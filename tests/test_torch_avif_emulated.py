"""The kernels of ``csrc/av1.cu`` on the CPU: the source compiled with g++
against a host emulation of the CUDA runtime
(``tests/cuda_emulation/cuda_runtime.h``: the threads of a block as fibers
that pass each barrier in turn, blocks one after another), bound in place of
the nvcc library, and driven
through ``data/av1_cuda.py``'s kernel path with host pointers. Each kernel
equals its plain version bit for bit on committed forms that take every
kind of transform block (intra with palettes, filter intra and CfL,
IntraBC, lossless), both restoration types, 4:2:0 / 4:2:2 / 4:4:4 and 8 /
10 / 12 bits. This checks the kernels' arithmetic and their host layout
here; the card runs the same source built by nvcc
(``tests/test_torch_avif_cuda.py``, ``chip_smoke.py`` phase 22).

Skips where no g++ with C++20 is found.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dspnet_torch.data import av1_cuda, av1_parse, avif
from dspnet_torch.ops import _build

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

ROOT = Path(__file__).resolve().parents[1]
FORMS = ROOT / "tests" / "fixtures" / "avif_forms"


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulated library bound as ``av1_cuda``'s, with every tensor
    taken for a card tensor and no stream, restored afterwards."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/av1.cu against the host emulation")
    out = tmp_path_factory.mktemp("av1emu") / "libav1_emulated.so"
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-I", str(ROOT / "tests" / "cuda_emulation"),
                           "-x", "c++", str(_build.CSRC / "av1.cu"), "-o", str(out), "-lpthread"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if "c++20" in proc.stderr or "barrier" in proc.stderr:
            pytest.skip(f"g++ without C++20's <barrier>: {proc.stderr[:200]}")
        raise AssertionError(proc.stderr)
    lib = ctypes.CDLL(str(out))
    lib.dspnet_cuda_error_string.restype = ctypes.c_char_p
    saved = (_build.load_library, av1_cuda._on_card, av1_cuda._stream)
    av1_cuda.load_library.cache_clear()
    _build.load_library = lambda source: lib
    av1_cuda._on_card = lambda x: True
    av1_cuda._stream = lambda device: ctypes.c_void_p(0)
    yield lib
    _build.load_library, av1_cuda._on_card, av1_cuda._stream = saved
    av1_cuda.load_library.cache_clear()


@pytest.mark.parametrize("name", ["cv2_default.avif", "cv2_s0.avif", "pil_screen.avif", "pil_lr.avif",
                                  "pil_422cdef.avif", "pil_444cdef.avif", "cv2_d12.avif", "pil_lossless.avif",
                                  "pil_alpha.avif", "cv2_tex_s0.avif"])
def test_emulated_kernels_equal_their_plain_versions(emulated, name):
    """recon, deblock, cdef and loop_restore through the emulated kernels
    equal the plain versions on the same inputs (launches counted)."""
    p = avif.plan((FORMS / name).read_bytes())
    for coded in p.color + p.alpha:
        parsed = av1_parse.parse(coded.frame)
        st = av1_cuda.stage(av1_cuda.pack(parsed), "cpu")
        launched = dict(av1_cuda.launches)
        ref = av1_cuda.recon_ref(st)
        got = av1_cuda.recon(st)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{name} recon")
        deb_ref = av1_cuda.deblock_ref(st, ref)
        for a, b in zip(av1_cuda.deblock(st, ref), deb_ref):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{name} deblock")
        cd_ref = av1_cuda.cdef_ref(st, deb_ref)
        for a, b in zip(av1_cuda.cdef(st, deb_ref), cd_ref):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{name} cdef")
        for a, b in zip(av1_cuda.loop_restore(st, deb_ref, cd_ref), av1_cuda.loop_restore_ref(st, deb_ref, cd_ref)):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{name} loop_restore")
        assert av1_cuda.launches["recon"] == launched["recon"] + len(st.packed.waves)
