"""The kernels of ``csrc/h264.cu`` on the CPU: the source compiled with g++
against a host emulation of the CUDA runtime
(``tests/cuda_emulation/cuda_runtime.h``: a std::thread per CUDA thread, a
std::barrier per block; ``H264_LAUNCH`` is the source's launch macro), bound
in place of the nvcc library and driven through ``data/h264_cuda.py``'s
kernel path with host pointers.

* every committed decodable form of ``tests/fixtures/h264_forms/``, the
  1024x2048 clip's 13 frames included, gives cv2's frames (``forms.json``'s
  sha256) through the three emulated kernels, and no plain version runs;
* stage by stage on forms of every tool (CAVLC and CABAC, P and B, both
  direct modes, weights, the 8x8 transform, slices, long-term references):
  the parse kernel's tables, the reconstruction kernel's planes and motion
  field and the deblocking kernel's planes equal the plain versions' on the
  same inputs.

The wave kernels run blocks of 8 threads in the emulation (``H264_MAX_THREADS``: each
thread strides the wave's rows, as on the card with 32 to 1,024), since a
std::thread a CUDA thread is slow to synchronise. This checks the kernels'
arithmetic and their host layout on the CPU; the card runs the same source built
by nvcc (``tests/test_torch_h264_cuda.py``,
``chip_smoke.py`` phase 23). Skips where no g++ with C++20 is found.
"""

import ctypes
import hashlib
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dspnet_torch.data import avi, h264_cuda
from dspnet_torch.ops import _build

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

ROOT = Path(__file__).resolve().parents[1]
FORMS = ROOT / "tests" / "fixtures" / "h264_forms"
META = json.loads((FORMS / "forms.json").read_text())["forms"]
STAGEWISE = ["cavlc_intra.mp4", "cavlc_p_partitions.mp4", "cavlc_longterm_mmco.mp4", "cabac_ipbb_temporal.mp4",
             "cabac_wp_explicit.mp4", "cabac_wp_implicit.mp4", "high_8x8_cabac.mp4", "cabac_slices_pb.mp4",
             "cabac_cip_nodirect8.mp4", "cavlc_qp_range.mp4"]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulated library bound as ``h264_cuda``'s, with every tensor
    taken for a card tensor and no stream, restored afterwards."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/h264.cu against the host emulation")
    out = tmp_path_factory.mktemp("h264emu") / "libh264_emulated.so"
    proc = subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-I", str(ROOT / "tests" / "cuda_emulation"),
                           "-DH264_MAX_THREADS=8", "-x", "c++", str(_build.CSRC / "h264.cu"), "-o", str(out),
                           "-lpthread"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if "c++20" in proc.stderr or "barrier" in proc.stderr:
            pytest.skip(f"g++ without C++20's <barrier>: {proc.stderr[:200]}")
        raise AssertionError(proc.stderr)
    lib = ctypes.CDLL(str(out))
    lib.dspnet_cuda_error_string.restype = ctypes.c_char_p
    saved = (_build.load_library, h264_cuda._on_card, h264_cuda._stream)
    h264_cuda.load_library.cache_clear()
    _build.load_library = lambda source: lib
    h264_cuda._on_card = lambda x: True
    h264_cuda._stream = lambda device: ctypes.c_void_p(0)
    yield lib
    _build.load_library, h264_cuda._on_card, h264_cuda._stream = saved
    h264_cuda.load_library.cache_clear()


def _sha(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _read(name):
    with avi.open_video(FORMS / name) as reader:
        return list(reader), reader.stream


@pytest.mark.parametrize("name", sorted(n for n, m in META.items() if "refused" not in m))
def test_emulated_kernels_give_cv2s_frames(emulated, name):
    """A form through the emulated parse, reconstruction and deblocking
    kernels: cv2's frames, every launch counted, no plain stage."""
    samples, stream = _read(name)
    for d in (h264_cuda.launches, h264_cuda.plain_calls):
        d.update(dict.fromkeys(d, 0))
    dec = h264_cuda.Decoder("cpu", stream.extradata, stream.fourcc)
    frames = []
    for i in range(0, len(samples), 8):
        frames += dec.decode(samples[i:i + 8])
    frames += dec.flush()
    assert [_sha(f.numpy()) for f in frames] == META[name]["bgr_sha256"]
    assert h264_cuda.plain_calls == dict.fromkeys(h264_cuda.plain_calls, 0)
    assert h264_cuda.launches["h264_parse"] == -(-len(samples) // 8)
    assert h264_cuda.launches["h264_recon"] == h264_cuda.launches["h264_deblock"] >= len(frames)


@pytest.mark.parametrize("name", STAGEWISE)
def test_emulated_kernels_equal_their_plain_versions(emulated, name):
    """Each kernel against its plain version on the same inputs, picture by
    picture, through ``Decoder.decode`` with its stages wrapped: tables and
    levels, planes and motion field, filtered planes."""
    samples, stream = _read(name)
    dec = h264_cuda.Decoder("cpu", stream.extradata, stream.fourcc)
    plain = {}
    done = []

    def parse(jobs, n, device):
        tables = h264_cuda.parse(jobs, n, device)
        for (t, lv), (rt, rlv) in zip(tables, h264_cuda.parse_ref(jobs, n, torch.device("cpu"))):
            m = rt.shape[0]
            np.testing.assert_array_equal(t[:m].numpy(), rt.numpy(), err_msg=f"{name} parse table")
            np.testing.assert_array_equal(lv[:m].numpy(), rlv.numpy(), err_msg=f"{name} parse levels")
        return tables

    def recon(*args):
        y, u, v, mf = h264_cuda.recon(*args)
        ry, ru, rv, rmf = h264_cuda.recon_ref(*args)
        for a, b, what in ((y, ry, "Y"), (u, ru, "U"), (v, rv, "V"), (mf.mv, rmf.mv, "mv"),
                           (mf.ref, rmf.ref, "ref"), (mf.ref_id, rmf.ref_id, "ref id")):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{name} picture {len(done)} recon {what}")
        plain["planes"], plain["mf"] = (ry, ru, rv), rmf
        return y, u, v, mf

    def deblock(y, u, v, table, mf, slices, sps):
        h264_cuda.deblock(y, u, v, table, mf, slices, sps)
        ry, ru, rv = plain["planes"]
        h264_cuda.deblock_ref(ry, ru, rv, table, plain["mf"], slices, sps)
        for a, b, what in ((y, ry, "Y"), (u, ru, "U"), (v, rv, "V")):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{name} picture {len(done)} deblock {what}")
        done.append(1)

    dec.stages.update(parse=parse, recon=recon, deblock=deblock)
    frames = []
    for i in range(0, len(samples), 8):
        frames += dec.decode(samples[i:i + 8])
    frames += dec.flush()
    assert [_sha(f.numpy()) for f in frames] == META[name]["bgr_sha256"] and len(done) >= len(frames)
