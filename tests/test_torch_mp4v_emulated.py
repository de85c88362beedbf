"""The kernels of ``csrc/mpeg4.cu`` on the CPU: the source compiled with g++
against a host emulation of the CUDA runtime
(``tests/cuda_emulation/cuda_runtime.h``: the threads of a block as fibers
that pass each barrier in turn, blocks one after another; ``MP4V_LAUNCH`` is
the source's launch macro), bound in place of the nvcc library and driven
through ``data/mpeg4_cuda.py``'s kernel path with host pointers.

* every committed decodable form of ``tests/fixtures/mp4v_forms/`` of
  232x136 and smaller gives cv2's frames (``forms.json``'s sha256; the odd
  height's the port's own) through ``mpeg4_cuda.Decoder`` and the three
  emulated kernels, every launch counted and no plain version run;
* stage by stage on the same forms: the parse kernel's macroblock table and
  levels, the reconstruction's planes and the colour kernel's frame equal
  the plain versions' on the same inputs, batch by batch;
* the parse kernel with its launch geometry forced (``MP4V_PARSE_THREADS``,
  ``MP4V_MAX_BLOCKS``): a warp of 1 thread on a grid of 2 blocks (a block
  takes VOPs in turn) and a full warp of 32, equal to the plain parse on
  forms of every tool (video packets with HEC, 4MV, DQUANT, escapes, the
  DC VLC threshold, f_code above 1).

The default build runs the parse with 4 threads a block. cv2's 2048x1024
clip is left out (its plain parse takes seconds a VOP here); the card runs
it (``tests/test_torch_mp4v_cuda.py``, ``chip_smoke.py`` phase 20). Skips
where no g++ with C++20 is found.
"""

import contextlib
import ctypes
import hashlib
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dspnet_torch.data import avi, mpeg4, mpeg4_cuda
from dspnet_torch.ops import _build

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

ROOT = Path(__file__).resolve().parents[1]
FORMS = ROOT / "tests" / "fixtures" / "mp4v_forms"
META = json.loads((FORMS / "forms.json").read_text())
SMALL = sorted(n for n, m in META.items() if m["source"] != "refusal" and m["width"] * m["height"] <= 232 * 136)
#: forms of every tool the parse reads, for the forced geometries
GEOMETRY_FORMS = ["cv2_mp4v_232x136.mp4", "cv2_xvid.avi", "w_4mv.mp4", "w_codes.mp4", "w_dc_threshold.mp4",
                  "w_dquant.mp4", "w_resync.mp4"]

#: the geometries the emulated library is built with: the default (blocks of
#: at most 8 threads, the parse's of 4), a parse of 1 thread a block on 2
#: blocks, and a parse of a full warp
GEOMETRY = {"default": ("-DMP4V_MAX_THREADS=8", "-DMP4V_PARSE_THREADS=4"),
            "one": ("-DMP4V_MAX_THREADS=8", "-DMP4V_PARSE_THREADS=1", "-DMP4V_MAX_BLOCKS=2"),
            "warp": ("-DMP4V_MAX_THREADS=8", "-DMP4V_PARSE_THREADS=32")}


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    """The source built once per geometry (the compilers run side by side)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/mpeg4.cu against the host emulation")
    out = tmp_path_factory.mktemp("mp4vemu")
    procs = {g: subprocess.Popen([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-I",
                                  str(ROOT / "tests" / "cuda_emulation"), *flags, "-x", "c++",
                                  str(_build.CSRC / "mpeg4.cu"), "-o", str(out / f"libmpeg4_{g}.so")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for g, flags in GEOMETRY.items()}
    libs = {}
    for g, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            if "c++20" in log:
                pytest.skip(f"g++ without C++20: {log[:200]}")
            raise AssertionError(log)
        libs[g] = ctypes.CDLL(str(out / f"libmpeg4_{g}.so"))
        libs[g].dspnet_cuda_error_string.restype = ctypes.c_char_p
    return libs


@contextlib.contextmanager
def _bound(lib):
    """``lib`` bound as ``mpeg4_cuda``'s, with every tensor taken for a card
    tensor and no stream, restored afterwards."""
    saved = (_build.load_library, mpeg4_cuda._on_card, mpeg4_cuda._stream)
    mpeg4_cuda.load_library.cache_clear()
    _build.load_library = lambda source: lib
    mpeg4_cuda._on_card = lambda x: True
    mpeg4_cuda._stream = lambda device: ctypes.c_void_p(0)
    try:
        yield lib
    finally:
        _build.load_library, mpeg4_cuda._on_card, mpeg4_cuda._stream = saved
        mpeg4_cuda.load_library.cache_clear()


def _sha(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _read(name):
    with avi.open_video(FORMS / name) as reader:
        return list(reader), reader.stream


def _want(name):
    return META[name].get("port_bgr_sha256", META[name]["bgr_sha256"])


#: the plain parse of each batch of 8 samples by (form, first sample); the
#: geometry cases compare with what the stage-by-stage case computed
_PLAIN = {}


def _batches(name):
    """The form's coded VOPs in the decoder's batches of 8: (first sample,
    staged bytes, VOP table, headers), and its decoder."""
    samples, stream = _read(name)
    dec = mpeg4_cuda.Decoder("cpu", stream.extradata, stream.fourcc)
    out = []
    for i in range(0, len(samples), 8):
        coded = [(x, h) for x in samples[i:i + 8] for h in [mpeg4.read_vop_header(x, dec.vol)] if h.coded]
        if coded:
            bits, vops = mpeg4_cuda.stage([c[0] for c in coded], [c[1] for c in coded], "cpu")
            out.append((i, bits, vops, [c[1] for c in coded]))
    return out, dec


def _parse_against_plain(name, batches, vol):
    """The parse kernel on each batch against the plain parse of it."""
    parsed = []
    for i, bits, vops, _ in batches:
        mb, levels = mpeg4_cuda.parse(bits, vops, vol)
        if (name, i) not in _PLAIN:
            _PLAIN[(name, i)] = mpeg4_cuda.parse_ref(bits, vops, vol)
        want_mb, want_levels = _PLAIN[(name, i)]
        np.testing.assert_array_equal(mb.numpy(), want_mb.numpy(), err_msg=f"{name} VOPs from {i}: table")
        np.testing.assert_array_equal(levels.numpy(), want_levels.numpy(), err_msg=f"{name} VOPs from {i}: levels")
        parsed.append((mb, levels))
    return parsed


@pytest.mark.parametrize("name", SMALL)
def test_emulated_kernels_give_cv2s_frames(libraries, name):
    """A form through ``Decoder.decode`` on the emulated parse,
    reconstruction and colour kernels: cv2's frames, every launch counted,
    no plain stage; then stage by stage, each kernel against its plain
    version on the same inputs."""
    samples, stream = _read(name)
    with _bound(libraries["default"]):
        for d in (mpeg4_cuda.launches, mpeg4_cuda.plain_calls):
            d.update(dict.fromkeys(d, 0))
        dec = mpeg4_cuda.Decoder("cpu", stream.extradata, stream.fourcc)
        frames = [f for i in range(0, len(samples), 8) for f in dec.decode(samples[i:i + 8])]
        assert [_sha(f.numpy()) for f in frames] == _want(name)
        assert mpeg4_cuda.plain_calls == dict.fromkeys(mpeg4_cuda.plain_calls, 0)
        assert mpeg4_cuda.launches["mp4v_recon"] == mpeg4_cuda.launches["yuv420_to_bgr"] == len(frames)
        assert mpeg4_cuda.launches["mp4v_parse"] == sum(
            any(mpeg4.read_vop_header(x, dec.vol).coded for x in samples[i:i + 8]) for i in range(0, len(samples), 8))

        batches, dec = _batches(name)
        vol, ref, got = dec.vol, None, []
        for (_, _, _, headers), (mb, levels) in zip(batches, _parse_against_plain(name, batches, vol)):
            for k, h in enumerate(headers):
                prev = ref if h.kind == "P" else None
                planes = mpeg4_cuda.recon(mb[k], levels[k], vol, h.rounding, prev)
                for a, b, what in zip(planes, mpeg4_cuda.recon_ref(mb[k], levels[k], vol, h.rounding, prev), "YUV"):
                    np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{name} VOP {len(got)} recon {what}")
                ref = planes
                frame = mpeg4_cuda.yuv420_to_bgr(*planes, vol.height, vol.width)
                np.testing.assert_array_equal(frame.numpy(), mpeg4.yuv420_to_bgr(*planes, vol.height, vol.width).numpy(),
                                              err_msg=f"{name} VOP {len(got)} colour")
                got.append(_sha(frame.numpy()))
        assert got == _want(name)


@pytest.mark.parametrize("geometry", ["one", "warp"])
@pytest.mark.parametrize("name", GEOMETRY_FORMS)
def test_forced_parse_geometry_equals_the_plain_parse(libraries, name, geometry):
    """The parse kernel built with 1 thread a block on a grid of 2 blocks
    (each block takes VOPs in turn) and with a full warp of 32, batch by
    batch equal to the plain parse."""
    batches, dec = _batches(name)
    with _bound(libraries[geometry]):
        _parse_against_plain(name, batches, dec.vol)
