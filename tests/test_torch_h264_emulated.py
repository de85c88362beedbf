"""The kernels of ``csrc/h264.cu`` on the CPU: the source compiled with g++
against a host emulation of the CUDA runtime
(``tests/cuda_emulation/cuda_runtime.h``: the threads of a block as fibers
that pass each barrier in turn, blocks one after another; ``H264_LAUNCH`` is
the source's launch macro), bound in place of the nvcc library and driven
through ``data/h264_cuda.py``'s kernel path with host pointers.

* every committed decodable form of ``tests/fixtures/h264_forms/``, the
  1024x2048 clip's 13 frames included, gives cv2's frames (``forms.json``'s
  sha256) through the six emulated kernels, and no plain version runs;
* stage by stage on forms of every tool (CAVLC and CABAC, P and B, both
  direct modes, weights, the 8x8 transform, slices, long-term references):
  the parse kernel's tables, the reconstruction's planes and motion field
  and the deblocking filter's planes equal the plain versions' on the same
  inputs;
* the same stage by stage on those forms with the launch geometry forced
  (``H264_MAX_THREADS``, ``H264_MAX_BLOCKS``): a grid smaller than a
  picture's rows (a block takes several rows, the inter kernel several
  macroblocks, the parse several slices) with 4 threads a block, and a grid
  larger than the rows (blocks that find no row) with 32; the parse kernel
  runs with 1 thread a block in the default build
  (``H264_PARSE_THREADS``), so its warp is held to the plain parse with 1,
  4 and 32 lanes.

The kernels run at most 64 blocks of at most 8 threads by default here
(every kernel strides by its block and grid, as on the card with 1 to 256
threads and a grid as large as the work or as what is co-resident). This checks
the kernels' arithmetic, their order and their host layout on the CPU; the
card runs the same source built by nvcc (``tests/test_torch_h264_cuda.py``,
``chip_smoke.py`` phase 23). Skips where no g++ with C++20 is found.
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

from dspnet_torch.data import avi, h264_cuda
from dspnet_torch.ops import _build

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

ROOT = Path(__file__).resolve().parents[1]
FORMS = ROOT / "tests" / "fixtures" / "h264_forms"
META = json.loads((FORMS / "forms.json").read_text())["forms"]
STAGEWISE = ["cavlc_intra.mp4", "cavlc_p_partitions.mp4", "cavlc_longterm_mmco.mp4", "cabac_ipbb_temporal.mp4",
             "cabac_wp_explicit.mp4", "cabac_wp_implicit.mp4", "high_8x8_cabac.mp4", "cabac_slices_pb.mp4",
             "cabac_cip_nodirect8.mp4", "cavlc_qp_range.mp4"]


#: the geometries the emulated library is built with: the default (blocks of
#: at most 8 threads, the parse's of 1, grids of at most 64 blocks), a grid
#: smaller than a picture's rows (and than a batch's slices: the parse's
#: blocks take slices in turn), and one larger; the parse runs a warp of 1,
#: 4 and 32 threads
GEOMETRY = {"default": ("-DH264_MAX_THREADS=8", "-DH264_MAX_BLOCKS=64", "-DH264_PARSE_THREADS=1"),
            "small": ("-DH264_MAX_THREADS=4", "-DH264_MAX_BLOCKS=2"),
            "large": ("-DH264_MAX_THREADS=32", "-DH264_MAX_BLOCKS=4096")}


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    """The source built once per geometry (the compilers run side by side)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/h264.cu against the host emulation")
    out = tmp_path_factory.mktemp("h264emu")
    procs = {g: subprocess.Popen([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-I",
                                  str(ROOT / "tests" / "cuda_emulation"), *flags, "-x", "c++",
                                  str(_build.CSRC / "h264.cu"), "-o", str(out / f"libh264_{g}.so")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for g, flags in GEOMETRY.items()}
    libs = {}
    for g, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            if "c++20" in log:
                pytest.skip(f"g++ without C++20: {log[:200]}")
            raise AssertionError(log)
        libs[g] = ctypes.CDLL(str(out / f"libh264_{g}.so"))
        libs[g].dspnet_cuda_error_string.restype = ctypes.c_char_p
    return libs


@contextlib.contextmanager
def _bound(lib):
    """``lib`` bound as ``h264_cuda``'s, with every tensor taken for a card
    tensor and no stream, restored afterwards."""
    saved = (_build.load_library, h264_cuda._on_card, h264_cuda._stream)
    h264_cuda.load_library.cache_clear()
    _build.load_library = lambda source: lib
    h264_cuda._on_card = lambda x: True
    h264_cuda._stream = lambda device: ctypes.c_void_p(0)
    try:
        yield lib
    finally:
        _build.load_library, h264_cuda._on_card, h264_cuda._stream = saved
        h264_cuda.load_library.cache_clear()


@pytest.fixture
def emulated(libraries):
    with _bound(libraries["default"]) as lib:
        yield lib


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
    for d in (h264_cuda.launches, h264_cuda.kernel_launches, h264_cuda.plain_calls):
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
    for stage, kernels in h264_cuda.KERNELS.items():
        assert all(h264_cuda.kernel_launches[k] == h264_cuda.launches[stage] for k in kernels), \
            h264_cuda.kernel_launches


#: the plain stages' results by (form, picture in decode order): the
#: reconstruction's planes and motion field, and the filtered planes; and
#: by (form, "parse", first picture of the batch) the parse's tables (the
#: geometry cases compare with what the default case computed)
_PLAIN = {}


def _against_plain(name):
    """The form through ``Decoder.decode`` with its stages wrapped, each
    kernel's output held to its plain version's on the same inputs, picture
    by picture: tables and levels, planes and motion
    field, filtered planes."""
    samples, stream = _read(name)
    dec = h264_cuda.Decoder("cpu", stream.extradata, stream.fourcc)
    done = []

    def parse(jobs, n, device):
        tables = h264_cuda.parse(jobs, n, device)
        key = (name, "parse", len(done))
        if key not in _PLAIN:
            _PLAIN[key] = h264_cuda.parse_ref(jobs, n, torch.device("cpu"))
        for (t, lv), (rt, rlv) in zip(tables, _PLAIN[key]):
            m = rt.shape[0]
            np.testing.assert_array_equal(t[:m].numpy(), rt.numpy(), err_msg=f"{name} parse table")
            np.testing.assert_array_equal(lv[:m].numpy(), rlv.numpy(), err_msg=f"{name} parse levels")
        return tables

    def recon(table, levels, slices, sps, refs, col, poc):
        y, u, v, mf = h264_cuda.recon(table, levels, slices, sps, refs, col, poc)
        key = (name, len(done))
        if key not in _PLAIN:
            ry, ru, rv, rmf = h264_cuda.recon_ref(table, levels, slices, sps, refs, col, poc)
            filtered = [p.clone() for p in (ry, ru, rv)]
            h264_cuda.deblock_ref(*filtered, table, rmf, slices, sps)
            _PLAIN[key] = (ry, ru, rv, rmf, filtered)
        ry, ru, rv, rmf, _ = _PLAIN[key]
        for a, b, what in ((y, ry, "Y"), (u, ru, "U"), (v, rv, "V"), (mf.mv, rmf.mv, "mv"),
                           (mf.ref, rmf.ref, "ref"), (mf.ref_id, rmf.ref_id, "ref id")):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{name} picture {len(done)} recon {what}")
        return y, u, v, mf

    def deblock(y, u, v, table, mf, slices, sps):
        h264_cuda.deblock(y, u, v, table, mf, slices, sps)
        for a, b, what in zip((y, u, v), _PLAIN[(name, len(done))][4], "YUV"):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f"{name} picture {len(done)} deblock {what}")
        done.append(1)

    dec.stages.update(parse=parse, recon=recon, deblock=deblock)
    frames = []
    for i in range(0, len(samples), 8):
        frames += dec.decode(samples[i:i + 8])
    frames += dec.flush()
    assert [_sha(f.numpy()) for f in frames] == META[name]["bgr_sha256"] and len(done) >= len(frames)


@pytest.mark.parametrize("name", STAGEWISE)
def test_emulated_kernels_equal_their_plain_versions(emulated, name):
    """Each kernel against its plain version on the same inputs, picture by
    picture, through ``Decoder.decode`` with its stages wrapped: tables and
    levels, planes and motion field, filtered planes."""
    _against_plain(name)


@pytest.mark.parametrize("geometry", ["small", "large"])
@pytest.mark.parametrize("name", STAGEWISE)
def test_forced_launch_geometry_equals_the_plain_versions(libraries, name, geometry):
    """The parse, the reconstruction and the deblocking filter built with a
    grid smaller than a picture's rows (2 blocks of 4 threads: a block takes
    rows, and slices, in turn, the inter kernel strides over macroblocks)
    and with one larger (4,096 blocks of 32: most find no row; the parse a
    full warp), picture by picture equal to the plain versions."""
    with _bound(libraries[geometry]):
        _against_plain(name)
