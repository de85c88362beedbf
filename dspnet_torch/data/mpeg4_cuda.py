"""MPEG-4 Part 2 decode on the card: the host's container and VOP headers
(``data/mpeg4.py``), then three hand-written kernels (``csrc/mpeg4.cu``,
built by ``ops/_build.py`` and bound with ctypes), and their plain versions.

:class:`Decoder` decodes a stream's samples in batches (``video.
DECODE_BATCH`` of them at a time): the host reads each sample's VOP header
(:func:`mpeg4.read_vop_header`), :func:`stage` copies the batch's bytes and
its VOP table to the card once through pinned memory on the caller's current
stream, and then:

* :func:`parse`: ``mp4v_parse_kernel``, a warp per VOP (lane 0 runs the
  VOP's chain of VLC symbols from shared memory, the warp stores each
  macroblock's results), the batch's coded VOPs in one launch -> per VOP
  the (mb_num, 12) macroblock table (:data:`mpeg4.MB_FIELDS`) and the
  (mb_num * 6, 64) int16 quantised levels;
* :func:`recon`: ``mp4v_recon_kernel``, one launch per VOP in decode order,
  a thread per 8x8 block, from the previous VOP's planes -> the Y, U, V
  uint8 planes at the macroblock-aligned size;
* :func:`yuv420_to_bgr`: ``yuv420_to_bgr_kernel``, a thread per pixel ->
  the (H, W, 3) uint8 BGR frame ``cv2.VideoCapture`` returns.

Each wrapper adds one to :data:`launches` where it launches its kernel and
nowhere else. On a CPU tensor each runs its plain version instead
(:func:`parse_ref`, :func:`recon_ref`, and ``mpeg4.yuv420_to_bgr``; counted
in :data:`plain_calls`); on a CUDA tensor it launches the kernel or raises.
A parse that fails raises naming the VOP and the bit; nothing on a card
falls back to a plain version. A VOP with ``vop_coded`` 0 gives no frame, as
in cv2.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from dspnet_torch.data import mpeg4
from dspnet_torch.ops import _build

#: columns of the VOP table (``csrc/mpeg4.cu``'s V_* order)
VOP_FIELDS = ("offset", "bytes", "bit", "kind", "qp", "fcode", "dc_threshold")
#: the parse kernel's status codes
PARSE_ERRORS = {1: "an invalid VLC code", 2: "a missing marker bit", 3: "more than 64 coefficients in a block",
                4: "a video packet header naming another macroblock", 5: "an escape inside an escape",
                6: "the VOP's bytes ending inside a macroblock"}

#: kernel launches by kernel; a caller may reset them to 0
launches = {"mp4v_parse": 0, "mp4v_recon": 0, "yuv420_to_bgr": 0}
#: calls of each plain version (0 on the card's path)
plain_calls = {"mp4v_parse": 0, "mp4v_recon": 0, "yuv420_to_bgr": 0}

_SOURCE = _build.CSRC / "mpeg4.cu"
#: bytes after a batch's last sample, so the kernel's word loads of its last bytes stay inside
PAD = 16


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build ``csrc/mpeg4.cu`` (at first use) and bind it."""
    lib = _build.load_library(_SOURCE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dspnet_mp4v_parse.argtypes = [vp, vp, i, vp, vp, vp, i, i, i, i, vp, vp, vp, vp, vp]
    lib.dspnet_mp4v_recon.argtypes = [vp, vp, i, i, i, i, i, i, i, i, vp, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.dspnet_yuv420_to_bgr.argtypes = [vp, vp, vp, i, i, i, i, ctypes.POINTER(i), vp, vp]
    for f in (lib.dspnet_mp4v_parse, lib.dspnet_mp4v_recon, lib.dspnet_yuv420_to_bgr):
        f.restype = i
    return lib


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


#: bits the TCOEF lookup tables are indexed by: the longest code and its sign bit
TCOEF_BITS = mpeg4.LUT_BITS + 1
#: the TCOEF lookup entry of the escape code
T_ESCAPE = -2


@functools.cache
def _host_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The tables as the kernel reads them: the lookup tables of the VLCs
    before the TCOEF ones (int16 ``symbol << 8 | length``, -1 where no code
    starts); the two TCOEF lookup tables, indexed by the next 13 bits, each
    entry a code with the sign bit after it (int32 ``length | last << 5 |
    signed level << 8 | (run + 1) << 24``, the length counting the sign;
    :data:`T_ESCAPE` for the escape code, -1 where no code starts); the
    TCOEF tables' LMAX / RMAX (int32)."""
    luts = mpeg4.luts()
    first = luts[:mpeg4.LUT_NAMES.index("intra_tcoef")]
    if first.min() < -1 or first.max() > np.iinfo(np.int16).max:
        raise ValueError("an MPEG-4 VLC lookup entry does not fit int16")
    tco = []
    for lut, rll in zip(luts[-2:], (mpeg4.INTRA_RLL, mpeg4.INTER_RLL)):
        for peek in range(1 << TCOEF_BITS):
            e = int(lut[peek >> 1])
            sym, n = e >> 8, e & 0xFF
            if e < 0:
                tco.append(-1)
            elif sym == mpeg4.ESCAPE:
                tco.append(T_ESCAPE)
            else:
                last, run, level = rll[sym]
                if (peek >> (TCOEF_BITS - 1 - n)) & 1:  # the sign bit after the code
                    level = -level
                tco.append((n + 1) | last << 5 | (level & 0xFFFF) << 8 | (run + 1) << 24)
    maxes = np.concatenate([mpeg4.INTRA_LMAX.ravel(), mpeg4.INTRA_RMAX.ravel(), mpeg4.INTER_LMAX.ravel(),
                            mpeg4.INTER_RMAX.ravel()])
    return first.astype(np.int16).ravel(), np.array(tco, np.int32), maxes.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(t).to(device) for t in _host_tables())


def stage(samples: List[bytes], headers: List[mpeg4.VopHeader], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The coded VOPs' bytes back to back and their VOP table
    (:data:`VOP_FIELDS`) on ``device``, in one transfer (through pinned
    memory on the current stream, for a CUDA device)."""
    device = torch.device(device)
    rows, pos = [], 0
    for data, h in zip(samples, headers):
        rows.append((pos, len(data), h.bitpos, "IP".index(h.kind), h.qp, h.fcode, h.dc_threshold))
        pos += len(data)
    table = np.array(rows, np.int32).reshape(-1, len(VOP_FIELDS))
    host = torch.from_numpy(np.concatenate([table.view(np.uint8).ravel(),
                                            np.frombuffer(b"".join(samples) + bytes(PAD), np.uint8)]))
    if device.type == "cuda":
        pinned = torch.empty(host.shape, dtype=torch.uint8, pin_memory=True)
        pinned.copy_(host)
        buf = pinned.to(device, non_blocking=True)
    elif device.type == "cpu":
        buf = host
    else:
        raise ValueError(f"MPEG-4 decodes on a CUDA device or the CPU, not {device}")
    n = table.size * 4
    return buf[n:], buf[:n].view(torch.int32).view(table.shape)


def parse_ref(bits: torch.Tensor, vops: torch.Tensor, vol: mpeg4.Vol) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain entropy stage (``mpeg4.parse_vop``) of every staged VOP ->
    ((B, mb_num, 12) int32, (B, mb_num * 6, 64) int16)."""
    plain_calls["mp4v_parse"] += 1
    data = bits.cpu().numpy().tobytes()
    mbs, lvs = [], []
    for off, size, bit, kind, qp, fcode, thr in vops.cpu().numpy().tolist():
        hdr = mpeg4.VopHeader("IP"[kind], True, 0, thr, qp, fcode, 0, bit)
        mb, lv = mpeg4.parse_vop(data[off:off + size], vol, hdr)
        mbs.append(mb)
        lvs.append(lv)
    return (torch.from_numpy(np.stack(mbs)).to(bits.device), torch.from_numpy(np.stack(lvs)).to(bits.device))


def parse_launches(bits: torch.Tensor, vops: torch.Tensor, vol: mpeg4.Vol, steps: Optional[torch.Tensor] = None):
    """The outputs of a batch's parse on a CUDA device and its kernel's
    launch: ((mb (B, mb_num, 12) int32, levels (B, mb_num * 6, 64) int16,
    status (B, 2) int32), [(kernel name, launch)]). Nothing runs until the
    launch is called (:func:`parse` calls it; ``chip_smoke.py`` also times
    it); each launch adds one to :data:`launches`. ``steps``, an int32 a
    VOP, takes each VOP's chain steps (VLC symbols)."""
    dev = bits.device
    nvop, n = len(vops), vol.mb_num
    mb = torch.zeros(nvop, n, 12, dtype=torch.int32, device=dev)
    levels = torch.zeros(nvop, n * 6, 64, dtype=torch.int16, device=dev)
    status = torch.zeros(nvop, 2, dtype=torch.int32, device=dev)
    lut, tco, maxes = _tables(dev)
    lib = load_library()
    args = (bits.data_ptr(), vops.data_ptr(), nvop, lut.data_ptr(), tco.data_ptr(), maxes.data_ptr(), vol.mb_width,
            vol.mb_height, vol.time_bits, int(vol.resync), mb.data_ptr(), levels.data_ptr(), status.data_ptr(),
            None if steps is None else steps.data_ptr(), _stream(dev))

    def launch(kept=(bits, vops)):
        err = lib.dspnet_mp4v_parse(*args)
        launches["mp4v_parse"] += 1
        _build.check(lib, err, "mp4v_parse_kernel")

    return (mb, levels, status), [("mp4v_parse_kernel", launch)]


def parse(bits: torch.Tensor, vops: torch.Tensor, vol: mpeg4.Vol) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mp4v_parse_kernel`` on a CUDA device (one launch, a warp per VOP),
    :func:`parse_ref` on the CPU. Raises when a VOP fails to parse, and when
    the launch is refused (a VOP too wide for the kernel's shared memory)."""
    if not _on_card(bits):
        return parse_ref(bits, vops, vol)
    if bits.dtype != torch.uint8 or vops.dtype != torch.int32 or not vops.is_contiguous():
        raise ValueError("parse takes stage()'s uint8 bytes and int32 VOP table")
    (mb, levels, status), kernels = parse_launches(bits, vops, vol)
    for _, launch in kernels:
        launch()
    st = status.cpu().numpy()
    for k, (code, bit) in enumerate(st.tolist()):
        if code:
            raise mpeg4.Mpeg4Error(f"VOP {k} of the batch: {PARSE_ERRORS.get(code, code)} (bit {bit})")
    return mb, levels


def recon_ref(mb: torch.Tensor, levels: torch.Tensor, vol: mpeg4.Vol, rounding: int,
              ref: Optional[Tuple[torch.Tensor, ...]]) -> Tuple[torch.Tensor, ...]:
    """The plain reconstruction (``mpeg4.recon_vop``) of one VOP."""
    plain_calls["mp4v_recon"] += 1
    planes = mpeg4.recon_vop(mb.cpu().numpy(), levels.cpu().numpy(), vol, rounding,
                             None if ref is None else tuple(p.cpu().numpy() for p in ref))
    return tuple(torch.from_numpy(p).to(mb.device) for p in planes)


def recon(mb: torch.Tensor, levels: torch.Tensor, vol: mpeg4.Vol, rounding: int,
          ref: Optional[Tuple[torch.Tensor, ...]] = None) -> Tuple[torch.Tensor, ...]:
    """``mp4v_recon_kernel`` for one VOP on a CUDA device (an I-VOP when
    ``ref`` is None, else a P-VOP from ``ref``'s planes), :func:`recon_ref`
    on the CPU -> (Y, U, V) uint8 planes at the macroblock-aligned size."""
    if not _on_card(mb):
        return recon_ref(mb, levels, vol, rounding, ref)
    n = vol.mb_num
    if mb.shape != (n, 12) or levels.shape != (n * 6, 64) or mb.dtype != torch.int32 \
            or levels.dtype != torch.int16 or not (mb.is_contiguous() and levels.is_contiguous()):
        raise ValueError("recon takes one VOP's contiguous int32 (mb_num, 12) table and int16 (mb_num * 6, 64) levels")
    dev = mb.device
    hy, wy = vol.mb_height * 16, vol.mb_width * 16
    out = (torch.empty(hy, wy, dtype=torch.uint8, device=dev), torch.empty(hy // 2, wy // 2, dtype=torch.uint8, device=dev),
           torch.empty(hy // 2, wy // 2, dtype=torch.uint8, device=dev))
    if ref is not None and any(r.shape != o.shape or r.dtype != torch.uint8 or not r.is_contiguous()
                               for r, o in zip(ref, out)):
        raise ValueError("recon's reference must be the previous VOP's planes")
    matrices = _matrices(dev, tuple(vol.intra_matrix), tuple(vol.inter_matrix))
    h_edge = vol.width if vol.edge_at_size else wy
    v_edge = vol.height if vol.edge_at_size else hy
    refs = [0, 0, 0] if ref is None else [r.data_ptr() for r in ref]
    lib = load_library()
    err = lib.dspnet_mp4v_recon(mb.data_ptr(), levels.data_ptr(), vol.mb_width, vol.mb_height, vol.width, vol.height,
                                h_edge, v_edge, int(vol.mpeg_quant), rounding, matrices[0].data_ptr(),
                                matrices[1].data_ptr(), *refs, *(o.data_ptr() for o in out), _stream(dev))
    launches["mp4v_recon"] += 1
    _build.check(lib, err, "mp4v_recon_kernel")
    return out


@functools.lru_cache(maxsize=8)
def _matrices(device: torch.device, intra: tuple, inter: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(intra, dtype=torch.int32, device=device),
            torch.tensor(inter, dtype=torch.int32, device=device))


def yuv420_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, height: int, width: int,
                  coef: tuple = mpeg4.COLOUR) -> torch.Tensor:
    """``yuv420_to_bgr_kernel`` on a CUDA device, ``mpeg4.yuv420_to_bgr`` on
    the CPU -> the (height, width, 3) uint8 BGR frame (``coef``: swscale's
    coefficients of the frame's matrix and range, ``mpeg4.swscale_colour``)."""
    if not _on_card(y):
        plain_calls["yuv420_to_bgr"] += 1
        return mpeg4.yuv420_to_bgr(y, u, v, height, width, coef)
    if not all(p.dtype == torch.uint8 and p.is_contiguous() for p in (y, u, v)) or y.shape[0] < height \
            or y.shape[1] < width or u.shape != v.shape or u.shape[0] * 2 < height or u.shape[1] * 2 < width:
        raise ValueError("yuv420_to_bgr takes contiguous uint8 planes covering the frame")
    out = torch.empty(height, width, 3, dtype=torch.uint8, device=y.device)
    coef = (ctypes.c_int * 6)(*coef)
    lib = load_library()
    err = lib.dspnet_yuv420_to_bgr(y.data_ptr(), u.data_ptr(), v.data_ptr(), y.shape[1], u.shape[1], height, width,
                                   coef, out.data_ptr(), _stream(y.device))
    launches["yuv420_to_bgr"] += 1
    _build.check(lib, err, "yuv420_to_bgr_kernel")
    return out


class Decoder:
    """One stream's decoder on ``device`` (a card, or the CPU through the
    plain versions): ``decode(samples)`` -> the frames cv2 returns for them,
    as (H, W, 3) uint8 BGR tensors on the device (one per coded VOP);
    ``decode_planes(samples)`` stops before the colour conversion. ``config``:
    the stream's VOS / VOL headers where the container holds them;
    ``fourcc``: its tag."""

    def __init__(self, device, config: bytes = b"", fourcc: str = "mp4v"):
        self.device = torch.device(device)
        self.vol = mpeg4.parse_config(config) if config else mpeg4.Vol()
        self.fourcc = fourcc
        self.ref: Optional[Tuple[torch.Tensor, ...]] = None
        self._checked = False

    def decode(self, samples: List[bytes]) -> List[torch.Tensor]:
        return [yuv420_to_bgr(*planes, self.vol.height, self.vol.width) for planes in self.decode_planes(samples)]

    def decode_planes(self, samples: List[bytes]) -> List[Tuple[torch.Tensor, ...]]:
        """The (Y, U, V) uint8 planes, at the macroblock-aligned size, of each
        coded VOP of ``samples``."""
        coded, headers = [], []
        for data in samples:
            hdr = mpeg4.read_vop_header(data, self.vol)
            if not self._checked:
                mpeg4.check_codec_tag(self.vol, self.fourcc)
                self._checked = True
            if hdr.coded:
                coded.append(data)
                headers.append(hdr)
        if not coded:
            return []
        if headers[0].kind == "P" and self.ref is None:
            raise mpeg4.Mpeg4Error("a P-VOP before any I-VOP")
        bits, vops = stage(coded, headers, self.device)
        mb, levels = parse(bits, vops, self.vol)
        planes = []
        for k, hdr in enumerate(headers):
            self.ref = recon(mb[k], levels[k], self.vol, hdr.rounding, self.ref if hdr.kind == "P" else None)
            planes.append(self.ref)
        return planes
