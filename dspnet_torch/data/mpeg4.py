"""MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile video read as cv2 5.0.0
reads it through FFmpeg's ``mpeg4`` decoder and swscale, and a writer, on
numpy and torch.

Reading runs in stages, each a function here. The one decoder,
``data/mpeg4_cuda.py``'s ``Decoder``, runs them: on a card it replaces
stages 2-4 by its kernels (``csrc/mpeg4.cu``), on the CPU it calls them as
those kernels' plain versions:

1. :func:`parse_config` / :func:`read_vop_header` (the host): the VOS, VO
   and VOL headers (from the MP4's ``esds`` or in band), user data, GOV
   headers and each VOP's header, up to the first macroblock's bit.
2. :func:`parse_vop`: the entropy stage of one VOP, as FFmpeg's
   ``mpeg4_decode_mb`` runs it: MCBPC, CBPY, ``not_coded``, DQUANT with the
   quantiser carried across, 1MV / 4MV with the median prediction (FFmpeg's
   first-slice-line rules at VOP and video-packet edges), ``f_code``
   residuals, intra DC with ``dc_scaler`` and ``intra_dc_vlc_thr``, AC/DC
   prediction (direction rule, quantiser rescaling, FFmpeg's buffer
   clearing at a resync), the zigzag and alternate scans, the intra and
   inter TCOEF VLCs with escapes 1-3 (LMAX / RMAX), resync markers and
   video packet headers (with ``header_extension_code``) -> per macroblock
   (:data:`MB_FIELDS`) its mode, quantiser, coded blocks and MVs, and each
   block's quantised levels in raster order.
3. :func:`recon_vop`: dequantisation (H.263, or MPEG with the default or
   loaded matrices and the inter mismatch control), the simple IDCT as
   FFmpeg's x86 build computes it (:func:`idct`), the half-pel prediction from the reference with the VOP's rounding type
   (the edge clamped at the macroblock-aligned size, FFmpeg's clips of 4MV
   sources and its chroma rounding), add and clip -> the Y, U, V planes at
   the macroblock-aligned size.
4. :func:`yuv420_to_bgr`: the YUV 4:2:0 -> BGR conversion cv2's FFmpeg
   backend applies (swscale's unscaled converter: BT.601 limited range,
   the chroma of each 2x2 block shared, fixed-point coefficients as its
   x86 SIMD path rounds them), cropped to the VOL's size.

FFmpeg's x86 build (the one cv2 here carries) is the reference, and where
its rules are not the standard's or its C code's they are followed, each
pinned by a committed form (``tests/test_torch_mp4v.py``): with
``vop_rounding_type`` 1, an 8-wide block's (chroma, 4MV luma) horizontal or
vertical half-pel average is ``(max(a - 1, 0) + b + 1) >> 1`` with ``a``
the left (or odd-row) sample, as its approximate
``put_no_rnd_pixels8_x2`` / ``_y2`` compute it, while a 16x16 block's is
exact; the IDCT's row outputs saturate to int16 (``packssdw``) where C
wraps them, and its column rounding term is added to the 16-bit DC input;
the intra MPEG dequantisation has no mismatch control.

Refused, each raising :class:`Mpeg4Error` and naming what it found: B-VOPs,
S(GMC)-VOPs and sprites, quarter-pel, interlaced video, data partitioning,
reversible VLC, N-bit, scalability, a non-rectangular shape, complexity
estimation, NEWPRED, reduced-resolution VOPs, DivX "packed bitstream" (two
VOPs in one sample) and streams whose user data names XviD or DivX 4 (FFmpeg
decodes those with the Xvid IDCT or other workarounds).

:func:`encode_vop` writes a Simple Profile VOP with vectorised torch ops on
the frame's device: I-VOPs and P-VOPs with zero MVs (``not_coded`` where
the residual quantises to zero, intra where its rule in :func:`encode_vop`
says so), one fixed quantiser (:data:`ENCODE_QP`), H.263 quantisation,
the DC prediction, the run/level VLC lookup and the bit packing. With
``data/mp4.py``'s ``Mp4Writer`` it writes the demo's ``detection_out.mp4``.
"""

from __future__ import annotations

import functools
import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from dspnet_torch.data.mp4 import VideoError


class Mpeg4Error(VideoError):
    """An MPEG-4 Part 2 stream the port does not read, or a broken one."""


# ------------------------------------------------------------------ tables

def _zigzag() -> List[int]:
    order = []
    for s in range(15):
        cells = [(r, s - r) for r in range(8) if 0 <= s - r < 8]
        order += [r * 8 + c for r, c in (cells if s % 2 else cells[::-1])]
    return order


#: scan orders, scan position -> raster index
ZIGZAG = _zigzag()
ALT_HORIZONTAL = [0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
                  13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
                  30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
                  46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63]
ALT_VERTICAL = [(i % 8) * 8 + i // 8 for i in ALT_HORIZONTAL]

#: (code, length): intra MCBPC, index = 4 * (dquant) + cbpc, 8 = stuffing
INTRA_MCBPC = [(1, 1), (1, 3), (2, 3), (3, 3), (1, 4), (1, 6), (2, 6), (3, 6), (1, 9)]
#: inter MCBPC, index = 4 * mode + cbpc for modes inter, intra, interQ,
#: intraQ, inter4V; 20 = stuffing
INTER_MCBPC = [(1, 1), (3, 4), (2, 4), (5, 6), (3, 5), (4, 8), (3, 8), (3, 7),
               (3, 3), (7, 7), (6, 7), (5, 9), (4, 6), (4, 9), (3, 9), (2, 9),
               (2, 3), (5, 7), (4, 7), (5, 8), (1, 9)]
#: CBPY of an intra macroblock (an inter one's is the complement)
CBPY = [(3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
        (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2)]
#: motion code magnitude 0..32 (a sign bit follows a non-zero code)
MVTAB = [(1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7),
         (11, 9), (10, 9), (9, 9), (17, 10), (16, 10), (15, 10), (14, 10), (13, 10),
         (12, 10), (11, 10), (10, 10), (9, 10), (8, 10), (7, 10), (6, 10), (5, 10),
         (4, 10), (7, 11), (6, 11), (5, 11), (4, 11), (3, 11), (2, 11), (3, 12), (2, 12)]
#: dct_dc_size of luma and chroma, 0..12
DC_LUM = [(3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7),
          (1, 8), (1, 9), (1, 10), (1, 11)]
DC_CHROM = [(3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8),
            (1, 9), (1, 10), (1, 11), (1, 12)]

#: inter TCOEF (H.263's): 102 codes and the escape (index 102)
INTER_VLC = [(0x2, 2), (0xf, 4), (0x15, 6), (0x17, 7), (0x1f, 8), (0x25, 9), (0x24, 9), (0x21, 10),
             (0x20, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x6, 3), (0x14, 6), (0x1e, 8), (0xf, 10),
             (0x21, 11), (0x50, 12), (0xe, 4), (0x1d, 8), (0xe, 10), (0x51, 12), (0xd, 5), (0x23, 9),
             (0xd, 10), (0xc, 5), (0x22, 9), (0x52, 12), (0xb, 5), (0xc, 10), (0x53, 12), (0x13, 6),
             (0xb, 10), (0x54, 12), (0x12, 6), (0xa, 10), (0x11, 6), (0x9, 10), (0x10, 6), (0x8, 10),
             (0x16, 7), (0x55, 12), (0x15, 7), (0x14, 7), (0x1c, 8), (0x1b, 8), (0x21, 9), (0x20, 9),
             (0x1f, 9), (0x1e, 9), (0x1d, 9), (0x1c, 9), (0x1b, 9), (0x1a, 9), (0x22, 11), (0x23, 11),
             (0x56, 12), (0x57, 12), (0x7, 4), (0x19, 9), (0x5, 11), (0xf, 6), (0x4, 11), (0xe, 6),
             (0xd, 6), (0xc, 6), (0x13, 7), (0x12, 7), (0x11, 7), (0x10, 7), (0x1a, 8), (0x19, 8),
             (0x18, 8), (0x17, 8), (0x16, 8), (0x15, 8), (0x14, 8), (0x13, 8), (0x18, 9), (0x17, 9),
             (0x16, 9), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9), (0x7, 10), (0x6, 10),
             (0x5, 10), (0x4, 10), (0x24, 11), (0x25, 11), (0x26, 11), (0x27, 11), (0x58, 12), (0x59, 12),
             (0x5a, 12), (0x5b, 12), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12), (0x3, 7)]
#: intra TCOEF: 102 codes and the escape (index 102)
INTRA_VLC = [(0x2, 2), (0x6, 3), (0xf, 4), (0xd, 5), (0xc, 5), (0x15, 6), (0x13, 6), (0x12, 6),
             (0x17, 7), (0x1f, 8), (0x1e, 8), (0x1d, 8), (0x25, 9), (0x24, 9), (0x23, 9), (0x21, 9),
             (0x21, 10), (0x20, 10), (0xf, 10), (0xe, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x21, 11),
             (0x50, 12), (0x51, 12), (0x52, 12), (0xe, 4), (0x14, 6), (0x16, 7), (0x1c, 8), (0x20, 9),
             (0x1f, 9), (0xd, 10), (0x22, 11), (0x53, 12), (0x55, 12), (0xb, 5), (0x15, 7), (0x1e, 9),
             (0xc, 10), (0x56, 12), (0x11, 6), (0x1b, 8), (0x1d, 9), (0xb, 10), (0x10, 6), (0x22, 9),
             (0xa, 10), (0xd, 6), (0x1c, 9), (0x8, 10), (0x12, 7), (0x1b, 9), (0x54, 12), (0x14, 7),
             (0x1a, 9), (0x57, 12), (0x19, 8), (0x9, 10), (0x18, 8), (0x23, 11), (0x17, 8), (0x19, 9),
             (0x18, 9), (0x7, 10), (0x58, 12), (0x7, 4), (0xc, 6), (0x16, 8), (0x17, 9), (0x6, 10),
             (0x5, 11), (0x4, 11), (0x59, 12), (0xf, 6), (0x16, 9), (0x5, 10), (0xe, 6), (0x4, 10),
             (0x11, 7), (0x24, 11), (0x10, 7), (0x25, 11), (0x13, 7), (0x5a, 12), (0x15, 8), (0x5b, 12),
             (0x14, 8), (0x13, 8), (0x1a, 8), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9),
             (0x26, 11), (0x27, 11), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12), (0x3, 7)]


def _run_levels(lmax_last0, lmax_last1):
    """(last, run, level) of each table index from the largest level of
    each run (the tables list runs in order, levels 1.. within a run)."""
    out = []
    for last, lmax in ((0, lmax_last0), (1, lmax_last1)):
        for run, top in enumerate(lmax):
            out += [(last, run, level) for level in range(1, top + 1)]
    return out


#: (last, run, level) of each TCOEF index
INTER_RLL = _run_levels([12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2] + [1] * 16, [3, 2] + [1] * 39)
INTRA_RLL = _run_levels([27, 10, 5, 4, 3, 3, 3, 3, 2, 2] + [1] * 5, [8, 3] + [2] * 5 + [1] * 14)
ESCAPE = 102


def _max_tables(rll):
    """LMAX[last][run] and RMAX[last][level] of a TCOEF table."""
    lmax = np.zeros((2, 64), np.int32)
    rmax = np.zeros((2, 64), np.int32)
    for last, run, level in rll:
        lmax[last, run] = max(lmax[last, run], level)
        rmax[last, level] = max(rmax[last, level], run)
    return lmax, rmax


INTER_LMAX, INTER_RMAX = _max_tables(INTER_RLL)
INTRA_LMAX, INTRA_RMAX = _max_tables(INTRA_RLL)

#: dc_scaler by quantiser, luma and chroma
Y_DC_SCALE = [0, 8, 8, 8, 8, 10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
              34, 36, 38, 40, 42, 44, 46]
C_DC_SCALE = [0, 8, 8, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18,
              19, 20, 21, 22, 23, 24, 25]
#: intra_dc_vlc_thr -> the quantiser from which intra DC is coded as AC
DC_THRESHOLD = [99, 13, 15, 17, 19, 21, 23, 0]
#: DQUANT's 2-bit code -> quantiser change
QUANT_TAB = [-1, -2, 1, 2]
#: 4MV chroma rounding of the sum's sixteenths
CHROMA_ROUND = [0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2]
#: MPEG quantisation's default matrices, raster order
DEFAULT_INTRA_MATRIX = [8, 17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28,
                        20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32,
                        22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
                        25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45]
DEFAULT_INTER_MATRIX = [16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24,
                        18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27,
                        20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
                        22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33]

#: bits a VLC lookup table is indexed by
LUT_BITS = 12
#: the tables :func:`luts` builds, in the order the kernel reads them
LUT_NAMES = ("intra_mcbpc", "inter_mcbpc", "cbpy", "mv", "dc_lum", "dc_chrom", "intra_tcoef", "inter_tcoef")


def _lut(codes) -> np.ndarray:
    """A ``2**LUT_BITS`` table: the next 12 bits -> ``symbol << 8 | length``,
    -1 where no code starts."""
    lut = np.full(1 << LUT_BITS, -1, np.int32)
    for sym, (code, n) in enumerate(codes):
        if n == 0:
            continue
        lo = code << (LUT_BITS - n)
        lut[lo:lo + (1 << (LUT_BITS - n))] = (sym << 8) | n
    return lut


def luts() -> np.ndarray:
    """Every VLC lookup table (:data:`LUT_NAMES`), stacked: (8, 4096) int32."""
    return np.stack([_lut(INTRA_MCBPC), _lut(INTER_MCBPC[:21]), _lut(CBPY), _lut(MVTAB), _lut(DC_LUM),
                     _lut(DC_CHROM), _lut(INTRA_VLC), _lut(INTER_VLC)])


_LUTS = luts()
_L = {name: _LUTS[i].tolist() for i, name in enumerate(LUT_NAMES)}


# ------------------------------------------------------------------ bits

class Bits:
    """A big-endian bit reader over ``data`` from bit ``pos``."""

    def __init__(self, data: bytes, pos: int = 0):
        self.buf = bytes(data) + bytes(16)
        self.size = len(data) * 8
        self.pos = pos

    def peek(self, n: int) -> int:
        p = self.pos
        v = int.from_bytes(self.buf[p >> 3:(p >> 3) + 8], "big")
        return (v >> (64 - (p & 7) - n)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.peek(n)
        self.pos += n
        return v

    def read1(self) -> int:
        p = self.pos
        self.pos = p + 1
        return (self.buf[p >> 3] >> (7 - (p & 7))) & 1

    def vlc(self, lut) -> int:
        e = lut[self.peek(LUT_BITS)]
        if e < 0:
            raise Mpeg4Error(f"invalid VLC code at bit {self.pos}")
        self.pos += e & 0xFF
        return e >> 8

    def left(self) -> int:
        return self.size - self.pos


def start_codes(data: bytes) -> List[Tuple[int, int]]:
    """(code byte, position after the 4-byte start code) of each start code."""
    return [(data[m.start() + 3], m.start() + 4) for m in re.finditer(b"\x00\x00\x01", data)
            if m.start() + 3 < len(data)]


# ------------------------------------------------------------------ headers

@dataclass
class Vol:
    """What the VOS / VO / VOL headers and user data say."""

    width: int = 0
    height: int = 0
    time_resolution: int = 0
    time_bits: int = 1
    fixed_rate: int = 0
    mpeg_quant: bool = False
    intra_matrix: List[int] = field(default_factory=lambda: list(DEFAULT_INTRA_MATRIX))
    inter_matrix: List[int] = field(default_factory=lambda: list(DEFAULT_INTER_MATRIX))
    resync: bool = False
    profile: int = -1
    user_data: List[bytes] = field(default_factory=list)
    #: FFmpeg's FF_BUG_EDGE (old encoders): the MC edge at the VOL's size
    edge_at_size: bool = False

    @property
    def mb_width(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_height(self) -> int:
        return (self.height + 15) // 16

    @property
    def mb_num(self) -> int:
        return self.mb_width * self.mb_height


def _marker(b: Bits, what: str) -> None:
    if b.read1() != 1:
        raise Mpeg4Error(f"missing marker bit {what}")


def _refuse(what: str) -> None:
    raise Mpeg4Error(f"MPEG-4 Part 2 stream uses {what}, which the port does not decode "
                     "(it reads Simple Profile I- and P-VOPs)")


def _read_vol(b: Bits, vol: Vol) -> None:
    b.read1()  # random_accessible_vol
    b.read(8)  # video_object_type_indication
    if b.read1():
        ver_id = b.read(4)
        b.read(3)
    else:
        ver_id = 1
    if b.read(4) == 15:  # extended pixel aspect ratio
        b.read(16)
    if b.read1():  # vol_control_parameters
        b.read(2)
        b.read1()  # low_delay
        if b.read1():
            b.read(79)
    shape = b.read(2)
    if shape != 0:
        _refuse(f"a non-rectangular shape (video_object_layer_shape {shape})")
    _marker(b, "before vop_time_increment_resolution")
    vol.time_resolution = b.read(16)
    if vol.time_resolution == 0:
        raise Mpeg4Error("vop_time_increment_resolution is 0")
    vol.time_bits = max(1, (vol.time_resolution - 1).bit_length())
    _marker(b, "before fixed_vop_rate")
    if b.read1():
        vol.fixed_rate = b.read(vol.time_bits)
    _marker(b, "before the width")
    vol.width = b.read(13)
    _marker(b, "before the height")
    vol.height = b.read(13)
    _marker(b, "after the height")
    if vol.width == 0 or vol.height == 0:
        raise Mpeg4Error(f"VOL of size {vol.width}x{vol.height}")
    if b.read1():
        _refuse("interlaced video")
    b.read1()  # obmc_disable (FFmpeg ignores it)
    sprite = b.read1() if ver_id == 1 else b.read(2)
    if sprite:
        _refuse(f"sprites (sprite_enable {sprite}: S(GMC)-VOPs or a static sprite)")
    if b.read1():
        precision, bits = b.read(4), b.read(4)
        _refuse(f"N-bit video (quant_precision {precision}, bits_per_pixel {bits})")
    vol.mpeg_quant = bool(b.read1())
    if vol.mpeg_quant:
        for name in ("intra_matrix", "inter_matrix"):
            matrix = list(DEFAULT_INTRA_MATRIX if name == "intra_matrix" else DEFAULT_INTER_MATRIX)
            if b.read1():
                last, i = 0, 0
                while i < 64:
                    v = b.read(8)
                    if v == 0:
                        break
                    last = v
                    matrix[ZIGZAG[i]] = v
                    i += 1
                for j in range(i, 64):
                    matrix[ZIGZAG[j]] = last
            setattr(vol, name, matrix)
    if ver_id != 1 and b.read1():
        _refuse("quarter-pel motion compensation")
    if not b.read1():
        _refuse("complexity estimation headers")
    vol.resync = not b.read1()
    if b.read1():
        if b.read1():
            _refuse("data partitioning with reversible VLC")
        _refuse("data partitioning")
    if ver_id != 1:
        if b.read1():
            _refuse("NEWPRED")
        if b.read1():
            _refuse("reduced-resolution VOPs")
    if b.read1():
        _refuse("scalability")


def _user_data(data: bytes, vol: Vol) -> None:
    vol.user_data.append(data)
    text = data.decode("latin-1")
    m = re.match(r"DivX(\d+)(?:Build|b)(\d+)(p?)", text)
    if m:
        if m.group(3) == "p":
            _refuse(f"DivX packed bitstream (user data {text!r})")
        if int(m.group(1)) < 500:
            _refuse(f"DivX {m.group(1)} workarounds (user data {text!r})")
    if text.startswith("XviD"):
        _refuse(f"an XviD-encoded stream, which FFmpeg decodes with the Xvid IDCT (user data {text!r})")
    m = re.match(r"(?:Lavc|FFmpe)(\d+)\.(\d+)\.(\d+)", text)
    if m and (int(m.group(1)) << 16) + (int(m.group(2)) << 8) + int(m.group(3)) < 4670:
        vol.edge_at_size = True


def parse_config(data: bytes, vol: Optional[Vol] = None) -> Vol:
    """The VOS / VO / VOL headers and user data found in ``data`` (an
    ``esds`` DecoderSpecificInfo, or a sample that carries them in band)."""
    vol = vol if vol is not None else Vol()
    codes = start_codes(data)
    for i, (code, pos) in enumerate(codes):
        end = codes[i + 1][1] - 4 if i + 1 < len(codes) else len(data)
        if code == 0xB0:
            vol.profile = data[pos] if pos < len(data) else -1
        elif code == 0xB2:
            _user_data(data[pos:end], vol)
        elif 0x20 <= code <= 0x2F:
            _read_vol(Bits(data[pos:end]), vol)
        elif code == 0xB6:
            break
    return vol


@dataclass
class VopHeader:
    kind: str  # "I" or "P"
    coded: bool
    rounding: int
    dc_threshold: int
    qp: int
    fcode: int
    time_increment: int
    #: the first macroblock's bit in the sample
    bitpos: int


def read_vop_header(data: bytes, vol: Vol) -> VopHeader:
    """The VOP header of one sample (after any VOS / VOL / user data / GOV
    headers it carries, which update ``vol``). A sample with two VOPs (a
    packed bitstream) raises."""
    codes = start_codes(data)
    vops = [pos for code, pos in codes if code == 0xB6]
    if not vops:
        raise Mpeg4Error("a sample without a VOP start code")
    if len(vops) > 1:
        _refuse(f"a packed bitstream ({len(vops)} VOPs in one sample)")
    if any(0x20 <= c <= 0x2F or c == 0xB2 for c, p in codes if p < vops[0]):
        parse_config(data[:vops[0] - 4], vol)
    if vol.width == 0:
        raise Mpeg4Error("a VOP before any VOL header")
    b = Bits(data, vops[0] * 8)
    kind = b.read(2)
    if kind == 2:
        _refuse("B-VOPs")
    if kind == 3:
        _refuse("S(GMC)-VOPs")
    while b.read1():  # modulo_time_base
        pass
    _marker(b, "before vop_time_increment")
    incr = b.read(vol.time_bits)
    _marker(b, "before vop_coded")
    if not b.read1():
        return VopHeader("IP"[kind], False, 0, 0, 0, 1, incr, b.pos)
    rounding = b.read1() if kind == 1 else 0
    thr = DC_THRESHOLD[b.read(3)]
    qp = b.read(5)
    if qp == 0:
        raise Mpeg4Error("vop_quant is 0")
    fcode = b.read(3) if kind == 1 else 1
    if fcode == 0:
        raise Mpeg4Error("vop_fcode_forward is 0")
    return VopHeader("IP"[kind], True, rounding, thr, qp, fcode, incr, b.pos)


# ------------------------------------------------------------------ parse

#: columns of :func:`parse_vop`'s per-macroblock table
MB_FIELDS = ("mode", "qp", "cbp", "ac_pred", "mx0", "my0", "mx1", "my1", "mx2", "my2", "mx3", "my3")
MODE_SKIP, MODE_INTER, MODE_INTER4V, MODE_INTRA = 0, 1, 2, 3


def _mid(a: int, b: int, c: int) -> int:
    return max(min(a, b), min(max(a, b), c))


def _sext(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


class VopState:
    """The prediction state of one VOP as FFmpeg keeps it: DC values and AC
    rows / columns per block (``dc_val`` / ``ac_val``, their layouts and
    borders), motion vectors (``motion_val``), each macroblock's quantiser,
    the running quantiser and the video packet's start (``resync_mb_x`` /
    ``_y``, ``first_slice_line``). :func:`parse_vop` reads a VOP with it,
    and the fixture script's writer writes one with it."""

    def __init__(self, vol: Vol, hdr: VopHeader):
        self.mbw, self.mbh = mbw, mbh = vol.mb_width, vol.mb_height
        self.hdr = hdr
        self.b8, self.mbs = 2 * mbw + 1, mbw + 1
        # luma arrays at (2y + 1) * b8 + 2x + 1 (+1 row / col for the block),
        # chroma at (y + 1) * mbs + x + 1; the left column a border
        self.dc = [[1024] * (self.b8 * (2 * mbh + 1)), [1024] * (self.mbs * (mbh + 1)),
                   [1024] * (self.mbs * (mbh + 1))]
        self.ac = [[[0] * 16 for _ in range(len(d))] for d in self.dc]
        self.qtab = [0] * (mbw * mbh)
        # motion_val: rows of b8 after one border row, the last column of
        # each row a zero border
        self.mv = [[0, 0] for _ in range(self.b8 * (2 * mbh + 1) + 1)]
        self.qp = hdr.qp
        self.resync_x = self.resync_y = 0
        self.first_line = True
        self.ac_pred = 0

    # -- macroblocks and packets

    def start_packet(self, y: int, x: int) -> None:
        """A video packet starts at (y, x): ``ff_mpeg4_clean_buffers``."""
        self.resync_x, self.resync_y = x, y
        self.first_line = True
        b8, mbs = self.b8, self.mbs
        lxy = b8 + 1 + (2 * y - 1) * b8 + 2 * x - 1
        for j in range(max(lxy, 0), lxy + 2 * b8 + 1):
            self.ac[0][j] = [0] * 16
        cxy = mbs + 1 + (y - 1) * mbs + x - 1
        for k in (1, 2):
            for j in range(max(cxy, 0), cxy + mbs + 1):
                self.ac[k][j] = [0] * 16

    def begin_mb(self, y: int, x: int) -> None:
        if x == self.resync_x and y == self.resync_y + 1:
            self.first_line = False

    def set_quant(self, dquant_code: int) -> None:
        self.qp = min(31, max(1, self.qp + QUANT_TAB[dquant_code]))

    def clear_intra(self, y: int, x: int) -> None:
        """A macroblock that is not intra: its DC values 1024, AC 0."""
        for blk in range(6):
            k, i, _ = self.block_pos(y, x, blk)
            self.dc[k][i] = 1024
            self.ac[k][i] = [0] * 16

    # -- motion vectors

    def mv_index(self, y: int, x: int, blk: int) -> int:
        return self.b8 * (2 * y + (blk >> 1) + 1) + 2 * x + (blk & 1)

    def set_mvs(self, y: int, x: int, mvs) -> None:
        for blk in range(4):
            self.mv[self.mv_index(y, x, blk)] = list(mvs[blk])

    def pred_mv(self, y: int, x: int, blk: int) -> Tuple[int, int]:
        """``ff_h263_pred_motion`` with FFmpeg's first-slice-line rules."""
        mv, b8 = self.mv, self.b8
        i = self.mv_index(y, x, blk)
        A = mv[i - 1]
        off = (2, 1, 1, -1)[blk]
        if self.first_line and blk < 3:
            if blk == 0:
                if x == self.resync_x:
                    return 0, 0
                if x + 1 == self.resync_x:
                    C = mv[i + off - b8]
                    if x == 0:
                        return C[0], C[1]
                    return _mid(A[0], 0, C[0]), _mid(A[1], 0, C[1])
                return A[0], A[1]
            if blk == 1:
                if x + 1 == self.resync_x:
                    C = mv[i + off - b8]
                    return _mid(A[0], 0, C[0]), _mid(A[1], 0, C[1])
                return A[0], A[1]
            B, C = mv[i - b8], mv[i + off - b8]
            if x == self.resync_x:
                A[0] = A[1] = 0
            return _mid(A[0], B[0], C[0]), _mid(A[1], B[1], C[1])
        B, C = mv[i - b8], mv[i + off - b8]
        return _mid(A[0], B[0], C[0]), _mid(A[1], B[1], C[1])

    # -- intra prediction

    def block_pos(self, y: int, x: int, blk: int):
        """(array, flat index, stride) of a block's DC / AC slot."""
        if blk < 4:
            return 0, self.b8 * (2 * y + (blk >> 1) + 1) + 2 * x + (blk & 1) + 1, self.b8
        return blk - 3, self.mbs * (y + 1) + x + 1, self.mbs

    def dc_scale(self, blk: int) -> int:
        return Y_DC_SCALE[self.qp] if blk < 4 else C_DC_SCALE[self.qp]

    def dc_prediction(self, y: int, x: int, blk: int) -> Tuple[int, int]:
        """(the quantised DC prediction, its direction: 0 from the left, 1
        from above) of a block (``ff_mpeg4_pred_dc``)."""
        k, i, wrap = self.block_pos(y, x, blk)
        d = self.dc[k]
        a, b, c = d[i - 1], d[i - 1 - wrap], d[i - wrap]
        if self.first_line and blk != 3:
            if blk != 2:
                b = c = 1024
            if blk != 1 and x == self.resync_x:
                b = a = 1024
        if x == self.resync_x and y == self.resync_y + 1 and blk in (0, 4, 5):
            b = 1024
        pred, direction = (c, 1) if abs(a - b) < abs(b - c) else (a, 0)
        scale = self.dc_scale(blk)
        return (pred + (scale >> 1)) // scale, direction

    def pred_dc(self, y: int, x: int, blk: int, diff: int) -> Tuple[int, int]:
        """The block's DC level from its coded difference, stored for its
        neighbours -> (level, direction)."""
        pred, direction = self.dc_prediction(y, x, blk)
        level = diff + pred
        v = level * self.dc_scale(blk)
        if v & ~2047:
            v = 0 if v < 0 else 2047
        k, i, _ = self.block_pos(y, x, blk)
        self.dc[k][i] = v
        return level, direction

    def ac_prediction(self, y: int, x: int, blk: int, direction: int) -> List[Tuple[int, int]]:
        """(raster position, value) the AC prediction adds to an intra
        block when ``ac_pred`` is set (``ff_mpeg4_pred_ac``)."""
        k, i, wrap = self.block_pos(y, x, blk)
        acv, qp, mbw = self.ac[k], self.qp, self.mbw
        if direction == 0:
            src, nq = acv[i - 1], self.qtab[y * mbw + x - 1] if x > 0 else qp
            pos, vals = [t << 3 for t in range(1, 8)], src[1:8]
            same = x == 0 or qp == nq or blk in (1, 3)
        else:
            src, nq = acv[i - wrap], self.qtab[(y - 1) * mbw + x] if y > 0 else qp
            pos, vals = list(range(1, 8)), src[9:16]
            same = y == 0 or qp == nq or blk in (2, 3)
        return [(p, v if same else _rounded_div(v * nq, qp)) for p, v in zip(pos, vals)]

    def store_ac(self, y: int, x: int, blk: int, block: List[int]) -> None:
        """An intra block's first column and row, for its neighbours."""
        k, i, _ = self.block_pos(y, x, blk)
        dst = self.ac[k][i]
        for t in range(1, 8):
            dst[t] = block[t << 3]
            dst[8 + t] = block[t]


def _is_resync(b: Bits, kind: str, fcode: int) -> bool:
    """A video packet starts here: stuffing to the byte boundary ('0' then
    '1's), then the resync marker's zeros and its '1'."""
    p = b.pos
    stuff = 8 - (p & 7)
    if b.peek(stuff) != (1 << (stuff - 1)) - 1:
        return False
    b.pos = p + stuff
    zeros = resync_zeros(kind, fcode)
    hit = b.left() > zeros and b.peek(zeros + 1) == 1
    b.pos = p
    return hit


def resync_zeros(kind: str, fcode: int) -> int:
    """The zeros of a resync marker before its '1'."""
    return 16 if kind == "I" else 15 + fcode


def _read_mv(b: Bits, pred: int, fcode: int) -> int:
    code = b.vlc(_L["mv"])
    if code == 0:
        return pred
    sign = b.read1()
    val = code
    shift = fcode - 1
    if shift:
        val = ((val - 1) << shift | b.read(shift)) + 1
    if sign:
        val = -val
    return _sext(val + pred, 5 + fcode)


def _read_tcoef(b: Bits, intra: bool) -> Tuple[int, int, int]:
    """One TCOEF symbol, escapes 1-3 resolved -> (last, run, signed level)."""
    lut = _L["intra_tcoef" if intra else "inter_tcoef"]
    rll = INTRA_RLL if intra else INTER_RLL
    sym = b.vlc(lut)
    if sym != ESCAPE:
        last, run, level = rll[sym]
        return last, run, -level if b.read1() else level
    mode = b.read1()
    if mode == 1:
        mode += b.read1()
    if mode == 2:
        last = b.read1()
        run = b.read(6)
        _marker(b, "before an escape-3 level")
        level = _sext(b.read(12), 12)
        _marker(b, "after an escape-3 level")
        return last, run, level
    sym = b.vlc(lut)
    if sym == ESCAPE:
        raise Mpeg4Error(f"an escape inside an escape at bit {b.pos}")
    last, run, level = rll[sym]
    lmax, rmax = (INTRA_LMAX, INTRA_RMAX) if intra else (INTER_LMAX, INTER_RMAX)
    if mode == 0:
        level += int(lmax[last, run])
    else:
        run += int(rmax[last, level]) + 1
    return last, run, -level if b.read1() else level


def _read_block(b: Bits, st: VopState, y: int, x: int, blk: int, intra: bool, coded: bool,
                use_dc_vlc: bool) -> List[int]:
    """One block (``mpeg4_decode_block``): its levels in raster order."""
    block = [0] * 64
    i = -1
    scan = ZIGZAG
    if intra:
        if use_dc_vlc:
            size = b.vlc(_L["dc_lum"] if blk < 4 else _L["dc_chrom"])
            diff = 0
            if size:
                v = b.read(size)
                diff = v if v >> (size - 1) else v - (1 << size) + 1
                if size > 8:
                    _marker(b, "after a DC coefficient")
            block[0], direction = st.pred_dc(y, x, blk, diff)
            i = 0
        else:
            _, direction = st.dc_prediction(y, x, blk)
        if st.ac_pred:
            scan = ALT_VERTICAL if direction == 0 else ALT_HORIZONTAL
    if coded:
        while True:
            last, run, level = _read_tcoef(b, intra)
            i += run + 1
            if i > 63:
                raise Mpeg4Error(f"more than 64 coefficients in a block (bit {b.pos})")
            block[scan[i]] = level
            if last:
                break
    if intra:
        if not use_dc_vlc:
            block[0], direction = st.pred_dc(y, x, blk, block[0])
        if st.ac_pred:
            for p, v in st.ac_prediction(y, x, blk, direction):
                block[p] += v
        st.store_ac(y, x, blk, block)
    return block


def read_packet_header(b: Bits, vol: Vol, hdr: VopHeader) -> Tuple[int, int]:
    """A video packet header after its resync marker -> (macroblock number,
    quant_scale or 0)."""
    number = b.read(max(1, (vol.mb_num - 1).bit_length()))
    qp = b.read(5)
    if b.read1():  # header_extension_code
        while b.read1():
            pass
        _marker(b, "before the packet's vop_time_increment")
        b.read(vol.time_bits)
        _marker(b, "before the packet's vop_coding_type")
        b.read(2)
        b.read(3)
        if hdr.kind != "I":
            b.read(3)
    return number, qp


def parse_vop(data: bytes, vol: Vol, hdr: VopHeader):
    """The entropy stage of one coded VOP (see the module's text) ->
    (mb (mb_num, 12) int32 in :data:`MB_FIELDS` order, levels (mb_num * 6,
    64) int16: each block's quantised levels in raster order, intra blocks
    after DC and AC prediction)."""
    n = vol.mb_num
    mb = np.zeros((n, 12), np.int32)
    levels = np.zeros((n * 6, 64), np.int16)
    st = VopState(vol, hdr)
    b = Bits(data, hdr.bitpos)
    for index in range(n):
        y, x = divmod(index, st.mbw)
        if index > 0 and vol.resync and _is_resync(b, hdr.kind, hdr.fcode):
            b.pos += 8 - (b.pos & 7) + resync_zeros(hdr.kind, hdr.fcode) + 1
            number, qp = read_packet_header(b, vol, hdr)
            if number != index:
                raise Mpeg4Error(f"video packet header names macroblock {number}, expected {index}")
            if qp:
                st.qp = qp
            st.start_packet(y, x)
        st.begin_mb(y, x)
        row = mb[index]
        mode, dquant = MODE_INTRA, 0
        if hdr.kind == "P":
            while True:
                if b.read1():
                    mode = MODE_SKIP
                    break
                cbpc = b.vlc(_L["inter_mcbpc"])
                if cbpc != 20:
                    break
            if mode != MODE_SKIP:
                dquant = cbpc & 8
                mode = MODE_INTRA if cbpc & 4 else (MODE_INTER4V if cbpc & 16 else MODE_INTER)
        else:
            while True:
                cbpc = b.vlc(_L["intra_mcbpc"])
                if cbpc != 8:
                    break
            dquant = cbpc & 4
        if mode == MODE_SKIP:
            row[:2] = (MODE_SKIP, st.qp)
            st.set_mvs(y, x, [(0, 0)] * 4)
            st.qtab[index] = st.qp
            st.clear_intra(y, x)
            continue
        use_dc_vlc = False
        if mode == MODE_INTRA:
            st.ac_pred = b.read1()
            cbpy = b.vlc(_L["cbpy"])
            use_dc_vlc = st.qp < hdr.dc_threshold
        else:
            st.ac_pred = 0
            cbpy = b.vlc(_L["cbpy"]) ^ 15
        if dquant:
            st.set_quant(b.read(2))
        cbp = (cbpc & 3) | (cbpy << 2)
        row[:4] = (mode, st.qp, cbp, st.ac_pred)
        st.qtab[index] = st.qp
        if mode == MODE_INTER:
            px, py = st.pred_mv(y, x, 0)
            mvs = [(_read_mv(b, px, hdr.fcode), _read_mv(b, py, hdr.fcode))] * 4
            st.set_mvs(y, x, mvs)
        elif mode == MODE_INTER4V:
            mvs = []
            for blk in range(4):
                px, py = st.pred_mv(y, x, blk)
                mvs.append((_read_mv(b, px, hdr.fcode), _read_mv(b, py, hdr.fcode)))
                st.mv[st.mv_index(y, x, blk)] = list(mvs[-1])
        else:
            mvs = [(0, 0)] * 4
            st.set_mvs(y, x, mvs)
        row[4:12] = [c for mv in mvs for c in mv]
        intra = mode == MODE_INTRA
        if not intra:
            st.clear_intra(y, x)
        for blk in range(6):
            levels[index * 6 + blk] = _read_block(b, st, y, x, blk, intra, bool((cbp >> (5 - blk)) & 1),
                                                  intra and use_dc_vlc)
    return mb, levels


def _rounded_div(a: int, b: int) -> int:
    return (a + (b >> 1)) // b if a > 0 else -((-a + (b >> 1)) // b)


# ------------------------------------------------------------------ recon

W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520


def _wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


def _wrap32(x):
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def dequantize(levels: torch.Tensor, mb: torch.Tensor, vol: Vol) -> torch.Tensor:
    """Each block's coefficients (raster order) from its quantised levels:
    (mb_num * 6, 64) levels and the (mb_num, 12) macroblock table -> int64
    values as FFmpeg stores them (int16)."""
    lv = levels.to(torch.int64)
    dev = lv.device
    mode = mb[:, 0].repeat_interleave(6)
    qp = mb[:, 1].to(torch.int64).repeat_interleave(6)[:, None]
    intra = (mode == MODE_INTRA)[:, None]
    luma = (torch.arange(len(lv), device=dev) % 6 < 4)
    dcs = torch.where(luma, _table_tensor("Y_DC_SCALE", dev)[qp[:, 0]], _table_tensor("C_DC_SCALE", dev)[qp[:, 0]])
    mag, neg = lv.abs(), lv < 0
    if vol.mpeg_quant:
        wi = torch.tensor(vol.intra_matrix, dtype=torch.int64, device=dev)[None]
        wp = torch.tensor(vol.inter_matrix, dtype=torch.int64, device=dev)[None]
        v = torch.where(intra, (mag * (2 * qp) * wi) >> 4, ((2 * mag + 1) * (2 * qp) * wp) >> 5)
        v = _wrap16(torch.where(neg, -v, v) * (lv != 0))
        # mismatch control of inter blocks: an even sum flips F[7][7]'s low bit
        flip = (~intra[:, 0]) & ((v.sum(dim=1) & 1) == 0)
        v[:, 63] = torch.where(flip, v[:, 63] ^ 1, v[:, 63])
    else:
        qadd = (qp - 1) | 1
        v = mag * (2 * qp) + qadd
        v = torch.where(neg, -v, v) * (lv != 0)
        v = torch.where(intra, _wrap16(v), v.clamp(-2048, 2047))
    v[:, 0] = torch.where(intra[:, 0], _wrap16(lv[:, 0] * dcs), v[:, 0])
    return v


def _butterfly(x0, x1, x2, x3, x4, x5, x6, x7, a0):
    a1, a2, a3 = a0, a0, a0
    a0 = a0 + W2 * x2 + W4 * x4 + W6 * x6
    a1 = a1 + W6 * x2 - W4 * x4 - W2 * x6
    a2 = a2 - W6 * x2 - W4 * x4 + W2 * x6
    a3 = a3 - W2 * x2 + W4 * x4 - W6 * x6
    b0 = W1 * x1 + W3 * x3 + W5 * x5 + W7 * x7
    b1 = W3 * x1 - W7 * x3 - W1 * x5 - W5 * x7
    b2 = W5 * x1 - W1 * x3 + W7 * x5 + W3 * x7
    b3 = W7 * x1 - W5 * x3 + W3 * x5 - W1 * x7
    return [a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0]


def idct(coef: torch.Tensor) -> torch.Tensor:
    """The simple IDCT (``simple_idct_template.c``, 8-bit) as FFmpeg's x86
    build computes it, of (N, 64) raster coefficients -> (N, 8, 8) int64
    residuals before clipping: the row pass's outputs and its DC-only
    shortcut (``row[0] << 3``) saturated to int16, the column pass's
    rounding (``+ 32`` before ``* W4``) added in 16 bits."""
    r = coef.reshape(-1, 8, 8).to(torch.int64)
    dc_only = (r[:, :, 1:] == 0).all(dim=2)
    x = [r[..., k] for k in range(8)]
    rows = torch.stack(_butterfly(*x, W4 * x[0] + (1 << 10)), dim=-1)
    rows = (_wrap32(rows) >> 11).clamp(-32768, 32767)
    rows = torch.where(dc_only[..., None], (r[..., :1] * 8).clamp(-32768, 32767), rows)
    c = [rows[:, k] for k in range(8)]
    cols = torch.stack(_butterfly(*c, W4 * _wrap16(c[0] + 32)), dim=1)
    return _wrap32(cols) >> 20


def _half_pel(ref: np.ndarray, ys: np.ndarray, xs: np.ndarray, dxy: np.ndarray, rounding: int,
              h_edge: int, v_edge: int, approx: np.ndarray) -> np.ndarray:
    """(N, 8, 8) predictions: block n's sample (i, j) from the source at
    (ys[n] + i, xs[n] + j) with the half-pel ``dxy`` (bit 0 x, bit 1 y),
    coordinates clamped into [0, edge - 1]. With ``rounding`` 1, a block
    where ``approx`` holds averages x2 / y2 as FFmpeg's x86 8-wide
    ``put_no_rnd_pixels8_x2`` / ``_y2`` do (the left, or the odd row's,
    sample less 1, saturated at 0, then ``pavgb``); the others exactly."""
    i = np.arange(9)
    yy = np.clip(ys[:, None] + i[None], 0, v_edge - 1)
    xx = np.clip(xs[:, None] + i[None], 0, h_edge - 1)
    p = ref[yy[:, :, None], xx[:, None, :]].astype(np.int32)
    a, b, c, d = p[:, :-1, :-1], p[:, :-1, 1:], p[:, 1:, :-1], p[:, 1:, 1:]
    hx, hy = (dxy & 1)[:, None, None], (dxy >> 1)[:, None, None]
    if rounding:
        odd_row = (np.arange(8) % 2 == 1)[None, :, None]
        ap = approx[:, None, None]
        x2 = np.where(ap, (np.maximum(a - 1, 0) + b + 1) >> 1, (a + b) >> 1)
        top = np.where(odd_row, np.maximum(a - 1, 0), a)
        bot = np.where(odd_row, c, np.maximum(c - 1, 0))
        y2 = np.where(ap, (top + bot + 1) >> 1, (a + c) >> 1)
        xy2 = (a + b + c + d + 1) >> 2
    else:
        x2 = (a + b + 1) >> 1
        y2 = (a + c + 1) >> 1
        xy2 = (a + b + c + d + 2) >> 2
    return np.where(hx & hy, xy2, np.where(hx, x2, np.where(hy, y2, a)))


def _blocks_to_plane(blocks: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """(rows * cols, 8, 8) blocks in raster order -> (rows * 8, cols * 8)."""
    return blocks.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)


def predict(mb: np.ndarray, ref: Tuple[np.ndarray, np.ndarray, np.ndarray], vol: Vol, rounding: int):
    """The motion-compensated prediction of every block of a P-VOP from the
    reference planes (FFmpeg's ``mpeg_motion`` / ``hpel_motion`` /
    ``chroma_4mv_motion``) -> (Y, U, V) planes at the macroblock-aligned size;
    intra macroblocks' samples are left 0."""
    mbw, mbh = vol.mb_width, vol.mb_height
    h_edge = vol.width if vol.edge_at_size else mbw * 16
    v_edge = vol.height if vol.edge_at_size else mbh * 16
    n = mbw * mbh
    my_, mx_ = np.divmod(np.arange(n), mbw)
    mode = mb[:, 0]
    mvx, mvy = mb[:, 4:12:2].astype(np.int64), mb[:, 5:12:2].astype(np.int64)
    mvx[mode == MODE_SKIP] = 0
    mvy[mode == MODE_SKIP] = 0
    four = mode == MODE_INTER4V
    bx = np.array([0, 8, 0, 8])[None]
    by = np.array([0, 0, 8, 8])[None]
    sx = mx_[:, None] * 16 + bx + (mvx >> 1)
    sy = my_[:, None] * 16 + by + (mvy >> 1)
    dxy = (mvx & 1) | ((mvy & 1) << 1)
    # hpel_motion's clips of a 4MV block's source
    csx = np.clip(sx, -16, vol.width)
    csy = np.clip(sy, -16, vol.height)
    d4 = np.where(csx != vol.width, mvx & 1, 0) | np.where(csy != vol.height, (mvy & 1) << 1, 0)
    sx = np.where(four[:, None], csx, sx)
    sy = np.where(four[:, None], csy, sy)
    dxy = np.where(four[:, None], d4, dxy)
    y_pred = _half_pel(ref[0], sy.reshape(-1), sx.reshape(-1), dxy.reshape(-1), rounding, h_edge, v_edge,
                       np.repeat(four, 4))
    # luma blocks (mb, 4) -> plane
    y_plane = y_pred.reshape(mbh, mbw, 2, 2, 8, 8).transpose(0, 2, 4, 1, 3, 5).reshape(mbh * 16, mbw * 16)
    # chroma
    cmx = (mvx[:, 0] >> 1) | (mvx[:, 0] & 1)
    cmy = (mvy[:, 0] >> 1) | (mvy[:, 0] & 1)
    s_x, s_y = mvx.sum(axis=1), mvy.sum(axis=1)
    tab = np.asarray(CHROMA_ROUND)
    cmx = np.where(four, tab[s_x & 15] + ((s_x >> 3) & ~1), cmx)
    cmy = np.where(four, tab[s_y & 15] + ((s_y >> 3) & ~1), cmy)
    cdxy = (cmx & 1) | ((cmy & 1) << 1)
    csx = mx_ * 8 + (cmx >> 1)
    csy = my_ * 8 + (cmy >> 1)
    c4x = np.clip(csx, -8, vol.width >> 1)
    c4y = np.clip(csy, -8, vol.height >> 1)
    c4d = cdxy & ~np.where(c4x == vol.width >> 1, 1, 0) & ~np.where(c4y == vol.height >> 1, 2, 0)
    csx = np.where(four, c4x, csx)
    csy = np.where(four, c4y, csy)
    cdxy = np.where(four, c4d, cdxy)
    chroma = [_blocks_to_plane(_half_pel(ref[k], csy, csx, cdxy, rounding, h_edge >> 1, v_edge >> 1,
                                          np.ones(n, bool)), mbh, mbw)
              for k in (1, 2)]
    return y_plane, chroma[0], chroma[1]


def recon_vop(mb: np.ndarray, levels: np.ndarray, vol: Vol, rounding: int = 0,
              ref: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None):
    """Dequantisation, IDCT, prediction (P-VOPs, from ``ref``), add and clip
    -> (Y, U, V) uint8 planes at the macroblock-aligned size."""
    mbw, mbh = vol.mb_width, vol.mb_height
    res = idct(dequantize(torch.from_numpy(levels), torch.from_numpy(mb), vol)).numpy().reshape(mbh, mbw, 6, 8, 8)
    y_res = res[:, :, :4].reshape(mbh, mbw, 2, 2, 8, 8).transpose(0, 2, 4, 1, 3, 5).reshape(mbh * 16, mbw * 16)
    u_res = res[:, :, 4].transpose(0, 2, 1, 3).reshape(mbh * 8, mbw * 8)
    v_res = res[:, :, 5].transpose(0, 2, 1, 3).reshape(mbh * 8, mbw * 8)
    if ref is None:
        pred = (0, 0, 0)
    else:
        pred = predict(mb, ref, vol, rounding)
        intra = (mb[:, 0] == MODE_INTRA).reshape(mbh, mbw)
        ym = np.repeat(np.repeat(intra, 16, 0), 16, 1)
        cm = np.repeat(np.repeat(intra, 8, 0), 8, 1)
        pred = (np.where(ym, 0, pred[0]), np.where(cm, 0, pred[1]), np.where(cm, 0, pred[2]))
    return tuple(np.clip(p + r, 0, 255).astype(np.uint8) for p, r in zip(pred, (y_res, u_res, v_res)))


# ------------------------------------------------------------------ colour

def _round_int16(f: int) -> int:
    r = (f + (1 << 15)) >> 16
    return max(-0x7FFF, min(0x7FFF, r))


#: swscale's fixed-point YUV -> RGB coefficients for BT.601 limited range
#: (``ff_yuv2rgb_c_init_tables``: y, v->r, u->b, v->g, u->g, the y offset)
_CY = (65536 * 255) // 219
COLOUR = (_round_int16(_CY << 13), _round_int16(104597 << 13), _round_int16(132201 << 13),
          _round_int16(-53279 << 13), _round_int16(-25675 << 13), _round_int16((16 << 16) << 3))


def swscale_colour(matrix: int = 2, full_range: bool = False) -> tuple:
    """swscale's x86 YUV -> BGR coefficients as ``COLOUR`` holds them, for a
    matrix (H.264 / ISO 23001-8 ``matrix_coefficients``; swscale's table by
    ``sws_getCoefficients``) and range, as cv2 5.0.0 converts a frame that
    carries them (measured for BT.601 and BT.709, limited and full)."""
    crv, cbu, cgu, cgv = _YUV2RGB_TABLES.get(matrix, _YUV2RGB_TABLES[2])
    cy, oy = 1 << 16, 0
    if full_range:
        crv, cbu, cgu, cgv = ((c * 224) // 255 for c in (crv, cbu, cgu, cgv))
    else:
        cy, oy = _CY, 16 << 16
    return (_round_int16(cy << 13), _round_int16(crv << 13), _round_int16(cbu << 13), _round_int16(-cgv << 13),
            _round_int16(-cgu << 13), _round_int16(oy << 3))


#: swscale's ff_yuv2rgb_coeffs (crv, cbu, cgu, cgv) by matrix_coefficients
_YUV2RGB_TABLES = {1: (117489, 138438, 13975, 34925),
                   2: (104597, 132201, 25675, 53279), 5: (104597, 132201, 25675, 53279),
                   6: (104597, 132201, 25675, 53279)}


def yuv420_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, height: int, width: int,
                  coef: tuple = COLOUR) -> torch.Tensor:
    """cv2's colour rule (the module's step 4) on torch tensors: (H16, W16)
    and two (H16 / 2, W16 / 2) uint8 planes -> the (height, width, 3) uint8
    BGR frame, each term ``pmulhw``'s floor of the 16-bit product;
    ``coef`` another matrix or range (:func:`swscale_colour`)."""
    yc, vr, ub, vg, ug, yo = coef
    yy = y[:height, :width].to(torch.int32)
    uu = u.repeat_interleave(2, 0).repeat_interleave(2, 1)[:height, :width].to(torch.int32)
    vv = v.repeat_interleave(2, 0).repeat_interleave(2, 1)[:height, :width].to(torch.int32)
    luma = ((yy * 8 - yo) * yc) >> 16
    uu, vv = (uu - 128) * 8, (vv - 128) * 8
    b = luma + ((uu * ub) >> 16)
    g = luma + (((uu * ug) >> 16) + ((vv * vg) >> 16))
    r = luma + ((vv * vr) >> 16)
    return torch.stack([b, g, r], -1).clamp_(0, 255).to(torch.uint8)


# ------------------------------------------------------------------ decode


def check_codec_tag(vol: Vol, fourcc: str) -> None:
    """FFmpeg takes a stream tagged XVID (or XVIX, RMP4, ZMP4, SIPP) whose
    user data names no encoder for an Xvid one and decodes it with the Xvid
    IDCT: such a stream raises."""
    named = any(re.match(rb"(Lavc|FFmpe|XviD|DivX)", d) for d in vol.user_data)
    if not named and fourcc.upper() in ("XVID", "XVIX", "RMP4", "ZMP4", "SIPP"):
        raise Mpeg4Error(f"an MPEG-4 stream tagged {fourcc!r} with no encoder named in its user data: FFmpeg decodes "
                         "it as Xvid's, with the Xvid IDCT, which the port does not implement")


# ------------------------------------------------------------------ encode

#: the writer's one quantiser (H.263 quantisation, every macroblock)
ENCODE_QP = 3
#: an I-VOP every this many VOPs, P-VOPs between them (cv2's writer's GOP)
GOP = 12
#: a P-VOP's macroblock is coded intra when the sum of its luma samples'
#: absolute deviations from their mean, plus this, is below the sum of its
#: absolute differences from the reference
INTRA_MARGIN = 512
#: the writer's VOL: vop_time_increment_resolution (one tick a frame)
TIME_RESOLUTION = 25


class BitWriter:
    """Big-endian bits into bytes (the host's headers)."""

    def __init__(self):
        self.value, self.n = 0, 0

    def put(self, v: int, n: int) -> "BitWriter":
        self.value = (self.value << n) | (v & ((1 << n) - 1))
        self.n += n
        return self

    def stuff(self) -> "BitWriter":
        """next_start_code(): a '0' then '1's to the byte boundary."""
        k = 8 - (self.n & 7)
        return self.put((1 << (k - 1)) - 1, k)

    def bytes(self) -> bytes:
        assert self.n % 8 == 0
        return self.value.to_bytes(self.n // 8, "big")


def vol_header(width: int, height: int) -> bytes:
    """The writer's VOS, VO and VOL headers, as the MP4's ``esds`` carries
    them (the layout of cv2's writer's: Simple Profile, rectangular,
    progressive, H.263 quantisation, no resync markers)."""
    w = BitWriter()
    w.put(0x1B0, 32).put(1, 8)  # profile_and_level_indication: Simple, level 1
    w.put(0x1B5, 32).put(1, 1).put(1, 4).put(1, 3).put(1, 4).put(0, 1).stuff()
    w.put(0x100, 32)
    w.put(0x120, 32).put(0, 1).put(1, 8).put(1, 1).put(1, 4).put(1, 3).put(1, 4)
    w.put(1, 1).put(1, 2).put(1, 1).put(0, 1)  # vol_control: 4:2:0, low_delay, no vbv
    w.put(0, 2).put(1, 1).put(TIME_RESOLUTION, 16).put(1, 1).put(0, 1)
    w.put(1, 1).put(width, 13).put(1, 1).put(height, 13).put(1, 1)
    w.put(0, 1).put(1, 1).put(0, 1).put(0, 1)  # progressive, obmc_disable, no sprite, 8 bit
    w.put(0, 1).put(1, 1).put(1, 1).put(0, 1).put(0, 1).stuff()  # H.263 quant, no estimation / resync / partitions
    return w.bytes()


def vop_start(kind: str, frame: int) -> BitWriter:
    """A VOP's start code, coding type and time (VOP number ``frame`` in
    ticks of :data:`TIME_RESOLUTION`), up to ``vop_coded``."""
    w = BitWriter().put(0x1B6, 32).put("IP".index(kind), 2)
    seconds = frame // TIME_RESOLUTION - (frame - 1) // TIME_RESOLUTION if frame else 0
    for _ in range(seconds):
        w.put(1, 1)
    return w.put(0, 1).put(1, 1).put(frame % TIME_RESOLUTION, max(1, (TIME_RESOLUTION - 1).bit_length())).put(1, 1)


def vop_header(kind: str, frame: int) -> BitWriter:
    """The writer's VOP header: coded, rounding type 0, DC as DC
    (``intra_dc_vlc_thr`` 0), :data:`ENCODE_QP`, ``f_code`` 1."""
    w = vop_start(kind, frame).put(1, 1)
    if kind == "P":
        w.put(0, 1)
    w.put(0, 3).put(ENCODE_QP, 5)
    if kind == "P":
        w.put(1, 3)
    return w


@functools.lru_cache(maxsize=None)
def _dct_matrix(device) -> torch.Tensor:
    k = torch.arange(8, dtype=torch.float64, device=device)
    d = torch.cos((2 * k[None] + 1) * k[:, None] * torch.pi / 16) * 0.5
    d[0] /= 2 ** 0.5
    return d


def fdct(blocks: torch.Tensor) -> torch.Tensor:
    """(N, 8, 8) samples -> the orthonormal 2-D DCT (the scale FFmpeg's IDCT
    inverts: F[0][0] = 8 * mean), rounded to int64."""
    d = _dct_matrix(blocks.device)
    return torch.round(d @ blocks.to(torch.float64) @ d.T).to(torch.int64)


def bgr_to_yuv420(frame: torch.Tensor, mb_height: int, mb_width: int):
    """An (H, W, 3) uint8 BGR tensor -> BT.601 limited-range Y, U, V planes
    at the macroblock-aligned size (edges repeated; chroma the rounded mean
    of each 2x2 block), int64."""
    h, w = frame.shape[:2]
    f = frame.to(torch.int64)
    f = torch.nn.functional.pad(f.permute(2, 0, 1)[None].float(), (0, mb_width * 16 - w, 0, mb_height * 16 - h),
                                mode="replicate")[0].to(torch.int64)
    b, g, r = f[0], f[1], f[2]
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
    u = ((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128
    v = ((112 * r - 94 * g - 18 * b + 128) >> 8) + 128

    def down(p):
        return (p.reshape(mb_height * 8, 2, mb_width * 8, 2).sum(dim=(1, 3)) + 2) >> 2

    return y, down(u), down(v)


def _to_blocks(plane: torch.Tensor, size: int) -> torch.Tensor:
    """(rows * size, cols * size) -> (rows * cols, size, size), raster order."""
    h, w = plane.shape
    return plane.reshape(h // size, size, w // size, size).transpose(1, 2).reshape(-1, size, size)


def _mb_blocks(y, u, v) -> torch.Tensor:
    """Planes -> (mb_num, 6, 8, 8): each macroblock's four luma and two chroma
    blocks in coding order."""
    mbh, mbw = u.shape[0] // 8, u.shape[1] // 8
    yb = y.reshape(mbh, 2, 8, mbw, 2, 8).permute(0, 3, 1, 4, 2, 5).reshape(mbh * mbw, 4, 8, 8)
    return torch.cat([yb, _to_blocks(u, 8)[:, None], _to_blocks(v, 8)[:, None]], dim=1)


def _from_mb_blocks(blocks: torch.Tensor, mbh: int, mbw: int):
    y = blocks[:, :4].reshape(mbh, mbw, 2, 2, 8, 8).permute(0, 2, 4, 1, 3, 5).reshape(mbh * 16, mbw * 16)
    u = blocks[:, 4].reshape(mbh, mbw, 8, 8).permute(0, 2, 1, 3).reshape(mbh * 8, mbw * 8)
    v = blocks[:, 5].reshape(mbh, mbw, 8, 8).permute(0, 2, 1, 3).reshape(mbh * 8, mbw * 8)
    return y, u, v


@functools.lru_cache(maxsize=None)
def _code_tables(intra: bool, device):
    """(code, length) of each (last, run, level) of the intra or inter TCOEF
    table as dense (2, 64, 64) tensors on ``device`` (length 0 where the
    table has no code), and its LMAX / RMAX."""
    vlc, rll = (INTRA_VLC, INTRA_RLL) if intra else (INTER_VLC, INTER_RLL)
    code = torch.zeros(2, 64, 64, dtype=torch.int64)
    length = torch.zeros(2, 64, 64, dtype=torch.int64)
    for (c, n), (last, run, level) in zip(vlc, rll):
        code[last, run, level], length[last, run, level] = c, n
    lmax, rmax = _max_tables(rll)
    return (code.to(device), length.to(device), torch.from_numpy(lmax).long().to(device),
            torch.from_numpy(rmax).long().to(device))


def _tcoef_symbols(levels: torch.Tensor, coded: torch.Tensor, intra: torch.Tensor, first: torch.Tensor):
    """The TCOEF symbols of every block: ``levels`` (N, 64) in scan order,
    ``coded`` (N,) which blocks carry coefficients, ``intra`` (N,) which use
    the intra table, ``first`` (N,) the scan position before the first
    coefficient's (0 after an intra DC, -1 otherwise) -> (block, scan
    position, value, length) of each symbol (sign and escapes included)."""
    dev = levels.device
    sel = (levels != 0) & coded[:, None]
    sel[:, 0] &= first == -1
    blk, pos = sel.nonzero(as_tuple=True)
    lev = levels[blk, pos]
    # the previous coefficient's position in the same block
    prev = torch.full_like(pos, -1)
    same = torch.zeros_like(pos, dtype=torch.bool)
    if len(pos) > 1:
        same[1:] = blk[1:] == blk[:-1]
        prev[1:] = torch.where(same[1:], pos[:-1], prev[1:])
    prev = torch.where(same, prev, first[blk])
    run = pos - prev - 1
    last = torch.ones_like(pos)
    if len(pos) > 1:
        last[:-1] = (blk[1:] != blk[:-1]).long()
    mag = lev.abs().clamp(max=2047)
    sign = (lev < 0).long()
    value = torch.zeros_like(pos)
    length = torch.zeros_like(pos)
    for table, which in ((_code_tables(True, dev), intra[blk]), (_code_tables(False, dev), ~intra[blk])):
        code, clen, lmax, rmax = table
        m63 = mag.clamp(max=63)
        lm = lmax[last, run]
        direct = clen[last, run, m63] * (mag <= 63)
        # escape 1: the level less LMAX
        l1 = (mag - lm).clamp(0, 63)
        e1 = (lm > 0) & (mag > lm) & (clen[last, run, l1] > 0) & (mag - lm <= 63)
        # escape 2: the run less RMAX + 1
        r2 = run - rmax[last, m63] - 1
        r2c = r2.clamp(0, 63)
        e2 = (mag <= lmax[last, 0]) & (r2 >= 0) & (clen[last, r2c, m63] > 0)
        n1, n2 = clen[last, run, l1], clen[last, r2c, m63]
        esc = 3
        v_direct = (code[last, run, m63] << 1) | sign
        v1 = (((esc << 1) << n1 | code[last, run, l1]) << 1) | sign
        v2 = (((esc << 2 | 2) << n2 | code[last, r2c, m63]) << 1) | sign
        v3 = (esc << 23) | (3 << 21) | (last << 20) | (run << 14) | (1 << 13) | ((lev.clamp(-2047, 2047) & 0xFFF) << 1) | 1
        val = torch.where(direct > 0, v_direct, torch.where(e1, v1, torch.where(e2, v2, v3)))
        ln = torch.where(direct > 0, direct + 1, torch.where(e1, n1 + 9, torch.where(e2, n2 + 10, torch.full_like(n1, 30))))
        value = torch.where(which, val, value)
        length = torch.where(which, ln, length)
    return blk, pos, value, length


def pack_bits(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Symbols (each at most 32 bits, in order) -> their bits packed into a
    uint8 tensor, the last byte's unused bits 0."""
    total = int(lengths.sum())
    if total == 0:
        return torch.zeros(0, dtype=torch.uint8, device=values.device)
    ends = torch.cumsum(lengths, 0)
    sym = torch.repeat_interleave(torch.arange(len(lengths), device=values.device), lengths)
    k = torch.arange(total, device=values.device) - (ends - lengths)[sym]
    bits = (values[sym] >> (lengths[sym] - 1 - k)) & 1
    bits = torch.nn.functional.pad(bits, (0, (-total) % 8)).reshape(-1, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=values.device)
    return (bits * weights).sum(dim=1).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _table_tensor(name: str, device) -> torch.Tensor:
    return torch.tensor(globals()[name], dtype=torch.int64, device=device)


def _vlc_lookup(name: str, index: torch.Tensor):
    """(code, length) of each index into the VLC table named ``name``."""
    t = _table_tensor(name, index.device)
    return t[index, 0], t[index, 1]


def _dc_symbols(diff: torch.Tensor, luma: torch.Tensor):
    """dct_dc_size, the differential and its marker of each intra block."""
    mag = diff.abs()
    size = torch.zeros_like(mag)
    for k in range(1, 13):
        size += (mag >= (1 << (k - 1))).long()
    bits = torch.where(diff >= 0, diff, diff + (1 << size) - 1)
    c_l, n_l = _vlc_lookup("DC_LUM", size)
    c_c, n_c = _vlc_lookup("DC_CHROM", size)
    code, n = torch.where(luma, c_l, c_c), torch.where(luma, n_l, n_c)
    marker = (size > 8).long()
    return ((code << size | bits) << marker) | marker, n + size + marker


def encode_vop(frame: torch.Tensor, index: int, ref=None):
    """One VOP of the writer (see the module's text) from an (H, W, 3) uint8
    BGR tensor on any device: an I-VOP when ``ref`` is None, else a P-VOP
    against ``ref`` (the previous VOP's reconstruction) -> (the VOP's bytes,
    its reconstruction: (Y, U, V) int64 planes at the macroblock-aligned
    size, what the decoder rebuilds)."""
    dev = frame.device
    qp = ENCODE_QP
    h, w = frame.shape[:2]
    mbh, mbw = (h + 15) // 16, (w + 15) // 16
    n = mbh * mbw
    cur = _mb_blocks(*bgr_to_yuv420(frame, mbh, mbw))  # (n, 6, 8, 8)
    kind = "I" if ref is None else "P"
    luma = (torch.arange(6, device=dev) < 4)[None].expand(n, 6)
    if ref is None:
        intra_mb = torch.ones(n, dtype=torch.bool, device=dev)
        pred = torch.zeros_like(cur)
    else:
        pred = _mb_blocks(*ref)
        inter_cost = (cur[:, :4] - pred[:, :4]).abs().sum(dim=(1, 2, 3))
        mean = cur[:, :4].sum(dim=(1, 2, 3), keepdim=True) // 256
        intra_cost = (cur[:, :4] - mean).abs().sum(dim=(1, 2, 3))
        intra_mb = intra_cost + INTRA_MARGIN < inter_cost
    intra = intra_mb[:, None].expand(n, 6)
    coef = fdct(torch.where(intra[..., None, None], cur, cur - pred).reshape(-1, 8, 8)).reshape(n, 6, 64)
    mag = coef.abs()
    quant = torch.where(intra[..., None], (mag * 8 + 3 * qp) // (16 * qp), ((mag * 8 - 2 * qp) // (16 * qp)).clamp(min=0))
    levels = torch.where(coef < 0, -quant, quant).clamp(-2047, 2047)
    dcs = torch.where(luma, Y_DC_SCALE[qp], C_DC_SCALE[qp])
    dc_level = (coef[..., 0] + (dcs >> 1)) // dcs
    levels[..., 0] = torch.where(intra, dc_level, levels[..., 0])
    # the reconstruction, as the decoder rebuilds it
    mb_table = torch.zeros(n, 12, dtype=torch.int64, device=dev)
    mb_table[:, 0] = torch.where(intra_mb, MODE_INTRA, MODE_INTER)
    mb_table[:, 1] = qp
    vol = Vol(width=w, height=h)
    res = idct(dequantize(levels.reshape(-1, 64), mb_table, vol)).reshape(n, 6, 8, 8)
    recon = torch.where(intra[..., None, None], res, pred + res).clamp(0, 255)
    # DC prediction (one video packet: neighbours outside the VOP or not
    # intra give 1024)
    dcv = torch.where(intra, (dc_level * dcs).clamp(0, 2047), 1024)
    luma_grid = dcv[:, :4].reshape(mbh, mbw, 2, 2).permute(0, 2, 1, 3).reshape(2 * mbh, 2 * mbw)
    preds = []
    for grid, scale in ((luma_grid, dcs[:, :4].reshape(mbh, mbw, 2, 2).permute(0, 2, 1, 3).reshape(2 * mbh, 2 * mbw)),
                        (dcv[:, 4].reshape(mbh, mbw), dcs[:, 4].reshape(mbh, mbw)),
                        (dcv[:, 5].reshape(mbh, mbw), dcs[:, 5].reshape(mbh, mbw))):
        g = torch.nn.functional.pad(grid, (1, 0, 1, 0), value=1024)
        a, b, c = g[1:, :-1], g[:-1, :-1], g[:-1, 1:]
        p = torch.where((a - b).abs() < (b - c).abs(), c, a)
        preds.append((p + (scale >> 1)) // scale)
    pred_dc = torch.cat([preds[0].reshape(mbh, 2, mbw, 2).permute(0, 2, 1, 3).reshape(n, 4),
                         preds[1].reshape(n, 1), preds[2].reshape(n, 1)], dim=1)
    dc_diff = dc_level - pred_dc
    # coded blocks and macroblocks
    zz = _table_tensor("ZIGZAG", dev)
    scanned = levels[..., zz]
    ac_coded = (scanned[..., 1:] != 0).any(dim=-1)
    coded = torch.where(intra, ac_coded, (scanned != 0).any(dim=-1))
    weights = torch.tensor([32, 16, 8, 4, 2, 1], device=dev)
    cbp = (coded.long() * weights).sum(dim=1)
    skip = ~intra_mb & (cbp == 0)
    cbpc, cbpy = cbp & 3, cbp >> 2
    if kind == "I":
        c1, n1 = _vlc_lookup("INTRA_MCBPC", cbpc)
        c2, n2 = _vlc_lookup("CBPY", cbpy)
        head_v, head_n = (c1 << (1 + n2)) | c2, n1 + 1 + n2  # MCBPC, ac_pred_flag 0, CBPY
    else:
        c1, n1 = _vlc_lookup("INTER_MCBPC", torch.where(intra_mb, 4, 0) + cbpc)
        c2, n2 = _vlc_lookup("CBPY", torch.where(intra_mb, cbpy, cbpy ^ 15))
        # not_coded 0, MCBPC, then ac_pred_flag 0 and CBPY (intra) or CBPY and
        # the MVDs x and y, '1' '1' (inter: a zero MV against a zero prediction)
        head_v = torch.where(intra_mb, (c1 << (1 + n2)) | c2, (((c1 << n2) | c2) << 2) | 3)
        head_n = 1 + n1 + n2 + torch.where(intra_mb, 1, 2)
        head_v = torch.where(skip, 1, head_v)
        head_n = torch.where(skip, 1, head_n)
    dc_v, dc_n = _dc_symbols(dc_diff.reshape(-1), luma.reshape(-1))
    flat_intra = intra.reshape(-1)
    dc_n = torch.where(flat_intra, dc_n, 0)
    blk, pos, tv, tn = _tcoef_symbols(scanned.reshape(-1, 64), coded.reshape(-1) & ~skip.repeat_interleave(6),
                                      flat_intra, torch.where(flat_intra, 0, -1))
    slots = 1 + 6 * 65
    mbi = torch.arange(n, device=dev)
    bi = torch.arange(6 * n, device=dev)
    keys = torch.cat([mbi * slots, (bi // 6) * slots + 1 + (bi % 6) * 65, (blk // 6) * slots + 1 + (blk % 6) * 65 + 1 + pos])
    vals = torch.cat([head_v, dc_v, tv])
    lens = torch.cat([head_n, dc_n, tn])
    order = torch.argsort(keys, stable=True)
    hdr = vop_header(kind, index)
    stuff = 8 - ((hdr.n + int(lens.sum())) & 7)
    vals = torch.cat([torch.tensor([hdr.value >> 32, hdr.value & 0xFFFFFFFF], device=dev), vals[order],
                      torch.tensor([(1 << (stuff - 1)) - 1], device=dev)])
    lens = torch.cat([torch.tensor([hdr.n - 32, 32], device=dev), lens[order], torch.tensor([stuff], device=dev)])
    data = pack_bits(vals, lens).cpu().numpy().tobytes()
    planes = _from_mb_blocks(torch.where(skip[:, None, None, None], pred, recon), mbh, mbw)
    return data, planes


class Encoder:
    """The writer's stream state: ``encode(frame)`` -> (VOP bytes, whether
    it is an I-VOP); ``config`` the VOS / VO / VOL headers for the MP4's
    ``esds``. Frames must keep the size the encoder was made for; an odd
    width or height is cut to the even size below it, as cv2's writer cuts
    it (``width`` and ``height`` are the stream's)."""

    def __init__(self, width: int, height: int):
        self.frame_size = (height, width)
        self.width, self.height = width & ~1, height & ~1
        self.config = vol_header(self.width, self.height)
        self.count = 0
        self.ref = None

    def encode(self, frame: torch.Tensor) -> Tuple[bytes, bool]:
        global encodes
        if tuple(frame.shape) != (*self.frame_size, 3):
            raise ValueError(f"a frame of {tuple(frame.shape)}, the encoder takes {self.frame_size} x 3")
        key = self.count % GOP == 0
        data, self.ref = encode_vop(frame[:self.height, :self.width], self.count, None if key else self.ref)
        self.count += 1
        encodes += 1
        return data, key


#: frames the writer has encoded
encodes = 0
