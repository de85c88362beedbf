"""JPEG 2000 (ISO/IEC 15444-1) read as cv2 5.0.0 reads it through
OpenJPEG, and a lossless ``.jp2`` writer, on numpy.

Reading runs in stages, each a function here, which the card's decoder
(``data/jpeg2000_cuda.py``) shares up to tier-2 and then replaces by its
kernels (``csrc/jpeg2000.cu``):

1. :func:`prepare`: the ``jP`` boxes (``ihdr``, ``colr``, ``pclr`` /
   ``cmap``, ``cdef``, ``jp2c``) or a raw ``FF 4F FF 51`` codestream; the
   markers (SIZ, COD, COC, QCD, QCC, RGN, POC, PPM, PPT, SOT / SOD / EOC;
   TLM, PLM, PLT, CRG and COM skipped); tiles, tile-parts and each
   tile-component's geometry; tier-2 (tag trees, packet headers with SOP /
   EPH, layers, precincts, the five progression orders and POC) into a
   :class:`Plan`: per code-block its bytes cut into terminated segments,
   its passes, its coded bit-planes, its band and its style.
2. :func:`tier1`: the EBCOT passes driven by the MQ decoder (47 states,
   19 contexts) for every code-block, with BYPASS, RESET, TERMALL, VSC,
   PTERM and SEGSYM and ROI maxshift, into one int32 buffer that holds each
   tile-component's subbands in OpenJPEG's layout (LL top left, then HL,
   LH, HH of each resolution), each value with the one extra fractional bit
   OpenJPEG keeps (twice the coefficient, plus half a step).
3. :func:`inverse_dwt`: dequantisation (5/3: halved as C halves an int;
   9/7: times half the step in float32) and the inverse wavelet, OpenJPEG's
   order: each resolution rows then columns, 5/3 integer lifting, 9/7
   float32 lifting with OpenJPEG's constants and steps (no fused
   multiply-add).
4. :func:`mct_store`: inverse RCT (5/3) or ICT (9/7, float32) of the first
   three components where the tile asks for it, the DC level shift, float
   rounding as ``lrintf`` (half to even), clipping to the precision, then
   cv2's output rule (:func:`output_rule`) into one (H, W[, C]) array.

cv2's rules (``grfmt_jpeg2000_openjpeg.cpp``), measured against cv2 5.0.0
here: a signed component, a precision below 8, more than 4 components, a
subsampled component or an image offset make cv2 return None, and the port
raises naming the form. ``IMREAD_UNCHANGED`` gives uint8 at precision 8
and uint16 (values as decoded, not scaled) at 9-16; ``IMREAD_COLOR`` and
``IMREAD_GRAYSCALE`` give uint8, each value shifted right by the precision
less 8. By the ``colr`` colour space: sRGB (and a raw codestream, which cv2
takes for sRGB) gives gray from one or two components, BGR / BGRA from
three or four, gray of three by cvtColor's 15-bit rule, and nothing for
colour from fewer than three; gray repeats the first component into BGR
under ``IMREAD_COLOR`` and has no 2-channel ``IMREAD_UNCHANGED``. An sYCC
``colr`` of three components gives the luma as gray and cvtColor's
``COLOR_YUV2BGR`` of (Y, Cb, Cr) as colour, as cv2 does. A palette (``pclr`` /
``cmap``) and channel definitions (``cdef``) are applied as OpenJPEG
applies them before cv2 sees the components.

:func:`encode` writes lossless ``.jp2``: one tile, 5/3, RCT for three or
more components, one layer, LRCP, 64x64 code-blocks and up to five
decomposition levels, for gray, BGR and BGRA, uint8 and uint16; cv2 reads
each back equal. Below 32 pixels on a side it raises, as cv2's writer fails
there. Keyword options (code-block styles, precincts, progression, SOP /
EPH, packed headers, ROI shift, a raw codestream) exist for the fixture
script (``tests/make_jpeg2000_fixtures.py``).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from dspnet_torch.data import cvt_color

IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR = -1, 0, 1

JP2_MAGIC = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_MAGIC = b"\xff\x4f\xff\x51"

#: code-block style bits (COD / COC SPcod byte 4)
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32
#: progression orders by their COD number
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
#: ``colr`` enumerated colour spaces cv2 reads
SRGB, GRAY, SYCC = 16, 17, 18

#: OpenJPEG's 9/7 lifting constants (``dwt.c``), float32, each with the sign
#: its lifting step adds it with
ALPHA = np.float32(1.586134342)
BETA = np.float32(0.052980118)
GAMMA = np.float32(-0.882911075)
DELTA = np.float32(-0.443506852)
K = np.float32(1.230174105)
TWO_INV_K = np.float32(1.625732422)
#: OpenJPEG's ICT (``mct.c``), float32
ICT_RV, ICT_GU, ICT_GV, ICT_BU = (np.float32(v) for v in (1.402, 0.34413, 0.71414, 1.772))


def is_jpeg2000(data: bytes) -> bool:
    return data[:12] == JP2_MAGIC or data[:4] == J2K_MAGIC


def image_size(data: bytes) -> Tuple[int, int]:
    """(height, width) from SIZ, without tier-2."""
    cs = read_boxes(bytes(data)).codestream
    if cs[:4] != J2K_MAGIC:
        raise ValueError("JPEG 2000 codestream does not start with SOC SIZ")
    xs, ys, xo, yo = struct.unpack_from(">IIII", cs, 8)
    return ys - yo, xs - xo


# ------------------------------------------------------------------ boxes


@dataclass
class Boxes:
    codestream: bytes
    colour: Optional[int] = None  # enumcs of the first colr box; None for a raw codestream
    pclr: Optional[np.ndarray] = None  # the palette's entries, (n, columns) int64
    cmap: Optional[List[Tuple[int, int, int]]] = None  # (cmp, mtyp, pcol)
    cdef: Optional[List[Tuple[int, int, int]]] = None  # (cn, typ, asoc)


def _boxes(data: bytes, pos: int, end: int):
    while pos + 8 <= end:
        length, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if length == 1:
            (length,) = struct.unpack_from(">Q", data, pos + 8)
            head = 16
        elif length == 0:
            length = end - pos
        if length < head or pos + length > end:
            raise ValueError(f"JPEG 2000 box {kind!r} of {length} bytes overruns the file")
        yield kind, pos + head, pos + length
        pos += length


def read_boxes(data: bytes) -> Boxes:
    """A ``.jp2`` file's boxes, or a raw codestream as it is."""
    if data[:4] == J2K_MAGIC:
        return Boxes(data)
    if data[:12] != JP2_MAGIC:
        raise ValueError("not a JPEG 2000 file")
    out, header = None, {}
    for kind, a, b in _boxes(data, 12, len(data)):
        if kind == b"jp2h":
            for sub, c, d in _boxes(data, a, b):
                body = data[c:d]
                if sub == b"colr" and "colr" not in header:  # enumerated (1), else an ICC profile
                    header["colr"] = struct.unpack_from(">I", body, 3)[0] if body[0] == 1 else None
                elif sub == b"pclr":
                    n, nc = struct.unpack_from(">HB", body)
                    depths = [(x & 0x7F) + 1 for x in body[3:3 + nc]]
                    signed = [bool(x & 0x80) for x in body[3:3 + nc]]
                    pos, entries = 3 + nc, np.zeros((n, nc), np.int64)
                    for i in range(n):
                        for j in range(nc):
                            size = (depths[j] + 7) // 8
                            v = int.from_bytes(body[pos:pos + size], "big")
                            pos += size
                            if signed[j] and v >= 1 << (depths[j] - 1):
                                v -= 1 << depths[j]
                            entries[i, j] = v
                    header["pclr"] = entries
                elif sub == b"cmap":
                    header["cmap"] = [struct.unpack_from(">HBB", body, 4 * i) for i in range(len(body) // 4)]
                elif sub == b"cdef":
                    (n,) = struct.unpack_from(">H", body)
                    header["cdef"] = [struct.unpack_from(">HHH", body, 2 + 6 * i) for i in range(n)]
        elif kind == b"jp2c" and out is None:
            out = data[a:b]
    if out is None:
        raise ValueError("JPEG 2000 file without a jp2c box")
    return Boxes(out, header.get("colr"), header.get("pclr"), header.get("cmap"), header.get("cdef"))


# ---------------------------------------------------------------- markers


@dataclass
class Coding:
    """COD / COC for one component: levels, code-block exponents, style,
    transform (1: 5/3, 0: 9/7), precinct exponents per resolution."""

    levels: int
    xcb: int
    ycb: int
    style: int
    reversible: bool
    precincts: List[Tuple[int, int]]


@dataclass
class Quant:
    guard: int
    style: int  # 0 none, 1 scalar derived, 2 scalar expounded
    steps: List[Tuple[int, int]]  # (exponent, mantissa) per band index

    def step(self, band: int) -> Tuple[int, int]:
        if self.style == 1:
            expn, mant = self.steps[0]
            return max(expn - (band - 1) // 3, 0) if band else expn, mant
        if band >= len(self.steps):
            raise ValueError(f"JPEG 2000 QCD/QCC lists {len(self.steps)} bands, band {band} is read")
        return self.steps[band]


@dataclass
class Header:
    """COD's tile-wide fields and the per-component overrides of one
    header (main or tile)."""

    cod: Optional[dict] = None
    coc: Dict[int, Coding] = field(default_factory=dict)
    qcd: Optional[Quant] = None
    qcc: Dict[int, Quant] = field(default_factory=dict)
    rgn: Dict[int, int] = field(default_factory=dict)
    poc: List[Tuple[int, int, int, int, int, int]] = field(default_factory=list)


@dataclass
class Codestream:
    width: int
    height: int
    x0: int
    y0: int
    tw: int
    th: int
    tx0: int
    ty0: int
    prec: List[int]
    signed: List[bool]
    dx: List[int]
    dy: List[int]
    main: Header
    tiles: Dict[int, dict]  # index -> {"header": Header, "data": bytes, "ppt": bytes, "ppm": bytes or None}

    @property
    def ntx(self) -> int:
        return -(-(self.width - self.tx0) // self.tw)

    @property
    def nty(self) -> int:
        return -(-(self.height - self.ty0) // self.th)


def _coding(body: bytes, pos: int, precincts: bool) -> Coding:
    levels, xcb, ycb, style, transform = body[pos:pos + 5]
    if levels > 32:
        raise ValueError(f"JPEG 2000 with {levels} decomposition levels")
    if xcb > 8 or ycb > 8 or xcb + ycb > 8:
        raise ValueError(f"JPEG 2000 code-block exponents {xcb + 2}, {ycb + 2} are not allowed")
    if style & 0x40:
        raise ValueError("JPEG 2000 high-throughput (HTJ2K) code-blocks are not read")
    pp = ([(b & 15, b >> 4) for b in body[pos + 5:pos + 6 + levels]] if precincts
          else [(15, 15)] * (levels + 1))
    if len(pp) != levels + 1:
        raise ValueError("JPEG 2000 COD/COC ends inside its precinct sizes")
    if transform not in (0, 1):
        raise ValueError(f"JPEG 2000 wavelet transform {transform} (Part 2) is not read")
    return Coding(levels, xcb + 2, ycb + 2, style, transform == 1, pp)


def _quant(body: bytes, pos: int) -> Quant:
    sq = body[pos]
    style, guard = sq & 31, sq >> 5
    rest = body[pos + 1:]
    if style == 0:
        steps = [(b >> 3, 0) for b in rest]
    elif style in (1, 2):
        steps = [(v >> 11, v & 0x7FF) for v in struct.unpack(f">{len(rest) // 2}H", rest[:len(rest) // 2 * 2])]
    else:
        raise ValueError(f"JPEG 2000 quantisation style {style} does not exist")
    return Quant(guard, style, steps)


def _segment(hdr: Header, marker: int, body: bytes, ncomp: int) -> None:
    cb = 1 if ncomp < 257 else 2

    def comp(pos):
        return body[pos] if cb == 1 else struct.unpack_from(">H", body, pos)[0]

    if marker == 0xFF52:  # COD
        scod, prog, layers, mct = struct.unpack_from(">BBHB", body)
        if prog > 4:
            raise ValueError(f"JPEG 2000 progression order {prog} does not exist")
        hdr.cod = {"sop": bool(scod & 2), "eph": bool(scod & 4), "prog": prog, "layers": layers, "mct": mct,
                   "coding": _coding(body, 5, bool(scod & 1))}
    elif marker == 0xFF53:  # COC
        c = comp(0)
        hdr.coc[c] = _coding(body, cb + 1, bool(body[cb] & 1))
    elif marker == 0xFF5C:  # QCD
        hdr.qcd = _quant(body, 0)
    elif marker == 0xFF5D:  # QCC
        hdr.qcc[comp(0)] = _quant(body, cb)
    elif marker == 0xFF5E:  # RGN
        c = comp(0)
        if body[cb] != 0:
            raise ValueError(f"JPEG 2000 ROI style {body[cb]} (only maxshift, 0, exists)")
        hdr.rgn[c] = body[cb + 1]
    elif marker == 0xFF5F:  # POC
        size = 5 + 2 * cb
        for i in range(len(body) // size):
            p = i * size
            rs = body[p]
            cs = comp(p + 1)
            (lye,) = struct.unpack_from(">H", body, p + 1 + cb)
            re = body[p + 3 + cb]
            ce = comp(p + 4 + cb)
            if cb == 1 and ce == 0:
                ce = 256
            pp = body[p + 4 + 2 * cb]
            if pp > 4:
                raise ValueError(f"JPEG 2000 POC progression {pp} does not exist")
            hdr.poc.append((rs, cs, lye, re, ce, pp))


def parse_codestream(cs: bytes) -> Codestream:
    if cs[:4] != J2K_MAGIC:
        raise ValueError("JPEG 2000 codestream does not start with SOC SIZ")
    (lsiz,) = struct.unpack_from(">H", cs, 4)
    rsiz, xs, ys, xo, yo, xt, yt, xto, yto, nc = struct.unpack_from(">HIIIIIIIIH", cs, 6)
    if not (0 < nc <= 16384) or xs <= xo or ys <= yo or xt == 0 or yt == 0 or xto > xo or yto > yo \
            or xto + xt <= xo or yto + yt <= yo:
        raise ValueError("JPEG 2000 SIZ describes no image")
    prec, signed, dx, dy = [], [], [], []
    for c in range(nc):
        s, rx, ry = cs[42 + 3 * c:45 + 3 * c]
        prec.append((s & 0x7F) + 1)
        signed.append(bool(s & 0x80))
        dx.append(rx)
        dy.append(ry)
        if rx == 0 or ry == 0:
            raise ValueError("JPEG 2000 component with subsampling 0")
    main = Header()
    pos = 4 + lsiz
    ppm = []
    tiles: Dict[int, dict] = {}
    tile_parts = []  # tile index per tile-part, in codestream order (PPM's order)
    while pos + 2 <= len(cs):
        (marker,) = struct.unpack_from(">H", cs, pos)
        if marker == 0xFF90:  # SOT
            lsot, isot, psot, tpsot, tnsot = struct.unpack_from(">HHIBB", cs, pos + 2)
            start = pos
            pos += 2 + lsot
            tile = tiles.setdefault(isot, {"header": Header(), "data": [], "ppt": {}, "parts": 0})
            while True:
                (m,) = struct.unpack_from(">H", cs, pos)
                if m == 0xFF93:  # SOD
                    pos += 2
                    break
                (ln,) = struct.unpack_from(">H", cs, pos + 2)
                body = cs[pos + 4:pos + 2 + ln]
                if m == 0xFF61:  # PPT
                    tile["ppt"][body[0]] = body[1:]
                elif m in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F):
                    if tpsot > 0 and m != 0xFF5F:
                        raise ValueError("JPEG 2000 coding marker in a tile-part header after the first")
                    _segment(tile["header"], m, body, nc)
                elif m in (0xFF58, 0xFF64):  # PLT, COM
                    pass
                else:
                    raise ValueError(f"JPEG 2000 marker {m:04X} in a tile-part header")
                pos += 2 + ln
            end = len(cs) if psot == 0 else start + psot
            if psot == 0 and cs[-2:] == b"\xff\xd9":
                end = len(cs) - 2
            if end > len(cs):
                raise ValueError(f"JPEG 2000 tile-part of tile {isot} is truncated")
            tile["data"].append(cs[pos:end])
            tile["parts"] += 1
            tile_parts.append(isot)
            pos = end
            continue
        if marker == 0xFFD9:  # EOC
            break
        (ln,) = struct.unpack_from(">H", cs, pos + 2)
        body = cs[pos + 4:pos + 2 + ln]
        if marker in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F):
            _segment(main, marker, body, nc)
        elif marker == 0xFF60:  # PPM
            ppm.append((body[0], body[1:]))
        elif marker in (0xFF55, 0xFF57, 0xFF63, 0xFF64, 0xFF78):  # TLM, PLM, CRG, COM, CBD
            pass
        else:
            raise ValueError(f"JPEG 2000 marker {marker:04X} in the main header is not read")
        pos += 2 + ln
    if main.cod is None or main.qcd is None:
        raise ValueError("JPEG 2000 main header without COD or QCD")
    for t in tiles.values():
        t["data"] = b"".join(t["data"])
        t["ppt"] = b"".join(v for _, v in sorted(t["ppt"].items()))
        t["ppm"] = None
    if ppm:
        stream = b"".join(v for _, v in sorted(ppm, key=lambda x: x[0]))
        p = 0
        for isot in tile_parts:
            (n,) = struct.unpack_from(">I", stream, p)
            t = tiles[isot]
            t["ppm"] = (t["ppm"] or b"") + stream[p + 4:p + 4 + n]
            p += 4 + n
    return Codestream(xs, ys, xo, yo, xt, yt, xto, yto, prec, signed, dx, dy, main, tiles)


# ---------------------------------------------------------------- geometry


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class Block:
    """One code-block: its place in its band and in the tile-component's
    buffer (``bx``, ``by``: OpenJPEG's layout), its tier-2 state and what
    tier-1 needs."""

    x0: int
    y0: int
    x1: int
    y1: int
    bx: int = 0
    by: int = 0
    included: bool = False
    numbps: int = 0
    lblock: int = 3
    segments: List[list] = field(default_factory=list)  # [[bytes, passes, maxpasses], ...]


@dataclass
class Band:
    orient: int  # 0 LL, 1 HL, 2 LH, 3 HH
    index: int  # into QCD's step list
    x0: int
    y0: int
    x1: int
    y1: int
    mb: int
    step: float  # 9/7 step size (float32), 1.0 for 5/3
    precincts: List[dict] = field(default_factory=list)  # {"blocks": [...], "cw", "ch", "incl", "zbp"}


@dataclass
class Resolution:
    x0: int
    y0: int
    x1: int
    y1: int
    ppx: int
    ppy: int
    pw: int
    ph: int
    bands: List[Band]


@dataclass
class TileComp:
    comp: int
    x0: int
    y0: int
    x1: int
    y1: int
    coding: Coding
    roishift: int
    resolutions: List[Resolution]
    offset: int = 0  # of this tile-component in the flat coefficient buffer

    @property
    def w(self) -> int:
        return self.x1 - self.x0

    @property
    def h(self) -> int:
        return self.y1 - self.y0


@dataclass
class Tile:
    index: int
    x0: int
    y0: int
    x1: int
    y1: int
    mct: int
    layers: int
    prog: int
    sop: bool
    eph: bool
    poc: list
    comps: List[TileComp]


def _pick(t: Header, m: Header, c: int):
    if c in t.coc:
        coding = t.coc[c]
    elif t.cod is not None:
        coding = t.cod["coding"]
    elif c in m.coc:
        coding = m.coc[c]
    else:
        coding = m.cod["coding"]
    quant = t.qcc.get(c) or t.qcd or m.qcc.get(c) or m.qcd
    roi = t.rgn.get(c, m.rgn.get(c, 0))
    return coding, quant, roi


def tile_geometry(cs: Codestream, index: int) -> Tile:
    """Tile ``index``'s tile-components, resolutions, bands, precincts and
    code-blocks (B.5-B.7, and OpenJPEG's ``opj_tcd_init_tile``)."""
    p, q = index % cs.ntx, index // cs.ntx
    tx0 = max(cs.tx0 + p * cs.tw, cs.x0)
    ty0 = max(cs.ty0 + q * cs.th, cs.y0)
    tx1 = min(cs.tx0 + (p + 1) * cs.tw, cs.width)
    ty1 = min(cs.ty0 + (q + 1) * cs.th, cs.height)
    th = cs.tiles.get(index, {}).get("header") or Header()
    cod = th.cod or cs.main.cod
    comps = []
    for c in range(len(cs.prec)):
        coding, quant, roi = _pick(th, cs.main, c)
        cx0, cy0 = _cdiv(tx0, cs.dx[c]), _cdiv(ty0, cs.dy[c])
        cx1, cy1 = _cdiv(tx1, cs.dx[c]), _cdiv(ty1, cs.dy[c])
        nl = coding.levels
        res = []
        for r in range(nl + 1):
            s = 1 << (nl - r)
            rx0, ry0, rx1, ry1 = _cdiv(cx0, s), _cdiv(cy0, s), _cdiv(cx1, s), _cdiv(cy1, s)
            ppx, ppy = coding.precincts[r]
            pw = 0 if rx0 == rx1 else _cdiv(rx1, 1 << ppx) - (rx0 >> ppx)
            ph = 0 if ry0 == ry1 else _cdiv(ry1, 1 << ppy) - (ry0 >> ppy)
            bands = []
            for orient in ((0,) if r == 0 else (1, 2, 3)):
                if r == 0:
                    bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
                else:
                    n = nl - r + 1
                    ox, oy = orient & 1, orient >> 1
                    half = 1 << (n - 1)
                    bx0, bx1 = _cdiv(cx0 - half * ox, 1 << n), _cdiv(cx1 - half * ox, 1 << n)
                    by0, by1 = _cdiv(cy0 - half * oy, 1 << n), _cdiv(cy1 - half * oy, 1 << n)
                bi = 0 if r == 0 else 3 * (r - 1) + orient
                expn, mant = quant.step(bi)
                gain = 0 if not coding.reversible else (0, 1, 1, 2)[orient]
                step = 1.0
                if not coding.reversible:
                    step = float(np.float32((1.0 + mant / 2048.0) * 2.0 ** (cs.prec[c] + gain - expn)))
                bands.append(Band(orient, bi, bx0, by0, bx1, by1, expn + quant.guard - 1, step))
            res.append(Resolution(rx0, ry0, rx1, ry1, ppx, ppy, pw, ph, bands))
        tc = TileComp(c, cx0, cy0, cx1, cy1, coding, roi, res)
        _partition(tc)
        comps.append(tc)
    return Tile(index, tx0, ty0, tx1, ty1, cod["mct"], cod["layers"], cod["prog"], cod["sop"], cod["eph"],
                th.poc or cs.main.poc, comps)


def _partition(tc: TileComp) -> None:
    """Precincts and code-blocks of every band, with each block's place in
    the tile-component's buffer."""
    for r, res in enumerate(tc.resolutions):
        prc_x0 = (res.x0 >> res.ppx) << res.ppx
        prc_y0 = (res.y0 >> res.ppy) << res.ppy
        if r == 0:
            gx0, gy0, gw, gh = prc_x0, prc_y0, res.ppx, res.ppy
        else:
            gx0, gy0, gw, gh = _cdiv(prc_x0, 2), _cdiv(prc_y0, 2), res.ppx - 1, res.ppy - 1
        cbw = min(tc.coding.xcb, gw)
        cbh = min(tc.coding.ycb, gh)
        prev = tc.resolutions[r - 1] if r else None
        for band in res.bands:
            offx = prev.x1 - prev.x0 if prev is not None and band.orient & 1 else 0
            offy = prev.y1 - prev.y0 if prev is not None and band.orient & 2 else 0
            for k in range(res.pw * res.ph):
                px0 = gx0 + (k % res.pw << gw)
                py0 = gy0 + (k // res.pw << gh)
                x0, y0 = max(px0, band.x0), max(py0, band.y0)
                x1, y1 = min(px0 + (1 << gw), band.x1), min(py0 + (1 << gh), band.y1)
                if x0 >= x1 or y0 >= y1:
                    band.precincts.append({"blocks": [], "cw": 0, "ch": 0})
                    continue
                bx0, by0 = (x0 >> cbw) << cbw, (y0 >> cbh) << cbh
                cw = (_cdiv(x1, 1 << cbw) * (1 << cbw) - bx0) >> cbw
                ch = (_cdiv(y1, 1 << cbh) * (1 << cbh) - by0) >> cbh
                blocks = []
                for j in range(ch):
                    for i in range(cw):
                        b = Block(max(bx0 + (i << cbw), x0), max(by0 + (j << cbh), y0),
                                  min(bx0 + (i + 1 << cbw), x1), min(by0 + (j + 1 << cbh), y1))
                        b.bx = b.x0 - band.x0 + offx
                        b.by = b.y0 - band.y0 + offy
                        blocks.append(b)
                band.precincts.append({"blocks": blocks, "cw": cw, "ch": ch, "incl": TagTree(cw, ch),
                                       "zbp": TagTree(cw, ch)})


# ------------------------------------------------------------ packet order


def packet_order(cs: Codestream, tile: Tile):
    """(layer, resolution, component, precinct) of each packet of ``tile``
    in codestream order (B.12, with POC; OpenJPEG's ``pi.c``), each at most
    once."""
    nc = len(tile.comps)
    maxres = max(len(tc.resolutions) for tc in tile.comps)
    progs = ([(rs, cs_, min(lye, tile.layers), min(re, maxres), min(ce, nc), pp)
              for rs, cs_, lye, re, ce, pp in tile.poc] if tile.poc
             else [(0, 0, tile.layers, maxres, nc, tile.prog)])
    done = set()
    # the smallest precinct step on the reference grid (pi.c's dx, dy)
    dxm = dym = None
    for tc in tile.comps:
        nl = len(tc.resolutions) - 1
        for r, res in enumerate(tc.resolutions):
            ddx = cs.dx[tc.comp] << (res.ppx + nl - r)
            ddy = cs.dy[tc.comp] << (res.ppy + nl - r)
            dxm = ddx if dxm is None else min(dxm, ddx)
            dym = ddy if dym is None else min(dym, ddy)

    def positions(c, r):
        """(x, y) steps of the reference grid in order and the precinct
        each starts, for the position-driven orders."""
        tc = tile.comps[c]
        res = tc.resolutions[r]
        nl = len(tc.resolutions) - 1
        lev = nl - r
        ddx, ddy = cs.dx[c], cs.dy[c]
        trx0, try0 = _cdiv(tile.x0, ddx << lev), _cdiv(tile.y0, ddy << lev)
        trx1, try1 = _cdiv(tile.x1, ddx << lev), _cdiv(tile.y1, ddy << lev)
        return tc, res, lev, trx0, try0, trx1, try1

    def precinct_at(c, r, x, y):
        if r >= len(tile.comps[c].resolutions):
            return None
        tc, res, lev, trx0, try0, trx1, try1 = positions(c, r)
        rpx, rpy = res.ppx + lev, res.ppy + lev
        ddx, ddy = cs.dx[c], cs.dy[c]
        if not (y % (ddy << rpy) == 0 or (y == tile.y0 and (try0 << lev) % (1 << rpy))):
            return None
        if not (x % (ddx << rpx) == 0 or (x == tile.x0 and (trx0 << lev) % (1 << rpx))):
            return None
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        pi = (_cdiv(x, ddx << lev) >> res.ppx) - (trx0 >> res.ppx)
        pj = (_cdiv(y, ddy << lev) >> res.ppy) - (try0 >> res.ppy)
        return pi + pj * res.pw

    def steps(lo, hi, d):
        v = lo
        while v < hi:
            yield v
            v += d - v % d

    for rs, cs0, le, re, ce, pp in progs:
        order = PROGRESSIONS[pp]
        seq = []
        if order in ("LRCP", "RLCP"):
            outer = ((l, r) for l in range(le) for r in range(rs, re)) if order == "LRCP" else \
                ((l, r) for r in range(rs, re) for l in range(le))
            for l, r in outer:
                for c in range(cs0, ce):
                    tc = tile.comps[c]
                    if r >= len(tc.resolutions):
                        continue
                    res = tc.resolutions[r]
                    for p in range(res.pw * res.ph):
                        seq.append((l, r, c, p))
        elif order == "RPCL":
            for r in range(rs, re):
                for y in steps(tile.y0, tile.y1, dym):
                    for x in steps(tile.x0, tile.x1, dxm):
                        for c in range(cs0, ce):
                            p = precinct_at(c, r, x, y)
                            if p is not None:
                                seq.extend((l, r, c, p) for l in range(le))
        elif order == "PCRL":
            for y in steps(tile.y0, tile.y1, dym):
                for x in steps(tile.x0, tile.x1, dxm):
                    for c in range(cs0, ce):
                        for r in range(rs, re):
                            p = precinct_at(c, r, x, y)
                            if p is not None:
                                seq.extend((l, r, c, p) for l in range(le))
        else:  # CPRL
            for c in range(cs0, ce):
                for y in steps(tile.y0, tile.y1, dym):
                    for x in steps(tile.x0, tile.x1, dxm):
                        for r in range(rs, re):
                            p = precinct_at(c, r, x, y)
                            if p is not None:
                                seq.extend((l, r, c, p) for l in range(le))
        for key in seq:
            if key not in done:
                done.add(key)
                yield key


# ------------------------------------------------------------------ tier-2


class TagTree:
    """A tag tree (B.10.2) over a (w, h) grid of leaves."""

    def __init__(self, w: int, h: int):
        self.levels = []
        while True:
            self.levels.append((w, h))
            if w * h <= 1:
                break
            w, h = _cdiv(w, 2), _cdiv(h, 2)
        n = sum(a * b for a, b in self.levels)
        self.value = [1 << 30] * n
        self.low = [0] * n
        self.known = [False] * n
        self.base = []
        b = 0
        for a, c in self.levels:
            self.base.append(b)
            b += a * c

    def path(self, leaf: int) -> List[int]:
        w = self.levels[0][0]
        x, y = leaf % max(w, 1), leaf // max(w, 1)
        out = []
        for k, (lw, _) in enumerate(self.levels):
            out.append(self.base[k] + y * lw + x)
            x, y = x >> 1, y >> 1
        return out[::-1]

    def decode(self, bits, leaf: int, threshold: int) -> bool:
        low = 0
        node = None
        for node in self.path(leaf):
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bits.read(1):
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
        return self.value[node] < threshold

    # encoder side
    def set_values(self, leaves: List[int]) -> None:
        for i, v in enumerate(leaves):
            self.value[i] = v
        for k in range(1, len(self.levels)):
            lw, lh = self.levels[k]
            pw, ph = self.levels[k - 1]
            for y in range(lh):
                for x in range(lw):
                    kids = [self.value[self.base[k - 1] + yy * pw + xx]
                            for yy in (2 * y, 2 * y + 1) for xx in (2 * x, 2 * x + 1) if yy < ph and xx < pw]
                    self.value[self.base[k] + y * lw + x] = min(kids)

    def encode(self, bits, leaf: int, threshold: int) -> None:
        low = 0
        for node in self.path(leaf):
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bits.write(1)
                        self.known[node] = True
                    break
                bits.write(0)
                low += 1
            self.low[node] = low


class BitReader:
    """Packet-header bits (B.10.1): after an 0xFF byte the next byte holds 7."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos, self.buf, self.ct = data, pos, 0, 0

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            if self.ct == 0:
                self.buf = (self.buf << 8) & 0xFFFF
                self.ct = 7 if self.buf == 0xFF00 else 8
                self.buf |= self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
            self.ct -= 1
            v = (v << 1) | ((self.buf >> self.ct) & 1)
        return v

    def align(self) -> int:
        if (self.buf & 0xFF) == 0xFF:
            self.buf = 0
            self.pos += 1
        self.ct = 0
        return self.pos


def _max_passes(style: int, first: bool, prev: int) -> int:
    if style & TERMALL:
        return 1
    if style & BYPASS:
        return 10 if first else (2 if prev in (1, 10) else 1)
    return 109


def read_packets(cs: Codestream, tile: Tile) -> None:
    """Tier-2 of one tile: walk its packets in order, decode each header
    and hand each code-block its bytes."""
    info = cs.tiles.get(tile.index)
    if info is None:
        return
    body = info["data"]
    headers = info["ppm"] if info["ppm"] is not None else (info["ppt"] or None)
    hpos = pos = 0
    for l, r, c, p in packet_order(cs, tile):
        if pos >= len(body) and headers is None:
            break
        tc = tile.comps[c]
        res = tc.resolutions[r]
        if tile.sop and body[pos:pos + 2] == b"\xff\x91":
            pos += 6
        src, start = (headers, hpos) if headers is not None else (body, pos)
        if start >= len(src):
            break
        bits = BitReader(src, start)
        contribs = []
        if bits.read(1):
            for band in res.bands:
                prc = band.precincts[p]
                for k, blk in enumerate(prc["blocks"]):
                    if not blk.included:
                        inc = prc["incl"].decode(bits, k, l + 1)
                    else:
                        inc = bool(bits.read(1))
                    if not inc:
                        continue
                    if not blk.included:
                        i = 0
                        while not prc["zbp"].decode(bits, k, i):
                            i += 1
                        blk.numbps = band.mb + 1 - i
                        blk.included = True
                    npasses = _read_passes(bits)
                    while bits.read(1):
                        blk.lblock += 1
                    segs = blk.segments
                    if not segs or segs[-1][1] == segs[-1][2]:
                        segs.append([b"", 0, _max_passes(tc.coding.style, not segs, segs[-1][2] if segs else 0)])
                    left = npasses
                    while left > 0:
                        seg = segs[-1]
                        take = min(seg[2] - seg[1], left)
                        length = bits.read(blk.lblock + take.bit_length() - 1)
                        contribs.append((seg, take, length))
                        left -= take
                        if left > 0:
                            segs.append([b"", 0, _max_passes(tc.coding.style, False, seg[2])])
        end = bits.align()
        if headers is not None:
            hpos = end
            if tile.eph and headers[hpos:hpos + 2] == b"\xff\x92":
                hpos += 2
        else:
            pos = end
            if tile.eph and body[pos:pos + 2] == b"\xff\x92":
                pos += 2
        for seg, take, length in contribs:
            if pos + length > len(body):
                raise ValueError(f"JPEG 2000 tile {tile.index}: a code-block's bytes run past the tile")
            seg[0] += body[pos:pos + length]
            seg[1] += take
            pos += length


def _read_passes(bits: BitReader) -> int:
    if not bits.read(1):
        return 1
    if not bits.read(1):
        return 2
    v = bits.read(2)
    if v != 3:
        return 3 + v
    v = bits.read(5)
    if v != 31:
        return 6 + v
    return 37 + bits.read(7)


# -------------------------------------------------------------------- plan


@dataclass
class Plan:
    """Everything before tier-1: the image, its tiles and components, and
    every code-block's segments (what the card's decoder packs)."""

    cs: Codestream
    boxes: Boxes
    tiles: List[Tile]
    size: int  # int32 words of the flat coefficient buffer
    blocks: List[Tuple[TileComp, Band, Block]]


def prepare(data: bytes) -> Plan:
    """Boxes, markers and tier-2 of a JPEG 2000 file."""
    boxes = read_boxes(bytes(data))
    cs = parse_codestream(boxes.codestream)
    tiles, blocks, off = [], [], 0
    for t in range(cs.ntx * cs.nty):
        tile = tile_geometry(cs, t)
        for tc in tile.comps:
            tc.offset = off
            off += tc.w * tc.h
        read_packets(cs, tile)
        for tc in tile.comps:
            for res in tc.resolutions:
                for band in res.bands:
                    for prc in band.precincts:
                        for blk in prc["blocks"]:
                            if blk.segments and any(s[1] for s in blk.segments):
                                blocks.append((tc, band, blk))
        tiles.append(tile)
    return Plan(cs, boxes, tiles, off, blocks)


# ------------------------------------------------------------------ tier-1

#: the MQ coder's states: (Qe, next on MPS, next on LPS, switch)
MQ_TABLE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0),
    (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0), (0x3801, 10, 14, 0),
    (0x3001, 11, 17, 0), (0x2401, 12, 18, 0), (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0), (0x1C01, 25, 22, 0),
    (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0),
    (0x02A1, 36, 33, 0), (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))
QE = [s[0] for s in MQ_TABLE]
NMPS = [s[1] for s in MQ_TABLE]
NLPS = [s[2] for s in MQ_TABLE]
SWITCH = [s[3] for s in MQ_TABLE]

#: contexts: 0-8 significance, 9-13 sign, 14-16 refinement, 17 run length, 18 uniform
CTX_RL, CTX_UNI = 17, 18

# neighbour bits of a coefficient's flag word: significance of N, S, W, E,
# NW, NE, SW, SE, then the sign (negative) of N, S, W, E
F_N, F_S, F_W, F_E, F_NW, F_NE, F_SW, F_SE = 1, 2, 4, 8, 16, 32, 64, 128
G_N, G_S, G_W, G_E = 256, 512, 1024, 2048
#: what VSC hides from the last row of a stripe: the stripe below
VSC_MASK = ~(F_S | F_SW | F_SE | G_S) & 0xFFF


def _zc(orient: int, nb: int) -> int:
    h = ((nb & F_W) > 0) + ((nb & F_E) > 0)
    v = ((nb & F_N) > 0) + ((nb & F_S) > 0)
    d = ((nb & F_NW) > 0) + ((nb & F_NE) > 0) + ((nb & F_SW) > 0) + ((nb & F_SE) > 0)
    if orient == 1:  # HL: horizontal and vertical swap roles
        h, v = v, h
    if orient == 3:
        hv = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if hv >= 1 else 6
        if d == 1:
            return 5 if hv >= 2 else (4 if hv == 1 else 3)
        return 2 if hv >= 2 else hv
    if h == 2:
        return 8
    if h == 1:
        return 7 if v >= 1 else (6 if d >= 1 else 5)
    if v == 2:
        return 4
    if v == 1:
        return 3
    return 2 if d >= 2 else d


def _sc(nb: int) -> Tuple[int, int]:
    def contrib(sig, neg):
        return 0 if not nb & sig else (-1 if nb & neg else 1)

    h = max(-1, min(1, contrib(F_W, G_W) + contrib(F_E, G_E)))
    v = max(-1, min(1, contrib(F_N, G_N) + contrib(F_S, G_S)))
    if h < 0:
        h, v, xor = -h, -v, 1
    else:
        xor = 0
    if h == 0 and v < 0:
        v, xor = -v, 1
    ctx = {(1, 1): 13, (1, 0): 12, (1, -1): 11, (0, 1): 10, (0, 0): 9}[(h, v)]
    return ctx, xor


#: ZC context by band orientation and the 8 significance bits
ZC_LUT = [[_zc(o, nb) for nb in range(256)] for o in range(4)]
#: (context, xor bit) by the N, S, W, E significance and sign bits:
#: index (nb & 15) | (nb >> 8 & 15) << 4
SC_LUT = [_sc((i & 15) | ((i >> 4) << 8)) for i in range(256)]


def t1_decode_block(segments, w: int, h: int, orient: int, numbps: int, style: int, roishift: int) -> np.ndarray:
    """One code-block's coding passes -> (h, w) int32, each value twice the
    coefficient plus half a step as OpenJPEG keeps it, ROI maxshift undone.
    ``segments`` is a list of (bytes, passes); ``numbps`` the coded
    bit-planes (Mb less the zero bit-planes)."""
    W = w + 2
    n = W * (h + 2)
    data = [0] * n
    nb = [0] * n  # neighbour flags
    st = [0] * n  # 1 significant, 2 visited in this bit-plane, 4 refined
    zc = ZC_LUT[orient]
    vsc = style & VSC
    # scan order: stripes of 4 rows, column by column
    cols = []
    for k in range(0, h, 4):
        rows = min(4, h - k)
        for x in range(w):
            idx = [(k + j + 1) * W + x + 1 for j in range(rows)]
            mk = [VSC_MASK if vsc and j == 3 else 0xFFF for j in range(rows)]
            cols.append((idx, mk, rows == 4))
    # MQ state
    I = [0] * 19
    M = [0] * 19

    def reset():
        for i in range(19):
            I[i] = 0
            M[i] = 0
        I[CTX_UNI] = 46
        I[CTX_RL] = 3
        I[0] = 4

    reset()
    buf = b""
    bp = 0
    A = C = CT = 0
    raw_c = raw_ct = 0

    def byte(i):
        return buf[i] if i < len(buf) else 0xFF

    def bytein():
        nonlocal bp, C, CT
        if byte(bp) == 0xFF:
            if byte(bp + 1) > 0x8F:
                C += 0xFF00
                CT = 8
            else:
                bp += 1
                C += byte(bp) << 9
                CT = 7
        else:
            bp += 1
            C += byte(bp) << 8
            CT = 8

    def mq_init(seg):
        nonlocal buf, bp, A, C, CT
        buf, bp = seg, 0
        C = byte(0) << 16
        bytein()
        C = (C << 7) & 0xFFFFFFFF
        CT -= 7
        A = 0x8000

    def decode(cx):
        nonlocal A, C, CT
        i = I[cx]
        qe = QE[i]
        A -= qe
        if (C >> 16) < qe:  # LPS exchange
            if A < qe:
                A = qe
                d = M[cx]
                I[cx] = NMPS[i]
            else:
                A = qe
                d = 1 - M[cx]
                if SWITCH[i]:
                    M[cx] = 1 - M[cx]
                I[cx] = NLPS[i]
        else:
            C -= qe << 16
            if A & 0x8000:
                return M[cx]
            if A < qe:  # MPS exchange
                d = 1 - M[cx]
                if SWITCH[i]:
                    M[cx] = 1 - M[cx]
                I[cx] = NLPS[i]
            else:
                d = M[cx]
                I[cx] = NMPS[i]
        while True:  # renormalise
            if CT == 0:
                bytein()
            A <<= 1
            C = (C << 1) & 0xFFFFFFFF
            CT -= 1
            if A & 0x8000:
                break
        return d

    def raw_init(seg):
        nonlocal buf, bp, raw_c, raw_ct
        buf, bp, raw_c, raw_ct = seg, 0, 0, 0

    def raw():
        nonlocal bp, raw_c, raw_ct
        if raw_ct == 0:
            if raw_c == 0xFF:
                if byte(bp) > 0x8F:
                    raw_c, raw_ct = 0xFF, 8
                else:
                    raw_c, raw_ct = byte(bp), 7
                    bp += 1
            else:
                raw_c, raw_ct = byte(bp), 8
                bp += 1
        raw_ct -= 1
        return (raw_c >> raw_ct) & 1

    def significant(i, neg):
        st[i] |= 1
        g = 1 if neg else 0
        nb[i - W] |= F_S | (G_S if g else 0)
        nb[i + W] |= F_N | (G_N if g else 0)
        nb[i - 1] |= F_E | (G_E if g else 0)
        nb[i + 1] |= F_W | (G_W if g else 0)
        nb[i - W - 1] |= F_SE
        nb[i - W + 1] |= F_SW
        nb[i + W - 1] |= F_NE
        nb[i + W + 1] |= F_NW

    def sign(i, m):
        f = nb[i] & m
        ctx, xor = SC_LUT[(f & 15) | ((f >> 4) & 0xF0)]
        return decode(ctx) ^ xor

    def sig_pass(bpp1, is_raw):
        oph = (1 << bpp1) | (1 << (bpp1 - 1))
        for idx, mk, _ in cols:
            for i, m in zip(idx, mk):
                if st[i] & 1:
                    continue
                f = nb[i] & m & 0xFF
                if not f:
                    continue
                if is_raw:
                    if raw():
                        neg = raw()
                        data[i] = -oph if neg else oph
                        significant(i, neg)
                elif decode(zc[f]):
                    neg = sign(i, m)
                    data[i] = -oph if neg else oph
                    significant(i, neg)
                st[i] |= 2

    def ref_pass(bpp1, is_raw):
        half = 1 << (bpp1 - 1)
        for idx, mk, _ in cols:
            for i, m in zip(idx, mk):
                s = st[i]
                if s & 3 != 1:
                    continue
                if is_raw:
                    v = raw()
                else:
                    v = decode(16 if s & 4 else (15 if nb[i] & m & 0xFF else 14))
                d = data[i]
                data[i] = d + (half if v ^ (d < 0) else -half)
                st[i] = s | 4

    def clean_pass(bpp1):
        oph = (1 << bpp1) | (1 << (bpp1 - 1))
        for idx, mk, full in cols:
            start = 0
            if full and not (st[idx[0]] | st[idx[1]] | st[idx[2]] | st[idx[3]]) \
                    and not ((nb[idx[0]] & mk[0]) | (nb[idx[1]] & mk[1]) | (nb[idx[2]] & mk[2])
                             | (nb[idx[3]] & mk[3])) & 0xFF:
                if not decode(CTX_RL):
                    continue
                start = decode(CTX_UNI) << 1
                start |= decode(CTX_UNI)
                i = idx[start]
                neg = sign(i, mk[start])
                data[i] = -oph if neg else oph
                significant(i, neg)
                start += 1
            for j in range(start, len(idx)):
                i = idx[j]
                if st[i] & 3:
                    continue
                if decode(zc[nb[i] & mk[j] & 0xFF]):
                    neg = sign(i, mk[j])
                    data[i] = -oph if neg else oph
                    significant(i, neg)
        for idx, _, _ in cols:
            for i in idx:
                st[i] &= ~2
        if style & SEGSYM:
            for _ in range(4):
                decode(CTX_UNI)

    bpp1 = roishift + numbps
    if bpp1 >= 31:
        raise ValueError(f"JPEG 2000 code-block with {bpp1} bit-planes (OpenJPEG stops at 30)")
    passtype = 2
    for seg, npass in segments:
        is_raw = bool(style & BYPASS) and passtype < 2 and bpp1 <= numbps - 4
        if is_raw:
            raw_init(seg)
        else:
            mq_init(seg)
        for _ in range(npass):
            if bpp1 < 1:
                break
            if passtype == 0:
                sig_pass(bpp1, is_raw)
            elif passtype == 1:
                ref_pass(bpp1, is_raw)
            else:
                clean_pass(bpp1)
            if style & RESET and not is_raw:
                reset()
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpp1 -= 1
    out = np.array(data, np.int64).reshape(h + 2, W)[1:-1, 1:-1]
    if roishift:
        mag = np.abs(out)
        out = np.where(mag >= 1 << roishift, np.sign(out) * (mag >> roishift), out)
    return out.astype(np.int32)


def block_args(tc: TileComp, band: Band, blk: Block):
    """tier-1's arguments of one planned code-block."""
    return ([(bytes(s[0]), s[1]) for s in blk.segments if s[1]], blk.x1 - blk.x0, blk.y1 - blk.y0, band.orient,
            blk.numbps, tc.coding.style, tc.roishift)


def _t1_decode_star(args):
    return t1_decode_block(*args)


def tier1(plan: Plan, map=map) -> np.ndarray:
    """Every code-block of the plan -> the flat int32 buffer of all
    tile-components' subbands (zeros where no block has bytes). ``map``
    may be a process pool's, to decode the blocks in parallel."""
    out = np.zeros(plan.size, np.int32)
    decoded = map(_t1_decode_star, [block_args(*b) for b in plan.blocks])
    for (tc, band, blk), vals in zip(plan.blocks, decoded):
        plane = out[tc.offset:tc.offset + tc.w * tc.h].reshape(tc.h, tc.w)
        plane[blk.by:blk.by + vals.shape[0], blk.bx:blk.bx + vals.shape[1]] = vals
    return out


# -------------------------------------------------------------- wavelet


def _idwt53_lines(x: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """Inverse 5/3 along the last axis of (lines, n) int64: lows [:sn],
    highs [sn:] in, interleaved samples out."""
    n = x.shape[1]
    if n == 1:  # OpenJPEG: a lone even sample stays, a lone odd one is halved
        return x if cas == 0 else _cdiv_trunc(x)
    lo, hi = x[:, :sn].copy(), x[:, sn:].copy()
    dn = n - sn
    if cas == 0:
        left = hi[:, np.maximum(np.arange(sn) - 1, 0)]
        right = hi[:, np.minimum(np.arange(sn), dn - 1)]
        lo -= (left + right + 2) >> 2
        nxt = lo[:, np.minimum(np.arange(dn) + 1, sn - 1)]
        hi += (lo[:, :dn] + nxt) >> 1
        out = np.empty_like(x)
        out[:, 0::2], out[:, 1::2] = lo, hi
    else:
        right = hi[:, np.minimum(np.arange(sn) + 1, dn - 1)]
        lo -= (hi[:, :sn] + right + 2) >> 2
        left = lo[:, np.maximum(np.arange(dn) - 1, 0)]
        cur = lo[:, np.minimum(np.arange(dn), sn - 1)]
        hi += (left + cur) >> 1
        out = np.empty_like(x)
        out[:, 1::2], out[:, 0::2] = lo, hi
    return out


def _cdiv_trunc(x: np.ndarray) -> np.ndarray:
    """x / 2 as C divides ints (towards zero)."""
    return np.where(x < 0, -((-x) >> 1), x >> 1)


def _step2(X: np.ndarray, l_off: int, w_off: int, end: int, m: int, c: np.float32) -> None:
    """OpenJPEG's ``opj_v8dwt_decode_step2`` on (lines, n) float32 in place."""
    imax = min(end, m)
    if imax > 0:
        i = np.arange(imax)
        left_pos = w_off - 2 + 2 * i
        if left_pos[0] < 0:
            left_pos[0] = l_off
        X[:, w_off - 1 + 2 * i] = X[:, w_off - 1 + 2 * i] + (X[:, left_pos] + X[:, w_off + 2 * i]) * c
    if m < end:
        fl = l_off if m == 0 else w_off + 2 * (m - 1)
        t = w_off - 1 + 2 * m
        X[:, t] = X[:, t] + X[:, fl] * (c + c)


def _idwt97_lines(x: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """Inverse 9/7 along the last axis of (lines, n) float32, OpenJPEG's
    ``opj_v8dwt_decode`` step for step."""
    n = x.shape[1]
    dn = n - sn
    X = np.empty_like(x)
    if cas == 0:
        X[:, 0::2], X[:, 1::2] = x[:, :sn], x[:, sn:]
        if not (dn > 0 or sn > 1):
            return X
        a, b = 0, 1
    else:
        X[:, 1::2], X[:, 0::2] = x[:, :sn], x[:, sn:]
        if not (sn > 0 or dn > 1):
            return X
        a, b = 1, 0
    X[:, a:a + 2 * sn:2] *= K
    X[:, b:b + 2 * dn:2] *= TWO_INV_K
    _step2(X, b, a + 1, sn, min(sn, dn - a), DELTA)
    _step2(X, a, b + 1, dn, min(dn, sn - b), GAMMA)
    _step2(X, b, a + 1, sn, min(sn, dn - a), BETA)
    _step2(X, a, b + 1, dn, min(dn, sn - b), ALPHA)
    return X


def dequantize(plan: Plan, coef: np.ndarray) -> np.ndarray:
    """Raw tier-1 values -> coefficients, OpenJPEG's rule: 5/3 halves as C
    divides an int (int32 out), 9/7 multiplies by half the step in float32
    (float32 bits in the int32 buffer)."""
    out = coef.copy()
    for tile in plan.tiles:
        for tc in tile.comps:
            plane = coef[tc.offset:tc.offset + tc.w * tc.h].reshape(tc.h, tc.w)
            dst = out[tc.offset:tc.offset + tc.w * tc.h].reshape(tc.h, tc.w)
            if tc.coding.reversible:
                dst[:] = _cdiv_trunc(plane.astype(np.int64)).astype(np.int32)
                continue
            fdst = dst.view(np.float32)
            for r, res in enumerate(tc.resolutions):
                prev = tc.resolutions[r - 1] if r else None
                for band in res.bands:
                    ox = prev.x1 - prev.x0 if prev is not None and band.orient & 1 else 0
                    oy = prev.y1 - prev.y0 if prev is not None and band.orient & 2 else 0
                    sl = (slice(oy, oy + band.y1 - band.y0), slice(ox, ox + band.x1 - band.x0))
                    fdst[sl] = plane[sl].astype(np.float32) * (np.float32(0.5) * np.float32(band.step))
    return out


def idwt_tilecomp(tc: TileComp, plane: np.ndarray) -> np.ndarray:
    """One tile-component's dequantised (h, w) coefficients -> samples,
    each resolution rows then columns. int32 for 5/3, float32 for 9/7."""
    rev = tc.coding.reversible
    a = plane.astype(np.int64) if rev else plane.astype(np.float32).copy()
    lines = _idwt53_lines if rev else _idwt97_lines
    for r in range(1, len(tc.resolutions)):
        res, prev = tc.resolutions[r], tc.resolutions[r - 1]
        rw, rh = res.x1 - res.x0, res.y1 - res.y0
        if rw == 0 or rh == 0:
            continue
        a[:rh, :rw] = lines(a[:rh, :rw], prev.x1 - prev.x0, res.x0 % 2)
        a[:rh, :rw] = lines(a[:rh, :rw].T, prev.y1 - prev.y0, res.y0 % 2).T
    return a.astype(np.int32) if rev else a


def inverse_dwt(plan: Plan, coef: np.ndarray) -> np.ndarray:
    """The flat tier-1 buffer -> the flat buffer of samples (int32 for 5/3
    tile-components, float32 bits for 9/7): :func:`dequantize`, then each
    tile-component's inverse wavelet."""
    deq = dequantize(plan, coef)
    out = deq.copy()
    for tile in plan.tiles:
        for tc in tile.comps:
            if tc.w == 0 or tc.h == 0:
                continue
            sl = slice(tc.offset, tc.offset + tc.w * tc.h)
            plane = deq[sl].reshape(tc.h, tc.w)
            if not tc.coding.reversible:
                plane = plane.view(np.float32)
            got = idwt_tilecomp(tc, plane)
            out[sl] = got.reshape(-1).view(np.int32) if got.dtype == np.float32 else got.reshape(-1)
    return out


# ------------------------------------------------------------ components


def tile_samples(plan: Plan, samples: np.ndarray, tile: Tile) -> List[np.ndarray]:
    """One tile's components after the inverse MCT, the DC level shift,
    rounding and clipping: a list of (h, w) int64."""
    cs = plan.cs
    comps = []
    for tc in tile.comps:
        plane = samples[tc.offset:tc.offset + tc.w * tc.h].reshape(tc.h, tc.w)
        comps.append(plane if tc.coding.reversible else plane.view(np.float32))
    if tile.mct and len(comps) >= 3:
        if tile.mct != 1:
            raise ValueError(f"JPEG 2000 multiple component transform {tile.mct} (Part 2) is not read")
        if not all(comps[i].shape == comps[0].shape for i in (1, 2)):
            raise ValueError("JPEG 2000 MCT over components of different sizes")
        if tile.comps[0].coding.reversible:
            y, u, v = (comps[i].astype(np.int64) for i in range(3))
            g = y - ((u + v) >> 2)
            comps[:3] = [v + g, g, u + g]
        else:
            y, u, v = (comps[i].astype(np.float32) for i in range(3))
            comps[:3] = [y + v * ICT_RV, (y - u * ICT_GU) - v * ICT_GV, y + u * ICT_BU]
    out = []
    for tc, plane in zip(tile.comps, comps):
        prec, sgnd = cs.prec[tc.comp], cs.signed[tc.comp]
        lo, hi = (-(1 << prec - 1), (1 << prec - 1) - 1) if sgnd else (0, (1 << prec) - 1)
        shift = 0 if sgnd else 1 << (prec - 1)
        if plane.dtype == np.float32:
            v = np.rint(plane).astype(np.int64)
        else:
            v = plane.astype(np.int64)
        out.append(np.clip(v + shift, lo, hi))
    return out


def components(plan: Plan, samples: np.ndarray) -> List[np.ndarray]:
    """The image's components (each (H_c, W_c) int64) from the flat sample
    buffer, tiles put in place."""
    cs = plan.cs
    planes = [np.zeros((_cdiv(cs.height, cs.dy[c]) - _cdiv(cs.y0, cs.dy[c]),
                        _cdiv(cs.width, cs.dx[c]) - _cdiv(cs.x0, cs.dx[c])), np.int64) for c in range(len(cs.prec))]
    for tile in plan.tiles:
        for tc, v in zip(tile.comps, tile_samples(plan, samples, tile)):
            ox, oy = _cdiv(cs.x0, cs.dx[tc.comp]), _cdiv(cs.y0, cs.dy[tc.comp])
            planes[tc.comp][tc.y0 - oy:tc.y1 - oy, tc.x0 - ox:tc.x1 - ox] = v
    return planes


@dataclass
class Image:
    """What OpenJPEG hands cv2: components after ``pclr`` / ``cdef``, and
    the codestream's own components (``header_*``), which cv2 sizes its
    output by before the palette is applied."""

    header_prec: List[int]
    header_signed: List[bool]
    order: List[Optional[int]]  # the codestream component of each plane, None from a palette
    planes: List[np.ndarray]
    dx: List[int]
    dy: List[int]
    x0: int
    y0: int
    colour: Optional[int]


def jp2_components(plan: Plan, planes: List[np.ndarray]) -> Image:
    """Apply ``pclr`` / ``cmap`` and ``cdef`` as OpenJPEG's ``opj_jp2_decode``
    does."""
    cs, bx = plan.cs, plan.boxes
    dx, dy = list(cs.dx), list(cs.dy)
    order = list(range(len(planes)))
    if bx.pclr is not None:
        entries = bx.pclr
        if bx.cmap is None:
            raise ValueError("JPEG 2000 pclr without cmap")
        new, ndx, ndy, norder = [], [], [], []
        for cmp, mtyp, pcol in bx.cmap:
            if cmp >= len(planes):
                raise ValueError("JPEG 2000 cmap names a missing component")
            norder.append(cmp if mtyp == 0 else None)
            if mtyp == 0:
                new.append(planes[cmp])
            else:
                new.append(entries[np.clip(planes[cmp], 0, len(entries) - 1), pcol])
            ndx.append(dx[cmp])
            ndy.append(dy[cmp])
        planes, dx, dy, order = new, ndx, ndy, norder
    if bx.cdef is not None:
        info = [list(e) for e in bx.cdef]
        for i, (cn, typ, asoc) in enumerate(info):
            if cn >= len(planes):
                continue
            if asoc in (0, 65535):
                continue
            acn = asoc - 1
            if acn >= len(planes):
                continue
            if cn != acn and typ == 0:
                for lst in (planes, dx, dy, order):
                    lst[cn], lst[acn] = lst[acn], lst[cn]
                for j in range(i + 1, len(info)):
                    if info[j][0] == cn:
                        info[j][0] = acn
                    elif info[j][0] == acn:
                        info[j][0] = cn
    return Image(list(cs.prec), list(cs.signed), order, planes, dx, dy, cs.x0, cs.y0, bx.colour)


# ------------------------------------------------------------ cv2's rule


@dataclass
class Rule:
    """cv2's output of an image under one flag: the components it takes in
    order, whether it converts them to gray (cvtColor's 15-bit rule of the
    first three, taken as R, G, B), the right shift and the dtype."""

    channels: List[int]
    to_gray: bool
    shift: int
    dtype: type
    #: the three channels are Y, Cb, Cr, taken to BGR by cvtColor's
    #: ``COLOR_YUV2BGR`` (:func:`cvt_color.yuv_to_bgr`)
    yuv: bool = False


def output_rule(img: Image, flags: int) -> Rule:
    """Raises where cv2 returns None, naming the form. The output's
    channels (under ``IMREAD_UNCHANGED``), dtype and shift follow the
    codestream's components; the conversion, the components after a
    palette (a palette's values are cast to the output type as C casts)."""
    hc = len(img.header_prec)
    nc = len(img.planes)
    if not 1 <= hc <= 4:
        raise ValueError(f"JPEG 2000 with {hc} components (cv2 reads 1 to 4)")
    if any(img.header_signed):
        raise ValueError("JPEG 2000 with a signed component (cv2 returns None)")
    maxp = max(img.header_prec)
    if maxp < 8:
        raise ValueError(f"JPEG 2000 at precision {maxp} (cv2 reads 8 bits and more)")
    if maxp > 16:
        raise ValueError(f"JPEG 2000 at precision {maxp} (cv2 returns float; the port reads up to 16 bits)")
    if any(d != 1 for d in img.dx + img.dy):
        raise ValueError("JPEG 2000 with a subsampled component (cv2 returns None)")
    if img.x0 or img.y0:
        raise ValueError("JPEG 2000 with an image offset (cv2 returns None)")
    if flags == IMREAD_UNCHANGED:
        out_ch, dtype = hc, (np.uint8 if maxp == 8 else np.uint16)
        if out_ch == 2:
            raise ValueError("JPEG 2000 of two components under IMREAD_UNCHANGED (cv2 returns None)")
    else:
        out_ch, dtype = (3 if flags == IMREAD_COLOR else 1), np.uint8
    shift = max(0, maxp - 8 * np.dtype(dtype).itemsize)
    space = img.colour
    if space is not None and space not in (SRGB, GRAY, SYCC):
        raise ValueError(f"JPEG 2000 colour space {space} (cv2 returns None)")
    if space in (None, SRGB):  # a raw codestream: cv2 takes it for sRGB
        if out_ch == 1:
            return Rule([0, 1, 2], True, shift, dtype) if nc >= 3 else Rule([0], False, shift, dtype)
        if nc < 3 or out_ch > nc:
            raise ValueError(f"JPEG 2000 sRGB of {nc} component(s) as colour (cv2 returns None)")
        return Rule([2, 1, 0] + ([3] if out_ch == 4 else []), False, shift, dtype)
    if space == GRAY:
        if out_ch not in (1, 3):
            raise ValueError(f"JPEG 2000 gray into {out_ch} channels (cv2 returns None)")
        return Rule([0] * out_ch, False, shift, dtype)
    # sYCC (measured): the luma as gray, and as the one channel of a single
    # component; colour through cvtColor's YUV rule of the first three
    if out_ch == 1 or (nc == 1 and flags == IMREAD_UNCHANGED):
        return Rule([0], False, shift, dtype)
    if nc < 3 or out_ch == 4:
        raise ValueError(f"JPEG 2000 sYCC of {nc} component(s) into {out_ch} channels (cv2 returns None)")
    return Rule([0, 1, 2], False, shift, dtype, True)


def apply_rule(img: Image, rule: Rule) -> np.ndarray:
    chans = [(img.planes[c] >> rule.shift).astype(rule.dtype) for c in rule.channels]
    if rule.to_gray:  # R, G, B -> BGR -> cvtColor
        return cvt_color.cvtcolor_gray(np.stack(chans[::-1], axis=-1))
    if rule.yuv:
        return cvt_color.yuv_to_bgr(np.stack(chans, axis=-1))
    if len(chans) == 1:
        return chans[0]
    return np.stack(chans, axis=-1)


#: whole images the plain decoder decoded (0 on the card's path); a caller
#: may reset it
decodes = 0


def decode(data, flags: int = IMREAD_COLOR) -> np.ndarray:
    """JPEG 2000 bytes (``.jp2`` or a raw codestream) -> the array
    ``cv2.imdecode`` gives under ``flags``; raises where cv2 returns None."""
    global decodes
    decodes += 1
    plan = prepare(bytes(data))
    img = jp2_components(plan, components(plan, inverse_dwt(plan, tier1(plan))))
    return apply_rule(img, output_rule(img, flags))


# ------------------------------------------------------------------ encode


class MQEncoder:
    """The MQ coder's encoder (C.2), with the standard flush and the
    predictable (ERTERM) termination, and the raw (bypass) bit writer."""

    def __init__(self):
        self.I = [0] * 19
        self.M = [0] * 19
        self.reset()

    def reset(self):
        for i in range(19):
            self.I[i] = self.M[i] = 0
        self.I[CTX_UNI], self.I[CTX_RL], self.I[0] = 46, 3, 4

    def start(self, raw: bool):
        self.raw = raw
        self.out = [0]  # a byte before the first, as the standard's BP - 1
        self.A, self.C, self.CT = 0x8000, 0, 12
        self.rc, self.rct = 0, 8

    def _byteout(self):
        out = self.out
        if out[-1] == 0xFF:
            out.append(self.C >> 20)
            self.C &= 0xFFFFF
            self.CT = 7
        elif self.C < 0x8000000:
            out.append(self.C >> 19)
            self.C &= 0x7FFFF
            self.CT = 8
        else:
            out[-1] += 1
            if out[-1] == 0xFF:
                self.C &= 0x7FFFFFF
                out.append(self.C >> 20)
                self.C &= 0xFFFFF
                self.CT = 7
            else:
                out.append((self.C >> 19) & 0xFF)
                self.C &= 0x7FFFF
                self.CT = 8

    def encode(self, cx: int, d: int):
        if self.raw:
            self.rct -= 1
            self.rc |= d << self.rct
            if self.rct == 0:
                self.out.append(self.rc)
                self.rct = 7 if self.rc == 0xFF else 8
                self.rc = 0
            return
        i = self.I[cx]
        qe = QE[i]
        self.A -= qe
        if d == self.M[cx]:
            if self.A & 0x8000:
                self.C += qe
                return
            if self.A < qe:
                self.A = qe
            else:
                self.C += qe
            self.I[cx] = NMPS[i]
        else:
            if self.A < qe:
                self.C += qe
            else:
                self.A = qe
            if SWITCH[i]:
                self.M[cx] = 1 - self.M[cx]
            self.I[cx] = NLPS[i]
        while True:
            self.A <<= 1
            self.C <<= 1
            self.CT -= 1
            if self.CT == 0:
                self._byteout()
            if self.A & 0x8000:
                break

    def finish(self, predictable: bool = False) -> bytes:
        if self.raw:
            out = self.out[1:]
            if self.rct < 8 and not (self.rct == 7 and out and out[-1] == 0xFF and self.rc == 0):
                bit = 0
                while self.rct > 0:  # pad with 0, 1, 0, ...
                    self.rct -= 1
                    self.rc |= bit << self.rct
                    bit ^= 1
                out.append(self.rc)
            while out and out[-1] == 0xFF:
                out.pop()
            return bytes(out)
        if predictable:
            k = 11 - self.CT + 1
            while k > 0:
                self.C <<= self.CT
                self.CT = 0
                self._byteout()
                k -= self.CT
            if self.out[-1] != 0xFF:
                self._byteout()
            return bytes(self.out[1:-1])
        temp = self.C + self.A
        self.C |= 0xFFFF
        if self.C >= temp:
            self.C -= 0x8000
        self.C <<= self.CT
        self._byteout()
        self.C <<= self.CT
        self._byteout()
        out = self.out[1:]
        if out and out[-1] == 0xFF:
            out.pop()
        return bytes(out)


def t1_encode_block(mag: np.ndarray, neg: np.ndarray, orient: int, numbps: int, style: int,
                    roishift: int = 0) -> List[Tuple[bytes, int]]:
    """The coding passes of one code-block's magnitudes (ROI already
    shifted up by ``roishift``) and signs -> [(segment bytes, passes)], cut
    into segments as tier-2 counts them for ``style``."""
    h, w = mag.shape
    W = w + 2
    n = W * (h + 2)
    mg = [0] * n
    sg = [0] * n
    for y in range(h):
        row = (y + 1) * W + 1
        mg[row:row + w] = [int(v) for v in mag[y]]
        sg[row:row + w] = [int(v) for v in neg[y]]
    nb = [0] * n
    st = [0] * n
    zc = ZC_LUT[orient]
    vsc = style & VSC
    cols = []
    for k in range(0, h, 4):
        rows = min(4, h - k)
        for x in range(w):
            cols.append(([(k + j + 1) * W + x + 1 for j in range(rows)],
                         [VSC_MASK if vsc and j == 3 else 0xFFF for j in range(rows)], rows == 4))
    mq = MQEncoder()
    enc = mq.encode

    def significant(i):
        st[i] |= 1
        g = sg[i]
        nb[i - W] |= F_S | (G_S if g else 0)
        nb[i + W] |= F_N | (G_N if g else 0)
        nb[i - 1] |= F_E | (G_E if g else 0)
        nb[i + 1] |= F_W | (G_W if g else 0)
        nb[i - W - 1] |= F_SE
        nb[i - W + 1] |= F_SW
        nb[i + W - 1] |= F_NE
        nb[i + W + 1] |= F_NW

    def sign(i, m):
        f = nb[i] & m
        ctx, xor = SC_LUT[(f & 15) | ((f >> 4) & 0xF0)]
        enc(ctx, sg[i] ^ xor)

    def sig_pass(p, raw):
        for idx, mk, _ in cols:
            for i, m in zip(idx, mk):
                if st[i] & 1:
                    continue
                f = nb[i] & m & 0xFF
                if not f:
                    continue
                bit = (mg[i] >> p) & 1
                if raw:
                    enc(0, bit)
                    if bit:
                        enc(0, sg[i])
                        significant(i)
                else:
                    enc(zc[f], bit)
                    if bit:
                        sign(i, m)
                        significant(i)
                st[i] |= 2

    def ref_pass(p, raw):
        for idx, mk, _ in cols:
            for i, m in zip(idx, mk):
                s = st[i]
                if s & 3 != 1:
                    continue
                enc(0 if raw else (16 if s & 4 else (15 if nb[i] & m & 0xFF else 14)), (mg[i] >> p) & 1)
                st[i] = s | 4

    def clean_pass(p):
        for idx, mk, full in cols:
            start = 0
            if full and not (st[idx[0]] | st[idx[1]] | st[idx[2]] | st[idx[3]]) \
                    and not ((nb[idx[0]] & mk[0]) | (nb[idx[1]] & mk[1]) | (nb[idx[2]] & mk[2])
                             | (nb[idx[3]] & mk[3])) & 0xFF:
                hits = [j for j in range(4) if (mg[idx[j]] >> p) & 1]
                if not hits:
                    enc(CTX_RL, 0)
                    continue
                enc(CTX_RL, 1)
                start = hits[0]
                enc(CTX_UNI, start >> 1)
                enc(CTX_UNI, start & 1)
                sign(idx[start], mk[start])
                significant(idx[start])
                start += 1
            for j in range(start, len(idx)):
                i = idx[j]
                if st[i] & 3:
                    continue
                bit = (mg[i] >> p) & 1
                enc(zc[nb[i] & mk[j] & 0xFF], bit)
                if bit:
                    sign(i, mk[j])
                    significant(i)
        for idx, _, _ in cols:
            for i in idx:
                st[i] &= ~2
        if style & SEGSYM:
            for bit in (1, 0, 1, 0):
                enc(CTX_UNI, bit)

    planes = roishift + numbps
    if planes <= 0:
        return []
    npasses = 3 * planes - 2
    segments, first, prev, k = [], True, 0, 0
    bpp1, passtype = planes, 2
    while k < npasses:
        maxp = _max_passes(style, first, prev)
        take = min(maxp, npasses - k)
        raw = bool(style & BYPASS) and passtype < 2 and bpp1 <= numbps - 4
        mq.start(raw)
        for _ in range(take):
            if passtype == 0:
                sig_pass(bpp1 - 1, raw)
            elif passtype == 1:
                ref_pass(bpp1 - 1, raw)
            else:
                clean_pass(bpp1 - 1)
            if style & RESET and not raw:
                mq.reset()
            passtype += 1
            if passtype == 3:
                passtype, bpp1 = 0, bpp1 - 1
        segments.append((mq.finish(bool(style & PTERM)), take))
        first, prev, k = False, maxp, k + take
    return segments


def _t1_encode_star(args):
    return t1_encode_block(*args)


class BitWriter:
    """Packet-header bits, stuffed as :class:`BitReader` reads them."""

    def __init__(self):
        self.out = bytearray()
        self.buf, self.ct = 0, 8

    def _byteout(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def write(self, bit: int, n: int = 1):
        for k in range(n - 1, -1, -1):
            if self.ct == 0:
                self._byteout()
            self.ct -= 1
            self.buf |= ((bit >> k) & 1) << self.ct

    def flush(self) -> bytes:
        self.ct = 0
        self._byteout()
        if self.ct == 7:
            self.ct = 0
            self._byteout()
        return bytes(self.out)


def _write_passes(bits: BitWriter, n: int) -> None:
    if n == 1:
        bits.write(0)
    elif n == 2:
        bits.write(0b10, 2)
    elif n <= 5:
        bits.write(0b1100 | (n - 3), 4)
    elif n <= 36:
        bits.write((0b1111 << 5) | (n - 6), 9)
    else:
        bits.write((0b111111111 << 7) | (n - 37), 16)


def _fdwt53_lines(x: np.ndarray) -> np.ndarray:
    """Forward 5/3 along the last axis of (lines, n) int64, samples at even
    coordinates first: lows then highs out (the inverse of
    :func:`_idwt53_lines` at ``cas`` 0)."""
    n = x.shape[1]
    if n == 1:
        return x.copy()
    ev, od = x[:, 0::2].copy(), x[:, 1::2].copy()
    sn, dn = ev.shape[1], od.shape[1]
    od -= (ev[:, :dn] + ev[:, np.minimum(np.arange(dn) + 1, sn - 1)]) >> 1
    ev += (od[:, np.maximum(np.arange(sn) - 1, 0)] + od[:, np.minimum(np.arange(sn), dn - 1)] + 2) >> 2
    return np.concatenate([ev, od], axis=1)


def encode(img, *, levels: Optional[int] = None, style: int = 0, progression: str = "LRCP",
           precincts: Optional[List[Tuple[int, int]]] = None, cblk: Tuple[int, int] = (6, 6), sop: bool = False,
           eph: bool = False, packed: Optional[str] = None, roi_shift: int = 0, codestream: bool = False,
           colour: Optional[int] = None, map=map) -> bytes:
    """A lossless ``.jp2`` of ``img``: (H, W) gray, (H, W, 3) BGR or (H, W,
    4) BGRA, uint8 or uint16 (see the module's text). The keywords exist for
    the fixture script: code-block ``style`` bits, ``progression``,
    ``precincts`` (log2 width, height per resolution), ``cblk`` (log2
    code-block width, height), SOP / EPH markers, packet headers ``packed``
    into "ppm" or "ppt", an ROI maxshift of ``roi_shift`` for the top-left
    quarter of every subband, and a raw ``codestream``. ``colour=SYCC``
    writes a (H, W, 3) image's channels as stored, taken for Y, Cb, Cr,
    without the component transform, under an sYCC ``colr``. ``map`` may be
    a process pool's, to code the blocks in parallel."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"the JPEG 2000 writer takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        planes = [img]
    elif colour == SYCC and img.ndim == 3 and img.shape[2] == 3:
        planes = [img[..., 0], img[..., 1], img[..., 2]]
    elif img.ndim == 3 and img.shape[2] in (3, 4) and colour is None:
        planes = [img[..., 2], img[..., 1], img[..., 0]] + ([img[..., 3]] if img.shape[2] == 4 else [])
    else:
        raise ValueError(f"the JPEG 2000 writer takes (H, W), (H, W, 3) or (H, W, 4), got {img.shape}")
    height, width = img.shape[:2]
    if min(height, width) < 32:
        raise ValueError(f"JPEG 2000 writer: {height}x{width} is below 32 pixels on a side "
                         "(cv2's OpenJPEG writer fails there: too many resolutions)")
    prec = 8 * img.dtype.itemsize
    nc = len(planes)
    nl = min(5, int(math.log2(min(height, width)))) if levels is None else levels
    comps = [p.astype(np.int64) - (1 << prec - 1) for p in planes]
    mct = 1 if nc >= 3 and colour is None else 0
    if mct:
        r, g, b = comps[:3]
        comps[:3] = [(r + 2 * g + b) >> 2, b - g, r - g]
    # forward wavelet: each level columns then rows, the inverse's reverse
    coefs = []
    for plane in comps:
        a = plane.copy()
        rh, rw = height, width
        for _ in range(nl):
            a[:rh, :rw] = _fdwt53_lines(a[:rh, :rw].T).T
            a[:rh, :rw] = _fdwt53_lines(a[:rh, :rw])
            rh, rw = _cdiv(rh, 2), _cdiv(rw, 2)
        coefs.append(a)
    pp = precincts or [(15, 15)] * (nl + 1)
    prog = PROGRESSIONS.index(progression)
    coding = Coding(nl, cblk[0], cblk[1], style, True, list(pp))
    # exponents: the band's nominal range (precision + gain, plus one for
    # RCT's chroma), guard bits as the data need
    gains = [0] + [g for _ in range(nl) for g in (1, 1, 2)]
    expn = [[prec + g + (1 if mct and c in (1, 2) else 0) for g in gains] for c in range(nc)]
    head = Header(cod={"sop": sop, "eph": eph, "prog": prog, "layers": 1, "mct": mct, "coding": coding},
                  qcd=Quant(2, 0, [(e, 0) for e in expn[0]]))
    for c in range(1, nc):
        if expn[c] != expn[0]:
            head.qcc[c] = Quant(2, 0, [(e, 0) for e in expn[c]])
    if roi_shift:
        for c in range(nc):
            head.rgn[c] = roi_shift
    cs = Codestream(width, height, 0, 0, width, height, 0, 0, [prec] * nc, [False] * nc, [1] * nc, [1] * nc,
                    head, {})
    tile = tile_geometry(cs, 0)
    # guard bits: enough for the largest magnitude of every band
    guard = 2
    for tc in tile.comps:
        for res in tile.comps[tc.comp].resolutions:
            for band in res.bands:
                sub = _band_view(coefs[tc.comp], tc, band)
                top = int(np.abs(sub).max(initial=0)).bit_length()
                guard = max(guard, top - expn[tc.comp][band.index] + 1)
    if guard > 7:
        raise ValueError("JPEG 2000 writer: coefficients beyond 7 guard bits")
    for q in [head.qcd, *head.qcc.values()]:
        q.guard = guard
    tile = tile_geometry(cs, 0)
    # tier-1
    jobs, keys = [], []
    for tc in tile.comps:
        for res in tc.resolutions:
            for band in res.bands:
                sub = _band_view(coefs[tc.comp], tc, band)
                bw, bh = band.x1 - band.x0, band.y1 - band.y0
                for prc in band.precincts:
                    for blk in prc["blocks"]:
                        v = sub[blk.y0 - band.y0:blk.y1 - band.y0, blk.x0 - band.x0:blk.x1 - band.x0]
                        mag = np.abs(v)
                        k = int(mag.max(initial=0)).bit_length()
                        zbp = band.mb - k
                        if roi_shift:
                            ys = np.arange(blk.y0, blk.y1)[:, None] - band.y0 < _cdiv(bh, 2)
                            xs = np.arange(blk.x0, blk.x1)[None, :] - band.x0 < _cdiv(bw, 2)
                            mag = np.where(ys & xs, mag << roi_shift, mag)
                        jobs.append((mag, v < 0, band.orient, k, style, roi_shift if k else 0))
                        keys.append((id(blk), zbp))
    coded = {key: (zbp, segs) for (key, zbp), segs in zip(keys, map(_t1_encode_star, jobs))}
    # tier-2: one layer
    heads, bodies = [], []
    for nsop, (l, r, c, p) in enumerate(packet_order(cs, tile)):
        res = tile.comps[c].resolutions[r]
        bits = BitWriter()
        body = bytearray()
        entries = [(band, band.precincts[p]) for band in res.bands]
        if not any(coded[id(b)][1] for _, prc in entries for b in prc["blocks"]):
            bits.write(0)
        else:
            bits.write(1)
            for band, prc in entries:
                blocks = prc["blocks"]
                if not blocks:
                    continue
                prc["incl"].set_values([0 if coded[id(b)][1] else 1 for b in blocks])
                prc["zbp"].set_values([coded[id(b)][0] for b in blocks])
                for k, blk in enumerate(blocks):
                    zbp, segs = coded[id(blk)]
                    prc["incl"].encode(bits, k, l + 1)
                    if not segs:
                        continue
                    prc["zbp"].encode(bits, k, zbp + 1)
                    _write_passes(bits, sum(s[1] for s in segs))
                    need = max(max(len(s[0]).bit_length(), 1) - (s[1].bit_length() - 1) for s in segs)
                    inc = max(0, need - 3)
                    bits.write((1 << inc) - 1 << 1, inc + 1)
                    for data, npass in segs:
                        bits.write(len(data), 3 + inc + npass.bit_length() - 1)
                        body += data
        hdr = bits.flush() + (b"\xff\x92" if eph else b"")
        marker = struct.pack(">HHH", 0xFF91, 4, nsop & 0xFFFF) if sop else b""
        if packed:
            heads.append(hdr)
            bodies.append(marker + bytes(body))
        else:
            bodies.append(marker + hdr + bytes(body))
    return _write_codestream(cs, coding, head, b"".join(heads), b"".join(bodies), packed, codestream, nc, prec, colour)


def _band_view(coef: np.ndarray, tc: TileComp, band: Band) -> np.ndarray:
    r = next(k for k, res in enumerate(tc.resolutions) if band in res.bands)
    prev = tc.resolutions[r - 1] if r else None
    ox = prev.x1 - prev.x0 if prev is not None and band.orient & 1 else 0
    oy = prev.y1 - prev.y0 if prev is not None and band.orient & 2 else 0
    return coef[oy:oy + band.y1 - band.y0, ox:ox + band.x1 - band.x0]


def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">HH", code, len(body) + 2) + body


def _write_codestream(cs: Codestream, coding: Coding, head: Header, headers: bytes, body: bytes,
                      packed: Optional[str], raw: bool, nc: int, prec: int, colour: Optional[int] = None) -> bytes:
    siz = struct.pack(">HIIIIIIIIH", 0, cs.width, cs.height, 0, 0, cs.width, cs.height, 0, 0, nc)
    siz += bytes([prec - 1, 1, 1]) * nc
    cod = head.cod
    scod = (1 if any(p != (15, 15) for p in coding.precincts) else 0) | (2 if cod["sop"] else 0) \
        | (4 if cod["eph"] else 0)
    spcod = bytes([coding.levels, coding.xcb - 2, coding.ycb - 2, coding.style, 1])
    if scod & 1:
        spcod += bytes(x | (y << 4) for x, y in coding.precincts)
    main = _marker(0xFF51, siz) + _marker(0xFF52, struct.pack(">BBHB", scod, cod["prog"], 1, cod["mct"]) + spcod)
    q = head.qcd
    main += _marker(0xFF5C, bytes([q.guard << 5]) + bytes(e << 3 for e, _ in q.steps))
    for c, q in sorted(head.qcc.items()):
        main += _marker(0xFF5D, bytes([c, q.guard << 5]) + bytes(e << 3 for e, _ in q.steps))
    for c, s in sorted(head.rgn.items()):
        main += _marker(0xFF5E, bytes([c, 0, s]))
    main += _marker(0xFF64, b"\x00\x01dspnet_torch")
    tile_head = b""
    if packed == "ppm":
        main += _marker(0xFF60, b"\x00" + struct.pack(">I", len(headers)) + headers)
    elif packed == "ppt":
        tile_head = _marker(0xFF61, b"\x00" + headers)
    elif packed is not None:
        raise ValueError(f"packed headers go into 'ppm' or 'ppt', not {packed!r}")
    psot = 12 + len(tile_head) + 2 + len(body)
    sot = _marker(0xFF90, struct.pack(">HIBB", 0, psot, 0, 1))
    stream = J2K_MAGIC[:2] + main + sot + tile_head + b"\xff\x93" + body + b"\xff\xd9"
    if raw:
        return stream
    ihdr = struct.pack(">IIHBBBB", cs.height, cs.width, nc, prec - 1, 7, 0, 0)
    colr = struct.pack(">BBBI", 1, 0, 0, colour or (SRGB if nc >= 3 else GRAY))

    def box(kind, data):
        return struct.pack(">I", len(data) + 8) + kind + data

    jp2h = box(b"jp2h", box(b"ihdr", ihdr) + box(b"colr", colr))
    return (JP2_MAGIC + box(b"ftyp", b"jp2 " + b"\x00\x00\x00\x00" + b"jp2 ") + jp2h + box(b"jp2c", stream))
