"""AVIF files read as cv2 5.0.0 reads them (``imdecode`` / ``imread`` over
libavif 1.4.2 on libaom 3.14.1), without cv2: the container and the colour
rule around the AV1 decoder of ``data/av1_cuda.py``.

:func:`plan` takes the primary item (``data/heif.py``), a ``grid`` of tiles
or one coded image, and its alpha auxiliary image; ``av1_cuda.decode``
decodes each AV1 item (``data/av1_obu.py``, ``av1_parse.py``, then its
kernels on the card or their plain versions, ``av1_recon.py`` and
``av1_filters.py``, on the CPU), :func:`finish` adds film grain
(``av1_grain.py``), :func:`assemble` stitches a grid, and :func:`to_output`
returns cv2's array:

* ``IMREAD_UNCHANGED``: a monochrome image gives its (H, W) luma as
  stored; colour gives BGR, or BGRA with an alpha item; 8 bits are uint8,
  10 and 12 bits uint16 with values not scaled;
* ``IMREAD_COLOR``: (H, W, 3) uint8 BGR; alpha dropped (a premultiplied
  image's colour divided by it first); monochrome luma
  repeated (above 8 bits rounded by ``cvRound(y / 2^(bits - 8))``);
* ``IMREAD_GRAYSCALE``: cv2's 15-bit ``cvtColor(BGR2GRAY)`` of the
  ``IMREAD_COLOR`` array, or the monochrome luma as under
  ``IMREAD_COLOR``.

Colour follows libavif's ``avifImageYUVToRGB`` as cv2's wheel builds it:
libyuv is linked in, so 8-bit YUV with a matrix libyuv knows (BT.601 and
unspecified, BT.709, BT.2020, full or limited range) converts by libyuv's
integer ``YuvPixel`` with its bilinear chroma upsampling
(``I420ToRGB24MatrixFilter`` and the 4:2:2 / 4:4:4 kin); deeper YUV read as
8-bit BGR is first cut to 8 bits (``v >> (bits - 8)``, libyuv's
``Convert16To8Plane``); 10- and 12-bit BGR under ``IMREAD_UNCHANGED`` go
through libavif's own float path (the unorm lookup tables and bilinear
9/3/3/1 weights, float32, no fused multiply-add); an 8-bit identity-matrix
4:4:4 full-range image is copied (G = Y, B = U, R = V). The matrix and
range come from the ``colr`` ``nclx`` property, else the sequence header.
The conversion runs as torch ops (:func:`to_output`) on the planes'
device.

What is refused, by name: superres, layered images (``a1lx`` / ``lsel``),
progressive AVIF, ``tmap`` gain-map images, a premultiplied alpha above 8
bits, matrices neither libyuv nor libavif's float path covers
(chroma-derived), a missing or broken item.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from dspnet_torch.data import av1_grain, av1_obu, heif

IMREAD_UNCHANGED = -1
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1

#: libyuv's YuvConstants (x86 layout) as (ub, ug, vg, vr, yg, yb)
LIBYUV_CONSTANTS = {
    "JPEG": (113, 22, 46, 90, 16320, 32), "I601": (128, 25, 52, 102, 18997, -1160),
    "F709": (119, 12, 30, 101, 16320, 32), "H709": (128, 14, 34, 115, 18997, -1160),
    "V2020": (120, 11, 37, 94, 16320, 32), "2020": (128, 12, 42, 107, 19003, -1160),
}
#: libavif's choice of constants by (matrix coefficients, full range)
_LIBYUV_MATRIX = {(1, 1): "F709", (5, 1): "JPEG", (6, 1): "JPEG", (2, 1): "JPEG", (9, 1): "V2020",
                  (1, 0): "H709", (5, 0): "I601", (6, 0): "I601", (2, 0): "I601", (9, 0): "2020"}
#: libavif's (kr, kb) by matrix coefficients (BT.601 for the rest)
_KR_KB = {1: (0.2126, 0.0722), 4: (0.30, 0.11), 5: (0.299, 0.114), 6: (0.299, 0.114), 7: (0.212, 0.087),
          9: (0.2627, 0.0593)}


class AvifError(ValueError):
    """An AVIF file the port does not read, or one cv2 returns None for."""


@dataclass
class Coded:
    """One AV1 item to decode."""

    frame: av1_obu.Frame
    x: int = 0  # where it lands in a grid
    y: int = 0


@dataclass
class Plan:
    color: List[Coded]
    alpha: List[Coded]
    width: int
    height: int
    bit_depth: int
    mono: bool
    ssx: int
    ssy: int
    matrix: int
    full_range: int
    alpha_depth: int = 8
    premultiplied: bool = False


def _frame(item: heif.Item) -> av1_obu.Frame:
    if item.type != "av01":
        raise AvifError(f"AVIF item of type {item.type!r} is not an AV1 image")
    for name in ("a1lx", "lsel"):
        if name in item.props:
            raise AvifError(f"AVIF layered image ({name}) is not read")
    cfg = item.props.get("av1C", b"")
    try:
        return av1_obu.read_frame(item.data, cfg[4:] if len(cfg) > 4 else b"")
    except av1_obu.Av1Error as e:
        raise AvifError(str(e)) from None


def _grid(h: heif.Heif, item: heif.Item) -> tuple:
    """The tiles of a ``grid`` item, each placed; cv2 (libavif's MIAF
    check) refuses tiles below 64 samples on a side."""
    d = item.data
    if len(d) < 8 or d[0] != 0:
        raise AvifError("AVIF grid with a broken ImageGrid")
    rows, cols = d[2] + 1, d[3] + 1
    if d[1] & 1:
        w, hh = struct.unpack(">II", d[4:12])
    else:
        w, hh = struct.unpack(">HH", d[4:8])
    tiles = item.refs.get("dimg", [])
    if len(tiles) != rows * cols:
        raise AvifError("AVIF grid whose tile count differs from rows x columns")
    coded = []
    frames = [_frame(h.items[t]) for t in tiles]
    tw, th = frames[0].hdr.width, frames[0].hdr.height
    for k, fr in enumerate(frames):
        if (fr.hdr.width, fr.hdr.height) != (tw, th):
            raise AvifError("AVIF grid tiles of unequal sizes")
        coded.append(Coded(fr, (k % cols) * tw, (k // cols) * th))
    if tw < 64 or th < 64:
        raise AvifError(f"AVIF grid tile of {tw}x{th} (below MIAF's 64 samples a side; cv2 returns None)")
    if tw * cols < w or th * rows < hh:
        raise AvifError("AVIF grid smaller than its output size")
    return coded, w, hh


def plan(data: bytes) -> Plan:
    """The items cv2 decodes for ``data`` and how they combine."""
    try:
        h = heif.parse(data)
    except (heif.HeifError, IndexError, struct.error) as e:
        raise AvifError(f"AVIF container: {e}") from None
    item = h.items[h.primary]
    if item.type == "tmap":
        raise AvifError("AVIF tone-mapped gain-map image (tmap) is not read")
    for name in item.essential:
        if name not in ("av1C", "ispe", "pixi", "colr", "irot", "imir", "clap", "auxC"):
            raise AvifError(f"AVIF essential property {name!r} is not read")
    if item.type == "grid":
        color, w, hh = _grid(h, item)
    else:
        fr = _frame(item)
        color, w, hh = [Coded(fr)], fr.hdr.width, fr.hdr.height
    alpha = []
    a = h.alpha_of(h.primary)
    premultiplied = False
    if a is not None:
        if a.type == "grid":
            alpha, aw, ah = _grid(h, a)
        else:
            alpha = [Coded(_frame(a))]
        premultiplied = a.id in item.refs.get("prem", [])
    s = color[0].frame.seq
    colr = item.props.get("colr")
    if colr is None and item.type == "grid":
        colr = h.items[item.refs["dimg"][0]].props.get("colr")
    if colr is not None and colr[0] == "nclx":
        matrix, full = colr[3], colr[4]
    else:
        matrix, full = s.matrix, s.color_range
    p = Plan(color, alpha, w, hh, s.bit_depth, bool(s.mono), s.ssx, s.ssy, matrix, full,
             premultiplied=premultiplied)
    if alpha:
        p.alpha_depth = alpha[0].frame.seq.bit_depth
    return p


def image_size(data: bytes) -> tuple:
    """(height, width) of cv2's array, from the headers alone."""
    p = plan(bytes(data))
    return p.height, p.width


def finish(frame: av1_obu.Frame, planes: List[torch.Tensor]) -> list:
    """Planes of the filter stages -> cut to the frame's size, with film
    grain (torch ops on the planes' device)."""
    s, h = frame.seq, frame.hdr
    out = []
    for i, pl in enumerate(planes):
        sx, sy = (s.ssx, s.ssy) if i else (0, 0)
        out.append(pl[:(h.height + sy) >> sy, :(h.width + sx) >> sx].contiguous())
    if h.grain.apply:
        noise = av1_grain.noise_planes(h.grain, s.bit_depth, bool(s.mono), s.ssx, s.ssy, h.width, h.height,
                                       out[0].device)
        out = av1_grain.apply(out, noise, h.grain, s.bit_depth, s.ssx, s.ssy, s.matrix)
    return out


def assemble(p: Plan, coded: List[Coded], planes: List[list]) -> list:
    """Tiles' planes -> the image's planes (a grid stitched and cut)."""
    if len(coded) == 1:
        return planes[0]
    s = coded[0].frame.seq
    dev = planes[0][0].device
    out = []
    for i in range(len(planes[0])):
        sx, sy = (s.ssx, s.ssy) if i else (0, 0)
        buf = torch.zeros(((p.height + sy) >> sy, (p.width + sx) >> sx), dtype=torch.int32, device=dev)
        for c, pl in zip(coded, planes):
            y0, x0 = c.y >> sy, c.x >> sx
            hh = min(pl[i].shape[0], buf.shape[0] - y0)
            ww = min(pl[i].shape[1], buf.shape[1] - x0)
            if hh > 0 and ww > 0:
                buf[y0:y0 + hh, x0:x0 + ww] = pl[i][:hh, :ww]
        out.append(buf)
    return out


# -- libavif's conversion -----------------------------------------------------------

def _up_linear(row: torch.Tensor, w: int) -> torch.Tensor:
    """libyuv's ``ScaleRowUp2_Linear_Any`` over the last axis -> w samples."""
    out = torch.empty(row.shape[:-1] + (w,), dtype=row.dtype, device=row.device)
    out[..., 0] = row[..., 0]
    work = (w - 1) & ~1
    if work > 0:
        a, b = row[..., :work // 2], row[..., 1:work // 2 + 1]
        out[..., 1:work + 1:2] = (a * 3 + b + 2) >> 2
        out[..., 2:work + 2:2] = (a + b * 3 + 2) >> 2
    out[..., w - 1] = row[..., (w - 1) // 2]
    return out


def _up_bilinear(sa: torch.Tensor, sb: torch.Tensor, w: int):
    """libyuv's ``ScaleRowUp2_Bilinear_Any`` of chroma rows pairs."""
    da = torch.empty(sa.shape[:-1] + (w,), dtype=sa.dtype, device=sa.device)
    db = torch.empty_like(da)
    da[..., 0] = (3 * sa[..., 0] + sb[..., 0] + 2) >> 2
    db[..., 0] = (sa[..., 0] + 3 * sb[..., 0] + 2) >> 2
    work = (w - 1) & ~1
    if work > 0:
        n = work // 2
        s0, s1, t0, t1 = sa[..., :n], sa[..., 1:n + 1], sb[..., :n], sb[..., 1:n + 1]
        da[..., 1:work + 1:2] = (s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4
        da[..., 2:work + 2:2] = (s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4
        db[..., 1:work + 1:2] = (s0 * 3 + s1 + t0 * 9 + t1 * 3 + 8) >> 4
        db[..., 2:work + 2:2] = (s0 + s1 * 3 + t0 * 3 + t1 * 9 + 8) >> 4
    k = (w - 1) // 2
    da[..., w - 1] = (3 * sa[..., k] + sb[..., k] + 2) >> 2
    db[..., w - 1] = (sa[..., k] + 3 * sb[..., k] + 2) >> 2
    return da, db


def libyuv_upsample(c: torch.Tensor, h: int, w: int, ssx: int, ssy: int) -> torch.Tensor:
    """A chroma plane at luma size by libyuv's filters (4:2:0 bilinear,
    4:2:2 linear)."""
    if not ssx and not ssy:
        return c
    if not ssy:
        return _up_linear(c, w)
    out = torch.empty((h, w), dtype=c.dtype, device=c.device)
    out[0] = _up_linear(c[0], w)
    pairs = (h - 1) // 2
    if pairs:
        da, db = _up_bilinear(c[:pairs], c[1:pairs + 1], w)
        out[1:2 * pairs + 1:2] = da
        out[2:2 * pairs + 2:2] = db
    if not (h & 1):
        out[h - 1] = _up_linear(c[pairs], w)
    return out


def libyuv_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, name: str, ssx: int, ssy: int) -> torch.Tensor:
    """8-bit YUV -> (H, W, 3) uint8 BGR by libyuv's ``YuvPixel``."""
    ub, ug, vg, vr, yg, yb = LIBYUV_CONSTANTS[name]
    hh, w = y.shape
    yy = y.to(torch.int64)
    uu = libyuv_upsample(u.to(torch.int64), hh, w, ssx, ssy) - 128
    vv = libyuv_upsample(v.to(torch.int64), hh, w, ssx, ssy) - 128
    y1 = ((yy * 0x0101 * yg) >> 16) + yb
    b = y1 + uu * ub
    g = y1 - (uu * ug + vv * vg)
    r = y1 + vv * vr
    return torch.stack([torch.clamp(x >> 6, 0, 255) for x in (b, g, r)], -1).to(torch.uint8)


def float_bgr(y, u, v, bd: int, full: int, matrix: int, ssx: int, ssy: int, out_depth: int,
              alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """libavif's ``avifImageYUVAnyToRGBAnySlow`` with bilinear chroma ->
    (H, W, 3) BGR at ``out_depth`` bits (int64); with ``alpha``, each
    colour divided by it (the unmultiply of a premultiplied image).

    Every operation is one float32 operation rounded on its own, as C
    computes it: the unorm tables in numpy, every constant a tensor on the
    planes' device (PyTorch's CUDA division by a host scalar multiplies by
    its reciprocal instead, which is not the quotient)."""
    f32 = torch.float32
    dev = y.device
    maxc = (1 << bd) - 1

    def k(x) -> torch.Tensor:
        return torch.tensor(np.float32(x), dtype=f32, device=dev)

    cp = np.arange(maxc + 1, dtype=np.float32)
    if full:
        by, ry, buv, ruv = 0, maxc, 1 << (bd - 1), maxc
    else:
        by, ry, buv, ruv = 16 << (bd - 8), 219 << (bd - 8), 1 << (bd - 1), 224 << (bd - 8)
    identity = matrix == 0
    if identity:
        buv, ruv = by, ry
    ty = torch.from_numpy((cp - np.float32(by)) / np.float32(ry)).to(dev)
    tuv = torch.from_numpy((cp - np.float32(buv)) / np.float32(ruv)).to(dev)
    yy = ty[torch.clamp(y.to(torch.int64), max=maxc)]
    if u is None:
        r = g = b = yy
    else:
        hh, w = y.shape
        ch, cw = u.shape
        j = torch.arange(hh, device=dev)[:, None]
        i = torch.arange(w, device=dev)[None, :]
        uj, ui = (j >> ssy).expand(hh, w), (i >> ssx).expand(hh, w)
        if (ssx, ssy) == (0, 0):
            cb = tuv[u.to(torch.int64)[uj, ui]]
            cr = tuv[v.to(torch.int64)[uj, ui]]
        else:
            if ssx:
                adjc = torch.where((i == 0) | ((i == w - 1) & (i % 2 != 0)), 0, torch.where(i % 2 != 0, 1, -1))
            else:
                adjc = torch.zeros_like(i)
            adjr = torch.where((j == 0) | ((j == hh - 1) & (j % 2 != 0)) | torch.tensor(ssy == 0, device=dev), 0,
                               torch.where(j % 2 != 0, 1, -1))
            adjc, adjr = adjc.expand(hh, w), adjr.expand(hh, w)

            def g_(pl, dr, dc):
                return tuv[pl.to(torch.int64)[torch.clamp(uj + dr, 0, ch - 1), torch.clamp(ui + dc, 0, cw - 1)]]

            w9, w3, w1 = k(9 / 16), k(3 / 16), k(1 / 16)
            cb = g_(u, 0, 0) * w9 + g_(u, 0, adjc) * w3 + g_(u, adjr, 0) * w3 + g_(u, adjr, adjc) * w1
            cr = g_(v, 0, 0) * w9 + g_(v, 0, adjc) * w3 + g_(v, adjr, 0) * w3 + g_(v, adjr, adjc) * w1
        if identity:
            g, b, r = yy, cb, cr
        elif matrix == 8:
            t = yy - cb
            g = yy + cb
            b = t - cr
            r = t + cr
        else:
            kr_, kb_ = _KR_KB.get(matrix, (0.299, 0.114))
            kr, kb, one, two = k(kr_), k(kb_), k(1.0), k(2.0)
            kg = one - kr - kb
            r = yy + (two * (one - kr)) * cr
            b = yy + (two * (one - kb)) * cb
            g = yy - ((two * ((kr * (one - kr) * cr) + (kb * (one - kb) * cb))) / kg)
    mx, half = k((1 << out_depth) - 1), k(0.5)
    cs = [torch.clamp(c, 0.0, 1.0) for c in (b, g, r)]
    if alpha is not None:
        a = torch.clamp(alpha.to(f32) / k(maxc), 0.0, 1.0)
        cs = [torch.where(a == 0, torch.zeros_like(c), torch.where(a < 1, torch.clamp(c / a, max=1.0), c)) for c in cs]
    return torch.stack([(half + c * mx).to(torch.int64) for c in cs], -1)


def color_bgr(p: Plan, planes: list, depth8: bool) -> torch.Tensor:
    """The BGR of a colour image: uint8 (``depth8``) or the stored depth."""
    y, u, v = planes
    bd = p.bit_depth
    if depth8:
        name = _LIBYUV_MATRIX.get((p.matrix, int(p.full_range)))
        if bd == 8 and p.matrix == 0 and (p.ssx, p.ssy) == (0, 0) and p.full_range:
            return torch.stack([u, y, v], -1).to(torch.uint8)
        if name is not None:
            sh = bd - 8
            return libyuv_bgr(y >> sh, u >> sh, v >> sh, name, p.ssx, p.ssy)
        if p.matrix not in _KR_KB and p.matrix not in (0, 2, 8):
            raise AvifError(f"AVIF matrix coefficients {p.matrix} are not read")
        if bd > 8:
            sh = bd - 8
            y, u, v = y >> sh, u >> sh, v >> sh
        return float_bgr(y, u, v, 8, p.full_range, p.matrix, p.ssx, p.ssy, 8).to(torch.uint8)
    if p.matrix not in _KR_KB and p.matrix not in (0, 2, 8):
        raise AvifError(f"AVIF matrix coefficients {p.matrix} are not read")
    return float_bgr(y, u, v, bd, p.full_range, p.matrix, p.ssx, p.ssy, bd).to(torch.int32)


def unattenuate(bgr: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """libyuv's ``ARGBUnattenuate`` as its x86 SIMD rows compute it, which
    is how libavif unmultiplies a premultiplied 8-bit image: ``ia`` from
    ``fixed_invtbl8`` (65536 // a; 0xffff at 1, 256 at 255), ``((f * 257)
    * ia) >> 16`` as 16 bits, then packed with signed saturation (a value
    past 32767 becomes 0)."""
    a = a.to(torch.int64)
    ia = torch.where(a >= 255, 256, torch.where(a >= 2, 65536 // torch.clamp(a, min=1),
                                                torch.where(a == 1, 0xFFFF, 0)))
    v = ((bgr.to(torch.int64) * 257) * ia[..., None]) >> 16
    return torch.where(v >= 32768, 0, torch.clamp(v, max=255)).to(torch.uint8)


def to_output(p: Plan, planes: list, alpha: Optional[list], flags: int) -> torch.Tensor:
    """The decoded planes -> cv2's array under ``flags`` (a tensor on the
    planes' device)."""
    bd = p.bit_depth
    if p.mono:
        yv = planes[0]
        if flags == IMREAD_UNCHANGED:
            return yv.to(torch.uint16 if bd > 8 else torch.uint8)
        if bd > 8:  # a power of two: the quotient is exact either way
            yv = torch.clamp(torch.round(yv.to(torch.float64) / (1 << (bd - 8))), 0, 255)
        g = yv.to(torch.uint8)
        return g if flags == IMREAD_GRAYSCALE else g[..., None].expand(*g.shape, 3).contiguous()
    if alpha is not None and p.premultiplied:
        if bd > 8:
            raise AvifError("AVIF premultiplied alpha above 8 bits is not read")
        bgr = unattenuate(color_bgr(p, planes, depth8=True), alpha[0])
        if flags == IMREAD_UNCHANGED:
            return torch.cat([bgr, alpha[0][..., None].to(torch.uint8)], -1)
    elif flags == IMREAD_UNCHANGED and bd > 8:
        bgr = color_bgr(p, planes, depth8=False).to(torch.uint16)
    else:
        bgr = color_bgr(p, planes, depth8=True)
    if flags == IMREAD_GRAYSCALE:
        b, g, r = (bgr[..., i].to(torch.int64) for i in range(3))
        return ((3735 * b + 19235 * g + 9798 * r + 16384) >> 15).to(torch.uint8)
    if flags == IMREAD_UNCHANGED and alpha is not None:
        a = alpha[0]
        if bd > 8:
            a = a if p.alpha_depth == bd else a << (bd - p.alpha_depth) if p.alpha_depth < bd else a >> (p.alpha_depth - bd)
        elif p.alpha_depth > 8:
            a = a >> (p.alpha_depth - 8)
        return torch.cat([bgr, a[..., None].to(bgr.dtype)], -1)
    return bgr

