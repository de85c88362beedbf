"""Radiance HDR (RGBE) images without cv2: the reader and writer of cv2
5.0.0's ``grfmt_hdr.cpp`` over Greg Ward's ``rgbe.cpp``, bit for bit.

Read: the header as ``RGBE_ReadHeader`` reads it: ``#?`` program line,
any lines up to ``FORMAT=32-bit_rle_rgbe``, which must be followed by a
blank line, then ``-Y <height> +X <width>`` (any other orientation, and an
``32-bit_rle_xyze`` file, is refused, as cv2 returns None for them). Pixels
as ``RGBE_ReadPixels_RLE`` reads them: a scanline starting ``2 2`` with its
width is new-style RLE (four channel runs, ``> 128`` a run, else a literal);
widths below 8 or above 32767, or a first scanline that does not start so,
are read flat, four bytes a pixel (old-style ``1 1 1 n`` runs are not
expanded: ``rgbe.cpp`` reads them as pixels). ``rgbe2float``: a mantissa
times float32(2 ** (e - 136)), 0 where e is 0. RGB comes back BGR: float32
under ``IMREAD_UNCHANGED``; under ``IMREAD_COLOR`` ``v * 255`` through
``saturate_cast<uchar>`` (half to even; inf and values past the int range
give 0); under ``IMREAD_GRAYSCALE`` that uint8 image through cv2 5's
cvtColor (15-bit weights, ``data/cvt_color.py``).

Write: ``cv2.imencode('.hdr')``'s bytes: the header above, then each
scanline RLE (``RGBE_WritePixels_RLE`` and ``RGBE_WriteBytes_RLE``), flat
below 8 pixels; a uint8 image is first scaled by float32(1 / 255), a gray
one repeated to three channels; BGR is stored RGB; ``float2rgbe``
truncates each field.
"""

from __future__ import annotations

import re

import numpy as np

from dspnet_torch.data import cvt_color

MAGICS = (b"#?RADIANCE", b"#?RGBE")


class HdrError(ValueError):
    pass


def _lines(data: bytes, pos: int):
    """fgets: each line with its newline, and the position after it."""
    end = data.find(b"\n", pos)
    if end < 0:
        raise HdrError("HDR header ends without its size line")
    return data[pos:end + 1], end + 1


def read_header(data: bytes):
    """-> (height, width, position of the pixels)."""
    if not data.startswith(MAGICS):
        raise HdrError("not a Radiance HDR file")
    _, pos = _lines(data, 0)
    while True:
        line, pos = _lines(data, pos)
        if line == b"\n":
            raise HdrError("HDR header has no FORMAT=32-bit_rle_rgbe line (cv2 returns None)")
        if line == b"FORMAT=32-bit_rle_rgbe\n":
            break
    line, pos = _lines(data, pos)
    if line != b"\n":
        raise HdrError("HDR header: no blank line after FORMAT (cv2 returns None)")
    line, pos = _lines(data, pos)
    m = re.match(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)", line)
    if not m:
        raise HdrError(f"HDR size line {line!r}: cv2 reads only -Y <height> +X <width>")
    h, w = int(m.group(1)), int(m.group(2))
    if h <= 0 or w <= 0:
        raise HdrError(f"HDR size {h}x{w}")
    return h, w, pos


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 -> (..., 3) float32, ``rgbe2float``."""
    e = rgbe[..., 3].astype(np.int64)
    f = np.ldexp(1.0, e - 136).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * f[..., None]
    out[e == 0] = 0
    return out


def _scanlines(data: bytes, pos: int, h: int, w: int) -> np.ndarray:
    """(h, w, 4) RGBE bytes, ``RGBE_ReadPixels_RLE``."""
    n = len(data)
    if w < 8 or w > 0x7FFF or not (pos + 4 <= n and data[pos] == 2 and data[pos + 1] == 2
                                   and not data[pos + 2] & 0x80):
        if pos + 4 * w * h > n:
            raise HdrError(f"HDR pixels are {n - pos} bytes, {4 * w * h} expected flat")
        return np.frombuffer(data, np.uint8, 4 * w * h, pos).reshape(h, w, 4)
    out = np.empty((h, 4, w), np.uint8)
    for y in range(h):
        if pos + 4 > n:
            raise HdrError(f"HDR data ends at scanline {y}")
        if data[pos] != 2 or data[pos + 1] != 2 or data[pos + 2] & 0x80:
            # cv2 reads the rest flat from here on
            rest = np.frombuffer(data, np.uint8, 4 * w * (h - y), pos) if pos + 4 * w * (h - y) <= n else None
            if rest is None:
                raise HdrError(f"HDR data ends in the flat pixels after scanline {y}")
            flat = out.transpose(0, 2, 1).copy()
            flat[y:] = rest.reshape(h - y, w, 4)
            return flat
        if (data[pos + 2] << 8 | data[pos + 3]) != w:
            raise HdrError(f"HDR scanline {y} has the wrong width")
        pos += 4
        for c in range(4):
            row = out[y, c]
            x = 0
            while x < w:
                if pos + 2 > n:
                    raise HdrError(f"HDR data ends in scanline {y}")
                count, v = data[pos], data[pos + 1]
                if count > 128:
                    count -= 128
                    if count > w - x:
                        raise HdrError(f"HDR bad scanline data at {y}")
                    row[x:x + count] = v
                    pos += 2
                else:
                    if count == 0 or count > w - x or pos + 1 + count > n:
                        raise HdrError(f"HDR bad scanline data at {y}")
                    row[x:x + count] = np.frombuffer(data, np.uint8, count, pos + 1)
                    pos += 1 + count
                x += count
    return out.transpose(0, 2, 1)


def decode(data: bytes, flags: int) -> np.ndarray:
    h, w, pos = read_header(data)
    img = np.ascontiguousarray(_rgbe_to_float(_scanlines(data, pos, h, w))[..., ::-1])
    if flags == -1:
        return img
    with np.errstate(over="ignore"):
        u8 = cvt_color.saturate_u8(img * np.float32(255))
    return u8 if flags == 1 else cvt_color.cvtcolor_gray(u8)


def _float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """(..., 3) float32 -> (..., 4) uint8, ``float2rgbe``."""
    v = img.max(axis=-1)
    mant, e = np.frexp(v.astype(np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = (mant * 256.0 / v.astype(np.float64)).astype(np.float32)
    out = np.zeros(img.shape[:-1] + (4,), np.uint8)
    ok = v.astype(np.float64) >= 1e-32
    out[..., :3] = np.where(ok[..., None], np.trunc(img * scale[..., None]), 0).astype(np.int64).astype(np.uint8)
    out[..., 3] = np.where(ok, e + 128, 0).astype(np.uint8)
    return out


def _rle_bytes(data: np.ndarray) -> bytes:
    """``RGBE_WriteBytes_RLE`` over one channel of a scanline."""
    d = data.tobytes()
    n, cur, out = len(d), 0, bytearray()
    while cur < n:
        beg = cur
        run = old = 0
        while run < 4 and beg < n:
            beg += run
            old = run
            run = 1
            while beg + run < n and run < 127 and d[beg] == d[beg + run]:
                run += 1
        if old > 1 and old == beg - cur:
            out += bytes([128 + old, d[cur]])
            cur = beg
        while cur < beg:
            k = min(beg - cur, 128)
            out.append(k)
            out += d[cur:cur + k]
            cur += k
        if run >= 4:
            out += bytes([128 + run, d[beg]])
            cur += run
    return bytes(out)


def encode(img: np.ndarray) -> bytes:
    """(H, W) / (H, W, 3) uint8 or float32 -> ``cv2.imencode('.hdr')``'s
    bytes."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = cvt_color.gray_to_bgr(img)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype not in (np.uint8, np.float32):
        raise HdrError(f"HDR is written from 1 or 3 channels of uint8 or float32, got {img.dtype} {img.shape}")
    if img.dtype == np.uint8:
        img = img.astype(np.float32) * np.float32(1 / 255.0)
    h, w = img.shape[:2]
    rgbe = _float_to_rgbe(img[..., ::-1])
    out = bytearray(f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n".encode())
    if w < 8 or w > 0x7FFF:
        return bytes(out) + rgbe.tobytes()
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            out += _rle_bytes(rgbe[y, :, c])
    return bytes(out)
