"""Sun raster images without cv2: the reader and writer of cv2 5.0.0's
``grfmt_sunras.cpp``, pixel for pixel (measured in
``tests/test_torch_image_formats.py``).

Read: 1, 8, 24 and 32 bits a pixel in ``RT_OLD`` / ``RT_STANDARD`` files
(raw rows padded to 16 bits), with ``RMT_EQUAL_RGB`` colour maps (a map
whose entries are all gray makes a one-channel image). cv2 5.0.0 returns
None for ``RT_BYTE_ENCODED`` (RLE) and ``RT_FORMAT_RGB`` files, so they are
refused by name. Without a map, 1-bit pixels are 0 -> 0 and 1 -> 255 in
colour (cv2's gray palette, not Sun's convention) and 8-bit ones gray; read
as one channel (``IMREAD_GRAYSCALE``, or ``IMREAD_UNCHANGED`` of such a
file) they are all 0, as cv2 looks them up in a gray table it fills only
from a map. 32-bit pixels are XBGR: the first byte is dropped. Gray from
colour is cvtColor's 14-bit rule, and a map entry's gray the same rule.

Write: what ``cv2.imencode('.sr')`` writes: ``RT_STANDARD`` with no map, the
array's own bytes (BGR, BGRA or gray) at 8 bits a channel, each row padded
to an even length with the first byte of the next row (0 after the last),
as cv2 copies a row's padded length from the image buffer.
"""

from __future__ import annotations

import struct

import numpy as np

from dspnet_torch.data import cvt_color

MAGIC = b"\x59\xa6\x6a\x95"
RT_OLD, RT_STANDARD, RT_BYTE_ENCODED, RT_FORMAT_RGB = 0, 1, 2, 3
RMT_NONE, RMT_EQUAL_RGB = 0, 1


class SunRasterError(ValueError):
    pass


def decode(data: bytes, flags: int) -> np.ndarray:
    if data[:4] != MAGIC or len(data) < 32:
        raise SunRasterError("not a Sun raster file")
    w, h, bpp, _length, kind, maptype, maplength = struct.unpack_from(">iiiiiii", data, 4)
    if w <= 0 or h <= 0 or bpp not in (1, 8, 24, 32):
        raise SunRasterError(f"Sun raster {w}x{h} at {bpp} bits is not one cv2 reads")
    pal_size = (1 << bpp) * 3 if bpp <= 8 else 0
    if kind in (RT_BYTE_ENCODED, RT_FORMAT_RGB):
        raise SunRasterError(f"Sun raster {('RT_BYTE_ENCODED', 'RT_FORMAT_RGB')[kind - 2]} files: cv2 5.0.0 "
                             "returns None for them")
    if kind not in (RT_OLD, RT_STANDARD) or not (
            (maptype == RMT_NONE and maplength == 0)
            or (maptype == RMT_EQUAL_RGB and 0 < maplength <= pal_size and bpp <= 8)):
        raise SunRasterError(f"Sun raster type {kind} with map type {maptype} of {maplength} bytes "
                             "is not one cv2 reads")
    palette = None
    if maplength:
        n = maplength // 3
        m = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)  # R plane, G plane, B plane
        palette = np.zeros((256, 3), np.uint8)
        palette[:n] = m[::-1].T
        channels = 3 if cvt_color.is_color_palette(palette[:1 << bpp]) else 1
    else:
        channels = 3 if bpp > 8 else 1
    out_ch = channels if flags == -1 else (3 if flags == 1 else 1)
    pitch = ((w * bpp + 7) // 8 + 1) & -2
    start = 32 + maplength
    if start + pitch * h > len(data):
        raise SunRasterError(f"Sun raster data is {len(data) - start} bytes, {pitch * h} expected")
    rows = np.frombuffer(data, np.uint8, pitch * h, start).reshape(h, pitch)
    if bpp <= 8:
        idx = rows[:, :w] if bpp == 8 else cvt_color.unpack_bits(rows, w, 1)
        if palette is None:  # cv2's gray table is left all zero without a map
            if out_ch == 1:
                return np.zeros((h, w), np.uint8)
            return cvt_color.gray_to_bgr(idx if bpp == 8 else idx * np.uint8(255))
        bgr = palette[idx]
        return bgr if out_ch == 3 else cvt_color.bgr_to_gray(bgr)
    px = rows[:, :w * (bpp // 8)].reshape(h, w, bpp // 8)
    if bpp == 32:  # XBGR: the first byte of each pixel is padding
        px = px[..., 1:]
    return np.ascontiguousarray(px) if out_ch == 3 else cvt_color.bgr_to_gray(px)


def encode(img: np.ndarray) -> bytes:
    """(H, W) / (H, W, 3) / (H, W, 4) uint8 -> ``cv2.imencode('.sr')``'s
    bytes."""
    img = np.asarray(img)
    channels = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype != np.uint8 or channels not in (1, 3, 4):
        raise SunRasterError(f"Sun raster holds uint8 gray, BGR or BGRA, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    row = w * channels
    step = (row + 1) & -2
    flat = np.concatenate([np.ascontiguousarray(img).reshape(-1), np.zeros(step - row + 1, np.uint8)])
    body = b"".join(flat[y * row:y * row + step].tobytes() for y in range(h))
    return MAGIC + struct.pack(">iiiiiii", w, h, channels * 8, step * h, RT_STANDARD, RMT_NONE, 0) + body
