"""The colour conversions cv2's image readers apply after decoding
(``modules/imgcodecs/src/utils.cpp`` and ``cvtColor``'s 8- and 16-bit
rules), shared by the still-image codecs of ``data/``.

Gray from colour is cvtColor's 14-bit rule, (4899 R + 9617 G + 1868 B +
8192) >> 14, at 8 and at 16 bits, except from four 8-bit channels, where
cv2's readers use a float32 rule (:func:`bgra_to_gray`); colour from gray repeats the plane; a
palette is looked up, its gray twin computed by the same rule."""

from __future__ import annotations

import numpy as np

#: 0.299, 0.587 and 0.114 at 14 fraction bits, rounded; blue takes the rest
GRAY_R, GRAY_G, GRAY_B = 4899, 9617, 1868


def bgr_to_gray(img: np.ndarray, rgb: bool = False) -> np.ndarray:
    """(..., >= 3) BGR (RGB with ``rgb``) uint8 / uint16 -> (...) gray of
    the same dtype; channels past the third are ignored."""
    b, g, r = (img[..., i].astype(np.int64) for i in ((2, 1, 0) if rgb else (0, 1, 2)))
    return ((GRAY_B * b + GRAY_G * g + GRAY_R * r + 8192) >> 14).astype(img.dtype)


def bgra_to_gray(img: np.ndarray) -> np.ndarray:
    """(..., 4) BGRA uint8 -> gray: cv2's ``icvCvt_BGRA2Gray_8u_C4C1R``, in
    float32, (R * 0.299 + G * 0.587) + B * 0.114 truncated (measured over
    all 2**24 colours; not the 14-bit rule of three channels)."""
    b, g, r = (img[..., i].astype(np.float32) for i in range(3))
    return ((r * np.float32(0.299) + g * np.float32(0.587)) + b * np.float32(0.114)).astype(np.uint8)


def cvtcolor_gray(img: np.ndarray) -> np.ndarray:
    """(..., 3) BGR uint8 -> gray as cv2 5.0.0's ``cvtColor(COLOR_BGR2GRAY)``
    computes it: 15-bit weights, (9798 R + 19235 G + 3735 B + 16384) >> 15
    (measured over all 2**24 colours, IPP on and off), which the readers
    that call cvtColor after decoding (HDR) follow."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    return ((3735 * b + 19235 * g + 9798 * r + 16384) >> 15).astype(np.uint8)


def saturate_u8(x: np.ndarray) -> np.ndarray:
    """float -> uint8 as ``saturate_cast<uchar>`` of ``cvRound``: half to
    even, then clipped; a value past the int range (inf, NaN) rounds to
    INT_MIN and so saturates to 0."""
    r = np.rint(np.asarray(x, np.float64))
    r[~(np.abs(r) < 2.0 ** 31)] = -(2.0 ** 31)
    return np.clip(r, 0, 255).astype(np.uint8)


def gray_to_bgr(img: np.ndarray) -> np.ndarray:
    return np.repeat(img[..., None], 3, axis=-1)


def is_color_palette(palette: np.ndarray) -> bool:
    """(n, 3) BGR entries: cv2's ``IsColorPalette``, any entry not gray."""
    return bool(((palette[:, 0] != palette[:, 1]) | (palette[:, 1] != palette[:, 2])).any())


def gray_palette(bits: int, negative: bool = False) -> np.ndarray:
    """cv2's ``FillGrayPalette``: 2**bits gray BGR entries from 0 to 255."""
    n = 1 << bits
    v = (np.arange(n) * 255 // max(n - 1, 1)) ^ (255 if negative else 0)
    return np.repeat(v.astype(np.uint8)[:, None], 3, axis=1)


def unpack_bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """(H, stride) uint8 rows of packed samples below 8 bits -> (H, width)
    uint8, most significant bits first."""
    per = 8 // depth
    shifts = (np.arange(per)[::-1] * depth).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :width]


#: cvtColor's ``COLOR_YUV2BGR`` weights in 14-bit fixed point: B from U, G
#: from U and V, R from V
YUV2BGR = (33292, -6472, -9519, 18678)


def yuv_to_bgr(img: np.ndarray) -> np.ndarray:
    """(..., 3) Y, U, V uint8 or uint16 -> BGR of the same dtype,
    ``cv2.cvtColor(img, COLOR_YUV2BGR)`` bit for bit: each term rounded at
    14 bits (+8192) and added to Y, then saturated."""
    top = np.iinfo(img.dtype).max
    d = (top + 1) // 2
    y, u, v = (img[..., i].astype(np.int64) for i in range(3))
    cb, cg1, cg2, cr = YUV2BGR
    b = y + (((u - d) * cb + 8192) >> 14)
    g = y + (((u - d) * cg1 + (v - d) * cg2 + 8192) >> 14)
    r = y + (((v - d) * cr + 8192) >> 14)
    return np.clip(np.stack([b, g, r], -1), 0, top).astype(img.dtype)
