"""``cv2.warpAffine`` for uint8 images in numpy, bit for bit with cv2 5.0.0
(the rule the JAX package's host loader runs, ``dspnet_tpu/data/augment.py``).

cv2 5.0.0's ``warpAffine`` no longer maps coordinates in fixed point
(``AB_BITS`` 10, ``INTER_BITS`` 5, 15-bit weights, the rule of OpenCV 4.10
and older): its 8-bit ``INTER_LINEAR`` and ``INTER_NEAREST`` paths compute
in float32. Measured against the build the tests run (its AVX2 dispatch,
with IPP on or off: the same pixels), the rule is:

* the 2x3 matrix is inverted in float64 as ``cv::warpAffine`` does
  (:func:`invert_affine`), then rounded to float32 ``m``;
* each row runs a vector loop over whole blocks of :data:`VECTOR_BLOCK`
  pixels, ``x < (W // 16) * 16``, and a scalar loop over the rest. The
  vector loop maps ``sx = fma(x, m0, y * m1 + m2)`` (the row term rounded
  once per product and once per sum); the scalar loop
  ``sx = fma(x, m0, y * m1) + m2``. ``sy`` likewise with ``m3, m4, m5``;
* ``INTER_LINEAR``: ``ix = floor(sx)``, ``a = sx - ix`` (exact), the four
  taps with ``border_value`` for each tap outside the source, then
  ``v0 = fma(a, p01 - p00, p00)``, ``v1 = fma(a, p11 - p10, p10)``,
  ``v = fma(b, v1 - v0, v0)`` and a round half to even, saturated;
* ``INTER_NEAREST``: the tap at ``(rint(sy), rint(sx))`` (half to even), or
  ``border_value`` outside the source.

A fused multiply-add is rounded once (:func:`fma32`, exact in float64
with the double-rounding case corrected), so the pixels do not depend on
this host's compiler. The tests hold this module to ``cv2.warpAffine`` over
many seeded affines and odd sizes, at each border the loaders use.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

#: pixels per iteration of cv2's vector warp loop (2 x 8 float32 lanes, AVX2);
#: the pixels of a row past its last whole block take the scalar loop
VECTOR_BLOCK = 16

_F32 = np.float32


def fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    The product of two float32 values is exact in float64; the float64 sum
    ``s`` and its exact error ``e`` (TwoSum) give the exact result
    ``s + e``. Rounding ``s`` to float32 is then correct unless ``s`` lies
    exactly halfway between two float32 values and ``e`` is not zero, in
    which case the result is the neighbour on ``e``'s side."""
    p = np.asarray(a, _F32).astype(np.float64) * np.asarray(b, _F32).astype(np.float64)
    c = np.asarray(c, _F32).astype(np.float64)
    s = p + c
    bp = s - c
    err = (p - (s - bp)) + (c - bp)
    r = s.astype(_F32)
    d = s - r.astype(np.float64)
    n = np.nextafter(r, np.where(d > 0, _F32(np.inf), _F32(-np.inf)).astype(_F32))
    half = (d != 0) & (np.abs(d) * 2 == np.abs(n.astype(np.float64) - r.astype(np.float64)))
    return np.where(half & (err * d > 0), n, r).astype(_F32)


def invert_affine(M) -> np.ndarray:
    """The inverse of a 2x3 affine as ``cv::warpAffine`` computes it, in
    float64: (6,) ``[a, b, c, d, e, f]`` mapping destination pixels to
    source pixels."""
    m = np.asarray(M, np.float64).reshape(6).copy()
    D = m[0] * m[4] - m[1] * m[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22 = m[4] * D, m[0] * D
    m[0], m[1], m[3], m[4] = a11, m[1] * -D, m[3] * -D, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _source_coords(M, hw: Tuple[int, int]):
    """(H, W) float32 source x and y of every destination pixel, the vector
    loop's formula in whole blocks and the scalar loop's after them."""
    H, W = hw
    m = invert_affine(M).astype(_F32)
    xs = np.broadcast_to(np.arange(W, dtype=_F32)[None, :], (H, W))
    ys = np.arange(H, dtype=_F32)[:, None]
    vector = np.arange(W)[None, :] < (W // VECTOR_BLOCK) * VECTOR_BLOCK
    out = []
    for m0, m1, m2 in ((m[0], m[1], m[2]), (m[3], m[4], m[5])):
        row = ys * m1  # float32 products, one rounding each
        vec = fma32(xs, m0, np.broadcast_to(row + m2, (H, W)))
        tail = fma32(xs, m0, np.broadcast_to(row, (H, W))) + m2
        out.append(np.where(vector, vec, tail))
    return out


def warp_affine(src: np.ndarray, M, dsize: Tuple[int, int], nearest: bool = False,
                border_value: Union[float, Sequence[float]] = 0) -> np.ndarray:
    """``cv2.warpAffine(src, M, dsize, flags=INTER_LINEAR or INTER_NEAREST,
    borderMode=BORDER_CONSTANT, borderValue=border_value)`` for a uint8
    (h, w) or (h, w, C) image; ``dsize`` is (W, H) as in cv2."""
    W, H = dsize
    src = np.asarray(src)
    if src.dtype != np.uint8:
        raise ValueError(f"warp_affine takes uint8 images, got {src.dtype}")
    sh, sw = src.shape[:2]
    img = src.reshape(sh, sw, -1)
    C = img.shape[2]
    border = np.asarray(border_value, _F32).reshape(-1)
    border = np.full(C, border[0], _F32) if border.size == 1 else border[:C]
    sx, sy = _source_coords(M, (H, W))

    def fetch(yi, xi):
        inside = (xi >= 0) & (xi < sw) & (yi >= 0) & (yi < sh)
        v = img[np.clip(yi, 0, sh - 1), np.clip(xi, 0, sw - 1)].astype(_F32)
        return np.where(inside[..., None], v, border)

    if nearest:
        out = fetch(np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))
    else:
        fx, fy = np.floor(sx), np.floor(sy)
        a = (sx - fx)[..., None]
        b = (sy - fy)[..., None]
        ix, iy = fx.astype(np.int64), fy.astype(np.int64)
        p00, p01 = fetch(iy, ix), fetch(iy, ix + 1)
        p10, p11 = fetch(iy + 1, ix), fetch(iy + 1, ix + 1)
        v0 = fma32(a, p01 - p00, p00)
        v1 = fma32(a, p11 - p10, p10)
        out = np.clip(np.rint(fma32(b, v1 - v0, v0)), 0, 255)
    return out.astype(np.uint8).reshape((H, W) + src.shape[2:])


def flip_horizontal(img: np.ndarray) -> np.ndarray:
    """``cv2.flip(img, 1)``: the columns reversed, a contiguous copy."""
    return np.ascontiguousarray(img[:, ::-1])
