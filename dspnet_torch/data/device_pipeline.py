"""On-device augmentation pipeline (counterpart of
``dspnet_tpu/data/device_pipeline.py``).

The device picks where images decode. On ``cuda`` the host threads only read
each sample's encoded bytes (path- or span-backed) and decode its PNG mask;
``prefetch_to_device``'s thread decodes the batch's JPEGs with nvJPEG
(``data/jpeg_cuda.py``) on its side stream into the raw uint8 batch (an image
in another format decodes on the host). On ``cpu`` the host threads decode
everything with the plain codecs (``data/image_io.py``). Either way the raw
uint8 batch lands on the device, and one call does the whole augmentation
there, batched: affine warp (bilinear, border
128) + horizontal flip + BGR->RGB mean-sub for the image; nearest warp
(border 255) + flip + 1/4 nearest downsample + LUT for the seg mask; and the box-corner transform, distance rescale,
area and out-of-image filters and top-compaction of the reference
(iterator.py:485-539) as fixed-shape masked ops over the batch.

The seed-233 parameter table, its order, the batch contract (``pad_last``,
maskless samples filled with 255) and the matrix math are the JAX
package's. The rotation's cosine and sine are taken in float64 and rounded
to float32, so the card and the CPU build the same matrices.

``predownscale`` resizes each image to ``data_shape`` right after its decode
(:func:`resize_area`, on the device on ``cuda``, the same torch ops on the
host on ``cpu``) and each mask with nearest sampling on the host
(``image_io.resize_nearest``), so raw resolutions may differ within a batch. The
JAX package does this with cv2 (``INTER_AREA`` / ``INTER_NEAREST``): masks
and images equal cv2's bit for bit. The JAX package's ``s2d`` (a TPU input
layout) is not ported (ROADMAP Queue A item 17).

:func:`resize` is ``cv2.resize`` for uint8 images with each of cv2's five
interpolations (nearest, bilinear, bicubic, area, Lanczos4), on the
tensor's device, cv2's fixed-point and float32 rules step by step; the
plain-SSD loader (``data/det_iterator.py``) draws one per image.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from dspnet_torch.data import augment as aug
from dspnet_torch.data import av1_cuda, avif, heif, image_io, jpeg, jpeg2000, jpeg2000_cuda, jpeg_cuda
from dspnet_torch.data.cs_labels import seg_label_lut
from dspnet_torch.data.iterator import SampleIndex, load_sample_arrays, load_sample_bytes, shard_positions
from dspnet_torch.data.prefetch import prefetch_to_device


#: cv2's interpolation codes (``cv2.INTER_*``), the values DetIterator draws
INTER_NEAREST, INTER_LINEAR, INTER_CUBIC, INTER_AREA, INTER_LANCZOS4 = 0, 1, 2, 3, 4
#: cv2's fixed-point weight scale for 8-bit resizes (``INTER_RESIZE_COEF_SCALE``)
_COEF = 2048
#: uint8 lanes of the SSE vertical cubic pass of the cv2 build the tests hold
#: this to; the last (W * C) % 8 values of each row take the integer rule
_CUBIC_LANES = 8


def _as_batch(images: torch.Tensor):
    return images if images.ndim == 4 else images[None]


def _area_tab(src: int, dst: int):
    """cv2's ``computeResizeAreaTab``: for each output, the source cells its
    interval [d * s, (d + 1) * s) covers (s = 1 / (dst / src)) and their
    float32 weights, partial cells by their covered fraction, in source
    order. Returns (dst, T) indices and weights, padded with weight 0."""
    scale = 1.0 / (dst / src)
    rows = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        width = min(scale, src - f1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / width))
        taps += [(s, 1.0 / width) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), width) / width))
        rows.append(taps)
    T = max(len(t) for t in rows)
    idx = np.zeros((dst, T), np.int64)
    alpha = np.zeros((dst, T), np.float32)
    for d, taps in enumerate(rows):
        for t, (s, a) in enumerate(taps):
            idx[d, t], alpha[d, t] = s, np.float32(a)
    return idx, alpha


def resize_area(images: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(..., h, w, C) uint8 -> (..., H, W, C) uint8, ``cv2.resize(...,
    INTER_AREA)`` bit for bit, on the tensor's device.

    cv2 has three rules. At integer factors on both axes each output is its
    fy x fx box's integer sum, rounded as ``(sum + 2) >> 2`` at 2 x 2 and as
    ``cvRound(float32(sum) * float32(1 / area))`` (half to even) at other
    factors. Other downscales (both factors >= 1) take the fractional-area
    table (:func:`_area_tab`): float32 sums in source order, one row at a
    time (``buf += S * alpha``), then over rows (``sum += beta * buf``),
    rounded half to even. Any upscale takes cv2's linear machinery with area
    coefficients (:func:`_area_linear_taps`)."""
    H, W = int(hw[0]), int(hw[1])
    x = _as_batch(images)
    B, h, w, C = x.shape
    if (h, w) == (H, W):
        return images
    if h < H or w < W:
        out = _two_tap_resize(x, _area_linear_taps(w, W, True), _area_linear_taps(h, H, False))
    elif h % H == 0 and w % W == 0:
        fy, fx = h // H, w // W
        s = x.reshape(B, H, fy, W, fx, C).sum(dim=(2, 4), dtype=torch.int32)
        if (fy, fx) == (2, 2):
            out = ((s + 2) >> 2).to(torch.uint8)
        else:
            out = (s.float() * float(np.float32(1.0) / np.float32(fy * fx))).round().clamp(0, 255)
            out = out.to(torch.uint8)
    else:
        dev = x.device
        xi, xa = (torch.from_numpy(t).to(dev) for t in _area_tab(w, W))
        yi, ya = (torch.from_numpy(t).to(dev) for t in _area_tab(h, H))
        xf = x.float()
        buf = xf[:, :, xi[:, 0]] * xa[:, 0, None]  # (B, h, W, C)
        for t in range(1, xi.shape[1]):
            buf = buf + xf[:, :, xi[:, t]] * xa[:, t, None]
        acc = buf[:, yi[:, 0]] * ya[:, 0, None, None]  # (B, H, W, C)
        for t in range(1, yi.shape[1]):
            acc = acc + buf[:, yi[:, t]] * ya[:, t, None, None]
        out = acc.round().clamp(0, 255).to(torch.uint8)
    return out if images.ndim == 4 else out[0]


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """cv2's ``INTER_LINEAR`` taps along one axis (``resize.cpp``,
    ``computeResizeLinear`` with fixed-point coefficients): for output d,
    f = float32((d + 0.5) * src / dst - 0.5), the taps floor(f) and
    floor(f) + 1 clamped into the image, the weights (1 - frac, frac) times
    2048 rounded to the nearest (even) integer. Along x (``clamp_weights``)
    a tap outside the image also moves the weight onto the edge sample, as
    cv2's horizontal pass does; along y only the rows are clamped."""
    f = ((np.arange(dst) + 0.5) * (np.float64(src) / dst) - 0.5).astype(np.float32)
    s0 = np.floor(f).astype(np.int64)
    frac = (f - s0.astype(np.float32)).astype(np.float32)
    return _two_taps(s0, frac, src, clamp_weights)


def _two_taps(s0, frac, src: int, clamp_weights: bool):
    if clamp_weights:
        out = (s0 < 0) | (s0 >= src - 1)
        frac = np.where(out, np.float32(0), frac)
        s0 = np.clip(s0, 0, src - 1)
    w0 = np.rint((np.float32(1) - frac) * np.float32(_COEF)).astype(np.int32)
    w1 = np.rint(frac * np.float32(_COEF)).astype(np.int32)
    return np.clip(s0, 0, src - 1), np.clip(s0 + 1, 0, src - 1), w0, w1


def _area_linear_taps(src: int, dst: int, clamp_weights: bool):
    """The taps of cv2's ``INTER_AREA`` when it upscales an axis (its
    linear machinery with area coefficients): s = floor(d * src / dst),
    frac = float32((d + 1) - (s + 1) * dst / src), 0 if <= 0, else its
    fractional part; then as :func:`_linear_taps`."""
    inv = dst / src
    s0 = np.floor(np.arange(dst) * (1.0 / inv)).astype(np.int64)
    f = ((np.arange(dst) + 1) - (s0 + 1) * inv).astype(np.float32)
    frac = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    return _two_taps(s0, frac, src, clamp_weights)


def _two_tap_resize(x: torch.Tensor, xtaps, ytaps) -> torch.Tensor:
    """cv2's 8-bit two-tap pass pair: a horizontal pass with 11-bit weights
    into int32 sums, then a vertical pass ``((b0 * (S0 >> 4)) >> 16 + (b1 *
    (S1 >> 4)) >> 16 + 2) >> 2`` (``VResizeLinearVec_32s8u``)."""
    dev = x.device
    x0, x1, a0, a1 = (torch.from_numpy(t).to(dev) for t in xtaps)
    y0, y1, b0, b1 = (torch.from_numpy(t).to(dev) for t in ytaps)
    xi = x.to(torch.int32)
    rows = (xi[:, :, x0] * a0[:, None] + xi[:, :, x1] * a1[:, None]) >> 4  # (B, h, W, C)
    out = (((b0[:, None, None] * rows[:, y0]) >> 16) + ((b1[:, None, None] * rows[:, y1]) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


def resize_linear(images: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(..., h, w, C) uint8 -> (..., H, W, C) uint8 bilinear resize on the
    tensor's device, equal to ``cv2.resize(..., INTER_LINEAR)`` bit for bit
    (the JAX ``Detector``'s resize, ``dspnet_tpu/detect/detector.py:156,
    213``). cv2 resizes uint8 in fixed point: a horizontal pass with 11-bit
    weights into int32 sums, then a vertical pass ``((b0 * (S0 >> 4)) >> 16 +
    (b1 * (S1 >> 4)) >> 16 + 2) >> 2``; integer tensor ops here do the same.
    An exact 2x downscale is cv2's ``INTER_AREA`` (cv2 switches to it, and
    the two rules give the same pixels there): :func:`resize_area`."""
    H, W = int(hw[0]), int(hw[1])
    x = _as_batch(images)
    h, w = x.shape[1:3]
    if (h, w) == (H, W):
        return images
    if (h, w) == (2 * H, 2 * W):
        return resize_area(images, (H, W))
    out = _two_tap_resize(x, _linear_taps(w, W, True), _linear_taps(h, H, False))
    return out if images.ndim == 4 else out[0]


def resize_nearest(images: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(..., h, w, C) -> (..., H, W, C), ``cv2.resize(..., INTER_NEAREST)``
    bit for bit (``image_io.nearest_index``), on the tensor's device."""
    H, W = int(hw[0]), int(hw[1])
    h, w = images.shape[-3:-1]
    dev = images.device
    ys = torch.from_numpy(image_io.nearest_index(h, H)).to(dev)
    xs = torch.from_numpy(image_io.nearest_index(w, W)).to(dev)
    return images[..., ys[:, None], xs[None, :], :]


def _cubic_coefs(x: np.ndarray) -> np.ndarray:
    """cv2's ``interpolateCubic`` (A = -0.75) in float32, (n, 4)."""
    f = np.float32
    x = x.astype(f)
    A, one = f(-0.75), f(1)
    c0 = ((A * (x + one) - f(5) * A) * (x + one) + f(8) * A) * (x + one) - f(4) * A
    c1 = ((A + f(2)) * x - (A + f(3))) * x * x + one
    y = one - x
    c2 = ((A + f(2)) * y - (A + f(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], -1).astype(f)


_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0), (_S45, _S45), (0, -1), (-_S45, _S45))


def _lanczos4_coefs(x: np.ndarray) -> np.ndarray:
    """cv2's ``interpolateLanczos4``, (n, 8): the windowed sinc in float64
    (Python's libm sin/cos, as cv2's), each tap rounded to float32, summed
    and normalised in float32."""
    f = np.float32
    out = np.zeros((len(x), 8), f)
    for n, xv in enumerate(x.astype(f)):
        x3 = f(xv + f(3))
        y0 = -float(x3) * np.pi * 0.25
        s0, c0 = math.sin(y0), math.cos(y0)
        total = f(0)
        for i in range(8):
            yi = f(x3 - f(i))
            if abs(yi) >= 1e-6:
                y = -float(yi) * np.pi * 0.25
                out[n, i] = f((_LANCZOS_CS[i][0] * s0 + _LANCZOS_CS[i][1] * c0) / (y * y))
            else:
                out[n, i] = f(1e30)
            total = f(total + out[n, i])
        out[n] = out[n] * (f(1) / total)
    return out


def _kernel_taps(src: int, dst: int, interp: int):
    """(dst, k) clamped source indices and 11-bit weights of cv2's cubic
    (k = 4) or Lanczos4 (k = 8) taps: f = float32((d + 0.5) / (dst / src) -
    0.5), taps floor(f) - k/2 + 1 ... floor(f) + k/2 (the border replicated),
    weights ``cvRound(coef * 2048)`` of the fraction."""
    f = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    frac = (f - s.astype(np.float32)).astype(np.float32)
    coef = _cubic_coefs(frac) if interp == INTER_CUBIC else _lanczos4_coefs(frac)
    k = coef.shape[1]
    idx = np.clip(s[:, None] + np.arange(k)[None] - (k // 2 - 1), 0, src - 1)
    return idx, np.rint(coef * np.float32(_COEF)).astype(np.int32)


def _resize_kernel(x: torch.Tensor, H: int, W: int, interp: int) -> torch.Tensor:
    """cv2's 8-bit cubic / Lanczos4 resize: a horizontal pass with 11-bit
    weights into int32 sums, then the vertical pass. Lanczos4's vertical
    pass is integer, ``(sum b * S + 2^21) >> 22``. Cubic's runs in float32
    in cv2's SIMD order (``S3 * b3 + S2 * b2 + S1 * b1 + S0 * b0``, each
    product and sum rounded, b = float32(beta / 2^22)) and rounds half to
    even, except the last (W * C) % 8 values of each row, which take the
    integer rule."""
    B, h, w, C = x.shape
    dev = x.device
    xi, xw = (torch.from_numpy(t).to(dev) for t in _kernel_taps(w, W, interp))
    yi, yw = (torch.from_numpy(t).to(dev) for t in _kernel_taps(h, H, interp))
    xs = x.to(torch.int32)
    rows = xs[:, :, xi[:, 0]] * xw[:, 0, None]
    for k in range(1, xi.shape[1]):
        rows = rows + xs[:, :, xi[:, k]] * xw[:, k, None]  # (B, h, W, C) int32
    taps = [rows[:, yi[:, k]] for k in range(yi.shape[1])]  # (B, H, W, C) each
    acc = taps[0].long() * yw[:, 0, None, None]
    for k in range(1, len(taps)):
        acc = acc + taps[k].long() * yw[:, k, None, None]
    out = ((acc + (1 << 21)) >> 22).clamp(0, 255)
    if interp == INTER_CUBIC:
        b = yw.float() * float(np.float32(1.0 / (_COEF * _COEF)))  # (H, 4), exact
        f = taps[3].float() * b[:, 3, None, None]
        for k in (2, 1, 0):
            f = f + taps[k].float() * b[:, k, None, None]
        f = f.round().clamp(0, 255)
        n = (W * C) // _CUBIC_LANES * _CUBIC_LANES
        simd = (torch.arange(W * C, device=dev) < n).reshape(W, C)
        out = torch.where(simd, f.long(), out)
    return out.to(torch.uint8)


def resize(images: torch.Tensor, hw: Tuple[int, int], interp: int = INTER_LINEAR) -> torch.Tensor:
    """(..., h, w, C) uint8 -> (..., H, W, C) uint8 on the tensor's device,
    ``cv2.resize(images, (W, H), interpolation=interp)`` for uint8 images:
    bit for bit with cv2 for every code, except that cv2 on x86 hands
    ``INTER_CUBIC`` to Intel IPP where it is built in (``cv2.ipp.useIPP()``),
    whose pixels differ from cv2's own rule (this one) by at most one level
    on about 1% of the values."""
    H, W = int(hw[0]), int(hw[1])
    if interp == INTER_LINEAR:
        return resize_linear(images, (H, W))
    if interp == INTER_AREA:
        return resize_area(images, (H, W))
    if interp == INTER_NEAREST:
        return resize_nearest(images, (H, W))
    if interp not in (INTER_CUBIC, INTER_LANCZOS4):
        raise ValueError(f"unknown interpolation code {interp}")
    x = _as_batch(images)
    if tuple(x.shape[1:3]) == (H, W):
        return images
    out = _resize_kernel(x, H, W, interp)
    return out if images.ndim == 4 else out[0]


def place_images(items, device) -> List[torch.Tensor]:
    """JPEG, JPEG 2000 or AVIF bytes or uint8 BGR arrays -> one (H_i, W_i,
    3) uint8 tensor each on ``device``: the JPEGs decoded there in one call
    (nvJPEG on CUDA, the plain decoder on the CPU), the JPEG 2000 files by
    the kernels of ``data/jpeg2000_cuda.py`` and the AVIF files by those of
    ``data/av1_cuda.py`` (their plain versions on the CPU), the arrays
    copied (through pinned memory on CUDA)."""
    device = torch.device(device)
    out: List[Optional[torch.Tensor]] = [None] * len(items)
    encoded = [i for i, x in enumerate(items)
               if isinstance(x, bytes) and not jpeg2000.is_jpeg2000(x) and not heif.is_avif(x)]
    if encoded:
        for i, t in zip(encoded, jpeg_cuda.decode_images([items[i] for i in encoded], device)):
            out[i] = t
    for i, x in enumerate(items):
        if isinstance(x, bytes) and jpeg2000.is_jpeg2000(x):
            out[i] = jpeg2000_cuda.decode(x, jpeg2000.IMREAD_COLOR, device)
        elif isinstance(x, bytes) and heif.is_avif(x):
            out[i] = av1_cuda.decode(x, avif.IMREAD_COLOR, device)
    for i, x in enumerate(items):
        if out[i] is None:
            t = torch.from_numpy(x)
            out[i] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
    return out


class EncodedImages:
    """A batch's images as the host threads left them: JPEG bytes, decoded
    on the device by nvJPEG when the batch is placed there (on
    ``prefetch_to_device``'s side stream), or uint8 arrays the host decoded.
    ``resize_to``: the predownscale target, applied after the decode."""

    def __init__(self, items, resize_to: Optional[Tuple[int, int]] = None):
        self.items = list(items)
        self.resize_to = resize_to

    def place_on(self, device) -> torch.Tensor:
        """(B, H, W, 3) uint8 BGR on ``device``."""
        out = place_images(self.items, device)
        if self.resize_to is not None:
            out = [resize_area(t, self.resize_to) for t in out]
        return torch.stack(out)


def _filter_and_compact(label: torch.Tensor, data_shape, out_of_image: bool) -> torch.Tensor:
    """(B, L, 6) labels: clear degenerate rows to -1, survivors to the top in
    their order (iterator.py:522-539)."""
    H, W = data_shape
    xmin, ymin, xmax, ymax = label[..., 1], label[..., 2], label[..., 3], label[..., 4]
    area = (xmax - xmin) * W * (ymax - ymin) * H
    bad = (label[..., 0] < 0) | (area < 100.0)
    if out_of_image:
        bad |= (xmax < 0.01) | (xmin > 0.99) | (ymax < 0.01) | (ymin > 0.99)
    label = torch.where(bad[..., None], -1.0, label)
    order = torch.argsort(bad.to(torch.uint8), dim=1, stable=True)
    return torch.gather(label, 1, order[..., None].expand_as(label))


def _cos_sin(theta: torch.Tensor):
    return torch.cos(theta.double()).float(), torch.sin(theta.double()).float()


def _augment_boxes(label: torch.Tensor, params: torch.Tensor, data_shape) -> torch.Tensor:
    """The box path of the reference (iterator.py:485-539), batched: (B, L, 6)
    labels, (B, 6) params."""
    H, W = data_shape
    flip, theta, sx, sy, tx, ty = (params[:, i:i + 1] for i in range(6))
    valid = label[..., 0] >= 0
    ca, sa = _cos_sin(theta)

    def tf(x, y):
        return sx * ca * x - sy * sa * y + tx, sx * sa * x + sy * ca * y + ty

    x1, y1 = tf(label[..., 1] * W, label[..., 2] * H)
    x2, y2 = tf(label[..., 3] * W, label[..., 4] * H)
    do_flip = flip > 0.5
    x1f = torch.where(do_flip, W - x1, x1)
    x2f = torch.where(do_flip, W - x2, x2)
    # flip mirrors corners, then xmin/xmax swap (augment.py:102-108)
    nx1 = torch.where(do_flip, x2f, x1f)
    nx2 = torch.where(do_flip, x1f, x2f)
    box = torch.stack([nx1 / W, y1 / H, nx2 / W, y2 / H], dim=-1).clamp(0.0, 1.0)
    dist = label[..., 5] / torch.sqrt(sx * sy)
    new = torch.cat([label[..., :1], box, dist[..., None]], dim=-1)
    label = torch.where(valid[..., None], new, label)
    return _filter_and_compact(label, data_shape, out_of_image=True)


@torch.no_grad()
def device_augment_batch(
    raw_images: torch.Tensor,  # (B, hh, ww, 3) uint8 BGR
    raw_segs: Optional[torch.Tensor],  # (B, hh, ww) uint8 or None
    labels: torch.Tensor,  # (B, 200, 6) f32
    params: torch.Tensor,  # (B, 6) f32 [flip, theta, sx, sy, tx, ty]
    lut: torch.Tensor,  # (256,) int32
    data_shape: Tuple[int, int],
    enable_aug: bool = True,
    mean_pixels=aug.MEAN_PIXELS,
) -> dict:
    """One augmented batch on the inputs' device: ``images`` (B, H, W, 3) f32
    RGB mean-subtracted, ``seg_label`` (B, H/4, W/4) int32 (when ``raw_segs``
    is given) and ``label_det`` (B, 200, 6) f32. Without ``enable_aug`` the
    warp is a plain resize (border 0) and boxes are only filtered.

    ``mean_pixels``: RGB, a tuple or a float32 tensor on the device. Every
    other constant enters as a Python scalar: a small tensor made from host
    values would be a blocking copy, which on CUDA waits for the stream
    (and so for the train step queued ahead of this batch)."""
    H, W = data_shape
    B, hh, ww = raw_images.shape[:3]
    dev = raw_images.device
    if not enable_aug:
        params = torch.zeros(B, 6, device=dev)
        params[:, 2:4] = 1.0  # identity: [0, 0, 1, 1, 0, 0]
    params = params.to(dev, torch.float32)
    flip, theta = params[:, 0], params[:, 1]
    sx, sy, tx, ty = params[:, 2], params[:, 3], params[:, 4], params[:, 5]
    sx2, sy2 = sx * (W / float(ww)), sy * (H / float(hh))
    ca, sa = _cos_sin(theta)
    M = torch.stack([
        torch.stack([sx2 * ca, -sy2 * sa, tx], dim=-1),
        torch.stack([sx2 * sa, sy2 * ca, ty], dim=-1),
    ], dim=1)  # (B, 2, 3)

    border = 128.0 if enable_aug else 0.0
    img = aug.warp_affine_batch(raw_images, M, (H, W), border)
    do_flip = (flip > 0.5) & enable_aug
    img = torch.where(do_flip[:, None, None, None], img.flip(2), img)
    img = img.flip(-1) - torch.as_tensor(mean_pixels, dtype=torch.float32, device=dev)  # BGR->RGB

    out = {"images": img}
    if raw_segs is not None:
        seg_border = 255.0 if enable_aug else 0.0
        seg = aug.warp_affine_batch(raw_segs, M, (H, W), seg_border, nearest=True)
        seg = torch.where(do_flip[:, None, None], seg.flip(2), seg)
        seg = seg[:, ::4, ::4].long()  # nearest 1/4 (src = dst*4)
        out["seg_label"] = lut.to(dev)[seg.clamp(0, 255)]

    labels = labels.to(dev, torch.float32)
    if enable_aug:
        out["label_det"] = _augment_boxes(labels, params, (H, W))
    else:
        out["label_det"] = _filter_and_compact(labels, (H, W), out_of_image=False)
    return out


class DeviceAugIterator:
    """Batches of ``{'images', 'label_det', 'seg_label'}`` (+ filenames),
    augmented on ``device``.

    Host worker threads read the samples (on ``cuda`` the JPEG bytes and the
    decoded masks, on ``cpu`` decoded images and masks),
    ``prefetch_to_device`` makes each raw batch on ``device`` (decoding its
    JPEGs there on ``cuda``), and the consumer's thread runs
    :func:`device_augment_batch`. All images must share one raw resolution,
    checked on the host from each JPEG's frame header, unless
    ``predownscale`` resizes them to ``data_shape`` first. ``device`` and
    ``seed`` are explicit: the batches land where the caller computes, and
    the seed fixes the epoch's order and augmentation table (233 in the
    reference).
    """

    def __init__(
        self,
        index: SampleIndex,
        batch_size: int,
        data_shape: Tuple[int, int],
        *,
        device,
        seed: int,
        enable_aug: bool = True,
        shuffle: bool = True,
        shard: Tuple[int, int] = (0, 1),
        num_threads: int = 4,
        pad_last: bool = False,
        predownscale: bool = False,
    ):
        """``pad_last``: also yield a final partial batch, padded to
        ``batch_size`` by repeating its last sample, with ``fnames`` listing
        only the real samples (consumers slice outputs by ``len(fnames)``);
        eval passes True, training False. ``predownscale``: resize every
        image and mask to ``data_shape`` right after its decode (see the
        module docstring)."""
        self.index = index
        self.predownscale = predownscale
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.device = torch.device(device)
        self.pad_last = pad_last
        # made on the device once: a per-batch copy from the host would wait
        # for the stream (see device_augment_batch)
        self.mean_pixels = torch.tensor(aug.MEAN_PIXELS, device=self.device)
        self.enable_aug = enable_aug
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.lut = torch.from_numpy(seg_label_lut().astype(np.int32)).to(self.device)
        self.num_samples = len(index)
        self.positions = shard_positions(self.num_samples, shard)
        self.order = np.arange(self.num_samples)
        if shuffle:
            self.rng.shuffle(self.order)
        self._resample_aug()
        self.cursor = 0
        self.num_threads = num_threads
        self.prefetch = 3  # raw batches decoded and copied ahead of the augmentation
        self.raw_hw: Optional[Tuple[int, int]] = None
        self._hw_lock = threading.Lock()

    def _resample_aug(self):
        self.aug_params = aug.sample_aug_params(self.num_samples, self.data_shape, self.rng)

    def reset(self):
        if self.shuffle:
            self.rng.shuffle(self.order)
        self._resample_aug()
        self.cursor = 0

    # ------------------------------------------------------------- host side

    def _load_raw(self, pos: int):
        """(image, label, mask, name) of one sample: the image as JPEG bytes
        when the device decodes it, else a uint8 BGR array."""
        sample = self.index[int(self.order[pos])]
        if self.device.type == "cuda":
            img, seg = load_sample_bytes(sample)
            if img[:3] == image_io.JPEG_MAGIC:
                hw = jpeg.read_header(img)[:2]
            elif jpeg2000.is_jpeg2000(img):  # decoded on the card by jpeg2000_cuda
                hw = jpeg2000.image_size(img)
            elif heif.is_avif(img):  # decoded on the card by av1_cuda
                hw = avif.image_size(img)
            else:
                img = image_io.imdecode(img, image_io.IMREAD_COLOR)
                hw = img.shape[:2]
        else:
            img, seg = load_sample_arrays(sample)
            hw = img.shape[:2]
        if self.predownscale:
            if seg is not None and seg.shape[:2] != self.data_shape:
                seg = image_io.resize_nearest(seg, self.data_shape)
            hw = self.data_shape  # every image is resized after its decode
        with self._hw_lock:
            if self.raw_hw is None:
                self.raw_hw = tuple(hw)
        if tuple(hw) != self.raw_hw:
            raise ValueError(
                f"mixed raw resolutions {tuple(hw)} vs {self.raw_hw}; on-device augmentation "
                "batches raw images: resize the dataset offline or pass predownscale=True")
        return img, sample.label, seg, sample.image_path

    def _raw_batches(self) -> Iterator:
        from concurrent.futures import ThreadPoolExecutor

        bs = self.batch_size
        n = len(self.positions)
        starts = list(range(0, n - bs + 1, bs))
        if self.pad_last and n % bs:
            starts.append((n // bs) * bs)  # padded tail
        with ThreadPoolExecutor(self.num_threads) as pool:
            for start in starts:
                poss = self.positions[start:start + bs]
                decoded = list(pool.map(lambda p: self._load_raw(int(p)), poss))
                n_real = len(decoded)
                # pad the tail by repeating the last decoded sample: consumers
                # keep only the real rows (len(fnames)), so the padded content
                # is never read, and repetition keeps one raw shape
                decoded.extend([decoded[-1]] * (bs - n_real))
                params = np.concatenate(
                    [self.aug_params[poss], np.repeat(self.aug_params[poss[-1:]], bs - n_real, axis=0)])
                segs = [d[2] for d in decoded]
                seg_arr = None
                if any(s is not None for s in segs):
                    hw = next(s.shape for s in segs if s is not None)
                    # maskless samples fill with 255 (ignore), not 0 (road)
                    seg_arr = np.stack([s if s is not None else np.full(hw, 255, np.uint8)
                                        for s in segs]).astype(np.uint8)
                imgs = [d[0] for d in decoded]
                if self.predownscale or any(isinstance(x, bytes) for x in imgs):
                    raw = EncodedImages(imgs, self.data_shape if self.predownscale else None)
                else:
                    raw = np.stack(imgs)
                yield {
                    "raw": raw,
                    "segs": seg_arr,
                    "labels": np.stack([d[1] for d in decoded]).astype(np.float32),
                    "params": params.astype(np.float32),
                    "names": [d[3] for d in decoded[:n_real]],
                }

    # ----------------------------------------------------------- device side

    def epoch(self) -> Iterator:
        """(batch, fnames) pairs. Decode runs ahead on ``prefetch_to_device``'s
        thread, which also copies each raw batch to the device (pinned memory,
        a side stream on CUDA); the augmentation runs on the consumer's stream."""
        self.reset()
        yield from self.batches()

    def batches(self) -> Iterator:
        """(batch, fnames) pairs over the current epoch's tables, without
        a :meth:`reset` (``data/native_loader.py`` starts its first epoch on
        the tables drawn at construction, as the JAX native loader does)."""
        # closing: an abandoned epoch releases the decode thread at once
        with contextlib.closing(prefetch_to_device(self._raw_batches(), size=self.prefetch, device=self.device)) as raw:
            for item in raw:
                batch = device_augment_batch(
                    item["raw"], item["segs"], item["labels"], item["params"], self.lut,
                    self.data_shape, enable_aug=self.enable_aug, mean_pixels=self.mean_pixels)
                yield batch, item["names"]

    def __iter__(self):
        for batch, _ in self.epoch():
            yield batch
