"""Deterministic multitask augmentation (counterpart of
``dspnet_tpu/data/augment.py``).

The parameter table and the box filter are numpy copies of the JAX
package's (bit for bit on the same seed): per epoch one row per sample,
numpy seed 233 at startup (reference iterator.py:381, 417-424): flip p=.5,
rotation +-5 deg, x-scale U(0.5, 2), y-scale = x-scale * U(0.8, 1.2), a
translation that keeps the scaled image over the canvas.

:func:`warp_affine_batch` is the torch form of ``warp_affine_batch_jax``:
one inverse-mapped affine warp per image, bilinear or nearest, constant
border, on the tensor's device. The host path of the JAX package
(``cv2.warpAffine``) is not ported (ROADMAP Queue A item 20).

The plain-SSD loader's colour jitter (:func:`color_jitter`) and
:func:`normalize_image` run on the tensor's device too, with cv2's 8-bit
``BGR2HSV`` / ``HSV2BGR`` / ``BGR2GRAY`` rules in torch ops
(:func:`bgr_to_hsv`, :func:`hsv_to_bgr`, :func:`bgr_to_gray`), equal to
cv2's conversions over every input value.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

MEAN_PIXELS = (123.68, 116.779, 103.939)  # RGB (iterator.py:340)


def sample_aug_params(num_samples: int, data_shape: Tuple[int, int], rng: np.random.RandomState) -> np.ndarray:
    """(N, 6) rows [flip, theta, sx, sy, tx, ty] — iterator.py:417-424."""
    H, W = data_shape
    p = np.zeros((num_samples, 6))
    p[:, 0] = rng.rand(num_samples) > 0.5
    p[:, 1] = np.radians(-5 + rng.rand(num_samples) * 10)
    p[:, 2] = 0.5 + rng.rand(num_samples) * 1.5
    p[:, 3] = p[:, 2] * (0.8 + rng.rand(num_samples) * 0.4)
    p[:, 4] = -(rng.rand(num_samples)) * W * (p[:, 2] - 1.0)
    p[:, 5] = -(rng.rand(num_samples)) * H * (p[:, 3] - 1.0)
    return p


def _filter_and_compact(label: np.ndarray, data_shape: Tuple[int, int], out_of_image: bool) -> np.ndarray:
    """Clear degenerate rows to -1 and move survivors to the top (in place)."""
    H, W = data_shape
    xmin, ymin, xmax, ymax = label[:, 1], label[:, 2], label[:, 3], label[:, 4]
    areas = (xmax - xmin) * W * (ymax - ymin) * H
    label[np.where(areas < 100)] = -1
    if out_of_image:
        label[np.where(xmax < 0.01)] = -1
        label[np.where(xmin > 0.99)] = -1
        label[np.where(ymax < 0.01)] = -1
        label[np.where(ymin > 0.99)] = -1
    keep = np.where(label[:, 3] > -0.5)[0]
    top = label[keep].copy()
    label.fill(-1)
    label[: top.shape[0]] = top
    return label


def warp_affine_batch(images: torch.Tensor, matrices: torch.Tensor, out_hw: Tuple[int, int],
                      border_value: float, nearest: bool = False) -> torch.Tensor:
    """Batched inverse-mapped affine warp, float32 out, NHWC or NHW.

    ``dst(x) = src(M^-1 x)`` with ``matrices`` (B, 2, 3) mapping source to
    destination pixels, as ``cv2.warpAffine``; bilinear (or nearest, round
    half to even) sampling; taps outside the source read ``border_value``.
    Every step is a separate elementwise op in the order of the JAX version
    (no fused multiply-add), so a CUDA tensor and a CPU tensor give the same
    coordinates. Nothing here copies from the host, so on a CUDA device the
    call never waits for the stream."""
    H, W = out_hw
    squeeze = images.dim() == 3
    if squeeze:
        images = images[..., None]
    B, sh, sw, C = images.shape
    dev = images.device
    m = matrices.to(dev, torch.float32)

    # invert the 2x3 affines
    a, b_, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    det = a * e - b_ * d
    ia, ib = e / det, -b_ / det
    id_, ie = -d / det, a / det
    ic = -(ia * c + ib * f)
    if_ = -(id_ * c + ie * f)

    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")

    def col(v):
        return v[:, None, None]

    sx = col(ia) * xs + col(ib) * ys + col(ic)  # (B, H, W)
    sy = col(id_) * xs + col(ie) * ys + col(if_)
    flat = images.reshape(B, sh * sw, C).float()

    def fetch(yi, xi):
        inside = (xi >= 0) & (xi < sw) & (yi >= 0) & (yi < sh)
        idx = yi.clamp(0, sh - 1) * sw + xi.clamp(0, sw - 1)
        v = torch.gather(flat, 1, idx.reshape(B, H * W, 1).expand(B, H * W, C)).reshape(B, H, W, C)
        return torch.where(inside[..., None], v, float(border_value))

    if nearest:
        out = fetch(torch.round(sy).long(), torch.round(sx).long())
    else:
        x0 = torch.floor(sx)
        y0 = torch.floor(sy)
        wx = (sx - x0)[..., None]
        wy = (sy - y0)[..., None]
        x0i = x0.long()
        y0i = y0.long()
        v00 = fetch(y0i, x0i)
        v01 = fetch(y0i, x0i + 1)
        v10 = fetch(y0i + 1, x0i)
        v11 = fetch(y0i + 1, x0i + 1)
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        out = top * (1 - wy) + bot * wy
    return out[..., 0] if squeeze else out


# ------------------------------------------------------ colour, cv2's 8-bit rules

_HSV_SHIFT = 12
_I = np.arange(1, 256, dtype=np.float64)
# cv2's RGB2HSV_b tables: cvRound((255 << 12) / i), cvRound((180 << 12) / (6 i))
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _I)]).astype(np.int32)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * _I))]).astype(np.int32)
# HSV2RGB's sector -> (b, g, r) picks from [v, v(1-s), v(1-sh), v(1-s(1-h))]
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]], np.int64)


def bgr_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 BGR -> (..., 3) int32 HSV (H in [0, 180)), cv2's
    ``COLOR_BGR2HSV`` for 8-bit images (``RGB2HSV_b``, integer with 12-bit
    reciprocal tables)."""
    x = img.to(torch.int32)
    b, g, r = x.unbind(-1)
    v = torch.maximum(torch.maximum(b, g), r)
    vmin = torch.minimum(torch.minimum(b, g), r)
    diff = v - vmin
    sdiv = torch.from_numpy(_SDIV).to(img.device)
    hdiv = torch.from_numpy(_HDIV).to(img.device)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v.long()] + half) >> _HSV_SHIFT
    h = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff.long()] + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1)


def _fma(a: torch.Tensor, b: torch.Tensor, c: float) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add: the product of
    two float32 values is exact in float64, and for every HSV input the
    float64 sum rounds to float32 as the fused operation does (all of them
    checked against cv2 by the tests). Separate tensor ops, so no compiler
    fuses anything else."""
    return (a.double() * b.double() + c).float()


#: pixels per block of cv2's vector ``HSV2BGR`` loop (4 x 8 float32 lanes,
#: its AVX2 build); the pixels of a row past its last whole block take the
#: scalar loop, which rounds where the vector loop truncates
HSV2BGR_BLOCK = 32


def hsv_to_bgr(hsv: torch.Tensor) -> torch.Tensor:
    """(..., W, 3) integer HSV (H in [0, 180)) -> (..., W, 3) uint8 BGR,
    cv2's ``COLOR_HSV2BGR`` for 8-bit images: s and v scaled by
    float32(1/255), the sector formula in float32 with its two
    ``1 - s * h`` terms fused, times 255; truncated in each row's whole
    blocks of :data:`HSV2BGR_BLOCK` pixels (the vector loop), rounded half
    to even in the rest of the row (the scalar loop)."""
    f = np.float32
    h, s, v = hsv.unbind(-1)
    S = s.float() * float(f(1.0) / f(255.0))
    V = v.float() * float(f(1.0) / f(255.0))
    Hs = h.float() * float(f(6.0) / f(180.0))
    sector = torch.floor(Hs)
    frac = Hs - sector
    tab = torch.stack([V, V * (1.0 - S), V * _fma(-S, frac, 1.0), V * _fma(-S, 1.0 - frac, 1.0)], dim=-1)
    pick = torch.from_numpy(_SECTORS).to(hsv.device)[sector.long()]
    bgr = torch.gather(tab, -1, pick) * 255.0
    W = hsv.shape[-2]
    vector = torch.arange(W, device=hsv.device) < W // HSV2BGR_BLOCK * HSV2BGR_BLOCK
    bgr = torch.where(vector[:, None], torch.trunc(bgr), torch.round(bgr))
    return bgr.clamp(0, 255).to(torch.uint8)


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 BGR -> (...) int32 gray, cv2's ``COLOR_BGR2GRAY`` for
    8-bit images: (3735 b + 19235 g + 9798 r + 2^14) >> 15."""
    x = img.to(torch.int32)
    return (x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798 + (1 << 14)) >> 15


def draw_color_jitter(jitter, rng: np.random.RandomState) -> Tuple[Optional[float], ...]:
    """The draws of one image's colour jitter, in the JAX package's order
    (``dspnet_tpu/data/augment.py::color_jitter``): for hue, saturation,
    illumination and contrast in turn, a gate ``rng.rand() < p`` (drawn only
    when p > 0) and, when it opens, the op's value. Returns (hue delta as
    ``int(round(delta))``, saturation delta, illumination delta, contrast
    alpha), None for an op that does not run. Nothing drawn depends on the
    pixels, so a loader draws a whole batch before it has decoded one."""
    out = []
    for key, mag in (("hue", "max_random_hue"), ("saturation", "max_random_saturation"),
                     ("illumination", "max_random_illumination"), ("contrast", "max_random_contrast")):
        p = jitter.get(f"random_{key}_prob", 0.0)
        value = None
        if p > 0 and rng.rand() < p:
            value = rng.uniform(-jitter[mag], jitter[mag])
            if key == "hue":
                value = int(round(value))
            elif key == "contrast":
                value = 1.0 + value
        out.append(value)
    return tuple(out)


def apply_color_jitter(images: torch.Tensor, draws) -> torch.Tensor:
    """(B, H, W, 3) uint8 BGR and one :func:`draw_color_jitter` tuple per
    image -> the jittered batch, on the images' device. Each op runs over
    the batch and keeps its result where that image drew it, so a batch
    costs the same few launches whatever its draws:

    * hue: H + delta mod 180 through cv2's 8-bit HSV;
    * saturation: S' = trunc(clip(float32(S) + delta, 0, 255));
    * illumination: trunc(clip(float32(x) + delta, 0, 255));
    * contrast: trunc(clip(float32(x) * alpha + float32((1 - alpha) *
      mean), 0, 255)), the mean of cv2's 8-bit gray in float64.

    The JAX package's numpy ops on uint8 / float32 arrays with Python
    floats (float32 arithmetic), step for step."""
    B = images.shape[0]
    if len(draws) != B:
        raise ValueError(f"{len(draws)} jitter draws for {B} images")
    dev = images.device
    table = np.zeros((B, 8), np.float64)  # (on, value) per op
    for b, d in enumerate(draws):
        for k, value in enumerate(d):
            if value is not None:
                table[b, 2 * k:2 * k + 2] = (1.0, value)
    if not table[:, 0::2].any():
        return images
    t = torch.from_numpy(table)
    t = (t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t)[:, :, None, None, None]
    on = [t[:, 2 * k] > 0 for k in range(4)]
    x = images
    if table[:, 0].any():  # hue
        hsv = bgr_to_hsv(x)
        h = torch.remainder(hsv[..., :1] + t[:, 1].to(torch.int32), 180)
        x = torch.where(on[0], hsv_to_bgr(torch.cat([h, hsv[..., 1:]], -1)), x)
    if table[:, 2].any():  # saturation
        hsv = bgr_to_hsv(x)
        s = (hsv[..., 1:2].float() + t[:, 3].float()).clamp(0, 255).to(torch.int32)
        x = torch.where(on[1], hsv_to_bgr(torch.cat([hsv[..., :1], s, hsv[..., 2:]], -1)), x)
    if table[:, 4].any():  # illumination
        x = torch.where(on[2], (x.float() + t[:, 5].float()).clamp(0, 255).to(torch.uint8), x)
    if table[:, 6].any():  # contrast
        gray = bgr_to_gray(x)
        mean = gray.sum(dim=(1, 2), dtype=torch.int64).double() / float(gray[0].numel())
        alpha = t[:, 7]
        c = ((1.0 - alpha) * mean[:, None, None, None]).float()
        y = x.float() * alpha.float() + c
        x = torch.where(on[3], y.clamp(0, 255).to(torch.uint8), x)
    return x


def color_jitter(img_bgr: torch.Tensor, jitter, rng: np.random.RandomState) -> torch.Tensor:
    """The JAX package's ``color_jitter(img, jitter, rng)`` on a (H, W, 3)
    uint8 BGR tensor, on its device: :func:`draw_color_jitter` then
    :func:`apply_color_jitter`."""
    return apply_color_jitter(img_bgr[None], [draw_color_jitter(jitter, rng)])[0]


def normalize_image(img_bgr: torch.Tensor, mean_pixels=MEAN_PIXELS) -> torch.Tensor:
    """(..., H, W, 3) uint8 BGR -> float32 RGB minus the mean pixel, on the
    tensor's device (``dspnet_tpu/data/augment.py::normalize_image``).
    ``mean_pixels``: RGB, a tuple or a float32 tensor on the device."""
    mean = torch.as_tensor(mean_pixels, dtype=torch.float32, device=img_bgr.device)
    return img_bgr.flip(-1).float() - mean
