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
"""

from __future__ import annotations

from typing import Tuple

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
