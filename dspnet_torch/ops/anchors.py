"""Anchor (prior box) generation — MultiBoxPrior in numpy.

A copy of ``dspnet_tpu/ops/anchors.py``: the port cannot import the JAX
package (importing it imports jax), and the table must stay bit-identical to
the JAX one, so the arithmetic below is the same numpy, line for line.

Behavioral contract (reference operator/multibox_prior.cc:30-71 and
multibox_prior-inl.h:60-128):

* For a feature map of size ``(fh, fw)`` each cell emits
  ``len(sizes) + len(ratios) - 1`` corner-format ``[xmin, ymin, xmax, ymax]``
  anchors, normalized to [0, 1] image coordinates.
* Cell order is row-major over ``(row, col)``; per-cell order is all ``sizes``
  at ratio 1 first, then ``ratios[1:]`` at ``sizes[0]``.
* Anchor *width* is multiplied by ``in_height / in_width`` so that a
  "square" prior is square in pixel space on non-square inputs
  (multibox_prior.cc:49,61).
* ``steps <= 0`` auto-computes ``(1/fh, 1/fw)``; ``offsets`` defaults to cell
  centers ``(0.5, 0.5)``; ``clip`` clamps into [0, 1].

Anchors depend only on static configuration, so they are built once on the
host and moved to the device by the caller.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence

import numpy as np


def multibox_prior(
    feat_height: int,
    feat_width: int,
    sizes: Sequence[float] = (1.0,),
    ratios: Sequence[float] = (1.0,),
    steps: Sequence[float] = (-1.0, -1.0),
    offsets: Sequence[float] = (0.5, 0.5),
    clip: bool = False,
) -> np.ndarray:
    """Generate anchors for one feature map.

    Returns float32 ``(feat_height * feat_width * K, 4)`` corner boxes where
    ``K = len(sizes) + len(ratios) - 1``.
    """
    sizes = list(sizes)
    ratios = list(ratios)
    assert len(sizes) > 0 and len(ratios) > 0
    if steps[0] > 0 and steps[1] > 0:
        step_y, step_x = steps[0], steps[1]
    else:
        # the reference resets BOTH steps when either is unset
        step_y, step_x = 1.0 / feat_height, 1.0 / feat_width

    # Per-cell half-extents, in the reference's emission order.
    aspect = feat_height / float(feat_width)  # pixel-square correction
    half_w = [s * aspect / 2.0 for s in sizes]
    half_h = [s / 2.0 for s in sizes]
    for r in ratios[1:]:
        sr = math.sqrt(r)
        half_w.append(sizes[0] * aspect * sr / 2.0)
        half_h.append(sizes[0] / sr / 2.0)
    half_w = np.asarray(half_w, np.float32)  # (K,)
    half_h = np.asarray(half_h, np.float32)

    cy = (np.arange(feat_height, dtype=np.float32) + np.float32(offsets[0])) * np.float32(step_y)
    cx = (np.arange(feat_width, dtype=np.float32) + np.float32(offsets[1])) * np.float32(step_x)
    # (fh, fw, K, 4) in (row, col, anchor) order, matching the C++ loop nest.
    cy = cy[:, None, None]
    cx = cx[None, :, None]
    zeros = np.zeros((feat_height, feat_width, half_w.shape[0]), np.float32)
    out = np.stack(
        [cx - half_w + zeros, cy - half_h + zeros, cx + half_w + zeros, cy + half_h + zeros],
        axis=-1,
    )
    out = out.reshape(-1, 4)
    if clip:
        out = np.clip(out, 0.0, 1.0)
    return np.ascontiguousarray(out, np.float32)


@lru_cache(maxsize=64)
def _cached_priors(key) -> np.ndarray:
    (fh, fw, sizes, ratios, steps, offsets, clip) = key
    arr = multibox_prior(fh, fw, sizes, ratios, steps, offsets, clip)
    arr.setflags(write=False)  # shared cache entry — callers must copy to mutate
    return arr


def multibox_prior_cached(
    feat_height: int,
    feat_width: int,
    sizes: Sequence[float],
    ratios: Sequence[float],
    steps: Sequence[float] = (-1.0, -1.0),
    offsets: Sequence[float] = (0.5, 0.5),
    clip: bool = False,
) -> np.ndarray:
    """Memoized ``multibox_prior`` (anchors are per-config constants)."""
    key = (
        int(feat_height),
        int(feat_width),
        tuple(float(s) for s in sizes),
        tuple(float(r) for r in ratios),
        tuple(float(s) for s in steps),
        tuple(float(o) for o in offsets),
        bool(clip),
    )
    return _cached_priors(key)


def anchors_for_config(
    feat_shapes: Sequence[tuple[int, int]],
    sizes: Sequence[Sequence[float]],
    ratios: Sequence[Sequence[float]],
    steps: Sequence[float] = (),
    clip: bool = False,
) -> np.ndarray:
    """Concatenate per-layer anchors into the network-wide ``(A, 4)`` table
    (the per-layer MultiBoxPrior + Concat of the reference head builder,
    symbol/common.py:414-432)."""
    assert len(feat_shapes) == len(sizes) == len(ratios)
    per_layer = []
    for k, (fh, fw) in enumerate(feat_shapes):
        st = (steps[k], steps[k]) if steps else (-1.0, -1.0)
        per_layer.append(multibox_prior_cached(fh, fw, tuple(sizes[k]), tuple(ratios[k]), st, clip=clip))
    return np.concatenate(per_layer, axis=0)
