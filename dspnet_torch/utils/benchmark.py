"""Timing helpers and the canonical synthetic train batch (counterpart of
``dspnet_tpu/utils/benchmark.py``).

:func:`timed` and :func:`timed_train_steps` time on the host clock over a
window that ends in a synchronise: ``float()`` of a result that depends on
every timed call, as in the JAX helpers (on a card, ``float`` of a CUDA
tensor waits for the stream). Warm-up calls run, and are waited for, before
the window opens.

:func:`canonical_train_batch` makes the same seeded numpy draws in the same
order as the JAX function, so both packages train on the same batch: 8
random boxes per image in ``(B, 200, 6)`` -1-padded labels, images in
``[0, 1)``, 19-class seg labels at 1/4 resolution. The JAX function's
``pre_s2d`` option is a TPU input layout and has no counterpart here.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch


def canonical_train_batch(B: int = 4, H: int = 512, W: int = 1024, seed: int = 0) -> Dict[str, np.ndarray]:
    """``{"images" (B, H, W, 3) f32, "label_det" (B, 200, 6) f32,
    "seg_label" (B, H/4, W/4) int32}`` as numpy arrays."""
    rng = np.random.RandomState(seed)
    lab = np.full((B, 200, 6), -1, np.float32)
    lab[:, :8] = np.abs(rng.rand(B, 8, 6)).astype(np.float32)
    lab[:, :8, 0] = rng.randint(0, 8, (B, 8))
    lab[:, :8, 3:5] = lab[:, :8, 1:3] + 0.2
    img = rng.rand(B, H, W, 3).astype(np.float32)
    seg = rng.randint(0, 19, (B, H // 4, W // 4)).astype(np.int32)
    return {"images": img, "label_det": lab, "seg_label": seg}


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """numpy (or tensor) batch -> tensors on ``device``, dtypes kept."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def timed(fn, *args, n: int = 20, warmup: int = 3) -> float:
    """Mean seconds per call of ``fn(*args)``, which returns a scalar tensor:
    the results are summed on their device and the window closes on
    ``float()`` of the sum."""
    acc = 0.0
    for _ in range(warmup):
        acc = acc + fn(*args)
    float(acc)
    acc = 0.0
    t0 = time.perf_counter()
    for _ in range(n):
        acc = acc + fn(*args)
    float(acc)
    return (time.perf_counter() - t0) / n


def timed_train_steps(solver, state, batch, n: int = 20, warmup: int = 3):
    """Mean seconds per ``solver.train_step(state, batch)``; each step takes
    the state the last one returned, so ``float()`` of the last loss closes
    the window on all of them. Returns (state, seconds per step)."""
    for _ in range(warmup):
        state, metrics = solver.train_step(state, batch)
    float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(n):
        state, metrics = solver.train_step(state, batch)
    float(metrics["loss"])
    return state, (time.perf_counter() - t0) / n
