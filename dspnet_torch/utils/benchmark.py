"""The canonical synthetic train batch (counterpart of
``dspnet_tpu/utils/benchmark.py::canonical_train_batch``).

The same seeded numpy draws in the same order as the JAX function, so both
packages train on the same batch: 8 random boxes per image in ``(B, 200, 6)``
-1-padded labels, images in ``[0, 1)``, 19-class seg labels at 1/4
resolution. The JAX function's ``pre_s2d`` option is a TPU input layout and
has no counterpart here.
"""

from __future__ import annotations

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
