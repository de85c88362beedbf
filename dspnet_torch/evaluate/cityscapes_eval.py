"""Cityscapes pixel-level confusion matrix (counterpart of the kernel half
of ``dspnet_tpu/evaluate/cityscapes_eval.py``).

* :func:`add_to_confusion_matrix` — the reference's Cython kernel
  (addToConfusionMatrix.pyx:10-25) as one ``np.bincount`` over id pairs;
* :func:`add_to_confusion_matrix_torch` — the same on the tensors' device
  (``torch.bincount``) into an int64 accumulator, so a long stream cannot
  wrap it as the JAX package's int32 one can.

The official scoring and the result-PNG writers come with
``--write-results`` (ROADMAP Queue A item 22).
"""

from __future__ import annotations

import numpy as np
import torch

NUM_IDS = 256  # label images are uint8


def add_to_confusion_matrix(
    prediction: np.ndarray, groundtruth: np.ndarray, conf: np.ndarray
) -> np.ndarray:
    """Accumulate (gt, pred) pixel pairs into ``conf`` (NUM_IDS x NUM_IDS) in
    place and return it."""
    assert prediction.shape == groundtruth.shape
    idx = groundtruth.astype(np.int64).reshape(-1) * NUM_IDS + prediction.astype(
        np.int64
    ).reshape(-1)
    conf += np.bincount(idx, minlength=NUM_IDS * NUM_IDS).reshape(NUM_IDS, NUM_IDS)
    return conf


def add_to_confusion_matrix_torch(
    prediction: torch.Tensor, groundtruth: torch.Tensor, conf: torch.Tensor
) -> torch.Tensor:
    """``conf`` (NUM_IDS x NUM_IDS int64, on the tensors' device) plus the
    (gt, pred) pair counts of one batch; ids must lie in [0, NUM_IDS)."""
    if prediction.shape != groundtruth.shape:
        raise ValueError(f"prediction {tuple(prediction.shape)} != groundtruth {tuple(groundtruth.shape)}")
    idx = groundtruth.reshape(-1).long() * NUM_IDS + prediction.reshape(-1).long()
    counts = torch.bincount(idx, minlength=NUM_IDS * NUM_IDS)
    return conf + counts.reshape(NUM_IDS, NUM_IDS)
