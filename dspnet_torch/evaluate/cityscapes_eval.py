"""Cityscapes pixel-level confusion matrix (counterpart of the kernel half
of ``dspnet_tpu/evaluate/cityscapes_eval.py``).

* :func:`add_to_confusion_matrix` — the reference's Cython kernel
  (addToConfusionMatrix.pyx:10-25) as one ``np.bincount`` over id pairs;
* :func:`add_to_confusion_matrix_torch` — the same on the tensors' device
  (``torch.bincount``) into an int64 accumulator, so a long stream cannot
  wrap it as the JAX package's int32 one can.

* :func:`evaluate_pairs` — the official pixel-level scores
  (evalPixelLevelSemanticLabeling.py, JAX ``:65-118``): the 34-id confusion
  matrix of (prediction, ground truth) labelId images, per-class IoU
  ``tp / (tp + fp + fn)`` over the evaluated ids (false positives counted
  only on pixels whose ground truth is an evaluated class, false negatives
  over every prediction), the category IoUs and their means;

* :func:`write_result_png_from_probs` / :func:`write_result_png` — the
  Cityscapes result PNGs of ``--write-results`` (JAX ``:119-151``): the
  class probabilities upsampled to full resolution (bilinear, align
  corners) on their device, then argmax and the trainId -> labelId LUT; or,
  without probabilities, the argmax map upsampled nearest. The PNG is
  written by ``data/image_io.py``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from dspnet_torch.data import image_io
from dspnet_torch.data.cs_labels import TRAINID_TO_LABELID, id2label, labels
from dspnet_torch.models.layers import resize_bilinear_align_corners

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


def _eval_label_ids():
    return [l.id for l in labels if l.id >= 0 and not l.ignoreInEval]


def class_iou_scores(conf: np.ndarray) -> Dict[str, float]:
    """Official per-class IoU from a labelId confusion matrix (rows ground
    truth, columns prediction); NaN for a class with no pixel either way."""
    eval_ids = _eval_label_ids()
    scores = {}
    for i in eval_ids:
        tp = float(conf[i, i])
        fn = float(conf[i, :].sum()) - tp
        # a prediction of class i on void ground truth is no false positive
        fp = float(conf[eval_ids, i].sum()) - tp
        denom = tp + fp + fn
        scores[id2label[i].name] = tp / denom if denom > 0 else float("nan")
    return scores


def category_iou_scores(conf: np.ndarray) -> Dict[str, float]:
    """Official per-category IoU: a category's evaluated ids pooled."""
    eval_ids = _eval_label_ids()
    scores = {}
    for cat in sorted({id2label[i].category for i in eval_ids}):
        ids = [i for i in eval_ids if id2label[i].category == cat]
        tp = float(conf[np.ix_(ids, ids)].sum())
        fn = float(conf[ids, :].sum()) - tp
        fp = float(conf[np.ix_(eval_ids, ids)].sum()) - tp
        denom = tp + fp + fn
        scores[cat] = tp / denom if denom > 0 else float("nan")
    return scores


def evaluate_pairs(pairs: Iterable[Tuple[np.ndarray, np.ndarray]]) -> Dict:
    """Official scores of (prediction labelId image, ground-truth labelId
    image) pairs: ``classScores`` / ``categoryScores`` and their means over
    the classes / categories that are not NaN, ``num_images`` and the
    ``confusion`` matrix (int64, NUM_IDS x NUM_IDS)."""
    conf = np.zeros((NUM_IDS, NUM_IDS), np.int64)
    n = 0
    for pred, gt in pairs:
        add_to_confusion_matrix(pred, gt, conf)
        n += 1
    classes = class_iou_scores(conf)
    cats = category_iou_scores(conf)
    vals = [v for v in classes.values() if not np.isnan(v)]
    cvals = [v for v in cats.values() if not np.isnan(v)]
    return {
        "num_images": n,
        "classScores": classes,
        "averageScoreClasses": float(np.mean(vals)) if vals else float("nan"),
        "categoryScores": cats,
        "averageScoreCategories": float(np.mean(cvals)) if cvals else float("nan"),
        "confusion": conf,
    }


def _write_labelids(trainid: torch.Tensor, out_path: str) -> str:
    """Full-resolution trainId map -> labelId PNG (ids above 18 -> 0)."""
    lut = torch.as_tensor(TRAINID_TO_LABELID.astype(np.uint8), device=trainid.device)
    t = trainid.long()
    out = torch.where(t <= 18, lut[t.clamp(0, 18)], 0).to(torch.uint8)
    image_io.imwrite(out_path, out.cpu().numpy())
    return out_path


def write_result_png(seg_trainid, out_path: str, full_hw=(1024, 2048)) -> str:
    """(H/4, W/4) trainId prediction (tensor on any device, or array) ->
    full-resolution labelId PNG by nearest upsampling of the argmax map on
    its device (source index floor(dst * h / H), cv2 ``INTER_NEAREST``'s
    rule): the fallback where no probabilities exist."""
    t = torch.as_tensor(seg_trainid)
    h, w = t.shape
    ys = torch.arange(full_hw[0], device=t.device) * h // full_hw[0]
    xs = torch.arange(full_hw[1], device=t.device) * w // full_hw[1]
    return _write_labelids(t[ys[:, None], xs[None, :]], out_path)


def write_result_png_from_probs(seg_prob, out_path: str, full_hw=(1024, 2048)) -> str:
    """(H/4, W/4, C) class probabilities (tensor on any device, or array) ->
    full-resolution labelId PNG: bilinear upsampling with aligned corners on
    their device, then argmax (the first of equal maxima), the reference's
    probability upsampling (multi_eval.py:28-34, 355-362)."""
    p = torch.as_tensor(seg_prob, dtype=torch.float32)
    up = resize_bilinear_align_corners(p.permute(2, 0, 1)[None], full_hw)[0]
    return _write_labelids(up.argmax(dim=0), out_path)
