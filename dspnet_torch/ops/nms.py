"""Standalone greedy NMS (counterpart of ``dspnet_tpu/ops/nms.py``; reference
detect/nms.py, cython/cpu_nms.pyx, cython/bbox.pyx).

Fast-R-CNN-style greedy NMS over ``[x1, y1, x2, y2, score]`` rows with the
integer-pixel ``+1`` area convention, a box kept at ``overlap <= thresh``
(suppressed strictly above it):

* :func:`nms` and :func:`bbox_overlaps` are pinned numpy copies of the JAX
  package's host functions;
* :func:`nms_keep` is the counterpart of ``nms_jax``: the same rule as a
  fixed-shape ``(N,)`` bool keep mask, in torch ops on the tensor's device.

This is not the detector's NMS: ``ops/nms_cuda.py::nms_keep_mask`` (the
hand-written kernel) is class-aware, has no ``+1`` and suppresses at
``>=``, a different rule.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def nms(dets: np.ndarray, thresh: float) -> List[int]:
    """Greedy NMS on the host; returns the kept row indices, best first.

    Descending-score order (numpy argsort reversed), ``+1`` pixel areas,
    boxes kept at ``overlap <= thresh`` (reference detect/nms.py:24-58)."""
    dets = np.asarray(dets, dtype=np.float32)
    if dets.size == 0:
        return []
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[np.where(ovr <= thresh)[0] + 1]
    return keep


def nms_keep(dets, thresh: float) -> torch.Tensor:
    """Greedy NMS as an ``(N,)`` bool keep mask, on the tensor's device.

    The rule of :func:`nms` with a deterministic order: a stable ascending
    sort reversed, so tied scores go to the higher original index first.
    The greedy pass walks the sorted rows once, each row suppressing the
    later rows that overlap it by strictly more than ``thresh``."""
    dets = torch.as_tensor(dets, dtype=torch.float32)
    n = dets.shape[0]
    x1, y1, x2, y2, scores = dets[:, :5].unbind(-1)
    areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    order = torch.sort(scores, stable=True).indices.flip(0)
    sx1, sy1, sx2, sy2, sarea = (v[order] for v in (x1, y1, x2, y2, areas))
    iw = (torch.minimum(sx2[:, None], sx2[None, :]) - torch.maximum(sx1[:, None], sx1[None, :]) + 1.0).clamp_min(0.0)
    ih = (torch.minimum(sy2[:, None], sy2[None, :]) - torch.maximum(sy1[:, None], sy1[None, :]) + 1.0).clamp_min(0.0)
    inter = iw * ih
    ovr = inter / (sarea[:, None] + sarea[None, :] - inter)
    row = torch.arange(n, device=dets.device)
    suppress = (row[:, None] < row[None, :]) & (ovr > thresh)
    keep_sorted = torch.ones(n, dtype=torch.bool, device=dets.device)
    for i in range(n):
        # row i, if still kept, suppresses the later rows it overlaps
        keep_sorted &= ~(suppress[i] & keep_sorted[i])
    keep = torch.zeros(n, dtype=torch.bool, device=dets.device)
    keep[order] = keep_sorted
    return keep


def bbox_overlaps(boxes: np.ndarray, query_boxes: np.ndarray) -> np.ndarray:
    """(N, 4) x (K, 4) float64 IoU matrix with the ``+1`` pixel convention
    and the reference's asymmetry: a pair counts 0 unless the intersection
    is strictly positive in both axes (reference cython/bbox.pyx:16-55)."""
    boxes = np.asarray(boxes, dtype=np.float64)
    query_boxes = np.asarray(query_boxes, dtype=np.float64)
    iw = np.minimum(boxes[:, None, 2], query_boxes[None, :, 2]) - np.maximum(
        boxes[:, None, 0], query_boxes[None, :, 0]) + 1
    ih = np.minimum(boxes[:, None, 3], query_boxes[None, :, 3]) - np.maximum(
        boxes[:, None, 1], query_boxes[None, :, 1]) + 1
    box_area = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    query_area = (query_boxes[:, 2] - query_boxes[:, 0] + 1) * (query_boxes[:, 3] - query_boxes[:, 1] + 1)
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    union = box_area[:, None] + query_area[None, :] - inter
    return np.where(inter > 0, inter / union, 0.0)
