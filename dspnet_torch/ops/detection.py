"""MultiBoxDetection — decode + class-aware NMS, fixed shape, on the device.

Counterpart of ``dspnet_tpu/ops/detection.py::multibox_detection`` with the
same signature and semantics (reference operator/multibox_detection.cc:53-169):
  1. per anchor: first-max argmax over the foreground classes; rows scoring
     below ``threshold`` are invalid; decode incl. the distance channel;
  2. one stable sort by ``(valid desc, score desc, anchor idx asc)`` and a
     static top-K slice (K = nms_topk, or A when nms_topk <= 0); invalid rows
     become all -1 (the reference's -1-initialized output);
  3. greedy NMS over the K rows, same class only unless ``force_suppress``;
     suppressed rows get class id -1 and keep their score and box
     (multibox_detection.cc:164).
With NMS off (nms_threshold <= 0 or > 1) the reference skips sort, top-K and
NMS: the output is (B, A, 7), valid rows first in anchor order.

Everything runs in float32 whatever the head's dtype.
"""

from __future__ import annotations

import torch

from dspnet_torch.ops import boxes as box_ops
from dspnet_torch.ops.nms_cuda import nms_keep_mask, nms_keep_mask_reference

NMS_BACKENDS = {"kernel": nms_keep_mask, "plain": nms_keep_mask_reference}


def _mask_invalid(valid, cid, score, boxes, dist):
    """Non-detections become all -1 rows."""
    neg = torch.full_like(score, -1.0)
    return (
        torch.where(valid, cid, neg),
        torch.where(valid, score, neg),
        torch.where(valid[..., None], boxes, torch.full_like(boxes, -1.0)),
        torch.where(valid, dist, neg),
    )


def _take(order, valid, cid, score, boxes, dist):
    return (
        torch.gather(valid, 1, order),
        torch.gather(cid, 1, order),
        torch.gather(score, 1, order),
        torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
        torch.gather(dist, 1, order),
    )


def multibox_detection(
    cls_prob,
    loc_preds,
    anchors,
    threshold: float = 0.01,
    clip: bool = True,
    variances: tuple = box_ops.DEFAULT_VARIANCES,
    nms_threshold: float = 0.5,
    force_suppress: bool = False,
    nms_topk: int = 400,
    nms_backend: str = "kernel",
):
    """Batched MultiBoxDetection.

    Args:
      cls_prob:  (B, C, A) class probabilities (background = class 0).
      loc_preds: (B, A, 5) or (B, A*5) location regressions.
      anchors:   (A, 4) or (1, A, 4) corner anchors (tensor or numpy).
      nms_backend: 'kernel' — ``nms_keep_mask``, the CUDA kernel for CUDA
        tensors and the plain version for CPU tensors; 'plain' — the plain
        version on any device, to hold the kernel against.

    Returns:
      (B, K, 7) float32 rows ``[class_id, score, xmin, ymin, xmax, ymax,
      dist]``, K = nms_topk (A if nms_topk <= 0, capped at A); with NMS off
      (B, A, 7) in anchor order.
    """
    if nms_backend not in NMS_BACKENDS:
        raise ValueError(f"nms_backend must be one of {sorted(NMS_BACKENDS)}, got {nms_backend!r}")
    keep_mask = NMS_BACKENDS[nms_backend]
    cls_prob = cls_prob.float()
    loc_preds = loc_preds.float()
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=cls_prob.device)
    if anchors.ndim == 3:
        anchors = anchors[0]
    num_anchors = anchors.shape[0]
    B = cls_prob.shape[0]
    if loc_preds.ndim == 2:
        loc_preds = loc_preds.reshape(B, num_anchors, -1)
    if loc_preds.shape[-1] == 4:
        # classic SSD head: no distance channel -> decoded distance 0
        loc_preds = torch.cat([loc_preds, torch.zeros_like(loc_preds[..., :1])], dim=-1)
    nms_on = 0.0 < nms_threshold <= 1.0
    topk = nms_topk if nms_topk > 0 else num_anchors
    topk = min(topk, num_anchors)

    fg = cls_prob[:, 1:]  # (B, C-1, A) foreground classes
    score = fg.amax(dim=1)
    cid = fg.argmax(dim=1).float()  # first max wins
    valid = score >= threshold
    boxes, dist = box_ops.decode_locations(anchors, loc_preds, variances, clip)

    if nms_on:
        # scores lie in [0, 1], so 2.0 sorts every invalid row last
        sort_key = torch.where(valid, -score, torch.full_like(score, 2.0))
        order = torch.sort(sort_key, dim=1, stable=True).indices[:, :topk]
    else:
        # valid rows first, each group in anchor order; no truncation
        order = torch.sort((~valid).to(torch.uint8), dim=1, stable=True).indices
    k_valid, *rows = _take(order, valid, cid, score, boxes, dist)
    k_id, k_score, k_boxes, k_dist = _mask_invalid(k_valid, *rows)
    if nms_on:
        keep = keep_mask(k_boxes, k_id, k_valid, nms_threshold, force_suppress)
        k_id = torch.where(keep, k_id, torch.full_like(k_id, -1.0))

    return torch.cat([k_id[..., None], k_score[..., None], k_boxes, k_dist[..., None]], dim=-1)
