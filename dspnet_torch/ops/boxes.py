"""Corner-format box math: IoU, SSD encode and decode (counterpart of
``dspnet_tpu/ops/boxes.py``).

Decoding contract (reference operator/multibox_detection.cc:102-125):

    ox = px * vx * aw + ax            ow = exp(pw * vw) * aw / 2
    oy = py * vy * ah + ay            oh = exp(ph * vh) * ah / 2
    corners = (ox - ow, oy - oh, ox + ow, oy + oh), oz = pz * 0.1
    optionally clipped into [0, 1] — the distance channel too.

IoU contract: intersection = max(0, min(r) - max(l)) * max(0, min(b) - max(t));
union = areaA + areaB - I, and IoU 0 where the union is not positive
(multibox_target-inl.h:44-50; multibox_detection.cc:45-51).
"""

from __future__ import annotations

import torch

DEFAULT_VARIANCES = (0.1, 0.1, 0.2, 0.2)
DISTANCE_VARIANCE = 0.1


def corner_to_center(boxes):
    """(..., 4) corners -> (cx, cy, w, h)."""
    xmin, ymin, xmax, ymax = boxes.unbind(-1)
    return torch.stack([(xmin + xmax) * 0.5, (ymin + ymax) * 0.5, xmax - xmin, ymax - ymin], dim=-1)


def iou_matrix(a, b):
    """Pairwise IoU between ``a`` (..., N, 4) and ``b`` (..., M, 4) corners."""
    a_ = a[..., :, None, :]
    b_ = b[..., None, :, :]
    iw = torch.clamp_min(torch.minimum(a_[..., 2], b_[..., 2]) - torch.maximum(a_[..., 0], b_[..., 0]), 0.0)
    ih = torch.clamp_min(torch.minimum(a_[..., 3], b_[..., 3]) - torch.maximum(a_[..., 1], b_[..., 1]), 0.0)
    inter = iw * ih
    area_a = (a_[..., 2] - a_[..., 0]) * (a_[..., 3] - a_[..., 1])
    area_b = (b_[..., 2] - b_[..., 0]) * (b_[..., 3] - b_[..., 1])
    union = area_a + area_b - inter
    pos = union > 0.0
    return torch.where(pos, inter / torch.where(pos, union, torch.ones_like(union)), torch.zeros_like(union))


def encode_targets(anchors, gt_boxes, gt_dist, variances=DEFAULT_VARIANCES):
    """Encode matched GT corners and distance against anchors.

    anchors (..., A, 4), gt_boxes (..., A, 4), gt_dist (..., A) ->
    (..., A, 5) regression targets ``[tx, ty, tw, th, tz]``. Widths and
    heights are floored at 1e-12 before the log: an unmatched anchor's GT
    row may be degenerate, and callers mask its target.
    """
    vx, vy, vw, vh = variances
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    gw = gt_boxes[..., 2] - gt_boxes[..., 0]
    gh = gt_boxes[..., 3] - gt_boxes[..., 1]
    gx = (gt_boxes[..., 0] + gt_boxes[..., 2]) * 0.5
    gy = (gt_boxes[..., 1] + gt_boxes[..., 3]) * 0.5
    tx = (gx - ax) / aw / vx
    ty = (gy - ay) / ah / vy
    tw = torch.log(torch.clamp_min(gw, 1e-12) / aw) / vw
    th = torch.log(torch.clamp_min(gh, 1e-12) / ah) / vh
    tz = gt_dist / DISTANCE_VARIANCE
    return torch.stack([tx, ty, tw, th, tz], dim=-1)


def decode_locations(anchors, loc_pred, variances=DEFAULT_VARIANCES, clip=True):
    """Inverse transform: (..., A, 5) loc predictions -> corners + distance.

    Returns ``(boxes (..., A, 4), dist (..., A))``; if ``clip`` both are
    clamped into [0, 1] (multibox_detection.cc:121-125).
    """
    vx, vy, vw, vh = variances
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    px, py, pw, ph, pz = loc_pred.unbind(-1)
    ox = px * vx * aw + ax
    oy = py * vy * ah + ay
    ow = torch.exp(pw * vw) * aw * 0.5
    oh = torch.exp(ph * vh) * ah * 0.5
    oz = pz * DISTANCE_VARIANCE
    boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
        oz = oz.clamp(0.0, 1.0)
    return boxes, oz
