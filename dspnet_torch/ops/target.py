"""MultiBoxTarget — anchor<->GT matching and training-target assignment.

Counterpart of ``dspnet_tpu/ops/target.py::multibox_target`` with the same
signature and semantics (reference operator/multibox_target.cc:73-284),
written batched over images and run in float32 without autograd:

* labels are ``(B, L, 6)`` rows ``[cls, xmin, ymin, xmax, ymax, dist]``,
  valid up to the first ``cls == -1`` (multibox_target.cc:96-105);
* phase 1: greedy bipartite matching (``ops/matching_cuda.py``: the CUDA
  kernel for CUDA tensors, the plain rounds for CPU tensors);
* phase 2: every anchor phase 1 left unmatched takes its best valid GT
  (first max); IoU strictly above ``overlap_threshold`` makes it positive,
  and ``overlap_threshold <= 0`` keeps the bipartite matches only (:151-172);
* phase 3: negatives are the ``min(int(num_pos * ratio), A - num_pos)``
  candidates (not positive, best IoU below ``negative_mining_thresh``) of
  lowest background probability, by a stable ascending sort (ties to the
  lower anchor); with mining off every non-positive is a negative;
* an image with no valid GT keeps the init values (cls_target =
  ignore_label, masks 0);
* ``cls_target`` in ``{ignore, 0, gt_cls + 1}``; ``loc_target`` encoded with
  the variances and ``dist / 0.1``, times ``loc_mask`` (1 on positives).

The JAX op gathers the matched GT rows as a one-hot matrix product, a TPU
workaround; here it is ``torch.gather``.
"""

from __future__ import annotations

import torch

from dspnet_torch.ops import boxes as box_ops
from dspnet_torch.ops.matching_cuda import bipartite_match, bipartite_match_reference

BIPARTITE_BACKENDS = {
    "auto": bipartite_match,
    "kernel": bipartite_match,
    "plain": bipartite_match_reference,
}


def _valid_columns(labels):
    """(..., L, 6) labels -> (..., L) bool: rows before the first ``cls == -1``."""
    is_pad = labels[..., 0] == -1.0
    return torch.cumsum(is_pad.to(torch.int32), dim=-1) == 0


@torch.no_grad()
def multibox_target(
    anchors,
    labels,
    cls_preds,
    overlap_threshold: float = 0.5,
    ignore_label: float = -1.0,
    negative_mining_ratio: float = -1.0,
    negative_mining_thresh: float = 0.5,
    minimum_negative_samples: int = 0,  # accepted, unused (as in the reference)
    variances: tuple = box_ops.DEFAULT_VARIANCES,
    bipartite_backend: str = "auto",
):
    """Batched MultiBoxTarget.

    Args:
      anchors:   (A, 4) or (1, A, 4) corner anchors (tensor or numpy).
      labels:    (B, L, 6) rows, -1-padded after the last valid row.
      cls_preds: (B, C, A) raw class logits (background = class 0).
      bipartite_backend: 'auto' or 'kernel' — ``bipartite_match``, the CUDA
        kernel for CUDA tensors and the plain rounds for CPU tensors;
        'plain' — the plain rounds on any device, to hold the kernel against.

    Returns:
      loc_target (B, A, 5), loc_mask (B, A, 5), cls_target (B, A), float32.
    """
    del minimum_negative_samples
    if bipartite_backend not in BIPARTITE_BACKENDS:
        raise ValueError(f"bipartite_backend must be one of {sorted(BIPARTITE_BACKENDS)}, "
                         f"got {bipartite_backend!r}")
    match = BIPARTITE_BACKENDS[bipartite_backend]
    cls_preds = cls_preds.float()
    dev = cls_preds.device
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    if anchors.ndim == 3:
        anchors = anchors[0]
    labels = torch.as_tensor(labels, device=dev).float()
    num_anchors = anchors.shape[0]

    col_valid = _valid_columns(labels)  # (B, L)
    has_gt = col_valid.any(dim=1)  # (B,)
    iou = box_ops.iou_matrix(anchors, labels[..., 1:5]).contiguous()  # (B, A, L)

    # phase 1: greedy bipartite matching
    pos1, match_gt, match_iou = match(iou, col_valid)

    # phase 2: per-anchor best valid GT for everything phase 1 left unmatched
    masked_iou = torch.where(col_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    row_best_iou = masked_iou.amax(dim=2)
    row_best_gt = masked_iou.argmax(dim=2)
    final_gt = torch.where(pos1, match_gt.long(), row_best_gt)
    final_iou = torch.where(pos1, match_iou, row_best_iou)
    if overlap_threshold > 0:
        positive = pos1 | (~pos1 & (row_best_iou > overlap_threshold))
    else:
        positive = pos1
    num_pos = positive.sum(dim=1)

    # phase 3: negatives
    if negative_mining_ratio > 0:
        num_neg = torch.minimum((num_pos.float() * negative_mining_ratio).to(torch.int64),
                                num_anchors - num_pos)
        candidate = ~positive & (final_iou < negative_mining_thresh)
        bg_prob = torch.softmax(cls_preds, dim=1)[:, 0]  # (B, A)
        sort_key = torch.where(candidate, bg_prob, torch.full_like(bg_prob, 2.0))  # probs <= 1
        order = torch.sort(sort_key, dim=1, stable=True).indices
        rank = torch.sort(order, dim=1, stable=True).indices  # rank of each anchor
        negative = candidate & (rank < num_neg[:, None])
    else:
        negative = ~positive
    positive &= has_gt[:, None]
    negative &= has_gt[:, None]

    matched = torch.gather(labels, 1, final_gt[..., None].expand(-1, -1, labels.shape[-1]))
    cls_target = torch.where(
        positive, matched[..., 0] + 1.0,
        torch.where(negative, torch.zeros_like(matched[..., 0]),
                    torch.full_like(matched[..., 0], ignore_label)))
    loc_target = box_ops.encode_targets(anchors, matched[..., 1:5], matched[..., 5], variances)
    loc_mask = positive[..., None].float().expand_as(loc_target).contiguous()
    return loc_target * loc_mask, loc_mask, cls_target
