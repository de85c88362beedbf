"""Multitask losses with the reference's gradient scaling (counterpart of
``dspnet_tpu/train/losses.py``).

The reference writes its losses as MXNet output layers
(multitask_symbol_builder.py:526-532, 588-589); their backward passes define
the scalar objective differentiated here:

* classification — SoftmaxOutput(ignore_label=-1, normalization='valid'):
  the sum of CE over anchors with target >= 0, divided by that count over
  the whole batch;
* localization — smooth_l1(mask * (pred - target)) through
  MakeLoss(normalization='valid'): the sum divided by the count of loss
  elements above 0;
* segmentation — SoftmaxOutput(ignore_label=255, grad_scale=4,
  normalization 'null'): 4 x the unnormalized sum of per-pixel CE over
  non-ignored pixels; ``seg_normalize='valid'`` divides by the valid count.
"""

from __future__ import annotations

from typing import Dict

import torch

SEG_IGNORE = 255
CLS_IGNORE = -1.0


def smooth_l1(x, scalar: float = 1.0):
    """MXNet smooth_l1 with sigma = ``scalar``."""
    s2 = scalar * scalar
    ax = x.abs()
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


def cls_loss_valid(cls_logits, cls_target):
    """(B, A, C) logits vs (B, A) targets, ignore -1, 'valid' normalization.
    Returns (loss, valid_count)."""
    valid = cls_target != CLS_IGNORE
    tgt = cls_target.clamp_min(0).long()
    logp = torch.log_softmax(cls_logits, dim=-1)
    ce = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    ce = torch.where(valid, ce, torch.zeros_like(ce))
    count = valid.sum()
    return ce.sum() / count.clamp_min(1), count


def loc_loss_valid(loc_preds, loc_target, loc_mask):
    """Masked smooth-L1 with MakeLoss-'valid' normalization (non-zero count).
    Returns (loss, unnormalized sum)."""
    elems = smooth_l1(loc_mask * (loc_preds - loc_target), 1.0)
    nonzero = (elems > 0.0).sum()
    total = elems.sum()
    return total / nonzero.clamp_min(1), total


def seg_loss_and_accuracy(seg_logits, seg_labels, grad_scale: float = 4.0,
                          normalize: str = "null"):
    """(B, H, W, C) logits vs (B, H, W) int labels with ignore 255.

    Returns (loss, correct_count, valid_count). A pixel counts as correct
    when its label's logit equals the maximum (``picked == 0`` on the
    max-shifted logits): tie-lenient where argmax takes the first maximum,
    as the JAX package's monitoring accuracy."""
    valid = seg_labels != SEG_IGNORE
    tgt = torch.where(valid, seg_labels, torch.zeros_like(seg_labels)).long()
    m = seg_logits.detach().amax(dim=-1, keepdim=True)
    shifted = seg_logits - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    picked = torch.gather(shifted, -1, tgt[..., None])[..., 0]
    ce = torch.where(valid, lse - picked, torch.zeros_like(lse))
    total = ce.sum()
    valid_count = valid.sum()
    if normalize == "valid":
        total = total / valid_count.clamp_min(1)
    correct = (valid & (picked.detach() == 0.0)).sum()
    return grad_scale * total, correct, valid_count


def seg_loss(seg_logits, seg_labels, grad_scale: float = 4.0, normalize: str = "null"):
    return seg_loss_and_accuracy(seg_logits, seg_labels, grad_scale, normalize)[0]


def multitask_loss(
    outputs: Dict,
    loc_target,
    loc_mask,
    cls_target,
    seg_labels=None,
    seg_grad_scale: float = 4.0,
    seg_normalize: str = "null",
):
    """Combined objective and monitoring scalars: (total_loss, metrics), with
    the JAX package's metric keys. The detection losses are skipped when
    ``cls_target`` is None, the seg loss when ``seg_labels`` is None."""
    metrics = {}
    total = 0.0
    if "cls_logits" in outputs and cls_target is not None:
        cls_l, valid_count = cls_loss_valid(outputs["cls_logits"], cls_target)
        loc_l, loc_sum = loc_loss_valid(outputs["loc_preds"], loc_target, loc_mask)
        total = total + cls_l + loc_l
        metrics["cross_entropy"] = cls_l
        metrics["smooth_l1"] = loc_sum / valid_count.clamp_min(1)
        metrics["valid_anchors"] = valid_count
    if seg_labels is not None and "seg_logits" in outputs:
        s, correct, valid_px = seg_loss_and_accuracy(
            outputs["seg_logits"], seg_labels, seg_grad_scale, seg_normalize)
        total = total + s
        metrics["seg_loss"] = s
        metrics["seg_accuracy"] = correct / valid_px.clamp_min(1)
    metrics["loss"] = total
    return total, metrics
