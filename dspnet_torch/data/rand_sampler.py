"""SSD-style random crop / pad samplers: a numpy copy of
``dspnet_tpu/data/rand_sampler.py`` (the same draws in the same order, pinned
by ``tests/test_torch_det_iterator.py``).

Behavioral parity with reference tools/rand_sampler.py:4-270 (used by the
plain-SSD DetIter path, dataset/iterator.py:249-297, with the preset lists in
config/config.py:39-57):

* :class:`RandCropper` draws up to ``max_sample`` crops in ``max_trials``
  attempts: scale U(min,max), aspect ratio clamped so the crop fits, IoU with
  some GT >= min_overlap, GT-center-inside constraint; boxes re-expressed in
  crop coordinates and clipped, zero-IoU boxes dropped.
* :class:`RandPadder` draws >1x canvases (padding) requiring every surviving
  GT to keep min(w, h) >= min_gt_scale.

Same RNG call order as the reference (one scale draw + one ratio draw + two
position draws per trial) so seeded runs line up; the rng is injectable
instead of global np.random.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np


class RandSampler:
    def __init__(self, max_trials: int, max_sample: int):
        assert max_trials > 0 and max_sample >= 0
        self.max_trials = int(max_trials)
        self.max_sample = int(max_sample)

    def sample(self, label: np.ndarray, rng=np.random):
        raise NotImplementedError


def _crop_ious(rand_box, gt_boxes):
    """IoU of one crop box vs (n, 5) GT rows [cls, x1, y1, x2, y2]."""
    l, t, r, b = rand_box
    il = np.maximum(l, gt_boxes[:, 1])
    it = np.maximum(t, gt_boxes[:, 2])
    ir = np.minimum(r, gt_boxes[:, 3])
    ib = np.minimum(b, gt_boxes[:, 4])
    inter = np.maximum(ir - il, 0) * np.maximum(ib - it, 0)
    union = (
        max(0.0, r - l) * max(0.0, b - t)
        + (gt_boxes[:, 3] - gt_boxes[:, 1]) * (gt_boxes[:, 4] - gt_boxes[:, 2])
        - inter
    )
    ious = np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)
    return ious


class RandCropper(RandSampler):
    def __init__(self, min_scale=1.0, max_scale=1.0, min_aspect_ratio=1.0,
                 max_aspect_ratio=1.0, min_overlap=0.0, max_trials=50, max_sample=1):
        super().__init__(max_trials, max_sample)
        assert 0 < min_scale <= max_scale <= 1
        assert 0 < min_aspect_ratio <= 1 <= max_aspect_ratio
        assert 0 <= min_overlap <= 1
        self.min_scale, self.max_scale = min_scale, max_scale
        self.min_aspect_ratio, self.max_aspect_ratio = min_aspect_ratio, max_aspect_ratio
        self.min_overlap = min_overlap
        self.gt_constraint = "center"

    def sample(self, label: np.ndarray, rng=np.random) -> List[Tuple]:
        samples = []
        for _ in range(self.max_trials):
            if len(samples) >= self.max_sample:
                return samples
            scale = rng.uniform(self.min_scale, self.max_scale)
            min_ratio = max(self.min_aspect_ratio, scale * scale)
            max_ratio = min(self.max_aspect_ratio, 1.0 / scale / scale)
            ratio = math.sqrt(rng.uniform(min_ratio, max_ratio))
            width, height = scale * ratio, scale / ratio
            left = rng.uniform(0.0, 1 - width)
            top = rng.uniform(0.0, 1 - height)
            rand_box = (left, top, left + width, top + height)
            gt = label[label[:, 0] > -1]
            ious = self._check(rand_box, gt)
            if ious is None:
                continue
            l, t, r, b = rand_box
            w, h = r - l, b - t
            rows = []
            for i in range(gt.shape[0]):
                if ious[i] > 0:
                    rows.append([
                        gt[i, 0],
                        max(0.0, (gt[i, 1] - l) / w),
                        max(0.0, (gt[i, 2] - t) / h),
                        min(1.0, (gt[i, 3] - l) / w),
                        min(1.0, (gt[i, 4] - t) / h),
                    ])
            if not rows:
                continue
            out = np.full_like(label, -1.0)
            out[: len(rows), :5] = np.asarray(rows)
            samples.append((rand_box, out))
        return samples

    def _check(self, rand_box, gt) -> Optional[np.ndarray]:
        if gt.shape[0] == 0:
            return None
        ious = _crop_ious(rand_box, gt)
        if np.max(ious) < self.min_overlap:
            return None
        l, t, r, b = rand_box
        if self.gt_constraint == "center":
            cx = (gt[:, 1] + gt[:, 3]) / 2
            cy = (gt[:, 2] + gt[:, 4]) / 2
            bad = (ious > 0) & ((cx < l) | (cx > r) | (cy < t) | (cy > b))
            if np.any(bad):
                return None
        elif self.gt_constraint == "corner":
            bad = (ious > 0) & ((gt[:, 1] < l) | (gt[:, 3] > r) | (gt[:, 2] < t) | (gt[:, 4] > b))
            if np.any(bad):
                return None
        return ious


class RandPadder(RandSampler):
    def __init__(self, min_scale=1.0, max_scale=1.0, min_aspect_ratio=1.0,
                 max_aspect_ratio=1.0, min_gt_scale=0.01, max_trials=50, max_sample=1):
        super().__init__(max_trials, max_sample)
        assert 1 <= min_scale <= max_scale
        assert 0 < min_aspect_ratio <= 1 <= max_aspect_ratio
        assert 0 <= min_gt_scale <= 1
        self.min_scale, self.max_scale = min_scale, max_scale
        self.min_aspect_ratio, self.max_aspect_ratio = min_aspect_ratio, max_aspect_ratio
        self.min_gt_scale = min_gt_scale

    def sample(self, label: np.ndarray, rng=np.random) -> List[Tuple]:
        samples = []
        for _ in range(self.max_trials):
            if len(samples) >= self.max_sample:
                return samples
            scale = rng.uniform(self.min_scale, self.max_scale)
            min_ratio = max(self.min_aspect_ratio, scale * scale)
            max_ratio = min(self.max_aspect_ratio, 1.0 / scale / scale)
            ratio = math.sqrt(rng.uniform(min_ratio, max_ratio))
            width, height = scale * ratio, scale / ratio
            if width < 1 or height < 1:
                continue
            left = rng.uniform(0.0, 1 - width)
            top = rng.uniform(0.0, 1 - height)
            rand_box = (left, top, left + width, top + height)
            gt = label[label[:, 0] > -1]
            rows = []
            ok = True
            for i in range(gt.shape[0]):
                x1 = (gt[i, 1] - left) / width
                y1 = (gt[i, 2] - top) / height
                x2 = (gt[i, 3] - left) / width
                y2 = (gt[i, 4] - top) / height
                if min(x2 - x1, y2 - y1) < self.min_gt_scale:
                    ok = False
                    break
                rows.append([gt[i, 0], x1, y1, x2, y2])
            if not ok or not rows:
                continue
            out = np.full_like(label, -1.0)
            out[: len(rows), :5] = np.asarray(rows)
            samples.append((rand_box, out))
        return samples
