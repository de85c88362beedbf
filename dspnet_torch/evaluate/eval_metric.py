"""Streaming evaluation metrics (counterpart of
``dspnet_tpu/evaluate/eval_metric.py``; numpy only).

A copy of the JAX package's metric classes, which the port cannot import
(importing ``dspnet_tpu`` imports jax), with the same update/get protocol:

* :class:`MApMetric` / :class:`VOC07MApMetric` — reference
  evaluate/eval_metric.py:4-276 (greedy per-image per-class TP/FP matching
  at ovp_thresh, precision envelope / 11-point AP).
* :class:`IoUMetric` — evaluate/eval_metric.py:278-388 (per-class
  intersection/union accumulation, ignore-pixel predictions counted in the
  union as the reference does), also fed from a confusion matrix.
* :class:`MultiBoxMetric` — train/metric.py:7-68 (the training monitors:
  valid-normalized cross-entropy and smooth-L1).
* :class:`CustomAccuracyMetric` — train/metric.py:71-132.
* :class:`DistanceAccuracyMetric` — train/metric.py:135-260 (median-in-box
  disparity -> meters oracle, per-class relative error).

``tests/test_torch_eval.py`` holds each against the JAX class on the same
updates, exactly.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np


class EvalMetric:
    """Minimal reset/update/get protocol (mx.metric.EvalMetric shape)."""

    def __init__(self, name):
        self.name = name

    def reset(self):
        raise NotImplementedError

    def get(self):
        raise NotImplementedError

    def get_dict(self):
        names, values = self.get()
        if isinstance(names, str):
            return {names: values}
        return dict(zip(names, values))


class MApMetric(EvalMetric):
    """Streaming VOC mean average precision.

    update() takes per-image arrays:
      labels: (n, >=5) rows [cls, xmin, ymin, xmax, ymax, (difficult)]
      preds:  (m, >=6) rows [cls, score, xmin, ymin, xmax, ymax]
    """

    def __init__(self, ovp_thresh=0.5, use_difficult=False, class_names: Optional[Sequence[str]] = None):
        super().__init__("mAP")
        if class_names is None:
            self.num = None
        else:
            self.name = list(class_names) + ["mAP"]
            self.num = len(class_names) + 1
        self.ovp_thresh = ovp_thresh
        self.use_difficult = use_difficult
        self.class_names = class_names
        self.reset()

    def reset(self):
        if getattr(self, "num", None) is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num
        self.records = {}
        self.counts = {}

    @staticmethod
    def _iou(x, ys):
        ixmin = np.maximum(ys[:, 0], x[0])
        iymin = np.maximum(ys[:, 1], x[1])
        ixmax = np.minimum(ys[:, 2], x[2])
        iymax = np.minimum(ys[:, 3], x[3])
        iw = np.maximum(ixmax - ixmin, 0.0)
        ih = np.maximum(iymax - iymin, 0.0)
        inters = iw * ih
        uni = (
            (x[2] - x[0]) * (x[3] - x[1])
            + (ys[:, 2] - ys[:, 0]) * (ys[:, 3] - ys[:, 1])
            - inters
        )
        ious = inters / np.where(uni < 1e-12, 1.0, uni)
        ious[uni < 1e-12] = 0
        return ious

    def update(self, labels: Sequence[np.ndarray], preds: Sequence[np.ndarray]):
        """labels/preds: lists of per-image arrays (batch)."""
        for label, pred in zip(labels, preds):
            label = np.asarray(label, np.float64).copy()
            pred = np.asarray(pred, np.float64).copy()
            # per-class greedy matching (reference :115-166)
            while pred.shape[0] > 0:
                cid = int(pred[0, 0])
                indices = np.where(pred[:, 0].astype(int) == cid)[0]
                if cid < 0:
                    pred = np.delete(pred, indices, axis=0)
                    continue
                dets = pred[indices]
                pred = np.delete(pred, indices, axis=0)
                # Known deviation: the reference computes this descending
                # score sort and DISCARDS it (eval_metric.py:126 — the
                # result is never assigned), so its greedy matching runs
                # in input order. We apply the sort, which is what the
                # expression plainly intends; identical results whenever
                # detections arrive score-sorted (multibox_detection does).
                dets = dets[dets[:, 1].argsort()[::-1]]
                records = np.hstack(
                    (dets[:, 1][:, np.newaxis], np.zeros((dets.shape[0], 1)))
                )
                label_indices = np.where(label[:, 0].astype(int) == cid)[0]
                gts = label[label_indices, :]
                label = np.delete(label, label_indices, axis=0)
                if gts.size > 0:
                    found = [False] * gts.shape[0]
                    for j in range(dets.shape[0]):
                        ious = self._iou(dets[j, 2:6], gts[:, 1:5])
                        ovargmax = int(np.argmax(ious))
                        if ious[ovargmax] > self.ovp_thresh:
                            if (
                                not self.use_difficult
                                and gts.shape[1] >= 6
                                and gts[ovargmax, 5] > 0
                            ):
                                pass  # matched difficult GT -> not counted
                            elif not found[ovargmax]:
                                records[j, -1] = 1  # tp
                                found[ovargmax] = True
                            else:
                                records[j, -1] = 2  # duplicate -> fp
                        else:
                            records[j, -1] = 2
                else:
                    records[:, -1] = 2
                if not self.use_difficult and gts.shape[1] >= 6:
                    gt_count = int(np.sum(gts[:, 5] < 1))
                else:
                    gt_count = gts.shape[0]
                records = records[np.where(records[:, -1] > 0)[0], :]
                if records.size > 0:
                    self._insert(cid, records, gt_count)
            # classes only in GT (reference :169-176)
            while label.shape[0] > 0:
                cid = int(label[0, 0])
                label_indices = np.where(label[:, 0].astype(int) == cid)[0]
                label = np.delete(label, label_indices, axis=0)
                if cid < 0:
                    continue
                self._insert(cid, np.array([[0.0, 0.0]]), label_indices.size)

    def _insert(self, key, records, count):
        if key not in self.records:
            self.records[key] = records
            self.counts[key] = count
        else:
            self.records[key] = np.vstack((self.records[key], records))
            self.counts[key] += count

    def _recall_prec(self, record, count):
        record = np.delete(record, np.where(record[:, 1].astype(int) == 0)[0], axis=0)
        sorted_records = record[record[:, 0].argsort()[::-1]]
        tp = np.cumsum(sorted_records[:, 1].astype(int) == 1)
        fp = np.cumsum(sorted_records[:, 1].astype(int) == 2)
        recall = tp / float(count) if count > 0 else tp * 0.0
        prec = tp.astype(float) / np.maximum(tp + fp, 1)
        return recall, prec

    def _average_precision(self, rec, prec):
        mrec = np.concatenate(([0.0], rec, [1.0]))
        mpre = np.concatenate(([0.0], prec, [0.0]))
        for i in range(mpre.size - 1, 0, -1):
            mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
        i = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))

    def _update(self):
        aps = []
        for k, v in self.records.items():
            recall, prec = self._recall_prec(v, self.counts[k])
            ap = self._average_precision(recall, prec)
            aps.append(ap)
            if self.num is not None and k < (self.num - 1):
                self.sum_metric[k] = ap
                self.num_inst[k] = 1
        if self.num is None:
            self.num_inst = 1
            self.sum_metric = float(np.mean(aps)) if aps else float("nan")
        else:
            self.num_inst[-1] = 1
            self.sum_metric[-1] = float(np.mean(aps)) if aps else float("nan")

    def get(self):
        self._update()
        if self.num is None:
            if self.num_inst == 0:
                return (self.name, float("nan"))
            return (self.name, self.sum_metric / self.num_inst)
        names = [str(self.name[i]) for i in range(self.num)]
        values = [x / y if y != 0 else float("nan") for x, y in zip(self.sum_metric, self.num_inst)]
        return names, values


class VOC07MApMetric(MApMetric):
    """11-point interpolated AP (reference :249-276)."""

    def _average_precision(self, rec, prec):
        rec = np.asarray(rec)
        prec = np.asarray(prec)
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else float(np.max(prec[rec >= t]))
            ap += p / 11.0
        return ap


class IoUMetric(EvalMetric):
    """Segmentation IoU (reference :278-388, quirks preserved)."""

    def __init__(self, class_names: Sequence[str]):
        super().__init__("mIoU")
        self.class_names = list(class_names)
        self.name = list(class_names) + ["mIoU"]
        self.num = len(class_names) + 1
        self.reset()

    def reset(self):
        self.num_inst = np.zeros(self.num)
        self.sum_metric = np.zeros(self.num)

    def update(self, labels: np.ndarray, preds: np.ndarray):
        """labels (B, H, W) int; preds (B, H, W) int or (B, H, W, C) scores."""
        labels = np.asarray(labels)
        preds = np.asarray(preds)
        if preds.ndim == labels.ndim + 1:
            preds = np.argmax(preds, axis=-1)
        label = labels.astype(np.int32)
        pred_label = preds.astype(np.int32)
        for idx in range(self.num):
            inter = ((label.flat == idx) & (pred_label.flat == idx)).sum()
            total = ((label.flat == idx) | (pred_label.flat == idx)).sum()
            self.sum_metric[idx] += inter
            self.num_inst[idx] += total

    def update_from_confusion(self, conf: np.ndarray):
        """Equivalent of update() fed a (gt, pred)-indexed integer confusion
        matrix covering every id either side can take (ids >= conf's extent
        must not occur). Per class idx: inter = conf[idx, idx], total =
        row + col - diag — identical integers to the per-pixel masks, so
        this is bit-identical to update() on the same pixels (the eval loop
        accumulates conf on the device and feeds it here once)."""
        conf = np.asarray(conf, np.int64)
        assert conf.shape[0] == conf.shape[1] and conf.shape[0] >= self.num
        for idx in range(self.num):
            inter = conf[idx, idx]
            total = conf[idx, :].sum() + conf[:, idx].sum() - inter
            self.sum_metric[idx] += inter
            self.num_inst[idx] += total

    def get(self):
        self.sum_metric[-1] = np.mean(self.sum_metric[:-1] / (self.num_inst[:-1] + 1e-5))
        self.num_inst[-1] = 1.0
        names = [str(n) for n in self.name]
        values = [x / y if y != 0 else float("nan") for x, y in zip(self.sum_metric, self.num_inst)]
        return names, values


class MultiBoxMetric(EvalMetric):
    """Training monitors: valid-normalized cross-entropy + smooth-L1
    (reference train/metric.py:7-68)."""

    def __init__(self, eps=1e-8):
        super().__init__("MultiBox")
        self.eps = eps
        self.num = 2
        self.name = ["CrossEntropy", "SmoothL1"]
        self.reset()

    def reset(self):
        self.num_inst = [0] * self.num
        self.sum_metric = [0.0] * self.num

    def update(self, cls_prob, loc_loss, cls_label):
        """cls_prob (B, C, A), loc_loss (B, ...) elementwise smooth-l1 values,
        cls_label (B, A); numpy arrays or tensors."""
        cls_prob, loc_loss, cls_label = (np.asarray(_numpy(x)) for x in (cls_prob, loc_loss, cls_label))
        valid_count = np.sum(cls_label >= 0)
        label = cls_label.flatten()
        mask = np.where(label >= 0)[0]
        indices = np.int64(label[mask])
        prob = cls_prob.transpose((0, 2, 1)).reshape((-1, cls_prob.shape[1]))
        prob = prob[mask, indices]
        self.sum_metric[0] += (-np.log(prob + self.eps)).sum()
        self.num_inst[0] += valid_count
        self.sum_metric[1] += np.sum(loc_loss)
        self.num_inst[1] += valid_count

    def get(self):
        names = list(self.name)
        values = [x / y if y != 0 else float("nan") for x, y in zip(self.sum_metric, self.num_inst)]
        return names, values


def _numpy(x):
    """A tensor (on any device) as a numpy array; anything else as it is."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


class CustomAccuracyMetric(EvalMetric):
    """Pixel/elementwise accuracy (reference train/metric.py:71-132)."""

    def __init__(self, name="accuracy"):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        labels = np.asarray(labels)
        preds = np.asarray(preds)
        if preds.ndim == labels.ndim + 1:
            preds = np.argmax(preds, axis=-1)
        self.sum_metric += (preds.astype(np.int32).flat == labels.astype(np.int32).flat).sum()
        self.num_inst += labels.size

    def update_from_confusion(self, conf: np.ndarray):
        """update() from a (gt, pred)-indexed integer confusion matrix over
        every id either side can take: matches = trace, total = conf.sum()
        — bit-identical integers to the elementwise comparison."""
        conf = np.asarray(conf, np.int64)
        self.sum_metric += int(np.trace(conf))
        self.num_inst += int(conf.sum())

    def get(self):
        return self.name, (self.sum_metric / self.num_inst if self.num_inst else float("nan"))


class DistanceAccuracyMetric(EvalMetric):
    """Per-box depth relative error vs the disparity-median oracle
    (reference train/metric.py:135-260).

    update() takes per-image (disparity (H, W) raw uint16 counts,
    detections (m, 7) normalized rows [cls, score, x1, y1, x2, y2, dist]).
    ``dist = 2200*75 / median_disparity``; >1000 -> 200; >199 m skipped;
    error = |pred*255 - dist| / dist.
    """

    def __init__(self, class_names: Sequence[str], name="derror"):
        super().__init__(name)
        self.class_names = list(class_names)
        self.name = list(class_names) + [name]
        self.num = len(class_names) + 1
        self.reset()

    def reset(self):
        self.num_inst = [0] * self.num
        self.sum_metric = [0.0] * self.num
        self.errors: List[float] = []

    def update(self, disparity: np.ndarray, detections: np.ndarray):
        disparity = np.asarray(disparity)
        hh, ww = disparity.shape
        error = [[] for _ in range(self.num - 1)]
        for bbox in np.asarray(detections):
            if bbox[0] < 0:
                break
            xmin, xmax = int(bbox[2] * ww), int(bbox[4] * ww)
            ymin, ymax = int(bbox[3] * hh), int(bbox[5] * hh)
            xmin, ymin = max(0, xmin), max(0, ymin)
            # deviation from train/metric.py:218-220 (which only clamps the
            # mins): a fully-out-of-image box with negative xmax/ymax would
            # negative-index a huge wrong ROI — treat it as empty instead
            if xmax < xmin or ymax < ymin:
                continue
            if xmin == xmax:
                xmax = xmin + 1
            roi = np.sort(disparity[ymin:ymax, xmin:xmax].reshape(-1).astype(np.float32))
            if roi.shape[0] == 0:
                continue
            # reference train/metric.py:222 is Python-2: `/` is integer
            # division there, so ceil(n / 2) == n // 2 (NOT ceil(n/2) —
            # true division would crash on 1-pixel ROIs and shift the
            # median element for every odd-size ROI)
            dist = 2200.0 * 75.0 / (roi[roi.shape[0] // 2] + 1e-3)
            if dist > 1000:
                dist = 200
            if dist > 199:
                continue
            error[int(bbox[0])].append(abs(bbox[6] * 255.0 - dist) / dist)
        for i in range(self.num - 1):
            self.sum_metric[i] += math.fsum(error[i])
            self.num_inst[i] += len(error[i])
            self.errors += error[i]
        self.sum_metric[-1] += math.fsum(math.fsum(e) for e in error)
        self.num_inst[-1] += sum(len(e) for e in error)

    def get(self):
        names = [str(n) for n in self.name]
        values = [x / y if y != 0 else float("nan") for x, y in zip(self.sum_metric, self.num_inst)]
        return names, values

    def save_errors(self, path="dist_errors.txt"):
        np.savetxt(path, np.asarray(self.errors) * 100.0, fmt="%.1f")
