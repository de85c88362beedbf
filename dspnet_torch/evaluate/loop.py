"""Shared evaluation loop (counterpart of ``dspnet_tpu/evaluate/loop.py``):
the forward-only metric pass of the eval CLI and of the per-epoch
validation inside training (reference multi_solver.py:355-517,
multi_eval.py:275-423)."""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from dspnet_torch.data import image_io
from dspnet_torch.data.cs_labels import DET_CLASSES, SEG_CLASSES, name2label
from dspnet_torch.evaluate import cityscapes_eval
from dspnet_torch.evaluate.instance_eval import InstanceEvalAccumulator, boxes_and_seg_to_instances
from dspnet_torch.evaluate.eval_metric import (
    CustomAccuracyMetric,
    DistanceAccuracyMetric,
    IoUMetric,
    MApMetric,
)


def disparity_path_for(image_path: str) -> str:
    """Image path -> sibling disparity PNG (the synthetic/prepared layout)."""
    return image_path.replace("JPEGImages", "Disparity").replace(
        "_leftImg8bit.jpg", "_disparity.png"
    )


def instance_path_for(image_path: str) -> str:
    """Image path -> sibling instanceIds PNG (the prepared layout's
    SegmentationInstance/)."""
    return image_path.replace("JPEGImages", "SegmentationInstance").replace(
        "_leftImg8bit.jpg", "_gtFine_instanceIds.png"
    )


def _start_d2h(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: on CUDA a non-blocking copy into pinned memory
    (complete once the stream passes the caller's event), else ``t``."""
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def evaluate_model(
    detector,
    iterator,
    det_score_thresh: float = 0.1,
    overlap_thresh: float = 0.5,
    class_names=DET_CLASSES,
    seg_class_names=SEG_CLASSES,
    write_results: Optional[str] = None,
    dist_errors_path: Optional[str] = None,
    instance_eval: bool = False,
    log_fn=None,
    pipeline_depth: int = 2,
) -> Dict[str, float]:
    """One pass over ``iterator.epoch()`` (which owns decode-ahead and the
    copy to the device, as ``DeviceAugIterator`` does) computing mAP, mIoU, pixel accuracy,
    depth relative error, and steady-state ms/batch; a flat metric dict
    whose keys and namespacing are the JAX package's.

    * ``detector.predict`` is asynchronous on a CUDA device; each batch's
      results are read ``pipeline_depth`` batches later, so its forward, its
      copies and the host's metric math for older batches overlap.
    * seg mIoU and accuracy accumulate on the device into one 256x256 int64
      confusion matrix (``add_to_confusion_matrix_torch``) from the real rows
      of each batch; one copy to the host at the end.
    * only the (B, K, 7) det rows and the (B, 200, 6) labels come to the
      host per batch, through non-blocking copies into pinned memory that
      start when the batch is queued.

    * ``write_results``: a directory for the Cityscapes result PNGs, one
      ``{image name}_pred.png`` per real image at 1024x2048, from the
      detector's ``seg_prob`` when it returns them (bilinear probability
      upsampling, on the device) and from the argmax map otherwise.
    * ``instance_eval``: instance AP / AP50 (``instAP``, ``instAP50``,
      ``inst_{class}``) from the det rows and the seg map against each
      image's ``SegmentationInstance/*_instanceIds.png``; the seg maps then
      come to the host too.

    ``ms_per_batch`` is the wall clock per batch over the loop, the first
    batch excluded (it pays the warm-up).
    """
    map_metric = MApMetric(overlap_thresh, class_names=list(class_names))
    iou_metric = IoUMetric(list(seg_class_names))
    acc_metric = CustomAccuracyMetric()
    dist_metric = DistanceAccuracyMetric(list(class_names))
    device = torch.device(detector.device)
    conf = None  # (NUM_IDS, NUM_IDS) int64 on the device, from the first seg batch
    inst_acc = None
    if instance_eval:
        inst_acc = InstanceEvalAccumulator(list(class_names))
        det_to_trainid = {i: name2label[n].trainId for i, n in enumerate(class_names) if n in name2label}
    if write_results:
        os.makedirs(write_results, exist_ok=True)

    def write_pngs(res, fnames):
        for b in range(len(fnames)):
            name = os.path.splitext(os.path.basename(fnames[b]))[0] + "_pred.png"
            path = os.path.join(write_results, name)
            if "seg_prob" in res:
                cityscapes_eval.write_result_png_from_probs(res["seg_prob"][b], path)
            else:
                cityscapes_eval.write_result_png(res["seg"][b], path)

    def process(det_host, label_host, seg_host, event, fnames):
        """Host-side metric math for one (older) batch."""
        if event is not None:
            event.synchronize()
        if det_host is None:
            return
        n_real = len(fnames)
        inst_seg = seg_host.numpy() if seg_host is not None else None
        det = det_host.numpy()
        label_det = label_host.numpy() if label_host is not None else None
        labels, preds = [], []
        for b in range(min(det.shape[0], n_real)):
            gt = label_det[b]
            gt = gt[gt[:, 0] >= 0][:, :5]
            rows = det[b]
            rows = rows[(rows[:, 0] >= 0) & (rows[:, 1] > det_score_thresh)]
            labels.append(gt)
            preds.append(rows[:, :6])
            dpath = disparity_path_for(fnames[b])
            if os.path.exists(dpath):
                dist_metric.update(image_io.imread(dpath, image_io.IMREAD_UNCHANGED), rows)
            if inst_seg is not None:
                # the rows that feed mAP feed instance AP; the accumulator
                # matches an image's masks and lets them go
                ipath = instance_path_for(fnames[b])
                if ipath != fnames[b] and os.path.exists(ipath):
                    inst_img = image_io.imread(ipath, image_io.IMREAD_UNCHANGED)
                    inst_acc.update(boxes_and_seg_to_instances(rows, inst_seg[b], det_to_trainid,
                                                               list(class_names), inst_img.shape[:2]),
                                    inst_img.astype(np.int64))
        map_metric.update(labels, preds)

    pending = deque()
    n_batches = 0
    t_first_done = None
    with torch.inference_mode():
        for batch, fnames in iterator.epoch():
            res = detector.predict(batch["images"])
            n_real = len(fnames)
            if "seg" in res and "seg_label" in batch:
                # ids < 0 (no-label fill) land on 255 = the ignore id: they
                # count in the accuracy denominator only, like the host metrics
                gt = torch.as_tensor(batch["seg_label"][:n_real], device=device)
                gt = torch.where(gt < 0, cityscapes_eval.NUM_IDS - 1,
                                 gt.clamp(max=cityscapes_eval.NUM_IDS - 1))
                if conf is None:
                    conf = torch.zeros((cityscapes_eval.NUM_IDS,) * 2, dtype=torch.int64, device=device)
                conf = cityscapes_eval.add_to_confusion_matrix_torch(res["seg"][:n_real], gt, conf)
            if write_results and "seg" in res:
                write_pngs(res, fnames)
            det_host = label_host = seg_host = event = None
            if "det" in res:
                det_host = _start_d2h(res["det"])
                label_host = _start_d2h(torch.as_tensor(batch["label_det"]))
                if inst_acc is not None and "seg" in res:
                    seg_host = _start_d2h(res["seg"])
            if device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            pending.append((det_host, label_host, seg_host, event, fnames))
            if len(pending) > pipeline_depth:
                process(*pending.popleft())
            if n_batches == 0:
                # the first batch pays the warm-up: finish it before timing
                while pending:
                    process(*pending.popleft())
                t_first_done = time.time()
            n_batches += 1
        while pending:
            process(*pending.popleft())
        if conf is not None:
            conf_np = conf.cpu().numpy()  # the one seg copy of the pass
            iou_metric.update_from_confusion(conf_np)
            acc_metric.update_from_confusion(conf_np)
    t_last = time.time()
    total_ms = ((t_last - t_first_done) * 1000.0
                if t_first_done is not None and n_batches > 1 else 0.0)
    timed = max(n_batches - 1, 0)

    if dist_errors_path:
        # per-box relative-error dump, percent (reference train/metric.py:259)
        dist_metric.save_errors(dist_errors_path)

    results: Dict[str, float] = {}
    # per-class entries are namespaced: det classes are a subset of the seg
    # classes, so a flat update would overwrite per-class AP with IoU
    headline = {"mAP", "mIoU", "accuracy", "derror"}
    for metric, prefix in ((map_metric, "ap_"), (iou_metric, "iou_"),
                           (acc_metric, ""), (dist_metric, "derror_")):
        try:
            for k, v in metric.get_dict().items():
                results[k if k in headline else prefix + k] = v
        except Exception:  # a broken metric must not abort the others,
            # but silence would read as "not computed"
            logging.getLogger(__name__).exception(
                "metric %s failed; its keys are missing from the results",
                type(metric).__name__)
    if inst_acc is not None:
        if inst_acc.num_images == 0:
            logging.getLogger(__name__).warning(
                "instance_eval: no *_instanceIds.png ground truth found (expected "
                "SegmentationInstance/ beside JPEGImages/); instAP not computed")
        else:
            inst = inst_acc.get()
            results["instAP"] = inst.pop("AP")
            results["instAP50"] = inst.pop("AP50")
            results.update({f"inst_{c}": v for c, v in inst.items()})
    results["ms_per_batch"] = total_ms / max(timed, 1)
    if log_fn:
        for k in ("mAP", "mIoU", "accuracy", "derror", "instAP", "instAP50", "ms_per_batch"):
            if k in results:
                log_fn(f"{k}: {results[k]}")
        # LaTeX-ready &-joined row (multi_solver.py:500-517)
        log_fn(" & ".join(
            f"{k}={results[k]:.4f}" for k in ("mAP", "mIoU", "accuracy", "derror", "ms_per_batch")
            if isinstance(results.get(k), float)
        ))
    return results
