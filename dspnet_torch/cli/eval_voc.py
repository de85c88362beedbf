"""Plain-SSD offline evaluation over a PASCAL-VOC devkit tree (counterpart
of ``dspnet_tpu/cli/eval_voc.py``; reference evaluate/evaluate_net.py:13-110
and dataset/pascal_voc.py:170-259).

    python -m dspnet_torch.cli.eval_voc --network vgg16_reduced \\
        --data-shape 3,300,300 --voc-root VOCdevkit --year 2007 \\
        --image-set test --voc07 --model-dir model

One pass scores the checkpoint two ways: the streaming ``MApMetric``
(``--voc07``: the 11-point VOC07 interpolation; ``--use-difficult`` counts
difficult ground truth), and the devkit path, per-class
``comp4_det_{set}_{cls}.txt`` files written under
``{voc-root}/results/VOC{year}/Main`` (or ``--result-dir``) and re-scored
with ``voc_eval``. The split goes through ``DetIterator`` without
augmentation (nvJPEG decode on the card, cv2's ``INTER_LINEAR`` resize on
the device); the detector is float32, score threshold 0.01, NMS
``--nms-thresh`` (``--force-nms`` across classes), its NMS the CUDA kernel on
the card. Returns the JAX CLI's keys: the metric's names (per class and
``mAP``), ``devkit_{class}`` / ``devkit_mAP`` and ``ms_per_batch`` (predict
to detections on the host, the first batch left out). ``--device`` defaults
to ``cuda`` and fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import time

from dspnet_torch.api import create_model
from dspnet_torch.cli.common import parse_data_shape, resolve_class_names, resolve_device, setup_logging
from dspnet_torch.data.det_iterator import DetIterator
from dspnet_torch.data.imdb import VOC_CLASSES, PascalVoc
from dspnet_torch.evaluate.eval_metric import MApMetric, VOC07MApMetric
from dspnet_torch.train.solver import MultiTaskSolver
from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a plain-SSD network on a PASCAL VOC split (PyTorch port).")
    p.add_argument("--network", default="vgg16_reduced", help="SSD network name (no task suffix = plain SSD)")
    p.add_argument("--data-shape", default="3,300,300")
    p.add_argument("--num-classes", type=int, default=20)
    p.add_argument("--class-names", default="", help="names file or comma list; default the VOC 20")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--epoch", type=int, default=-1, help="checkpoint epoch (-1 latest)")
    p.add_argument("--model-dir", default="model")
    p.add_argument("--voc-root", required=True, help="devkit root holding VOC{year}/")
    p.add_argument("--year", default="2007")
    p.add_argument("--image-set", default="val")
    p.add_argument("--voc07", action="store_true",
                   help="11-point VOC07 AP instead of area-under-envelope (reference evaluate_net.py:101-104)")
    p.add_argument("--use-difficult", action="store_true",
                   help="count difficult ground truth in the metric (reference evaluate_net.py:49-52)")
    p.add_argument("--overlap-thresh", type=float, default=0.5)
    p.add_argument("--nms-thresh", type=float, default=0.45)
    p.add_argument("--force-nms", action="store_true", help="suppress across classes in NMS")
    p.add_argument("--det-score-thresh", type=float, default=0.01, help="drop detections below this score")
    p.add_argument("--result-dir", default="",
                   help="devkit result-file dir (default {voc-root}/results/VOC{year}/Main)")
    p.add_argument("--random-init", action="store_true", help="skip checkpoint load (pipeline smoke testing)")
    p.add_argument("--device", default="cuda", help="torch device; 'cuda' fails without a CUDA device")
    args = p.parse_args(argv)
    args.data_shape = parse_data_shape(args.data_shape)
    return args


def main(argv=None):
    args = parse_args(argv)
    log = setup_logging(log_file=time.strftime("eval_voc_%Y%m%d_%H%M%S.log"))
    device = resolve_device(args.device)
    H, W = args.data_shape
    class_names = resolve_class_names(args.class_names, VOC_CLASSES)
    if len(class_names) != args.num_classes:
        raise ValueError(f"{len(class_names)} class names for --num-classes {args.num_classes}")

    bundle = create_model(args.network, (H, W), args.num_classes, device=device)
    if bundle.task not in ("ssd", "det"):
        raise ValueError(f"--network {args.network} is task '{bundle.task}', not a detector")
    solver = MultiTaskSolver(bundle.model, bundle.anchors, device=device)
    state = solver.init_state()
    if not args.random_init:
        ckpt = CheckpointManager(checkpoint_prefix(args.model_dir, args.network, H))
        state, epoch = ckpt.restore(None if args.epoch < 0 else args.epoch, state)
        log.info("loaded checkpoint epoch %d (step %d)", epoch, state.step)
    detector = solver.make_detector(state, (H, W), classes=class_names, nms_thresh=args.nms_thresh,
                                    force_suppress=args.force_nms, score_threshold=0.01)

    # difficult_in_label: every GT kept, its difficult flag in label column
    # 5, the MApMetric labels contract; the metric's use_difficult decides
    imdb = PascalVoc(args.image_set, args.year, args.voc_root, classes=class_names, difficult_in_label=True)
    index = imdb.index()
    it = DetIterator(index, args.batch_size, (H, W), is_train=False, label_col5="passthrough", device=device)

    metric_cls = VOC07MApMetric if args.voc07 else MApMetric
    metric = metric_cls(args.overlap_thresh, args.use_difficult, class_names)

    all_boxes = []  # per split image: (n, 6) [cls, score, x1, y1, x2, y2]
    n_batches, total_ms, timed = 0, 0.0, 0
    for batch, fnames in it.epoch():
        t0 = time.perf_counter()
        det = detector.predict(batch["images"])["det"].cpu().numpy()
        if n_batches > 0:
            total_ms += (time.perf_counter() - t0) * 1000.0
            timed += 1
        n_batches += 1
        gt_all = batch["label_det"].cpu().numpy()
        labels, preds = [], []
        for b in range(len(fnames)):  # the wrapped tail: only the real rows
            rows = det[b]
            rows = rows[(rows[:, 0] >= 0) & (rows[:, 1] >= args.det_score_thresh)]
            gt = gt_all[b]
            labels.append(gt[gt[:, 0] >= 0])  # (n, 6), difficult in column 5
            preds.append(rows[:, :6])
            all_boxes.append(rows[:, :6])
        metric.update(labels, preds)
    if len(all_boxes) != len(index):
        raise RuntimeError(f"{len(all_boxes)} detection lists for {len(index)} images")

    names, values = metric.get()
    results = dict(zip(names, values))
    for k in names:
        log.info("%s: %.4f", k, results[k])

    devkit = imdb.evaluate_detections(all_boxes, result_dir=args.result_dir or None,
                                      ovthresh=args.overlap_thresh, use_07_metric=args.voc07)
    log.info("devkit mAP%s: %.4f (result files: %s)", " (VOC07 11-point)" if args.voc07 else "",
             devkit["mAP"], args.result_dir or "devkit results/ tree")
    results.update({f"devkit_{k}": v for k, v in devkit.items()})
    results["ms_per_batch"] = total_ms / max(timed, 1)
    log.info("ms_per_batch: %.1f", results["ms_per_batch"])
    return results


if __name__ == "__main__":
    main()
