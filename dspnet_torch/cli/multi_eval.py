"""Evaluation CLI (counterpart of ``dspnet_tpu/cli/multi_eval.py``; reference
multi_eval.py:106-465): detection mAP, segmentation mIoU and pixel
accuracy, depth relative error and ms/batch in one pass over the
validation split, from a checkpoint of ``multi_train``: the port's, or a
JAX run's Orbax step under ``--model-dir`` as it is (``utils/orbax_read.py``).

    python -m dspnet_torch.cli.multi_eval --network resnet-50_multi \\
        --data-shape 3,512,1024 --batch-size 4 --dataset-root data/cityscapes \\
        --write-results results --instance-eval

The detector is float32 with NMS ``--nms-thresh`` and score threshold 0.01,
as in the JAX CLI; the ``val`` split of ``--dataset-root`` (or of
``--synthetic``) goes through ``--loader`` without augmentation, its last
partial batch padded: ``device`` (the default; nvJPEG decode on the card,
``--predownscale`` as in training), ``python`` (the JAX host loader, cv2's
pixels in numpy) or ``native`` (the JAX native loader's arguments over the
device loader; ``--native-u8`` accepted), as ``multi_train``'s.
``--write-results DIR`` writes the 1024x2048 Cityscapes result PNGs from the
seg probabilities (the detector then returns them); ``--instance-eval`` scores instance AP against
``SegmentationInstance/*_instanceIds.png``. ``--seg-fast`` evaluates the
score-then-upsample seg head (pass it when the network was trained with
it).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from dspnet_torch.api import create_model
from dspnet_torch.cli.common import (
    MODEL_DIR_HELP,
    check_loader_flags,
    default_synthetic_dir,
    make_multitask_loader,
    parse_data_shape,
    resolve_class_names,
    resolve_dataset,
    resolve_device,
    setup_logging,
)
from dspnet_torch.data.cs_labels import DET_CLASSES, SEG_CLASSES
from dspnet_torch.evaluate.loop import evaluate_model
from dspnet_torch.train.solver import MultiTaskSolver
from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a DSPNet network (PyTorch port).")
    p.add_argument("--network", default="resnet-50_multi")
    p.add_argument("--data-shape", default="3,512,1024")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--class-names", default="",
                   help="names file (one per line) or comma list; default Cityscapes 8")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--epoch", type=int, default=-1, help="checkpoint epoch (-1 latest)")
    p.add_argument("--model-dir", default="model", help=MODEL_DIR_HELP)
    p.add_argument("--dataset-root", default="",
                   help="a prepared dataset directory or .drec record store (split val)")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--synthetic-dir", default=default_synthetic_dir())
    p.add_argument("--overlap-thresh", type=float, default=0.5)
    p.add_argument("--nms-thresh", type=float, default=0.45)
    p.add_argument("--det-score-thresh", type=float, default=0.1)
    p.add_argument("--write-results", default="", help="dir for Cityscapes result PNGs")
    p.add_argument("--instance-eval", action="store_true",
                   help="Cityscapes-style instance-level AP/AP50 from det boxes x seg map vs "
                        "SegmentationInstance/*_instanceIds.png ground truth")
    p.add_argument("--predownscale", action="store_true",
                   help="with --loader device: resize each image to the data shape right after its "
                        "decode")
    p.add_argument("--native-u8", action="store_true",
                   help="with --loader native: uint8 to the device, mean subtraction there")
    p.add_argument("--dist-errors", default="",
                   help="write per-box depth relative errors here (dist_errors.txt)")
    p.add_argument("--seg-class-names", default="",
                   help="seg names file or comma list; default Cityscapes 19")
    p.add_argument("--loader", default="device", choices=["python", "native", "device"],
                   help="val input pipeline: 'device' (host reads, decode, resize and normalize on "
                        "the device), 'python' (the JAX host loader) or 'native' (its native "
                        "loader's arguments over the device loader)")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="batches in flight in evaluate_model")
    p.add_argument("--random-init", action="store_true",
                   help="skip the checkpoint load (pipeline smoke testing)")
    p.add_argument("--seg-fast", action="store_true",
                   help="the score-then-upsample seg head (as trained with multi_train --seg-fast)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails without a CUDA device")
    args = p.parse_args(argv)
    args.data_shape = parse_data_shape(args.data_shape)
    check_loader_flags(p, args)
    return args


def main(argv=None):
    args = parse_args(argv)
    log = setup_logging(log_file=time.strftime("eval_%Y%m%d_%H%M%S.log"))
    device = resolve_device(args.device)
    H, W = args.data_shape
    bundle = create_model(args.network, (H, W), args.num_classes, device=device, seg_fast=args.seg_fast)
    solver = MultiTaskSolver(
        bundle.model, bundle.anchors if bundle.anchors is not None else np.zeros((1, 4), np.float32),
        device=device)
    state = solver.init_state()
    if not args.random_init:
        ckpt = CheckpointManager(checkpoint_prefix(args.model_dir, args.network, H))
        state, epoch = ckpt.restore(None if args.epoch < 0 else args.epoch, state)
        log.info("loaded checkpoint epoch %d (step %d)", epoch, state.step)

    class_names = resolve_class_names(args.class_names, DET_CLASSES)
    # the PNG writer wants probabilities (bilinear probability upsampling,
    # multi_eval.py:28-34); otherwise they are not computed
    detector = solver.make_detector(state, (H, W), nms_thresh=args.nms_thresh, score_threshold=0.01,
                                    seg_probabilities=bool(args.write_results))
    it = make_multitask_loader(args, resolve_dataset(args, "val"), args.batch_size, (H, W), device, False,
                               num_threads=4)
    return evaluate_model(
        detector,
        it,
        det_score_thresh=args.det_score_thresh,
        overlap_thresh=args.overlap_thresh,
        class_names=class_names,
        seg_class_names=resolve_class_names(args.seg_class_names, SEG_CLASSES),
        write_results=args.write_results or None,
        dist_errors_path=args.dist_errors or None,
        instance_eval=args.instance_eval,
        log_fn=log.info,
        pipeline_depth=args.pipeline_depth,
    )


if __name__ == "__main__":
    main()
