"""Demo CLI (counterpart of ``dspnet_tpu/cli/multi_demo.py``; reference
multi_demo.py:56-150): the detector on image files, each written back as
``<stem>_out.jpg`` with boxes, class and distance text and the seg overlay.

    python -m dspnet_torch.cli.multi_demo --network resnet-50_multi \\
        --data-shape 3,512,1024 --images a.jpg,b.png --out-dir out

The checkpoint is the latest under ``--model-dir`` (``--epoch N`` for
another; ``tools/import_mxnet.py`` writes one from a reference ``.params``),
or the seeded initial weights with ``--random-init``; a JAX run's model
dir is read as it is (its Orbax steps, ``utils/orbax_read.py``). JPEG inputs decode on
the card (nvJPEG and the colour kernel), the resize and the network run
there; ``--device cpu`` runs everything on the CPU. ``--seg-fast`` serves
the score-then-upsample seg head (as trained with ``multi_train
--seg-fast``). One ``--images`` path ending in ``.avi`` or ``.mp4`` is a
video: a Motion-JPEG AVI is decoded, served and encoded on the card into
``detection_out.avi`` under ``--out-dir`` (``detect/video.py``); an MP4
raises with its codec's name (H.264 and mp4v wait for NVDEC).

    python -m dspnet_torch.cli.multi_demo --network resnet-50_multi \\
        --data-shape 3,512,1024 --images clip.avi --out-dir out
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from dspnet_torch.api import create_model
from dspnet_torch.cli.common import MODEL_DIR_HELP, parse_data_shape, resolve_class_names, resolve_device
from dspnet_torch.data.cs_labels import DET_CLASSES
from dspnet_torch.detect.detector import Detector
from dspnet_torch.train.solver import MultiTaskSolver
from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DSPNet demo (PyTorch port).")
    p.add_argument("--network", default="resnet-50_multi")
    p.add_argument("--images", default="", help="comma-separated image paths, or one .avi / .mp4 video")
    p.add_argument("--data-shape", default="3,512,1024")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--class-names", default="",
                   help="names file (one per line) or comma list; default Cityscapes 8")
    p.add_argument("--epoch", type=int, default=-1)
    p.add_argument("--model-dir", default="model", help=MODEL_DIR_HELP)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--nms-thresh", type=float, default=0.5)
    p.add_argument("--vis-thresh", type=float, default=0.6)
    p.add_argument("--force-suppress", action="store_true")
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="the network's compute type (NMS and decode stay float32)")
    p.add_argument("--seg-fast", action="store_true",
                   help="the score-then-upsample seg head (as trained with multi_train --seg-fast)")
    p.add_argument("--device", default="cuda", help="torch device; 'cuda' fails without a CUDA device")
    args = p.parse_args(argv)
    args.data_shape = parse_data_shape(args.data_shape)
    return args


def get_detector(args) -> Detector:
    device = resolve_device(args.device)
    H, W = args.data_shape
    bundle = create_model(args.network, (H, W), args.num_classes, device=device, seg_fast=args.seg_fast)
    solver = MultiTaskSolver(bundle.model, bundle.anchors if bundle.anchors is not None
                             else np.zeros((1, 4), np.float32), device=device)
    state = solver.init_state()
    if not args.random_init:
        ckpt = CheckpointManager(checkpoint_prefix(args.model_dir, args.network, H))
        state, _ = ckpt.restore(None if args.epoch < 0 else args.epoch, state)
    return solver.make_detector(state, (H, W), dtype=getattr(torch, args.dtype),
                                classes=resolve_class_names(args.class_names, DET_CLASSES),
                                nms_thresh=args.nms_thresh, force_suppress=args.force_suppress)


def main(argv=None):
    args = parse_args(argv)
    detector = get_detector(args)
    inputs = [s.strip() for s in args.images.split(",") if s.strip()]
    if len(inputs) == 1:
        inputs = inputs[0]  # one path: a video path goes to the video branch
    written = detector.detect_and_visualize(inputs, args.out_dir, thresh=args.vis_thresh)
    for w in written:
        print("wrote", os.path.abspath(w))
    return written


if __name__ == "__main__":
    main()
