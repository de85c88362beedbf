"""Training CLI (counterpart of ``dspnet_tpu/cli/multi_train.py``; reference
multi_train.py:20-100, 188-536): build the dataset, train with a validation
pass after each epoch, checkpoint, resume.

    python -m dspnet_torch.cli.multi_train --network resnet-50_multi \\
        --data-shape 3,512,1024 --batch-size 4 --dataset-root data/cityscapes \\
        --end-epoch 2 --seg-normalize valid --compute-dtype bfloat16

The data is ``--dataset-root`` (a prepared directory, VOC / Cityscapes /
record store, through ``data/imdb.py::load_index``; the train split is
``train``, the val split ``val``, and a missing val split skips the
validation pass, as in the JAX CLI) or ``--synthetic N``. It takes the JAX
CLI's flags that this port honours and no others: argparse rejects the rest
(multi-process and mesh flags, ``--remat``, ``--seg-fast``, ``--input-s2d``,
the host loaders; ROADMAP Queue A). ``--monitor N --pattern RX`` logs the
shape, mean and std of every parameter whose flax path matches RX after
every N-th batch (``utils/profiler.py::StatMonitor``; the JAX CLI's paths,
so one pattern serves both), copying two numbers per matching tensor.

Two loaders. ``device`` (the default): on the card the host threads read
bytes and decode masks, nvJPEG decodes the images and the augmentation runs
there (``data/device_pipeline.py``); ``--predownscale`` resizes each image
to the data shape right after its decode. ``det``: the plain-SSD
``DetIterator`` (``data/det_iterator.py``: IoU-constrained crop, pad,
mirror, one of cv2's five resizes and the colour jitter, drawn on the host
in the JAX order and applied on the device) for a plain SSD network
(``vgg16_reduced``, ``legacy_vgg16_ssd_*``, ``resnet-18``, …) or a ``_det``
one on a VOC devkit tree (``--dataset-root``); the validation pass then
reads the val split through the ``device`` loader without augmentation, as
the JAX CLI does. The JAX CLI's ``python`` and ``native`` loaders are not
ported (ROADMAP Queue A item 20). ``--device`` defaults to ``cuda`` and
fails without a CUDA device.

One deliberate difference from the JAX CLI: ``--checkpoint-every N`` saves
when the **absolute** epoch satisfies ``(epoch + 1) % N == 0`` (and always
at the last epoch). The JAX CLI gates on the epoch counted from the start of
the run (``dspnet_tpu/cli/multi_train.py:267``), so a resumed run saves at
other epochs than an unbroken one; here both save at the same epochs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from dspnet_torch.api import create_model
from dspnet_torch.cli.common import (
    default_synthetic_dir,
    parse_data_shape,
    resolve_class_names,
    resolve_dataset,
    resolve_device,
    setup_logging,
)
from dspnet_torch.data.cs_labels import DET_CLASSES
from dspnet_torch.data.det_iterator import DetIterator
from dspnet_torch.data.device_pipeline import DeviceAugIterator
from dspnet_torch.train.lr import lr_scheduler_from_epochs
from dspnet_torch.train.solver import MultiTaskSolver, TrainingDiverged
from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix
from dspnet_torch.utils.profiler import StatMonitor

SEED = 233  # the reference's seed: weights, shuffle and augmentation table


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a DSPNet multitask network (PyTorch port).")
    p.add_argument("--network", default="resnet-50_multi")
    p.add_argument("--data-shape", default="3,512,1024")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--class-names", default="",
                   help="comma list or file of one name per line; must list "
                        "--num-classes names (default: the 8 Cityscapes det names)")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--lr", type=float, default=0.0005)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=0.0005)
    p.add_argument("--lr-steps", default="80,160,240,320")
    p.add_argument("--lr-factor", type=float, default=0.5)
    p.add_argument("--begin-epoch", type=int, default=0)
    p.add_argument("--end-epoch", type=int, default=2000)
    p.add_argument("--resume", type=int, default=-1,
                   help="resume from epoch N (0 = latest checkpoint, -1 off)")
    p.add_argument("--freeze", default="", help="regex of flax param paths to freeze")
    p.add_argument("--model-dir", default="model")
    p.add_argument("--dataset-root", default="",
                   help="a prepared dataset directory or .drec record store (splits train, val)")
    p.add_argument("--synthetic", type=int, default=0, help="use N synthetic samples")
    p.add_argument("--synthetic-val", type=int, default=0,
                   help="synthetic validation-set size (0 = same as --synthetic)")
    p.add_argument("--synthetic-dir", default=default_synthetic_dir())
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--monitor", type=int, default=0,
                   help="log param stats every N batches (reference mx.mon.Monitor, "
                        "multi_train.py:76-79,379)")
    p.add_argument("--pattern", default=".*", help="with --monitor: regex of flax param paths to log")
    p.add_argument("--metrics-jsonl", default="",
                   help="append per-epoch train/val metrics as JSON lines "
                        "({epoch, split, time, ...metrics})")
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="save when (absolute epoch + 1) %% N == 0; the final epoch "
                        "is always saved")
    p.add_argument("--seg-normalize", default="null", choices=["null", "valid"])
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="model compute precision (float32 master weights either way)")
    p.add_argument("--loader", default="device", choices=["device", "det"],
                   help="input pipeline: 'device' (host reads, nvJPEG decode and the multitask "
                        "augmentation on the device) or 'det' (the plain-SSD DetIterator: "
                        "IoU-constrained crop/pad/mirror, random interpolation and colour jitter, "
                        "reference dataset/iterator.py DetIter)")
    p.add_argument("--loader-threads", type=int, default=8)
    p.add_argument("--predownscale", action="store_true",
                   help="resize each image to the data shape right after its decode (on the "
                        "device on cuda) and each mask nearest; allows mixed raw resolutions")
    p.add_argument("--target-backend", default="auto", choices=["auto", "kernel", "plain"],
                   help="bipartite matcher of target assignment (auto: the CUDA "
                        "kernel on a CUDA device, the plain rounds elsewhere)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="accumulate gradients over N batches before each update")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails without a CUDA device")
    args = p.parse_args(argv)
    args.data_shape = parse_data_shape(args.data_shape)
    return args


def main(argv=None):
    args = parse_args(argv)
    log = setup_logging()
    device = resolve_device(args.device)
    H, W = args.data_shape
    bundle = create_model(args.network, (H, W), args.num_classes, device=device,
                          generator=torch.Generator().manual_seed(SEED))
    log.info("network=%s task=%s anchors=%d data=%dx%d device=%s", bundle.name, bundle.task,
             bundle.num_anchors, H, W, device)

    class_names = resolve_class_names(args.class_names, DET_CLASSES)
    if len(class_names) != args.num_classes:
        raise ValueError(f"--class-names lists {len(class_names)} names but --num-classes is "
                         f"{args.num_classes}")
    train_index = resolve_dataset(args, "train")
    # label-space invariant: every GT class id must fit the head being
    # trained; a dataset indexed with the wrong name table fails here
    max_cid = max((int(s.label[:, 0].max()) for s in train_index.samples if s.label.size), default=-1)
    if max_cid >= args.num_classes:
        raise ValueError(
            f"dataset labels carry class id {max_cid} but --num-classes is {args.num_classes}; "
            "pass --class-names matching the annotation names (or fix --num-classes)")
    if args.loader == "det":
        if bundle.task not in ("ssd", "det"):
            raise ValueError("--loader det is the det-only SSD pipeline (no seg labels); "
                             f"network task is '{bundle.task}'")
        train_iter = DetIterator(train_index, args.batch_size, (H, W), is_train=True, seed=SEED,
                                 device=device)
        log.info("using plain-SSD DetIterator (crop/pad/mirror augmentation)")
    else:
        train_iter = DeviceAugIterator(train_index, args.batch_size, (H, W), device=device, seed=SEED,
                                       enable_aug=True, num_threads=args.loader_threads,
                                       predownscale=args.predownscale)

    _, schedule = lr_scheduler_from_epochs(
        args.lr, args.lr_steps, args.lr_factor, len(train_index),
        args.batch_size * args.grad_accum,  # optimizer steps per epoch
        args.begin_epoch)
    solver = MultiTaskSolver(
        bundle.model, bundle.anchors if bundle.anchors is not None else np.zeros((1, 4), np.float32),
        learning_rate=schedule, momentum=args.momentum,
        weight_decay=args.wd, batch_size=args.batch_size, freeze_pattern=args.freeze or None,
        seg_normalize=args.seg_normalize, compute_dtype=args.compute_dtype,
        target_backend=args.target_backend, grad_accum=args.grad_accum, device=device)
    state = solver.init_state()

    prefix = checkpoint_prefix(args.model_dir, args.network, H)
    ckpt = CheckpointManager(prefix)
    begin = args.begin_epoch
    if args.resume > 0 or (args.resume == 0 and ckpt.latest_epoch() is not None):
        state, epoch = ckpt.restore(args.resume if args.resume > 0 else None, state)
        begin = epoch + 1
        log.info("resumed from epoch %d (step %d)", epoch, state.step)
    elif args.resume == 0:
        # --resume 0 on an empty model dir starts fresh, so a restart script
        # passes the same flags for the first run and every retry
        log.info("no checkpoint under %s yet; starting fresh", prefix)

    last_epoch = args.end_epoch - begin - 1

    def epoch_cb(epoch, st):
        # cadence on the absolute epoch (see the module docstring); the final
        # save blocks so the run exits with its last checkpoint written
        ep = begin + epoch
        if (ep + 1) % args.checkpoint_every == 0 or epoch == last_epoch:
            ckpt.save(ep, st, block=epoch == last_epoch)
            log.info("checkpoint save %s: %s epoch %d step %d",
                     "committed" if epoch == last_epoch else "started", prefix, ep, st.step)

    eval_iter = None
    if args.eval_every > 0:
        try:
            val_index = resolve_dataset(args, "val")
        except FileNotFoundError:
            val_index = None
            log.info("no validation split found; skipping per-epoch eval")
        if val_index is not None:
            eval_iter = DeviceAugIterator(val_index, args.batch_size, (H, W), device=device, seed=SEED,
                                          enable_aug=False, shuffle=False, pad_last=True,
                                          num_threads=args.loader_threads, predownscale=args.predownscale)

    metrics_sink = None
    if args.metrics_jsonl:
        def metrics_sink(ep, split, metrics):
            with open(args.metrics_jsonl, "a") as f:
                f.write(json.dumps({"epoch": ep, "split": split, "time": time.time(), **metrics}) + "\n")

    batch_cb = None
    if args.monitor > 0:
        mon = StatMonitor(interval=args.monitor, pattern=args.pattern, logger=log)

        def batch_cb(st, n):
            mon.tic_toc(st.params)

    try:
        state = solver.fit(
            state, train_iter, num_epochs=args.end_epoch - begin, eval_iter=eval_iter,
            eval_every=args.eval_every, data_shape=(H, W), log_fn=log.info,
            epoch_end_callback=epoch_cb, log_every=args.log_every, epoch_offset=begin,
            metrics_sink=metrics_sink, batch_end_callback=batch_cb)
    except TrainingDiverged as e:
        # exit 3 = deterministic failure: a restart script must not retry (a
        # resume replays the same seeded epoch and diverges again)
        log.error(str(e))
        sys.exit(3)
    finally:
        ckpt.close()
    return state


if __name__ == "__main__":
    main()
