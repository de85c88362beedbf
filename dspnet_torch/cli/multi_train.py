"""Training CLI (counterpart of ``dspnet_tpu/cli/multi_train.py``; reference
multi_train.py:20-100, 188-536): build the dataset, train with a validation
pass after each epoch, checkpoint, resume. ``--resume`` also continues a
JAX run: its model dir's Orbax steps are read as they are (the JAX step
goes on), and the next epochs are written as ``.pt`` beside them.

    python -m dspnet_torch.cli.multi_train --network resnet-50_multi \\
        --data-shape 3,512,1024 --batch-size 4 --dataset-root data/cityscapes \\
        --end-epoch 2 --seg-normalize valid --compute-dtype bfloat16

The data is ``--dataset-root`` (a prepared directory, VOC / Cityscapes /
record store, through ``data/imdb.py::load_index``; the train split is
``train``, the val split ``val``, and a missing val split skips the
validation pass, as in the JAX CLI) or ``--synthetic N``. It takes the JAX
CLI's flags that this port honours and no others: argparse rejects the rest
(the TPU's ``--input-s2d``, ``--model-parallel`` and ``--target-backend
pallas``; ROADMAP item 17).
``--remat`` rematerialises each residual unit of a resnet backbone in the
backward pass; ``--seg-fast`` trains the score-then-upsample seg head (use
it at eval and demo time too). ``--monitor N --pattern RX`` logs the
shape, mean and std of every parameter whose flax path matches RX after
every N-th batch (``utils/profiler.py::StatMonitor``; the JAX CLI's paths,
so one pattern serves both), copying two numbers per matching tensor.

Four loaders, the JAX CLI's. ``device`` (the default here; the JAX CLI's
is ``python``, which on the card decodes with the plain numpy JPEG decoder):
on the card the host threads read bytes and decode masks, nvJPEG decodes the
images and the augmentation runs there (``data/device_pipeline.py``);
``--predownscale``, with this loader only, resizes each image to the data
shape right after its decode. ``python``: the JAX package's host loader
(``data/iterator.py::MultiTaskIterator``, cv2's warp rules in numpy, the
JAX batches bit for bit), its batches copied to the device a few ahead on
a thread of their own. ``native``: the JAX native loader's arguments over
the device loader (``data/native_loader.py``; ``--native-u8`` is accepted,
the device loader always ships uint8). Each of the three validates through
itself without augmentation. ``det``: the plain-SSD
``DetIterator`` (``data/det_iterator.py``: IoU-constrained crop, pad,
mirror, one of cv2's five resizes and the colour jitter, drawn on the host
in the JAX order and applied on the device) for a plain SSD network
(``vgg16_reduced``, ``legacy_vgg16_ssd_*``, ``resnet-18``, …) or a ``_det``
one on a VOC devkit tree (``--dataset-root``); the validation pass then
reads the val split through the ``device`` loader without augmentation, as
the JAX CLI does. ``--device`` defaults to ``cuda`` and
fails without a CUDA device.

Data parallelism (the JAX CLI's ``--coordinator`` / ``--num-processes`` /
``--process-id``, one process per rank, ``parallel/dist.py``): every rank
runs this CLI with the same flags and its own ``--process-id``;
``--batch-size`` is the global batch and divides by the world; each rank
reads its ``rank::world`` rows of the global epoch and takes the card
``local rank % device count`` (NCCL when each rank has a card of its own,
else gloo; ``--device cpu`` is gloo). Rank 0 alone validates and writes
checkpoints. ``--num-devices N`` keeps the JAX meaning, data parallelism
over N local devices (0 = all): without ``--coordinator`` and with N > 1
this process starts N - 1 more ranks of itself on a free loopback port and
runs rank 0 (with ``--device cpu``, N gloo ranks on the CPU); on a machine
with one card, 0 means 1 and the plain path runs. ``--loader det`` does not
shard across processes (the JAX CLI refuses it across processes too), so
with it 0 means 1 on any host, and an explicit N > 1 or a ``--coordinator``
world above 1 is refused; the JAX CLI runs it over N local devices in one
process, which this port's one process per card cannot. Every collective
times out after ``parallel/dist.py::DEFAULT_TIMEOUT_S``.

Deliberate differences from the JAX CLI: ``--checkpoint-every N`` saves
when the **absolute** epoch satisfies ``(epoch + 1) % N == 0`` (and always
at the last epoch). The JAX CLI gates on the epoch counted from the start of
the run (``dspnet_tpu/cli/multi_train.py:267``), so a resumed run saves at
other epochs than an unbroken one; here both save at the same epochs.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

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
from dspnet_torch.data.cs_labels import DET_CLASSES
from dspnet_torch.data.det_iterator import DetIterator
from dspnet_torch.parallel import dist as pdist
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
    p.add_argument("--model-dir", default="model",
                   help=MODEL_DIR_HELP + "; epochs are written as .pt, beside a JAX run's steps on --resume")
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
    p.add_argument("--loader", default="device", choices=["python", "native", "device", "det"],
                   help="input pipeline: 'device' (host reads, nvJPEG decode and the multitask "
                        "augmentation on the device), 'python' (the JAX host loader: plain decode "
                        "and cv2's warp rules in numpy), 'native' (the JAX native loader's "
                        "arguments over the device loader) or 'det' (the plain-SSD DetIterator: "
                        "IoU-constrained crop/pad/mirror, random interpolation and colour jitter, "
                        "reference dataset/iterator.py DetIter)")
    p.add_argument("--loader-threads", type=int, default=8)
    p.add_argument("--predownscale", action="store_true",
                   help="with --loader device: resize each image to the data shape right after its "
                        "decode (on the device on cuda) and each mask nearest; allows mixed raw "
                        "resolutions")
    p.add_argument("--native-u8", action="store_true",
                   help="with --loader native: the uint8 batch to the device and the mean "
                        "subtraction there (what the device loader always does)")
    p.add_argument("--target-backend", default="auto", choices=["auto", "kernel", "plain"],
                   help="bipartite matcher of target assignment (auto: the CUDA "
                        "kernel on a CUDA device, the plain rounds elsewhere)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="accumulate gradients over N batches before each update")
    p.add_argument("--remat", action="store_true",
                   help="rematerialise each residual unit in the backward pass (less activation "
                        "memory, more arithmetic; resnet backbones)")
    p.add_argument("--seg-fast", action="store_true",
                   help="seg score conv at native stream resolutions (score then upsample): other "
                        "numerics, same parameters; use the same flag at eval/demo time")
    p.add_argument("--num-devices", type=int, default=0,
                   help="data parallelism over N local devices, one process each (0 = all)")
    p.add_argument("--coordinator", default="",
                   help="multi-process data parallelism: host:port of rank 0's rendezvous; every "
                        "process runs this CLI with the same flags and its own --process-id; "
                        "--batch-size is the global batch")
    p.add_argument("--num-processes", type=int, default=1, help="with --coordinator: the world size")
    p.add_argument("--process-id", type=int, default=0, help="with --coordinator: this process's rank")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' fails without a CUDA device")
    args = p.parse_args(argv)
    args.data_shape = parse_data_shape(args.data_shape)
    check_loader_flags(p, args)
    return args


def _local_world(args, device) -> int:
    """--num-devices resolved: 0 means every local device (the cards on
    cuda, one on the CPU), and one with ``--loader det``, which does not
    shard."""
    if args.num_devices < 0:
        raise ValueError(f"--num-devices {args.num_devices}")
    if args.num_devices:
        world = args.num_devices
    elif args.loader == "det":
        world = 1
    else:
        world = torch.cuda.device_count() if device.type == "cuda" else 1
    if args.loader == "det" and world > 1:
        raise ValueError(f"--loader det does not shard across processes: --num-devices {world} starts "
                         f"{world} (one per device)")
    return world


def _launch_local_ranks(argv, world: int, log):
    """Run ``world`` ranks of this CLI on this host: ranks 1.. as child
    processes, rank 0 in this process; returns rank 0's state. A failed rank
    fails the run (the others are stopped)."""
    port = pdist.free_port()
    extra = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world)]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    if "--device" in argv and argv[argv.index("--device") + 1] == "cpu":
        # CPU ranks share the host's cores: each child takes its share
        env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world)))
    log.info("--num-devices %d: starting ranks 1..%d on 127.0.0.1:%d", world, world - 1, port)
    children = [subprocess.Popen([sys.executable, "-m", "dspnet_torch.cli.multi_train", *argv, *extra,
                                  "--process-id", str(r)], env=env) for r in range(1, world)]
    try:
        state = main(list(argv) + extra + ["--process-id", "0"])
    except BaseException:
        for c in children:
            c.kill()
        raise
    finally:
        codes = [c.wait() for c in children]
    if any(codes):
        raise RuntimeError(f"data-parallel ranks 1..{world - 1} exited with {codes}")
    return state


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    log = setup_logging()
    device = resolve_device(args.device)
    if not args.coordinator:
        world = _local_world(args, device)
        if world > 1:
            return _launch_local_ranks(argv, world, log)
        return _train(args, device, log, None)
    if args.num_devices not in (0, args.num_processes):
        raise ValueError(f"--num-devices {args.num_devices} with --coordinator: the world is "
                         f"--num-processes {args.num_processes}")
    info = pdist.distributed_init(args.coordinator, args.num_processes, args.process_id, device)
    try:
        return _train(args, info.device, log, info)
    finally:
        pdist.destroy()


def _train(args, device, log, info):
    H, W = args.data_shape
    rank, world = (info.rank, info.world) if info is not None else (0, 1)
    if args.batch_size % world:
        raise ValueError(f"--batch-size {args.batch_size} is the global batch and must divide by the "
                         f"world size {world}")
    if args.loader == "det" and world > 1:
        raise ValueError("--loader det does not shard across processes (as the JAX CLI refuses it "
                         "across processes)")
    local_batch = args.batch_size // world
    bundle = create_model(args.network, (H, W), args.num_classes, device=device,
                          generator=torch.Generator().manual_seed(SEED), remat=args.remat,
                          seg_fast=args.seg_fast)
    log.info("network=%s task=%s anchors=%d data=%dx%d device=%s%s%s", bundle.name, bundle.task,
             bundle.num_anchors, H, W, device, " remat" if args.remat else "",
             " seg-fast" if args.seg_fast else "")
    if info is not None:
        log.info("data parallel: rank %d of %d, backend %s, input shard %d/%d, local batch %d of %d",
                 rank, world, info.backend, rank, world, local_batch, args.batch_size)

    class_names = resolve_class_names(args.class_names, DET_CLASSES)
    if len(class_names) != args.num_classes:
        raise ValueError(f"--class-names lists {len(class_names)} names but --num-classes is "
                         f"{args.num_classes}")
    train_index = _resolve_train(args, rank, info is not None)
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
        train_iter = make_multitask_loader(args, train_index, local_batch, (H, W), device, True, (rank, world))
        log.info("using the %s loader%s", args.loader, " (uint8 to the device)" if args.native_u8 else "")

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
        if rank == 0 and ((ep + 1) % args.checkpoint_every == 0 or epoch == last_epoch):
            ckpt.save(ep, st, block=epoch == last_epoch)
            log.info("checkpoint save %s: %s epoch %d step %d",
                     "committed" if epoch == last_epoch else "started", prefix, ep, st.step)

    eval_iter = None
    if args.eval_every > 0 and rank == 0:  # rank 0 evaluates the whole val split
        # (its local batch, as the JAX CLI); the other ranks wait at fit's barrier
        try:
            val_index = resolve_dataset(args, "val")
        except FileNotFoundError:
            val_index = None
            log.info("no validation split found; skipping per-epoch eval")
        if val_index is not None:
            # --loader det validates through the device loader, as the JAX CLI
            # validates through its own host loader
            val_args = copy.copy(args)
            val_args.loader = "device" if args.loader == "det" else args.loader
            eval_iter = make_multitask_loader(val_args, val_index, local_batch, (H, W), device, False)

    metrics_sink = None
    if args.metrics_jsonl and rank == 0:
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


def _resolve_train(args, rank: int, distributed: bool):
    """The train split, rank 0 first: the other ranks index it after a
    barrier, so no rank reads a file another is writing (``--synthetic``
    writes the set: every rank its own copy, the same files from the same
    seed)."""
    if not distributed:
        return resolve_dataset(args, "train")
    index = resolve_dataset(args, "train") if rank == 0 else None
    pdist.barrier()
    if rank:
        if args.synthetic:
            args = copy.copy(args)
            args.synthetic_dir = os.path.join(args.synthetic_dir, f"rank{rank}")
        index = resolve_dataset(args, "train")
    return index


if __name__ == "__main__":
    main()
