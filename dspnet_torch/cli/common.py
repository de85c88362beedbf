"""Shared CLI plumbing (counterpart of ``dspnet_tpu/cli/common.py``):
logging, dataset resolution, the multitask loaders and their flag rules,
class names, data shapes, the device."""

from __future__ import annotations

import logging
import os
import tempfile
import time

import torch

_HANDLER_MARK = "_dspnet_torch_cli"

#: ``--model-dir``'s help in every entry point that reads a checkpoint
MODEL_DIR_HELP = ("checkpoint directory: the port's {epoch:04d}.pt files, or a JAX run's model dir as it is "
                  "(its Orbax steps are read without JAX, utils/orbax_read.py)")


def setup_logging(log_dir: str = "log", log_file: str | None = None):
    """INFO to stderr and to a timestamped file under ``log_dir`` (reference
    multi_train.py:267-274). Calling it again (a second CLI run in one
    process) replaces the handlers it added before."""
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    for h in [h for h in logger.handlers if getattr(h, _HANDLER_MARK, False)]:
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    os.makedirs(log_dir, exist_ok=True)
    if log_file is None:
        log_file = time.strftime("train_%Y%m%d_%H%M%S.log")
    for h in (logging.StreamHandler(), logging.FileHandler(os.path.join(log_dir, log_file))):
        h.setFormatter(fmt)
        setattr(h, _HANDLER_MARK, True)
        logger.addHandler(h)
    return logger


def default_synthetic_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "dspnet_torch_synth")


def resolve_dataset(args, split: str):
    """The SampleIndex of ``split``.

    --synthetic N: the train split from seed 233, the val split from seed 91
    (--synthetic-val images when set, else N), at the data shape, written
    under ``{--synthetic-dir}/{split}`` (with instance ids under
    --instance-eval). --dataset-root: ``imdb.load_index`` on the prepared
    directory or ``.drec`` store, with the --class-names table (else the
    Cityscapes 8 or VOC 20 names when --num-classes is 8 or 20) threaded
    into the XML layouts, as the JAX CLI does; a missing split raises
    FileNotFoundError."""
    from dspnet_torch.data import imdb, synthetic

    if getattr(args, "synthetic", 0):
        n = int(args.synthetic)
        if split != "train" and getattr(args, "synthetic_val", 0):
            n = int(args.synthetic_val)
        return synthetic.build_dataset(
            os.path.join(args.synthetic_dir, split),
            num_samples=n,
            hw=(args.data_shape[0], args.data_shape[1]),
            seed=233 if split == "train" else 91,
            with_instances=getattr(args, "instance_eval", False),
        )
    if not getattr(args, "dataset_root", ""):
        raise ValueError("no dataset: pass --dataset-root DIR (or a .drec store) or --synthetic N")
    classes = None
    if getattr(args, "class_names", ""):
        classes = resolve_class_names(args.class_names, None)
    else:
        nc = int(getattr(args, "num_classes", 0) or 0)
        if nc == len(imdb.CITYSCAPES_DET_CLASSES):
            classes = list(imdb.CITYSCAPES_DET_CLASSES)
        elif nc == len(imdb.VOC_CLASSES):
            classes = list(imdb.VOC_CLASSES)
    return imdb.load_index(args.dataset_root, split, classes=classes)


def check_loader_flags(parser, args) -> None:
    """The JAX CLIs' loader flag rules: ``--predownscale`` with the device
    loader, ``--native-u8`` with the native one."""
    if args.predownscale and args.loader != "device":
        parser.error(f"--predownscale is a --loader device option, not --loader {args.loader}")
    if args.native_u8 and args.loader != "native":
        parser.error(f"--native-u8 is a --loader native option, not --loader {args.loader}")


def make_multitask_loader(args, index, batch_size, data_shape, device, train: bool, shard=(0, 1),
                          num_threads=None):
    """The ``python``, ``native`` or ``device`` loader over ``index``: with
    augmentation and shuffled for training, else plain resizes in order with
    the last batch padded (the JAX CLIs' eval settings); the order and the
    augmentation table from the reference's seed, 233."""
    from dspnet_torch.data.device_pipeline import DeviceAugIterator
    from dspnet_torch.data.iterator import MultiTaskIterator
    from dspnet_torch.data.native_loader import NativeMultiTaskIterator
    from dspnet_torch.data.prefetch import OnDevice

    kw = dict(enable_aug=train, shuffle=train, shard=shard, pad_last=not train)
    threads = args.loader_threads if num_threads is None else num_threads
    if args.loader == "python":
        return OnDevice(MultiTaskIterator(index, batch_size, data_shape, seed=233, **kw), device)
    if args.loader == "native":
        return NativeMultiTaskIterator(index, batch_size, data_shape, seed=233, num_threads=threads,
                                       device_normalize=args.native_u8, device=device, **kw)
    return DeviceAugIterator(index, batch_size, data_shape, device=device, seed=233,
                             num_threads=threads, predownscale=args.predownscale, **kw)


def resolve_class_names(spec: str, default):
    """--class-names: a file of one name per line (the reference's
    dataset/names/*.txt contract, multi_train.py:141-143), a comma-separated
    list, or '' for the default."""
    if not spec:
        return list(default)
    if os.path.exists(spec):
        with open(spec) as f:
            return [line.strip() for line in f if line.strip()]
    return [c.strip() for c in spec.split(",") if c.strip()]


def parse_data_shape(s):
    """'3,512,1024' or '512,1024' or '512' -> (H, W)."""
    parts = [int(x) for x in str(s).split(",")]
    if len(parts) == 3:
        return (parts[1], parts[2])
    if len(parts) == 2:
        return (parts[0], parts[1])
    return (parts[0], parts[0])


def resolve_device(spec: str) -> torch.device:
    """--device: 'cuda' (the default) fails on a machine without a CUDA
    device instead of running on the CPU; 'cpu' is for tests and debugging."""
    device = torch.device(spec)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {spec}: no CUDA device here (torch.cuda.is_available() is "
                         "false); pass --device cpu to run on the CPU")
    return device
