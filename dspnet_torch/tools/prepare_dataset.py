"""prepare_dataset — ``.lst`` files, and optionally ``.drec`` stores, from a
dataset's indexer (counterpart of ``dspnet_tpu/tools/prepare_dataset.py``).

The reference's ``tools/prepare_dataset.py`` turns its imdbs into a ``.lst``
and packs a ``.rec`` (reference tools/prepare_dataset.py:118-140): PASCAL VOC
(several sets and years through ConcatDB), COCO, Cityscapes. Here: the
indexer of ``data/imdb.py`` -> ``Imdb.save_imglist`` (``.lst``) -> with
``--pack``, a ``.drec`` store beside it (``data/record.py``, the port's
``.rec``), which ``--dataset-root`` reads.

    python -m dspnet_torch.tools.prepare_dataset --dataset pascal \\
        --set trainval --year 2007,2012 --root VOCdevkit --target train.lst --pack
    python -m dspnet_torch.tools.prepare_dataset --dataset cityscapes \\
        --set train --root cityscapes --target cs_train.lst --pack
"""

from __future__ import annotations

import argparse
import os


def build_imdb(args):
    """The indexer ``args`` name (the JAX tool's flags)."""
    from dspnet_torch.data.imdb import CityscapesDetSeg, CocoDet, ConcatDB, PascalVoc, YoloFormat

    if args.dataset in ("pascal", "voc"):
        sets = [s.strip() for s in args.set.split(",")]
        years = [y.strip() for y in args.year.split(",")]
        # the reference's set x year zipping (prepare_dataset.py:36-46)
        if len(sets) > 1 and len(years) == 1:
            years = years * len(sets)
        if len(sets) == 1 and len(years) > 1:
            sets = sets * len(years)
        dbs = [PascalVoc(s, y, args.root, use_difficult=args.difficult) for s, y in zip(sets, years)]
        return dbs[0] if len(dbs) == 1 else ConcatDB(*dbs)
    if args.dataset == "coco":
        return CocoDet(args.annotation, args.root)
    if args.dataset == "cityscapes":
        return CityscapesDetSeg(args.set, args.root)
    if args.dataset == "yolo":
        classes = [c.strip() for c in args.classes.split(",") if c.strip()]
        return YoloFormat(args.list_file, args.root, args.label_dir or os.path.join(args.root, "labels"), classes)
    raise ValueError(f"unknown dataset {args.dataset}")


def main(argv=None):
    p = argparse.ArgumentParser(description="Build .lst (+ optional .drec) from a dataset.")
    p.add_argument("--dataset", required=True, choices=["pascal", "voc", "coco", "cityscapes", "yolo"])
    p.add_argument("--set", default="trainval", help="image set(s), comma separated")
    p.add_argument("--year", default="2007,2012", help="VOC year(s), comma separated")
    p.add_argument("--root", required=True, help="dataset root directory")
    p.add_argument("--annotation", default="", help="COCO instances JSON")
    p.add_argument("--list-file", default="", help="YOLO image list file")
    p.add_argument("--label-dir", default="", help="YOLO label directory")
    p.add_argument("--classes", default="", help="YOLO class names, comma separated")
    p.add_argument("--difficult", action="store_true", help="keep VOC difficult objects")
    p.add_argument("--target", required=True, help="output .lst path")
    p.add_argument("--pack", action="store_true", help="also pack a .drec/.idx record store next to the .lst")
    args = p.parse_args(argv)

    db = build_imdb(args)
    os.makedirs(os.path.dirname(os.path.abspath(args.target)), exist_ok=True)
    db.save_imglist(args.target)
    print(f"wrote {args.target} ({len(db.samples())} samples)")
    if args.pack:
        from dspnet_torch.data.record import pack_records

        pack_records(db.index(), os.path.splitext(args.target)[0])


if __name__ == "__main__":
    main()
