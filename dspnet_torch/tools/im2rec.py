"""im2rec — pack a dataset into a ``.drec`` / ``.idx`` record store
(counterpart of ``dspnet_tpu/tools/im2rec.py``).

The reference's ``tools/im2rec.py --pack-label`` packs a ``.lst`` into an
MXNet ``.rec`` (reference tools/im2rec.py:137-140). This tool packs a
``.lst``, a recognised dataset layout, or (``--from-rec``) a ``.rec`` that
the reference packed, into the port's ``.drec`` (``data/record.py``);
training and evaluation read it through ``--dataset-root``.

    python -m dspnet_torch.tools.im2rec --lst train.lst --root data --out data/train
    python -m dspnet_torch.tools.im2rec --dataset-root cityscapes --split train --out packed/train
    python -m dspnet_torch.tools.im2rec --from-rec train.rec --lst train.lst --out packed/train
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Pack a dataset into .drec records.")
    p.add_argument("--lst", help=".lst file written by Imdb.save_imglist")
    p.add_argument("--from-rec", help="MXNet-packed .rec (the reference's tools/im2rec.py output) to migrate "
                                      "one-way into .drec; --lst recovers paths and seg masks")
    p.add_argument("--root", default="", help="root joined to relative .lst paths")
    p.add_argument("--no-seg", action="store_true", help="skip the seg-mask lookup (.lst and --from-rec inputs)")
    p.add_argument("--dataset-root", help="dataset directory (layout detected)")
    p.add_argument("--split", default="train")
    p.add_argument("--out", required=True, help="output prefix (writes .drec + .idx)")
    args = p.parse_args(argv)

    from dspnet_torch.data import imdb, record

    if args.from_rec:
        from dspnet_torch.data import rec_import

        rec_import.convert_rec(args.from_rec, args.out, lst_path=args.lst, root=args.root,
                               find_seg=not args.no_seg)
        return
    if args.lst:
        index = imdb.load_imglist(args.lst, args.root, find_seg=not args.no_seg)
    elif args.dataset_root:
        index = imdb.load_index(args.dataset_root, args.split)
    else:
        p.error("one of --lst / --dataset-root / --from-rec is required")
    record.pack_records(index, args.out)


if __name__ == "__main__":
    main()
