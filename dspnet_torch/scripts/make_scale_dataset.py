"""Build the full-scale dataset of ``scale_run.sh`` (counterpart of
``scripts/make_scale_dataset.py``).

Real Cityscapes is 2975 train / 500 val at raw 1024x2048 (the reference's
run_multi.sh trains on that split). This writes synthetic samples at that
scale through ``dspnet_torch.data.synthetic`` (raw-resolution JPEGs, trainId
seg PNGs, disparity PNGs, instanceIds PNGs for the val split), then packs
each split into a ``.drec`` store with ``dspnet_torch.data.record``, the
JAX package's layout, so training reads the packed-record path
(``load_index`` prefers ``{split}.drec``).

Usage:
    python dspnet_torch/scripts/make_scale_dataset.py [root] [n_train] [n_val]
    # defaults: dspnet_scale 2975 500
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from dspnet_torch.data import record, synthetic  # noqa: E402


def build_split(root, split, n, seed, with_instances):
    t0 = time.time()
    index = synthetic.build_dataset(os.path.join(root, split), num_samples=n, hw=(1024, 2048), max_objects=12,
                                    seed=seed, with_disparity=True, with_instances=with_instances)
    t1 = time.time()
    prefix = os.path.join(root, split)
    record.pack_records(index, prefix, quiet=True)
    print(f"{split}: {n} images in {t1 - t0:.0f}s, packed "
          f"{os.path.getsize(prefix + '.drec') / 1e9:.2f} GB .drec in {time.time() - t1:.0f}s", flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0] if len(argv) > 0 else "dspnet_scale"
    n_train = int(argv[1]) if len(argv) > 1 else 2975
    n_val = int(argv[2]) if len(argv) > 2 else 500
    os.makedirs(root, exist_ok=True)
    build_split(root, "train", n_train, seed=233, with_instances=False)
    build_split(root, "val", n_val, seed=91, with_instances=True)
    print(f"done under {root}")


if __name__ == "__main__":
    main()
