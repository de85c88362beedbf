"""Synthetic Cityscapes-format fixtures (counterpart of
``dspnet_tpu/data/synthetic.py``).

A tiny dataset in the on-disk contract of the JAX package: street-like
images, trainId segmentation PNGs, disparity PNGs (for the depth-eval
oracle), optional instanceIds PNGs (for the instance-level evaluator) and
the (cls, corners, distance) label matrix, all from one numpy seed.
``make_example`` equals the JAX one bit for bit on the same seed.

``build_dataset`` writes the JAX package's file names
(``JPEGImages/…_leftImg8bit.jpg``, ``SegmentationClass/…_labelTrainIds.png``,
``Disparity/…_disparity.png``, ``SegmentationInstance/…_instanceIds.png``)
and formats: the images are baseline JPEG at quality 95 with 4:2:0 chroma,
as ``cv2.imwrite`` writes them there, from the port's own encoder
(``data/jpeg.py``); the bytes differ from cv2's, the format does not.
``build_voc_dataset`` writes the JAX package's synthetic PASCAL-VOC devkit
tree the same way (the same scenes, XML and split files from one seed).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from dspnet_torch.data import image_io
from dspnet_torch.data.cs_labels import DET_CLASSES, name2label, trainId2label
from dspnet_torch.data.iterator import Sample, SampleIndex

# disparity -> meters constant used across the reference
# (train/metric.py:222, data/cityscapes/disparity2distance.py:67)
DISPARITY_SCALE = 2200.0 * 75.0

# det class index -> seg trainId (person 11 ... bicycle 18)
_DET_TRAINID = [name2label[n].trainId for n in DET_CLASSES]
# distinctive BGR per trainId: the official Cityscapes palette reversed
_TRAINID_BGR = {
    t: tuple(int(c) for c in reversed(trainId2label[t].color))
    for t in range(19)
}


def make_example(
    rng: np.random.RandomState, hw: Tuple[int, int], num_objects: int, num_classes: int = 8
):
    """Returns (img BGR uint8, label rows (n, 6) normalized, seg trainId uint8,
    disparity uint16): a street scene painting all 19 trainId classes, with
    ``num_objects`` det-class boxes on the road (the JAX package's draws, in
    its order)."""
    H, W = hw
    img = np.zeros((H, W, 3), np.uint8)
    seg = np.full((H, W), 255, np.uint8)
    disparity = np.zeros((H, W), np.uint16)
    disparity[:] = int(DISPARITY_SCALE / 150.0)  # far background

    def paint(y1, y2, x1, x2, tid):
        y1, y2 = max(0, y1), min(H, y2)
        x1, x2 = max(0, x1), min(W, x2)
        if y2 <= y1 or x2 <= x1:
            return
        seg[y1:y2, x1:x2] = tid
        img[y1:y2, x1:x2] = _TRAINID_BGR[tid]

    horizon = H // 3 + rng.randint(-H // 16, H // 16 + 1)

    # sky above the horizon
    paint(0, horizon, 0, W, 10)
    # buildings rising above the horizon
    for _ in range(rng.randint(2, 5)):
        bw, bh = rng.randint(W // 10, W // 4), rng.randint(H // 6, max(H // 6 + 1, horizon))
        x = rng.randint(0, W - bw)
        paint(horizon - bh, horizon, x, x + bw, 2)
    # vegetation blobs straddling the horizon
    for _ in range(rng.randint(1, 4)):
        vw, vh = rng.randint(W // 16, W // 6), rng.randint(H // 12, H // 5)
        x = rng.randint(0, W - vw)
        paint(horizon - vh // 2, horizon + vh // 2, x, x + vw, 8)
    # wall slab on the left edge, fence on the right (always present)
    wall_h = max(3, H // 10)
    paint(horizon - wall_h, horizon, 0, rng.randint(W // 8, W // 3), 3)
    fx = rng.randint(W // 2, W - W // 8)
    paint(horizon - max(2, H // 12), horizon, fx, W, 4)
    # terrain strip then road below
    th = max(2, H // 24)
    road_top = horizon + th
    paint(horizon, road_top, 0, W, 9)
    paint(road_top, H, 0, W, 0)
    # sidewalks flanking the road
    sw = max(3, W // 10)
    paint(road_top, H, 0, sw, 1)
    paint(road_top, H, W - sw, W, 1)
    # poles crossing the horizon; the first two carry a traffic light / sign
    n_poles = rng.randint(2, 4)
    for pi in range(n_poles):
        pw = max(2, W // 80)
        px = rng.randint(sw, W - sw - pw)
        ph = rng.randint(H // 5, H // 3)
        paint(horizon - ph, road_top + H // 12, px, px + pw, 5)
        s = max(3, H // 24)
        if pi == 0:  # traffic light box at the pole top
            paint(horizon - ph, horizon - ph + 2 * s, px - s // 2, px + pw + s // 2, 6)
        elif pi == 1:  # traffic sign square
            paint(horizon - ph, horizon - ph + s, px - s // 2, px + pw + s // 2, 7)

    rows = []
    for _ in range(num_objects):
        cls = rng.randint(0, num_classes)
        w = rng.randint(max(6, W // 16), max(8, W // 4))
        h = rng.randint(max(6, H // 16), max(8, H // 4))
        x1 = rng.randint(0, W - w)
        y1 = rng.randint(max(0, horizon - h // 2), H - h)
        # distance inversely tied to apparent size (learnable signal)
        dist_m = float(np.clip(30.0 * W / 8.0 / max(w, h), 5.0, 150.0))
        tid = _DET_TRAINID[cls % len(_DET_TRAINID)]
        # the JAX package's filled cv2.rectangle, (x1, y1)-(x1+w-1, y1+h-1)
        # inclusive: the box lies inside the image, so it is this slice
        img[y1 : y1 + h, x1 : x1 + w] = _TRAINID_BGR[tid]
        seg[y1 : y1 + h, x1 : x1 + w] = tid
        disparity[y1 : y1 + h, x1 : x1 + w] = int(DISPARITY_SCALE / dist_m)
        rows.append(
            [cls, x1 / W, y1 / H, (x1 + w) / W, (y1 + h) / H, min(1.0, dist_m / 255.0)]
        )
    label = np.asarray(rows, np.float32) if rows else np.zeros((0, 6), np.float32)
    return img, label, seg, disparity


def build_dataset(
    root: str,
    num_samples: int = 8,
    hw: Tuple[int, int] = (256, 512),
    max_objects: int = 6,
    seed: int = 233,
    with_disparity: bool = True,
    with_instances: bool = False,
    texture: bool = False,
) -> SampleIndex:
    """Write a synthetic dataset under ``root`` and return its SampleIndex.

    ``with_instances`` also writes gtFine-style ``*_instanceIds.png``
    (labelId * 1000 + instance index per box, in draw order, so later boxes
    occlude earlier ones) under SegmentationInstance/, for the
    instance-level evaluator. ``texture`` lays :func:`texture_offsets` over each
    image, from a generator of its own (seed + 1), so that the scenes,
    labels and masks stay those of ``seed``: flat colours hide a warp's
    sub-pixel errors, which a textured image shows."""
    rng = np.random.RandomState(seed)
    texture_rng = np.random.RandomState(seed + 1) if texture else None
    os.makedirs(os.path.join(root, "JPEGImages"), exist_ok=True)
    os.makedirs(os.path.join(root, "SegmentationClass"), exist_ok=True)
    if with_disparity:
        os.makedirs(os.path.join(root, "Disparity"), exist_ok=True)
    if with_instances:
        os.makedirs(os.path.join(root, "SegmentationInstance"), exist_ok=True)
    samples = []
    for i in range(num_samples):
        img, label, seg, disp = make_example(rng, hw, rng.randint(1, max_objects + 1))
        if texture_rng is not None:
            img = np.clip(img + texture_offsets(texture_rng, hw), 0, 255).astype(np.uint8)
        ipath = os.path.join(root, "JPEGImages", f"synth_{i:04d}_leftImg8bit.jpg")
        spath = os.path.join(root, "SegmentationClass", f"synth_{i:04d}_gtFine_labelTrainIds.png")
        image_io.imwrite(ipath, img)
        image_io.imwrite(spath, seg)
        if with_disparity:
            image_io.imwrite(os.path.join(root, "Disparity", f"synth_{i:04d}_disparity.png"), disp)
        if with_instances:
            image_io.imwrite(os.path.join(root, "SegmentationInstance", f"synth_{i:04d}_gtFine_instanceIds.png"),
                             instance_ids(label, seg.shape))
        samples.append(Sample(ipath, SampleIndex.pad_label(label), spath))
    return SampleIndex(samples)


def texture_offsets(rng: np.random.RandomState, hw: Tuple[int, int]) -> np.ndarray:
    """(H, W, 3) float32 offsets with the look of a photograph's texture:
    value noise bilinear over cells of 64, 16 and 4 pixels (amplitudes 24, 20
    and 16), shared by the channels, plus a grain of +-10 in each channel. Its
    mean absolute step between neighbouring pixels is several grey levels,
    as in street photographs, so a shift of half a pixel moves the image by
    more than one level on average."""
    H, W = hw
    plane = np.zeros((H, W), np.float32)
    for cell, amp in ((64, 24.0), (16, 20.0), (4, 16.0)):
        grid = rng.uniform(-amp, amp, (H // cell + 2, W // cell + 2)).astype(np.float32)
        y, x = np.arange(H, dtype=np.float32) / cell, np.arange(W, dtype=np.float32) / cell
        y0, x0 = y.astype(np.int64), x.astype(np.int64)
        fy, fx = (y - y0)[:, None], (x - x0)[None, :]
        top = grid[y0][:, x0] * (1 - fx) + grid[y0][:, x0 + 1] * fx
        bottom = grid[y0 + 1][:, x0] * (1 - fx) + grid[y0 + 1][:, x0 + 1] * fx
        plane += top * (1 - fy) + bottom * fy
    return plane[..., None] + rng.uniform(-10, 10, (H, W, 3)).astype(np.float32)


def instance_ids(label: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """(H, W) uint16 gtFine instanceIds of a label's boxes: labelId * 1000 +
    the box's index among its class, painted in row order over 0."""
    H, W = hw
    inst = np.zeros((H, W), np.uint16)
    counts = [0] * len(DET_CLASSES)
    for row in label:
        cid = int(row[0])
        lid = name2label[DET_CLASSES[cid]].id
        x1, y1 = int(round(row[1] * W)), int(round(row[2] * H))
        x2, y2 = int(round(row[3] * W)), int(round(row[4] * H))
        inst[y1:y2, x1:x2] = lid * 1000 + counts[cid]
        counts[cid] += 1
    return inst


def class_names():
    return list(DET_CLASSES)


def build_voc_dataset(
    root: str,
    num_samples: int = 8,
    hw: Tuple[int, int] = (96, 96),
    max_objects: int = 4,
    seed: int = 233,
    year: str = "",
    splits=("train", "val"),
    difficult_frac: float = 0.2,
) -> str:
    """Write a synthetic PASCAL-VOC devkit tree under ``root`` and return
    the devkit root (``root``): ``{root}/VOC{year}/{JPEGImages, Annotations,
    ImageSets/Main}``, what ``data.imdb.PascalVoc`` (and ``load_index``'s VOC
    fallback at year '') reads. Scenes from :func:`make_example`; object
    names are the 8 Cityscapes det classes (pass them as --class-names);
    ``difficult_frac`` of the objects are marked difficult. The draws, the
    XML and the split files are the JAX package's
    (``dspnet_tpu/data/synthetic.py::build_voc_dataset``); the JPEGs come
    from the port's encoder (q95 4:2:0)."""
    H, W = hw
    base = os.path.join(root, f"VOC{year}")
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    for split in splits:
        ids = []
        for i in range(num_samples):
            iid = f"{split}_{i:04d}"
            ids.append(iid)
            img, label, _, _ = make_example(rng, hw, rng.randint(1, max_objects + 1))
            image_io.imwrite(os.path.join(base, "JPEGImages", iid + ".jpg"), img)
            objs = []
            for row in label:
                difficult = int(rng.rand() < difficult_frac)
                objs.append(
                    "<object><name>{}</name><difficult>{}</difficult>"
                    "<bndbox><xmin>{}</xmin><ymin>{}</ymin>"
                    "<xmax>{}</xmax><ymax>{}</ymax></bndbox></object>".format(
                        DET_CLASSES[int(row[0])], difficult,
                        int(row[1] * W), int(row[2] * H), int(row[3] * W), int(row[4] * H)))
            with open(os.path.join(base, "Annotations", iid + ".xml"), "w") as f:
                f.write("<annotation><size><width>{}</width><height>{}"
                        "</height><depth>3</depth></size>{}</annotation>".format(W, H, "".join(objs)))
        with open(os.path.join(base, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    return root
