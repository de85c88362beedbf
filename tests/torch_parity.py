"""Shared helpers for the tests of the PyTorch port: seeded numpy weights for
a flax module, handed to both packages, and seeded NMS rows. jax is imported
only where a flax module is read, so the NMS helpers also serve the CUDA
tests on a machine without jax."""

from __future__ import annotations

import numpy as np


def random_flax_variables(module, input_shape, seed: int, **init_kwargs) -> dict:
    """Every leaf of ``module``'s variable tree drawn from a seeded numpy
    generator: kernels N(0, 1/fan_in), BatchNorm scale and var in
    [0.5, 1.5) (var positive), biases and means N(0, 0.1). Returns nested
    dicts of float32 numpy arrays."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(input_shape, jnp.float32), **init_kwargs))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            x = rng.normal(0.0, np.sqrt(1.0 / np.prod(shape[:-1])), shape)
        elif name in ("scale", "var"):
            x = rng.uniform(0.5, 1.5, shape)
        elif name in ("bias", "mean"):
            x = rng.normal(0.0, 0.1, shape)
        else:
            raise KeyError(name)
        return x.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(np.asarray, _as_dict(tree))


def _as_dict(tree):
    if hasattr(tree, "items"):
        return {k: _as_dict(v) for k, v in tree.items()}
    return tree


def random_nms_rows(rng, B, K):
    """Random (boxes, ids, valid) top-K rows, as tests/test_nms_pallas.py."""
    cx = rng.uniform(0.1, 0.9, (B, K))
    cy = rng.uniform(0.1, 0.9, (B, K))
    w = rng.uniform(0.05, 0.4, (B, K))
    h = rng.uniform(0.05, 0.4, (B, K))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)
    ids = rng.randint(0, 3, (B, K)).astype(np.float32)
    valid = rng.rand(B, K) > 0.2
    ids = np.where(valid, ids, -1.0).astype(np.float32)
    return boxes, ids, valid


#: rows whose IoUs sit exactly on the thresholds in float32: a box and its
#: duplicate (IoU 1), a half-width box (IoU 0.5 with the unit box), a
#: quarter-width one (0.25), and zero-area boxes (IoU 0, union 0 between two)
BOUNDARY_BOXES = np.array([
    [0.0, 0.0, 1.0, 1.0],
    [0.0, 0.0, 0.5, 1.0],
    [0.0, 0.0, 1.0, 1.0],
    [0.0, 0.0, 0.25, 1.0],
    [0.5, 0.5, 0.5, 0.5],
    [0.5, 0.5, 0.5, 0.5],
    [0.25, 0.0, 0.75, 1.0],
    [0.0, 0.5, 1.0, 1.0],
], np.float32)


def with_boundary_rows(boxes, ids, valid):
    """Overwrite the first rows of every image with BOUNDARY_BOXES, all valid
    and of class 0, so same-class suppression is decided on them."""
    n = len(BOUNDARY_BOXES)
    boxes, ids, valid = boxes.copy(), ids.copy(), valid.copy()
    boxes[:, :n] = BOUNDARY_BOXES
    ids[:, :n] = 0.0
    valid[:, :n] = True
    return boxes, ids, valid


def near_threshold_rows(rng, B, K, thr):
    """The unit box, then boxes [0, 0, w, h] with w * h within an ulp of
    ``thr``, all valid and of class 0: their IoU with the unit box,
    w * h / ((1 + w * h) - w * h), sits within 2^-21 of ``thr``, so the
    rounding of the division decides ``iou >= thr``."""
    w = rng.uniform(thr, 1.0, (B, K)).astype(np.float32)
    h = np.nextafter((np.float32(thr) / w).astype(np.float32),
                     np.float32(2.0) * rng.randint(0, 2, (B, K))).astype(np.float32)
    z = np.zeros_like(w)
    boxes = np.stack([z, z, w, h], -1)
    boxes[:, 0] = (0.0, 0.0, 1.0, 1.0)
    return boxes, np.zeros((B, K), np.float32), np.ones((B, K), bool)


def write_cityscapes_layout(root, splits, hw=(64, 128), seed=0, max_objects=6, encode=None, workers=1):
    """Write a prepared-Cityscapes directory under ``root``, the layout of
    ``dspnet_tpu/tools/prepare_cityscapes.py``: ``JPEGImages/{id}.jpg`` (id =
    ``{stem}_leftImg8bit``), PASCAL-style ``Annotations/{id}.xml`` with
    ``<distance>`` in metres, ``SegmentationClass/{stem}_gtFine_labelTrainIds.png``,
    ``SegmentationInstance/{stem}_gtFine_instanceIds.png``,
    ``Disparity/{stem}_disparity.png`` and ``ImageSets/Main/{split}.txt``.

    ``splits``: {split: number of images}. The scenes are the port's
    ``synthetic.make_example`` from ``seed``; ``encode`` turns a BGR image
    into JPEG bytes (default: the port's encoder at quality 95, 4:2:0);
    ``workers`` threads write the files. Returns {split: [ids]}."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from dspnet_torch.data import image_io, jpeg, synthetic
    from dspnet_torch.data.cs_labels import DET_CLASSES

    encode = encode or (lambda img: jpeg.encode(img, 95))
    H, W = hw
    for d in ("JPEGImages", "Annotations", "SegmentationClass", "SegmentationInstance", "Disparity",
              os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rng = np.random.RandomState(seed)
    out, jobs = {}, []
    for split, n in splits.items():
        ids = []
        for i in range(n):
            stem = f"{split}city_{i:06d}_000019"
            ids.append(stem + "_leftImg8bit")
            jobs.append((stem, synthetic.make_example(rng, hw, rng.randint(1, max_objects + 1))))
        with open(os.path.join(root, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
        out[split] = ids

    def write(job):
        stem, (img, label, seg, disp) = job
        iid = stem + "_leftImg8bit"
        with open(os.path.join(root, "JPEGImages", iid + ".jpg"), "wb") as f:
            f.write(encode(img))
        image_io.imwrite(os.path.join(root, "SegmentationClass", stem + "_gtFine_labelTrainIds.png"), seg)
        image_io.imwrite(os.path.join(root, "SegmentationInstance", stem + "_gtFine_instanceIds.png"),
                         synthetic.instance_ids(label, (H, W)))
        image_io.imwrite(os.path.join(root, "Disparity", stem + "_disparity.png"), disp)
        objs = "".join(
            "<object><name>{}</name><difficult>0</difficult><bndbox><xmin>{}</xmin><ymin>{}</ymin>"
            "<xmax>{}</xmax><ymax>{}</ymax></bndbox><distance>{}</distance></object>".format(
                DET_CLASSES[int(r[0])], int(round(r[1] * W)), int(round(r[2] * H)),
                int(round(r[3] * W)), int(round(r[4] * H)), int(round(r[5] * 255.0)))
            for r in label)
        with open(os.path.join(root, "Annotations", iid + ".xml"), "w") as f:
            f.write(f"<annotation><filename>{iid}.jpg</filename><size><width>{W}</width>"
                    f"<height>{H}</height><depth>3</depth></size>{objs}</annotation>")

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(write, jobs))
    return out
