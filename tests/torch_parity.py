"""Shared helpers for the tests of the PyTorch port: seeded numpy weights for
a flax module, handed to both packages, seeded NMS rows, and seeded data on
disk (a prepared Cityscapes layout, a raw gtFine tree, PNGs of any colour
type). jax is imported only where a flax module is read, so the other
helpers also serve the CUDA tests and ``chip_smoke.py`` on a machine
without jax."""

from __future__ import annotations

import struct
import zlib

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


#: a raw Cityscapes scene's labels: stuff first (large, drawn under the
#: rest), then things, '...group' labels, an id -1 class (license plate),
#: void classes and a label the table does not know
GTFINE_STUFF = ("road", "sidewalk", "building", "vegetation", "sky", "terrain", "fence", "pole")
GTFINE_THINGS = ("car", "car", "car", "person", "person", "rider", "bicycle", "truck", "bus", "motorcycle",
                 "train", "traffic sign", "traffic light", "cargroup", "persongroup", "bicyclegroup",
                 "license plate", "ego vehicle", "out of roi", "dynamic", "unknown thing")


def random_polygon(rng, hw, kind):
    """One polygon (list of [x, y] ints) in an (H, W) frame, reaching past
    the border at times: ``star`` (concave), ``tangle`` (self-intersecting),
    ``box``, or a degenerate ``point`` / ``hline`` / ``vline`` / ``pair``."""
    H, W = hw
    cx, cy = rng.uniform(-0.1 * W, 1.1 * W), rng.uniform(-0.1 * H, 1.1 * H)
    r = rng.uniform(4, 0.15 * min(H, W))
    if kind == "star":
        n = rng.randint(5, 40)
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        rad = r * rng.uniform(0.3, 1.0, n)
        pts = np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)], -1)
    elif kind == "tangle":
        pts = np.stack([cx, cy]) + rng.uniform(-r, r, (rng.randint(4, 10), 2))
    elif kind == "box":
        w, h = rng.uniform(2, r, 2)
        pts = np.array([[cx - w, cy - h], [cx + w, cy - h], [cx + w, cy + h], [cx - w, cy + h]])
    elif kind == "point":
        pts = np.array([[cx, cy]])
    elif kind == "hline":
        pts = np.array([[cx - r, cy], [cx + r, cy], [cx, cy]])
    elif kind == "vline":
        pts = np.array([[cx, cy - r], [cx, cy + r]])
    else:  # pair
        pts = np.array([[cx, cy], [cx + rng.uniform(-r, r), cy + rng.uniform(-r, r)]])
    return np.floor(pts).astype(int).tolist()


def gtfine_scene(rng, hw, n_objects):
    """The polygons JSON of one raw scene (the gtFine ``*_polygons.json``
    schema): ``n_objects`` objects, the stuff first, about one in ten thing
    marked ``deleted``."""
    H, W = hw
    objects = [{"label": "road", "polygon": [[-20, int(H * 0.55)], [W + 20, int(H * 0.5)],
                                             [W + 20, H + 20], [-20, H + 20]]},
               {"label": "sky", "polygon": [[0, 0], [W - 1, 0], [W - 1, int(H * 0.3)], [0, int(H * 0.35)]]}]
    kinds = ("star",) * 6 + ("tangle", "box", "box", "point", "hline", "vline", "pair")
    while len(objects) < n_objects:
        stuff = len(objects) < 8
        label = GTFINE_STUFF[rng.randint(len(GTFINE_STUFF))] if stuff else \
            GTFINE_THINGS[rng.randint(len(GTFINE_THINGS))]
        obj = {"label": label, "polygon": random_polygon(rng, hw, kinds[rng.randint(len(kinds))])}
        if not stuff and rng.rand() < 0.1:
            obj["deleted"] = 1
        objects.append(obj)
    return {"imgHeight": H, "imgWidth": W, "objects": objects}


def write_gtfine_tree(root, jpeg_dir, splits, hw=(1024, 2048), seed=0, n_objects=100, jpeg_scale=0.5,
                      workers=1):
    """Write a raw Cityscapes release under ``root``:
    ``gtFine/{split}/{city}/{stem}_gtFine_polygons.json`` and the 16-bit
    ``disparity/{split}/{city}/{stem}_disparity.png``, both at ``hw`` (the
    release's 1024x2048 by default), and into ``jpeg_dir`` the scene's image
    at ``jpeg_scale`` as ``convert_cityscapes.sh`` makes it
    (``{stem}_leftImg8bit.jpg``, the port's encoder at quality 95, 4:2:0):
    the trainId colours of the polygons plus noise. ``splits``: {split:
    number of scenes}. Returns {split: [stems]}."""
    import json
    import os
    from concurrent.futures import ThreadPoolExecutor

    from dspnet_torch.data import image_io, jpeg
    from dspnet_torch.data.cs_labels import name2label, train_id_palette
    from dspnet_torch.utils.raster import fill_poly

    H, W = hw
    h, w = int(round(H * jpeg_scale)), int(round(W * jpeg_scale))
    rng = np.random.RandomState(seed)
    os.makedirs(jpeg_dir, exist_ok=True)
    out, jobs = {}, []
    for split, n in splits.items():
        out[split] = []
        for i in range(n):
            city = f"{split}city{i % 3}"
            stem = f"{city}_{i:06d}_000019"
            out[split].append(stem)
            yy = np.linspace(0.0, 1.0, H)[:, None]
            disp = 2000 + 18000 * yy ** 2 + rng.uniform(0, 400, (H, W))
            jobs.append((split, city, stem, gtfine_scene(rng, hw, n_objects), disp.astype(np.uint16),
                         rng.randint(0, 24, (h, w, 3))))

    palette = train_id_palette()[:, ::-1].astype(np.int64)  # BGR

    def write(job):
        split, city, stem, scene, disp, noise = job
        for kind, name, data in (("gtFine", "gtFine_polygons.json", None), ("disparity", "disparity.png", disp)):
            d = os.path.join(root, kind, split, city)
            os.makedirs(d, exist_ok=True)
            if data is None:
                with open(os.path.join(d, f"{stem}_{name}"), "w") as f:
                    json.dump(scene, f)
            else:
                image_io.imwrite(os.path.join(d, f"{stem}_{name}"), data)
        tid = np.full((h, w), 255, np.uint8)
        for obj in scene["objects"]:
            label = name2label.get(obj["label"].removesuffix("group"))
            if label is not None and 0 <= label.trainId < 255 and not obj.get("deleted"):
                pts = np.floor(np.asarray(obj["polygon"], np.float64) * jpeg_scale).astype(np.int32)
                fill_poly(tid, pts, label.trainId)
        img = np.clip(palette[tid] + noise, 0, 255).astype(np.uint8)
        with open(os.path.join(jpeg_dir, f"{stem}_leftImg8bit.jpg"), "wb") as f:
            f.write(jpeg.encode(img, 95))

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(write, jobs))
    return out


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def make_png(samples, color, depth, palette=None, trns=None):
    """PNG bytes of ``samples`` (H, W) or (H, W, C) at any colour type and
    bit depth, with an optional ``PLTE`` and ``tRNS``, every row with filter
    0: the forms the port's encoder does not write (VOC's palette masks
    among them)."""
    s = np.asarray(samples)
    s = s[..., None] if s.ndim == 2 else s
    h, w, _ = s.shape
    if depth == 16:
        rows = s.astype(">u2").reshape(h, -1).view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = s.astype(np.uint8).reshape(h, -1)
    else:
        per = 8 // depth
        flat = s.reshape(h, -1).astype(np.uint8)
        flat = np.concatenate([flat, np.zeros((h, (-flat.shape[1]) % per), np.uint8)], 1).reshape(h, -1, per)
        rows = (flat << (np.arange(per)[::-1] * depth).astype(np.uint8)).sum(-1).astype(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def flat_tree(tree) -> dict:
    """{keystr path: numpy leaf} of a pytree."""
    import jax

    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def jax_solver_state(js, variables, hw):
    """A JAX ``MultiTaskSolver`` state holding the numpy ``variables``
    (params and batch_stats) and a fresh optimizer state."""
    import jax
    import jax.numpy as jnp

    st = js.init_state(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3)))
    params = jax.tree.map(jnp.asarray, variables["params"])
    return st.replace(params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                      opt_state=js.tx.init(params))


def assert_steps_match_jax(init_params, jax_state, jax_metrics, port_variables, port_metrics, valid_px=None,
                           init_stats=None):
    """The port's solver steps against the JAX solver's from the same
    ``init_params`` on the same batches: every step's metrics within rtol
    1e-4, each parameter's change within 4% of the largest change of the
    JAX steps over the model (the ReLU-switch bound of
    test_torch_train.py), every running statistic within 1e-3 * max|ref| of
    its tensor. ``port_variables`` is the port's state as a flax tree
    (``to_flax_variables``); the metrics are one dict per step.
    ``valid_px``, each step's count of labelled seg pixels, lets the seg
    accuracy (a count of argmax hits) differ by one pixel, where a batch
    holds a near-tie that float32 rounding decides. With ``init_stats``
    (the running statistics before the steps, as a flax tree) each running
    statistic's change is held instead, within 1e-3 of the largest change
    of its kind (mean, var) over the model, as the parameters are: from
    fresh statistics (0 and 1) a channel's mean is the batch means alone,
    and near zero its own scale says nothing."""
    import jax

    assert len(port_metrics) == len(jax_metrics)
    for step, (got_m, want_m) in enumerate(zip(port_metrics, jax_metrics)):
        assert set(got_m) == set(want_m)
        for k in want_m:
            atol = 1.0 / valid_px[step] if valid_px is not None and k == "seg_accuracy" else 0.0
            np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-4, atol=atol, err_msg=k)
    init = flat_tree(init_params)
    after = flat_tree(jax.tree.map(np.asarray, jax_state.params))
    got = flat_tree(port_variables["params"])
    biggest = max(np.abs(after[k] - v).max() for k, v in init.items())
    assert biggest > 0
    for k, v in init.items():
        np.testing.assert_allclose(got[k] - v, after[k] - v, rtol=0, atol=0.04 * biggest, err_msg=k)
    stats = flat_tree(port_variables["batch_stats"])
    want = flat_tree(jax.tree.map(np.asarray, jax_state.batch_stats))
    if init_stats is None:
        for k, w in want.items():
            np.testing.assert_allclose(stats[k], w, rtol=0, atol=1e-3 * np.abs(w).max(), err_msg=k)
        return
    init = flat_tree(init_stats)
    kind = lambda k: k.rsplit("[", 1)[-1]  # noqa: E731
    largest = {}
    for k, w in want.items():
        largest[kind(k)] = max(largest.get(kind(k), 0.0), float(np.abs(w - init[k]).max()))
    for k, w in want.items():
        np.testing.assert_allclose(stats[k] - init[k], w - init[k], rtol=0, atol=1e-3 * largest[kind(k)], err_msg=k)
