"""The plain-SSD loader of the PyTorch port vs the JAX package and cv2, on the
CPU: the numpy copies of the samplers and the config presets, cv2's five
uint8 resizes, cv2's 8-bit colour conversions and the colour jitter, and
whole ``DetIterator`` batches on one synthetic VOC tree and seed.

cv2 on x86 hands ``INTER_CUBIC`` to Intel IPP when it is built in
(``cv2.ipp.useIPP()``), whose pixels are not cv2's own rule: the port
reproduces cv2's own rule, so the bit-for-bit comparisons run with IPP off,
and ``test_cubic_with_ipp_within_one_level`` states the distance to IPP's
(at most one level, on under 6% of the values). Through the colour jitter
that level can grow: ``test_det_iterator_with_ipp_within_stated_tolerance``
holds whole batches to the numbers measured with IPP on."""

import contextlib

import cv2
import numpy as np
import pytest
import torch

from dspnet_tpu.data import augment as jax_aug
from dspnet_tpu.data import synthetic as jax_synthetic
from dspnet_tpu.data.det_iterator import DetIterator as JaxDetIterator
from dspnet_tpu.data.imdb import PascalVoc as JaxPascalVoc
from dspnet_tpu.utils import config as jax_config
from dspnet_torch.data import augment, device_pipeline, image_io, synthetic
from dspnet_torch.data import rand_sampler as rs
from dspnet_torch.data.det_iterator import INTERP_METHODS, DetIterator, ImagePlan, apply_plan
from dspnet_torch.data.imdb import PascalVoc
from dspnet_torch.utils import config

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

INTERPS = {"nearest": cv2.INTER_NEAREST, "linear": cv2.INTER_LINEAR, "cubic": cv2.INTER_CUBIC,
           "area": cv2.INTER_AREA, "lanczos4": cv2.INTER_LANCZOS4}


@contextlib.contextmanager
def ipp(on: bool):
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(on)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


def _labels(rng, n):
    out = np.full((200, 6), -1.0, np.float32)
    x1 = rng.uniform(0, 0.7, n)
    y1 = rng.uniform(0, 0.7, n)
    out[:n, 0] = rng.randint(0, 8, n)
    out[:n, 1], out[:n, 2] = x1, y1
    out[:n, 3] = x1 + rng.uniform(0.05, 0.3, n)
    out[:n, 4] = y1 + rng.uniform(0.05, 0.3, n)
    out[:n, 5] = 0.0
    return out


# --------------------------------------------------------------- copies


def test_config_presets_match_jax():
    """``config_as_dict`` of the two trees: the same keys and values, the
    samplers compared by their attributes."""
    got, want = config.config_as_dict(config.cfg), jax_config.config_as_dict(jax_config.cfg)
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith(("rand_crop_samplers", "rand_pad")):
            g = got[k] if isinstance(got[k], list) else [got[k]]
            w = v if isinstance(v, list) else [v]
            assert [None if x is None else vars(x) for x in g] == [None if x is None else vars(x) for x in w], k
        else:
            assert got[k] == v, k
    assert config.cfg.train.seed == 233 and config.cfg.train.inter_method == 10
    d = config.DotDict(a=1)
    d.b = 2
    assert d == {"a": 1, "b": 2} and d.b == 2
    with pytest.raises(AttributeError):
        d.missing


@pytest.mark.parametrize("seed", range(4))
def test_samplers_match_jax(seed):
    """Every preset sampler (five croppers, the padder) draws the same
    boxes and labels bit for bit from the same RandomState, and leaves it in
    the same state."""
    label = _labels(np.random.RandomState(seed), 1 + seed % 4)
    samplers = config.cfg.train.rand_crop_samplers + [config.cfg.train.rand_pad]
    jax_samplers = jax_config.cfg.train.rand_crop_samplers + [jax_config.cfg.train.rand_pad]
    r1, r2 = np.random.RandomState(100 + seed), np.random.RandomState(100 + seed)
    for got_s, want_s in zip(samplers, jax_samplers):
        assert type(got_s).__name__ == type(want_s).__name__
        got, want = got_s.sample(label, r1), want_s.sample(label, r2)
        assert len(got) == len(want)
        for (gb, gl), (wb, wl) in zip(got, want):
            assert gb == wb
            np.testing.assert_array_equal(gl, wl)
    assert r1.rand() == r2.rand()
    assert rs.RandCropper(min_scale=0.5).sample(label[:0], np.random.RandomState(0)) == []


# --------------------------------------------------------------- resizes

RESIZE_CASES = [((375, 500), (300, 300)),  # down, mixed factors
                ((100, 150), (300, 300)),  # up
                ((375, 500), (480, 640)),  # up, non-integer
                ((97, 211), (300, 301)),  # up in y, mixed in x
                ((612, 433), (300, 300)),  # down
                ((1500, 2000), (300, 300)),  # the pad canvas's 4x
                ((600, 600), (300, 300)),  # exactly 2x
                ((900, 300), (300, 300)),  # 3x in y, 1x in x
                ((7, 5), (96, 96)), ((1, 1), (3, 4))]


@pytest.mark.parametrize("interp", sorted(INTERPS))
def test_resize_equals_cv2(interp):
    """``device_pipeline.resize`` against ``cv2.resize`` bit for bit for
    each of the five interpolations, up, down, mixed and integer factors
    (cubic against cv2's own rule, IPP off)."""
    rng = np.random.RandomState(len(interp))
    with ipp(False):
        for src, dst in RESIZE_CASES:
            img = rng.randint(0, 256, src + (3,)).astype(np.uint8)
            want = cv2.resize(img, dst[::-1], interpolation=INTERPS[interp])
            got = device_pipeline.resize(torch.from_numpy(img), dst, INTERPS[interp])
            assert got.dtype == torch.uint8 and tuple(got.shape) == dst + (3,)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{interp} {src} -> {dst}")


def test_cubic_with_ipp_within_one_level():
    """cv2's default on x86 (IPP on) against the port's cubic: at most one
    level apart, on under 6% of the values (measured 1.4% downscaling, 4.7%
    at 375x500 -> 480x640). The other four interpolations are the same with
    and without IPP."""
    rng = np.random.RandomState(1)
    with ipp(True):
        for src, dst in RESIZE_CASES[:6]:
            img = rng.randint(0, 256, src + (3,)).astype(np.uint8)
            want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_CUBIC)
            got = device_pipeline.resize(torch.from_numpy(img), dst, cv2.INTER_CUBIC).numpy()
            d = np.abs(got.astype(int) - want)
            assert d.max() <= 1 and (d > 0).mean() < 0.06, (src, dst, d.max(), (d > 0).mean())
            for flag in (cv2.INTER_NEAREST, cv2.INTER_LINEAR, cv2.INTER_AREA, cv2.INTER_LANCZOS4):
                np.testing.assert_array_equal(device_pipeline.resize(torch.from_numpy(img), dst, flag).numpy(),
                                              cv2.resize(img, dst[::-1], interpolation=flag))


def test_nearest_index_equals_cv2_at_every_size():
    """``image_io.nearest_index`` (the predownscale masks and the device
    nearest resize) against cv2's INTER_NEAREST over 133 x 37 size pairs,
    up and down; the exact rational floor(d * src / dst) differs from cv2
    at 203 of these 4,921 pairs."""
    for src in range(1, 400, 3):
        row = (np.arange(src) % 251).astype(np.uint8)[None, :].repeat(2, 0)
        for dst in range(1, 400, 11):
            want = cv2.resize(row, (dst, 2), interpolation=cv2.INTER_NEAREST)
            np.testing.assert_array_equal(row[:, image_io.nearest_index(src, dst)], want, err_msg=f"{src}->{dst}")
            np.testing.assert_array_equal(image_io.resize_nearest(row.T, (dst, 2)), want.T)


def test_resize_batches_and_refuses_unknown_codes():
    img = np.random.RandomState(0).randint(0, 256, (2, 40, 50, 3)).astype(np.uint8)
    for flag in INTERPS.values():
        got = device_pipeline.resize(torch.from_numpy(img), (33, 61), flag)
        assert got.shape == (2, 33, 61, 3)
        np.testing.assert_array_equal(got[1].numpy(), device_pipeline.resize(torch.from_numpy(img[1]), (33, 61),
                                                                             flag).numpy())
    with pytest.raises(ValueError, match="interpolation"):
        device_pipeline.resize(torch.from_numpy(img), (10, 10), 7)


# --------------------------------------------------------------- colour


def _hsv2bgr_block() -> int:
    """The pixels per block of this cv2's vector HSV2BGR loop: in a row of
    HSV (0, 1, 1) the vector loop gives blue 0 (it truncates 0.996), the
    scalar tail 1 (it rounds)."""
    for w in range(1, 257):
        row = np.tile(np.array([0, 1, 1], np.uint8), (1, w, 1))
        if cv2.cvtColor(row, cv2.COLOR_HSV2BGR)[0, 0, 0] == 0:
            return w
    raise AssertionError("no vector block up to 256 pixels")


@pytest.fixture(scope="module")
def cv2_block():
    block = _hsv2bgr_block()
    assert block == augment.HSV2BGR_BLOCK, (block, augment.HSV2BGR_BLOCK)
    return block


def test_bgr_to_hsv_and_gray_equal_cv2_on_every_colour():
    """All 2^24 BGR values, in rows of 4096 and of 31 (cv2's vector loop and
    its scalar tail)."""
    v = np.arange(256)
    b, g, r = np.meshgrid(v, v, v, indexing="ij")
    img = np.stack([b, g, r], -1).astype(np.uint8)
    for shape in ((4096, 4096, 3), (-1, 31, 3)):
        x = img.reshape(-1, 3)
        x = np.concatenate([x, x[: (-len(x)) % 31]]).reshape(shape) if shape[1] == 31 else x.reshape(shape)
        t = torch.from_numpy(x)
        np.testing.assert_array_equal(augment.bgr_to_hsv(t).numpy(), cv2.cvtColor(x, cv2.COLOR_BGR2HSV))
        np.testing.assert_array_equal(augment.bgr_to_gray(t).numpy(), cv2.cvtColor(x, cv2.COLOR_BGR2GRAY))


def test_hsv_to_bgr_equals_cv2_on_every_hsv(cv2_block):
    """All 180 x 256 x 256 HSV values, in rows of 256 (whole vector blocks)
    and of 31 (the scalar tail), and in rows of 100 (both in one row)."""
    hh, ss, vv = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([hh, ss, vv], -1).astype(np.uint8).reshape(-1, 3)
    for w in (256, 31, 100):
        x = np.concatenate([hsv, hsv[: (-len(hsv)) % w]]).reshape(-1, w, 3)
        np.testing.assert_array_equal(augment.hsv_to_bgr(torch.from_numpy(x).int()).numpy(),
                                      cv2.cvtColor(x, cv2.COLOR_HSV2BGR), err_msg=f"rows of {w}")


@pytest.mark.parametrize("ops", ["hue", "saturation", "illumination", "contrast", "all", "preset"])
def test_color_jitter_matches_jax(cv2_block, ops):
    """``augment.color_jitter`` against the JAX package's on the same image
    and RandomState, bit for bit, each op alone, all four, and the
    ``cfg.train`` preset (p = 0.5 each); the RandomStates end equal."""
    for seed in range(3):
        rng = np.random.RandomState(seed)
        img = cv2.GaussianBlur(rng.randint(0, 256, (61, 83, 3)).astype(np.uint8), (5, 5), 2)
        jitter = dict(jax_config.cfg.train.color_jitter)
        if ops != "preset":
            for k in jitter:
                if k.endswith("_prob"):
                    jitter[k] = 1.0 if ops == "all" or ops in k else 0.0
        r1, r2 = np.random.RandomState(50 + seed), np.random.RandomState(50 + seed)
        want = jax_aug.color_jitter(img, jitter, r1)
        got = augment.color_jitter(torch.from_numpy(img), jitter, r2)
        np.testing.assert_array_equal(got.numpy(), want)
        assert r1.rand() == r2.rand()


def test_apply_color_jitter_batches_mixed_draws():
    """A batch whose images drew different ops equals the images jittered
    one by one; no draw leaves the batch as it is."""
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (4, 20, 40, 3)).astype(np.uint8)
    draws = [(5, None, None, None), (None, -12.5, 7.25, None), (None, None, None, 1.3), (None,) * 4]
    got = augment.apply_color_jitter(torch.from_numpy(imgs), draws)
    for b in range(4):
        one = augment.apply_color_jitter(torch.from_numpy(imgs[b:b + 1]), draws[b:b + 1])
        np.testing.assert_array_equal(got[b].numpy(), one[0].numpy())
    np.testing.assert_array_equal(got[3].numpy(), imgs[3])
    np.testing.assert_array_equal(augment.normalize_image(torch.from_numpy(imgs)).numpy(),
                                  np.stack([jax_aug.normalize_image(i) for i in imgs]))


# --------------------------------------------------------------- DetIterator


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    """The JAX package's synthetic VOC tree (cv2's JPEGs; the port's decoder
    gives cv2's pixels), at a VOC-like 4:3 size, with both indexes."""
    root = jax_synthetic.build_voc_dataset(str(tmp_path_factory.mktemp("voc")), num_samples=10,
                                           hw=(120, 160), seed=5)
    names = jax_synthetic.class_names()
    return (JaxPascalVoc("train", "", root, classes=names).index(),
            PascalVoc("train", "", root, classes=names).index(), root, names)


@pytest.mark.parametrize("is_train", [True, False])
def test_det_iterator_matches_jax(voc_tree, cv2_block, is_train):
    """Three epochs of 4-image batches (a wrapped tail in each): the labels
    bit for bit, the images bit for bit (cubic at cv2's own rule, IPP off),
    train (every sampler, pad canvases, mirror, all five interpolations,
    jitter) and eval (full-image INTER_LINEAR); the RandomStates end equal."""
    jidx, pidx, _, _ = voc_tree
    with ipp(False):
        j = JaxDetIterator(jidx, 4, (96, 96), is_train=is_train)
        p = DetIterator(pidx, 4, (96, 96), is_train=is_train, device="cpu")
        n = 0
        for _ in range(3):
            for want, got in zip(j, p):
                np.testing.assert_array_equal(got["label_det"].numpy(), want["label_det"])
                np.testing.assert_array_equal(got["images"].numpy(), want["images"])
                n += 1
    assert n == 9 and j.rng.rand() == p.rng.rand()


def test_det_iterator_plans_every_path(voc_tree):
    """Over a few epochs the train plans reach crops, pad canvases, mirrors
    and all five interpolations, so the comparisons above cover them."""
    _, pidx, _, _ = voc_tree
    it = DetIterator(pidx, 5, (96, 96), device="cpu")
    plans = []
    for _ in range(6):
        it.reset()
        while it.cursor < len(pidx):
            plans += it.plan_batch()["images"].plans
    assert any(p.pad for p in plans) and any(p.box and not p.pad for p in plans)
    assert any(p.mirror for p in plans) and {p.interp for p in plans} == set(INTERP_METHODS)
    assert any(p.jitter and p.jitter[0] is not None for p in plans)


def test_det_iterator_with_ipp_within_stated_tolerance(voc_tree):
    """With cv2's default (IPP on) the labels stay bit for bit; the images
    differ only through the cubic resize, and after the HSV jitter by at
    most 16 levels on under 1% of the values (measured 12 levels, 0.23%)."""
    jidx, pidx, _, _ = voc_tree
    with ipp(True):
        j = JaxDetIterator(jidx, 5, (96, 96))
        p = DetIterator(pidx, 5, (96, 96), device="cpu")
        diffs = []
        for _ in range(3):
            for want, got in zip(j, p):
                np.testing.assert_array_equal(got["label_det"].numpy(), want["label_det"])
                diffs.append(np.abs(got["images"].numpy() - want["images"]))
    d = np.concatenate([x.ravel() for x in diffs])
    assert d.max() <= 16 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


def test_det_iterator_epoch_contract(voc_tree):
    """``epoch()``: (batch, fnames) pairs, fnames the real samples only in
    the wrapped tail, batches (B, H, W, 3) f32 and (B, 100, 6) labels;
    ``label_col5='passthrough'`` carries the difficult flag; the JAX
    ``epoch()`` gives the same names."""
    jidx, pidx, root, names = voc_tree
    for col5 in ("zero", "passthrough"):
        jv = JaxPascalVoc("val", "", root, classes=names, difficult_in_label=True).index()
        pv = PascalVoc("val", "", root, classes=names, difficult_in_label=True).index()
        j = JaxDetIterator(jv, 4, (64, 80), is_train=False, label_col5=col5)
        p = DetIterator(pv, 4, (64, 80), is_train=False, label_col5=col5, device="cpu")
        got, want = list(p.epoch()), list(j.epoch())
        assert [f for _, f in got] == [f for _, f in want]
        assert [len(f) for _, f in got] == [4, 4, 2]
        for (gb, _), (wb, _) in zip(got, want):
            assert gb["images"].shape == (4, 64, 80, 3) and gb["images"].dtype == torch.float32
            assert gb["label_det"].shape == (4, 100, 6)
            np.testing.assert_array_equal(gb["label_det"].numpy(), wb["label_det"])
            np.testing.assert_array_equal(gb["images"].numpy(), wb["images"])
    with pytest.raises(ValueError, match="label_col5"):
        DetIterator(pidx, 2, (64, 64), label_col5="dist", device="cpu")


def test_apply_plan_pad_canvas_and_mirror():
    """A pad plan puts the image at (-x1, -y1) on a 128 canvas, a mirror
    flips columns, as the JAX iterator's numpy slicing and cv2.flip."""
    img = np.random.RandomState(0).randint(0, 256, (6, 8, 3)).astype(np.uint8)
    got = apply_plan(torch.from_numpy(img), ImagePlan(box=(-3, -2, 9, 10), pad=True, mirror=True,
                                                      interp=cv2.INTER_NEAREST), (12, 12)).numpy()
    canvas = np.full((12, 12, 3), 128, np.uint8)
    canvas[2:8, 3:11] = img
    np.testing.assert_array_equal(got, cv2.flip(canvas, 1))


def test_port_voc_tree_matches_jax_layout(tmp_path):
    """The port's ``build_voc_dataset`` writes the JAX package's XML and split
    files byte for byte and JPEGs of the same scenes (its own encoder), which
    both indexes read to the same samples."""
    a = jax_synthetic.build_voc_dataset(str(tmp_path / "jax"), num_samples=3, hw=(48, 64), seed=2)
    b = synthetic.build_voc_dataset(str(tmp_path / "port"), num_samples=3, hw=(48, 64), seed=2)
    for split in ("train", "val"):
        for sub in ("ImageSets/Main/" + split + ".txt",) + tuple(
                f"Annotations/{split}_{i:04d}.xml" for i in range(3)):
            with open(f"{a}/VOC/{sub}", "rb") as fa, open(f"{b}/VOC/{sub}", "rb") as fb:
                assert fa.read() == fb.read(), sub
        ja = JaxPascalVoc(split, "", a, classes=synthetic.class_names()).index()
        pb = PascalVoc(split, "", b, classes=synthetic.class_names()).index()
        for x, y in zip(ja.samples, pb.samples):
            np.testing.assert_array_equal(x.label, y.label)
            ix, iy = cv2.imread(x.image_path), cv2.imread(y.image_path)
            assert ix.shape == iy.shape and np.abs(ix.astype(int) - iy).mean() < 2.0
