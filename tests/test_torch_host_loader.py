"""The port's host loaders against the JAX package's and cv2: the numpy warp
(``data/cv_warp.py``) against ``cv2.warpAffine`` bit for bit, the host
augmentation (``augment_example``, ``resize_example``, ``downsample_seg``)
and whole ``MultiTaskIterator`` epochs against the JAX ones bit for bit,
``NativeMultiTaskIterator`` (the device loader behind the JAX native
loader's contract) within the JAX package's own native-vs-python bounds,
and ``multi_train`` / ``multi_eval`` with ``--loader python`` and
``--loader native``, the python run's steps held to the JAX solver's."""

import json
import math
import os

import cv2
import numpy as np
import pytest
import torch

from dspnet_tpu.data import augment as jaug
from dspnet_tpu.data import synthetic as jsynthetic
from dspnet_tpu.data.cs_labels import seg_label_lut
from dspnet_tpu.data.iterator import MultiTaskIterator as JaxIterator
from dspnet_tpu.data.iterator import Sample as JaxSample
from dspnet_tpu.data.iterator import SampleIndex as JaxIndex
from dspnet_tpu.data.native_loader import NativeMultiTaskIterator as JaxNative
from dspnet_tpu.data.native_loader import native_available as jax_native_available
from dspnet_tpu.train.solver import MultiTaskSolver as JaxSolver
from dspnet_torch.api import create_model
from dspnet_torch.cli import multi_eval, multi_train
from dspnet_torch.data import augment, cv_warp, synthetic
from dspnet_torch.data.iterator import MultiTaskIterator, Sample, SampleIndex
from dspnet_torch.data.native_loader import NativeMultiTaskIterator, native_available
from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix
from dspnet_torch.utils.convert import to_flax_variables
from tests.torch_parity import assert_steps_match_jax, jax_solver_state

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

SHAPE = (64, 128)


@pytest.fixture(params=[True, False], ids=["ipp", "no_ipp"])
def ipp(request):
    """cv2 with IPP on and off: its warpAffine gives the same pixels."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(request.param)
    yield request.param
    cv2.ipp.setUseIPP(was)


def _affine(rng, H, W, hh, ww):
    """A matrix of the loader's kind (flip-free part of sample_aug_params),
    or a scale-only one."""
    if rng.rand() < 0.25:
        return np.array([[W / ww, 0.0, 0.0], [0.0, H / hh, 0.0]])
    theta = np.radians(-5 + rng.rand() * 10)
    sx = 0.5 + rng.rand() * 1.5
    sy = sx * (0.8 + rng.rand() * 0.4)
    tx, ty = -rng.rand() * W * (sx - 1), -rng.rand() * H * (sy - 1)
    sx2, sy2 = sx * W / ww, sy * H / hh
    return np.array([[sx2 * math.cos(theta), -sy2 * math.sin(theta), tx],
                     [sx2 * math.sin(theta), sy2 * math.cos(theta), ty]])


WARPS = {
    "linear_128": (cv2.INTER_LINEAR, (128, 128, 128), 3),
    "linear_default_0": (cv2.INTER_LINEAR, None, 3),
    "nearest_255": (cv2.INTER_NEAREST, (255, 255, 255), 1),
    "nearest_0": (cv2.INTER_NEAREST, (0, 0, 0), 1),
}


@pytest.mark.parametrize("kind", sorted(WARPS))
def test_warp_affine_equals_cv2(ipp, kind):
    """80 seeded affines from odd source sizes to odd destination sizes
    (widths on both sides of the 16-pixel vector blocks): every pixel equals
    ``cv2.warpAffine``'s."""
    flags, border, C = WARPS[kind]
    rng = np.random.RandomState(sorted(WARPS).index(kind))
    for _ in range(80):
        hh, ww = rng.randint(3, 200), rng.randint(3, 260)
        H, W = rng.randint(1, 120), rng.randint(1, 200)
        shape = (hh, ww, C) if C > 1 else (hh, ww)
        src = rng.randint(0, 256 if C > 1 else 40, shape).astype(np.uint8)
        M = _affine(rng, H, W, hh, ww)
        if border is None:
            want = cv2.warpAffine(src, M, (W, H), flags=flags)
            got = cv_warp.warp_affine(src, M, (W, H))
        else:
            want = cv2.warpAffine(src, M, (W, H), flags=flags, borderValue=border)
            got = cv_warp.warp_affine(src, M, (W, H), nearest=flags == cv2.INTER_NEAREST, border_value=border)
        np.testing.assert_array_equal(got, want, err_msg=f"{src.shape} -> {(H, W)} M={M.tolist()}")


def test_warp_affine_full_scale_equals_cv2(ipp):
    """1024x2048 -> 512x1024, the scale alone and one augmentation affine,
    image and mask, equal cv2's."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (1024, 2048, 3)).astype(np.uint8)
    seg = rng.randint(0, 34, (1024, 2048)).astype(np.uint8)
    for M in (np.array([[0.5, 0.0, 0.0], [0.0, 0.5, 0.0]]), _affine(np.random.RandomState(9), 512, 1024, 1024, 2048)):
        np.testing.assert_array_equal(cv_warp.warp_affine(img, M, (1024, 512), border_value=128),
                                      cv2.warpAffine(img, M, (1024, 512), flags=cv2.INTER_LINEAR,
                                                     borderValue=(128, 128, 128)))
        np.testing.assert_array_equal(cv_warp.warp_affine(seg, M, (1024, 512), nearest=True, border_value=255),
                                      cv2.warpAffine(seg, M, (1024, 512), flags=cv2.INTER_NEAREST,
                                                     borderValue=(255, 255, 255)))


def test_fma32_rounds_once():
    """``fma32`` against exact rational arithmetic, cancellations and
    halfway cases included."""
    from fractions import Fraction

    rng = np.random.RandomState(1)
    a = (rng.randn(3000) * 10.0 ** rng.randint(-3, 4, 3000)).astype(np.float32)
    b = (rng.randn(3000) * 10.0 ** rng.randint(-3, 4, 3000)).astype(np.float32)
    c = (rng.randn(3000) * 10.0 ** rng.randint(-3, 4, 3000)).astype(np.float32)
    c[::3] = -(a[::3].astype(np.float64) * b[::3]).astype(np.float32)
    a[1::5] = rng.randint(0, 2048, a[1::5].size)
    b[1::5] = (rng.randint(-8, 8, b[1::5].size) / 16 + 2.0 ** -20).astype(np.float32)
    got = cv_warp.fma32(a, b, c)
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        err = abs(Fraction(float(r)) - exact)
        for n in (np.nextafter(r, np.float32(np.inf)), np.nextafter(r, np.float32(-np.inf))):
            assert abs(Fraction(float(n)) - exact) >= err, (x, y, z, r)


def test_flip_equals_cv2():
    img = np.random.RandomState(2).randint(0, 256, (7, 13, 3)).astype(np.uint8)
    np.testing.assert_array_equal(cv_warp.flip_horizontal(img), cv2.flip(img, 1))
    np.testing.assert_array_equal(cv_warp.flip_horizontal(img[..., 0]), cv2.flip(img[..., 0], 1))


def _example(rng, hh, ww, n_boxes):
    img = rng.randint(0, 256, (hh, ww, 3)).astype(np.uint8)
    seg = rng.randint(0, 34, (hh, ww)).astype(np.uint8)
    label = np.full((200, 6), -1.0, np.float32)
    for i in range(n_boxes):
        x1, y1 = rng.rand() * 0.8, rng.rand() * 0.8
        label[i] = [rng.randint(0, 8), x1, y1, x1 + 0.05 + rng.rand() * 0.2, y1 + 0.05 + rng.rand() * 0.2,
                    rng.rand()]
    return img, label, seg


@pytest.mark.parametrize("with_seg", [True, False])
def test_augment_example_equals_jax(with_seg):
    """20 examples through one drawn table row each (flips included, one
    example with no boxes), image, label and mask equal the JAX function's."""
    rng = np.random.RandomState(4)
    params = augment.sample_aug_params(20, SHAPE, np.random.RandomState(233))
    for i in range(20):
        img, label, seg = _example(rng, rng.randint(40, 140), rng.randint(60, 300), 0 if i == 3 else rng.randint(1, 9))
        seg = seg if with_seg else None
        want = jaug.augment_example(img, label, seg, params[i], SHAPE)
        got = augment.augment_example(img, label, seg, params[i], SHAPE)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("with_seg", [True, False])
def test_resize_example_equals_jax(with_seg):
    rng = np.random.RandomState(5)
    for _ in range(12):
        img, label, seg = _example(rng, rng.randint(20, 140), rng.randint(30, 300), rng.randint(0, 9))
        seg = seg if with_seg else None
        want = jaug.resize_example(img, label, seg, SHAPE)
        got = augment.resize_example(img, label, seg, SHAPE)
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("lut", [True, False])
def test_downsample_seg_equals_jax(lut):
    rng = np.random.RandomState(6)
    table = seg_label_lut() if lut else None
    for hh, ww in ((64, 128), (66, 130), (17, 31), (512, 1024)):
        seg = rng.randint(0, 256, (hh, ww)).astype(np.uint8)
        got = augment.downsample_seg(seg, table)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jaug.downsample_seg(seg, table))


def test_augment_refuses_a_mask_of_another_size():
    img, label, seg = _example(np.random.RandomState(7), 40, 80, 2)
    with pytest.raises(ValueError, match="seg mask"):
        augment.augment_example(img, label, seg[:20], augment.sample_aug_params(1, SHAPE, np.random.RandomState(0))[0],
                                SHAPE)
    with pytest.raises(ValueError, match="seg mask"):
        augment.resize_example(img, label, seg[:, :40], SHAPE)


# ---------------------------------------------------------------- iterators


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Seven samples of the JAX package's synthetic set at 96x200: JPEG
    images, two of them rewritten as PNG, one without a mask."""
    root = tmp_path_factory.mktemp("host_loader")
    index = jsynthetic.build_dataset(str(root), num_samples=7, hw=(96, 200))
    samples = list(index.samples)
    for i in (2, 5):
        png = samples[i].image_path[:-4] + ".png"
        cv2.imwrite(png, cv2.imread(samples[i].image_path))
        samples[i] = JaxSample(png, samples[i].label, samples[i].seg_path)
    samples[4] = JaxSample(samples[4].image_path, samples[4].label, None)
    jax_index = JaxIndex(samples)
    port_index = SampleIndex([Sample(s.image_path, s.label, s.seg_path) for s in samples])
    return jax_index, port_index


def _numpy(batch):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)) for k, v in batch.items()}


CASES = {
    "aug": dict(enable_aug=True),
    "no_aug_padded": dict(enable_aug=False, shuffle=False, pad_last=True),
    "aug_shard_1_2": dict(enable_aug=True, shard=(1, 2)),
    "aug_padded_shard_1_2": dict(enable_aug=True, shard=(1, 2), pad_last=True),
    "no_lut": dict(enable_aug=True, apply_seg_lut=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_multitask_iterator_epochs_equal_jax(dataset, case):
    """Two whole epochs (the table redrawn at each): images, labels, seg and
    file names equal the JAX iterator's bit for bit, the maskless sample's
    seg all ignore, the padded tail's rows empty."""
    jax_index, port_index = dataset
    kw = dict(batch_size=2, data_shape=SHAPE, **CASES[case])
    want_it, got_it = JaxIterator(jax_index, **kw), MultiTaskIterator(port_index, **kw)
    for _ in range(2):
        want, got = list(want_it.epoch()), list(got_it.epoch())
        assert len(got) == len(want) > 0
        for (wb, wn), (gb, gn) in zip(want, got):
            assert gn == wn
            assert set(gb) == set(wb)
            for k in wb:
                assert gb[k].dtype == wb[k].dtype, k
                np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


JPEG_FORMS = os.path.join(os.path.dirname(__file__), "fixtures", "jpeg_forms")


@pytest.mark.parametrize("enable_aug", [False, True])
def test_multitask_iterator_on_arithmetic_and_lossless_jpegs_equals_jax(dataset, tmp_path, enable_aug):
    """Two epochs of the python loader over arithmetic-coded JPEGs
    (sequential, progressive, with restarts and DAC conditioning, 4:1:1 and
    4:4:0), a lossless one and a progressive one with restarts, each with
    the labels of a synthetic sample and no mask: equal to the JAX
    ``MultiTaskIterator`` (cv2.imread) bit for bit."""
    jax_index, _ = dataset
    names = ["arith_seq_420_street.jpg", "arith_prog_420.jpg", "arith_seq_dac_rst.jpg", "arith_prog_rst1.jpg",
             "arith_seq_411.jpg", "arith_prog_440.jpg", "lossless_rgb_p7_pt2_rst.jpg", "prog_rst2_420.jpg"]
    jax_samples, port_samples = [], []
    for i, name in enumerate(names):
        path = str(tmp_path / name)
        with open(os.path.join(JPEG_FORMS, name), "rb") as src, open(path, "wb") as dst:
            dst.write(src.read())
        label = jax_index[i % len(jax_index.samples)].label
        jax_samples.append(JaxSample(path, label, None))
        port_samples.append(Sample(path, label, None))
    kw = dict(batch_size=3, data_shape=SHAPE, enable_aug=enable_aug, pad_last=True)
    want_it, got_it = JaxIterator(JaxIndex(jax_samples), **kw), MultiTaskIterator(SampleIndex(port_samples), **kw)
    for _ in range(2):
        want, got = list(want_it.epoch()), list(got_it.epoch())
        assert len(got) == len(want) == 3
        for (wb, wn), (gb, gn) in zip(want, got):
            assert gn == wn
            for k in wb:
                np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_multitask_iterator_next_batch_and_s2d(dataset):
    """``next_batch`` before any ``epoch()`` reads the tables drawn at
    construction, as the JAX iterator's does; ``s2d`` is refused."""
    jax_index, port_index = dataset
    want = JaxIterator(jax_index, 3, SHAPE).next_batch()
    got = MultiTaskIterator(port_index, 3, SHAPE).next_batch()
    assert got[1] == want[1]
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k])
    with pytest.raises(ValueError, match="item 17"):
        MultiTaskIterator(port_index, 2, SHAPE, s2d=True)


def _assert_native_bounds(nb, pb):
    """The JAX package's native-vs-python bounds (tests/test_native_loader.py)
    and its device-vs-host label tolerance (tests/test_device_pipeline.py)."""
    np.testing.assert_allclose(nb["label_det"], pb["label_det"], atol=2e-4)
    diff = np.abs(nb["images"] - pb["images"])
    assert np.mean(diff) < 1.0, np.mean(diff)
    assert np.percentile(diff, 99) <= 16.0
    assert np.mean(nb["seg_label"] != pb["seg_label"]) < 0.02


@pytest.mark.parametrize("enable_aug", [False, True])
@pytest.mark.parametrize("against", ["python", "jax_native"])
def test_native_iterator_within_the_jax_bounds(dataset, enable_aug, against):
    """Three batches against the JAX python loader (every sample with a mask,
    PNG images included), and against the JAX native loader where it is
    built (on its own domain: JPEG images with masks; the C++ loader fills a
    missing mask with zeros and mis-reads these PNG images)."""
    jax_index, port_index = dataset
    if against == "jax_native" and not jax_native_available():
        pytest.skip("the JAX native loader is not built (make -C native)")
    keep = [i for i, s in enumerate(port_index.samples)
            if s.seg_path is not None and (against == "python" or s.image_path.endswith(".jpg"))]
    jax_index, port_index = JaxIndex([jax_index[i] for i in keep]), SampleIndex([port_index[i] for i in keep])
    kw = dict(batch_size=2, data_shape=SHAPE, enable_aug=enable_aug, shuffle=True)
    ref = JaxIterator(jax_index, **kw) if against == "python" else JaxNative(jax_index, num_threads=3, **kw)
    nat = NativeMultiTaskIterator(port_index, num_threads=3, device="cpu", **kw)
    try:
        for _ in range(2):
            want = ref.next_batch()
            _assert_native_bounds(_numpy(nat.next_batch()), want[0] if isinstance(want, tuple) else want)
    finally:
        nat.close()
        if against == "jax_native":
            ref.close()


def _shifted(images, pixels):
    """A planted fault: the batch moved right by one pixel (``pixels=1``) or,
    bilinear, by half a pixel (``pixels=0.5``), the edge column repeated."""
    one = np.concatenate([images[:, :, :1], images[:, :, :-1]], axis=2)
    return one if pixels == 1 else 0.5 * (images + one)


@pytest.fixture(scope="module")
def textured(tmp_path_factory):
    """Six samples of the port's synthetic set at 96x200 with a photograph's
    texture over the flat scenes (``synthetic.texture_offsets``)."""
    root = tmp_path_factory.mktemp("host_loader_textured")
    index = synthetic.build_dataset(str(root), num_samples=6, hw=(96, 200), texture=True)
    return JaxIndex([JaxSample(s.image_path, s.label, s.seg_path) for s in index.samples]), index


def test_texture_keeps_the_scenes(textured, tmp_path):
    """``texture=True`` changes the images only: the same labels and masks
    as the flat set of the same seed, and images whose mean absolute step
    between neighbours exceeds the flat ones' by several levels."""
    flat = synthetic.build_dataset(str(tmp_path), num_samples=6, hw=(96, 200))
    _, tex = textured
    for f, t in zip(flat.samples, tex.samples):
        np.testing.assert_array_equal(f.label, t.label)
        np.testing.assert_array_equal(cv2.imread(f.seg_path, cv2.IMREAD_UNCHANGED),
                                      cv2.imread(t.seg_path, cv2.IMREAD_UNCHANGED))
        fi, ti = (cv2.imread(p).astype(np.float32) for p in (f.image_path, t.image_path))
        assert np.abs(np.diff(ti, axis=1)).mean() > np.abs(np.diff(fi, axis=1)).mean() + 3.0


@pytest.mark.parametrize("enable_aug", [False, True])
def test_native_iterator_on_textured_samples(textured, enable_aug):
    """On textured images, where flat colours would hide a warp's sub-pixel
    error, the native batches stay within the JAX bounds of the python
    loader's, and the same batches moved by one pixel or half a pixel fall
    outside them (image mean abs difference >= 1.0)."""
    jax_index, port_index = textured
    kw = dict(batch_size=3, data_shape=SHAPE, enable_aug=enable_aug, shuffle=True)
    ref = JaxIterator(jax_index, **kw)
    nat = NativeMultiTaskIterator(port_index, num_threads=3, device="cpu", **kw)
    try:
        for _ in range(2):
            pb, nb = ref.next_batch()[0], _numpy(nat.next_batch())
            _assert_native_bounds(nb, pb)
            for pixels in (1, 0.5):
                assert np.mean(np.abs(_shifted(nb["images"], pixels) - pb["images"])) >= 1.0, pixels
    finally:
        nat.close()


def test_native_iterator_epochs_threads_u8_and_s2d(dataset):
    """The first epoch runs on the construction tables, later ones redraw
    (the JAX native loader's rule); the thread count, ``queue_cap`` (the
    batches decoded ahead) and ``device_normalize`` change no batch; ``s2d``
    is refused; ``native_available`` holds on the CPU."""
    _, port_index = dataset
    kw = dict(batch_size=2, data_shape=SHAPE, enable_aug=True, pad_last=True)
    a = NativeMultiTaskIterator(port_index, num_threads=1, device="cpu", **kw)
    b = NativeMultiTaskIterator(port_index, num_threads=4, queue_cap=1, device_normalize=True, device="cpu", **kw)
    assert (a.prefetch, b.prefetch) == (4, 1)
    first_order = a.order.copy()
    for epoch in range(2):
        ea, eb = list(a.epoch()), list(b.epoch())
        assert len(ea) == len(eb) == 4
        names = [n for _, ns in ea for n in ns]
        assert names == [port_index[int(i)].image_path for i in a.order]
        for (ba, na), (bb, nb) in zip(ea, eb):
            assert na == nb
            for k in ba:
                assert ba[k].device.type == "cpu"
                assert torch.equal(ba[k], bb[k]), k
        if epoch == 0:
            np.testing.assert_array_equal(a.order, first_order)
    assert not np.array_equal(a.order, first_order)
    assert native_available("cpu")
    with pytest.raises(ValueError, match="item 17"):
        NativeMultiTaskIterator(port_index, 2, SHAPE, s2d=True, device="cpu")


# ---------------------------------------------------------------- the CLIs

H, W = 128, 256
LR = 1e-3


def test_default_loader_is_device():
    """The port's default loader is ``device`` (the JAX CLIs' is ``python``,
    which on the card decodes with the plain numpy decoder)."""
    net = ["--network", "resnet-18_multi", "--synthetic", "2", "--device", "cpu"]
    assert multi_train.parse_args(net).loader == "device"
    assert multi_eval.parse_args(net).loader == "device"


@pytest.mark.parametrize("loader", ["python", "native"])
def test_train_then_eval_with_the_host_loaders(tmp_path, monkeypatch, loader):
    """``multi_train --loader python|native`` (b4 over 4 images, one step,
    a validation pass through the same loader), then ``multi_eval`` with it.
    The python run's checkpoint and step metrics are held against the JAX
    solver from the CLI's seeded weights on the JAX ``MultiTaskIterator``'s
    batch, at ``assert_steps_match_jax``'s tolerances (a second step's
    metrics would follow the first step's ReLU switches, which those
    tolerances bound on the parameters, not on the next losses); the
    native run's validation matches ``multi_eval``'s seg metrics."""
    monkeypatch.chdir(tmp_path)  # the CLIs log under ./log
    net = ["--network", "resnet-18_multi", "--data-shape", f"3,{H},{W}", "--num-classes", "8", "--device", "cpu",
           "--synthetic", "4", "--synthetic-dir", str(tmp_path / "synth")]
    extra = ["--native-u8"] if loader == "native" else []
    st = multi_train.main(net + ["--batch-size", "4", "--end-epoch", "1", "--seg-normalize", "valid", "--lr", str(LR),
                                 "--eval-every", "1", "--log-every", "1", "--loader", loader, "--loader-threads", "2",
                                 "--model-dir", str(tmp_path / "m"), "--metrics-jsonl", str(tmp_path / "m.jsonl")]
                           + extra)
    assert st.step == 1
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [(r["epoch"], r["split"]) for r in rows] == [(0, "train"), (0, "val")]
    res = multi_eval.main(net + ["--batch-size", "2", "--loader", loader, "--model-dir", str(tmp_path / "m")] + extra)
    for k in ("mAP", "mIoU", "accuracy", "derror", "ms_per_batch"):
        assert k in res and np.isfinite(res[k]), k
    if loader == "native":
        # training validated at the local batch 4, the eval CLI at 2: the seg
        # metrics count the same pixels
        np.testing.assert_allclose(res["mIoU"], rows[1]["mIoU"], rtol=1e-6)
        np.testing.assert_allclose(res["accuracy"], rows[1]["accuracy"], rtol=1e-6)
        return
    ckpt = torch.load(CheckpointManager(checkpoint_prefix(str(tmp_path / "m"), "resnet-18_multi", H)).path(0),
                      weights_only=True)
    init = create_model("resnet-18_multi", (H, W), device="cpu",
                        generator=torch.Generator().manual_seed(multi_train.SEED)).model
    variables = to_flax_variables(init)
    index = multi_train.resolve_dataset(multi_train.parse_args(net), "train")
    jax_index = JaxIndex([JaxSample(s.image_path, s.label, s.seg_path) for s in index.samples])
    it = JaxIterator(jax_index, 4, (H, W), enable_aug=True)
    batches = list(it)
    from dspnet_tpu.api import create_model as jax_create_model

    bundle = jax_create_model("resnet-18_multi", (H, W), num_classes=8)
    js = JaxSolver(bundle.model, bundle.anchors, learning_rate=LR, batch_size=4, seg_normalize="valid")
    jst, want_m = jax_solver_state(js, variables, (H, W)), []
    for batch in batches:
        jst, m = js.train_step(jst, batch)
        want_m.append(m)
    got_m = [{k: v for k, v in r.items() if k not in ("epoch", "split", "time")} for r in rows[:1]]
    assert_steps_match_jax(variables["params"], jst, want_m,
                           to_flax_variables({**ckpt["params"], **ckpt["buffers"]}), got_m,
                           valid_px=[int((b["seg_label"] != 255).sum()) for b in batches],
                           init_stats=variables["batch_stats"])
    assert os.path.isdir(tmp_path / "log")
