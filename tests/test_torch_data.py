"""The data slice of the PyTorch port vs the JAX package, on the CPU: the
label tables, the synthetic scenes, the PNG codec (against cv2), the
augmentation table, the batched warp and the on-device augmentation
pipeline (torch on the CPU vs ``dspnet_tpu.data.device_pipeline``), the
sample decoding and the prefetch thread."""

import os
import struct
import threading
import time
import zlib

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dspnet_tpu.data import augment as jaug
from dspnet_tpu.data import cs_labels as jlabels
from dspnet_tpu.data import device_pipeline as jdp
from dspnet_tpu.data import iterator as jiter
from dspnet_tpu.data import synthetic as jsyn
from dspnet_torch.data import augment, cs_labels, device_pipeline, image_io, iterator, jpeg, synthetic
from dspnet_torch.data.device_pipeline import DeviceAugIterator
from dspnet_torch.data.prefetch import prefetch_to_device

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

# Images: the pipelines build the same warp matrices except where float32
# cos/sin differ by one ulp (JAX's float32 cos against the port's float64
# cos rounded to float32, chosen so the card and the CPU agree); that moves
# a sample point by ~1e-5 px, so a bilinear value by < 0.05 (measured 0.014).
IMG_ATOL = 0.05
BOX_ATOL = 1e-5


# ------------------------------------------------------------- labels


def test_cs_labels_match_jax():
    assert cs_labels.labels == jlabels.labels
    assert cs_labels.name2label == jlabels.name2label
    assert cs_labels.id2label == jlabels.id2label
    assert cs_labels.trainId2label == jlabels.trainId2label
    assert cs_labels.DET_CLASSES == jlabels.DET_CLASSES
    assert cs_labels.SEG_CLASSES == jlabels.SEG_CLASSES
    for fn in ("TRAINID_TO_LABELID",):
        a, b = getattr(cs_labels, fn), getattr(jlabels, fn)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for fn in ("seg_label_lut", "train_id_palette"):
        a, b = getattr(cs_labels, fn)(), getattr(jlabels, fn)()
        assert a.dtype == b.dtype and np.array_equal(a, b), fn


# ------------------------------------------------------------- synthetic


@pytest.mark.parametrize("seed,hw,n", [(233, (128, 256), 6), (91, (64, 128), 1), (5, (512, 1024), 4),
                                       (7, (96, 96), 0)])
def test_make_example_matches_jax(seed, hw, n):
    got = synthetic.make_example(np.random.RandomState(seed), hw, n)
    want = jsyn.make_example(np.random.RandomState(seed), hw, n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_build_dataset_names_and_png_bytes(tmp_path):
    """Same file names and labels as the JAX build_dataset on the same seed; the
    image files hold baseline JPEG bytes at quality 95 and 4:2:0, as the JAX
    package's do, which image_io and cv2 decode to the same pixels, as close
    to the scene as cv2's own JPEG of it; masks, disparity and instance ids
    are lossless PNG equal to the JAX package's."""
    index = synthetic.build_dataset(str(tmp_path / "t"), num_samples=3, hw=(64, 128), seed=233,
                                    with_instances=True)
    jindex = jsyn.build_dataset(str(tmp_path / "j"), num_samples=3, hw=(64, 128), seed=233,
                                with_instances=True)
    rng = np.random.RandomState(233)
    for s, js in zip(index.samples, jindex.samples):
        assert os.path.relpath(s.image_path, tmp_path / "t") == os.path.relpath(js.image_path, tmp_path / "j")
        assert os.path.relpath(s.seg_path, tmp_path / "t") == os.path.relpath(js.seg_path, tmp_path / "j")
        np.testing.assert_array_equal(s.label, js.label)
        img, _, seg, disp = synthetic.make_example(rng, (64, 128), rng.randint(1, 7))
        with open(s.image_path, "rb") as f:
            data = f.read()
        assert data[:3] == image_io.JPEG_MAGIC
        assert jpeg.read_header(data) == (64, 128, 3)
        ours = image_io.imread(s.image_path)
        np.testing.assert_array_equal(ours, cv2.imread(s.image_path, cv2.IMREAD_COLOR))
        theirs = cv2.imread(js.image_path, cv2.IMREAD_COLOR)
        assert _psnr(ours, img) >= _psnr(theirs, img) - 1.0
        name = os.path.basename(s.image_path)
        for sub, old, new in (("Disparity", "_leftImg8bit.jpg", "_disparity.png"),
                              ("SegmentationInstance", "_leftImg8bit.jpg", "_gtFine_instanceIds.png")):
            path = os.path.join(str(tmp_path / "t"), sub, name.replace(old, new))
            want = cv2.imread(os.path.join(str(tmp_path / "j"), sub, name.replace(old, new)), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(image_io.imread(path, image_io.IMREAD_UNCHANGED), want)
        for path, want, flag in ((s.seg_path, seg, cv2.IMREAD_UNCHANGED),):
            np.testing.assert_array_equal(image_io.imread(path, flag), want)
            np.testing.assert_array_equal(cv2.imread(path, flag), want)


def _psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))


# ------------------------------------------------------------- PNG codec


def _images():
    rng = np.random.RandomState(0)
    H, W = 48, 80
    yy, xx = np.mgrid[:H, :W]
    smooth = ((xx * 3 + yy * 2) % 256).astype(np.uint8)
    noise = rng.randint(0, 256, (H, W)).astype(np.uint8)
    mix = np.where(rng.rand(H, W) < 0.5, smooth, noise).astype(np.uint8)
    return {
        "gray8": mix,
        "gray16": (rng.randint(0, 65536, (H, W)) // (1 + xx % 7)).astype(np.uint16),
        "bgr8": np.stack([smooth, (smooth.astype(int) * 2 % 256).astype(np.uint8), noise], -1),
        "bgra8": np.stack([smooth, mix, noise, smooth[::-1]], -1),
    }


def _filter_bytes(path):
    """The filter type byte of every row of a PNG file."""
    data = open(path, "rb").read()
    pos, idat = 8, []
    while True:
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    stride = w * {0: 1, 2: 3, 6: 4}[color] * depth // 8
    raw = zlib.decompress(b"".join(idat))
    return {raw[i * (stride + 1)] for i in range(h)}


_FILTERS = {"none": (cv2.IMWRITE_PNG_FILTER_NONE, {0}), "sub": (cv2.IMWRITE_PNG_FILTER_SUB, {1}),
            "up": (cv2.IMWRITE_PNG_FILTER_UP, {2}), "average": (cv2.IMWRITE_PNG_FILTER_AVG, {3}),
            "paeth": (cv2.IMWRITE_PNG_FILTER_PAETH, {4}), "adaptive": (cv2.IMWRITE_PNG_ALL_FILTERS, None),
            "default": (None, None)}


@pytest.mark.parametrize("mode", list(_images()))
@pytest.mark.parametrize("filt", list(_FILTERS))
def test_png_read_matches_cv2(tmp_path, mode, filt):
    """Every mode the data path reads, written by cv2 with each row filter
    (one forced filter at a time, libpng's adaptive choice, and cv2's
    default), decodes to what cv2.imread gives, UNCHANGED and COLOR."""
    img = _images()[mode]
    flag, expect = _FILTERS[filt]
    path = str(tmp_path / f"{mode}.png")
    assert cv2.imwrite(path, img, [] if flag is None else [cv2.IMWRITE_PNG_FILTER, flag])
    if expect is not None:
        assert _filter_bytes(path) == expect
    for f in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR):
        want = cv2.imread(path, f)
        got = image_io.imread(path, f)
        assert got.dtype == want.dtype and got.shape == want.shape, (f, got.shape, want.shape)
        np.testing.assert_array_equal(got, want)


def test_png_adaptive_filters_cover_all_kinds(tmp_path):
    """libpng's adaptive choice on these images uses Sub, Up, Average and
    Paeth rows (None is pinned by its forced case above)."""
    kinds = set()
    for mode, img in _images().items():
        path = str(tmp_path / f"{mode}.png")
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
        kinds |= _filter_bytes(path)
    assert kinds >= {1, 2, 3, 4}


@pytest.mark.parametrize("mode", list(_images()))
def test_png_write_round_trip(tmp_path, mode):
    """image_io writes filter-0 PNG bytes under a name that is not .jpg /
    .jpeg, which it and cv2 read back to the same array."""
    img = _images()[mode]
    path = str(tmp_path / "x_gtFine_labelTrainIds.png")
    image_io.imwrite(path, img)
    assert _filter_bytes(path) == {0}
    np.testing.assert_array_equal(image_io.imread(path, image_io.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    with open(path, "rb") as f:
        np.testing.assert_array_equal(image_io.imdecode(np.frombuffer(f.read(), np.uint8), -1), img)
    assert not [p for p in os.listdir(tmp_path) if ".tmp" in p]


def test_imread_sniffs_content_and_refuses_jpeg(tmp_path):
    """JPEG bytes under a .png name decode as JPEG (to cv2's pixels), gray
    replicated under IMREAD_COLOR; a progressive JPEG decodes to cv2's
    pixels too; a lossless-coded JPEG, unknown bytes, a broken GIF and a
    broken PNG raise."""
    img = _images()["bgr8"]
    jpg = str(tmp_path / "a.png")  # JPEG bytes under a .png name
    assert cv2.imwrite(str(tmp_path / "a.jpg"), img)
    os.replace(str(tmp_path / "a.jpg"), jpg)
    np.testing.assert_array_equal(image_io.imread(jpg), cv2.imread(jpg, cv2.IMREAD_COLOR))
    gray = str(tmp_path / "g.jpg")
    assert cv2.imwrite(gray, img[..., 0])
    np.testing.assert_array_equal(image_io.imread(gray), cv2.imread(gray, cv2.IMREAD_COLOR))
    np.testing.assert_array_equal(image_io.imread(gray, image_io.IMREAD_UNCHANGED),
                                  cv2.imread(gray, cv2.IMREAD_UNCHANGED))
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    np.testing.assert_array_equal(image_io.imdecode(prog), cv2.imdecode(prog, cv2.IMREAD_COLOR))
    base = cv2.imencode(".jpg", img)[1].tobytes()
    with pytest.raises(jpeg.JpegError, match="lossless"):
        image_io.imdecode(base.replace(b"\xff\xc0", b"\xff\xc3", 1))
    junk = str(tmp_path / "b.png")
    with open(junk, "wb") as f:
        f.write(b"XIF89a" + bytes(20))
    with pytest.raises(ValueError, match="unknown image format"):
        image_io.imread(junk)
    with open(junk, "wb") as f:  # GIF is read now: a broken one raises as a GIF
        f.write(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="GIF"):
        image_io.imread(junk)
    data = bytearray(image_io.encode_png(img[..., ::-1]))
    data[40] ^= 0xFF  # inside IDAT: the CRC check fails
    with pytest.raises(ValueError, match="CRC"):
        image_io.imdecode(bytes(data))


# ------------------------------------------------------------- augmentation


def test_sample_aug_params_and_filter_match_jax(rng):
    for shape in ((512, 1024), (64, 128)):
        got = augment.sample_aug_params(37, shape, np.random.RandomState(233))
        want = jaug.sample_aug_params(37, shape, np.random.RandomState(233))
        np.testing.assert_array_equal(got, want)
    assert augment.MEAN_PIXELS == jaug.MEAN_PIXELS
    for out_of_image in (False, True):
        label = np.full((40, 6), -1.0, np.float32)
        n = 25
        x1, y1 = rng.uniform(-0.2, 1.1, (2, n))
        label[:n] = np.stack([rng.randint(0, 8, n), x1, y1, x1 + rng.uniform(0, 0.3, n),
                              y1 + rng.uniform(0, 0.3, n), rng.rand(n)], 1)
        label[3, 3] = label[3, 1]  # zero area
        got = augment._filter_and_compact(label.copy(), (64, 128), out_of_image)
        want = jaug._filter_and_compact(label.copy(), (64, 128), out_of_image)
        np.testing.assert_array_equal(got, want)
        assert (got[:, 0] >= 0).sum() < n


def _affines(rng, B):
    M = np.zeros((B, 2, 3), np.float32)
    th, s = rng.uniform(-0.09, 0.09, B), rng.uniform(0.4, 2.2, B)
    M[:, 0, 0], M[:, 0, 1], M[:, 0, 2] = s * np.cos(th), -s * 1.1 * np.sin(th), rng.uniform(-60, 5, B)
    M[:, 1, 0], M[:, 1, 1], M[:, 1, 2] = s * np.sin(th), s * 1.1 * np.cos(th), rng.uniform(-40, 5, B)
    return M


@pytest.mark.parametrize("nearest", [False, True])
def test_warp_affine_batch_matches_jax(rng, nearest):
    """Same matrices in, the same float32 pixels out, bit for bit (the same
    ops in the same order; NHWC and NHW)."""
    M = _affines(rng, 3)
    for raw in (rng.randint(0, 256, (3, 96, 160, 3)).astype(np.uint8),
                rng.randint(0, 34, (3, 96, 160)).astype(np.uint8)):
        want = np.asarray(jaug.warp_affine_batch_jax(jnp.asarray(raw), jnp.asarray(M), (48, 80), 128.0,
                                                     nearest=nearest))
        got = augment.warp_affine_batch(torch.from_numpy(raw), torch.from_numpy(M), (48, 80), 128.0,
                                        nearest=nearest)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def _raw_batch(rng, B=3, hh=96, ww=192):
    raw = rng.randint(0, 256, (B, hh, ww, 3)).astype(np.uint8)
    segs = np.repeat(np.repeat(rng.randint(0, 40, (B, hh // 8, ww // 8)), 8, 1), 8, 2).astype(np.uint8)
    labels = np.full((B, 200, 6), -1.0, np.float32)
    for b in range(B):
        n = rng.randint(1, 9)
        x1, y1 = rng.rand(2, n) * 0.8
        labels[b, :n] = np.stack([rng.randint(0, 8, n), x1, y1, x1 + 0.02 + rng.rand(n) * 0.3,
                                  y1 + 0.02 + rng.rand(n) * 0.3, rng.rand(n)], 1)
    return raw, segs, labels


def _assert_batches_close(got, want):
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].cpu().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
    np.testing.assert_allclose(got["label_det"].cpu().numpy(), np.asarray(want["label_det"]), rtol=0,
                               atol=BOX_ATOL)
    np.testing.assert_allclose(got["images"].cpu().numpy(), np.asarray(want["images"]), rtol=0,
                               atol=IMG_ATOL)
    if "seg_label" in want:
        np.testing.assert_array_equal(got["seg_label"].cpu().numpy(), np.asarray(want["seg_label"]))


@pytest.mark.parametrize("enable_aug", [True, False])
@pytest.mark.parametrize("shape", [(48, 96), (96, 192)])
def test_device_augment_batch_matches_jax(rng, enable_aug, shape):
    """The same raw uint8 batch through both packages: boxes to 1e-5, seg
    maps equal, images to IMG_ATOL (bit for bit without augmentation)."""
    raw, segs, labels = _raw_batch(rng)
    params = augment.sample_aug_params(3, shape, np.random.RandomState(4)).astype(np.float32)
    lut = cs_labels.seg_label_lut().astype(np.int32)
    want = jdp.device_augment_batch(jnp.asarray(raw), jnp.asarray(segs), jnp.asarray(labels),
                                    jnp.asarray(params), lut, shape, enable_aug=enable_aug)
    got = device_pipeline.device_augment_batch(
        torch.from_numpy(raw), torch.from_numpy(segs), torch.from_numpy(labels), torch.from_numpy(params),
        torch.from_numpy(lut), shape, enable_aug=enable_aug)
    _assert_batches_close(got, want)
    if not enable_aug:
        np.testing.assert_array_equal(got["images"].numpy(), np.asarray(want["images"]))
    # no seg input: no seg output, in both
    got = device_pipeline.device_augment_batch(
        torch.from_numpy(raw), None, torch.from_numpy(labels), torch.from_numpy(params),
        torch.from_numpy(lut), shape, enable_aug=enable_aug)
    assert "seg_label" not in got


# ------------------------------------------------------------- iterator


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """5 samples written by the port (PNG bytes), as a port index and as a
    JAX index over the same files."""
    index = synthetic.build_dataset(str(tmp_path_factory.mktemp("pt_synth")), num_samples=5,
                                    hw=(96, 192), seed=233)
    jindex = jiter.SampleIndex([jiter.Sample(s.image_path, s.label, s.seg_path) for s in index.samples])
    return index, jindex


@pytest.mark.parametrize("enable_aug,shuffle,pad_last", [(True, True, False), (False, False, True),
                                                         (True, True, True)])
def test_device_aug_iterator_epochs_match_jax(dataset, enable_aug, shuffle, pad_last):
    """Two epochs of both iterators over the port's dataset: the same order,
    names, padding (the last sample repeated, fnames holding only the real
    rows) and batches."""
    index, jindex = dataset
    kw = dict(enable_aug=enable_aug, shuffle=shuffle, pad_last=pad_last, num_threads=2)
    ours = DeviceAugIterator(index, 2, (48, 96), device="cpu", seed=233, **kw)
    ref = jdp.DeviceAugIterator(jindex, 2, (48, 96), seed=233, **kw)
    for _ in range(2):
        got, want = list(ours.epoch()), list(ref.epoch())
        assert len(got) == len(want) == (3 if pad_last else 2)
        for (gb, gn), (wb, wn) in zip(got, want):
            assert gn == wn
            _assert_batches_close(gb, wb)
        if pad_last:
            assert len(got[-1][1]) == 1 and got[-1][0]["images"].shape[0] == 2
            np.testing.assert_array_equal(got[-1][0]["label_det"][0].numpy(),
                                          got[-1][0]["label_det"][1].numpy())


def test_device_aug_iterator_maskless_and_sharded(dataset, tmp_path):
    """A sample without a mask is filled with 255 (ignore) beside masked ones,
    as in the JAX package; a shard walks its rank::world slice."""
    index, jindex = dataset
    samples = [iterator.Sample(s.image_path, s.label, None if i == 1 else s.seg_path)
               for i, s in enumerate(index.samples)]
    jsamples = [jiter.Sample(s.image_path, s.label, s.seg_path) for s in samples]
    ours = DeviceAugIterator(iterator.SampleIndex(samples), 2, (48, 96), device="cpu", seed=233,
                             shuffle=False, enable_aug=False)
    ref = jdp.DeviceAugIterator(jiter.SampleIndex(jsamples), 2, (48, 96), shuffle=False, enable_aug=False)
    (gb, _), (wb, _) = next(ours.epoch()), next(ref.epoch())
    _assert_batches_close(gb, wb)
    assert (gb["seg_label"][1] == 255).all()
    full = [b for b, _ in DeviceAugIterator(index, 1, (48, 96), device="cpu", seed=233).epoch()]
    half = [b for b, _ in DeviceAugIterator(index, 1, (48, 96), device="cpu", seed=233,
                                            shard=(1, 2)).epoch()]
    assert len(half) == 2
    for k, b in enumerate(half):
        np.testing.assert_array_equal(b["label_det"].numpy(), full[2 * k + 1]["label_det"].numpy())
    np.testing.assert_array_equal(iterator.shard_positions(7, (1, 3)), jiter.shard_positions(7, (1, 3)))


def test_device_aug_iterator_releases_an_abandoned_epoch(dataset):
    """An epoch left after one batch stops its decode and prefetch threads:
    the next epoch starts from the table's first batch again."""
    index, _ = dataset
    it = DeviceAugIterator(index, 1, (48, 96), device="cpu", seed=233, shuffle=False, enable_aug=False)
    before = threading.active_count()
    epoch = it.epoch()
    first, names = next(epoch)
    epoch.close()
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before
    again, again_names = next(it.epoch())
    assert again_names == names
    np.testing.assert_array_equal(again["images"].numpy(), first["images"].numpy())


def test_device_aug_iterator_rejects_mixed_sizes(tmp_path):
    p1, p2 = str(tmp_path / "a.jpg"), str(tmp_path / "b.jpg")
    image_io.imwrite(p1, np.zeros((32, 64, 3), np.uint8))
    image_io.imwrite(p2, np.zeros((64, 64, 3), np.uint8))
    empty = iterator.SampleIndex.pad_label(np.zeros((0, 6), np.float32))
    idx = iterator.SampleIndex([iterator.Sample(p1, empty), iterator.Sample(p2, empty)])
    it = DeviceAugIterator(idx, 2, (32, 64), device="cpu", seed=233, shuffle=False)
    with pytest.raises(ValueError, match="mixed raw resolutions"):
        next(it.epoch())


@pytest.mark.parametrize("raw,shape", [((96, 192), (48, 96)), ((128, 256), (32, 64)), ((90, 150), (48, 96))])
def test_predownscale_resizes_match_cv2(rng, raw, shape):
    """The predownscale resizes against the JAX package's cv2 calls: masks
    (nearest) equal cv2's INTER_NEAREST; images equal cv2's INTER_AREA at an
    integer factor (2 and 4 here; the bound stated is one level), within one
    level of it elsewhere."""
    img = cv2.GaussianBlur(rng.randint(0, 256, raw + (3,)).astype(np.uint8), (3, 3), 1.0)
    mask = rng.randint(0, 34, (raw[0] // 3 + 1, raw[1] // 3 + 1)).astype(np.uint8)
    mask = cv2.resize(mask, raw[::-1], interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(image_io.resize_nearest(mask, shape),
                                  cv2.resize(mask, shape[::-1], interpolation=cv2.INTER_NEAREST))
    got = device_pipeline.resize_area(torch.from_numpy(img), shape).numpy()
    want = cv2.resize(img, shape[::-1], interpolation=cv2.INTER_AREA)
    d = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape and d.max() <= 1, d.max()
    if raw[0] % shape[0] == 0 and raw[1] % shape[1] == 0:
        assert raw[0] // shape[0] == 4 or d.max() == 0  # factor 2: cv2's (sum + 2) >> 2
    batch = device_pipeline.resize_area(torch.from_numpy(np.stack([img, img[::-1]])), shape)
    np.testing.assert_array_equal(batch[0].numpy(), got)


def test_device_aug_iterator_predownscale_matches_jax(tmp_path):
    """predownscale=True in both packages over a dataset at twice the data
    shape, with one image at another raw size: the same batches (the one
    place the JAX package resizes with cv2 and the port with its own ops)."""
    index = synthetic.build_dataset(str(tmp_path / "big"), num_samples=3, hw=(96, 192), seed=4)
    other = synthetic.build_dataset(str(tmp_path / "odd"), num_samples=1, hw=(144, 288), seed=6)
    samples = index.samples + other.samples
    jindex = jiter.SampleIndex([jiter.Sample(s.image_path, s.label, s.seg_path) for s in samples])
    for enable_aug in (True, False):
        kw = dict(enable_aug=enable_aug, shuffle=enable_aug, num_threads=2, predownscale=True)
        got = list(DeviceAugIterator(iterator.SampleIndex(samples), 2, (48, 96), device="cpu", seed=233,
                                     **kw).epoch())
        want = list(jdp.DeviceAugIterator(jindex, 2, (48, 96), seed=233, **kw).epoch())
        assert len(got) == len(want) == 2
        for (gb, gn), (wb, wn) in zip(got, want):
            assert gn == wn
            _assert_batches_close(gb, wb)
    with pytest.raises(ValueError, match="mixed raw resolutions"):
        list(DeviceAugIterator(iterator.SampleIndex(samples), 4, (48, 96), device="cpu", seed=233,
                               shuffle=False).epoch())


def test_load_sample_arrays_spans_and_paths(dataset, tmp_path):
    """A span-backed sample (bytes at an offset of one store file) decodes to
    the same arrays as its path-backed twin, and to what the JAX package
    decodes."""
    index, _ = dataset
    store = str(tmp_path / "store.bin")
    samples = []
    with open(store, "wb") as f:
        f.write(b"header")
        for s in index.samples[:2]:
            spans = []
            for p in (s.image_path, s.seg_path):
                data = open(p, "rb").read()
                spans.append((store, f.tell(), len(data)))
                f.write(data)
            samples.append(iterator.Sample(s.image_path, s.label, s.seg_path, *spans))
    for s in samples:
        img, seg = iterator.load_sample_arrays(s)
        img2, seg2 = iterator.load_sample_arrays(iterator.Sample(s.image_path, s.label, s.seg_path))
        jimg, jseg = jiter.load_sample_arrays(jiter.Sample(s.image_path, s.label, s.seg_path,
                                                           s.image_span, s.seg_span))
        for a, b in ((img, img2), (seg, seg2), (img, jimg), (seg, jseg)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert iterator.load_sample_arrays(s, with_seg=False)[1] is None


# ------------------------------------------------------------- prefetch


def test_prefetch_to_device_on_the_cpu():
    """Arrays become tensors, other leaves pass, the order holds; an error in
    the producer is raised in the consumer; an abandoned generator releases
    its thread and closes its source."""
    items = [({"x": np.full((2,), i, np.float32), "t": torch.tensor([i])}, [f"n{i}"]) for i in range(5)]
    out = list(prefetch_to_device(iter(items), size=2, device="cpu"))
    assert [o[1] for o in out] == [i[1] for i in items]
    assert all(isinstance(o[0]["x"], torch.Tensor) and float(o[0]["x"][0]) == k for k, o in enumerate(out))

    def broken():
        yield {"x": np.zeros(1)}
        raise OSError("decode failed")

    with pytest.raises(OSError, match="decode failed"):
        list(prefetch_to_device(broken(), device="cpu"))

    closed = threading.Event()

    def endless():
        try:
            while True:
                yield {"x": np.zeros(1)}
        finally:
            closed.set()

    before = threading.active_count()
    gen = prefetch_to_device(endless(), size=2, device="cpu")
    next(gen)
    gen.close()
    assert closed.wait(5.0)
    assert threading.active_count() <= before
