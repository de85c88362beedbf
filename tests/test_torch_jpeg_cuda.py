"""nvJPEG and the colour kernel on the card against the plain JPEG decoder
(which equals libjpeg's pixels, ``tests/test_torch_jpeg.py``), at the gates
of ``jpeg_cuda.GATES``, and the colour kernel against its plain version bit
for bit.

Skips without a CUDA device. The file imports no jax, so it also runs on a
machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_jpeg_cuda.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dspnet_torch.data import iterator, jpeg, jpeg_cuda, synthetic

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: nvJPEG decodes on the card")
    return torch.device("cuda:0")


def _scenes(hw, n, seed):
    rng = np.random.RandomState(seed)
    return [synthetic.make_example(rng, hw, 4)[0] for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("sub", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("hw", [(256, 512), (64, 128), (37, 53)])
def test_nvjpeg_matches_the_plain_decoder_within_the_gates(cuda_device, sub, hw):
    """A batch of the port's JPEGs: the card's BGR pixels (nvJPEG's planes,
    then the colour kernel) against the plain decoder's, mean |difference|
    within the gate at every size; every image decoded and counted once,
    one colour launch per image, the plain colour function never called."""
    imgs = _scenes(hw, 3, seed=hw[0])
    if sub == "gray":
        imgs = [im[..., 1] for im in imgs]
    data = [jpeg.encode(im, 95, "444" if sub == "gray" else sub) for im in imgs]
    jpeg_cuda.launches = jpeg_cuda.images = jpeg_cuda.color_launches = jpeg_cuda.color_plain_calls = 0
    got = jpeg_cuda.decode_batch(data, cuda_device)
    assert (jpeg_cuda.launches, jpeg_cuda.images, jpeg_cuda.color_launches) == (1, 3, 3)
    assert jpeg_cuda.color_plain_calls == 0
    assert got.shape == (3, *hw, 3) and got.dtype == torch.uint8 and got.device == cuda_device
    want = jpeg_cuda.decode_batch(data, "cpu")
    diff = jpeg_cuda.difference(got.cpu().numpy(), want.numpy())
    print(f"card vs plain, {sub} {hw}: {diff}")
    assert diff["mean"] <= jpeg_cuda.GATES[sub], diff


@pytest.mark.cuda
@pytest.mark.parametrize("sub", ["420", "422", "444", "gray"])
@pytest.mark.parametrize("hw", [(256, 512), (37, 53), (9, 2)])
def test_color_kernel_equals_its_plain_version(cuda_device, sub, hw):
    """The colour kernel on the planes nvJPEG returned, bit for bit against
    the plain PyTorch colour function on the same planes."""
    imgs = _scenes(hw, 2, seed=7) if min(hw) >= 16 else [np.random.RandomState(7).randint(
        0, 256, hw + (3,)).astype(np.uint8) for _ in range(2)]
    if sub == "gray":
        imgs = [im[..., 1] for im in imgs]
    data = [jpeg.encode(im, 90, "444" if sub == "gray" else sub) for im in imgs]
    for planes, info in jpeg_cuda.decode_planes(data, cuda_device):
        got = jpeg_cuda.ycc_to_bgr(*planes, factors=info.factors)
        want = jpeg_cuda.ycc_to_bgr_reference(*planes, factors=info.factors)
        assert torch.equal(got, want)
        cpu = jpeg_cuda.ycc_to_bgr(*[p.cpu() for p in planes], factors=info.factors)
        assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
def test_nvjpeg_progressive_and_exif_orientation(cuda_device):
    """A progressive file takes the single-image route and decodes to the
    pixels of the baseline file with the same coefficients; an Exif
    orientation turns the card's image as it turns the plain decoder's."""
    img = _scenes((64, 128), 1, 3)[0]
    base = jpeg.encode(img, 95)
    prog = jpeg.encode(img, 95, progressive=True)
    jpeg_cuda.routes.update(dict.fromkeys(jpeg_cuda.routes, 0))
    got = jpeg_cuda.decode_images([base, prog], cuda_device)
    assert jpeg_cuda.routes["single_progressive"] == 1
    assert torch.equal(got[0], got[1])
    for o in range(1, 9):
        data = base[:2] + _exif_app1(o) + base[2:]
        card = jpeg_cuda.decode_images([data], cuda_device)[0].cpu().numpy()
        np.testing.assert_array_equal(card, jpeg.orient(got[0].cpu().numpy(), o))
        assert card.shape == jpeg.decode(data).shape


def _exif_app1(orientation: int) -> bytes:
    tiff = b"MM\x00\x2a" + (8).to_bytes(4, "big") + (1).to_bytes(2, "big") + bytes.fromhex("0112000300000001") \
        + orientation.to_bytes(2, "big") + b"\x00\x00" + bytes(4)
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + (len(body) + 2).to_bytes(2, "big") + body


@pytest.mark.cuda
def test_nvjpeg_image_info_and_mixed_sizes(cuda_device):
    """Sizes from nvjpegGetImageInfo; mixed sizes decode as a list and are
    refused as one batch."""
    imgs = _scenes((64, 128), 1, 0) + _scenes((48, 96), 1, 1)
    data = [jpeg.encode(im, 95) for im in imgs]
    assert jpeg_cuda.image_info(data[0], cuda_device) == (3, 2, 64, 128)
    assert jpeg_cuda.component_sizes(data[0], cuda_device)[1] == (32, 64)
    outs = jpeg_cuda.decode_images(data, cuda_device)
    assert [tuple(o.shape) for o in outs] == [(64, 128, 3), (48, 96, 3)]
    for o, d in zip(outs, data):
        diff = jpeg_cuda.difference(o.cpu().numpy(), jpeg.decode(d))
        assert diff["mean"] <= jpeg_cuda.GATES["420"], diff
    with pytest.raises(ValueError, match="mixed raw resolutions"):
        jpeg_cuda.decode_batch(data, cuda_device)


@pytest.mark.cuda
def test_nvjpeg_hardware_backend_where_supported(cuda_device):
    """The H100's JPEG engines, where nvjpegDecodeBatchedSupported allows
    them, within the same gate."""
    data = [jpeg.encode(im, 95) for im in _scenes((256, 512), 2, 5)]
    if not jpeg_cuda.backend_available(jpeg_cuda.BACKEND_HARDWARE, cuda_device):
        pytest.skip("nvJPEG has no hardware backend on this card (architecture mismatch)")
    if not jpeg_cuda.batched_supported(data[0], cuda_device, jpeg_cuda.BACKEND_HARDWARE):
        pytest.skip("the hardware backend does not take these streams on this card")
    got = jpeg_cuda.decode_batch(data, cuda_device, backend=jpeg_cuda.BACKEND_HARDWARE)
    diff = jpeg_cuda.difference(got.cpu().numpy(), jpeg_cuda.decode_batch(data, "cpu").numpy())
    print(f"nvJPEG hardware backend vs plain, 420: {diff}")
    assert diff["mean"] <= jpeg_cuda.GATES["420"], diff


@pytest.mark.cuda
def test_nvjpeg_refuses_what_it_cannot_decode(cuda_device):
    with pytest.raises((RuntimeError, jpeg.JpegError), match="nvJPEG|nvjpeg|JPEG"):
        jpeg_cuda.decode_batch([b"\xff\xd8\xff\xe0garbage"], cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("predownscale", [False, True])
def test_loader_decodes_jpeg_on_the_card(cuda_device, tmp_path, predownscale):
    """DeviceAugIterator on the card: nvJPEG decodes every image once (the
    plain decoder never runs), and the batches equal the CPU pipeline's on
    the images nvJPEG decoded (labels and masks exactly, images to 1e-3;
    the decoders' own difference is the test above)."""
    from dspnet_torch.data.device_pipeline import DeviceAugIterator, device_augment_batch, resize_area

    index = synthetic.build_dataset(str(tmp_path / "d"), num_samples=4, hw=(128, 256), seed=3)
    kw = dict(seed=233, enable_aug=False, shuffle=False, predownscale=predownscale, num_threads=2)
    jpeg_cuda.images = 0
    before = jpeg.decodes
    it = DeviceAugIterator(index, 2, (64, 128), device=cuda_device, **kw)
    card = list(it.epoch())
    assert jpeg.decodes == before and jpeg_cuda.images == 4
    cpu = list(DeviceAugIterator(index, 2, (64, 128), device="cpu", **kw).epoch())
    for k, ((cb, cn), (pb, pn)) in enumerate(zip(card, cpu)):
        assert cn == pn and cb["images"].device == cuda_device
        torch.testing.assert_close(cb["label_det"].cpu(), pb["label_det"], rtol=0, atol=1e-5)
        assert torch.equal(cb["seg_label"].cpu(), pb["seg_label"])
        data = [open(s.image_path, "rb").read() for s in index.samples[2 * k:2 * k + 2]]
        raw = jpeg_cuda.decode_batch(data, cuda_device).cpu()
        if predownscale:
            raw = resize_area(raw, (64, 128))
        segs = torch.stack([torch.from_numpy(iterator.load_sample_arrays(s)[1])
                            for s in index.samples[2 * k:2 * k + 2]])
        if predownscale:
            segs = segs[:, ::2, ::2]
        want = device_augment_batch(raw, segs, pb["label_det"], torch.zeros(2, 6), it.lut.cpu(), (64, 128),
                                    enable_aug=False)
        torch.testing.assert_close(cb["images"].cpu(), want["images"], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_loader_on_the_card_refuses_mixed_raw_sizes(cuda_device, tmp_path):
    """Mixed raw sizes raise the loader's error from the frame headers,
    before any decode."""
    from dspnet_torch.data.device_pipeline import DeviceAugIterator

    a = synthetic.build_dataset(str(tmp_path / "a"), num_samples=1, hw=(64, 128), seed=1)
    b = synthetic.build_dataset(str(tmp_path / "b"), num_samples=1, hw=(96, 128), seed=2)
    it = DeviceAugIterator(iterator.SampleIndex(a.samples + b.samples), 2, (64, 128), device=cuda_device,
                           seed=233, shuffle=False)
    jpeg_cuda.images = 0
    with pytest.raises(ValueError, match="mixed raw resolutions"):
        next(it.epoch())
    assert jpeg_cuda.images == 0


FORMS = Path(__file__).resolve().parent / "fixtures" / "video" / "jpeg_forms"


@pytest.mark.cuda
@pytest.mark.parametrize("color", ["ycc", "rgb", "cmyk", "ycck"])
@pytest.mark.parametrize("factors", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("hw", [(64, 96), (37, 53), (5, 2)])
def test_color_kernel_modes_equal_their_plain_version(cuda_device, color, factors, hw):
    """Every mode of the colour kernel (YCbCr, RGB-coded, CMYK, YCCK; the
    fourth plane at full size and at the chroma's) on random planes, bit for
    bit against the plain PyTorch colour function on the same planes."""
    rng = np.random.RandomState(hw[0] + factors[0] + factors[1])
    H, W = hw
    fh, fv = factors
    ch, cw = -(-H // fv), -(-W // fh)
    y, cb, cr = (torch.from_numpy(rng.randint(0, 256, s).astype(np.uint8)).to(cuda_device)
                 for s in ((H, W), (ch, cw), (ch, cw)))
    ks = [None] if color in ("ycc", "rgb") else [
        torch.from_numpy(rng.randint(0, 256, s).astype(np.uint8)).to(cuda_device) for s in {(H, W), (ch, cw)}]
    for k in ks:
        before = jpeg_cuda.color_launches
        got = jpeg_cuda.ycc_to_bgr(y, cb, cr, factors=factors, color=color, k=k)
        assert jpeg_cuda.color_launches == before + 1
        want = jpeg_cuda.ycc_to_bgr_reference(y, cb, cr, factors=factors, color=color, k=k)
        assert torch.equal(got, want), (color, factors, hw, None if k is None else tuple(k.shape))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(p.name for p in FORMS.glob("*.jpg")))
def test_nvjpeg_on_the_other_forms(cuda_device, name):
    """cv2's progressive files, a DHT-less file (Annex K's tables inserted
    before nvJPEG), Pillow's RGB-coded, CMYK and YCCK files: the card's
    pixels within the gate of the plain decoder's (which equal cv2's,
    ``tests/test_torch_jpeg.py``), the colour kernel equal to its plain
    version on nvJPEG's planes; or, where nvJPEG refuses the form, a
    ``JpegError`` that names it (there is no fallback to the plain decoder)."""
    data = (FORMS / name).read_bytes()
    info = jpeg.read_info(data)
    jpeg.decodes = 0
    try:
        got = jpeg_cuda.decode_images([data], cuda_device)[0]
    except jpeg.JpegError as e:
        assert info.color in str(e) and "nvJPEG" in str(e), e
        print(f"{name}: nvJPEG refuses it: {e}")
        return
    assert jpeg.decodes == 0
    want = jpeg.decode(data)
    want = np.repeat(want[..., None], 3, -1) if want.ndim == 2 else want
    diff = jpeg_cuda.difference(got.cpu().numpy(), want)
    print(f"{name} ({info.color}): card vs plain {diff}")
    assert diff["mean"] <= jpeg_cuda.GATES["420"], diff
    (planes, pinfo), = jpeg_cuda.decode_planes([data], cuda_device)
    k = planes[3] if len(planes) == 4 else None
    assert torch.equal(jpeg_cuda.ycc_to_bgr(*planes[:3], factors=pinfo.factors, color=pinfo.color, k=k),
                       jpeg_cuda.ycc_to_bgr_reference(*planes[:3], factors=pinfo.factors, color=pinfo.color, k=k))


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(256, 512), (37, 53)])
def test_nvjpeg_encoder(cuda_device, hw):
    """The card's encoder (nvjpegEncodeImage): baseline JFIF at q95 4:2:0
    that the plain decoder and nvJPEG read, within ``jpeg_cuda.ENCODE_GATE_DB``
    of the plain encoder's PSNR against the source; counted in ``encodes``,
    the plain encoder not called; q75 writes fewer bytes; a CPU tensor takes
    the plain encoder."""
    img = _scenes(hw, 1, 11)[0]
    t = torch.from_numpy(img).to(cuda_device)
    jpeg.encodes = 0
    before = jpeg_cuda.encodes
    data = jpeg_cuda.encode(t)
    assert jpeg_cuda.encodes == before + 1 and jpeg.encodes == 0
    info = jpeg.read_info(data)
    assert (info.height, info.width, info.components, info.progressive, info.factors) == (*hw, 3, False, (2, 2))
    plain = jpeg.encode(img, 95)
    got = jpeg.decode(data)
    print(f"nvJPEG q95 {hw}: {len(data)} bytes, PSNR {_psnr(got, img):.2f} dB; plain encoder {len(plain)} bytes, "
          f"{_psnr(jpeg.decode(plain), img):.2f} dB")
    assert _psnr(got, img) >= _psnr(jpeg.decode(plain), img) - jpeg_cuda.ENCODE_GATE_DB
    card = jpeg_cuda.decode_images([data], cuda_device)[0].cpu().numpy()
    assert jpeg_cuda.difference(card, got)["mean"] <= jpeg_cuda.GATES["420"]
    assert len(jpeg_cuda.encode(t, 75)) < len(data)
    assert jpeg_cuda.encode(t.cpu()) == plain


JPEG_FORMS = Path(__file__).resolve().parent / "fixtures" / "jpeg_forms"
JPEG_FORMS_META = json.loads((JPEG_FORMS / "forms.json").read_text())["files"]


def expected_route(info: jpeg.Info) -> str:
    """The route ``jpeg_cuda`` must choose from a file's header."""
    if info.lossless:
        return "host_lossless"
    if info.coding == "arithmetic" or (info.progressive and info.restart):
        return "transcoded"
    if info.color not in ("ycc", "gray"):
        return "single_unchanged"
    return "single_progressive" if info.progressive else "batched"


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(JPEG_FORMS_META))
def test_forms_on_the_card(cuda_device, name):
    """Every committed form on the card, its route chosen from the header
    (arithmetic-coded and progressive-with-restart files transcoded to
    baseline for nvJPEG, lossless ones reconstructed on the host), never a
    plain decode: a lossless file equal to cv2's pixels (forms.json's
    sha256), a DCT form within the gate of the plain decoder, the colour
    kernel equal to its plain version on the planes; what cv2 refuses
    (12-bit, fractional sampling, a gray lossless file in colour) raises
    by name, and so does a form nvJPEG refuses."""
    import hashlib

    data = (JPEG_FORMS / name).read_bytes()
    meta = JPEG_FORMS_META[name]
    jpeg.decodes = 0
    jpeg_cuda.routes.update(dict.fromkeys(jpeg_cuda.routes, 0))
    if meta["cv2"]["color"] is None:
        with pytest.raises(jpeg.JpegError, match="12-bit|fractional|lossless"):
            jpeg_cuda.decode_images([data], cuda_device)
        return
    info = jpeg.read_info(data)
    route = expected_route(info)
    try:
        got = jpeg_cuda.decode_images([data], cuda_device)[0].cpu().numpy()
    except jpeg.JpegError as e:  # nvJPEG refuses the form: by name, no fallback
        assert route not in ("host_lossless",) and "nvJPEG" in str(e), e
        print(f"{name}: refused on the card: {e}")
        return
    assert jpeg.decodes == 0
    assert jpeg_cuda.routes[route] == 1 and sum(jpeg_cuda.routes.values()) == 1, jpeg_cuda.routes
    if info.lossless:
        assert hashlib.sha256(got.tobytes()).hexdigest() == meta["cv2"]["color"]["sha256"]
    else:
        want = jpeg.decode(data)
        want = np.repeat(want[..., None], 3, -1) if want.ndim == 2 else want
        diff = jpeg_cuda.difference(got, want)
        print(f"{name} ({route}): card vs plain {diff}")
        assert diff["mean"] <= jpeg_cuda.GATES["420"], diff
    (planes, pinfo), = jpeg_cuda.decode_planes([data], cuda_device)
    k = planes[3] if len(planes) == 4 else None
    kw = dict(color=pinfo.color, k=k, fancy=not pinfo.lossless, upsampling=pinfo.upsampling,
              size=(pinfo.height, pinfo.width))
    assert torch.equal(jpeg_cuda.ycc_to_bgr(*planes[:3], **kw), jpeg_cuda.ycc_to_bgr_reference(*planes[:3], **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("fancy", [True, False])
@pytest.mark.parametrize("factors", [(1, 2), (4, 1), (4, 2), (1, 4), (3, 1), (1, 3), (2, 4), (4, 4), (2, 1), (2, 2)])
@pytest.mark.parametrize("hw", [(64, 96), (37, 53), (5, 2)])
def test_color_kernel_geometries_equal_their_plain_version(cuda_device, factors, fancy, hw):
    """The colour kernel at every chroma factor up to 4 (h1v2 fancy for
    4:4:0, replication for 4:1:1 and the rest, and everywhere without
    ``fancy``), in the YCbCr, RGB and CMYK modes, and with the first
    component subsampled too (each plane at its own factors), bit for bit
    against its plain version on random planes."""
    rng = np.random.RandomState(hw[0] + 7 * factors[0] + factors[1])
    H, W = hw
    fh, fv = factors
    ch, cw = -(-H // fv), -(-W // fh)
    y, cb, cr, k = (torch.from_numpy(rng.randint(0, 256, s).astype(np.uint8)).to(cuda_device)
                    for s in ((H, W), (ch, cw), (ch, cw), (ch, cw)))
    for color in ("ycc", "rgb", "cmyk"):
        kk = k if color == "cmyk" else None
        before = jpeg_cuda.color_launches
        got = jpeg_cuda.ycc_to_bgr(y, cb, cr, factors=factors, color=color, k=kk, fancy=fancy)
        assert jpeg_cuda.color_launches == before + 1
        want = jpeg_cuda.ycc_to_bgr_reference(y, cb, cr, factors=factors, color=color, k=kk, fancy=fancy)
        assert torch.equal(got, want), (color, factors, fancy, hw)
    # the first component at these factors, the chroma at full size
    up = [factors, (1, 1), (1, 1)]
    full = [torch.from_numpy(rng.randint(0, 256, (H, W)).astype(np.uint8)).to(cuda_device) for _ in range(2)]
    got = jpeg_cuda.ycc_to_bgr(cb, *full, upsampling=up, size=hw, fancy=fancy)
    assert torch.equal(got, jpeg_cuda.ycc_to_bgr_reference(cb, *full, upsampling=up, size=hw, fancy=fancy))


@pytest.mark.cuda
def test_mixed_forms_in_one_call(cuda_device):
    """One call over an arithmetic, a lossless, a 4:1:1, a progressive-with-
    restart and a baseline file: each route counted once, each image as it
    decodes alone."""
    names = ["arith_seq_420_street.jpg", "lossless_rgb_p7_pt2_rst.jpg", "samp_4x1_1x1.jpg", "prog_rst2_420.jpg",
             "samp_2x2_1x1.jpg"]
    data = [(JPEG_FORMS / n).read_bytes() for n in names]
    jpeg_cuda.routes.update(dict.fromkeys(jpeg_cuda.routes, 0))
    jpeg.decodes = 0
    got = jpeg_cuda.decode_images(data, cuda_device)
    assert jpeg.decodes == 0
    assert (jpeg_cuda.routes["transcoded"], jpeg_cuda.routes["host_lossless"], jpeg_cuda.routes["batched"]) == (2, 1, 2)
    for g, d in zip(got, data):
        assert torch.equal(g, jpeg_cuda.decode_images([d], cuda_device)[0])
