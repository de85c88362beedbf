"""nvJPEG and the colour kernel on the card against the plain JPEG decoder
(which equals libjpeg's pixels, ``tests/test_torch_jpeg.py``), at the gates
of ``jpeg_cuda.GATES``, and the colour kernel against its plain version bit
for bit.

Skips without a CUDA device. The file imports no jax, so it also runs on a
machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_jpeg_cuda.py
"""

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
