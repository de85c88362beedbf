"""The port's plain JPEG codec (``dspnet_torch/data/jpeg.py``) against cv2
(libjpeg-turbo) and the JAX package, on the CPU.

Decoder: bit for bit equal to ``cv2.imdecode`` on cv2-written files at
quality 75 and 95, 4:4:4 / 4:2:2 / 4:2:0, gray, with restart markers, at
sizes that are not multiples of the MCU (down to components 1 and 2 samples
wide, which libjpeg-turbo replicates), with optimised Huffman tables, and
on the JAX package's own synthetic images. No case needs a tolerance.
Encoder: cv2 decodes the port's bytes to exactly the plain decoder's
pixels; the PSNR against the source is within 1 dB of cv2's at the same
quality; the JAX loader reads a dataset the port wrote to the port's arrays.
"""

import numpy as np
import pytest

import cv2

from dspnet_tpu.data import iterator as jiter
from dspnet_tpu.data import synthetic as jsyn
from dspnet_torch.data import image_io, iterator, jpeg, synthetic

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def _scene(rng, hw, kind):
    """noise (every coefficient busy), smooth (blurred noise) or a street
    scene (flat regions and sharp colour edges)."""
    if kind == "street":
        return synthetic.make_example(rng, hw, 4)[0]
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 1.5) if kind == "smooth" else img


def _psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))


@pytest.mark.parametrize("hw", [(64, 96), (37, 53), (3, 3), (5, 4), (17, 33)])
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("sub", ["444", "422", "420"])
def test_decoder_equals_cv2(rng, hw, quality, sub):
    """cv2-written colour JPEGs (noise, smooth and street scenes; the
    smooth one with a restart marker every 2 MCUs) decode to cv2's pixels."""
    for kind, extra in (("noise", []), ("smooth", [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]), ("street", [])):
        img = _scene(rng, hw, kind) if kind != "street" or min(hw) >= 16 else _scene(rng, hw, "noise")
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sub], *extra])
        got = jpeg.decode(buf.tobytes())
        want = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
        assert got.dtype == np.uint8 and got.shape == want.shape == hw + (3,), (kind, got.shape)
        np.testing.assert_array_equal(got, want, err_msg=kind)
        assert jpeg.read_header(buf.tobytes()) == (*hw, 3)


@pytest.mark.parametrize("hw", [(64, 96), (37, 53), (1, 1)])
def test_decoder_equals_cv2_gray_and_optimised_tables(rng, hw):
    """Gray JPEGs (one plane, replicated under IMREAD_COLOR) and files with
    optimised Huffman tables."""
    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    ok, buf = cv2.imencode(".jpg", img[..., 0], [cv2.IMWRITE_JPEG_QUALITY, 90])
    np.testing.assert_array_equal(jpeg.decode(buf.tobytes()), cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(image_io.imdecode(buf), cv2.imdecode(buf, cv2.IMREAD_COLOR))
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_QUALITY, 85])
    np.testing.assert_array_equal(jpeg.decode(buf.tobytes()), cv2.imdecode(buf, cv2.IMREAD_COLOR))


def test_decoder_equals_cv2_on_the_jax_dataset(tmp_path):
    """The JAX package's synthetic dataset (cv2.imwrite, quality 95, 4:2:0)
    through the port's loader and through the JAX loader."""
    index = jsyn.build_dataset(str(tmp_path / "j"), num_samples=3, hw=(96, 160), seed=5)
    for s in index.samples:
        img, seg = iterator.load_sample_arrays(iterator.Sample(s.image_path, s.label, s.seg_path))
        jimg, jseg = jiter.load_sample_arrays(s)
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(seg, jseg)


def _patched(data: bytes, offset_from_sof: int, value: int) -> bytes:
    i = data.index(b"\xff\xc0")
    b = bytearray(data)
    b[i + offset_from_sof] = value
    return bytes(b)


def test_decoder_refuses_what_it_does_not_read(rng):
    """Progressive, arithmetic-coded, 12-bit and 4-component streams, and
    damaged data, raise JpegError with a reason."""
    img = _scene(rng, (32, 48), "smooth")
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(jpeg.JpegError, match="progressive"):
        jpeg.decode(prog.tobytes())
    base = jpeg.encode(img)
    with pytest.raises(jpeg.JpegError, match="arithmetic"):
        jpeg.decode(_patched(base, 1, 0xC9))
    with pytest.raises(jpeg.JpegError, match="12-bit"):
        jpeg.decode(_patched(base, 4, 12))
    with pytest.raises(jpeg.JpegError, match="4 components"):
        jpeg.decode(_patched(base, 9, 4))
    with pytest.raises(jpeg.JpegError, match="SOI"):
        jpeg.decode(b"GIF89a")
    sos = base.index(b"\xff\xda")
    with pytest.raises(jpeg.JpegError):
        jpeg.decode(base[:sos + 40] + b"\xff\xd9")
    with pytest.raises(jpeg.JpegError, match="sampling"):
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
        jpeg.decode(buf.tobytes())


@pytest.mark.parametrize("hw", [(64, 128), (37, 53), (3, 3)])
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("sub", ["420", "444", "gray"])
def test_encoder_against_cv2(rng, hw, quality, sub):
    """cv2 decodes the port's bytes to the plain decoder's pixels exactly,
    and the PSNR against the source is within 1 dB of cv2.imwrite's at the
    same quality and subsampling (on images of 64 pixels and more: at 3x3
    one level on one pixel moves the PSNR by about a dB)."""
    for kind in ("smooth", "street" if min(hw) >= 16 else "noise"):
        img = _scene(rng, hw, kind)
        if sub == "gray":
            img = img[..., 1]
        data = jpeg.encode(img, quality, "444" if sub == "gray" else sub)
        ours = jpeg.decode(data)
        np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED), ours)
        params = [cv2.IMWRITE_JPEG_QUALITY, quality]
        if sub != "gray":
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sub]]
        ok, buf = cv2.imencode(".jpg", img, params)
        theirs = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
        if img.shape[0] * img.shape[1] >= 64:
            assert _psnr(ours, img) >= _psnr(theirs, img) - 1.0, (kind, _psnr(ours, img), _psnr(theirs, img))


def test_encoder_tables_are_cv2s(rng):
    """The Annex K Huffman tables and the IJG quality scaling: the port
    writes the tables cv2 writes."""
    ok, buf = cv2.imencode(".jpg", _scene(rng, (16, 16), "noise"), [cv2.IMWRITE_JPEG_QUALITY, 80])
    data = buf.tobytes()
    dht, dqt = {}, {}
    for marker, body, _ in jpeg._segments(data, 2):
        if marker == 0xDA:
            break
        i = 0
        while marker == 0xC4 and i < len(body):
            n = sum(body[i + 1:i + 17])
            dht[body[i]] = (list(body[i + 1:i + 17]), list(body[i + 17:i + 17 + n]))
            i += 17 + n
        if marker == 0xDB:
            dqt[body[0]] = np.frombuffer(body[1:65], np.uint8)
    names = {0x00: "dc_luma", 0x10: "ac_luma", 0x01: "dc_chroma", 0x11: "ac_chroma"}
    assert {k: tuple(v) for k, v in dht.items()} == {k: tuple(jpeg.STD_HUFFMAN[n]) for k, n in names.items()}
    for t, base in ((0, jpeg._STD_LUMA_Q), (1, jpeg._STD_CHROMA_Q)):
        np.testing.assert_array_equal(dqt[t], jpeg.quality_table(base, 80)[jpeg.NATURAL_ORDER])


def test_jax_loader_reads_a_port_dataset(tmp_path):
    """A dataset the port wrote (JPEG images) reads to the same arrays in the
    JAX loader (cv2) and in the port's."""
    index = synthetic.build_dataset(str(tmp_path / "t"), num_samples=3, hw=(96, 160), seed=8)
    for s in index.samples:
        img, seg = iterator.load_sample_arrays(s)
        jimg, jseg = jiter.load_sample_arrays(jiter.Sample(s.image_path, s.label, s.seg_path))
        assert open(s.image_path, "rb").read(3) == image_io.JPEG_MAGIC
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(seg, jseg)


def test_decode_counter():
    """Every plain decode is counted (the card's loader path must leave the
    count at 0)."""
    data = jpeg.encode(np.zeros((8, 8, 3), np.uint8))
    before = jpeg.decodes
    jpeg.decode(data)
    image_io.imdecode(data)
    assert jpeg.decodes == before + 2


# ------------------------------------------------- planes, colour, orientation


@pytest.mark.parametrize("hw", [(64, 96), (37, 53), (3, 3), (17, 33), (9, 2), (2, 5), (1, 1)])
@pytest.mark.parametrize("sub", ["444", "422", "420"])
def test_plain_colour_function_equals_the_plain_decoder(rng, hw, sub):
    """``jpeg_cuda.ycc_to_bgr_reference`` (integer tensor ops, the colour
    kernel's plain version) on ``jpeg.decode_planes``' planes gives
    ``jpeg.decode``'s pixels bit for bit (and so cv2's), at odd sizes and at
    chroma planes 1 and 2 samples wide."""
    import torch

    from dspnet_torch.data import jpeg_cuda

    img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         SAMPLING[sub]])
    planes, info = jpeg.decode_planes(buf.tobytes())
    fh, fv = info.factors
    assert info.factors == {"444": (1, 1), "422": (2, 1), "420": (2, 2)}[sub]
    assert [p.shape for p in planes] == [hw] + [(-(-hw[0] // fv), -(-hw[1] // fh))] * 2
    before = jpeg_cuda.color_plain_calls
    got = jpeg_cuda.ycc_to_bgr(*[torch.from_numpy(p) for p in planes], factors=info.factors)
    assert jpeg_cuda.color_plain_calls == before + 1
    np.testing.assert_array_equal(got.numpy(), cv2.imdecode(buf, cv2.IMREAD_COLOR))
    gray = jpeg_cuda.ycc_to_bgr(torch.from_numpy(planes[0]))
    assert torch.equal(gray, torch.from_numpy(planes[0])[..., None].expand(*hw, 3))


def _exif(orientation: int, endian: str = "MM") -> bytes:
    """An APP1 Exif segment whose IFD0 holds one Orientation entry."""
    import struct

    e = ">" if endian == "MM" else "<"
    tiff = (endian.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(e + "I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("endian", ["MM", "II"])
def test_exif_orientation_equals_cv2(rng, tmp_path, orientation, endian):
    """An Exif Orientation tag spliced into an encoded JPEG: the plain
    decoder turns the image as ``cv2.imdecode`` and ``cv2.imread`` do
    (both apply it under IMREAD_COLOR), colour and gray; IMREAD_UNCHANGED
    leaves it as stored, as cv2 does."""
    img = rng.randint(0, 256, (24, 40, 3)).astype(np.uint8)
    for src in (img, img[..., 0]):
        data = jpeg.encode(src, 90)
        data = data[:2] + _exif(orientation, endian) + data[2:]
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        path = tmp_path / "o.jpg"
        path.write_bytes(data)
        np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_COLOR), want)
        np.testing.assert_array_equal(image_io.imread(str(path)), want)
        assert jpeg.read_info(data).orientation == orientation
        stored = image_io.imdecode(data, image_io.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(stored, cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("hw", [(64, 96), (37, 53), (3, 3), (1, 1)])
@pytest.mark.parametrize("sub", ["444", "422", "420", "gray"])
def test_encoder_422_and_progressive(rng, hw, sub):
    """4:2:2 and progressive files from the port's encoder: cv2 decodes the
    baseline file to the plain decoder's pixels, and the progressive file
    (the same coefficients) to the same pixels; the plain decoder refuses
    the progressive one, and ``read_info`` reads its header."""
    img = cv2.GaussianBlur(rng.randint(0, 256, hw + (3,)).astype(np.uint8), (5, 5), 1.5)
    src = img[..., 0].copy() if sub == "gray" else img
    kw = {} if sub == "gray" else {"subsampling": sub}
    base, prog = jpeg.encode(src, 90, **kw), jpeg.encode(src, 90, progressive=True, **kw)
    want = cv2.imdecode(np.frombuffer(base, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(jpeg.decode(base), want)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(prog, np.uint8), cv2.IMREAD_UNCHANGED), want)
    info = jpeg.read_info(prog)
    assert info.progressive and not jpeg.read_info(base).progressive
    assert (info.height, info.width, info.components) == (*hw, 1 if sub == "gray" else 3)
    with pytest.raises(jpeg.JpegError, match="progressive"):
        jpeg.decode(prog)
