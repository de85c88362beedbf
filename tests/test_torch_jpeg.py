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

import hashlib
import json
from pathlib import Path

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
    """Arithmetic-coded lossless and hierarchical frames (no writer here
    makes one, so their frame markers are patched in), 12-bit and
    5-component streams, a progressive file whose scans stop short (libjpeg
    would smooth it), and damaged data, raise JpegError with a reason.
    Written 12-bit files and fractional sampling factors, which cv2 refuses
    too, are among the committed forms (``test_forms_equal_cv2``)."""
    img = _scene(rng, (32, 48), "smooth")
    base = jpeg.encode(img)
    with pytest.raises(jpeg.JpegError, match="arithmetic-coded lossless"):
        jpeg.decode(_patched(base, 1, 0xCB))
    with pytest.raises(jpeg.JpegError, match="differential"):
        jpeg.read_info(_patched(base, 1, 0xC5))
    with pytest.raises(jpeg.JpegError, match="12-bit"):
        jpeg.decode(_patched(base, 4, 12))
    with pytest.raises(jpeg.JpegError, match="5 components"):
        jpeg.decode(_patched(base, 9, 5))
    with pytest.raises(jpeg.JpegError, match="SOI"):
        jpeg.decode(b"GIF89a")
    sos = base.index(b"\xff\xda")
    with pytest.raises(jpeg.JpegError):
        jpeg.decode(base[:sos + 40] + b"\xff\xd9")
    with pytest.raises(jpeg.JpegError, match="sampling factors 5x1"):
        jpeg.read_info(_patched(base, 11, 0x51))
    # the DC scan alone: every AC coefficient still unsent, which libjpeg smooths
    prog = jpeg.encode(img, progressive=True)
    first_ac = prog.index(b"\xff\xda", prog.index(b"\xff\xda") + 2)
    with pytest.raises(jpeg.JpegError, match="smooth"):
        jpeg.decode(prog[:first_ac] + b"\xff\xd9")


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
    (the same coefficients) to the same pixels; the plain decoder reads the
    progressive one back to them too, and ``read_info`` reads its header."""
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
    np.testing.assert_array_equal(jpeg.decode(prog), want)


# ------------------------------------------------- progressive, DHT-less, RGB, CMYK


@pytest.mark.parametrize("hw", [(64, 96), (37, 53), (17, 33), (3, 3), (9, 2), (1, 1)])
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("sub", ["444", "422", "420", "gray"])
def test_progressive_equals_cv2(rng, hw, quality, sub):
    """cv2's progressive files (libjpeg's scan script: DC first and
    refinement, AC first with end-of-band runs and AC refinement with
    correction bits) decode to ``cv2.imdecode``'s pixels bit for bit, noise
    and smooth scenes, with and without restart intervals; no case needs
    libjpeg's block smoothing (a complete file is not smoothed)."""
    for kind, extra in (("noise", []), ("smooth", [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
                        ("smooth", [cv2.IMWRITE_JPEG_RST_INTERVAL, 1])):
        img = _scene(rng, hw, kind)
        src = img[..., 0].copy() if sub == "gray" else img
        params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1, *extra]
        if sub != "gray":
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sub]]
        ok, buf = cv2.imencode(".jpg", src, params)
        assert jpeg.read_info(buf.tobytes()).progressive
        np.testing.assert_array_equal(jpeg.decode(buf.tobytes()), cv2.imdecode(buf, cv2.IMREAD_UNCHANGED),
                                      err_msg=f"{kind} {extra}")


def _without_dht(data: bytes) -> bytes:
    """A JPEG with every DHT segment before its first scan removed."""
    import struct

    out, pos = bytearray(data[:2]), 2
    while True:
        marker, (length,) = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])
        if marker != 0xC4:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDA:
            return bytes(out) + data[pos:]


@pytest.mark.parametrize("sub", ["444", "422", "420", "gray"])
def test_dht_less_stream_equals_cv2(rng, sub):
    """A baseline file with its DHT segments stripped (a Motion-JPEG frame's
    form): libjpeg-turbo falls back to the Annex K tables, and so does the
    plain decoder, to cv2's pixels; ``with_default_huffman`` writes those
    tables back into the stream (what the card hands nvJPEG), leaves a
    stream that has its tables as it was, and refuses a table number Annex
    K has no table for."""
    img = _scene(rng, (37, 53), "smooth")
    src = img[..., 0].copy() if sub == "gray" else img
    params = [] if sub == "gray" else [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sub]]
    ok, buf = cv2.imencode(".jpg", src, [cv2.IMWRITE_JPEG_QUALITY, 90, *params])
    bare = _without_dht(buf.tobytes())
    assert b"\xff\xc4" not in bare[:bare.index(b"\xff\xda")]
    want = cv2.imdecode(np.frombuffer(bare, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(want, cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(jpeg.decode(bare), want)
    fixed = jpeg.with_default_huffman(bare)
    assert fixed != bare and b"\xff\xc4" in fixed[:fixed.index(b"\xff\xda")]
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(fixed, np.uint8), cv2.IMREAD_UNCHANGED), want)
    np.testing.assert_array_equal(jpeg.decode(fixed), want)
    assert jpeg.with_default_huffman(buf.tobytes()) == buf.tobytes()
    sos = bare.index(b"\xff\xda")
    odd = bare[:sos + 6] + bytes([0x22]) + bare[sos + 7:]  # the first component asks for tables 2
    with pytest.raises(jpeg.JpegError, match="Huffman table 2"):
        jpeg.decode(odd)


def _pillow(arr, mode, **kw) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("hw", [(64, 96), (37, 53), (1, 1)])
def test_adobe_rgb_equals_cv2(rng, hw):
    """Pillow's ``keep_rgb=True`` file (Adobe transform 0, components coded
    as R, G, B): no colour conversion, BGR out, as cv2 (and cv2's gray of
    it under IMREAD_GRAYSCALE); a JFIF marker beside
    an Adobe transform 0 means YCbCr (libjpeg's order of the two)."""
    img = _scene(rng, hw, "smooth" if min(hw) > 1 else "noise")
    data = _pillow(np.ascontiguousarray(img[..., ::-1]), "RGB", quality=90, keep_rgb=True)
    assert jpeg.read_info(data).color == "rgb"
    np.testing.assert_array_equal(jpeg.decode(data), cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    # IMREAD_GRAYSCALE: libjpeg's rgb_gray_convert of the planes
    np.testing.assert_array_equal(image_io.imdecode(data, image_io.IMREAD_GRAYSCALE),
                                  cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE))
    base = jpeg.encode(img, 90)
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    both = base[:20] + adobe + base[20:]
    assert jpeg.read_info(both).color == "ycc"
    np.testing.assert_array_equal(jpeg.decode(both), cv2.imdecode(np.frombuffer(both, np.uint8), cv2.IMREAD_COLOR))


@pytest.mark.parametrize("subsampling", [0, 2])
def test_cmyk_and_ycck_equal_cv2(rng, subsampling):
    """Pillow's CMYK files (Adobe transform 0; 4:4:4, and with three planes
    at half size): cv2 5.0.0's CMYK -> BGR rule (``jpeg.cmyk_to_bgr``,
    measured here over 24,576 random CMYK pixels), bit for bit; the same
    file marked YCCK (Adobe transform 2) goes through libjpeg's
    ``ycck_cmyk_convert`` first, also bit for bit; both under
    IMREAD_GRAYSCALE as cv2 reads them."""
    cmyk = rng.randint(0, 256, (128, 192, 4)).astype(np.uint8)
    data = _pillow(cmyk, "CMYK", quality=95, subsampling=subsampling)
    info = jpeg.read_info(data)
    assert info.color == "cmyk" and info.components == 4
    assert info.upsampling == (((1, 1),) * 4 if subsampling == 0 else ((1, 1),) + ((2, 2),) * 3)
    np.testing.assert_array_equal(jpeg.decode(data), cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    i = data.index(b"Adobe") + 11
    ycck = data[:i] + b"\x02" + data[i + 1:]
    assert jpeg.read_info(ycck).color == "ycck"
    np.testing.assert_array_equal(jpeg.decode(ycck), cv2.imdecode(np.frombuffer(ycck, np.uint8), cv2.IMREAD_COLOR))
    for d in (data, ycck):  # IMREAD_GRAYSCALE: cv2's own CMYK -> gray after libjpeg's CMYK
        np.testing.assert_array_equal(image_io.imdecode(d, image_io.IMREAD_GRAYSCALE),
                                      cv2.imdecode(np.frombuffer(d, np.uint8), cv2.IMREAD_GRAYSCALE))
    planes = [rng.randint(0, 256, (64, 64)).astype(np.uint8) for _ in range(4)]
    k = planes[3].astype(np.int32)
    want = [k - ((255 - p.astype(np.int32)) * k >> 8) for p in planes[:3]][::-1]
    np.testing.assert_array_equal(jpeg.cmyk_to_bgr(*planes), np.stack(want, -1))


@pytest.mark.parametrize("form", ["rgb", "cmyk444", "cmyk420", "ycck444", "ycck420"])
def test_plain_colour_function_on_other_codings(rng, form):
    """The colour kernel's plain version in its other modes, on
    ``jpeg.decode_planes``' planes: RGB-coded (Adobe transform 0), CMYK and
    YCCK (4:4:4, and with three planes at half size) give ``jpeg.decode``'s
    pixels, and so cv2's, bit for bit."""
    import torch

    from dspnet_torch.data import jpeg_cuda

    if form == "rgb":
        data = _pillow(np.ascontiguousarray(_scene(rng, (37, 53), "smooth")[..., ::-1]), "RGB", quality=90,
                       keep_rgb=True)
    else:
        data = _pillow(rng.randint(0, 256, (37, 53, 4)).astype(np.uint8), "CMYK", quality=95,
                       subsampling=0 if form.endswith("444") else 2)
        if form.startswith("ycck"):
            i = data.index(b"Adobe") + 11
            data = data[:i] + b"\x02" + data[i + 1:]
    planes, info = jpeg.decode_planes(data)
    assert info.color == form[:4].rstrip("4")
    t = [torch.from_numpy(p) for p in planes]
    got = jpeg_cuda.ycc_to_bgr(*t[:3], factors=info.factors, color=info.color, k=t[3] if len(t) == 4 else None)
    np.testing.assert_array_equal(got.numpy(), jpeg.decode(data))
    np.testing.assert_array_equal(got.numpy(), cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))


# ------------------------------------------------- arithmetic, lossless, every geometry

FORMS = Path(__file__).resolve().parent / "fixtures" / "jpeg_forms"
FORMS_META = json.loads((FORMS / "forms.json").read_text())["files"]
FLAGS = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE, "unchanged": cv2.IMREAD_UNCHANGED}


def _cv2(data: bytes, flag):
    return cv2.imdecode(np.frombuffer(data, np.uint8), flag)


@pytest.mark.parametrize("name", sorted(FORMS_META))
def test_forms_equal_cv2(name):
    """Every committed form (``tests/make_jpeg_fixtures.py``: arithmetic
    coding sequential and progressive with restarts and DAC conditioning,
    lossless predictors 1-7 with point transforms and restarts, every
    integral sampling geometry, progressive files with restarts, RGB-coded,
    CMYK and YCCK): ``image_io.imdecode`` gives ``cv2.imdecode``'s pixels
    bit for bit under IMREAD_COLOR, IMREAD_GRAYSCALE and IMREAD_UNCHANGED,
    and raises by name exactly where cv2 returns None (12-bit, fractional
    sampling factors where the output needs the component, a lossless file
    asked for a colour conversion). ``forms.json``'s sha256s are cv2's
    (the card's check reads them)."""
    data = (FORMS / name).read_bytes()
    meta = FORMS_META[name]
    for key, flag in FLAGS.items():
        want = _cv2(data, flag)
        if want is None:
            assert meta["cv2"][key] is None
            with pytest.raises(jpeg.JpegError, match="12-bit|fractional|lossless"):
                image_io.imdecode(data, flag)
            continue
        assert meta["cv2"][key] == {"shape": list(want.shape), "sha256": hashlib.sha256(want.tobytes()).hexdigest()}
        np.testing.assert_array_equal(image_io.imdecode(data, flag), want, err_msg=key)
        if key == "unchanged":
            np.testing.assert_array_equal(jpeg.decode(data, apply_orientation=False), want)


def _dct_forms():
    return sorted(n for n, m in FORMS_META.items()
                  if m["cv2"]["color"] is not None and not m["info"].get("lossless") and not n.startswith("big_"))


@pytest.mark.parametrize("name", _dct_forms())
def test_transcode_baseline_keeps_the_coefficients(name):
    """``transcode_baseline`` on every DCT form cv2 reads (1024x2048 ones in
    ``test_transcode_and_lossless_at_full_size``): one interleaved baseline
    Huffman scan (SOF0, Annex K's tables, no DAC, no restart) that cv2 and
    the plain decoder read to the original's pixels bit for bit, the header
    (sizes, component sampling, colour coding) unchanged."""
    data = (FORMS / name).read_bytes()
    out = jpeg.transcode_baseline(data)
    before, after = jpeg.read_info(data), jpeg.read_info(out)
    assert (after.coding, after.progressive, after.restart, after.lossless) == ("huffman", False, 0, False)
    assert after._replace(coding=before.coding, progressive=before.progressive, restart=before.restart) == before
    assert b"\xff\xc0" in out and b"\xff\xcc" not in out
    want = _cv2(data, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(_cv2(out, cv2.IMREAD_UNCHANGED), want)
    np.testing.assert_array_equal(jpeg.decode(out, apply_orientation=False), want)


def test_transcode_keeps_app_segments_and_wide_tables(rng):
    """The APPn segments (Exif orientation, Adobe transform) survive; a
    16-bit quantisation table makes the frame SOF1, read to the same pixels;
    a lossless file has nothing to transcode."""
    img = _scene(rng, (24, 40), "smooth")
    data = jpeg.encode(img, 90)
    data = data[:2] + _exif(6) + data[2:]
    out = jpeg.transcode_baseline(data)
    assert jpeg.read_info(out).orientation == 6
    np.testing.assert_array_equal(jpeg.decode(out), jpeg.decode(data))
    # table 0 rewritten with 16-bit precision, values unchanged
    i = data.index(b"\xff\xdb")
    n = data[i + 2] << 8 | data[i + 3]
    q = np.frombuffer(data[i + 5:i + 69], np.uint8).astype(">u2").tobytes()
    wide = data[:i] + b"\xff\xdb" + (n + 64).to_bytes(2, "big") + b"\x10" + q + data[i + 69:]
    np.testing.assert_array_equal(jpeg.decode(wide), jpeg.decode(data))
    out = jpeg.transcode_baseline(wide)
    assert b"\xff\xc1" in out and b"\xff\xc0" not in out
    np.testing.assert_array_equal(jpeg.decode(out), jpeg.decode(data))
    np.testing.assert_array_equal(_cv2(out, cv2.IMREAD_COLOR), _cv2(wide, cv2.IMREAD_COLOR))
    with pytest.raises(jpeg.JpegError, match="lossless"):
        jpeg.transcode_baseline((FORMS / "lossless_rgb_p1.jpg").read_bytes())


def test_transcode_and_lossless_at_full_size():
    """The committed 1024x2048 arithmetic and progressive-with-restart files
    transcode to baseline files cv2 reads to the same pixels; the 512x1024
    lossless file's host planes (``lossless_planes``, not a counted plain
    decode) equal cv2's samples."""
    for name in ("big_arith_420.jpg", "big_prog_rst_420.jpg"):
        data = (FORMS / name).read_bytes()
        np.testing.assert_array_equal(_cv2(jpeg.transcode_baseline(data), cv2.IMREAD_COLOR),
                                      _cv2(data, cv2.IMREAD_COLOR), err_msg=name)
    data = (FORMS / "big_lossless_rgb_p1.jpg").read_bytes()
    before = jpeg.decodes
    planes, info = jpeg.lossless_planes(data)
    assert jpeg.decodes == before and info.lossless and info.color == "rgb"
    np.testing.assert_array_equal(np.stack(planes[::-1], -1), _cv2(data, cv2.IMREAD_COLOR))
    with pytest.raises(jpeg.JpegError, match="lossless"):
        jpeg.lossless_planes((FORMS / "big_411.jpg").read_bytes())


def _colour_forms():
    return sorted(n for n, m in FORMS_META.items() if m["cv2"]["color"] is not None and not n.startswith("big_"))


@pytest.mark.parametrize("name", _colour_forms())
def test_plain_colour_function_on_every_geometry(name):
    """The colour kernel's plain version on ``jpeg.decode_planes``' planes,
    each upsampled by its own factors (4:1:1 and 4:4:0 among them, the first
    component subsampled too; a lossless file with ``fancy`` off), gives
    cv2's IMREAD_COLOR pixels bit for bit."""
    import torch

    from dspnet_torch.data import jpeg_cuda

    data = (FORMS / name).read_bytes()
    planes, info = jpeg.decode_planes(data)
    t = [torch.from_numpy(p) for p in planes]
    got = jpeg_cuda.ycc_to_bgr(*t[:3], color=info.color, k=t[3] if len(t) == 4 else None, fancy=not info.lossless,
                               upsampling=info.upsampling, size=(info.height, info.width))
    np.testing.assert_array_equal(got.numpy(), _cv2(data, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("name", ["arith_seq_420_street.jpg", "lossless_rgb_p7_pt2_rst.jpg", "samp_4x1_1x1.jpg",
                                  "big_prog_rst_420.jpg", "lossless_gray_p1.jpg", "fractional_3x1_2x1.jpg"])
def test_card_decoder_cpu_path_on_the_forms(name):
    """``jpeg_cuda.decode_images`` on CPU tensors (the loader's CPU path)
    gives cv2's IMREAD_COLOR pixels, and refuses what cv2 returns None for
    (a gray lossless file under IMREAD_COLOR, fractional sampling)."""
    from dspnet_torch.data import jpeg_cuda

    data = (FORMS / name).read_bytes()
    want = _cv2(data, cv2.IMREAD_COLOR)
    if want is None:
        with pytest.raises(jpeg.JpegError, match="lossless|fractional"):
            jpeg_cuda.decode_images([data], "cpu")
        return
    np.testing.assert_array_equal(jpeg_cuda.decode_images([data], "cpu")[0].numpy(), want)


def test_arithmetic_decoder_against_corrupt_data():
    """A truncated arithmetic scan reads zeros past its end (as libjpeg does
    at a marker) and gives an image; a damaged DAC raises."""
    data = (FORMS / "arith_seq_dac.jpg").read_bytes()
    sos = data.index(b"\xff\xda")
    cut = data[:sos + 60] + b"\xff\xd9"
    assert jpeg.decode(cut).shape == _cv2(data, cv2.IMREAD_UNCHANGED).shape
    i = data.index(b"\xff\xcc")
    assert data[i + 4] < 16  # the first entry conditions a DC table
    bad = data[:i + 5] + b"\x0f" + data[i + 6:]  # L 15 above U 0
    with pytest.raises(jpeg.JpegError, match="DAC"):
        jpeg.decode(bad)
