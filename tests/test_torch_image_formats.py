"""The port's still-image codecs beside JPEG and PNG (BMP, PBM/PGM/PPM/PAM/PFM,
Sun raster, Radiance HDR, TIFF, WebP, GIF) against cv2 5.0.0 bit for bit,
and the JAX entry points that read such files against the port's.

* every committed form of ``tests/fixtures/image_forms/`` (written by
  ``tests/make_image_fixtures.py``) under IMREAD_COLOR, IMREAD_GRAYSCALE and
  IMREAD_UNCHANGED: the port's array equals ``cv2.imdecode``'s (dtype,
  shape, every element) and the sha256 ``forms.json`` records; where cv2
  returns None the port raises;
* files ``cv2.imencode`` writes in the test, over dtypes, channel counts and
  each TIFF compression and predictor cv2 writes;
* the writers: BMP, PxM, PAM, PFM, Sun raster and HDR bytes equal
  ``cv2.imencode``'s; TIFF, WebP and GIF files read back by cv2 to the
  written array; an extension with no writer and a GIF of more than 256
  colours refused;
* ``Detector.im_detect_single`` on a BMP, a TIFF, a WebP and a GIF, a
  ``--loader python`` epoch over a ``YoloFormat`` index of TIFF and BMP
  images, and ``voc_palette`` into ``.bmp`` and ``.tif``, each against the
  JAX package's.
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from dspnet_torch.data import bmp, gif, hdr, image_io, pxm, sunras, synthetic, tiff, webp
from tests.make_image_fixtures import pam_alpha_columns

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

ROOT = Path(__file__).resolve().parents[1]
FORMS = ROOT / "tests" / "fixtures" / "image_forms"
META = json.loads((FORMS / "forms.json").read_text())["files"]
FLAGS = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE, "unchanged": cv2.IMREAD_UNCHANGED}


def _sha(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _cv2(data: bytes, flag: int):
    return cv2.imdecode(np.frombuffer(data, np.uint8), flag)


def _assert_same(got, want, what=""):
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ------------------------------------------------------------ committed forms


@pytest.mark.parametrize("flag", sorted(FLAGS))
@pytest.mark.parametrize("name", sorted(META))
def test_committed_form_equals_cv2(name, flag):
    """One committed file under one flag: the port's array is cv2's bit for
    bit and has the recorded sha256; where cv2 returns None (or, for a PAM
    it would write past its image for, is not run) the port raises. A PAM
    whose alpha cv2 converts fills only ``columns`` of each row, which are
    compared."""
    data = (FORMS / name).read_bytes()
    f = FLAGS[flag]
    rec = META[name]["cv2"][flag]
    columns, overruns = pam_alpha_columns(data, f)
    if rec is None:
        if not overruns:
            assert _cv2(data, f) is None
        with pytest.raises(ValueError):
            image_io.imdecode(data, f)
        return
    got = image_io.imdecode(data, f)
    want = _cv2(data, f)
    if columns is not None:
        assert rec["columns"] == columns
        got, want = got[:, :columns], want[:, :columns]
    _assert_same(got, want, name)
    assert (str(got.dtype), list(got.shape), _sha(got)) == (rec["dtype"], rec["shape"], rec["sha256"])


def test_forms_cover_each_reader():
    """The committed forms reach every reader and its refusals."""
    ext = {os.path.splitext(n)[1] for n in META}
    assert ext == {".bmp", ".pbm", ".pgm", ".ppm", ".pam", ".pfm", ".sr", ".ras", ".hdr", ".tif", ".webp", ".gif",
                   ".png"}
    refused = sorted(n for n, m in META.items() if all(v is None for v in m["cv2"].values()))
    assert {"bgr24_rle.ras", "cv2_bgra.pam", "old_jpeg6.tif", "lzma_tag.tif", "xyze.hdr",
            "orient_plus_y.hdr", "rle4_delta.bmp", "ycbcr22_tiles32x32_raw.tif",
            "ycbcr14_tiles16x16_deflate.tif"} <= set(refused)
    assert sum(p.stat().st_size for p in FORMS.iterdir()) < 1 << 20


# ------------------------------------------------------------ files cv2 writes here


def _scene(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    big = (max(shape[0], 64), max(shape[1], 64))
    base = synthetic.make_example(rng, big, 3)[0][:shape[0], :shape[1]].astype(np.float64)
    noise = rng.rand(*shape[:2], 1) * 40
    if len(shape) == 2:
        img = base[..., 1] + noise[..., 0]
    elif shape[2] == 4:
        img = np.concatenate([base + noise, rng.rand(*shape[:2], 1) * 255], -1)
    else:
        img = (base + noise)[..., :shape[2]]
    if dtype == np.float32:
        return (img / 200).astype(np.float32)
    if dtype == np.float64:
        return img / 200
    scale = {np.uint8: 1, np.int8: 1, np.uint16: 250, np.int16: 120, np.int32: 9000}[dtype]
    out = np.clip(img, 0, 255) * scale
    if dtype in (np.int8, np.int16, np.int32):
        out = out - (128 * scale)
    return out.astype(dtype)


C, P = cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_PREDICTOR
ENCODED = {
    "bmp_gray": (".bmp", (37, 53), np.uint8, []), "bmp_bgr": (".bmp", (37, 53, 3), np.uint8, []),
    "bmp_bgra": (".bmp", (37, 53, 4), np.uint8, []),
    "pgm": (".pgm", (37, 53), np.uint8, []), "pgm16": (".pgm", (37, 53), np.uint16, []),
    "ppm": (".ppm", (37, 53, 3), np.uint8, []), "ppm16": (".ppm", (37, 53, 3), np.uint16, []),
    "pbm": (".pbm", (37, 53), np.uint8, []), "pgm_ascii": (".pgm", (21, 19), np.uint8, [cv2.IMWRITE_PXM_BINARY, 0]),
    "ppm_ascii": (".ppm", (21, 19, 3), np.uint8, [cv2.IMWRITE_PXM_BINARY, 0]),
    "pam_gray": (".pam", (37, 53), np.uint8, []), "pam_bgr16": (".pam", (37, 53, 3), np.uint16, []),
    "pfm_gray": (".pfm", (37, 53), np.float32, []), "pfm_bgr": (".pfm", (37, 53, 3), np.float32, []),
    "sr_gray": (".sr", (37, 54), np.uint8, []), "sr_bgr": (".sr", (37, 53, 3), np.uint8, []),
    "sr_bgra": (".sr", (37, 53, 4), np.uint8, []),
    "hdr_bgr": (".hdr", (37, 53, 3), np.float32, []), "hdr_gray8": (".hdr", (37, 53), np.uint8, []),
    "hdr_narrow": (".hdr", (9, 5, 3), np.float32, []),
    "tif_u8_gray": (".tif", (37, 53), np.uint8, []), "tif_u8_bgra": (".tif", (37, 53, 4), np.uint8, []),
    "tif_s8": (".tif", (37, 53), np.int8, []), "tif_u16_gray": (".tif", (37, 53), np.uint16, []),
    "tif_u16_bgr": (".tif", (37, 53, 3), np.uint16, []), "tif_u16_bgra": (".tif", (37, 53, 4), np.uint16, []),
    "tif_s16": (".tif", (37, 53), np.int16, []), "tif_s32": (".tif", (37, 53), np.int32, []),
    "tif_f32_bgr": (".tif", (37, 53, 3), np.float32, []), "tif_f64": (".tif", (21, 19), np.float64, []),
    "tif_u16_strips": (".tif", (37, 53, 3), np.uint16, [cv2.IMWRITE_TIFF_ROWSPERSTRIP, 5]),
    "webp_lossless": (".webp", (37, 53, 3), np.uint8, []), "webp_bgra": (".webp", (37, 53, 4), np.uint8, []),
    "webp_gray": (".webp", (37, 53), np.uint8, []),
    "webp_q20": (".webp", (37, 53, 3), np.uint8, [cv2.IMWRITE_WEBP_QUALITY, 20]),
    "webp_q95": (".webp", (64, 96, 3), np.uint8, [cv2.IMWRITE_WEBP_QUALITY, 95]),
    "webp_q70_bgra": (".webp", (37, 53, 4), np.uint8, [cv2.IMWRITE_WEBP_QUALITY, 70]),
    "gif": (".gif", (37, 53, 3), np.uint8, []),
}
for _code in (1, 5, 8, 32773):
    for _pred in (1, 2):
        ENCODED[f"tif_c{_code}_p{_pred}"] = (".tif", (37, 53, 3), np.uint8, [C, _code, P, _pred])


@pytest.mark.parametrize("case", sorted(ENCODED))
def test_cv2_written_files_equal_cv2(case):
    """A file cv2 writes from a seeded scene, read by the port and by cv2
    under each flag: equal arrays, or both refusing."""
    ext, shape, dtype, params = ENCODED[case]
    img = _scene(shape, dtype, sorted(ENCODED).index(case))
    ok, buf = cv2.imencode(ext, img, params)
    assert ok
    data = buf.tobytes()
    for flag in FLAGS.values():
        want = _cv2(data, flag)
        if want is None:
            with pytest.raises(ValueError):
                image_io.imdecode(data, flag)
            continue
        _assert_same(image_io.imdecode(data, flag), want, f"{case} flag {flag}")


# ------------------------------------------------------------ writers

BYTES_EQUAL = {
    "bmp_gray": (".bmp", (37, 53), np.uint8), "bmp_bgr": (".bmp", (37, 53, 3), np.uint8),
    "bmp_bgra": (".bmp", (37, 53, 4), np.uint8), "dib_bgr": (".dib", (5, 6, 3), np.uint8),
    "pbm": (".pbm", (37, 53), np.uint8), "pgm": (".pgm", (37, 53), np.uint8), "pgm16": (".pgm", (37, 53), np.uint16),
    "ppm": (".ppm", (37, 53, 3), np.uint8), "ppm16": (".ppm", (37, 53, 3), np.uint16),
    "pnm_gray": (".pnm", (37, 53), np.uint8), "pnm_bgr": (".pnm", (37, 53, 3), np.uint8),
    "pam_gray": (".pam", (37, 53), np.uint8), "pam_bgr": (".pam", (37, 53, 3), np.uint8),
    "pam_bgra": (".pam", (37, 53, 4), np.uint8), "pam_bgr16": (".pam", (37, 53, 3), np.uint16),
    "pfm_gray": (".pfm", (37, 53), np.float32), "pfm_bgr": (".pfm", (37, 53, 3), np.float32),
    "pfm_u8": (".pfm", (37, 53, 3), np.uint8),
    "sr_gray": (".sr", (37, 53), np.uint8), "sr_bgr": (".sr", (37, 53, 3), np.uint8),
    "ras_bgra": (".ras", (37, 53, 4), np.uint8),
    "hdr_bgr": (".hdr", (37, 53, 3), np.float32), "hdr_u8": (".hdr", (37, 53, 3), np.uint8),
    "hdr_gray": (".hdr", (37, 53), np.uint8), "pic_narrow": (".pic", (9, 5, 3), np.float32),
}


@pytest.mark.parametrize("case", sorted(BYTES_EQUAL))
def test_writer_bytes_equal_cv2(case):
    """BMP, PxM, PAM, PFM, Sun raster and HDR: the port's bytes are
    ``cv2.imencode``'s. (cv2's Sun raster writer pads an odd row with the
    next row's first byte, and the last row with the byte after the image:
    the array lies in a zeroed buffer so that byte is 0.)"""
    ext, shape, dtype = BYTES_EQUAL[case]
    img = _scene(shape, dtype, sorted(BYTES_EQUAL).index(case))
    buf = np.zeros(img.nbytes + 64, np.uint8)
    held = buf[:img.nbytes].view(dtype).reshape(shape)
    held[...] = img
    ok, want = cv2.imencode(ext, held)
    assert ok
    assert image_io.imencode(ext, held) == want.tobytes()


READ_BACK = {
    "tif_u8_gray": (".tif", (37, 53), np.uint8), "tif_u8_bgr": (".tif", (64, 96, 3), np.uint8),
    "tif_u8_bgra": (".tif", (37, 53, 4), np.uint8), "tif_s8": (".tif", (37, 53), np.int8),
    "tif_u16_gray": (".tif", (37, 53), np.uint16), "tif_u16_bgr": (".tif", (37, 53, 3), np.uint16),
    "tif_u16_bgra": (".tif", (37, 53, 4), np.uint16), "tif_s16": (".tif", (37, 53), np.int16),
    "tif_s32": (".tif", (37, 53), np.int32), "tif_f32": (".tiff", (37, 53, 3), np.float32),
    "tif_f64": (".tif", (21, 19), np.float64), "tif_tall": (".tif", (300, 40, 3), np.uint8),
    "webp_bgr": (".webp", (64, 96, 3), np.uint8), "webp_bgra": (".webp", (37, 53, 4), np.uint8),
    "webp_gray": (".webp", (37, 53), np.uint8),
}


@pytest.mark.parametrize("case", sorted(READ_BACK))
def test_writer_read_back_by_cv2(case):
    """TIFF (LZW) and WebP (lossless) files the port writes: cv2 reads them
    back (IMREAD_UNCHANGED) to the written array, BGRA with its transparent
    pixels' colours included, and so does the port. cv2 reads a gray WebP
    as BGR."""
    ext, shape, dtype = READ_BACK[case]
    img = _scene(shape, dtype, sorted(READ_BACK).index(case))
    if len(shape) == 3 and shape[2] == 4 and dtype == np.uint8:
        img[::5, ::3, 3] = 0  # transparent pixels keep their colour
    data = image_io.imencode(ext, img)
    want = img if not (ext == ".webp" and img.ndim == 2) else np.repeat(img[..., None], 3, -1)
    _assert_same(_cv2(data, cv2.IMREAD_UNCHANGED), want, case)
    _assert_same(image_io.imdecode(data, image_io.IMREAD_UNCHANGED), want, case)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_gif_writer_exact_palette_read_back(channels):
    """A GIF of an array of at most 256 colours (a street scene's, a gray
    map, an opaque BGRA): cv2 reads it back equal (BGR; gray replicated),
    as the port does."""
    scene = synthetic.make_example(np.random.RandomState(channels), (64, 96), 4)
    img = scene[2] if channels == 1 else scene[0]
    if channels == 4:
        img = np.concatenate([img, np.full(img.shape[:2] + (1,), 255, np.uint8)], -1)
    data = image_io.imencode(".gif", img)
    want = np.repeat(img[..., None], 3, -1) if channels == 1 else img[..., :3]
    _assert_same(_cv2(data, cv2.IMREAD_UNCHANGED), want)
    _assert_same(image_io.imdecode(data, image_io.IMREAD_UNCHANGED), want)


def test_gif_writer_refuses_more_than_256_colours():
    """cv2 quantises such an array to its own palette (and refuses a gray
    one); the port refuses it and says so."""
    img = np.random.RandomState(0).randint(0, 256, (20, 30, 3)).astype(np.uint8)
    with pytest.raises(gif.GifError, match="256 colours .*quantises"):
        image_io.imencode(".gif", img)
    with pytest.raises(gif.GifError, match="opaque"):
        image_io.imencode(".gif", np.zeros((4, 4, 4), np.uint8))


@pytest.mark.parametrize("ext", [".xyz", ".j2k", ".avif", ".exr", ".pxm", ""])
def test_imwrite_refuses_an_extension_without_a_writer(tmp_path, ext):
    """No PNG under another name: an extension with no writer raises and
    no file appears."""
    path = tmp_path / f"out{ext}"
    with pytest.raises(ValueError, match="no image writer"):
        image_io.imwrite(str(path), np.zeros((4, 4, 3), np.uint8))
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("ext, magic", [(".BMP", b"BM"), (".dib", b"BM"), (".tiff", b"II*\0"), (".TIF", b"II*\0"),
                                        (".ras", sunras.MAGIC), (".pic", b"#?RADIANCE"), (".jpe", b"\xff\xd8\xff"),
                                        (".webp", b"RIFF"), (".gif", b"GIF89a"), (".png", image_io.PNG_MAGIC)])
def test_imwrite_picks_the_format_by_extension(tmp_path, ext, magic):
    path = image_io.imwrite(str(tmp_path / f"x{ext}"), np.full((6, 8, 3), 7, np.uint8))
    assert Path(path).read_bytes().startswith(magic)


def test_jpeg_in_tiff_is_counted_apart_from_jpeg_files():
    """A JPEG-coded TIFF decodes its strips through ``data/jpeg.py``,
    counted in ``stream_decodes`` (one a strip), not in ``decodes``."""
    from dspnet_torch.data import jpeg

    data = (FORMS / "pil_rgb_jpeg.tif").read_bytes()
    strips = len(tiff.read_ifd(data)[0][tiff.STRIP_OFFSETS])
    jpeg.decodes = jpeg.stream_decodes = 0
    image_io.imdecode(data)
    assert (jpeg.decodes, jpeg.stream_decodes) == (0, strips)


@pytest.mark.parametrize("tile", [None, (32, 64)])
def test_planar_16bit_gray_alpha_tiff_is_refused_where_cv2_reads_it(tile):
    """Repaired (ROADMAP Queue C item 5): cv2 5.0.0 reads a planar 16-bit
    gray + alpha TIFF through libtiff 4.7.1's separate RGBA path, where gray
    takes ``Bitdepth16To8`` ((v + 128) // 257), unmapped for min-is-white,
    before alpha is unassociated; the port's array is cv2's under every flag
    and ExtraSamples value. The name is kept from when the port refused it."""
    from tests.make_image_fixtures import tiff_simple

    la16 = np.random.RandomState(16).randint(0, 65536, (19, 27, 2)).astype(np.uint16)
    for photometric in (0, 1):
        for extra in (0, 1, 2):
            data = tiff_simple(la16, photometric, extra=[extra], planar=True, tile=tile)
            for flag in FLAGS.values():
                _assert_same(image_io.imdecode(data, flag), _cv2(data, flag), f"{photometric} {extra} {flag}")


def test_avif_refused_by_name():
    """AVIF is read: cv2's file decodes to cv2's array under each flag (the
    forms are in ``tests/test_torch_avif.py``); what the port refuses of it
    raises naming the form (a layered image, which cv2 returns None for)."""
    img = synthetic.make_example(np.random.RandomState(5), (16, 24), 2)[0]
    ok, avif = cv2.imencode(".avif", img)
    assert ok
    for flag in FLAGS.values():
        _assert_same(image_io.imdecode(avif.tobytes(), flag), _cv2(avif.tobytes(), flag))
    layered = (ROOT / "tests" / "fixtures" / "avif_forms" / "made_a1lx.avif").read_bytes()
    assert _cv2(layered, cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="AVIF.*a1lx"):
        image_io.imdecode(layered)


def test_codec_writers_refuse_what_they_cannot_hold():
    with pytest.raises(bmp.BmpError):
        bmp.encode(np.zeros((4, 4), np.uint16))
    with pytest.raises(pxm.PxmError):
        pxm.encode_pnm(np.zeros((4, 4, 3), np.uint8), "pgm")
    with pytest.raises(hdr.HdrError):
        hdr.encode(np.zeros((4, 4, 4), np.float32))
    with pytest.raises(tiff.TiffError):
        tiff.encode(np.zeros((4, 4, 2), np.uint8))
    with pytest.raises(webp.WebPError):
        webp.encode(np.zeros((4, 4, 3), np.uint16))


def test_new_modules_import_no_cv2_pil_or_jax():
    """Importing the codecs loads none of cv2, PIL, jax or the JAX package
    (the card's machine has none of them)."""
    code = ("import sys; import dspnet_torch.data.image_io, dspnet_torch.data.bmp, dspnet_torch.data.pxm, "
            "dspnet_torch.data.sunras, dspnet_torch.data.hdr, dspnet_torch.data.tiff, dspnet_torch.data.ccitt, "
            "dspnet_torch.data.gif, dspnet_torch.data.webp, dspnet_torch.data.vp8, dspnet_torch.data.cvt_color; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('cv2', 'PIL', 'jax', 'flax', 'dspnet_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------------ the JAX entry points


@pytest.fixture(scope="module")
def detectors():
    from dspnet_tpu.api import create_model as jax_create_model
    from dspnet_tpu.detect.detector import Detector as JaxDetector
    from dspnet_torch.api import create_model
    from dspnet_torch.data.cs_labels import DET_CLASSES
    from dspnet_torch.detect.detector import Detector
    from dspnet_torch.utils.convert import load_flax_variables
    from tests.torch_parity import random_flax_variables

    hw = (128, 256)
    bundle = jax_create_model("resnet-18_multi", hw)
    variables = random_flax_variables(bundle.model, (1, *hw, 3), seed=41, train=False)
    port = create_model("resnet-18_multi", hw, device="cpu")
    load_flax_variables(port.model, variables)
    return (JaxDetector(bundle.model, variables, bundle.anchors, hw, classes=DET_CLASSES),
            Detector(port.model, port.anchors, hw, device="cpu", classes=DET_CLASSES))


@pytest.mark.parametrize("ext", [".bmp", ".tif", ".webp", ".gif"])
def test_im_detect_single_matches_jax(detectors, tmp_path, ext):
    """A BMP, an LZW TIFF, a lossy WebP (cv2's, quality 80) and a GIF of a
    street scene: the port reads cv2's pixels on the host, then its det rows
    (ids equal, values within 1e-4) and seg map match the JAX Detector's."""
    jdet, pdet = detectors
    img = synthetic.make_example(np.random.RandomState(7), (150, 333), 4)[0]
    path = tmp_path / f"scene{ext}"
    if ext == ".webp":
        path.write_bytes(cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 80])[1].tobytes())
    else:
        image_io.imwrite(str(path), img)
    np.testing.assert_array_equal(pdet.read_image(str(path)).numpy(), cv2.imread(str(path), cv2.IMREAD_COLOR))
    want = jdet.im_detect_single(str(path))
    got = pdet.im_detect_single(str(path))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)


def _yolo_layout(root: Path, ext: str, n: int = 5):
    """A YOLO layout (list, images, labels) of ``n`` street scenes in
    ``ext``, odd sizes among them, one without a label file."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.RandomState(len(ext))
    ids = []
    for i in range(n):
        img, _, rows = synthetic.make_example(rng, (70, 110) if i % 2 else (64, 96), 4)[:3]
        iid = f"im{i}"
        ids.append(iid)
        image_io.imwrite(str(root / "images" / (iid + ext)), img)
        if i == n - 1:
            continue
        lines = []
        for r in np.asarray(rows):
            if r[0] < 0:
                continue
            cx, cy, w, h = (r[1] + r[3]) / 2, (r[2] + r[4]) / 2, r[3] - r[1], r[4] - r[2]
            lines.append(f"{int(r[0])} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}")
        (root / "labels" / (iid + ".txt")).write_text("\n".join(lines) + "\n")
    (root / "list.txt").write_text("\n".join(ids) + "\n")
    return root


@pytest.mark.parametrize("ext", [".tif", ".bmp"])
def test_python_loader_over_yolo_tiff_and_bmp_equals_jax(tmp_path, ext):
    """Two epochs of the port's ``MultiTaskIterator`` (``--loader python``)
    over a ``YoloFormat(image_ext=...)`` index of TIFF or BMP images equal
    the JAX ``MultiTaskIterator``'s over the JAX ``YoloFormat`` bit for bit
    (images, labels, names)."""
    from dspnet_tpu.data.imdb import YoloFormat as JaxYolo
    from dspnet_tpu.data.iterator import MultiTaskIterator as JaxIterator
    from dspnet_tpu.data.iterator import SampleIndex as JaxIndex
    from dspnet_torch.data.imdb import YoloFormat
    from dspnet_torch.data.iterator import MultiTaskIterator, SampleIndex

    root = _yolo_layout(tmp_path, ext)
    classes = ["person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle"]
    args = (str(root / "list.txt"), str(root / "images"), str(root / "labels"), classes)
    jax_index = JaxIndex(JaxYolo(*args, image_ext=ext).samples())
    port_index = SampleIndex(YoloFormat(*args, image_ext=ext).samples())
    kw = dict(batch_size=2, data_shape=(64, 128), enable_aug=True, pad_last=True)
    want_it, got_it = JaxIterator(jax_index, **kw), MultiTaskIterator(port_index, **kw)
    for _ in range(2):
        want, got = list(want_it.epoch()), list(got_it.epoch())
        assert len(got) == len(want) == 3
        for (wb, wn), (gb, gn) in zip(want, got):
            assert gn == wn
            for k in wb:
                assert gb[k].dtype == wb[k].dtype, k
                np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


@pytest.mark.parametrize("ext", [".bmp", ".tif"])
def test_voc_palette_into_bmp_and_tiff_equals_jax(tmp_path, ext):
    """``voc_palette`` colour -> index -> colour with ``.bmp`` and ``.tif``
    destinations: the JAX tool's files (cv2.imwrite) and the port's hold
    equal arrays (a BMP's bytes are equal too), the index map exact."""
    from dspnet_tpu.tools import voc_palette as jpal
    from dspnet_torch.tools import voc_palette

    rng = np.random.RandomState(9)
    idx = rng.randint(0, 21, (40, 60))
    src = tmp_path / "mask.png"
    cv2.imwrite(str(src), voc_palette.voc_palette()[idx][..., ::-1])
    for mod, d in ((jpal, "jax"), (voc_palette, "port")):
        (tmp_path / d).mkdir()
        mod.main([str(src), str(tmp_path / d / f"index{ext}")])
        mod.main(["--colorize", str(tmp_path / d / f"index{ext}"), str(tmp_path / d / f"colour{ext}")])
    for name in (f"index{ext}", f"colour{ext}"):
        jax_file, port_file = str(tmp_path / "jax" / name), str(tmp_path / "port" / name)
        _assert_same(image_io.imread(port_file, -1), cv2.imread(jax_file, cv2.IMREAD_UNCHANGED), name)
        _assert_same(cv2.imread(port_file, cv2.IMREAD_UNCHANGED), cv2.imread(jax_file, cv2.IMREAD_UNCHANGED), name)
        if ext == ".bmp":
            assert Path(port_file).read_bytes() == Path(jax_file).read_bytes()
    np.testing.assert_array_equal(image_io.imread(str(tmp_path / "port" / f"index{ext}"), -1), idx)
