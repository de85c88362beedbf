"""The port's data-preparation tools against the JAX package's (and cv2's),
on the CPU, exactly: ``utils/raster.py::fill_poly`` against
``cv2.fillPoly``, the PNG and JPEG reads of ``data/image_io.py`` under
every flag against ``cv2.imread``, ``prepare_cityscapes``, ``prepare_dataset``,
``im2rec``, ``voc_palette`` and ``visualize_net`` / ``intermediate_shapes``
against the JAX tools on the same inputs, and the rule that the port's
modules import none of cv2, PIL, jax, the JAX package, orbax, tensorstore
or a Python zstd module."""

import ast
import filecmp
import json
import os
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from dspnet_tpu.tools import im2rec as jim2rec
from dspnet_tpu.tools import prepare_cityscapes as jprep
from dspnet_tpu.tools import prepare_dataset as jprepds
from dspnet_tpu.tools import voc_palette as jpal
from dspnet_torch.data import image_io, jpeg
from dspnet_torch.tools import im2rec, prepare_cityscapes, prepare_dataset, visualize_net, voc_palette
from dspnet_torch.utils import raster
from tests.torch_parity import gtfine_scene, make_png, random_polygon, write_gtfine_tree

ROOT = Path(__file__).resolve().parent.parent

# ------------------------------------------------------------ fill_poly

XY_SHIFT = 16


def _trunc_div(a, b):
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _clip_line(w, h, x1, y1, x2, y2):
    """cv2's clipLine, one segment at a time."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line(img, x1, y1, x2, y2, val):
    """cv2's 8-connected Line: the LineIterator's error-term loop."""
    h, w = img.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        ok, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not ok:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, sy = x2 - x1, abs(y2 - y1), (-1 if y2 < y1 else 1)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, x, y = dx - 2 * dy, x1, y1
    for _ in range(dx + 1):
        img[y, x] = val
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y, x = y + sy, x + (1 if minor else 0)
        else:
            x, y = x + 1, y + (sy if minor else 0)


def fill_poly_loops(img, pts, val):
    """A scalar transcription of cv2 5.0.0's CollectPolyEdges and
    FillEdgeCollection (lineType 8, shift 0): the reference the vectorised
    ``raster.fill_poly`` is held to beside cv2 itself."""
    h, w = img.shape
    v = [tuple(int(c) for c in p) for p in np.asarray(pts).reshape(-1, 2)]
    edges, p0 = [], v[-1]
    for p1 in v:
        _line(img, p0[0], p0[1], p1[0], p1[1], val)
        c0, c1 = [p0[0] << XY_SHIFT, p0[1]], [p1[0] << XY_SHIFT, p1[1]]
        if not (0 <= p0[0] < w and 0 <= p1[0] < w and 0 <= p0[1] < h and 0 <= p1[1] < h):
            _, a, b, c, d = _clip_line(w, h, p0[0], p0[1], p1[0], p1[1])
            c0[0], c1[0] = a << XY_SHIFT, c << XY_SHIFT
            if b != d:
                c0[1], c1[1] = b, d
        if p0[1] != p1[1]:
            dx = _trunc_div(c1[0] - c0[0], c1[1] - c0[1])
            top, bot, c = (p0, p1, c0) if p0[1] < p1[1] else (p1, p0, c1)
            edges.append((top[1], bot[1], c[0] + (top[1] - c[1]) * dx, dx))
        p0 = p1
    if len(edges) < 2:
        return img
    for y in range(max(min(e[0] for e in edges), 0), min(max(e[1] for e in edges), h)):
        xs = sorted(x + (y - y0) * dx for y0, y1, x, dx in edges if y0 <= y < y1)
        for k in range(0, len(xs) - 1, 2):
            x1, x2 = (xs[k] + (1 << XY_SHIFT) - 1) >> XY_SHIFT, xs[k + 1] >> XY_SHIFT
            if x1 < w and x2 >= 0:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = val
    return img


POLY_KINDS = ("star", "tangle", "box", "point", "hline", "vline", "pair", "far")


def _polygons(rng, kind, n, hw):
    out = []
    for _ in range(n):
        if kind == "far":  # vertices far outside on every side, some negative
            H, W = hw
            k = rng.randint(3, 9)
            pts = np.stack([rng.randint(-4 * W, 5 * W, k), rng.randint(-4 * H, 5 * H, k)], -1)
        else:
            pts = np.asarray(random_polygon(rng, hw, kind))
        out.append(pts.astype(np.int32).reshape(-1, 1, 2))
    return out


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("kind", POLY_KINDS)
def test_fill_poly_equals_cv2(kind, dtype):
    """80 polygons of each kind (concave, self-intersecting, boxes, one
    point, horizontal and vertical segments, two points, and vertices far
    past every border) on images from 1x1 to 60x60: ``fill_poly`` paints
    exactly ``cv2.fillPoly``'s pixels, and so does the scalar transcription
    of cv2's loops."""
    rng = np.random.RandomState(POLY_KINDS.index(kind))
    value = 7 if dtype == np.uint8 else 26001
    for i in range(80):
        hw = (rng.randint(1, 61), rng.randint(1, 61))
        (pts,) = _polygons(rng, kind, 1, hw)
        want = np.zeros(hw, dtype)
        cv2.fillPoly(want, [pts], value)
        got = raster.fill_poly(np.zeros(hw, dtype), pts, value)
        np.testing.assert_array_equal(got, want, err_msg=f"{kind} #{i} {hw} {pts.reshape(-1, 2).tolist()}")
        np.testing.assert_array_equal(fill_poly_loops(np.zeros(hw, dtype), pts, value), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_fill_poly_scene_equals_cv2(dtype):
    """A Cityscapes-sized scene, 1024x512 with 100 polygons painted in turn
    over one image (later ones over earlier ones), equals cv2's."""
    rng = np.random.RandomState(11)
    scene = gtfine_scene(rng, (512, 1024), 100)
    want, got = np.full((512, 1024), 255, dtype), np.full((512, 1024), 255, dtype)
    for i, obj in enumerate(scene["objects"]):
        pts = np.asarray(obj["polygon"], np.int32).reshape(-1, 1, 2)
        cv2.fillPoly(want, [pts], i * 7 % 250)
        raster.fill_poly(got, pts, i * 7 % 250)
    np.testing.assert_array_equal(got, want)


def test_line_pixels_equal_cv2_line():
    """``line_pixels`` (the Bresenham steps in closed form) paints
    ``cv2.line``'s pixels at lineType 8, clipped segments included."""
    rng = np.random.RandomState(4)
    for _ in range(300):
        h, w = rng.randint(1, 40, 2)
        x1, x2 = rng.randint(-w, 2 * w, 2)
        y1, y2 = rng.randint(-h, 2 * h, 2)
        want = np.zeros((h, w), np.uint8)
        cv2.line(want, (int(x1), int(y1)), (int(x2), int(y2)), 1, lineType=8)
        got = np.zeros((h, w), np.uint8)
        ys, xs = raster.line_pixels(w, h, [x1], [y1], [x2], [y2])
        got[ys, xs] = 1
        np.testing.assert_array_equal(got, want)


def test_fill_poly_refuses_non_2d_and_skips_empty():
    with pytest.raises(ValueError, match="2-D"):
        raster.fill_poly(np.zeros((4, 4, 3), np.uint8), [[0, 0], [2, 2], [0, 3]], 1)
    img = np.zeros((4, 4), np.uint8)
    assert not raster.fill_poly(img, np.zeros((0, 1, 2), np.int32), 1).any()


# ------------------------------------------------------------ image_io reads


def _png_cases(rng):
    cases = []
    for depth in (1, 2, 4, 8, 16):
        hw = (rng.randint(1, 40), rng.randint(1, 40))
        cases.append((f"gray{depth}", make_png(rng.randint(0, 1 << depth, hw), 0, depth)))
        cases.append((f"gray{depth}+tRNS", make_png(rng.randint(0, 1 << depth, hw), 0, depth, trns=b"\0\1")))
        if depth <= 8:
            n = rng.randint(1, (1 << depth) + 1)
            pal = rng.randint(0, 256, (n, 3))
            pal[: min(2, n)] = pal[: min(2, n), :1]  # gray entries: R == G == B
            idx = rng.randint(0, n, hw)
            cases.append((f"palette{depth}", make_png(idx, 3, depth, pal)))
            trns = rng.randint(0, 256, rng.randint(1, n + 1)).astype(np.uint8).tobytes()
            cases.append((f"palette{depth}+tRNS", make_png(idx, 3, depth, pal, trns)))
        if depth >= 8:
            for color, ch in ((2, 3), (4, 2), (6, 4)):
                img = rng.randint(0, 1 << depth, hw + (ch,))
                img[0] = img[0, :, :1]
                cases.append((f"type{color}-{depth}", make_png(img, color, depth)))
            img = rng.randint(0, 1 << depth, hw + (3,))
            img[-1, -1] = img[0, 0]
            key = b"".join(int(v).to_bytes(2, "big") for v in img[0, 0])
            cases.append((f"rgb{depth}+tRNS", make_png(img, 2, depth, trns=key)))
    for img in (rng.randint(0, 256, (30, 41, 3)), rng.randint(0, 65536, (17, 9)),
                rng.randint(0, 65536, (17, 9, 3)), rng.randint(0, 256, (17, 9, 4))):
        img = img.astype(np.uint16 if img.max() > 255 else np.uint8)
        cases.append((f"cv2 {img.shape} {img.dtype}", cv2.imencode(".png", img)[1].tobytes()))
    return cases


@pytest.mark.parametrize("flag", ["IMREAD_UNCHANGED", "IMREAD_COLOR", "IMREAD_GRAYSCALE"])
def test_png_reads_equal_cv2(tmp_path, flag):
    """Every PNG colour type at every bit depth, palettes with and without
    ``tRNS``, ``tRNS`` on gray and RGB, and PNGs cv2 wrote: ``imread``
    returns cv2's array (dtype, shape, values) under each flag."""
    rng = np.random.RandomState(8)
    for name, data in _png_cases(rng):
        path = tmp_path / "x.png"
        path.write_bytes(data)
        want = cv2.imread(str(path), getattr(cv2, flag))
        got = image_io.imread(str(path), getattr(image_io, flag))
        assert (got.dtype, got.shape) == (want.dtype, want.shape), name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("depth", [8, 16])
def test_grayscale_of_colour_is_libpngs_rgb_to_gray(depth):
    """cv2 reads a colour PNG as gray through libpng's rgb_to_gray (15-bit
    weights 9797 / 19234 / 3737, truncated at 8 bits, rounded at 16, gray
    pixels kept), not cvtColor's: measured over every gray level and 2^18
    random colours. cvtColor's rule differs on some of them."""
    rng = np.random.RandomState(depth)
    top = (1 << depth) - 1
    img = rng.randint(0, top + 1, (512, 512, 3))
    img[0, :256] = np.arange(256)[:, None] * (257 if depth == 16 else 1)
    want = cv2.imdecode(np.frombuffer(make_png(img, 2, depth), np.uint8), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(image_io.imdecode(make_png(img, 2, depth), image_io.IMREAD_GRAYSCALE), want)
    assert (image_io.GRAY_RED, image_io.GRAY_GREEN, image_io.GRAY_BLUE) == (9797, 19234, 3737)
    if depth == 8:
        bgr = np.ascontiguousarray(img[..., ::-1].astype(np.uint8))
        assert (cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY) != want).any()


@pytest.mark.parametrize("sub", ["444", "422", "420", "gray"])
@pytest.mark.parametrize("orientation", [1, 6])
def test_jpeg_grayscale_equals_cv2(rng, sub, orientation):
    """A JPEG under IMREAD_GRAYSCALE is its luma plane, turned by the Exif
    orientation, as cv2 reads it."""
    img = cv2.GaussianBlur(rng.randint(0, 256, (37, 53, 3)).astype(np.uint8), (5, 5), 1.5)
    data = jpeg.encode(img[..., 0].copy(), 90) if sub == "gray" else jpeg.encode(img, 90, subsampling=sub)
    if orientation != 1:
        body = b"Exif\x00\x00MM" + struct.pack(">HIH", 42, 8, 1) + struct.pack(">HHIHH", 0x0112, 3, 1,
                                                                             orientation, 0) + b"\0" * 4
        data = data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(image_io.imdecode(data, image_io.IMREAD_GRAYSCALE), want)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _adam7_png(samples, color, depth, palette=None):
    """An interlaced (Adam7) PNG of ``samples`` at any colour type and bit
    depth: each of the seven passes a reduced image of its own, its rows
    filtered None, Sub and Up in turn (Up from the pass's previous row)."""
    s = np.asarray(samples)
    s = s[..., None] if s.ndim == 2 else s
    h, w, ch = s.shape
    bpp = max(1, ch * depth // 8)
    raw = b""
    for x0, y0, dx, dy in ADAM7:
        sub = s[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = np.frombuffer(make_png(sub, color, depth, palette), np.uint8)  # the packing of make_png
        packed = zlib.decompress(_idat(rows.tobytes()))
        stride = len(packed) // sub.shape[0]
        prev = np.zeros(stride - 1, np.uint8)
        for y in range(sub.shape[0]):
            line = np.frombuffer(packed[y * stride + 1:(y + 1) * stride], np.uint8)
            kind = y % 3
            if kind == 1:
                out = line - np.concatenate([np.zeros(bpp, np.uint8), line[:-bpp]])
            elif kind == 2:
                out = line - prev
            else:
                out = line
            raw += bytes([kind]) + out.astype(np.uint8).tobytes()
            prev = line
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 1)
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
    if palette is not None:
        out += _png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b"")


def _png_chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _idat(png: bytes) -> bytes:
    pos, out = 8, b""
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        if png[pos + 4:pos + 8] == b"IDAT":
            out += png[pos + 8:pos + 8 + n]
        pos += 12 + n
    return out


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (37, 53)])
@pytest.mark.parametrize("form", ["gray1", "gray2", "gray4", "gray8", "gray16", "palette1", "palette2", "palette4",
                                  "palette8", "rgb8", "rgb16", "ga8", "ga16", "rgba8", "rgba16"])
def test_adam7_pngs_equal_cv2(form, hw):
    """Interlaced (Adam7) PNGs of every colour type and depth, at sizes
    where some passes are empty: ``imdecode`` returns cv2's array under
    IMREAD_UNCHANGED, IMREAD_COLOR and IMREAD_GRAYSCALE, and the samples
    equal the non-interlaced file's."""
    rng = np.random.RandomState(sum(hw) + len(form))
    kind = form.rstrip("0123456789")
    depth = int(form[len(kind):])
    color, ch = {"gray": (0, 1), "palette": (3, 1), "rgb": (2, 3), "ga": (4, 2), "rgba": (6, 4)}[kind]
    samples = rng.randint(0, 1 << depth, hw + (ch,))
    palette = rng.randint(0, 256, (1 << depth, 3)) if kind == "palette" else None
    data = _adam7_png(samples, color, depth, palette)
    flat = make_png(samples, color, depth, palette)
    for flag in ("IMREAD_UNCHANGED", "IMREAD_COLOR", "IMREAD_GRAYSCALE"):
        want = cv2.imdecode(np.frombuffer(data, np.uint8), getattr(cv2, flag))
        got = image_io.imdecode(data, getattr(image_io, flag))
        assert (got.dtype, got.shape) == (want.dtype, want.shape), flag
        np.testing.assert_array_equal(got, want, err_msg=flag)
        np.testing.assert_array_equal(image_io.imdecode(flat, getattr(image_io, flag)), want, err_msg=flag)


def test_sixteen_bit_pngs_both_ways(tmp_path):
    """A 16-bit PNG written by cv2 (libpng's filters) reads back as its
    array here, and one written here reads back as the same array in cv2."""
    rng = np.random.RandomState(2)
    img = (rng.randint(0, 4000, (64, 96)) + np.arange(96) * 600).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(image_io.imread(str(tmp_path / "a.png"), image_io.IMREAD_UNCHANGED), img)
    image_io.imwrite(str(tmp_path / "b.png"), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "b.png"), cv2.IMREAD_UNCHANGED), img)


def test_png_reader_refusals():
    with pytest.raises(ValueError, match="not valid PNG"):
        image_io.decode_png(make_png(np.zeros((2, 2, 3)), 2, 4))
    with pytest.raises(ValueError, match="without a PLTE"):
        image_io.decode_png(make_png(np.zeros((2, 2)), 3, 8))
    with pytest.raises(ValueError, match="past its"):
        image_io.decode_png(make_png(np.full((2, 2), 3), 3, 8, np.zeros((2, 3))))
    with pytest.raises(ValueError, match="flags"):
        image_io.imdecode(make_png(np.zeros((2, 2)), 0, 8), 2)


# ------------------------------------------------------------ prepare_cityscapes


@pytest.fixture(scope="module")
def gtfine(tmp_path_factory):
    """A raw tree of 3 train and 2 val scenes at 128x256, 40 polygons each
    (stuff, things, groups, deleted objects, degenerate and border-crossing
    polygons), with 16-bit disparity."""
    root = tmp_path_factory.mktemp("raw")
    write_gtfine_tree(str(root), str(root / "jpg"), {"train": 3, "val": 2}, hw=(128, 256), seed=4,
                      n_objects=40)
    return root


def _same_tree(a, b):
    """Every file under ``a`` is under ``b`` and equal: PNGs as arrays (as
    cv2 reads them), anything else byte for byte."""
    files = sorted(p.relative_to(a) for p in Path(a).rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(b) for p in Path(b).rglob("*") if p.is_file())
    for rel in files:
        if rel.suffix == ".png":
            want = cv2.imread(str(Path(a) / rel), cv2.IMREAD_UNCHANGED)
            got = image_io.imread(str(Path(b) / rel), image_io.IMREAD_UNCHANGED)
            assert got.dtype == want.dtype, rel
            np.testing.assert_array_equal(got, want, err_msg=str(rel))
        else:
            assert filecmp.cmp(Path(a) / rel, Path(b) / rel, shallow=False), rel
    return files


@pytest.mark.parametrize("extra", [[], ["--instance-ids"], ["--instance-ids", "--scale", "1.0"],
                                   ["--scale", "0.25", "--classes", "car,person"]])
def test_prepare_cityscapes_main_equals_jax(gtfine, tmp_path, extra):
    """``main`` over both splits with disparity: the XML (minidom's form,
    then ET.write's after inject_distances), trainIds, instanceIds and
    half-resolution disparity PNGs and ImageSets equal the JAX tool's."""
    for split in ("train", "val"):
        for mod, out in ((jprep, tmp_path / "jax"), (prepare_cityscapes, tmp_path / "port")):
            mod.main(["--gtfine", str(gtfine / "gtFine"), "--disparity", str(gtfine / "disparity"),
                      "--out", str(out), "--split", split] + extra)
    files = _same_tree(tmp_path / "jax", tmp_path / "port")
    assert sum(f.parts[0] == "Disparity" for f in files) == 5
    assert sum(f.parts[0] == "SegmentationInstance" for f in files) == (5 if "--instance-ids" in extra else 0)
    xml = (tmp_path / "port" / "Annotations" / files[0].name).read_text()
    assert "<distance>" in xml


def test_prepare_cityscapes_without_disparity_equals_jax(gtfine, tmp_path):
    """Without ``--disparity`` the XML keeps minidom's pretty form."""
    for mod, out in ((jprep, tmp_path / "jax"), (prepare_cityscapes, tmp_path / "port")):
        mod.main(["--gtfine", str(gtfine / "gtFine"), "--out", str(out), "--split", "train"])
    files = _same_tree(tmp_path / "jax", tmp_path / "port")
    assert (tmp_path / "port" / [f for f in files if f.suffix == ".xml"][0]).read_text().startswith(
        '<?xml version="1.0" ?>\n<annotation>\n\t<filename>')


@pytest.mark.parametrize("encoding", ["ids", "trainIds"])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_instanceid_pngs_equal_jax(tmp_path, encoding, scale):
    """Both instanceIds encodings on scenes with groups, instance-less and
    id -1 classes, at two scales."""
    rng = np.random.RandomState(5)
    for i in range(3):
        jp = tmp_path / f"s{i}.json"
        jp.write_text(json.dumps(gtfine_scene(rng, (96, 160), 50)))
        jprep.polygons_to_instanceid_png(str(jp), str(tmp_path / "j.png"), encoding=encoding, scale=scale)
        prepare_cityscapes.polygons_to_instanceid_png(str(jp), str(tmp_path / "t.png"), encoding=encoding,
                                                      scale=scale)
        want = cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(image_io.imread(str(tmp_path / "t.png"), image_io.IMREAD_UNCHANGED), want)
        assert want.dtype == np.uint16 and (want >= 1000).any()


def test_json_to_xml_and_trainids_equal_jax(tmp_path):
    """The two rasterisers' shared polygon loop and the XML writer on one
    parsed scene, passed in as ``parsed`` as ``main`` does."""
    rng = np.random.RandomState(6)
    scene = gtfine_scene(rng, (64, 128), 30)
    jp = str(tmp_path / "a_gtFine_polygons.json")
    for mod, tag in ((jprep, "j"), (prepare_cityscapes, "t")):
        mod.json_to_xml(jp, str(tmp_path / f"{tag}.xml"), scale=0.5, parsed=scene)
        mod.polygons_to_trainid_png(jp, str(tmp_path / f"{tag}.png"), scale=0.5, parsed=scene)
    assert (tmp_path / "j.xml").read_bytes() == (tmp_path / "t.xml").read_bytes()
    np.testing.assert_array_equal(image_io.imread(str(tmp_path / "t.png"), image_io.IMREAD_UNCHANGED),
                                  cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED))


def test_disparity_to_distance_equals_jax():
    """One pixel, an empty ROI, a far median (> 1000 m -> 200) and an even
    count (the n // 2 index)."""
    for roi in (np.array([[1650]], np.uint16), np.zeros((0,), np.uint16), np.array([[100]], np.uint16),
                np.array([[3000, 1000, 2000, 4000]], np.uint16)):
        assert prepare_cityscapes.disparity_to_distance(roi) == jprep.disparity_to_distance(roi)
    assert prepare_cityscapes.disparity_to_distance(np.array([[1650]], np.uint16)) == pytest.approx(
        2200 * 75 / 1650.001, rel=1e-6)


# ------------------------------------------------------------ prepare_dataset, im2rec


def _voc(root, year, n):
    base = Path(root) / f"VOC{year}"
    for d in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (base / d).mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(int(year))
    ids = [f"{i:06d}" for i in range(n)]
    for iid in ids:
        (base / "JPEGImages" / f"{iid}.jpg").write_bytes(jpeg.encode(rng.randint(0, 256, (60, 80, 3))
                                                                     .astype(np.uint8), 90))
        objs = "".join(f"<object><name>{c}</name><difficult>{d}</difficult><bndbox><xmin>{x}</xmin>"
                       f"<ymin>10</ymin><xmax>{x + 20}</xmax><ymax>40</ymax></bndbox></object>"
                       for c, d, x in (("car", 0, 5), ("dog", 1, 30), ("person", 0, rng.randint(1, 50))))
        (base / "Annotations" / f"{iid}.xml").write_text(
            f"<annotation><size><width>80</width><height>60</height><depth>3</depth></size>{objs}</annotation>")
    (base / "ImageSets" / "Main" / "trainval.txt").write_text("\n".join(ids) + "\n")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory, gtfine):
    """A VOC devkit (2007, 2012) and a prepared Cityscapes layout."""
    root = tmp_path_factory.mktemp("ds")
    _voc(root / "voc", "2007", 3)
    _voc(root / "voc", "2012", 2)
    cs = root / "cs"
    for split in ("train", "val"):
        prepare_cityscapes.main(["--gtfine", str(gtfine / "gtFine"), "--disparity", str(gtfine / "disparity"),
                                 "--out", str(cs), "--split", split, "--instance-ids"])
    (cs / "JPEGImages").mkdir()
    for p in (gtfine / "jpg").iterdir():
        (cs / "JPEGImages" / p.name).write_bytes(p.read_bytes())
    return root


@pytest.mark.parametrize("args", [
    ["--dataset", "pascal", "--set", "trainval", "--year", "2007", "--pack"],
    ["--dataset", "voc", "--set", "trainval", "--year", "2007,2012", "--pack", "--difficult"],
    ["--dataset", "cityscapes", "--set", "train", "--pack"],
    ["--dataset", "cityscapes", "--set", "val"],
], ids=["voc", "voc-concat-difficult", "cityscapes", "cityscapes-lst-only"])
def test_prepare_dataset_equals_jax(datasets, tmp_path, args):
    """The ``.lst`` text and the ``.drec`` / ``.idx`` bytes equal the JAX
    tool's."""
    root = datasets / ("voc" if args[1] in ("pascal", "voc") else "cs")
    for mod, d in ((jprepds, "jax"), (prepare_dataset, "port")):
        mod.main(args + ["--root", str(root), "--target", str(tmp_path / d / "set.lst")])
    names = _same_tree(tmp_path / "jax", tmp_path / "port")
    assert [n.name for n in names] == (["set.drec", "set.idx", "set.lst"] if "--pack" in args else ["set.lst"])


@pytest.mark.parametrize("source", ["lst", "lst-no-seg", "dataset-root", "from-rec"])
def test_im2rec_equals_jax(datasets, tmp_path, source):
    """``--lst`` (with and without the seg lookup), ``--dataset-root`` and
    ``--from-rec`` (a reference-format ``.rec`` with its ``.lst``) give the
    JAX tool's ``.drec`` and ``.idx`` bytes."""
    from dspnet_tpu.data import rec_import as jrec

    cs = datasets / "cs"
    lst = tmp_path / "train.lst"
    prepare_dataset.main(["--dataset", "cityscapes", "--set", "train", "--root", str(cs), "--target", str(lst)])
    if source == "dataset-root":
        args = ["--dataset-root", str(cs), "--split", "val"]
    elif source == "from-rec":
        from dspnet_torch.data import imdb

        samples = imdb.CityscapesDetSeg("train", str(cs)).samples()
        payloads = []
        for i, s in enumerate(samples):
            rows = s.label[s.label[:, 0] >= 0]
            vec = np.concatenate([[2.0, 6.0], rows.reshape(-1)]).astype(np.float32)
            payloads.append(jrec.pack_payload(i, vec, Path(s.image_path).read_bytes()))
        jrec.write_records(str(tmp_path / "train.rec"), payloads)
        args = ["--from-rec", str(tmp_path / "train.rec"), "--lst", str(lst)]
    else:
        args = ["--lst", str(lst)] + (["--no-seg"] if source == "lst-no-seg" else [])
    for mod, d in ((jim2rec, "jax"), (im2rec, "port")):
        mod.main(args + ["--out", str(tmp_path / d / "packed")])
    _same_tree(tmp_path / "jax", tmp_path / "port")
    with pytest.raises(SystemExit):
        im2rec.main(["--out", str(tmp_path / "x")])


# ------------------------------------------------------------ voc_palette


def test_voc_palette_both_ways_equals_jax(tmp_path):
    """A VOC palette mask (colour type 3 with the VOC colormap and a void
    colour) -> class indices, and the indices -> colours, equal the JAX
    tool's files; the round trip gives the mask's colours back."""
    rng = np.random.RandomState(9)
    pal = jpal.voc_palette()
    np.testing.assert_array_equal(voc_palette.voc_palette(), pal)
    idx = rng.randint(0, 21, (40, 60))
    idx[:3] = 255  # VOC's void boundary
    pal[255] = (224, 224, 192)
    src = tmp_path / "mask.png"
    src.write_bytes(make_png(idx, 3, 8, pal))
    for mod, d in ((jpal, "jax"), (voc_palette, "port")):
        (tmp_path / d).mkdir()
        mod.main([str(src), str(tmp_path / d / "index.png")])
        mod.main(["--colorize", str(tmp_path / d / "index.png"), str(tmp_path / d / "colour.png")])
    _same_tree(tmp_path / "jax", tmp_path / "port")
    got = image_io.imread(str(tmp_path / "port" / "index.png"), image_io.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, np.where(idx == 255, 255, idx))
    back = image_io.imread(str(tmp_path / "port" / "colour.png"))
    keep = idx != 255
    np.testing.assert_array_equal(back[keep], image_io.imread(str(src))[keep])
    # a palette PNG given to --colorize is read as gray, as cv2 reads it
    voc_palette.main(["--colorize", str(src), str(tmp_path / "c.png")])
    jpal.main(["--colorize", str(src), str(tmp_path / "cj.png")])
    np.testing.assert_array_equal(image_io.imread(str(tmp_path / "c.png")), cv2.imread(str(tmp_path / "cj.png")))


# ------------------------------------------------------------ shapes, visualize_net

#: JAX-only module paths, by network: the flax wrappers around a BatchNorm
#: or a ConvTranspose (``…/bn1`` around ``…/bn1/BatchNorm_0``), whose output
#: is their inner module's; the port has the one module
#: (``utils/convert.py``). No path is the port's alone.
WRAPPERS = {"resnet-18_multi": 28, "vgg16_reduced": 0, "inceptionv3": 94}
#: shared paths whose shapes differ: the JAX resnet stem runs BatchNorm on
#: the space-to-depth input (2x2 blocks of the image as 12 channels, not
#: ported, ROADMAP Queue A item 17); the port's on the image itself
SHAPE_DIFFERS = {"resnet-18_multi": {"backbone/bn_data/BatchNorm_0/__call__/0": ((1, 64, 128, 12),
                                                                                (1, 128, 256, 3))}}


@pytest.mark.parametrize("net, hw", [("resnet-18_multi", (128, 256)), ("vgg16_reduced", (300, 300)),
                                     ("inceptionv3", (300, 300))])
def test_intermediate_shapes_equal_jax(net, hw):
    from dspnet_tpu.api import create_model as jax_create_model
    from dspnet_tpu.utils.shapes import intermediate_shapes as jax_shapes
    from dspnet_torch.api import create_model
    from dspnet_torch.utils.shapes import intermediate_shapes

    want = jax_shapes(jax_create_model(net, hw, 8).model, hw)
    model = create_model(net, hw, 8, device="meta").model
    got = intermediate_shapes(model, hw)
    assert not set(got) - set(want)
    jax_only = set(want) - set(got)
    wrapped = {k for k in want if k.endswith(("/BatchNorm_0/__call__/0", "/ConvTranspose_0/__call__/0"))}
    assert jax_only == {k.rsplit("/", 3)[0] + "/__call__/0" for k in wrapped}
    assert len(jax_only) == WRAPPERS[net]
    differ = {k: (want[k], got[k]) for k in got if got[k] != want[k]}
    assert differ == SHAPE_DIFFERS.get(net, {})
    assert next(iter(model.parameters())).device.type == "meta"
    with pytest.raises(ValueError, match="meta"):
        intermediate_shapes(create_model("resnet-18_multi", (64, 64), 8, device="cpu").model, (64, 64))


@pytest.mark.parametrize("hw, anchors", [((512, 1024), 12264), ((320, 640), 4822)])
def test_visualize_net_anchor_counts(capsys, hw, anchors):
    """resnet-50_multi's anchors at the reference's two golden shapes
    (SURVEY.md: 4,822 at 320x640); the last line is the JAX tool's."""
    visualize_net.main(["--network", "resnet-50_multi", "--data-shape", f"3,{hw[0]},{hw[1]}", "--num-classes", "8"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == f"task=multi anchors={anchors} input={hw[0]}x{hw[1]}"
    assert any(line.startswith("seg/score4_conv/ConvTranspose_0/__call__/0") for line in lines)


def test_visualize_net_refuses_hlo():
    with pytest.raises(SystemExit) as err:
        visualize_net.main(["--network", "vgg16_reduced", "--hlo", "x.txt"])
    assert err.value.code == 2


# ------------------------------------------------------------ imports

@pytest.mark.parametrize("path", ["chip_smoke.py"] + sorted(str(p.relative_to(ROOT))
                                                            for p in (ROOT / "dspnet_torch").rglob("*.py")))
def test_no_cv2_pil_jax_in_the_port(path):
    """No module of the port (the tools of this slice among them) and not
    ``chip_smoke.py`` imports cv2, PIL, fontTools, jax, flax, the JAX
    package, or the JAX checkpoints' stack (orbax, tensorstore, a Python
    zstd module), at any depth of its code."""
    tree = ast.parse((ROOT / path).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    banned = [n for n in names if n.split(".")[0] in ("cv2", "PIL", "fontTools", "jax", "flax", "dspnet_tpu",
                                                         "orbax", "tensorstore", "zstandard", "compression")]
    assert not banned, (path, banned)

