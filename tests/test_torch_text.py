"""``dspnet_torch/utils/text.py`` and ``utils/truetype.py`` against cv2
5.0.0 and fontTools, live, on the CPU: the font file as cv2 carries it,
the reader's outlines, advances and metrics at ``wght`` 400, 600 and 800,
every demo label (each class name and id with every distance from "-0m" to
"255m") at ``FONT_HERSHEY_SIMPLEX`` 0.5 and under ``label_box``'s
``FONT_HERSHEY_PLAIN`` 0.6, a hypothesis property over printable ASCII,
both faces, scales 0.3-3.0 and thickness 1-3, the blend on the colours and
coverages that tell its candidate forms apart, the committed forms of
``tests/fixtures/text_forms/`` (``python tests/make_text_fixtures.py``),
and each refusal by name."""

import hashlib
import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dspnet_torch.utils import draw, text
from dspnet_torch.utils.truetype import Font

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import make_text_fixtures  # noqa: E402

SIMPLEX, PLAIN = cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_PLAIN
NAMES = make_text_fixtures.label_names()
DISTANCES = ["-0m"] + [f"{d}m" for d in range(256)]
LABEL_CHARS = sorted(set("".join(NAMES) + "".join(DISTANCES) + " "))


def _cv2(img, s, org, face, scale, color, thickness):
    out = img.copy()
    cv2.putText(out, s, tuple(int(v) for v in org), face, scale, tuple(color), thickness)
    return out


def _port(img, s, org, face, scale, color, thickness):
    return text.put_text(img.copy(), s, org, face, scale, color, thickness)


# ---------------------------------------------------------------- the font

def test_the_font_is_cv2s_rubik_byte_for_byte():
    """The committed font is the upright Rubik cv2 5.0.0 carries (found by
    gzip magic and name table in ``cv2.abi3.so``), with its licence text."""
    data = text.FONT_PATH.read_bytes()
    assert len(data) == 359916 and hashlib.sha256(data).hexdigest() == text.FONT_SHA256
    assert make_text_fixtures.cv2_fonts()[make_text_fixtures.FONT_NAME] == data
    licence = (text.FONT_PATH.parent / "OFL.txt").read_text()
    assert "SIL Open Font License, Version 1.1" in licence and text.FONT_SHA256 in licence


def test_a_changed_font_file_raises_by_name(tmp_path, monkeypatch):
    bad = bytearray(text.FONT_PATH.read_bytes())
    bad[1000] ^= 1
    path = tmp_path / "rubik_opencv.ttf"
    path.write_bytes(bytes(bad))
    monkeypatch.setattr(text, "FONT_PATH", path)
    text.font.cache_clear()
    try:
        with pytest.raises(text.TextError, match="rubik_opencv.ttf has sha256"):
            text.font()
    finally:
        monkeypatch.undo()
        text.font.cache_clear()


@pytest.fixture(scope="module")
def fonts():
    from fontTools.ttLib import TTFont

    return Font.from_file(text.FONT_PATH), TTFont(str(text.FONT_PATH))


def test_reader_tables_equal_fonttools(fonts):
    """cmap, metrics, axes and the user -> normalised mapping (avar,
    F2Dot14) as fontTools reads them."""
    from fontTools.varLib.models import normalizeLocation

    ours, ft = fonts
    assert ours.cmap == {c: ft.getGlyphID(n) for c, n in ft.getBestCmap().items()}
    assert (ours.units_per_em, ours.ascent, ours.descent) == (ft["head"].unitsPerEm, ft["hhea"].ascent,
                                                              ft["hhea"].descent)
    assert [(a.tag, a.minimum, a.default, a.maximum) for a in ours.axes] == [
        (a.axisTag, a.minValue, a.defaultValue, a.maxValue) for a in ft["fvar"].axes]
    axes = {a.axisTag: (a.minValue, a.defaultValue, a.maxValue) for a in ft["fvar"].axes}
    for w in (300, 350, 400, 450, 500, 600, 700, 800, 900):
        loc = normalizeLocation({"wght": w}, axes)
        seg = sorted(ft["avar"].segments["wght"].items())
        t = loc["wght"]
        for (a0, b0), (a1, b1) in zip(seg, seg[1:]):
            if a0 <= t <= a1:
                t = b0 + (t - a0) / (a1 - a0) * (b1 - b0) if a1 != a0 else b0
                break
        assert ours.normalize({"wght": w}) == (round(t * 16384) / 16384,), w


@pytest.mark.parametrize("weight", [400, 600, 800])
def test_outlines_and_advances_equal_fonttools(fonts, weight):
    """Every glyph the label alphabet and printable ASCII use, and every
    composite of the cmap: the instance's points (fontTools' glyphset at
    the same normalised location, composites decomposed) and advances
    (HVAR); and MVAR's one varied metric."""
    from fontTools.pens.recordingPen import DecomposingRecordingPointPen
    from fontTools.varLib.varStore import VarStoreInstancer

    ours, ft = fonts
    loc = ours.normalize({"wght": weight})
    gs = ft.getGlyphSet(location={"wght": loc[0]}, normalized=True)
    gids = {ours.glyph_id(ord(c)) for c in LABEL_CHARS + [chr(c) for c in range(0x20, 0x7F)]}
    gids |= {g for g in set(ours.cmap.values()) if ours.raw_glyph(g).components}
    for gid in sorted(gids):
        name = ft.getGlyphName(gid)
        pen = DecomposingRecordingPointPen(gs)
        gs[name].drawPoints(pen)
        want = np.array([v[1][0] for v in pen.value if v[0] == "addPoint"], np.float64).reshape(-1, 2)
        got = ours.glyph(gid, loc)
        np.testing.assert_allclose(np.stack([got.xs, got.ys], 1), want, rtol=0, atol=1e-9, err_msg=name)
        assert abs(ours.advance(gid, loc) - gs[name].width) < 1e-9, name
    mvar = ft["MVAR"].table
    inst = VarStoreInstancer(mvar.VarStore, ft["fvar"].axes, {"wght": loc[0]})
    for rec in mvar.ValueRecord:
        assert abs(ours.metric_delta(rec.ValueTag, loc) - inst[rec.VarIdx]) < 1e-9, rec.ValueTag


# ------------------------------------------------------------ the labels

@pytest.mark.parametrize("name", NAMES)
def test_demo_labels_equal_cv2(name):
    """"name Nm" for every distance at SIMPLEX 0.5 (the demo's boxes) and
    PLAIN 0.6 (``label_box``), on a random background in a random colour,
    placed inside, near the edges and clipped: equal bit for bit, and so is
    ``getTextSize``."""
    rng = np.random.RandomState(sum(map(ord, name)))
    img = rng.randint(0, 256, (64, 160, 3)).astype(np.uint8)
    for k, dist in enumerate(DISTANCES):
        s = f"{name} {dist}"
        face, scale = (SIMPLEX, 0.5) if k % 2 == 0 else (PLAIN, 0.6)
        org = (int(rng.randint(-30, 140)), int(rng.randint(-2, 70)))
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        np.testing.assert_array_equal(_port(img, s, org, face, scale, color, 1),
                                      _cv2(img, s, org, face, scale, color, 1), err_msg=s)
        assert text.get_text_size(s, face, scale, 1) == cv2.getTextSize(s, face, scale, 1), s


def test_label_box_banner_is_get_text_size_of_plain():
    assert text.get_text_size("car 12m", PLAIN, 0.6, 1) == ((34, 9), 1)
    assert text.get_text_size("car 12m", SIMPLEX, 0.5, 1) == ((56, 14), 1)
    img = np.zeros((40, 80, 3), np.uint8)
    out = draw.label_box(img.copy(), "car 12m", (10, 30, 60, 38))
    assert (out[21:30, 11:44] != 0).any() and (out[21, 11:44] == (128, 0, 0)).any()


def test_no_kerning_and_integer_advances():
    """cv2 lays "AV", "To" and "Ty" out without kerning: each glyph at the
    pen, the pen advancing by whole pixels."""
    for s in ("AV", "To", "Ty", "LT", "P.", "Yo", "HHHHHH"):
        for scale in (0.5, 1.0, 2.7):
            img = np.zeros((120, 400, 3), np.uint8)
            np.testing.assert_array_equal(_port(img, s, (5, 90), SIMPLEX, scale, (255, 255, 255), 1),
                                          _cv2(img, s, (5, 90), SIMPLEX, scale, (255, 255, 255), 1))


def _composites():
    f = text.font()
    return [chr(c) for c, g in sorted(f.cmap.items()) if f.raw_glyph(g).components and not f.uses_iup(g)]


@pytest.mark.parametrize("call", [(SIMPLEX, 0.5, 1), (PLAIN, 2.9, 2), (SIMPLEX, 1.7, 3)])
def test_composite_characters_equal_cv2(call):
    """Rubik's composite characters (accented Latin and others) whose parts
    need no IUP: each component's instance moved by its offset and the
    offset's variation, as cv2 joins them."""
    face, scale, thickness = call
    chars = _composites()
    assert len(chars) == 216
    for k in range(0, len(chars), 12):
        s = "".join(chars[k:k + 12])
        img = np.random.RandomState(k).randint(0, 256, (160, 900, 3)).astype(np.uint8)
        np.testing.assert_array_equal(_port(img, s, (4, 110), face, scale, (250, 3, 128), thickness),
                                      _cv2(img, s, (4, 110), face, scale, (250, 3, 128), thickness), err_msg=s)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(s=st.text(alphabet=st.characters(min_codepoint=0x20, max_codepoint=0x7E), max_size=14),
       face=st.sampled_from([SIMPLEX, PLAIN]), scale=st.floats(0.3, 3.0), thickness=st.integers(1, 3),
       color=st.tuples(*[st.integers(0, 255)] * 3), org=st.tuples(st.integers(-60, 250), st.integers(-20, 130)),
       seed=st.integers(0, 2 ** 31 - 1), gray=st.booleans())
def test_put_text_and_get_text_size_equal_cv2_on_printable_ascii(s, face, scale, thickness, color, org, seed, gray):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (110, 240) if gray else (110, 240, 3)).astype(np.uint8)
    np.testing.assert_array_equal(_port(img, s, org, face, scale, color, thickness),
                                  _cv2(img, s, org, face, scale, color, thickness))
    assert text.get_text_size(s, face, scale, thickness) == cv2.getTextSize(s, face, scale, thickness)


@pytest.mark.parametrize("face,scale,size", [(SIMPLEX, 0.5, 14), (SIMPLEX, 1.0, 27), (SIMPLEX, 0.3, 8),
                                             (PLAIN, 0.6, 9), (PLAIN, 0.3, 5), (PLAIN, 0.957, 15),
                                             (PLAIN, 1.3, 20), (SIMPLEX, 2.5, 68)])
def test_hershey_sizes(face, scale, size):
    """cv2 5's size is ``rint(scale * 100 / 3.7)`` (SIMPLEX) or ``/ 6.6``
    (PLAIN) in double, half to even: 0.957 * 100 / 6.6 is a hair above 14.5."""
    assert text.hershey_to_truetype(face, scale, 1) == (size, 400)
    assert cv2.getTextSize("H", face, scale, 1)[0][1] == size


def test_weights_by_thickness():
    assert [text.hershey_to_truetype(SIMPLEX, 1.0, t)[1] for t in (1, 2, 3)] == [400, 600, 600]
    assert [text.hershey_to_truetype(PLAIN, 1.0, t)[1] for t in (1, 2, 3)] == [400, 800, 800]


# -------------------------------------------------------------- the blend

@pytest.mark.parametrize("bg", [0, 1, 2, 127, 128, 253, 254, 255])
def test_blend_on_the_forms_that_separate_the_rules(bg):
    """Uniform backgrounds near 0 and 255 under colours near 0 and 255, a
    big string covering every coverage level: cv2's blend is
    ``(d * (255 - a) + c * a + 127) // 255``, and the port's equals it."""
    img = np.full((240, 700, 3), bg, np.uint8)
    cover = _cv2(np.zeros_like(img), "@%&SW", (10, 190), SIMPLEX, 6.0, (255, 255, 255), 1)[..., 0]
    assert len(np.unique(cover)) > 200
    for color in ((0, 1, 2), (253, 254, 255), (127, 128, 129), (255, 0, 1)):
        want = _cv2(img, "@%&SW", (10, 190), SIMPLEX, 6.0, color, 1)
        a = cover.astype(np.int64)[..., None]
        rule = (img.astype(np.int64) * (255 - a) + np.array(color) * a + 127) // 255
        np.testing.assert_array_equal(want, rule)
        np.testing.assert_array_equal(_port(img, "@%&SW", (10, 190), SIMPLEX, 6.0, color, 1), want)


def test_string_cache_counts_hits():
    text.clear_caches()
    img = np.zeros((30, 120, 3), np.uint8)
    for _ in range(3):
        text.put_text(img, "bus 40m", (2, 20), SIMPLEX, 0.5, (0, 255, 0), 1)
    assert text.STATS == {"hits": 2, "misses": 1}


# ------------------------------------------------------- committed forms

FORMS = json.loads((ROOT / "tests" / "fixtures" / "text_forms" / "forms.json").read_text())


def test_forms_are_cv2s():
    """The committed forms still hold cv2's output here (the card's machine
    has no cv2 and checks the port against them)."""
    assert FORMS["cv2"] == cv2.__version__ and len(FORMS["forms"]) == 300
    for f in FORMS["forms"][::7]:
        img = _cv2(make_text_fixtures.background(f), f["text"], f["org"], f["face"], f["scale"], f["color"],
                   f["thickness"])
        assert hashlib.sha256(img.tobytes()).hexdigest() == f["sha256"], f


@pytest.mark.parametrize("chunk", range(6))
def test_port_equals_the_committed_forms(chunk):
    for f in FORMS["forms"][chunk::6]:
        img = _port(make_text_fixtures.background(f), f["text"], f["org"], f["face"], f["scale"], f["color"],
                    f["thickness"])
        assert hashlib.sha256(img.tobytes()).hexdigest() == f["sha256"], f
        (w, h), bl = text.get_text_size(f["text"], f["face"], f["scale"], f["thickness"])
        assert [[w, h], bl] == f["text_size"], f


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("face,name", [(cv2.FONT_HERSHEY_DUPLEX, "FONT_HERSHEY_DUPLEX"),
                                       (cv2.FONT_HERSHEY_COMPLEX, "FONT_HERSHEY_COMPLEX"),
                                       (cv2.FONT_HERSHEY_TRIPLEX, "FONT_HERSHEY_TRIPLEX"),
                                       (cv2.FONT_HERSHEY_COMPLEX_SMALL, "FONT_HERSHEY_COMPLEX_SMALL"),
                                       (cv2.FONT_HERSHEY_SCRIPT_SIMPLEX, "FONT_HERSHEY_SCRIPT_SIMPLEX"),
                                       (cv2.FONT_HERSHEY_SCRIPT_COMPLEX, "FONT_HERSHEY_SCRIPT_COMPLEX"),
                                       (SIMPLEX | cv2.FONT_ITALIC, "FONT_ITALIC")])
def test_refuses_other_faces(face, name):
    img = np.zeros((20, 40, 3), np.uint8)
    for call in (lambda: text.put_text(img, "a", (0, 10), face, 0.5, (1, 2, 3), 1),
                 lambda: text.get_text_size("a", face, 0.5, 1)):
        with pytest.raises(text.TextError, match=name):
            call()


@pytest.mark.parametrize("kwargs,match", [
    ({"thickness": 0}, "thickness 0"), ({"thickness": 4}, "thickness 4"), ({"thickness": -1}, "thickness -1"),
    ({"scale": 0.0}, "mirrors"), ({"scale": -0.5}, "mirrors"), ({"scale": 0.01}, "0-pixel"),
    ({"s": "a中"}, "U\\+4E2D"), ({"s": "tab\t"}, "U\\+0009"), ({"s": "Å"}, "U\\+00C5"),
    ({"bottom_left_origin": True}, "bottomLeftOrigin"), ({"img": np.zeros((9, 9, 4), np.uint8)}, "uint8"),
    ({"img": np.zeros((9, 9, 3), np.float32)}, "float32")])
def test_refusals_raise_by_name(kwargs, match):
    args = {"img": np.zeros((20, 40, 3), np.uint8), "s": "ab", "scale": 0.5, "thickness": 1,
            "bottom_left_origin": False}
    args.update(kwargs)
    with pytest.raises(text.TextError, match=match):
        text.put_text(args["img"], args["s"], (0, 10), SIMPLEX, args["scale"], (1, 2, 3), args["thickness"],
                      args["bottom_left_origin"])


def test_empty_and_blank_strings():
    img = np.full((20, 40, 3), 7, np.uint8)
    assert text.get_text_size("", SIMPLEX, 0.5, 1) == cv2.getTextSize("", SIMPLEX, 0.5, 1) == ((0, 0), 0)
    np.testing.assert_array_equal(_port(img, "", (1, 10), SIMPLEX, 0.5, (1, 2, 3), 1), img)
    assert text.get_text_size("   ", PLAIN, 0.6, 2) == cv2.getTextSize("   ", PLAIN, 0.6, 2)
