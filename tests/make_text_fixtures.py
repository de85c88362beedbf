"""Write the font the port draws its labels with, and the committed text
forms that hold ``dspnet_torch/utils/text.py`` to cv2 on a machine that has
no cv2.

    python tests/make_text_fixtures.py            # the font and the forms
    python tests/make_text_fixtures.py --checks   # the slow checks (minutes)

Needs cv2 5.0.0 and fontTools. cv2 5 draws ``cv2.putText`` with a TrueType
font it carries inside ``cv2.abi3.so`` as gzip members: "Rubik for OpenCV
Light" (a variable font, ``wght`` 300-900), its italic, and WenQuanYi Micro
Hei for the characters Rubik lacks. The script finds the members by their
gzip magic and reads each one's name table, writes the upright Rubik byte
for byte to ``dspnet_torch/utils/fonts/rubik_opencv.ttf`` and the name
table's copyright, licence and licence URL (name ids 0, 13, 14) beside it
as ``OFL.txt``. It then draws :func:`form_cases` with cv2 (random
backgrounds and colours from each form's seed, near edges and clipped) and
records in ``tests/fixtures/text_forms/forms.json`` each form's string,
face, scale, thickness, colour, origin, image shape and seed, with the
sha256 of cv2's image and ``cv2.getTextSize``'s result.
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FONT_DIR = ROOT / "dspnet_torch" / "utils" / "fonts"
FORMS = ROOT / "tests" / "fixtures" / "text_forms"
FONT_NAME = "Rubik for OpenCV Light"


def cv2_fonts() -> dict:
    """The TrueType files inside cv2's library, by their full name (name id 4)."""
    import cv2
    from fontTools.ttLib import TTFont

    blob = (Path(cv2.__file__).parent / "cv2.abi3.so").read_bytes()
    fonts, pos = {}, 0
    while (i := blob.find(b"\x1f\x8b\x08", pos)) >= 0:
        pos = i + 3
        try:
            data = zlib.decompressobj(16 + zlib.MAX_WBITS).decompress(blob[i:])
        except zlib.error:
            continue
        if data[:4] in (b"\x00\x01\x00\x00", b"true"):
            fonts[TTFont(io.BytesIO(data))["name"].getDebugName(4)] = data
    return fonts


def write_font() -> Path:
    """Write the upright Rubik and its licence text; returns the font's path."""
    from fontTools.ttLib import TTFont

    data = cv2_fonts()[FONT_NAME]
    FONT_DIR.mkdir(parents=True, exist_ok=True)
    path = FONT_DIR / "rubik_opencv.ttf"
    path.write_bytes(data)
    name = TTFont(io.BytesIO(data))["name"]
    text = "\n\n".join(name.getDebugName(i) for i in (0, 13, 14))
    (FONT_DIR / "OFL.txt").write_text(
        f"{FONT_NAME} ({path.name}), as cv2 5.0.0 carries it.\n"
        f"sha256 {hashlib.sha256(data).hexdigest()}\n\n{text}\n")
    return path


def label_names() -> list:
    """Every class name the port's demo can label a box with, and the bare
    class ids it falls back to."""
    sys.path.insert(0, str(ROOT))
    from dspnet_torch.data.cs_labels import DET_CLASSES
    from dspnet_torch.data.imdb import CITYSCAPES_DET_CLASSES, VOC_CLASSES

    names = list(dict.fromkeys(DET_CLASSES + tuple(VOC_CLASSES) + tuple(CITYSCAPES_DET_CLASSES)))
    return names + [str(i) for i in range(21)]


def form_cases() -> list:
    """About 300 forms: demo labels at SIMPLEX 0.5 and under ``label_box``'s
    PLAIN 0.6, random printable ASCII at both faces, scales 0.3-3.0 and
    thickness 1-3, on random backgrounds and colours, placed in the image,
    near its edges and clipped by them."""
    rng = np.random.default_rng(18)
    names = label_names()
    ascii_chars = [chr(c) for c in range(0x20, 0x7F)]
    cases = []
    for k in range(300):
        if k < 120:
            face, scale, thickness = (0, 0.5, 1) if k % 2 == 0 else (1, 0.6, 1)
            dist = "-0m" if k % 37 == 0 else f"{int(rng.integers(0, 256))}m"
            text = f"{names[k % len(names)]} {dist}"
        else:
            face = int(rng.integers(0, 2))
            scale = round(float(rng.uniform(0.3, 3.0)), 3)
            thickness = int(rng.integers(1, 4))
            text = "".join(rng.choice(ascii_chars, int(rng.integers(1, 16))))
        h, w = int(rng.integers(40, 160)), int(rng.integers(60, 400))
        place = k % 4
        if place == 0:  # inside
            org = [int(rng.integers(0, max(w // 3, 1))), int(rng.integers(h // 2, h))]
        elif place == 1:  # clipped on the left or top
            org = [int(rng.integers(-40, 1)), int(rng.integers(0, 20))]
        elif place == 2:  # clipped on the right or bottom
            org = [int(rng.integers(w - 60, w)), int(rng.integers(h - 5, h + 15))]
        else:  # wholly or almost wholly outside
            org = [int(rng.integers(-300, w + 10)), int(rng.integers(-20, h + 60))]
        color = [int(v) for v in rng.choice([0, 1, 2, 127, 128, 253, 254, 255, *rng.integers(0, 256, 3)], 3)]
        channels = 1 if k % 10 == 9 else 3
        cases.append({"text": text, "face": face, "scale": scale, "thickness": thickness, "color": color,
                      "org": org, "shape": [h, w] + ([channels] if channels == 3 else []),
                      "seed": int(rng.integers(0, 2 ** 31))})
    return cases


def background(case: dict) -> np.ndarray:
    """A form's image before drawing: uniform random bytes from its seed
    (numpy's legacy ``RandomState``, whose stream every numpy version keeps)."""
    return np.random.RandomState(case["seed"]).randint(0, 256, case["shape"]).astype(np.uint8)


def write_forms() -> Path:
    import cv2

    forms = []
    for case in form_cases():
        img = background(case)
        cv2.putText(img, case["text"], tuple(case["org"]), case["face"], case["scale"], tuple(case["color"]),
                    case["thickness"])
        (w, h), baseline = cv2.getTextSize(case["text"], case["face"], case["scale"], case["thickness"])
        forms.append(dict(case, sha256=hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
                          text_size=[[w, h], baseline]))
    FORMS.mkdir(parents=True, exist_ok=True)
    path = FORMS / "forms.json"
    path.write_text(json.dumps({"cv2": cv2.__version__, "forms": forms}, indent=0) + "\n")
    return path


def checks() -> None:
    """The slow checks behind ``utils/text.py``'s notes, against cv2 5.0.0's
    ``FontFace`` API: every printable ASCII glyph at sizes 4-100 and
    weights 400, 600 and 800; the blend rule on 128 random backgrounds and
    colours under a 400-pixel string (every coverage level); and the count
    of characters refused for IUP."""
    import cv2

    sys.path.insert(0, str(ROOT))
    from dspnet_torch.utils import text

    face = cv2.FontFace("sans")
    bad = []
    for weight in (400, 600, 800):
        for size in range(4, 101):
            for code in range(0x21, 0x7F):
                img = np.zeros((3 * size + 10, 3 * size + 10, 3), np.uint8)
                want = img.copy()
                cv2.putText(want, chr(code), (size, 2 * size), (255, 255, 255), face, size, weight)
                for cov, x, y in text._layout(chr(code), size, weight).layers:
                    img[2 * size + y:2 * size + y + cov.shape[0], size + x:size + x + cov.shape[1]] = cov[..., None]
                if not np.array_equal(img, want):
                    bad.append((weight, size, chr(code)))
            text.clear_caches()
    print(f"glyphs: {94 * 97 * 3} (94 glyphs x sizes 4-100 x 3 weights), unequal to cv2: {bad}")
    canvas = np.zeros((700, 1400, 3), np.uint8)
    cv2.putText(canvas, "@%&SWM", (20, 560), (255, 255, 255), face, 400, 400)
    a = canvas[..., 0].astype(np.int64)[..., None]
    rng = np.random.default_rng(0)
    triples = unequal = 0
    for _ in range(128):
        colour = tuple(int(v) for v in rng.integers(0, 256, 3))
        bg = rng.integers(0, 256, canvas.shape).astype(np.uint8)
        out = bg.copy()
        cv2.putText(out, "@%&SWM", (20, 560), colour, face, 400, 400)
        rule = (bg.astype(np.int64) * (255 - a) + np.array(colour) * a + 127) // 255
        unequal += int((rule != out).sum())
        triples += int((a[..., 0] > 0).sum()) * 3
    print(f"blend: {triples} (background, colour, coverage) triples, unequal to the rule: {unequal}")
    f = text.font()
    composites = [g for g in set(f.cmap.values()) if f.raw_glyph(g).components]
    refused = [c for c, g in f.cmap.items() if c > 0x7E and f.uses_iup(g)]
    print(f"IUP refusals: {len(refused)} characters ({sum(f.raw_glyph(f.cmap[c]).components != [] for c in refused)} "
          f"composite of {len(composites)} composite glyphs)")


def main() -> None:
    if "--checks" in sys.argv[1:]:
        return checks()
    path = write_font()
    print(path, path.stat().st_size, hashlib.sha256(path.read_bytes()).hexdigest())
    forms = write_forms()
    print(forms, len(json.loads(forms.read_text())["forms"]), "forms")


if __name__ == "__main__":
    sys.exit(main())
