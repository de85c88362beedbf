"""The cv2 drawing the demo needs, on numpy, without cv2 (the card's machine
has none): the counterparts of ``cv2.rectangle``, ``cv2.addWeighted``,
``cv2.putText`` as ``dspnet_tpu/detect/detector.py:234-267`` uses them, and
``dspnet_tpu/utils/misc.py::put_text``.

* :func:`rectangle` gives cv2's pixels (8-connected lines) for thickness 1,
  2 and filled (-1): at thickness 2 cv2 draws each edge as a 3-pixel band
  from corner to corner, with round caps that add nothing outside the bands,
  so the outer corner pixel stays unset;
* :func:`add_weighted` is cv2's uint8 rule: the weighted sum as two fused
  multiply-adds in float32, rounded half to even, saturated;
* :func:`seg_overlay` is the demo's overlay: palette lookup, nearest resize
  to the image (``data/image_io.py::resize_nearest``), then
  ``add_weighted`` with 1 - alpha and alpha;
* :func:`put_text` draws a raster font of this module (3x5 glyphs on a
  4-pixel advance, capitals for letters), because cv2's Hershey glyphs are
  not in the repository. Its pixels differ from ``cv2.putText``'s, and only
  there: for the demo's labels it stays inside the box
  ``cv2.getTextSize`` gives at the same anchor (``tests/test_torch_demo.py``
  checks the pixels outside it bit for bit).

Colours are BGR tuples, images (H, W, 3) uint8 BGR, drawn on in place.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from dspnet_torch.data import image_io

_GLYPH_ROWS = {
    "0": "### #.# #.# #.# ###", "1": ".#. ##. .#. .#. ###", "2": "### ..# ### #.. ###",
    "3": "### ..# ### ..# ###", "4": "#.# #.# ### ..# ..#", "5": "### #.. ### ..# ###",
    "6": "### #.. ### #.# ###", "7": "### ..# ..# ..# ..#", "8": "### #.# ### #.# ###",
    "9": "### #.# ### ..# ###",
    "A": ".#. #.# ### #.# #.#", "B": "##. #.# ##. #.# ##.", "C": "### #.. #.. #.. ###",
    "D": "##. #.# #.# #.# ##.", "E": "### #.. ##. #.. ###", "F": "### #.. ##. #.. #..",
    "G": "### #.. #.# #.# ###", "H": "#.# #.# ### #.# #.#", "I": "### .#. .#. .#. ###",
    "J": "..# ..# ..# #.# ###", "K": "#.# #.# ##. #.# #.#", "L": "#.. #.. #.. #.. ###",
    "M": "#.# ### ### #.# #.#", "N": "##. #.# #.# #.# #.#", "O": "### #.# #.# #.# ###",
    "P": "### #.# ### #.. #..", "Q": "### #.# #.# ### ..#", "R": "##. #.# ##. #.# #.#",
    "S": "### #.. ### ..# ###", "T": "### .#. .#. .#. .#.", "U": "#.# #.# #.# #.# ###",
    "V": "#.# #.# #.# #.# .#.", "W": "#.# #.# ### ### #.#", "X": "#.# #.# .#. #.# #.#",
    "Y": "#.# #.# .#. .#. .#.", "Z": "### ..# .#. #.. ###",
    " ": "... ... ... ... ...", "-": "... ... ### ... ...", ".": "... ... ... ... .#.",
    ":": "... .#. ... .#. ...", "_": "... ... ... ... ###", "/": "..# ..# .#. #.. #..",
    "%": "#.# ..# .#. #.. #.#", "(": ".#. #.. #.. #.. .#.", ")": ".#. ..# ..# ..# .#.",
    "?": "### ..# .#. ... .#.", "!": ".#. .#. .#. ... .#.", ",": "... ... ... .#. #..",
    "+": "... .#. ### .#. ...", "=": "... ### ... ### ...", "'": ".#. .#. ... ... ...",
}
#: char -> (5, 3) bool glyph; a character without one draws as a block
GLYPHS = {c: np.array([[p == "#" for p in row] for row in rows.split()]) for c, rows in _GLYPH_ROWS.items()}
_BLOCK = np.ones((5, 3), bool)
ADVANCE, GLYPH_H, GLYPH_W = 4, 5, 3


def text_size(text: str) -> Tuple[int, int]:
    """(width, height) in pixels of ``text`` in this module's font."""
    return ADVANCE * len(text), GLYPH_H


def _paint(img: np.ndarray, mask: np.ndarray, x0: int, y0: int, color):
    """Set the pixels of ``mask`` (h, w) placed at (x0, y0), clipped."""
    H, W = img.shape[:2]
    h, w = mask.shape
    ys, xs = max(0, -y0), max(0, -x0)
    ye, xe = min(h, H - y0), min(w, W - x0)
    if ys >= ye or xs >= xe:
        return
    region = img[y0 + ys:y0 + ye, x0 + xs:x0 + xe]
    region[mask[ys:ye, xs:xe]] = color


def put_text(img: np.ndarray, text: str, org, color) -> np.ndarray:
    """Draw ``text`` with its baseline's left end at ``org`` = (x, y), as
    ``cv2.putText``'s anchor: glyph rows y - 5 .. y - 1."""
    x, y = int(org[0]), int(org[1])
    for i, ch in enumerate(text):
        glyph = GLYPHS.get(ch.upper(), _BLOCK)
        _paint(img, glyph, x + ADVANCE * i, y - GLYPH_H, color)
    return img


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle`` with corners ``pt1``, ``pt2`` (inclusive, in any
    order, clipped to the image); ``thickness`` 1, 2 or -1 (filled)."""
    x1, x2 = sorted((int(pt1[0]), int(pt2[0])))
    y1, y2 = sorted((int(pt1[1]), int(pt2[1])))
    H, W = img.shape[:2]

    def fill(xa, ya, xb, yb):  # inclusive, clipped
        xa, ya, xb, yb = max(xa, 0), max(ya, 0), min(xb, W - 1), min(yb, H - 1)
        if xa <= xb and ya <= yb:
            img[ya:yb + 1, xa:xb + 1] = color

    if thickness < 0:
        fill(x1, y1, x2, y2)
    elif thickness == 1:
        fill(x1, y1, x2, y1)
        fill(x1, y2, x2, y2)
        fill(x1, y1, x1, y2)
        fill(x2, y1, x2, y2)
    elif thickness == 2:
        fill(x1, y1 - 1, x2, y1 + 1)
        fill(x1, y2 - 1, x2, y2 + 1)
        fill(x1 - 1, y1, x1 + 1, y2)
        fill(x2 - 1, y1, x2 + 1, y2)
    else:
        raise ValueError(f"thickness must be 1, 2 or -1, got {thickness}")
    return img


def add_weighted(a: np.ndarray, alpha: float, b: np.ndarray, beta: float, gamma: float = 0.0) -> np.ndarray:
    """``cv2.addWeighted`` on uint8: cv2's two fused multiply-adds in
    float32, fma(a, alpha, fma(b, beta, gamma)) (each exact in float64, then
    rounded once to float32), rounded half to even, saturated to 0..255."""
    f32, f64 = np.float32, np.float64
    t = (b.astype(f64) * f64(f32(beta)) + f64(f32(gamma))).astype(f32)
    s = (a.astype(f64) * f64(f32(alpha)) + t.astype(f64)).astype(f32)
    return np.clip(np.rint(s), 0, 255).astype(np.uint8)


def seg_overlay(img: np.ndarray, seg: np.ndarray, palette: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """The demo's seg overlay: trainIds through ``palette`` (RGB rows), as
    BGR, nearest-resized to the image, blended with weights 1 - alpha and
    alpha."""
    seg_bgr = palette[np.clip(seg, 0, 255)][:, :, ::-1]
    seg_bgr = image_io.resize_nearest(seg_bgr, img.shape[:2])
    return add_weighted(img, 1.0 - alpha, seg_bgr, alpha, 0)


def label_box(img: np.ndarray, text: str, bbox, box_color=(0, 255, 0)) -> np.ndarray:
    """A labelled box with a filled banner behind its text
    (``dspnet_tpu/utils/misc.py::put_text``, reference utils.py:25-33): the
    box at thickness 1, the banner in (128, 0, 0) as wide and high as the
    text in this module's font, the text in white."""
    x1, y1 = int(bbox[0]), int(bbox[1])
    rectangle(img, (x1, y1), (int(bbox[2]), int(bbox[3])), box_color, 1)
    tw, th = text_size(text)
    rectangle(img, (x1, y1 - th), (x1 + tw, y1), (128, 0, 0), -1)
    return put_text(img, text, (x1, y1), (255, 255, 255))
