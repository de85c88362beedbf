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
  ``add_weighted`` with 1 - alpha and alpha; :func:`seg_overlay_tensor` and
  :func:`add_weighted_tensor` are the same rules as torch ops on the
  tensors' device (the video demo overlays on the card), bit for bit;
* :func:`put_text` is ``cv2.putText`` for the faces the demo uses
  (:mod:`dspnet_torch.utils.text`: cv2 5.0.0's Rubik font, its layout,
  rasteriser and blend, bit for bit), and :func:`label_box` sizes its
  banner with the same module's ``getTextSize``.

Colours are BGR tuples, images (H, W, 3) uint8 BGR, drawn on in place.
"""

from __future__ import annotations

import numpy as np
import torch

from dspnet_torch.data import device_pipeline, image_io
from dspnet_torch.utils import text

put_text = text.put_text


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


def add_weighted_tensor(a: torch.Tensor, alpha: float, b: torch.Tensor, beta: float,
                        gamma: float = 0.0) -> torch.Tensor:
    """:func:`add_weighted` on uint8 tensors, on their device: each product
    of a uint8 value and a float32 weight is exact in float64, so the two
    float64 sums, each rounded to float32, are cv2's fused multiply-adds."""
    f32 = np.float32
    t = (b.double() * float(f32(beta)) + float(f32(gamma))).float()
    s = (a.double() * float(f32(alpha)) + t.double()).float()
    return torch.round(s).clamp(0, 255).to(torch.uint8)  # half to even, as np.rint


def seg_overlay_tensor(img: torch.Tensor, seg: torch.Tensor, palette, alpha: float = 0.5) -> torch.Tensor:
    """:func:`seg_overlay` as torch ops on ``img``'s device: (H, W, 3) uint8
    BGR and an (h, w) trainId map -> the blended (H, W, 3) uint8, bit for bit
    equal to the numpy overlay (the palette gather, ``resize_nearest``,
    :func:`add_weighted_tensor`)."""
    pal = torch.as_tensor(np.asarray(palette)).to(img.device)
    seg_bgr = pal[seg.to(img.device).long().clamp(0, 255)].flip(-1)
    seg_bgr = device_pipeline.resize_nearest(seg_bgr, img.shape[:2])
    return add_weighted_tensor(img, 1.0 - alpha, seg_bgr, alpha, 0)


def label_box(img: np.ndarray, label: str, bbox, box_color=(0, 255, 0)) -> np.ndarray:
    """A labelled box with a filled banner behind its text
    (``dspnet_tpu/utils/misc.py::put_text``, reference utils.py:25-33): the
    box at thickness 1, the banner in (128, 0, 0) as wide and high as
    ``getTextSize`` of the text in ``FONT_HERSHEY_PLAIN`` 0.6, the text in
    white."""
    x1, y1 = int(bbox[0]), int(bbox[1])
    rectangle(img, (x1, y1), (int(bbox[2]), int(bbox[3])), box_color, 1)
    (tw, th), _ = text.get_text_size(label, text.FONT_HERSHEY_PLAIN, 0.6, 1)
    rectangle(img, (x1, y1 - th), (x1 + tw, y1), (128, 0, 0), -1)
    return text.put_text(img, label, (x1, y1), text.FONT_HERSHEY_PLAIN, 0.6, (255, 255, 255), 1)
