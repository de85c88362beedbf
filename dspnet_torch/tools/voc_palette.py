"""VOC segmentation palette utilities (counterpart of
``dspnet_tpu/tools/voc_palette.py``).

The reference ships ``data/VOC2007/palette2grayscale.py`` to turn VOC's
palette-indexed ``SegmentationClass`` PNGs into gray class-id images with the
standard VOC colormap (reference data/VOC2007/palette2grayscale.py:15-17).
This is that tool: the bit-reversal colormap, colour -> index and index ->
colour, and a CLI, reading and writing through ``data/image_io.py`` (palette
PNGs decode there as cv2 decodes them).

    python -m dspnet_torch.tools.voc_palette 000001.png 000001_index.png
    python -m dspnet_torch.tools.voc_palette --colorize 000001_index.png out.png
"""

from __future__ import annotations

import argparse

import numpy as np

from dspnet_torch.data import image_io


def voc_palette(n: int = 256) -> np.ndarray:
    """The standard VOC colormap: (n, 3) uint8 RGB rows, each class id's bits
    spread over R, G and B from the most significant bit down (the
    ``getpalette`` the reference tool imports,
    data/VOC2007/palette2grayscale.py:11,15)."""
    ids = np.arange(n)
    out = np.zeros((n, 3), np.int64)
    for j in range(8):
        for ch in range(3):
            out[:, ch] |= ((ids >> (3 * j + ch)) & 1) << (7 - j)
    return out.astype(np.uint8)


def _key(rgb: np.ndarray) -> np.ndarray:
    rgb = rgb.astype(np.int32)
    return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]


def palette_to_index(rgb: np.ndarray, n: int = 256) -> np.ndarray:
    """(H, W, 3) RGB colormap image -> (H, W) uint8 class indices; a colour
    outside the map (VOC's 224,224,192 'void' boundary) -> 255."""
    pal_key = _key(voc_palette(n))
    sort = np.argsort(pal_key)
    key = _key(rgb.reshape(-1, 3))
    pos = np.clip(np.searchsorted(pal_key[sort], key), 0, n - 1)
    idx = np.where(pal_key[sort][pos] == key, sort[pos], 255).astype(np.uint8)
    return idx.reshape(rgb.shape[:2])


def index_to_palette(idx: np.ndarray, n: int = 256) -> np.ndarray:
    """(H, W) class indices -> (H, W, 3) RGB colormap image."""
    return voc_palette(n)[idx]


def main(argv=None):
    p = argparse.ArgumentParser(description="VOC palette <-> class-index PNGs.")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--colorize", action="store_true", help="index -> colour (default: colour -> index)")
    args = p.parse_args(argv)
    if args.colorize:
        idx = image_io.imread(args.src, image_io.IMREAD_GRAYSCALE)
        image_io.imwrite(args.dst, index_to_palette(idx)[:, :, ::-1])  # RGB -> BGR, as cv2 writes
    else:
        bgr = image_io.imread(args.src, image_io.IMREAD_COLOR)
        image_io.imwrite(args.dst, palette_to_index(bgr[:, :, ::-1]))


if __name__ == "__main__":
    main()
