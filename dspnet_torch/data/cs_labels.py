"""Cityscapes label table (counterpart of ``dspnet_tpu/data/cs_labels.py``).

A numpy copy of the JAX package's module, which the port cannot import
(importing ``dspnet_tpu`` imports jax): the standard Cityscapes ``labels.py``
table published with the dataset, with the trainId maps, the det and seg
class lists, the trainId -> labelId LUT and the reference's seg-label LUT.
``tests/test_torch_data.py`` pins it against the JAX module bit for bit.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

Label = namedtuple("Label", ["name", "id", "trainId", "category", "catId", "hasInstances", "ignoreInEval", "color"])

labels = [
    #      name                     id  trainId  category         catId hasInst ignore  color
    Label("unlabeled",               0, 255, "void",         0, False, True,  (0, 0, 0)),
    Label("ego vehicle",             1, 255, "void",         0, False, True,  (0, 0, 0)),
    Label("rectification border",    2, 255, "void",         0, False, True,  (0, 0, 0)),
    Label("out of roi",              3, 255, "void",         0, False, True,  (0, 0, 0)),
    Label("static",                  4, 255, "void",         0, False, True,  (0, 0, 0)),
    Label("dynamic",                 5, 255, "void",         0, False, True,  (111, 74, 0)),
    Label("ground",                  6, 255, "void",         0, False, True,  (81, 0, 81)),
    Label("road",                    7,   0, "flat",         1, False, False, (128, 64, 128)),
    Label("sidewalk",                8,   1, "flat",         1, False, False, (244, 35, 232)),
    Label("parking",                 9, 255, "flat",         1, False, True,  (250, 170, 160)),
    Label("rail track",             10, 255, "flat",         1, False, True,  (230, 150, 140)),
    Label("building",               11,   2, "construction", 2, False, False, (70, 70, 70)),
    Label("wall",                   12,   3, "construction", 2, False, False, (102, 102, 156)),
    Label("fence",                  13,   4, "construction", 2, False, False, (190, 153, 153)),
    Label("guard rail",             14, 255, "construction", 2, False, True,  (180, 165, 180)),
    Label("bridge",                 15, 255, "construction", 2, False, True,  (150, 100, 100)),
    Label("tunnel",                 16, 255, "construction", 2, False, True,  (150, 120, 90)),
    Label("pole",                   17,   5, "object",       3, False, False, (153, 153, 153)),
    Label("polegroup",              18, 255, "object",       3, False, True,  (153, 153, 153)),
    Label("traffic light",          19,   6, "object",       3, False, False, (250, 170, 30)),
    Label("traffic sign",           20,   7, "object",       3, False, False, (220, 220, 0)),
    Label("vegetation",             21,   8, "nature",       4, False, False, (107, 142, 35)),
    Label("terrain",                22,   9, "nature",       4, False, False, (152, 251, 152)),
    Label("sky",                    23,  10, "sky",          5, False, False, (70, 130, 180)),
    Label("person",                 24,  11, "human",        6, True,  False, (220, 20, 60)),
    Label("rider",                  25,  12, "human",        6, True,  False, (255, 0, 0)),
    Label("car",                    26,  13, "vehicle",      7, True,  False, (0, 0, 142)),
    Label("truck",                  27,  14, "vehicle",      7, True,  False, (0, 0, 70)),
    Label("bus",                    28,  15, "vehicle",      7, True,  False, (0, 60, 100)),
    Label("caravan",                29, 255, "vehicle",      7, True,  True,  (0, 0, 90)),
    Label("trailer",                30, 255, "vehicle",      7, True,  True,  (0, 0, 110)),
    Label("train",                  31,  16, "vehicle",      7, True,  False, (0, 80, 100)),
    Label("motorcycle",             32,  17, "vehicle",      7, True,  False, (0, 0, 230)),
    Label("bicycle",                33,  18, "vehicle",      7, True,  False, (119, 11, 32)),
    Label("license plate",          -1,  -1, "vehicle",      7, False, True,  (0, 0, 142)),
]

name2label = {l.name: l for l in labels}
id2label = {l.id: l for l in labels}
trainId2label = {l.trainId: l for l in reversed(labels)}

# 8 traffic classes of the detection task (reference dataset/names/cityscapes.txt)
DET_CLASSES = ("person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle")
# 19 evaluated segmentation classes, by trainId order
SEG_CLASSES = tuple(
    l.name for l in sorted((l for l in labels if 0 <= l.trainId < 255), key=lambda l: l.trainId)
)

# trainId -> official labelId LUT used when writing result PNGs for the
# official Cityscapes evaluator (reference multi_eval.py:356-362)
TRAINID_TO_LABELID = np.asarray(
    [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33], np.uint8
)


def train_id_palette() -> np.ndarray:
    """(256, 3) RGB palette keyed by trainId (reference palette.py:39-55)."""
    pal = np.zeros((256, 3), np.uint8)
    for l in labels:
        if 0 <= l.trainId < 255:
            pal[l.trainId] = l.color
    return pal


def seg_label_lut() -> np.ndarray:
    """The reference's seg-label LUT (dataset/iterator.py:357-363).

    Built over label ``id`` but applied to trainId images; because
    ``trainId >= 0`` is also true for 255, it is an identity map on 0..33
    with everything else -> 255 — i.e. a documented near-no-op. We keep it
    for byte parity with the reference batches.
    """
    lut = np.full(256, 255, np.float64)
    for l in labels:
        if l.trainId >= 0:
            lut[l.id] = l.id  # note: l.id == -1 (license plate) wraps to 255
    return lut.astype(np.uint8)
