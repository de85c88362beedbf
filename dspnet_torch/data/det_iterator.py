"""Detection-only iterator with SSD-style random crop/pad augmentation
(counterpart of ``dspnet_tpu/data/det_iterator.py``; reference
dataset/iterator.py:113-297 DetIter).

Per image, one candidate pooled from the IoU-constrained ``RandCropper``
samples and the ``RandPadder`` canvas (``data/rand_sampler.py``) is applied,
then an optional horizontal mirror, a resize with an interpolation drawn
from cv2's five, the colour jitter of the ``cfg.train`` preset and the mean
subtraction. Labels are (B, max_objects, 6) rows [cls, x1, y1, x2, y2,
col5], col5 0 (or the sample's column 5 with ``label_col5="passthrough"``,
the VOC difficult flag at eval). The final partial batch wraps to the
start of the epoch.

The work is split as the device loader splits it:

* **the host** shuffles and draws every random number of a batch in the
  JAX package's order, image by image (samplers, pad gate, candidate pick,
  mirror, interpolation, jitter): nothing drawn depends on the pixels, only
  on the labels and the image's size, which comes from the JPEG header. So
  the labels, the crop and pad boxes (``int()``-truncated pixels, as the
  reference) and every draw are fixed before a pixel is decoded, and equal
  the JAX iterator's bit for bit;
* **the device** decodes the batch (nvJPEG on ``cuda``, the plain decoder
  on ``cpu``) and does, per image, the crop or the 128-filled pad canvas,
  the mirror and the resize (``device_pipeline.resize``, cv2's rules), then
  over the batch the jitter (``augment.apply_color_jitter``) and the mean
  subtraction. In :meth:`DetIterator.epoch` this runs ahead on
  ``prefetch_to_device``'s thread and side stream.

The eval path (``is_train=False``) resizes the full image with
``INTER_LINEAR`` and leaves the labels as they are.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from dspnet_torch.data import augment as aug
from dspnet_torch.data import heif, image_io, jpeg, jpeg2000
from dspnet_torch.data.device_pipeline import (
    INTER_AREA,
    INTER_CUBIC,
    INTER_LANCZOS4,
    INTER_LINEAR,
    INTER_NEAREST,
    place_images,
    resize,
)
from dspnet_torch.data.iterator import SampleIndex, load_sample_bytes
from dspnet_torch.data.prefetch import prefetch_to_device
from dspnet_torch.utils.config import cfg as default_cfg

#: the reference's random interpolation set, in its order (inter_method 10)
INTERP_METHODS = [INTER_LINEAR, INTER_CUBIC, INTER_AREA, INTER_NEAREST, INTER_LANCZOS4]


@dataclasses.dataclass
class ImagePlan:
    """What the device does to one image: ``box`` (x1, y1, x2, y2) pixels or
    None for the whole image, ``pad`` (a canvas filled 128 with the image at
    (-x1, -y1)) or a crop, the mirror, cv2's interpolation code and the
    jitter draws (``augment.draw_color_jitter``, None without jitter)."""

    box: Optional[Tuple[int, int, int, int]] = None
    pad: bool = False
    mirror: bool = False
    interp: int = INTER_LINEAR
    jitter: Optional[tuple] = None


def image_size(data) -> Tuple[int, int]:
    """(height, width) of an encoded JPEG as decoded (Exif orientation
    applied), or of a decoded array."""
    if isinstance(data, np.ndarray):
        return data.shape[:2]
    info = jpeg.read_info(data)
    return (info.width, info.height) if info.orientation in (5, 6, 7, 8) else (info.height, info.width)


def apply_plan(img: torch.Tensor, plan: ImagePlan, data_shape: Tuple[int, int]) -> torch.Tensor:
    """(h, w, 3) uint8 BGR -> (H, W, 3) uint8: crop or pad, mirror, resize,
    on the image's device (the JAX iterator's numpy slicing, ``cv2.flip``
    and ``cv2.resize``)."""
    if plan.box is not None:
        x1, y1, x2, y2 = plan.box
        if plan.pad:
            h, w = img.shape[:2]
            canvas = torch.full((y2 - y1, x2 - x1, 3), 128, dtype=img.dtype, device=img.device)
            canvas[-y1:-y1 + h, -x1:-x1 + w] = img
            img = canvas
        else:
            img = img[y1:y2, x1:x2]
    if plan.mirror:
        img = img.flip(1)
    return resize(img, data_shape, plan.interp)


class PlannedImages:
    """A batch's images as the host left them (JPEG bytes, or uint8 arrays
    it decoded) with their plans; ``place_on(device)`` decodes, augments and
    normalizes them there: (B, H, W, 3) float32 RGB minus the mean."""

    def __init__(self, items, plans: List[ImagePlan], data_shape, mean_pixels):
        self.items = list(items)
        self.plans = plans
        self.data_shape = tuple(data_shape)
        self.mean_pixels = mean_pixels

    def place_on(self, device) -> torch.Tensor:
        imgs = place_images(self.items, device)
        batch = torch.stack([apply_plan(t, p, self.data_shape) for t, p in zip(imgs, self.plans)])
        draws = [p.jitter or (None,) * 4 for p in self.plans]
        batch = aug.apply_color_jitter(batch, draws)
        return aug.normalize_image(batch, self.mean_pixels)


class DetIterator:
    """Batches ``{'images': (B, H, W, 3) f32, 'label_det': (B, max_objects,
    6) f32}`` on ``device``, with the JAX ``DetIterator``'s constructor,
    draws and ``epoch()`` / ``next_batch()`` contract. ``device`` is the
    card unless the caller asks for ``"cpu"``."""

    def __init__(
        self,
        index: SampleIndex,
        batch_size: int,
        data_shape: Tuple[int, int],
        mean_pixels=aug.MEAN_PIXELS,
        max_objects: int = 100,
        is_train: bool = True,
        train_cfg=None,
        seed: int = 233,
        label_col5: str = "zero",
        *,
        device="cuda",
    ):
        """``label_col5``: 'zero' writes 0.0 into label column 5 (the dist
        slot, plain-SSD training); 'passthrough' carries the sample's column
        5 (the VOC eval path's difficult flag, ``PascalVoc(
        difficult_in_label=True)``)."""
        if label_col5 not in ("zero", "passthrough"):
            raise ValueError(f"label_col5 must be 'zero' or 'passthrough', got {label_col5!r}")
        self.index = index
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.device = torch.device(device)
        # made on the device once: a per-batch copy from the host would wait
        # for the stream
        self.mean_pixels = torch.tensor(mean_pixels, dtype=torch.float32, device=self.device)
        self.max_objects = max_objects
        self.is_train = is_train
        self.label_col5 = label_col5
        self.cfg = train_cfg if train_cfg is not None else (
            default_cfg.train if is_train else default_cfg.valid)
        self.rng = np.random.RandomState(seed)
        self.order = np.arange(len(index))
        if is_train and self.cfg.get("shuffle", False):
            self.rng.shuffle(self.order)
        self.cursor = 0

    def reset(self):
        if self.is_train and self.cfg.get("shuffle", False):
            self.rng.shuffle(self.order)
        self.cursor = 0

    # ------------------------------------------------------------ host side

    def _augment(self, hw: Tuple[int, int], label: np.ndarray):
        """The JAX ``_augment`` (iterator.py:249-297) without the pixels:
        candidates pooled from every sampler (the padder's behind its
        ``rand_pad_prob`` gate), one picked uniformly; its box in pixels
        (``int()`` truncation) is a crop when it lies inside the image, else
        a pad canvas; then the mirror draw. Returns (plan, label)."""
        rng = self.rng
        plan = ImagePlan()
        candidates = []
        for rs in self.cfg.get("rand_crop_samplers", []):
            candidates += rs.sample(label, rng)
        padder = self.cfg.get("rand_pad", None)
        if padder is not None and rng.rand() < self.cfg.get("rand_pad_prob", 0.0):
            candidates += padder.sample(label, rng)
        if candidates:
            box, label = candidates[int(rng.uniform(0, 1) * len(candidates))]
            h, w = hw
            x1, y1 = int(box[0] * w), int(box[1] * h)
            x2, y2 = int(box[2] * w), int(box[3] * h)
            plan.box = (x1, y1, x2, y2)
            plan.pad = not (x1 >= 0 and y1 >= 0 and x2 <= w and y2 <= h)
        if rng.rand() < self.cfg.get("rand_mirror_prob", 0.0):
            plan.mirror = True
            valid = label[:, 0] >= 0
            x1 = label[valid, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x1
        return plan, label

    def _read(self, sample):
        """The image as JPEG bytes (decoded on the device), as JPEG 2000 or
        AVIF bytes on a CUDA device (decoded there by
        ``data/jpeg2000_cuda.py`` / ``data/av1_cuda.py``) or, in another
        format, decoded here."""
        data, _ = load_sample_bytes(sample, with_seg=False)
        if data[:3] == image_io.JPEG_MAGIC:
            return data
        if self.device.type == "cuda" and (jpeg2000.is_jpeg2000(data) or heif.is_avif(data)):
            return data
        return image_io.imdecode(data, image_io.IMREAD_COLOR)

    def plan_batch(self):
        """The next batch's host half: ``{'images': PlannedImages,
        'label_det': (B, max_objects, 6) f32 numpy}``, every draw made and
        the cursor advanced."""
        B = self.batch_size
        labels = np.full((B, self.max_objects, 6), -1.0, np.float32)
        items, plans = [], []
        for b in range(B):
            # the final partial batch wraps to the epoch start
            s = self.index[int(self.order[self.cursor % len(self.index)])]
            data = self._read(s)
            label = s.label[:, :6].copy()
            plan = ImagePlan()
            if self.is_train:
                plan, label = self._augment(image_size(data), label)
                if self.cfg.get("inter_method", 1) == 10:
                    plan.interp = INTERP_METHODS[self.rng.randint(len(INTERP_METHODS))]
                jitter = self.cfg.get("color_jitter", None)
                if jitter:
                    plan.jitter = aug.draw_color_jitter(jitter, self.rng)
            items.append(data)
            plans.append(plan)
            valid = label[label[:, 0] >= 0][: self.max_objects]
            labels[b, : valid.shape[0], :5] = valid[:, :5]
            labels[b, : valid.shape[0], 5] = valid[:, 5] if self.label_col5 == "passthrough" else 0.0
            self.cursor += 1
        return {"images": PlannedImages(items, plans, self.data_shape, self.mean_pixels), "label_det": labels}

    # ---------------------------------------------------------- device side

    def next_batch(self) -> dict:
        """The next batch on the device, made now (no read-ahead)."""
        planned = self.plan_batch()
        labels = torch.from_numpy(planned["label_det"])
        return {"images": planned["images"].place_on(self.device), "label_det": labels.to(self.device)}

    def _planned(self) -> Iterator:
        n = len(self.index)
        while self.cursor < n:
            start = self.cursor
            fnames = [self.index[int(self.order[i])].image_path
                      for i in range(start, min(start + self.batch_size, n))]
            yield self.plan_batch(), fnames

    def epoch(self) -> Iterator:
        """(batch, fnames) pairs over one epoch, the JAX ``epoch()``
        contract: ``fnames`` lists only the real samples of the wrapped
        tail. Decode and augmentation run ahead on ``prefetch_to_device``'s
        thread (its side stream on CUDA)."""
        self.reset()
        with contextlib.closing(prefetch_to_device(self._planned(), size=3, device=self.device)) as it:
            yield from it

    def __iter__(self):
        for batch, _ in self.epoch():
            yield batch
