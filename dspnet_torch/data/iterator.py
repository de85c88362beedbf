"""Sample index, sample decoding and the host batch iterator (counterpart
of ``dspnet_tpu/data/iterator.py``).

A dataset is a plain **sample index**: a list of (image path, label matrix,
seg path) triples, path- or span-backed (:class:`Sample`), built by the
indexers of ``data/imdb.py``, the record stores of ``data/record.py`` or
``data/synthetic.py``. Two ways to read a sample:

* :func:`load_sample_arrays` decodes the image (PNG or JPEG, through
  ``data/image_io.py``'s plain codecs) and the mask on the host: the CPU
  path and host-side tools;
* :func:`load_sample_bytes` returns the image's encoded bytes and the
  decoded mask: the card's loader decodes the JPEG with nvJPEG
  (``data/device_pipeline.py``).

:class:`MultiTaskIterator` is the JAX package's host loader (the JAX CLIs'
``--loader python``): it decodes each sample with the plain codecs, equal to
``cv2.imread``, and augments it in numpy with cv2 5.0.0's pixels
(``data/augment.py::augment_example``, ``data/cv_warp.py``), so its batches
equal the JAX iterator's bit for bit. It is the reference loader, slow at
full size (the plain JPEG decoder and the numpy warp run on one host
thread); the card's loader is ``data/device_pipeline.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dspnet_torch.data import augment as aug
from dspnet_torch.data import image_io
from dspnet_torch.data.cs_labels import seg_label_lut

# GT rows per image, the matcher's GT columns: at most the 256 that
# ops/matching_cuda.py's kernel takes (pinned by a CPU test)
MAX_OBJECTS = 200
LABEL_WIDTH = 6


@dataclasses.dataclass
class Sample:
    image_path: str
    label: np.ndarray  # (MAX_OBJECTS, 6) normalized [cls,x1,y1,x2,y2,dist], -1 padded
    seg_path: Optional[str] = None
    # record-backed storage: encoded bytes at (store_path, offset, length)
    # instead of image_path / seg_path, which then only carry the names
    image_span: Optional[Tuple[str, int, int]] = None
    seg_span: Optional[Tuple[str, int, int]] = None


def read_span(span: Tuple[str, int, int]) -> np.ndarray:
    """Read `length` bytes at `offset` of a record store as a uint8 array."""
    path, offset, length = span
    with open(path, "rb") as f:
        f.seek(offset)
        buf = f.read(length)
    return np.frombuffer(buf, np.uint8)


def shard_positions(num_samples: int, shard: Tuple[int, int]) -> np.ndarray:
    """Epoch positions owned by host ``rank`` of ``world``: the ``rank::world``
    slice of the epoch, truncated to ``num_samples // world`` so every host
    runs the same batch count."""
    rank, world = shard
    if not 0 <= rank < world:
        raise ValueError(f"bad shard {shard}")
    return np.arange(num_samples)[rank::world][: num_samples // world]


def read_encoded(path: str, span: Optional[Tuple[str, int, int]]) -> bytes:
    """The encoded bytes of a file, or of a record span when one is given."""
    if span is not None:
        return read_span(span).tobytes()
    with open(path, "rb") as f:
        return f.read()


def load_sample_bytes(sample: Sample, with_seg: bool = True):
    """A sample's encoded image bytes (from its file or its record span) and
    its decoded seg mask (PNG, decoded here) or None."""
    data = read_encoded(sample.image_path, sample.image_span)
    seg = None
    if with_seg and (sample.seg_span is not None or sample.seg_path is not None):
        seg = image_io.imdecode(read_encoded(sample.seg_path, sample.seg_span), image_io.IMREAD_UNCHANGED)
    return data, seg


def load_sample_arrays(sample: Sample, with_seg: bool = True):
    """Decode a sample's image (BGR uint8) and optional seg mask, path- or
    span-backed. ``with_seg=False`` skips the mask decode."""
    data, seg = load_sample_bytes(sample, with_seg)
    return image_io.imdecode(data, image_io.IMREAD_COLOR), seg


class SampleIndex:
    """An ordered list of samples; the storage-neutral '.lst' equivalent."""

    def __init__(self, samples: Sequence[Sample]):
        self.samples = list(samples)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i) -> Sample:
        return self.samples[i]

    @staticmethod
    def pad_label(rows: np.ndarray) -> np.ndarray:
        out = np.full((MAX_OBJECTS, LABEL_WIDTH), -1.0, np.float32)
        n = min(len(rows), MAX_OBJECTS)
        if n:
            out[:n] = rows[:n]
        return out


class MultiTaskIterator:
    """Batches of numpy ``{'images', 'label_det', 'seg_label'}`` (+ file
    names), decoded and augmented on the host (the JAX package's
    ``MultiTaskIterator``, argument for argument).

    ``data_shape`` (H, W); ``mean_pixels`` RGB; ``enable_aug`` selects the
    augmented or the plain-resize path; the seed (233 in the reference) draws
    the shuffle at construction and the augmentation table, one row per
    sample, at construction and at every :meth:`reset`, in the JAX order.
    ``shard=(rank, world)``: every host draws the same global tables and
    walks its ``rank::world`` positions. ``pad_last``: also yield a final
    partial batch padded with zero images, all -1 labels and all-ignore seg,
    its ``fnames`` listing only the real samples (eval passes True).
    ``apply_seg_lut`` maps mask ids through ``seg_label_lut``. ``s2d`` (the
    TPU's space-to-depth input layout) is refused (ROADMAP item 17).
    """

    def __init__(
        self,
        index: SampleIndex,
        batch_size: int,
        data_shape: Tuple[int, int],
        mean_pixels=aug.MEAN_PIXELS,
        enable_aug: bool = True,
        seed: int = 233,
        apply_seg_lut: bool = True,
        shuffle: bool = True,
        shard: Tuple[int, int] = (0, 1),
        pad_last: bool = False,
        s2d: bool = False,
    ):
        if s2d:
            raise ValueError("s2d (the TPU's space-to-depth input layout) is not ported: ROADMAP item 17")
        self.index = index
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.mean_pixels = mean_pixels
        self.enable_aug = enable_aug
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.lut = seg_label_lut() if apply_seg_lut else None
        self.num_samples = len(index)
        self.shard = tuple(shard)
        self.pad_last = pad_last
        self.positions = shard_positions(self.num_samples, shard)
        self.order = np.arange(self.num_samples)
        if shuffle:
            self.rng.shuffle(self.order)
        self._resample_aug()
        self.cursor = 0

    def _resample_aug(self):
        self.aug_params = aug.sample_aug_params(self.num_samples, self.data_shape, self.rng)

    def reset(self):
        if self.shuffle:
            self.rng.shuffle(self.order)
        self._resample_aug()
        self.cursor = 0

    def __iter__(self) -> Iterator:
        for batch, _ in self.epoch():
            yield batch

    def epoch(self) -> Iterator:
        """(batch, fnames) pairs over one epoch, after a :meth:`reset`."""
        self.reset()
        while self.cursor + self.batch_size <= len(self.positions):
            yield self.next_batch()
        if self.pad_last and self.cursor < len(self.positions):
            yield self.next_batch()

    def next_batch(self):
        """The next batch of the current epoch and its real samples' names."""
        H, W = self.data_shape
        bs = self.batch_size
        images = np.zeros((bs, H, W, 3), np.float32)
        labels = np.full((bs, MAX_OBJECTS, LABEL_WIDTH), -1.0, np.float32)
        # a sample without a mask contributes no seg loss: ignore, not 0 (road)
        segs = np.full((bs, H // 4, W // 4), 255, np.int32)
        has_seg = False
        fnames: List[str] = []
        n_real = min(bs, len(self.positions) - self.cursor)
        for b in range(n_real):
            pos = int(self.positions[self.cursor])
            sample = self.index[int(self.order[pos])]
            img, seg = load_sample_arrays(sample)
            label = sample.label.copy()
            if self.enable_aug:
                img, label, seg = aug.augment_example(img, label, seg, self.aug_params[pos], self.data_shape)
            else:
                img, label, seg = aug.resize_example(img, label, seg, self.data_shape)
            images[b] = aug.normalize_image(torch.from_numpy(img), self.mean_pixels).numpy()
            labels[b] = label
            if seg is not None:
                has_seg = True
                segs[b] = aug.downsample_seg(seg.astype(np.uint8), self.lut)
            fnames.append(sample.image_path)
            self.cursor += 1
        batch = {"images": images, "label_det": labels}
        if has_seg:
            batch["seg_label"] = segs
        return batch, fnames
