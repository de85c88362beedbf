"""Sample index and sample decoding (counterpart of the storage half of
``dspnet_tpu/data/iterator.py``).

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

The JAX package's ``MultiTaskIterator`` augments on the host with
``cv2.warpAffine`` and is not ported; the port's loader is
``data/device_pipeline.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from dspnet_torch.data import image_io

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
