"""Packed record stores (counterpart of ``dspnet_tpu/data/record.py``, whose
format this is, byte for byte).

A ``.drec`` store keeps each sample's original encoded bytes (JPEG image,
PNG seg mask: no recompression, so decoded pixels equal the file-backed
path's) with its label rows and its original path; the ``.idx`` sidecar is
a text file of ``<i> <offset>`` lines, MXNet's ``.idx`` contract. Stores
packed by either package read the same in both
(``tests/test_torch_imdb.py``).

Layout (all integers little-endian)::

    header  := b"DREC0001" u64:num_records
    record  := u32:name_len u32:label_rows u64:img_len u64:seg_len
               name[name_len] label[label_rows*6*f32] img[img_len] seg[seg_len]

Readers build a span-backed :class:`~dspnet_torch.data.iterator.SampleIndex`
(``image_span`` / ``seg_span`` = (store path, offset, length)); the loader
reads the encoded bytes from those spans (``iterator.load_sample_bytes``).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

import numpy as np

from dspnet_torch.data.iterator import LABEL_WIDTH, Sample, SampleIndex, read_encoded

MAGIC = b"DREC0001"
_HDR = struct.Struct("<IIQQ")  # name_len, label_rows, img_len, seg_len


def pack_records(index: SampleIndex, prefix: str, quiet: bool = False) -> str:
    """Pack a SampleIndex into ``prefix.drec`` + ``prefix.idx``.

    Encoded bytes are copied verbatim from the source files (or source
    spans, when repacking an already record-backed index), mirroring
    im2rec's pack-without-recompress path (reference tools/im2rec.py:86-92).
    Returns the ``.drec`` path.
    """
    drec = prefix + ".drec"
    idx = prefix + ".idx"
    os.makedirs(os.path.dirname(os.path.abspath(drec)), exist_ok=True)
    offsets: List[int] = []
    with open(drec, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(index)))
        for i in range(len(index)):
            s = index[i]
            img_bytes = read_encoded(s.image_path, s.image_span)
            seg_bytes = b""
            if s.seg_span is not None or s.seg_path is not None:
                seg_bytes = read_encoded(s.seg_path, s.seg_span)
            label = np.asarray(s.label, np.float32)
            valid = int((label[:, 0] >= 0).sum())  # rows are top-compacted
            name = s.image_path.encode()
            offsets.append(f.tell())
            f.write(_HDR.pack(len(name), valid, len(img_bytes), len(seg_bytes)))
            f.write(name)
            f.write(label[:valid].tobytes())
            f.write(img_bytes)
            f.write(seg_bytes)
    with open(idx, "w") as f:
        for i, off in enumerate(offsets):
            f.write(f"{i} {off}\n")
    if not quiet:
        size_mb = os.path.getsize(drec) / 1e6
        print(f"packed {len(index)} samples -> {drec} ({size_mb:.1f} MB)")
    return drec


def load_record_index(prefix: str) -> SampleIndex:
    """Open ``prefix.drec``/``prefix.idx`` as a span-backed SampleIndex.

    One pass over the record headers at open (labels + names live in the
    index, like the reference's `.lst` sidecar); pixel bytes stay on disk
    until a batch needs them.
    """
    if prefix.endswith(".drec"):
        prefix = prefix[: -len(".drec")]
    drec = prefix + ".drec"
    idx = prefix + ".idx"
    with open(idx) as f:
        offsets = [int(line.split()[1]) for line in f if line.strip()]
    samples = []
    with open(drec, "rb") as f:
        magic = f.read(8)
        if magic != MAGIC:
            raise ValueError(f"{drec}: bad magic {magic!r}")
        (n,) = struct.unpack("<Q", f.read(8))
        if n != len(offsets):
            raise ValueError(f"{drec}: {n} records but {len(offsets)} idx lines")
        for off in offsets:
            f.seek(off)
            name_len, rows, img_len, seg_len = _HDR.unpack(f.read(_HDR.size))
            name = f.read(name_len).decode()
            label_rows = np.frombuffer(
                f.read(rows * LABEL_WIDTH * 4), np.float32
            ).reshape(rows, LABEL_WIDTH)
            img_off = f.tell()
            seg_off = img_off + img_len
            samples.append(
                Sample(
                    image_path=name,
                    label=SampleIndex.pad_label(label_rows),
                    seg_path=(name + "#seg") if seg_len else None,
                    image_span=(drec, img_off, img_len),
                    seg_span=(drec, seg_off, seg_len) if seg_len else None,
                )
            )
    return SampleIndex(samples)


def record_prefix_at(root: str, split: str) -> Optional[str]:
    """If ``root`` holds packed records for ``split``, return their prefix.

    When ``root`` is a ``.drec`` file, a sibling ``{split}.drec`` wins (so
    ``--dataset-root /data/train.drec`` still evaluates on ``val.drec``,
    never silently on the training records); the named file itself is the
    fallback only when no sibling split exists."""
    if root.endswith(".drec") and os.path.exists(root):
        sibling = os.path.join(os.path.dirname(root), split)
        if os.path.exists(sibling + ".drec"):
            return sibling
        return root[: -len(".drec")]
    cand = os.path.join(root, split)
    if os.path.exists(cand + ".drec"):
        return cand
    return None
