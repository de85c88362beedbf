"""MXNet RecordIO (``.rec`` / ``.idx``) ingestion (counterpart of
``dspnet_tpu/data/rec_import.py``, byte for byte in what it reads and
writes): the migration path for datasets packed by the reference's
``tools/im2rec.py --pack-label`` (reference tools/im2rec.py:137-140, written
through mx.recordio.pack_img and read back by MXIndexedRecordIO,
dataset/iterator.py:396,559).

Wire format (mxnet src/io/recordio.h + python/mxnet/recordio.py)::

    record  := u32 kMagic=0xced7230a
               u32 lrec         (length = lrec & (2^29-1), cflag = lrec>>29)
               data[length]     padded with zeros to a 4-byte boundary
    multipart: the writer splits a payload AT each kMagic inside it (dropping
               the occurrence); cflag 1=first, 2=middle, 3=last part; the
               reader joins the parts with the 4 magic bytes between them
    payload := IRHeader { u32 flag; f32 label; u64 id; u64 id2 }
               + (flag > 0: flag * f32, the packed label vector)
               + encoded image bytes

The label vector follows the ``.lst`` contract the reference writes
(``2 <object_width> <objects...>``, imdb.py:81-82): element 0 is the header
width H, element 1 the object width W, objects start at element H.

:func:`load_rec_index` serves straight out of the ``.rec``: single-part image
bytes become (path, offset, length) spans that the loaders read as they
read ``.drec`` spans. :func:`convert_rec` repacks into a ``.drec`` store
(``data/record.py``).
"""

from __future__ import annotations

import os
import struct
import tempfile
from typing import Iterator, List, Optional, Tuple

import numpy as np

from dspnet_torch.data.iterator import LABEL_WIDTH, Sample, SampleIndex

KMAGIC = 0xCED7230A
_MAGIC_BYTES = struct.pack("<I", KMAGIC)
_LEN_MASK = (1 << 29) - 1
_IR_HEADER = struct.Struct("<IfQQ")  # flag, label, id, id2


def read_records(rec_path: str) -> Iterator[Tuple[int, int, bytes]]:
    """Yield ``(payload_offset, payload_len, payload)`` per logical record.

    ``payload_offset`` is the byte offset of the (joined) payload within the
    file, or -1 for multipart records (whose payload is not contiguous on
    disk and cannot be served by span). Streams record-by-record — a
    reference-packed .rec can be multi-GB and must not be slurped whole."""
    parts: List[bytes] = []
    with open(rec_path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            magic, lrec = struct.unpack("<II", head)
            if magic != KMAGIC:
                raise ValueError(f"{rec_path}: bad record magic {magic:#x} at offset {f.tell() - 8}")
            length = lrec & _LEN_MASK
            cflag = lrec >> 29
            start = f.tell()
            payload = f.read(length)
            if len(payload) != length:
                raise ValueError(f"{rec_path}: truncated record")
            f.seek((-length) % 4, 1)  # zero padding to a 4-byte boundary
            if cflag == 0:
                if parts:
                    raise ValueError(f"{rec_path}: complete record inside multipart")
                yield start, length, payload
            elif cflag == 1:
                if parts:
                    raise ValueError(f"{rec_path}: nested multipart start")
                parts = [payload]
            else:
                if not parts:
                    raise ValueError(f"{rec_path}: multipart continuation without start")
                parts.append(payload)
                if cflag == 3:
                    joined = _MAGIC_BYTES.join(parts)
                    parts = []
                    yield -1, len(joined), joined
    if parts:
        raise ValueError(f"{rec_path}: unterminated multipart record")


def write_records(rec_path: str, payloads: Iterator[bytes]) -> List[int]:
    """MXRecordIO writer (for tests / round-trips): splits payloads at
    embedded kMagic occurrences exactly like recordio.h WriteRecord.
    Returns each record's start offset (the ``.idx`` position column)."""
    offsets = []
    with open(rec_path, "wb") as f:
        for payload in payloads:
            offsets.append(f.tell())
            parts = payload.split(_MAGIC_BYTES)
            for i, part in enumerate(parts):
                cflag = 0
                if len(parts) > 1:
                    cflag = 1 if i == 0 else (3 if i == len(parts) - 1 else 2)
                f.write(struct.pack("<II", KMAGIC, (cflag << 29) | len(part)))
                f.write(part)
                f.write(b"\0" * ((-len(part)) % 4))
    return offsets


def pack_payload(flag_id: int, label_vec: np.ndarray, img_bytes: bytes) -> bytes:
    """mx.recordio.pack(IRHeader(len(label), 0, id, 0), ...) equivalent."""
    label_vec = np.asarray(label_vec, np.float32).reshape(-1)
    head = _IR_HEADER.pack(len(label_vec), 0.0, flag_id, 0)
    return head + label_vec.tobytes() + img_bytes


def unpack_payload(payload: bytes):
    """-> (id, label_vector f32 array, img_offset_within_payload, img_bytes)."""
    flag, label_scalar, rid, _ = _IR_HEADER.unpack_from(payload, 0)
    off = _IR_HEADER.size
    if flag > 0:
        vec = np.frombuffer(payload, np.float32, count=flag, offset=off).copy()
        off += 4 * flag
    else:
        vec = np.asarray([label_scalar], np.float32)
    return rid, vec, off, payload[off:]


def _label_rows(vec: np.ndarray) -> np.ndarray:
    """Packed lst label vector -> (N, LABEL_WIDTH) object rows.

    ``[H, W, header..., objects...]`` with H header elements and W-wide
    objects (imdb.py:81-82 writes H=2, W=6; the VOC path W=5)."""
    if vec.size < 2:
        return np.zeros((0, LABEL_WIDTH), np.float32)
    hw, ow = int(vec[0]), int(vec[1])
    if hw < 2 or ow < 5 or vec.size < hw:
        return np.zeros((0, LABEL_WIDTH), np.float32)
    body = vec[hw:]
    n = body.size // ow
    rows = body[: n * ow].reshape(n, ow).astype(np.float32)
    if ow < LABEL_WIDTH:
        rows = np.concatenate(
            [rows, np.zeros((n, LABEL_WIDTH - ow), np.float32)], axis=1)
    return rows[:, :LABEL_WIDTH]


def load_rec_index(rec_path: str, lst_path: Optional[str] = None,
                   root: str = "", find_seg: bool = True) -> SampleIndex:
    """Open a reference-packed ``.rec`` as a span-backed SampleIndex.

    Labels come from the packed record vectors; ``lst_path`` (the sidecar
    the reference keeps next to the .rec) recovers image path strings and
    the seg-mask lookup keyed by record id (dataset/iterator.py:386-394).
    Multipart records (payload not contiguous on disk — JPEG bytes that
    happened to contain kMagic) are materialized through a fresh temp file
    (unique per call: two .rec files sharing a basename must not collide)
    so every sample stays span-backed; the dataset mount may be read-only
    and other processes may be reading the same .rec, so the temp file
    never lives next to the source. It stays for the process lifetime —
    the returned index's spans point into it.
    """
    key_to_path = {}
    if lst_path:
        with open(lst_path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    key_to_path[int(float(parts[0]))] = parts[-1]

    from dspnet_torch.data import imdb

    samples = []
    side_path = None
    side = None
    for start, length, payload in read_records(rec_path):
        rid, vec, img_off, img = unpack_payload(payload)
        name = key_to_path.get(rid, f"{rec_path}#%d" % rid)
        if root and not os.path.isabs(name) and not name.startswith(rec_path):
            name = os.path.join(root, name)
        seg = None
        if find_seg and rid in key_to_path:
            seg = imdb.find_seg_for(name)
        if start >= 0:
            span = (rec_path, start + img_off, length - img_off)
        else:
            # multipart: payload is not contiguous in the .rec — append the
            # joined image bytes to a sidecar once and span into that
            if side is None:
                import atexit

                fd, side_path = tempfile.mkstemp(
                    prefix=os.path.basename(rec_path) + ".joined.")
                side = os.fdopen(fd, "wb")
                # spans point into the sidecar for the index's lifetime;
                # reclaim it at interpreter exit so repeated loads can't
                # fill the tempdir
                atexit.register(
                    lambda p=side_path: os.path.exists(p) and os.unlink(p))
            span = (side_path, side.tell(), len(img))
            side.write(img)
        samples.append(Sample(
            image_path=name,
            label=SampleIndex.pad_label(_label_rows(vec)),
            seg_path=seg,
            image_span=span,
        ))
    if side is not None:
        side.close()
    return SampleIndex(samples)


def convert_rec(rec_path: str, out_prefix: str, lst_path: Optional[str] = None,
                root: str = "", quiet: bool = False,
                find_seg: bool = True) -> str:
    """One-way ``.rec`` -> ``.drec`` migration (image bytes copied verbatim,
    labels re-framed, seg masks pulled in from the lst lookup when found)."""
    from dspnet_torch.data.record import pack_records

    index = load_rec_index(rec_path, lst_path, root=root, find_seg=find_seg)
    return pack_records(index, out_prefix, quiet=quiet)
