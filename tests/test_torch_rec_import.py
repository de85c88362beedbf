"""The port's MXNet RecordIO ingestion (``data/rec_import.py``) against the
JAX package's, on the CPU, exactly: the framing (multipart records split at
the magic word, a payload that holds it), ``IRHeader`` payloads, the label
rows, ``load_rec_index``'s spans and ``convert_rec``'s ``.drec`` stores, and
a converted store through the port's loader."""

import struct

import numpy as np
import pytest
import torch

from dspnet_tpu.data import rec_import as jrec
from dspnet_tpu.data import record as jrecord
from dspnet_torch.data import image_io, iterator, jpeg, rec_import, record
from dspnet_torch.data.device_pipeline import DeviceAugIterator

MAGIC_FLOAT = struct.unpack("<f", rec_import._MAGIC_BYTES)[0]


def _lst_label(rows, width=6):
    """The reference's packed label vector: [2, W, objects...] (imdb.py:81)."""
    rows = np.asarray(rows, np.float32).reshape(-1, width)
    return np.concatenate([[2.0, width], rows.reshape(-1)]).astype(np.float32)


def _payloads(rng, n=6):
    """Payloads as the reference packs them, two holding the magic word
    (one in the label vector, one in the image bytes, twice) and one with
    a scalar label (flag 0)."""
    out = []
    for i in range(n):
        img = jpeg.encode(rng.randint(0, 256, (16 + i, 24, 3)).astype(np.uint8), 90)
        rows = np.concatenate([rng.randint(0, 8, (i % 3 + 1, 1)), rng.uniform(0, 1, (i % 3 + 1, 5))], 1)
        vec = _lst_label(rows)
        if i == 1:
            vec = np.concatenate([vec, [MAGIC_FLOAT]]).astype(np.float32)
        if i == 2:
            img = img[:40] + rec_import._MAGIC_BYTES + img[40:60] + rec_import._MAGIC_BYTES + img[60:]
        out.append(rec_import.pack_payload(i, vec, img) if i != 4 else
                   rec_import._IR_HEADER.pack(0, 3.0, i, 0) + img)
    return out


def test_framing_equals_jax(tmp_path, rng):
    """``write_records`` writes the JAX writer's bytes, with the same record
    offsets; ``read_records`` yields the JAX reader's records from either
    file (multipart ones at offset -1, joined with the magic word)."""
    payloads = _payloads(rng)
    assert sum(rec_import._MAGIC_BYTES in p for p in payloads) == 2
    offsets = rec_import.write_records(str(tmp_path / "t.rec"), payloads)
    assert offsets == jrec.write_records(str(tmp_path / "j.rec"), payloads)
    assert (tmp_path / "t.rec").read_bytes() == (tmp_path / "j.rec").read_bytes()
    got = list(rec_import.read_records(str(tmp_path / "j.rec")))
    assert got == list(jrec.read_records(str(tmp_path / "t.rec")))
    assert [p for _, _, p in got] == payloads
    assert [s for s, _, _ in got][1:3] == [-1, -1]


def test_payloads_and_label_rows_equal_jax(rng):
    """``pack_payload`` / ``unpack_payload`` and ``_label_rows`` on 5- and
    6-wide objects, a header wider than 2, a short or malformed vector and a
    scalar label."""
    vecs = [_lst_label(rng.uniform(0, 1, (3, 6))), _lst_label(rng.uniform(0, 1, (2, 5)), 5),
            np.concatenate([[4.0, 6.0, 9.0, 9.0], rng.uniform(0, 1, 12)]).astype(np.float32),
            np.array([2.0], np.float32), np.array([1.0, 6.0, 0.5], np.float32),
            np.array([2.0, 4.0, 0.1, 0.2, 0.3, 0.4], np.float32), np.zeros(0, np.float32)]
    for i, vec in enumerate(vecs):
        p = rec_import.pack_payload(i, vec, b"img")
        assert p == jrec.pack_payload(i, vec, b"img")
        got, want = rec_import.unpack_payload(p), jrec.unpack_payload(p)
        assert (got[0], got[2], got[3]) == (want[0], want[2], want[3])
        np.testing.assert_array_equal(got[1], want[1])
        rows = rec_import._label_rows(vec)
        np.testing.assert_array_equal(rows, jrec._label_rows(vec))
        assert rows.dtype == np.float32 and rows.shape[1] == iterator.LABEL_WIDTH
    scalar = rec_import._IR_HEADER.pack(0, 3.0, 7, 0) + b"x"
    assert rec_import.unpack_payload(scalar)[:2][0] == 7
    np.testing.assert_array_equal(rec_import.unpack_payload(scalar)[1], [3.0])


@pytest.mark.parametrize("with_lst", [False, True])
def test_load_rec_index_equals_jax(tmp_path, rng, with_lst):
    """The same samples: names (from the ``.lst`` or ``path#id``), labels bit
    for bit, seg paths, and spans into the ``.rec`` for single-part records
    (the same spans as the JAX index) that read the original image bytes;
    multipart ones are served from a joined copy."""
    payloads = _payloads(rng)
    rec = str(tmp_path / "a.rec")
    rec_import.write_records(rec, payloads)
    lst = None
    if with_lst:
        (tmp_path / "JPEGImages").mkdir()
        (tmp_path / "SegmentationClass").mkdir()
        lst = str(tmp_path / "a.lst")
        with open(lst, "w") as f:
            for i in range(len(payloads)):
                f.write(f"{i}\t2\t6\t0.1\tJPEGImages/s{i}_leftImg8bit.jpg\n")
        (tmp_path / "SegmentationClass" / "s3_gtFine_labelTrainIds.png").write_bytes(b"png")
    got = rec_import.load_rec_index(rec, lst, root=str(tmp_path))
    want = jrec.load_rec_index(rec, lst, root=str(tmp_path))
    assert len(got) == len(want) == len(payloads)
    for i, (a, b) in enumerate(zip(got.samples, want.samples)):
        assert (a.image_path, a.seg_path) == (b.image_path, b.seg_path)
        np.testing.assert_array_equal(a.label, b.label)
        img = rec_import.unpack_payload(payloads[i])[3]
        assert iterator.read_span(a.image_span).tobytes() == img
        if i in (1, 2):
            assert a.image_span[0] != rec
        else:
            assert a.image_span == b.image_span
    assert (got[3].seg_path is not None) == with_lst


def test_convert_rec_equals_jax_and_feeds_the_loader(tmp_path, rng):
    """``convert_rec`` writes the JAX store's bytes; the store opens in
    either package and feeds the port's loader on the CPU."""
    (tmp_path / "JPEGImages").mkdir()
    (tmp_path / "SegmentationClass").mkdir()
    lines, payloads = [], []
    for i in range(4):
        img = jpeg.encode(rng.randint(0, 256, (32, 48, 3)).astype(np.uint8), 95)
        seg = rng.randint(0, 19, (32, 48)).astype(np.uint8)
        image_io.imwrite(str(tmp_path / "SegmentationClass" / f"s{i}_gtFine_labelTrainIds.png"), seg)
        rows = np.array([[i % 8, 0.1, 0.2, 0.6, 0.7, 0.3]], np.float32)
        if i == 2:
            img = img[:50] + rec_import._MAGIC_BYTES + img[50:]
        payloads.append(rec_import.pack_payload(i, _lst_label(rows), img))
        lines.append(f"{i}\t2\t6\t0\tJPEGImages/s{i}_leftImg8bit.jpg\n")
    rec, lst = str(tmp_path / "c.rec"), str(tmp_path / "c.lst")
    rec_import.write_records(rec, payloads)
    (tmp_path / "c.lst").write_text("".join(lines))
    for find_seg in (True, False):
        out_t, out_j = str(tmp_path / f"t{find_seg}"), str(tmp_path / f"j{find_seg}")
        assert rec_import.convert_rec(rec, out_t, lst, root=str(tmp_path), quiet=True,
                                      find_seg=find_seg) == out_t + ".drec"
        jrec.convert_rec(rec, out_j, lst, root=str(tmp_path), quiet=True, find_seg=find_seg)
        for ext in (".drec", ".idx"):
            assert open(out_t + ext, "rb").read() == open(out_j + ext, "rb").read()
    index = record.load_record_index(str(tmp_path / "tTrue"))
    assert len(jrecord.load_record_index(str(tmp_path / "tTrue"))) == len(index) == 4
    assert all(s.seg_span is not None for s in index)
    it = DeviceAugIterator(index, 2, (32, 48), device="cpu", seed=233, enable_aug=False, shuffle=False)
    batch, names = next(iter(it.epoch()))
    assert tuple(batch["images"].shape) == (2, 32, 48, 3) and isinstance(batch["images"], torch.Tensor)
    assert names[0].endswith("s0_leftImg8bit.jpg")


@pytest.mark.parametrize("fault", ["magic", "truncated", "orphan", "nested", "unterminated", "inside"])
def test_malformed_records_raise(tmp_path, fault):
    """Faults in a ``.rec`` raise ValueError (the JAX reader asserts)."""
    def rec(cflag, body):
        return struct.pack("<II", rec_import.KMAGIC, (cflag << 29) | len(body)) + body + b"\0" * (-len(body) % 4)

    data = {"magic": struct.pack("<II", 0x12345678, 4) + b"abcd",
            "truncated": struct.pack("<II", rec_import.KMAGIC, 100) + b"short",
            "orphan": rec(2, b"abcd"),
            "nested": rec(1, b"abcd") + rec(1, b"efgh"),
            "unterminated": rec(1, b"abcd"),
            "inside": rec(1, b"abcd") + rec(0, b"efgh")}[fault]
    (tmp_path / "bad.rec").write_bytes(data)
    with pytest.raises(ValueError, match="record|multipart"):
        list(rec_import.read_records(str(tmp_path / "bad.rec")))
