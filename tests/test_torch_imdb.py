"""The port's dataset indexers and record stores against the JAX package's, on
the CPU: the same samples (paths, label matrices bit for bit, seg paths,
record spans) from a prepared-Cityscapes directory, a VOC devkit, list files,
COCO JSON, YOLO, ConcatDB, TestDB and ``.drec`` stores packed by either
package."""

import json
import os

import numpy as np
import pytest

from dspnet_tpu.data import imdb as jimdb
from dspnet_tpu.data import iterator as jiter
from dspnet_tpu.data import record as jrecord
from dspnet_tpu.data import synthetic as jsyn
from dspnet_torch.data import imdb, iterator, record
from dspnet_torch.data.cs_labels import DET_CLASSES
from tests.torch_parity import write_cityscapes_layout


def _same(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got.samples, want.samples):
        assert (a.image_path, a.seg_path, a.image_span, a.seg_span) == \
            (b.image_path, b.seg_path, b.image_span, b.seg_span)
        assert a.label.dtype == b.label.dtype == np.float32
        np.testing.assert_array_equal(a.label, b.label)


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cs"))
    write_cityscapes_layout(root, {"train": 4, "val": 2}, hw=(48, 96), seed=3)
    return root


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("classes", [None, list(DET_CLASSES), ["car", "person"]])
def test_cityscapes_layout_matches_jax(cityscapes, split, classes):
    """XML boxes with <distance>, trainId seg paths, the class table."""
    got = imdb.load_index(cityscapes, split, classes=classes)
    _same(got, jimdb.load_index(cityscapes, split, classes=classes))
    assert all(s.seg_path and os.path.exists(s.seg_path) for s in got.samples)
    dist = np.concatenate([s.label[s.label[:, 0] >= 0, 5] for s in got.samples])
    assert (dist > 0).all() and (dist <= 1).all()
    assert dist.size or classes == ["car", "person"]
    if classes == ["car", "person"]:
        assert {int(c) for s in got.samples for c in s.label[:, 0] if c >= 0} <= {0, 1}


@pytest.mark.parametrize("classes", [None, list(DET_CLASSES)])
def test_voc_devkit_matches_jax(tmp_path, classes):
    """A VOC devkit from the JAX package's writer, through load_index (devkit
    root and VOC{year} root) and PascalVoc's difficult options."""
    root = jsyn.build_voc_dataset(str(tmp_path / "voc"), num_samples=4, hw=(48, 64), year="2012")
    for r in (root, os.path.join(root, "VOC2012")):
        for split in ("train", "val"):
            _same(imdb.load_index(r, split, classes=classes), jimdb.load_index(r, split, classes=classes))
    names = classes or list(DET_CLASSES)
    for kw in ({"use_difficult": True}, {"difficult_in_label": True}, {}):
        ours = imdb.PascalVoc("val", "2012", root, classes=names, **kw)
        theirs = jimdb.PascalVoc("val", "2012", root, classes=names, **kw)
        assert ours.split_ids() == theirs.split_ids()
        _same(ours.index(), theirs.index())


def test_drec_stores_cross_read(cityscapes, tmp_path):
    """A store packed by either package reads the same in both; its spans
    hold the files' bytes; a .drec root prefers its sibling split."""
    index = imdb.load_index(cityscapes, "train")
    ours = record.pack_records(index, str(tmp_path / "a" / "train"), quiet=True)
    theirs = jrecord.pack_records(jimdb.load_index(cityscapes, "train"), str(tmp_path / "b" / "train"),
                                  quiet=True)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    for store in (ours, theirs):
        got = record.load_record_index(store)
        _same(got, jrecord.load_record_index(store))
        for s, src in zip(got.samples, index.samples):
            data, seg = iterator.load_sample_bytes(s)
            assert data == open(src.image_path, "rb").read()
            np.testing.assert_array_equal(seg, iterator.load_sample_arrays(src)[1])
            img, _ = iterator.load_sample_arrays(s)
            jimg, _ = jiter.load_sample_arrays(s)
            np.testing.assert_array_equal(img, jimg)
    record.pack_records(imdb.load_index(cityscapes, "val"), str(tmp_path / "a" / "val"), quiet=True)
    for root, split in ((ours, "val"), (ours, "train"), (str(tmp_path / "a"), "val")):
        assert record.record_prefix_at(root, split) == jrecord.record_prefix_at(root, split)
        _same(imdb.load_index(root, split), jimdb.load_index(root, split))
    assert record.record_prefix_at(str(tmp_path / "a"), "test") is None
    with open(ours[:-5] + ".idx", "a") as f:
        f.write("4 0\n")
    with pytest.raises(ValueError, match="idx lines"):
        record.load_record_index(ours)


def test_lists_coco_yolo_concat_testdb(cityscapes, tmp_path):
    """load_imglist (with the seg lookup), COCO JSON, YOLO txt, ConcatDB and
    TestDB give the JAX package's samples."""
    db, jdb = imdb.CityscapesDetSeg("train", cityscapes), jimdb.CityscapesDetSeg("train", cityscapes)
    lst = str(tmp_path / "train.lst")
    db.save_imglist(lst)
    jlst = str(tmp_path / "j.lst")
    jdb.save_imglist(jlst)
    assert open(lst).read() == open(jlst).read()
    _same(imdb.load_imglist(lst), jimdb.load_imglist(lst))
    _same(imdb.load_imglist(lst, root=str(tmp_path), find_seg=False),
          jimdb.load_imglist(lst, root=str(tmp_path), find_seg=False))
    assert imdb.find_seg_for(db.samples()[0].image_path) == db.samples()[0].seg_path

    coco = {"categories": [{"id": 7, "name": "car"}, {"id": 3, "name": "person"}],
            "images": [{"id": 1, "file_name": "a.jpg", "width": 64, "height": 48},
                       {"id": 2, "file_name": "b.jpg", "width": 32, "height": 32}],
            "annotations": [{"image_id": 1, "bbox": [4, 5, 10, 12], "category_id": 7},
                            {"image_id": 1, "bbox": [1, 2, 3, 4], "category_id": 3, "iscrowd": 1},
                            {"image_id": 2, "bbox": [0, 0, 31, 31], "category_id": 3}]}
    cpath = str(tmp_path / "coco.json")
    with open(cpath, "w") as f:
        json.dump(coco, f)
    ours, theirs = imdb.CocoDet(cpath, "imgs"), jimdb.CocoDet(cpath, "imgs")
    assert ours.classes == theirs.classes
    _same(ours.index(), theirs.index())

    os.makedirs(tmp_path / "labels")
    with open(tmp_path / "labels" / "x.txt", "w") as f:
        f.write("1 0.5 0.5 0.2 0.4\n0 0.1 0.2 0.05 0.05\nbad\n")
    with open(tmp_path / "list.txt", "w") as f:
        f.write("x\ny\n")
    args = (str(tmp_path / "list.txt"), "imgs", str(tmp_path / "labels"), ["a", "b"])
    _same(imdb.YoloFormat(*args).index(), jimdb.YoloFormat(*args).index())

    _same(imdb.ConcatDB(db, db).index(), jimdb.ConcatDB(jdb, jdb).index())
    with pytest.raises(ValueError, match="class sets"):
        imdb.ConcatDB(db, imdb.TestDB(["a.jpg"]))
    _same(imdb.TestDB(["a.jpg", "b.jpg"]).index(), jimdb.TestDB(["a.jpg", "b.jpg"]).index())


def test_load_index_refuses_what_it_cannot_find(tmp_path):
    with pytest.raises(FileNotFoundError):
        imdb.load_index(str(tmp_path), "train")
    with pytest.raises(ValueError):
        imdb.load_index("", "train")
