"""Dataset indexers (counterpart of the index half of
``dspnet_tpu/data/imdb.py``): VOC, Cityscapes, COCO, YOLO, list files and
record stores -> a :class:`~dspnet_torch.data.iterator.SampleIndex`.

  * :class:`Imdb` base with list-file export, :func:`load_imglist`,
    :func:`find_seg_for`;
  * :class:`PascalVoc` (XML boxes, difficult flag): its samples, split ids
    and the offline devkit evaluation (``comp4_det_*`` result files written
    and re-scored with ``evaluate/eval_voc.py::voc_eval``);
  * :class:`CityscapesDetSeg` (PASCAL-style XML with the extra <distance>
    tag normalised /255 and clipped to [0, 1]; trainId seg PNGs);
  * :class:`CocoDet`, :class:`YoloFormat`, :class:`ConcatDB`, :class:`TestDB`;
  * :func:`load_index`: the layout under a ``--dataset-root``, with the
    ``classes`` name table threaded into the XML layouts.

Every sample carries normalised (cls, x1, y1, x2, y2, dist) rows (dist 0
where the source has none) and an optional seg path, as in the JAX package:
``tests/test_torch_imdb.py`` holds both to the same samples bit for bit.
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from typing import List, Optional, Sequence

import numpy as np

from dspnet_torch.data.iterator import LABEL_WIDTH, Sample, SampleIndex
from dspnet_torch.evaluate.eval_voc import voc_eval

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
CITYSCAPES_DET_CLASSES = (
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
)


class Imdb:
    """Base: named dataset -> SampleIndex + .lst export (imdb.py:53-93)."""

    def __init__(self, name: str, classes: Sequence[str]):
        self.name = name
        self.classes = list(classes)
        self.num_classes = len(self.classes)

    def samples(self) -> List[Sample]:
        raise NotImplementedError

    def index(self) -> SampleIndex:
        return SampleIndex(self.samples())

    def save_imglist(self, fname: str):
        """lst line: index \t 2 \t label_width \t labels... \t path
        (imdb.py:81-82)."""
        with open(fname, "w") as f:
            for i, s in enumerate(self.samples()):
                rows = s.label[s.label[:, 0] >= 0]
                flat = " ".join("%.4f" % v for v in rows.reshape(-1))
                width = rows.shape[1] if rows.size else 6
                f.write(f"{i}\t2\t{width}\t{flat}\t{s.image_path}\n")


def load_imglist(fname: str, root: str = "", find_seg: bool = True) -> SampleIndex:
    """Parse a `.lst` written by :meth:`Imdb.save_imglist` back into samples.

    Inverse of the reference's lst contract (imdb.py:81-82): ``index \\t 2 \\t
    label_width \\t labels... \\t path``. Image paths are joined to ``root``
    when relative. When ``find_seg``, a sibling seg mask is looked up by the
    DSPNet naming rule (JPEGImages/x_leftImg8bit.jpg ->
    SegmentationClass/x_gtFine_labelTrainIds.png, the record-id -> seg-path
    map of reference dataset/iterator.py:386-394).
    """
    samples = []
    with open(fname) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 4:
                continue
            width = int(float(parts[2]))
            vals = [float(v) for v in parts[3].split()] if parts[3] else []
            rows = np.asarray(vals, np.float32).reshape(-1, width) if vals \
                else np.zeros((0, LABEL_WIDTH), np.float32)
            if width < LABEL_WIDTH:  # 5-wide VOC rows -> dist column 0
                rows = np.concatenate(
                    [rows, np.zeros((len(rows), LABEL_WIDTH - width), np.float32)], 1)
            path = parts[-1]
            if root and not os.path.isabs(path):
                path = os.path.join(root, path)
            seg = find_seg_for(path) if find_seg else None
            samples.append(Sample(path, SampleIndex.pad_label(rows[:, :LABEL_WIDTH]), seg))
    return SampleIndex(samples)


def find_seg_for(image_path: str):
    """Sibling seg mask by the DSPNet naming rule (JPEGImages/
    x_leftImg8bit.jpg -> SegmentationClass/x_gtFine_labelTrainIds.png — the
    record-id -> seg-path map of reference dataset/iterator.py:386-394);
    None when absent. Replaces only in the basename (a directory component
    may also contain 'leftImg8bit' in the official layout)."""
    d, b = os.path.split(image_path)
    b = os.path.splitext(b)[0].replace(
        "leftImg8bit", "gtFine_labelTrainIds") + ".png"
    for cand_dir in (d.replace("JPEGImages", "SegmentationClass"),
                     d.replace(os.sep + "leftImg8bit" + os.sep,
                               os.sep + "gtFine" + os.sep)):
        cand = os.path.join(cand_dir, b)
        if os.path.exists(cand):
            return cand
    return None


def _parse_voc_xml(xml_path: str, classes: Sequence[str], with_distance: bool):
    tree = ET.parse(xml_path)
    size = tree.find("size")
    width = float(size.find("width").text)
    height = float(size.find("height").text)
    rows = []
    for obj in tree.iter("object"):
        cls_name = obj.find("name").text.strip().lower()
        if cls_name not in classes:
            continue
        cid = classes.index(cls_name)
        diff_node = obj.find("difficult")
        difficult = int(diff_node.text) if diff_node is not None else 0
        bb = obj.find("bndbox")
        x1 = float(bb.find("xmin").text) / width
        y1 = float(bb.find("ymin").text) / height
        x2 = float(bb.find("xmax").text) / width
        y2 = float(bb.find("ymax").text) / height
        dist = 0.0
        if with_distance:
            dn = obj.find("distance")
            if dn is not None:
                # meters / 255, clipped (cityscapes.py:160-166)
                dist = min(1.0, max(0.0, float(dn.text) / 255.0))
        rows.append([cid, x1, y1, x2, y2, dist, difficult])
    return np.asarray(rows, np.float32) if rows else np.zeros((0, 7), np.float32)


class PascalVoc(Imdb):
    """VOCdevkit layout: {root}/VOC{year}/{JPEGImages,Annotations,ImageSets}."""

    def __init__(self, image_set: str, year: str, root: str,
                 classes: Sequence[str] = VOC_CLASSES, use_difficult: bool = False,
                 difficult_in_label: bool = False):
        """``use_difficult``: TRAIN-side filter — when False, difficult
        objects are dropped from the labels (reference pascal_voc.py
        config['use_difficult']). ``difficult_in_label``: EVAL-side layout —
        keep every object and carry its difficult flag in label column 5
        (the dist column, always 0 for VOC), which is exactly the
        ``(n, >=6)`` labels-with-difficult contract of
        evaluate.eval_metric.MApMetric (the streaming metric decides with
        its own use_difficult switch, reference eval_metric.py:100-104)."""
        super().__init__(f"voc_{year}_{image_set}", classes)
        self.root = os.path.join(root, f"VOC{year}")
        self.year = year
        self.image_set = image_set
        self.use_difficult = use_difficult
        self.difficult_in_label = difficult_in_label

    def split_ids(self) -> List[str]:
        lst = os.path.join(self.root, "ImageSets", "Main", self.image_set + ".txt")
        with open(lst) as f:
            return [line.strip().split()[0] for line in f if line.strip()]

    def samples(self) -> List[Sample]:
        out = []
        for iid in self.split_ids():
            xml = os.path.join(self.root, "Annotations", iid + ".xml")
            img = os.path.join(self.root, "JPEGImages", iid + ".jpg")
            rows = _parse_voc_xml(xml, self.classes, with_distance=False)
            if self.difficult_in_label:
                if rows.size:  # difficult flag -> column 5
                    rows = np.concatenate([rows[:, :5], rows[:, 6:7]], axis=1)
                else:
                    rows = rows[:, :6]
                out.append(Sample(img, SampleIndex.pad_label(rows)))
                continue
            if not self.use_difficult and rows.size:
                rows = rows[rows[:, 6] < 1]
            out.append(Sample(img, SampleIndex.pad_label(rows[:, :6])))
        return out

    # --- offline file-based VOCdevkit evaluation -------------------------
    # Capability of reference dataset/pascal_voc.py:170-259 (the
    # Imdb.evaluate_detections entry consumed by evaluate/evaluate_net.py):
    # write per-class devkit result files, then score them with voc_eval.

    def _image_size(self, iid: str):
        """(height, width) from the annotation XML <size> — the reference
        decodes the JPEG for this (pascal_voc.py:258-267); the XML already
        carries it."""
        size = ET.parse(
            os.path.join(self.root, "Annotations", iid + ".xml")).find("size")
        return float(size.find("height").text), float(size.find("width").text)

    def get_result_file_template(self, result_dir: str) -> str:
        """VOCdevkit results/VOC{year}/Main/comp4_det_{set}_{cls}.txt
        (pascal_voc.py:195-208, comp_id config default 'comp4')."""
        return os.path.join(result_dir, f"comp4_det_{self.image_set}_" + "{}.txt")

    def write_pascal_results(self, all_boxes, result_dir: str):
        """Write one devkit result file per class (pascal_voc.py:210-236).

        ``all_boxes``: one (n, 6) array per split image, rows
        ``[cls_id, score, x1, y1, x2, y2]`` with coordinates normalized to
        [0, 1] (the detector row contract). Written as 1-based pixel
        coordinates, matching the devkit convention (pascal_voc.py:233).
        """
        ids = self.split_ids()
        if len(all_boxes) != len(ids):
            raise ValueError(f"{len(all_boxes)} detection lists for {len(ids)} split images")
        os.makedirs(result_dir, exist_ok=True)
        files = {c: open(self.get_result_file_template(result_dir).format(c), "w")
                 for c in self.classes}
        try:
            for iid, dets in zip(ids, all_boxes):
                dets = np.asarray(dets, np.float64)
                if dets.size == 0:
                    continue
                h, w = self._image_size(iid)
                for row in dets:
                    cid = int(row[0])
                    # detector padding rows are all -1 (pascal_voc.py:231
                    # filters by class the same way)
                    if not 0 <= cid < len(self.classes):
                        continue
                    cls = self.classes[cid]
                    # 1-based integer pixel coords: the reference truncates
                    # with int() before the +1 (pascal_voc.py:235-236), so
                    # devkit result files match it bit-for-bit
                    files[cls].write(
                        "{:s} {:.3f} {:.1f} {:.1f} {:.1f} {:.1f}\n".format(
                            iid, row[1],
                            int(row[2] * w) + 1, int(row[3] * h) + 1,
                            int(row[4] * w) + 1, int(row[5] * h) + 1))
        finally:
            for f in files.values():
                f.close()

    def do_python_eval(self, result_dir: str, ovthresh: float = 0.5,
                       use_07_metric: Optional[bool] = None):
        """Score previously written result files; returns {class: AP, 'mAP':
        mean} (pascal_voc.py:238-256; 07 metric for year < 2010)."""
        if use_07_metric is None:
            # 07 metric for year < 2010 (pascal_voc.py:247-249); non-numeric
            # years (e.g. the load_index VOC fallback) use the modern metric
            use_07_metric = self.year.isdigit() and int(self.year) < 2010
        anno_fmt = os.path.join(self.root, "Annotations", "{}.xml")
        ids = self.split_ids()
        aps = {}
        for cls in self.classes:
            lines = []
            path = self.get_result_file_template(result_dir).format(cls)
            if os.path.exists(path):
                with open(path) as f:
                    for line in f:
                        p = line.split()
                        if len(p) >= 6:
                            lines.append((p[0], float(p[1]), *map(float, p[2:6])))
            _, _, ap = voc_eval(lines, anno_fmt, ids, cls, ovthresh, use_07_metric)
            aps[cls] = ap
        aps["mAP"] = float(np.mean([aps[c] for c in self.classes]))
        return aps

    def evaluate_detections(self, detections, result_dir: Optional[str] = None,
                            ovthresh: float = 0.5,
                            use_07_metric: Optional[bool] = None):
        """Top-level offline eval (pascal_voc.py:170-185): write devkit
        result files under ``{devkit}/results/VOC{year}/Main`` (or
        ``result_dir``) and score them. Returns the per-class AP dict."""
        if result_dir is None:
            result_dir = os.path.join(os.path.dirname(self.root), "results",
                                      f"VOC{self.year}", "Main")
        self.write_pascal_results(detections, result_dir)
        return self.do_python_eval(result_dir, ovthresh, use_07_metric)


class CityscapesDetSeg(Imdb):
    """DSPNet Cityscapes layout: XML annotations with <distance>, trainId seg
    PNGs. Expects {root}/{Annotations,JPEGImages,SegmentationClass,ImageSets}."""

    def __init__(self, image_set: str, root: str,
                 classes: Sequence[str] = CITYSCAPES_DET_CLASSES):
        super().__init__(f"cityscapes_{image_set}", classes)
        self.root = root
        self.image_set = image_set

    def samples(self) -> List[Sample]:
        lst = os.path.join(self.root, "ImageSets", "Main", self.image_set + ".txt")
        with open(lst) as f:
            ids = [line.strip().split()[0] for line in f if line.strip()]
        out = []
        for iid in ids:
            xml = os.path.join(self.root, "Annotations", iid + ".xml")
            img = os.path.join(self.root, "JPEGImages", iid + ".jpg")
            seg = os.path.join(
                self.root, "SegmentationClass",
                iid.replace("leftImg8bit", "gtFine_labelTrainIds") + ".png",
            )
            rows = (
                _parse_voc_xml(xml, self.classes, with_distance=True)
                if os.path.exists(xml)
                else np.zeros((0, 7), np.float32)
            )
            out.append(Sample(img, SampleIndex.pad_label(rows[:, :6]),
                              seg if os.path.exists(seg) else None))
        return out


class CocoDet(Imdb):
    """COCO instances JSON (dataset/mscoco.py capability)."""

    def __init__(self, annotation_file: str, image_dir: str):
        with open(annotation_file) as f:
            self.coco = json.load(f)
        cats = sorted(self.coco["categories"], key=lambda c: c["id"])
        super().__init__("coco", [c["name"] for c in cats])
        self.catid_to_idx = {c["id"]: i for i, c in enumerate(cats)}
        self.image_dir = image_dir

    def samples(self) -> List[Sample]:
        imgs = {im["id"]: im for im in self.coco["images"]}
        per_image = {}
        for ann in self.coco["annotations"]:
            if ann.get("iscrowd", 0):
                continue
            im = imgs[ann["image_id"]]
            x, y, w, h = ann["bbox"]
            row = [
                self.catid_to_idx[ann["category_id"]],
                x / im["width"], y / im["height"],
                (x + w) / im["width"], (y + h) / im["height"], 0.0,
            ]
            per_image.setdefault(ann["image_id"], []).append(row)
        out = []
        for iid, im in imgs.items():
            rows = np.asarray(per_image.get(iid, []), np.float32)
            if rows.size == 0:
                rows = np.zeros((0, 6), np.float32)
            out.append(Sample(os.path.join(self.image_dir, im["file_name"]),
                              SampleIndex.pad_label(rows)))
        return out


class YoloFormat(Imdb):
    """YOLO txt-per-image: rows `cls cx cy w h` normalized
    (dataset/yolo_format.py capability)."""

    def __init__(self, list_file: str, image_dir: str, label_dir: str,
                 classes: Sequence[str], image_ext: str = ".jpg"):
        super().__init__("yolo", classes)
        self.list_file = list_file
        self.image_dir = image_dir
        self.label_dir = label_dir
        self.image_ext = image_ext

    def samples(self) -> List[Sample]:
        with open(self.list_file) as f:
            ids = [line.strip() for line in f if line.strip()]
        out = []
        for iid in ids:
            rows = []
            lp = os.path.join(self.label_dir, iid + ".txt")
            if os.path.exists(lp):
                with open(lp) as f:
                    for line in f:
                        p = line.split()
                        if len(p) < 5:
                            continue
                        cid, cx, cy, w, h = float(p[0]), *map(float, p[1:5])
                        rows.append([cid, cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2, 0.0])
            rows = np.asarray(rows, np.float32) if rows else np.zeros((0, 6), np.float32)
            out.append(Sample(os.path.join(self.image_dir, iid + self.image_ext),
                              SampleIndex.pad_label(rows)))
        return out


class ConcatDB(Imdb):
    """Concatenate imdbs (dataset/concat_db.py)."""

    def __init__(self, *imdbs: Imdb):
        if not imdbs:
            raise ValueError("ConcatDB needs at least one imdb")
        classes = imdbs[0].classes
        for db in imdbs:
            if db.classes != classes:
                raise ValueError("class sets must match to concat")
        super().__init__("+".join(db.name for db in imdbs), classes)
        self.imdbs = imdbs

    def samples(self) -> List[Sample]:
        out = []
        for db in self.imdbs:
            out.extend(db.samples())
        return out


class TestDB(Imdb):
    """Bare image list for inference (dataset/testdb.py)."""

    def __init__(self, images: Sequence[str]):
        super().__init__("test", [])
        self.images = list(images)

    def samples(self) -> List[Sample]:
        empty = SampleIndex.pad_label(np.zeros((0, 6), np.float32))
        return [Sample(p, empty.copy()) for p in self.images]


def load_index(root: str, split: str,
               classes: Optional[Sequence[str]] = None) -> SampleIndex:
    """Auto-detect the dataset layout under ``root`` and return the split.

    Packed record stores win: ``root`` may be a ``.drec`` file or a directory
    holding ``{split}.drec`` (see ``data/record.py``).

    ``classes`` sets the name->id table for XML-backed layouts (the
    reference threads cfg class names into every imdb —
    dataset/pascal_voc.py:41); None keeps each layout's default
    (VOC 20 / Cityscapes-det 8). Record stores carry numeric ids fixed at
    pack time, so ``classes`` does not apply there."""
    if not root:
        raise ValueError("--dataset-root (or --synthetic) required")
    from dspnet_torch.data import record

    rec_prefix = record.record_prefix_at(root, split)
    if rec_prefix is not None:
        return record.load_record_index(rec_prefix)
    if os.path.exists(os.path.join(root, "ImageSets", "Main", split + ".txt")):
        if os.path.isdir(os.path.join(root, "SegmentationClass")):
            return CityscapesDetSeg(
                split, root,
                **({"classes": classes} if classes else {})).index()
        # VOC layout rooted HERE: root is .../VOC{year} itself — PascalVoc
        # joins root+VOC{year}, so hand it the parent (the old
        # PascalVoc(split, "", root) fallback silently required a root/VOC
        # nesting that contradicted the ImageSets check above)
        head, tail = os.path.split(os.path.abspath(root).rstrip(os.sep))
        if tail.startswith("VOC"):
            return PascalVoc(split, tail[3:], head,
                             **({"classes": classes} if classes else {})).index()
    # devkit root: a VOC{year}/ child holding the split (synthetic.
    # build_voc_dataset writes this layout; so does the real VOCdevkit)
    if os.path.isdir(root):
        for d in sorted(os.listdir(root)):
            if d.startswith("VOC") and os.path.exists(
                    os.path.join(root, d, "ImageSets", "Main", split + ".txt")):
                return PascalVoc(split, d[3:], root,
                                 **({"classes": classes} if classes else {})).index()
    raise FileNotFoundError(f"no recognizable dataset at {root} (split {split})")
