"""Offline file-based PASCAL VOC detection evaluation: a numpy copy of
``dspnet_tpu/evaluate/eval_voc.py`` (pinned by ``tests/test_torch_eval_voc.py``).

Capability parity with reference evaluate/eval_voc.py:1-179 (used by
dataset/pascal_voc.py:170-259): parse VOC XML annotations, match detections
per class at an IoU threshold, compute recall/precision and AP with either
the 07 11-point or the area-under-envelope metric.
"""

from __future__ import annotations

import functools
import os
import xml.etree.ElementTree as ET

import numpy as np


def parse_rec(xml_path: str):
    # cached keyed by (path, mtime): per-class voc_eval calls re-read the
    # same split's XMLs (the reference caches a pickle per split,
    # evaluate/eval_voc.py:81-95), and the mtime key prevents stale reads
    # when annotations are rewritten in place (e.g. inject_distances).
    # Callers must not mutate the returned list.
    return _parse_rec_cached(xml_path, os.path.getmtime(xml_path))


@functools.lru_cache(maxsize=8192)
def _parse_rec_cached(xml_path: str, _mtime: float):
    tree = ET.parse(xml_path)
    objects = []
    for obj in tree.findall("object"):
        bbox = obj.find("bndbox")
        diff = obj.find("difficult")
        objects.append(
            {
                "name": obj.find("name").text,
                "difficult": int(diff.text) if diff is not None else 0,
                "bbox": [
                    int(float(bbox.find("xmin").text)),
                    int(float(bbox.find("ymin").text)),
                    int(float(bbox.find("xmax").text)),
                    int(float(bbox.find("ymax").text)),
                ],
            }
        )
    return objects


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else float(np.max(prec[rec >= t]))
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def voc_eval(
    det_lines,
    anno_path_fmt: str,
    image_ids,
    classname: str,
    ovthresh: float = 0.5,
    use_07_metric: bool = False,
):
    """Evaluate one class.

    Args:
      det_lines: iterable of (image_id, score, x1, y1, x2, y2) detections of
        ``classname`` (the content of a VOC results file).
      anno_path_fmt: format string for annotation XMLs, e.g.
        '{root}/Annotations/{}.xml' with one positional slot.
      image_ids: all image ids of the split.

    Returns (recall, precision, ap).
    """
    recs = {iid: parse_rec(anno_path_fmt.format(iid)) for iid in image_ids}
    class_recs = {}
    npos = 0
    for iid in image_ids:
        objs = [o for o in recs[iid] if o["name"] == classname]
        bbox = np.array([o["bbox"] for o in objs], float)
        difficult = np.array([o["difficult"] for o in objs]).astype(bool)
        npos += int(np.sum(~difficult))
        class_recs[iid] = {"bbox": bbox, "difficult": difficult, "det": [False] * len(objs)}

    det_lines = list(det_lines)
    if not det_lines:
        return np.array([]), np.array([]), 0.0
    image_ids_det = [d[0] for d in det_lines]
    confidence = np.array([float(d[1]) for d in det_lines])
    bb = np.array([[float(v) for v in d[2:6]] for d in det_lines])
    order = np.argsort(-confidence)
    image_ids_det = [image_ids_det[i] for i in order]
    bb = bb[order]

    nd = len(image_ids_det)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        r = class_recs.get(image_ids_det[d])
        if r is None:
            fp[d] = 1.0
            continue
        bbgt = r["bbox"]
        ovmax, jmax = -np.inf, -1
        if bbgt.size > 0:
            ixmin = np.maximum(bbgt[:, 0], bb[d, 0])
            iymin = np.maximum(bbgt[:, 1], bb[d, 1])
            ixmax = np.minimum(bbgt[:, 2], bb[d, 2])
            iymax = np.minimum(bbgt[:, 3], bb[d, 3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inters = iw * ih
            uni = (
                (bb[d, 2] - bb[d, 0] + 1.0) * (bb[d, 3] - bb[d, 1] + 1.0)
                + (bbgt[:, 2] - bbgt[:, 0] + 1.0) * (bbgt[:, 3] - bbgt[:, 1] + 1.0)
                - inters
            )
            overlaps = inters / uni
            jmax = int(np.argmax(overlaps))
            ovmax = overlaps[jmax]
        if ovmax > ovthresh:
            if not r["difficult"][jmax]:
                if not r["det"][jmax]:
                    tp[d] = 1.0
                    r["det"][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)
