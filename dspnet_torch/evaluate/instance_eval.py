"""Instance-level segmentation evaluation, official Cityscapes AP (a numpy
copy of ``dspnet_tpu/evaluate/instance_eval.py``; ``tests/test_torch_eval.py``
holds the two to the same APs).

Re-implements the scoring of the reference's vendored official script
(data/cityscapes/Scripts/evaluation/evalInstanceLevelSemanticLabeling.py)
with its EXACT semantics — not a VOC-style approximation.  Per that script:

* GT instances come from an ``instanceIds`` image: every pixel value is an
  instance; values >= 1000 encode ``labelId*1000 + index`` (real instances),
  values < 1000 are the bare labelId (group regions, e.g. a "car" crowd)
  (instance.py:22-26, instances2dict.py:36-39).
* Matching intersects every prediction with every same-label GT region,
  group or not (evalInstanceLevelSemanticLabeling.py:327-343).  A GT
  counts toward AP only when ``instID >= 1000`` and ``pixelCount >=
  minRegionSize`` (:412); matching requires overlap STRICTLY > the
  threshold (:428).  When several predictions clear the threshold on one
  GT, the highest confidence wins and the rest become false positives
  (:434-446); a GT with intersecting-but-under-threshold predictions is a
  "hard" false negative (:448-449).
* An unmatched prediction is IGNORED (not a false positive) when the
  proportion of its pixels lying on void labels, group regions, or
  filtered-small GT instances exceeds the overlap threshold (:463-476).
* The AP curve is the official step-wise integration over unique score
  thresholds with an artificial (r=0, p=1) point — a convolution
  [-0.5, 0, 0.5] over recall gives step widths, AP = precision . widths
  (:486-539) — NOT the VOC precision envelope.
* Averages: per-class AP = mean over overlaps 0.5:0.05:0.95; AP50 = the
  0.5 column; dataset AP = nanmean over classes (:549-575).  A class with
  GT but no predictions anywhere scores 0; a class with no GT is NaN and
  excluded from the mean (:541-544).

The JAX package's ``tests/test_instance_official.py`` cross-runs its module
against the vendored official script on identical PNG inputs.

Streaming: :class:`InstanceEvalAccumulator` folds each image into per
(class, overlap) score vectors immediately, so whole-dataset mask sets
never sit in memory (real Cityscapes val would otherwise hold tens of GB
of full-resolution boolean masks).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from dspnet_torch.data import image_io
from dspnet_torch.data.cs_labels import labels, name2label

OVERLAPS = np.arange(0.5, 1.0, 0.05)
# minimum GT region size in pixels (evalInstanceLevelSemanticLabeling.py:131;
# only the first entry applies when stereo distances are unavailable, :381-385)
MIN_REGION_SIZE = 100

VOID_IDS = np.array([l.id for l in labels if l.ignoreInEval], np.int64)
_ID2NAME = {l.id: l.name for l in labels}


class PredInstance:
    """Bbox-local predicted instance: ``mask`` covers only ``bbox`` =
    (y0, y1, x0, x1) in image coordinates (pixels outside are implicitly
    False). Avoids materializing full-resolution boolean masks per
    detection — the instance-eval host path's dominant cost at raw
    Cityscapes resolution."""

    __slots__ = ("bbox", "mask", "class_name", "confidence")

    def __init__(self, bbox, mask, class_name, confidence):
        self.bbox = bbox
        self.mask = mask
        self.class_name = class_name
        self.confidence = float(confidence)

    def full_mask(self, hw) -> np.ndarray:
        """Materialize the full-image mask (tests / visualization)."""
        out = np.zeros(hw, bool)
        y0, y1, x0, x1 = self.bbox
        out[y0:y1, x0:x1] = self.mask
        return out


def decode_instance_png(inst_img: np.ndarray, id2name: Dict[int, str],
                        has_instances: Sequence[str]) -> List[Tuple[np.ndarray, str]]:
    """Cityscapes instanceIds image -> [(mask, class_name)] of REAL instances
    (value >= 1000, encoding labelId*1000 + index; instance.py:22-26).

    Convenience for visualization/debugging; the accumulator consumes the
    raw instanceIds array itself because scoring also needs group regions
    and the void mask.
    """
    out = []
    for val in np.unique(inst_img):
        if val < 1000:
            continue
        name = id2name.get(int(val) // 1000)
        if name is None or name not in has_instances:
            continue
        out.append((inst_img == val, name))
    return out


def official_ap_curve(y_true: np.ndarray, y_score: np.ndarray,
                      hard_fns: int) -> float:
    """The official AP integration (evalInstanceLevelSemanticLabeling.py:
    486-539): step-wise integration over unique ascending score thresholds,
    with an artificial (recall 0, precision 1) end point."""
    y_true = np.asarray(y_true, np.float64)
    y_score = np.asarray(y_score, np.float64)
    order = np.argsort(y_score)  # ascending
    y_score = y_score[order]
    y_true_cum = np.cumsum(y_true[order])

    thresholds, unique_idx = np.unique(y_score, return_index=True)
    n = len(unique_idx) + 1
    nb_examples = len(y_score)
    nb_true = y_true_cum[-1] if nb_examples else 0.0
    precision = np.zeros(n)
    recall = np.zeros(n)
    # index -1 must read 0 (the artificial first point, :509-511)
    y_true_cum = np.append(y_true_cum, 0.0)
    for res_i, score_i in enumerate(unique_idx):
        cum = y_true_cum[score_i - 1]
        tp = nb_true - cum
        fp = nb_examples - score_i - tp
        fn = cum + hard_fns
        precision[res_i] = tp / (tp + fp)
        recall[res_i] = tp / (tp + fn)
    precision[-1] = 1.0
    recall[-1] = 0.0
    r = np.concatenate(([recall[0]], recall, [0.0]))
    step_widths = np.convolve(r, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths))


class InstanceEvalAccumulator:
    """Streaming official instance-level AP over (preds, instanceIds) images.

    ``update(preds, inst_img)``: ``preds`` is ``[(mask (H,W) bool,
    class_name, confidence)]``; ``inst_img`` the raw GT instanceIds array.
    """

    def __init__(self, class_names: Sequence[str],
                 min_region_size: int = MIN_REGION_SIZE):
        # evaluated labels: hasInstances and not ignoreInEval (:152-156),
        # restricted to the caller's class set (the det head's 8 classes)
        self.class_names = [
            c for c in class_names
            if c in name2label and name2label[c].hasInstances
            and not name2label[c].ignoreInEval
        ]
        self.min_region_size = min_region_size
        nt = len(OVERLAPS)
        self._y_true = {c: [[] for _ in range(nt)] for c in self.class_names}
        self._y_score = {c: [[] for _ in range(nt)] for c in self.class_names}
        self._hard_fns = {c: np.zeros(nt, np.int64) for c in self.class_names}
        self._have_gt = {c: False for c in self.class_names}
        self._have_pred = {c: False for c in self.class_names}
        self.num_images = 0

    def update(self, preds, inst_img: np.ndarray) -> None:
        """``preds`` items are either ``(mask (H,W) bool, class_name,
        confidence)`` or the bbox-local :class:`PredInstance` that
        :func:`boxes_and_seg_to_instances` emits. All mask arithmetic is
        restricted to bounding boxes — identical set intersections, so the
        scores are bit-identical to the full-image formulation, but each
        pred x GT pair costs O(overlap-box) instead of O(image): ~10x less
        host time per full-res Cityscapes image."""
        self.num_images += 1
        inst_img = np.asarray(inst_img)
        H, W = inst_img.shape

        # one labeling pass: compact ids + counts + per-id bounding boxes
        # (two small bincounts instead of a full-image `== val` scan per
        # region; the official script's per-value masks are O(values * HW))
        vals, inv = np.unique(inst_img, return_inverse=True)
        inv = inv.reshape(-1).astype(np.int64)  # numpy>=2 returns 2-D inverse
        inv2 = inv.reshape(H, W)
        counts = np.bincount(inv, minlength=len(vals))
        n = len(vals)
        ys = np.repeat(np.arange(H, dtype=np.int64), W)
        xs = np.tile(np.arange(W, dtype=np.int64), H)
        row_any = np.bincount(inv * H + ys, minlength=n * H).reshape(n, H) > 0
        col_any = np.bincount(inv * W + xs, minlength=n * W).reshape(n, W) > 0
        y0s = row_any.argmax(1)
        y1s = H - row_any[:, ::-1].argmax(1)
        x0s = col_any.argmax(1)
        x1s = W - col_any[:, ::-1].argmax(1)
        # value-level void lookup: VOID_IDS are bare label ids (< 1000), so
        # np.isin(inst_img, VOID_IDS) == is_void_val[inv2] elementwise
        is_void_val = np.isin(vals, VOID_IDS)

        # GT regions per evaluated label — groups (instID < 1000) included,
        # they matter for the FP-ignore rule (instances2dict.py:36-39)
        gts: Dict[str, List[dict]] = {c: [] for c in self.class_names}
        for vi, val in enumerate(vals):
            label_id = int(val) if val < 1000 else int(val) // 1000
            name = _ID2NAME.get(label_id)
            if name not in gts:
                continue
            y0, y1, x0, x1 = int(y0s[vi]), int(y1s[vi]), int(x0s[vi]), int(x1s[vi])
            gts[name].append({
                "instID": int(val),
                "pixelCount": int(counts[vi]),
                "bbox": (y0, y1, x0, x1),
                "mask": inv2[y0:y1, x0:x1] == vi,  # bbox-local
                "matchedPred": [],
            })

        # prediction instances + their intersections with same-label GT
        # (evalInstanceLevelSemanticLabeling.py:284-349)
        pred_insts: Dict[str, List[dict]] = {c: [] for c in self.class_names}
        for item in preds:
            if isinstance(item, PredInstance):
                cname, conf = item.class_name, item.confidence
                bbox, mask = item.bbox, np.asarray(item.mask, bool)
            else:
                mask, cname, conf = item
                mask = np.asarray(mask, bool)
                ys_nz, xs_nz = np.nonzero(mask)
                if ys_nz.size == 0:
                    continue
                bbox = (int(ys_nz.min()), int(ys_nz.max()) + 1,
                        int(xs_nz.min()), int(xs_nz.max()) + 1)
                mask = mask[bbox[0]:bbox[1], bbox[2]:bbox[3]]
            if cname not in pred_insts:
                continue
            pix = int(mask.sum())
            if pix == 0:
                continue
            py0, py1, px0, px1 = bbox
            void_local = is_void_val[inv2[py0:py1, px0:px1]]
            p = {
                "pixelCount": pix,
                "confidence": float(conf),
                "voidIntersection": int(np.logical_and(void_local, mask).sum()),
                "matchedGt": [],
            }
            for gt in gts[cname]:
                gy0, gy1, gx0, gx1 = gt["bbox"]
                oy0, oy1 = max(py0, gy0), min(py1, gy1)
                ox0, ox1 = max(px0, gx0), min(px1, gx1)
                if oy0 >= oy1 or ox0 >= ox1:
                    continue
                inter = int(np.logical_and(
                    mask[oy0 - py0:oy1 - py0, ox0 - px0:ox1 - px0],
                    gt["mask"][oy0 - gy0:oy1 - gy0, ox0 - gx0:ox1 - gx0],
                ).sum())
                if inter > 0:
                    p["matchedGt"].append({"gt": gt, "intersection": inter})
                    gt["matchedPred"].append(
                        {"pred": p, "intersection": inter})
            pred_insts[cname].append(p)

        for cname in self.class_names:
            # filter groups and too-small instances from the scored GT set
            # (:412; medDist/distConf pass trivially without stereo data)
            scored_gts = [g for g in gts[cname]
                          if g["instID"] >= 1000
                          and g["pixelCount"] >= self.min_region_size]
            if scored_gts:
                self._have_gt[cname] = True
            if pred_insts[cname]:
                self._have_pred[cname] = True

            for ti, t in enumerate(OVERLAPS):
                cur_true: List[float] = []
                cur_score: List[float] = []
                for gt in scored_gts:
                    found = False
                    best = -np.inf
                    for m in gt["matchedPred"]:
                        p = m["pred"]
                        ov = m["intersection"] / (
                            gt["pixelCount"] + p["pixelCount"]
                            - m["intersection"])
                        if ov > t:
                            conf = p["confidence"]
                            if found:
                                # second+ match: lower confidence becomes an
                                # extra false positive (:434-441)
                                hi, lo = max(best, conf), min(best, conf)
                                best = hi
                                cur_true.append(0.0)
                                cur_score.append(lo)
                            else:
                                found = True
                                best = conf
                    if found:
                        cur_true.append(1.0)
                        cur_score.append(best)
                    else:
                        self._hard_fns[cname][ti] += 1
                for p in pred_insts[cname]:
                    found_gt = any(
                        m["intersection"] / (m["gt"]["pixelCount"]
                                             + p["pixelCount"]
                                             - m["intersection"]) > t
                        for m in p["matchedGt"])
                    if found_gt:
                        continue
                    # ignore the FP when it mostly covers void, group, or
                    # filtered-small GT pixels (:463-476)
                    n_ignore = p["voidIntersection"]
                    for m in p["matchedGt"]:
                        g = m["gt"]
                        if g["instID"] < 1000:
                            n_ignore += m["intersection"]
                        if g["pixelCount"] < self.min_region_size:
                            n_ignore += m["intersection"]
                    if n_ignore / p["pixelCount"] <= t:
                        cur_true.append(0.0)
                        cur_score.append(p["confidence"])
                self._y_true[cname][ti].extend(cur_true)
                self._y_score[cname][ti].extend(cur_score)

    def ap_matrix(self) -> np.ndarray:
        """(num_classes, num_overlaps) AP matrix (the official
        ``ap[dInf]`` slice, :395-545)."""
        mat = np.full((len(self.class_names), len(OVERLAPS)), np.nan)
        for ci, c in enumerate(self.class_names):
            for ti in range(len(OVERLAPS)):
                if self._have_gt[c] and self._have_pred[c]:
                    mat[ci, ti] = official_ap_curve(
                        self._y_true[c][ti], self._y_score[c][ti],
                        int(self._hard_fns[c][ti]))
                elif self._have_gt[c]:
                    mat[ci, ti] = 0.0
        return mat

    def get(self) -> Dict[str, float]:
        mat = self.ap_matrix()
        results: Dict[str, float] = {}
        for ci, c in enumerate(self.class_names):
            results[c] = float(np.mean(mat[ci]))  # nan iff class has no GT
        import warnings

        with warnings.catch_warnings():
            # nanmean of an all-NaN dataset (no GT at all) is NaN, silently
            warnings.simplefilter("ignore", RuntimeWarning)
            results["AP"] = float(np.nanmean(mat))
            results["AP50"] = float(np.nanmean(mat[:, 0]))
        return results


def evaluate_instances(
    images: Iterable[Tuple[List, np.ndarray]], class_names: Sequence[str],
    min_region_size: int = MIN_REGION_SIZE,
) -> Dict[str, float]:
    """images: iterable of (preds, inst_img) per image. Returns {class: AP}
    + 'AP' (nanmean over classes of the overlap-mean) and 'AP50'."""
    acc = InstanceEvalAccumulator(class_names, min_region_size)
    for preds, inst_img in images:
        acc.update(preds, inst_img)
    return acc.get()


def boxes_and_seg_to_instances(
    dets: np.ndarray,
    seg: np.ndarray,
    det_class_to_seg_trainid: Dict[int, int],
    det_class_names: Sequence[str],
    hw: Tuple[int, int],
):
    """Derive instance masks from DSPNet outputs: each detection contributes
    the pixels of its box whose seg prediction matches the class.

    dets: (n, 7) rows [cls, score, x1, y1, x2, y2, dist] normalized;
    seg: (H', W') trainId map (resized to ``hw`` here).

    Returns bbox-local :class:`PredInstance` objects — no full-resolution
    mask is ever allocated (each box's region slice only), and the
    accumulator intersects them bbox-locally too. The seg map is resized
    with nearest sampling by index arithmetic (cv2 ``INTER_NEAREST``'s floor
    rule, ``image_io.resize_nearest``).
    """
    H, W = hw
    seg_full = image_io.resize_nearest(np.asarray(seg).astype(np.uint8), (H, W))
    out = []
    for row in np.asarray(dets):
        cid = int(row[0])
        if cid < 0:
            continue
        tid = det_class_to_seg_trainid.get(cid)
        if tid is None:
            continue
        x1, y1 = max(0, int(row[2] * W)), max(0, int(row[3] * H))
        x2, y2 = min(W, int(row[4] * W)), min(H, int(row[5] * H))
        if x2 <= x1 or y2 <= y1:
            continue
        region = seg_full[y1:y2, x1:x2] == tid
        if not region.any():
            region = np.ones((y2 - y1, x2 - x1), bool)  # fall back to the box
        out.append(PredInstance((y1, y2, x1, x2), region,
                                det_class_names[cid], float(row[1])))
    return out
