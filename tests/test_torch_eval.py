"""The evaluation slice of the PyTorch port vs the JAX package, on the CPU:
the metric classes on the same updates, the confusion matrix on the device,
and ``evaluate_model`` of both packages over one stub detector."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cv2

from dspnet_tpu.evaluate import cityscapes_eval as jce
from dspnet_tpu.evaluate import eval_metric as jm
from dspnet_tpu.evaluate import instance_eval as jie
from dspnet_tpu.evaluate.loop import evaluate_model as jax_evaluate_model
from dspnet_torch.data import synthetic
from dspnet_torch.data.cs_labels import DET_CLASSES, SEG_CLASSES, name2label
from dspnet_torch.data.device_pipeline import DeviceAugIterator
from dspnet_torch.evaluate import cityscapes_eval, eval_metric, instance_eval
from dspnet_torch.evaluate.loop import evaluate_model

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores


def _boxes(rng, n):
    x1, y1 = rng.uniform(0, 0.8, (2, n))
    return np.stack([x1, y1, x1 + rng.uniform(0.02, 0.3, n), y1 + rng.uniform(0.02, 0.3, n)], 1)


def _det_updates(rng, n_images=6, C=8):
    """Per-image GT rows (with a difficult flag) and predictions: jittered
    copies of GTs, duplicates, wrong classes, false positives, -1 rows."""
    labels, preds = [], []
    for _ in range(n_images):
        n = rng.randint(0, 7)
        gt = np.concatenate([rng.randint(0, C, (n, 1)), _boxes(rng, n), (rng.rand(n, 1) < 0.2)], 1)
        p = []
        for row in gt:
            if rng.rand() < 0.8:
                p.append([row[0], rng.rand(), *(row[1:5] + rng.normal(0, 0.02, 4))])
            if rng.rand() < 0.3:  # a duplicate
                p.append([row[0], rng.rand(), *row[1:5]])
        m = rng.randint(0, 4)
        p += [[c, s, *b] for c, s, b in zip(rng.randint(0, C, m), rng.rand(m), _boxes(rng, m))]
        p += [[-1, -1, -1, -1, -1, -1]]
        pred = np.asarray(p, np.float64).reshape(-1, 6)
        labels.append(gt.astype(np.float32))
        preds.append(pred[np.argsort(-pred[:, 1], kind="stable")].astype(np.float32))
    return labels, preds


def _same(a, b):
    assert list(a.keys()) == list(b.keys())
    for k in a:
        if isinstance(a[k], float) and np.isnan(a[k]):
            assert np.isnan(b[k]), k
        else:
            assert a[k] == b[k], (k, a[k], b[k])


@pytest.mark.parametrize("cls", ["MApMetric", "VOC07MApMetric"])
@pytest.mark.parametrize("use_difficult", [False, True])
@pytest.mark.parametrize("named", [False, True])
def test_map_metrics_match_jax(rng, cls, use_difficult, named):
    names = list(DET_CLASSES) if named else None
    ours = getattr(eval_metric, cls)(0.5, use_difficult=use_difficult, class_names=names)
    ref = getattr(jm, cls)(0.5, use_difficult=use_difficult, class_names=names)
    for _ in range(3):
        labels, preds = _det_updates(rng)
        ours.update(labels, preds)
        ref.update(labels, preds)
    _same(ours.get_dict(), ref.get_dict())
    ours.reset()
    ref.reset()
    _same(ours.get_dict(), ref.get_dict())


def test_seg_metrics_match_jax(rng):
    """IoU and accuracy from per-pixel updates and from a confusion matrix,
    ignore pixels (255) and scores included."""
    iou, jiou = eval_metric.IoUMetric(SEG_CLASSES), jm.IoUMetric(SEG_CLASSES)
    ciou, jciou = eval_metric.IoUMetric(SEG_CLASSES), jm.IoUMetric(SEG_CLASSES)
    acc, jacc = eval_metric.CustomAccuracyMetric(), jm.CustomAccuracyMetric()
    cacc, jcacc = eval_metric.CustomAccuracyMetric(), jm.CustomAccuracyMetric()
    for _ in range(3):
        gt = rng.randint(0, 19, (2, 16, 32))
        gt[:, :3] = 255
        scores = rng.rand(2, 16, 32, 19).astype(np.float32)
        pred = scores.argmax(-1)
        iou.update(gt, scores)
        jiou.update(gt, scores)
        acc.update(gt, pred)
        jacc.update(gt, pred)
        conf = cityscapes_eval.add_to_confusion_matrix(pred, gt, np.zeros((256, 256), np.int64))
        ciou.update_from_confusion(conf)
        jciou.update_from_confusion(conf)
        cacc.update_from_confusion(conf)
        jcacc.update_from_confusion(conf)
    for a, b in ((iou, jiou), (ciou, jciou), (acc, jacc), (cacc, jcacc), (iou, ciou), (acc, cacc)):
        _same(a.get_dict(), b.get_dict())


def test_distance_metric_matches_jax(rng, tmp_path):
    ours, ref = eval_metric.DistanceAccuracyMetric(DET_CLASSES), jm.DistanceAccuracyMetric(DET_CLASSES)
    for _ in range(4):
        disp = rng.randint(0, 3000, (64, 128)).astype(np.uint16)
        disp[:8] = 0  # distance > 1000 -> 200 -> skipped
        n = 6
        det = np.concatenate([rng.randint(0, 8, (n, 1)), rng.rand(n, 1), _boxes(rng, n),
                              rng.rand(n, 1)], 1).astype(np.float32)
        det[2, 2:6] = [-0.3, -0.3, -0.1, -0.1]  # fully outside: skipped
        det[4, 2:6] = [0.5, 0.01, 0.5, 0.05]  # one column wide
        ours.update(disp, det)
        ref.update(disp, det)
    _same(ours.get_dict(), ref.get_dict())
    assert ours.errors == ref.errors
    ours.save_errors(str(tmp_path / "a.txt"))
    ref.save_errors(str(tmp_path / "b.txt"))
    assert open(tmp_path / "a.txt").read() == open(tmp_path / "b.txt").read()


def test_confusion_matrix_torch_matches_host_and_jax(rng):
    conf = torch.zeros(256, 256, dtype=torch.int64)
    host = np.zeros((256, 256), np.int64)
    jconf = jnp.zeros((256, 256), jnp.int32)
    for _ in range(3):
        gt = rng.randint(0, 256, (3, 20, 24)).astype(np.int32)
        pred = rng.randint(0, 256, (3, 20, 24)).astype(np.uint8)
        conf = cityscapes_eval.add_to_confusion_matrix_torch(torch.from_numpy(pred), torch.from_numpy(gt), conf)
        cityscapes_eval.add_to_confusion_matrix(pred, gt, host)
        jconf = jce.add_to_confusion_matrix_jax(jnp.asarray(pred), jnp.asarray(gt), jconf)
    assert conf.dtype == torch.int64
    np.testing.assert_array_equal(conf.numpy(), host)
    np.testing.assert_array_equal(conf.numpy(), np.asarray(jconf))
    np.testing.assert_array_equal(jce.add_to_confusion_matrix(pred, gt, np.zeros((256, 256), np.int64)),
                                  cityscapes_eval.add_to_confusion_matrix(pred, gt, np.zeros((256, 256), np.int64)))
    with pytest.raises(ValueError):
        cityscapes_eval.add_to_confusion_matrix_torch(torch.zeros(2, 3), torch.zeros(3, 2), conf)


# ------------------------------------------------------------- the loop


class _Stub:
    """A detector that answers every batch with fixed det rows and seg maps
    (made from a seed by its batch count), in the package's array type;
    with ``probs``, also seg probabilities whose argmax is the seg map."""

    def __init__(self, to_array, device=None, probs=False):
        self.to_array = to_array
        self.device = device
        self.probs = probs
        self.calls = 0

    def predict(self, images):
        rng = np.random.RandomState(self.calls)
        self.calls += 1
        B, H, W = images.shape[:3]
        det = np.full((B, 40, 7), -1.0, np.float32)
        for b in range(B):
            n = rng.randint(0, 30)
            det[b, :n] = np.concatenate([rng.randint(0, 8, (n, 1)), np.sort(rng.rand(n, 1))[::-1], _boxes(rng, n),
                                         rng.rand(n, 1)], 1)
        seg = rng.randint(0, 21, (B, H // 4, W // 4)).astype(np.uint8)
        out = {"det": self.to_array(det), "seg": self.to_array(seg)}
        if self.probs:
            p = rng.rand(B, H // 4, W // 4, 19).astype(np.float32)
            p /= p.sum(-1, keepdims=True)
            out["seg_prob"] = self.to_array(p)
            out["seg"] = self.to_array(p.argmax(-1).astype(np.uint8))
        return out


class _Batches:
    """An iterator with ``epoch()`` over a fixed list of (batch, fnames)."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self):
        return iter(self.batches)


@pytest.fixture(scope="module")
def val_batches(tmp_path_factory):
    """Two eval epochs' worth of batches from the port's pipeline over a
    synthetic dataset with disparity files (5 images, b2, the last padded)."""
    index = synthetic.build_dataset(str(tmp_path_factory.mktemp("val")), num_samples=5, hw=(64, 128), seed=91,
                                    with_instances=True)
    it = DeviceAugIterator(index, 2, (64, 128), device="cpu", seed=233, enable_aug=False, shuffle=False,
                           pad_last=True)
    batches = [({k: v.numpy() for k, v in b.items()}, n) for b, n in it.epoch()]
    batches[0][0]["seg_label"][0, :2] = -1  # a no-label fill, mapped to the ignore id
    return batches


def test_evaluate_model_matches_jax(val_batches, tmp_path):
    """Both loops over the same batches and the same stub answers: equal
    result dicts key for key (ms_per_batch aside, a wall clock), the same
    dist-errors file, and the same log lines apart from the timing."""
    logs, jlogs = [], []
    got = evaluate_model(_Stub(torch.from_numpy, torch.device("cpu")), _Batches(val_batches),
                         dist_errors_path=str(tmp_path / "a.txt"), log_fn=logs.append)
    want = jax_evaluate_model(_Stub(jnp.asarray), _Batches(val_batches),
                              dist_errors_path=str(tmp_path / "b.txt"), log_fn=jlogs.append)
    assert set(got) == set(want)
    for k in want:
        if k != "ms_per_batch":
            assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k
    assert {"mAP", "mIoU", "accuracy", "derror", "ap_car", "iou_road", "derror_car"} <= set(got)
    assert np.isfinite(got["derror"]) and got["ms_per_batch"] >= 0
    assert open(tmp_path / "a.txt").read() == open(tmp_path / "b.txt").read()
    assert logs[:4] == jlogs[:4]
    for depth in (0, 1, 4):  # the pipeline depth changes no result
        again = evaluate_model(_Stub(torch.from_numpy, torch.device("cpu")), _Batches(val_batches),
                               pipeline_depth=depth)
        assert all(again[k] == got[k] for k in ("mAP", "mIoU", "accuracy", "derror"))


@pytest.mark.parametrize("probs", [False, True])
def test_evaluate_model_rejects_what_is_not_ported(val_batches, tmp_path, probs):
    """``write_results`` and ``instance_eval``, once refused, now run: the
    same result PNGs as the JAX loop (nearest from the argmax map; from the
    probabilities by bilinear upsampling, equal outside the pixels whose top
    two upsampled probabilities lie within 1e-5), the same instance AP, the
    same results key for key."""
    stub = _Stub(torch.from_numpy, torch.device("cpu"), probs)
    got = evaluate_model(stub, _Batches(val_batches), write_results=str(tmp_path / "a"), instance_eval=True)
    replay = _Stub(np.asarray, probs=probs)  # the same answers again, for the near-tie masks
    probs_of = {}
    for batch, fnames in val_batches:
        res = replay.predict(batch["images"])
        for b, f in enumerate(fnames):
            probs_of[os.path.splitext(os.path.basename(f))[0] + "_pred.png"] = res.get("seg_prob", [None] * 2)[b]
    want = jax_evaluate_model(_Stub(jnp.asarray, probs=probs), _Batches(val_batches),
                              write_results=str(tmp_path / "b"), instance_eval=True)
    assert set(got) == set(want) and {"instAP", "instAP50", "inst_car"} <= set(got)
    for k in want:
        if k != "ms_per_batch":
            assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k
    assert np.isfinite(got["instAP"])
    names = sorted(os.listdir(tmp_path / "b"))
    assert sorted(os.listdir(tmp_path / "a")) == names and len(names) == 5
    for n in names:
        a = cv2.imread(str(tmp_path / "a" / n), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "b" / n), cv2.IMREAD_UNCHANGED)
        assert a.shape == (1024, 2048) and a.dtype == np.uint8
        if probs:
            assert not ((a != b) & ~_near_ties_f32(probs_of[n], (1024, 2048))).any(), n
        else:
            np.testing.assert_array_equal(a, b)


def _near_ties_f32(prob, hw, gap=1e-5):
    """As :func:`_near_ties`, in float32 through the port's upsampling (for
    full-resolution maps, where float64 would take gigabytes)."""
    up = cityscapes_eval.resize_bilinear_align_corners(torch.from_numpy(prob).permute(2, 0, 1)[None], hw)[0]
    top = up.topk(2, dim=0).values
    return ((top[0] - top[1]) < gap).numpy()


def _near_ties(prob, hw, gap=1e-5):
    """Pixels of the align-corners bilinear upsampling of ``prob`` (h, w, C)
    to ``hw`` whose two largest class values lie within ``gap`` (float64)."""
    h, w, _ = prob.shape
    ys = np.linspace(0, h - 1, hw[0])
    xs = np.linspace(0, w - 1, hw[1])
    y0, x0 = np.minimum(ys.astype(int), h - 2), np.minimum(xs.astype(int), w - 2)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    p = prob.astype(np.float64)
    out = np.empty(tuple(hw), bool)
    for r in range(0, hw[0], 128):  # 128 output rows at a time: bounded memory
        a, b, ry = y0[r:r + 128], y0[r:r + 128] + 1, fy[r:r + 128]
        up = ((1 - ry) * (1 - fx) * p[a][:, x0] + (1 - ry) * fx * p[a][:, x0 + 1]
              + ry * (1 - fx) * p[b][:, x0] + ry * fx * p[b][:, x0 + 1])
        top = np.sort(up, axis=-1)[..., -2:]
        out[r:r + 128] = (top[..., 1] - top[..., 0]) < gap
    return out


@pytest.mark.parametrize("full_hw", [(64, 128), (256, 512), (1024, 2048)])
def test_result_pngs_match_jax(rng, tmp_path, full_hw):
    """write_result_png(_from_probs) against the JAX writers on the same
    inputs: the nearest map equal; the probability map equal outside the
    pixels whose top two upsampled probabilities lie within 1e-5 (about
    0.1% of the pixels on these random probabilities: 7 of 8,192 at 64x128,
    160 of 131,072 at 256x512)."""
    seg = rng.randint(0, 22, (16, 32)).astype(np.uint8)
    prob = rng.rand(16, 32, 19).astype(np.float32)
    prob /= prob.sum(-1, keepdims=True)
    for name, ours, theirs, arg in (("nearest", cityscapes_eval.write_result_png, jce.write_result_png, seg),
                                    ("probs", cityscapes_eval.write_result_png_from_probs,
                                     jce.write_result_png_from_probs, prob)):
        a, b = str(tmp_path / f"a_{name}.png"), str(tmp_path / f"b_{name}.png")
        ours(torch.from_numpy(arg), a, full_hw)
        theirs(arg, b, full_hw)
        got, want = cv2.imread(a, cv2.IMREAD_UNCHANGED), cv2.imread(b, cv2.IMREAD_UNCHANGED)
        assert got.shape == tuple(full_hw) and got.dtype == np.uint8
        differ = got != want
        if name == "probs":
            ties = _near_ties(prob, full_hw)
            assert not (differ & ~ties).any(), int((differ & ~ties).sum())
            assert ties.mean() < 5e-3, int(ties.sum())
        else:
            assert not differ.any()


def _instance_case(rng, H=48, W=96):
    """An instanceIds map (car / person / rider instances, a car group
    region, void pixels, a tiny instance under the region size) and
    predictions: jittered copies of the instances, duplicates, false
    positives, over void."""
    gt = np.full((H, W), 7, np.int64)  # road
    gt[:4] = 0  # void
    preds = []
    for k in range(rng.randint(2, 6)):
        name = ["car", "person", "rider"][rng.randint(0, 3)]
        y1, x1 = rng.randint(4, H - 12), rng.randint(0, W - 16)
        y2, x2 = y1 + rng.randint(8, 12), x1 + rng.randint(10, 16)
        gt[y1:y2, x1:x2] = name2label[name].id * 1000 + k
        for _ in range(rng.randint(0, 3)):
            m = np.zeros((H, W), bool)
            dy, dx = rng.randint(-2, 3, 2)
            m[max(0, y1 + dy):y2 + dy, max(0, x1 + dx):x2 + dx] = True
            preds.append((m, name, float(rng.rand())))
    gt[H - 6:, :10] = name2label["car"].id  # a group region
    gt[H - 3:, W - 3:] = name2label["car"].id * 1000 + 99  # under the region size
    for _ in range(2):
        m = np.zeros((H, W), bool)
        y, x = rng.randint(0, H - 6), rng.randint(0, W - 6)
        m[y:y + 6, x:x + 6] = True
        preds.append((m, ["car", "person", "bicycle"][rng.randint(0, 3)], float(rng.rand())))
    m = np.zeros((H, W), bool)
    m[:5, 20:30] = True  # mostly void: ignored
    preds.append((m, "car", 0.5))
    return preds, gt


def test_instance_eval_matches_jax(rng):
    """The official instance AP and AP50 of both packages on the same
    predictions and instanceIds maps, to 1e-6 (mask tuples and bbox-local
    instances from boxes x seg), with the same instances derived."""
    names = list(DET_CLASSES)
    images = [_instance_case(rng) for _ in range(6)]
    got = instance_eval.evaluate_instances(images, names)
    want = jie.evaluate_instances(images, names)
    assert set(got) == set(want)
    for k in want:
        assert (np.isnan(got[k]) and np.isnan(want[k])) or abs(got[k] - want[k]) <= 1e-6, k
    assert np.isfinite(got["AP"]) and np.isfinite(got["AP50"])
    det_to_trainid = {i: name2label[n].trainId for i, n in enumerate(names)}
    acc, jacc = instance_eval.InstanceEvalAccumulator(names), jie.InstanceEvalAccumulator(names)
    for _, gt in images:
        n = 8
        x1, y1 = rng.uniform(0, 0.8, (2, n))
        dets = np.stack([rng.randint(-1, 8, n), rng.rand(n), x1, y1, x1 + rng.uniform(0.05, 0.3, n),
                         y1 + rng.uniform(0.05, 0.3, n), rng.rand(n)], 1).astype(np.float32)
        seg = rng.randint(10, 19, (12, 24)).astype(np.uint8)
        ours = instance_eval.boxes_and_seg_to_instances(dets, seg, det_to_trainid, names, gt.shape)
        theirs = jie.boxes_and_seg_to_instances(dets, seg, det_to_trainid, names, gt.shape)
        assert [(p.bbox, p.class_name, p.confidence) for p in ours] == \
            [(p.bbox, p.class_name, p.confidence) for p in theirs]
        for p, q in zip(ours, theirs):
            np.testing.assert_array_equal(p.mask, q.mask)
        acc.update(ours, gt)
        jacc.update(theirs, gt)
    a, b = acc.get(), jacc.get()
    for k in b:
        assert (np.isnan(a[k]) and np.isnan(b[k])) or abs(a[k] - b[k]) <= 1e-6, k
    assert instance_eval.official_ap_curve([1, 0, 1, 1], [0.9, 0.8, 0.3, 0.3], 2) == \
        jie.official_ap_curve([1, 0, 1, 1], [0.9, 0.8, 0.3, 0.3], 2)
    img = images[0][1]
    assert [(m.sum(), n) for m, n in instance_eval.decode_instance_png(img, instance_eval._ID2NAME, names)] == \
        [(m.sum(), n) for m, n in jie.decode_instance_png(img, jie._ID2NAME, names)]
