"""The evaluation slice of the PyTorch port vs the JAX package, on the CPU:
the metric classes on the same updates, the confusion matrix on the device,
and ``evaluate_model`` of both packages over one stub detector."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dspnet_tpu.evaluate import cityscapes_eval as jce
from dspnet_tpu.evaluate import eval_metric as jm
from dspnet_tpu.evaluate.loop import evaluate_model as jax_evaluate_model
from dspnet_torch.data import synthetic
from dspnet_torch.data.cs_labels import DET_CLASSES, SEG_CLASSES
from dspnet_torch.data.device_pipeline import DeviceAugIterator
from dspnet_torch.evaluate import cityscapes_eval, eval_metric
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
    (made from a seed by its batch count), in the package's array type."""

    def __init__(self, to_array, device=None):
        self.to_array = to_array
        self.device = device
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
        return {"det": self.to_array(det), "seg": self.to_array(seg)}


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
    index = synthetic.build_dataset(str(tmp_path_factory.mktemp("val")), num_samples=5, hw=(64, 128), seed=91)
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


def test_evaluate_model_rejects_what_is_not_ported(val_batches):
    stub = _Stub(torch.from_numpy, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="item 22"):
        evaluate_model(stub, _Batches(val_batches), write_results="out")
    with pytest.raises(NotImplementedError, match="item 22"):
        evaluate_model(stub, _Batches(val_batches), instance_eval=True)
