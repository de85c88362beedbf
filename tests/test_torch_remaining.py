"""The last public names of the JAX package in the port, and its run
scripts: the standalone NMS (``ops/nms.py``) against ``dspnet_tpu/ops/nms.py``,
``MultiBoxMetric``, ``corner_to_center``, ``save_params_only`` /
``load_params_only``, ``timed`` / ``timed_train_steps``, each
``dspnet_torch.bench`` mode small on the CPU, ``dspnet_torch/scripts/
run_multi.sh`` train -> eval -> demo and ``make_scale_dataset.py``, and the
new modules' imports."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dspnet_tpu.evaluate.eval_metric import MultiBoxMetric as JaxMultiBoxMetric
from dspnet_tpu.ops import boxes as jboxes
from dspnet_tpu.ops import nms as jnms
from dspnet_torch import bench
from dspnet_torch.api import create_model
from dspnet_torch.data import imdb, record
from dspnet_torch.evaluate.eval_metric import MultiBoxMetric
from dspnet_torch.ops import boxes, nms
from dspnet_torch.train.solver import MultiTaskSolver
from dspnet_torch.utils.benchmark import batch_to_device, canonical_train_batch, timed, timed_train_steps
from dspnet_torch.utils.checkpoint import load_params_only, save_params_only
from tests.torch_parity import write_cityscapes_layout

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "dspnet_torch", "scripts")


def _random_corners(rng, n):
    """``tests/test_ops.py``'s boxes."""
    cx = rng.uniform(0.05, 0.95, n)
    cy = rng.uniform(0.05, 0.95, n)
    w = rng.uniform(0.02, 0.5, n)
    h = rng.uniform(0.02, 0.5, n)
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


def _dets(seed, n=40, tied=False):
    rng = np.random.RandomState(seed)
    b = _random_corners(rng, n) * 100
    scores = rng.permutation(n).astype(np.float32) / n
    if tied:
        scores = (rng.randint(0, 4, n) / 4).astype(np.float32)
    return np.concatenate([b, scores[:, None]], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [233, 1, 2])
@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.7])
def test_nms_and_nms_keep_equal_jax(seed, thresh):
    """``tests/test_ops.py``'s inputs (distinct scores): the kept indices equal
    the JAX ``nms``'s in order, and the mask equals ``nms_jax``'s."""
    dets = _dets(seed)
    assert nms.nms(dets, thresh) == jnms.nms(dets, thresh)
    keep = nms.nms_keep(torch.from_numpy(dets), thresh)
    assert keep.dtype == torch.bool and keep.shape == (40,)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jnms.nms_jax(dets, thresh)))
    assert sorted(nms.nms(dets, thresh)) == np.nonzero(keep.numpy())[0].tolist()


def test_nms_exact_threshold_and_ties():
    """A pair overlapping exactly at the threshold is kept (suppression is
    strictly above it); tied scores go to the higher original index in
    ``nms_keep``, as in ``nms_jax``; an empty input keeps nothing."""
    # two 10x10 boxes (the +1 areas 100 each), intersection 50: IoU 1/3
    dets = np.array([[0, 0, 9, 9, 0.9], [0, 5, 9, 14, 0.8]], np.float32)
    iou = 50.0 / 150.0
    for thresh in (iou, np.nextafter(np.float32(iou), np.float32(1))):
        assert nms.nms(dets, float(thresh)) == jnms.nms(dets, float(thresh)) == [0, 1]
        np.testing.assert_array_equal(nms.nms_keep(dets, float(thresh)).numpy(), [True, True])
    assert nms.nms(dets, 0.3) == jnms.nms(dets, 0.3) == [0]
    for seed in (3, 4):
        tied = _dets(seed, tied=True)
        np.testing.assert_array_equal(nms.nms_keep(tied, 0.4).numpy(), np.asarray(jnms.nms_jax(tied, 0.4)))
    same = np.array([[0, 0, 9, 9, 0.5], [0, 0, 9, 9, 0.5]], np.float32)
    np.testing.assert_array_equal(nms.nms_keep(same, 0.5).numpy(), [False, True])
    np.testing.assert_array_equal(np.asarray(jnms.nms_jax(same, 0.5)), [False, True])
    assert nms.nms(np.zeros((0, 5), np.float32), 0.5) == []


def test_bbox_overlaps_equals_jax():
    rng = np.random.RandomState(233)
    a, b = _random_corners(rng, 12) * 50, _random_corners(rng, 7) * 50
    got = nms.bbox_overlaps(a, b)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jnms.bbox_overlaps(a, b))
    # the asymmetry: touching boxes (intersection 0 in one axis) count 0
    touch = np.array([[0, 0, 4, 4]], np.float64), np.array([[5, 0, 9, 4]], np.float64)
    np.testing.assert_array_equal(nms.bbox_overlaps(*touch), jnms.bbox_overlaps(*touch))


def test_multibox_metric_equals_jax():
    rng = np.random.RandomState(5)
    got, want = MultiBoxMetric(), JaxMultiBoxMetric()
    for _ in range(3):
        prob = rng.rand(2, 9, 50).astype(np.float32)
        prob /= prob.sum(1, keepdims=True)
        loc = rng.rand(2, 200).astype(np.float32)
        label = rng.randint(-1, 9, (2, 50)).astype(np.float32)
        want.update(prob, loc, label)
        got.update(torch.from_numpy(prob), torch.from_numpy(loc), label)
    assert got.get() == want.get()
    assert got.get_dict() == dict(zip(*want.get()))
    got.reset()
    assert all(np.isnan(v) for v in got.get()[1])


def test_corner_to_center_equals_jax():
    b = _random_corners(np.random.RandomState(6), 20).reshape(4, 5, 4)
    np.testing.assert_array_equal(boxes.corner_to_center(torch.from_numpy(b)).numpy(),
                                  np.asarray(jboxes.corner_to_center(b)))


def test_params_only_round_trip(tmp_path):
    """A module's parameters and buffers, or a solver state's, saved and
    loaded strictly into a module of another seed: equal bit for bit; a
    module of another architecture is refused."""
    hw = (128, 256)
    src = create_model("resnet-18_multi", hw, device="cpu", generator=torch.Generator().manual_seed(1)).model
    dst = create_model("resnet-18_multi", hw, device="cpu", generator=torch.Generator().manual_seed(2)).model
    path = save_params_only(str(tmp_path / "d" / "params.pt"), src)
    assert load_params_only(path, dst) is dst
    for (k, a), b in zip(src.state_dict().items(), dst.state_dict().values()):
        assert torch.equal(a, b), k
    solver = MultiTaskSolver(src, np.zeros((1, 4), np.float32), device="cpu")
    state = solver.init_state()
    path2 = save_params_only(str(tmp_path / "state.pt"), state.params, state.buffers)
    other = create_model("resnet-18_multi", hw, device="cpu", generator=torch.Generator().manual_seed(3)).model
    load_params_only(path2, other)
    for k, v in state.params.items():
        assert torch.equal(other.state_dict()[k], v), k
    with pytest.raises(RuntimeError):
        load_params_only(path, create_model("resnet-18_det", hw, device="cpu").model)


def test_timed_and_timed_train_steps():
    """``timed`` runs warm-up + n calls and returns a positive mean;
    ``timed_train_steps`` chains the state through warm-up + n steps."""
    calls = []

    def fn(x):
        calls.append(1)
        return (x * 2).sum()

    dt = timed(fn, torch.ones(8), n=4, warmup=2)
    assert dt > 0 and len(calls) == 6
    hw = (128, 256)
    bundle = create_model("resnet-18_multi", hw, device="cpu", generator=torch.Generator().manual_seed(0))
    solver = MultiTaskSolver(bundle.model, bundle.anchors, batch_size=2, device="cpu")
    state = solver.init_state()
    batch = batch_to_device(canonical_train_batch(2, *hw), "cpu")
    state, dt = timed_train_steps(solver, state, batch, n=2, warmup=1)
    assert dt > 0 and state.step == 3


JAX_KEYS = {
    "": ("multitask_inference_throughput_512x512", {"metric", "value", "unit", "vs_baseline", "seg_head"}),
    "BENCH_SEG_FAST": ("multitask_inference_throughput_512x512",
                       {"metric", "value", "unit", "vs_baseline", "seg_head"}),
    "BENCH_TRAIN": ("multitask_train_step_512x1024_b8_bf16",
                    {"metric", "value", "unit", "vs_baseline", "ms_per_step", "est_mfu", "b4_ms_per_step",
                     "b4_img_per_s"}),
    "BENCH_SERVE": ("serving_latency_512x1024_b1",
                    {"metric", "value", "unit", "vs_baseline", "sync_ms", "pipelined_ms", "device_resident_ms"}),
}
SMALL = {
    "": dict(network="resnet-18_multi", batch=2, hw=(128, 256), device="cpu", iters=2),
    "BENCH_SEG_FAST": dict(network="resnet-18_multi", batch=2, hw=(128, 256), device="cpu", iters=2),
    "BENCH_TRAIN": dict(network="resnet-18_multi", hw=(128, 256), batches=(2, 4), device="cpu", n=1, warmup=1),
    "BENCH_SERVE": dict(network="resnet-18_multi", hw=(128, 256), device="cpu", n=2),
}


@pytest.mark.parametrize("mode", sorted(JAX_KEYS))
def test_bench_modes_print_one_json_line(mode, monkeypatch, capsys):
    """Each mode, small on the CPU, prints one JSON line with the JAX bench's
    metric name and keys, ``vs_baseline`` null."""
    for var in ("BENCH_TRAIN", "BENCH_SERVE", "BENCH_SEG_FAST"):
        monkeypatch.delenv(var, raising=False)
    if mode:
        monkeypatch.setenv(mode, "1")
    out = bench.main([], **SMALL[mode])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row == out
    metric, keys = JAX_KEYS[mode]
    assert row["metric"] == metric and set(row) == keys
    assert row["vs_baseline"] is None
    assert all(row[k] > 0 for k in keys - {"metric", "unit", "vs_baseline", "seg_head"})
    if "seg_head" in row:
        assert row["seg_head"] == ("fast_variant" if mode == "BENCH_SEG_FAST" else "reference_exact")


def _run(cmd, cwd, env=None, timeout=600):
    env = dict(os.environ, **(env or {}))
    env.pop("LOADER", None)
    env["OMP_NUM_THREADS"] = "2"
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)


def test_run_multi_train_eval_demo(tmp_path):
    """``run_multi.sh train`` (``LOADER`` unset: the native loader) then
    ``eval`` then ``demo``, each with the CPU, a small network and shape,
    one epoch and a tiny prepared layout appended; each exits 0 and leaves
    its checkpoint, metrics and picture."""
    write_cityscapes_layout(str(tmp_path / "cs"), {"train": 2, "val": 2}, hw=(128, 256))
    small = ["--device", "cpu", "--network", "resnet-18_multi", "--data-shape", "3,128,256"]
    data = ["--dataset-root", str(tmp_path / "cs"), "--model-dir", str(tmp_path / "m")]
    script = os.path.join(SCRIPTS, "run_multi.sh")
    env = {"PYTHON": sys.executable}
    r = _run([script, "train", "multi", *small, *data, "--end-epoch", "1", "--batch-size", "2"], tmp_path, env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "using the native loader" in r.stderr
    assert os.path.exists(tmp_path / "m" / "multitask_resnet-18_multi_128" / "0000.pt")
    r = _run([script, "eval", "multi", *small, *data], tmp_path, env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "mIoU" in r.stderr
    image = sorted((tmp_path / "cs" / "JPEGImages").iterdir())[0]
    r = _run([script, "demo", "multi", *small, "--model-dir", str(tmp_path / "m"), "--images", str(image),
              "--out-dir", str(tmp_path / "out")], tmp_path, env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert len(os.listdir(tmp_path / "out")) == 1
    r = _run([script, "bogus"], tmp_path, env)
    assert r.returncode == 1 and "usage" in r.stderr


def test_run_resumable_refuses_resume(tmp_path):
    r = _run([os.path.join(SCRIPTS, "run_resumable.sh"), "--resume", "3"], tmp_path)
    assert r.returncode == 2 and "do not pass --resume" in r.stderr


def test_make_scale_dataset(tmp_path):
    """4 train + 2 val images at 1024x2048, each split packed into a
    ``.drec`` store that ``load_index`` reads, the val split with instance
    ids."""
    r = _run([sys.executable, os.path.join(SCRIPTS, "make_scale_dataset.py"), str(tmp_path / "s"), "4", "2"],
             tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    for split, n in (("train", 4), ("val", 2)):
        index = record.load_record_index(str(tmp_path / "s" / split))
        assert len(index) == n
        via = imdb.load_index(str(tmp_path / "s"), split)
        assert [s.image_path for s in via.samples] == [s.image_path for s in index.samples]
        assert index[0].label.shape == (200, 6)
    assert os.path.isdir(tmp_path / "s" / "val" / "SegmentationInstance")


NEW_MODULES = ["dspnet_torch.ops.nms", "dspnet_torch.data.cv_warp", "dspnet_torch.data.native_loader",
               "dspnet_torch.data.iterator", "dspnet_torch.bench", "dspnet_torch.utils.benchmark"]


def test_new_modules_import_no_jax_cv2_or_pil():
    """Imported in a fresh interpreter, the new modules load none of jax,
    flax, cv2, PIL or the JAX package."""
    code = ("import importlib, sys\n"
            f"for m in {NEW_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'flax', 'cv2', 'PIL', 'dspnet_tpu'))\n"
            "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "[]"
