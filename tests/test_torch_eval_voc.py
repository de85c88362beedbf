"""The VOC evaluation of the PyTorch port vs the JAX package on the CPU:
``voc_ap`` / ``voc_eval`` (numpy copies), the devkit ``comp4_det_*`` result
files and their scores, and the plain-SSD CLIs, ``multi_train --loader det``
then ``eval_voc``, against the JAX ``eval_voc`` on the same weights."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dspnet_tpu.api import create_model as jax_create_model
from dspnet_tpu.cli import eval_voc as jax_eval_voc
from dspnet_tpu.data import synthetic as jax_synthetic
from dspnet_tpu.data.imdb import PascalVoc as JaxPascalVoc
from dspnet_tpu.evaluate import eval_voc as jax_ev
from dspnet_tpu.train.solver import MultiTaskSolver as JaxSolver
from dspnet_tpu.utils.checkpoint import CheckpointManagerWrapper
from dspnet_tpu.utils.checkpoint import checkpoint_prefix as jax_checkpoint_prefix
from dspnet_torch.cli import eval_voc, multi_train
from dspnet_torch.data import synthetic
from dspnet_torch.data.imdb import PascalVoc
from dspnet_torch.evaluate import eval_voc as ev
from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix
from dspnet_torch.utils.convert import to_flax_variables

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

NAMES = synthetic.class_names()


@pytest.mark.parametrize("use_07", [False, True])
def test_voc_ap_matches_jax(use_07):
    rng = np.random.RandomState(int(use_07))
    for n in (1, 5, 40):
        rec = np.sort(rng.rand(n))
        prec = rng.rand(n)
        assert ev.voc_ap(rec, prec, use_07) == jax_ev.voc_ap(rec, prec, use_07)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return jax_synthetic.build_voc_dataset(str(tmp_path_factory.mktemp("devkit")), num_samples=6, hw=(96, 128),
                                           seed=4)


def _random_boxes(rng, n_images):
    """Detector-style rows [cls, score, x1, y1, x2, y2] (normalized), a few
    -1 padding rows and out-of-range ids among them."""
    out = []
    for _ in range(n_images):
        n = rng.randint(0, 12)
        x1, y1 = rng.uniform(0, 0.7, n), rng.uniform(0, 0.7, n)
        rows = np.stack([rng.randint(-1, len(NAMES) + 1, n), rng.rand(n), x1, y1,
                         x1 + rng.uniform(0.05, 0.3, n), y1 + rng.uniform(0.05, 0.3, n)], -1)
        out.append(rows.astype(np.float32))
    return out


@pytest.mark.parametrize("use_07", [False, True])
def test_voc_eval_matches_jax(tree, use_07):
    """Per-class recall, precision and AP of the same detection lines
    against the same annotations, equal; the parsed records too."""
    anno = os.path.join(tree, "VOC", "Annotations", "{}.xml")
    ids = [f"val_{i:04d}" for i in range(6)]
    rng = np.random.RandomState(7)
    for cls in NAMES[:4]:
        lines = [(ids[rng.randint(6)], rng.rand(), *sorted(rng.uniform(0, 96, 2)), *sorted(rng.uniform(0, 128, 2)))
                 for _ in range(15)]
        got, want = ev.voc_eval(lines, anno, ids, cls, 0.5, use_07), jax_ev.voc_eval(lines, anno, ids, cls, 0.5, use_07)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert ev.parse_rec(anno.format(ids[0])) == jax_ev.parse_rec(anno.format(ids[0]))
    assert ev.voc_eval([], anno, ids, NAMES[0])[2] == 0.0


def test_comp4_files_byte_equal_to_jax(tree, tmp_path):
    """The same detections through both packages' ``evaluate_detections``:
    every ``comp4_det_val_{cls}.txt`` byte for byte (int() before the +1,
    %.3f scores, -1 and out-of-range ids skipped), the same AP dict, 07 and
    area metrics."""
    all_boxes = _random_boxes(np.random.RandomState(3), 6)
    for use_07 in (True, False):
        want = JaxPascalVoc("val", "", tree, classes=NAMES).evaluate_detections(
            all_boxes, result_dir=str(tmp_path / f"jax{use_07}"), use_07_metric=use_07)
        got = PascalVoc("val", "", tree, classes=NAMES).evaluate_detections(
            all_boxes, result_dir=str(tmp_path / f"port{use_07}"), use_07_metric=use_07)
        assert got == want
        for cls in NAMES:
            name = f"comp4_det_val_{cls}.txt"
            with open(tmp_path / f"jax{use_07}" / name, "rb") as a, open(tmp_path / f"port{use_07}" / name, "rb") as b:
                assert a.read() == b.read(), name
    voc = PascalVoc("val", "", tree, classes=NAMES)
    with pytest.raises(ValueError, match="2 detection lists for 6"):
        voc.write_pascal_results(all_boxes[:2], str(tmp_path / "short"))
    # the default result dir is the devkit results/ tree
    voc.evaluate_detections(all_boxes)
    assert os.path.exists(os.path.join(tree, "results", "VOC", "Main", f"comp4_det_val_{NAMES[0]}.txt"))


def _jax_checkpoint(port_state, model_dir, network, hw, num_classes, epoch):
    """The port state's weights written as the JAX package's Orbax checkpoint."""
    bundle = jax_create_model(network, hw, num_classes)
    js = JaxSolver(bundle.model, bundle.anchors)
    st = js.init_state(jax.random.PRNGKey(0), jnp.zeros((1,) + hw + (3,)))
    flax = to_flax_variables({**port_state.params, **port_state.buffers})
    params = jax.tree.map(jnp.asarray, flax["params"])
    st = st.replace(params=params, batch_stats=jax.tree.map(jnp.asarray, flax["batch_stats"]),
                    opt_state=js.tx.init(params))
    mgr = CheckpointManagerWrapper(jax_checkpoint_prefix(model_dir, network, hw[0]))
    mgr.save(epoch, st, block=True)
    mgr.close()


def test_det_train_then_eval_voc_matches_jax(tmp_path):
    """``multi_train --loader det`` (resnet-18 plain SSD, 2 epochs with a
    validation pass, a checkpoint) then ``eval_voc --voc07`` with the devkit
    files, in-process on the CPU; the same weights written as a JAX
    checkpoint and scored by the JAX ``eval_voc``: the same keys, ``mAP``
    and ``devkit_mAP`` (and every class) within 1e-6, every comp4 file with
    the same lines, scores within one printed digit (0.001) and pixel
    corners within one (the two forwards differ by float32 reassociation,
    which can cross a rounding or ``int()`` boundary). A resume continues
    from the saved epoch. The port's ``eval_voc`` on the JAX model dir
    (its Orbax epoch read without JAX) equals the port's on its own
    checkpoint, key for key."""
    root = synthetic.build_voc_dataset(str(tmp_path / "devkit"), num_samples=4, hw=(96, 96), seed=233)
    names = ",".join(NAMES)
    common = ["--network", "resnet-18", "--data-shape", "3,96,96", "--num-classes", "8", "--batch-size", "2"]
    model_dir = str(tmp_path / "model")
    state = multi_train.main(common + ["--end-epoch", "2", "--lr", "0.001", "--dataset-root", root,
                                       "--loader", "det", "--model-dir", model_dir, "--eval-every", "2",
                                       "--device", "cpu"])
    assert state.step == 4
    resumed = multi_train.main(common + ["--end-epoch", "3", "--lr", "0.001", "--dataset-root", root,
                                         "--loader", "det", "--model-dir", str(tmp_path / "model"), "--resume",
                                         "0", "--eval-every", "0", "--device", "cpu"])
    assert resumed.step == 6
    saved, epoch = CheckpointManager(checkpoint_prefix(model_dir, "resnet-18", 96)).restore(1, state)
    assert epoch == 1
    _jax_checkpoint(saved, str(tmp_path / "jax_model"), "resnet-18", (96, 96), 8, 1)

    flags = common + ["--class-names", names, "--voc-root", root, "--year", "", "--image-set", "val",
                      "--voc07", "--epoch", "1"]
    got = eval_voc.main(flags + ["--model-dir", model_dir, "--result-dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    want = jax_eval_voc.main(flags + ["--model-dir", str(tmp_path / "jax_model"),
                                      "--result-dir", str(tmp_path / "jax")])
    assert set(got) == set(want)
    assert {"mAP", "devkit_mAP", "ms_per_batch"} <= set(got)
    from_jax = eval_voc.main(flags + ["--model-dir", str(tmp_path / "jax_model"),
                                      "--result-dir", str(tmp_path / "port_on_jax"), "--device", "cpu"])
    assert all(from_jax[k] == got[k] or (np.isnan(got[k]) and np.isnan(from_jax[k]))
               for k in got if k != "ms_per_batch")
    for k in want:
        if k != "ms_per_batch":
            assert abs(got[k] - want[k]) <= 1e-6 or (np.isnan(got[k]) and np.isnan(want[k])), k
    for cls in NAMES:
        a, b = (_comp4_rows(tmp_path / d / f"comp4_det_val_{cls}.txt") for d in ("port", "jax"))
        assert a[0] == b[0], cls
        np.testing.assert_allclose(a[1][:, 0], b[1][:, 0], rtol=0, atol=0.0011, err_msg=cls)
        np.testing.assert_allclose(a[1][:, 1:], b[1][:, 1:], rtol=0, atol=1.0, err_msg=cls)


def _comp4_rows(path):
    """A result file's (image ids, [score, x1, y1, x2, y2] rows), sorted."""
    with open(path) as f:
        rows = sorted((p[0], *map(float, p[2:6]), float(p[1])) for p in (line.split() for line in f))
    return [r[0] for r in rows], np.array([[r[5], *r[1:5]] for r in rows]).reshape(-1, 5)


def test_loader_det_refuses_multitask_networks(tmp_path):
    root = synthetic.build_voc_dataset(str(tmp_path / "devkit"), num_samples=2, hw=(64, 64))
    with pytest.raises(ValueError, match="--loader det"):
        multi_train.main(["--network", "resnet-18_multi", "--data-shape", "3,64,64", "--dataset-root", root,
                          "--loader", "det", "--model-dir", str(tmp_path / "m"), "--end-epoch", "1",
                          "--device", "cpu"])
    with pytest.raises(ValueError, match="not a detector"):
        eval_voc.main(["--network", "resnet-18_seg", "--data-shape", "3,64,64", "--num-classes", "8",
                       "--class-names", ",".join(NAMES), "--voc-root", root, "--year", "", "--random-init",
                       "--device", "cpu"])
