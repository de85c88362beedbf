"""The port's CLIs in-process on the CPU: train -> checkpoint -> resume ->
evaluate on synthetic data (resnet-18_multi at 128x256, batch 2), the
absolute-epoch checkpoint cadence, exit code 3 on divergence, and the flags
the port refuses."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import cv2

from dspnet_tpu.cli.common import resolve_dataset as jax_resolve_dataset
from dspnet_torch.cli import common, multi_eval, multi_train
from dspnet_torch.data import imdb, record
from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix
from tests.torch_parity import write_cityscapes_layout

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

NET = ["--network", "resnet-18_multi", "--data-shape", "3,128,256", "--num-classes", "8",
       "--batch-size", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_cli")
    cwd = os.getcwd()
    os.chdir(path)  # the CLIs log under ./log
    yield path
    os.chdir(cwd)


def _data(workdir, n=4):
    return ["--synthetic", str(n), "--synthetic-dir", str(workdir / "synth")]


def _epochs(model_dir):
    return CheckpointManager(checkpoint_prefix(str(model_dir), "resnet-18_multi", 128)).epochs()


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_validate_checkpoint_resume_evaluate(workdir):
    """2 epochs with a validation pass after each and a checkpoint each; a
    resume from the latest starts at epoch 2 from its step and state; the
    eval CLI scores the latest checkpoint as the training's last pass did."""
    model = workdir / "model"
    jsonl = str(workdir / "m.jsonl")
    common = NET + _data(workdir) + ["--model-dir", str(model), "--seg-normalize", "valid",
                                    "--metrics-jsonl", jsonl]
    st = multi_train.main(common + ["--end-epoch", "2", "--eval-every", "1", "--log-every", "1"])
    assert st.step == 4 and _epochs(model) == [0, 1]
    rows = _rows(jsonl)
    assert [(r["epoch"], r["split"]) for r in rows] == [(0, "train"), (0, "val"), (1, "train"), (1, "val")]
    for r in rows[1::2]:
        for k in ("mAP", "mIoU", "accuracy"):
            assert np.isfinite(r[k]) and 0.0 <= r[k] <= 1.0, (k, r[k])
        assert r["ms_per_batch"] >= 0
    saved = torch.load(CheckpointManager(checkpoint_prefix(str(model), "resnet-18_multi", 128)).path(1),
                       weights_only=True)
    assert saved["step"] == 4
    for k, v in st.params.items():
        assert torch.equal(saved["params"][k], v.detach()), k

    st2 = multi_train.main(common + ["--end-epoch", "3", "--resume", "0", "--eval-every", "0"])
    assert st2.step == 6 and _epochs(model) == [0, 1, 2]
    assert [(r["epoch"], r["split"]) for r in _rows(jsonl)[4:]] == [(2, "train")]

    res = multi_eval.main(NET + _data(workdir) + ["--model-dir", str(model), "--epoch", "1"])
    for key in ("mAP", "mIoU", "accuracy", "derror", "ms_per_batch"):
        assert key in res, key
    last_val = rows[3]
    # the training pass used NMS 0.5 and the eval CLI uses 0.45, so only the
    # seg metrics, which NMS does not touch, must agree exactly
    assert res["mIoU"] == last_val["mIoU"] and res["accuracy"] == last_val["accuracy"]
    res2 = multi_eval.main(NET + _data(workdir) + ["--model-dir", str(model), "--random-init",
                                                    "--dist-errors", str(workdir / "d.txt")])
    assert np.isfinite(res2["accuracy"]) and os.path.exists(workdir / "d.txt")


def test_checkpoint_cadence_on_the_absolute_epoch(workdir):
    """--checkpoint-every 2 after a resume saves at absolute epochs 1 and 3
    (the last), where an unbroken run also saves; gating on the epoch of the
    run, as the JAX CLI does, would save at epoch 2 instead."""
    model = workdir / "model_every"
    common = NET + _data(workdir) + ["--model-dir", str(model), "--seg-normalize", "valid",
                                    "--eval-every", "0"]
    multi_train.main(common + ["--end-epoch", "1"])
    assert _epochs(model) == [0]  # the last epoch is always saved
    st = multi_train.main(common + ["--end-epoch", "4", "--resume", "0", "--checkpoint-every", "2"])
    assert _epochs(model) == [0, 1, 3] and st.step == 8
    # --resume 0 on an empty model dir starts fresh
    multi_train.main(common + ["--end-epoch", "1", "--resume", "0", "--model-dir", str(workdir / "fresh")])
    assert CheckpointManager(checkpoint_prefix(str(workdir / "fresh"), "resnet-18_multi", 128)).epochs() == [0]


def test_divergence_exits_3(workdir):
    with pytest.raises(SystemExit) as err:
        multi_train.main(NET + _data(workdir) + ["--model-dir", str(workdir / "model_nan"), "--lr", "1e8",
                                                 "--log-every", "1", "--end-epoch", "2", "--eval-every", "0"])
    assert err.value.code == 3


def test_refusals(workdir):
    """JAX flags the port does not honour (the TPU-only ones) and the loader
    options given to another loader than theirs (the JAX CLIs' rules:
    ``--predownscale`` with ``device``, ``--native-u8`` with ``native``) are
    argparse errors; a dataset root, a label space wider than the head and a
    missing card fail loudly."""
    for extra in (["--target-backend", "pallas"], ["--input-s2d", "on"], ["--native-u8"],
                  ["--model-parallel", "2"], ["--loader", "python", "--predownscale"],
                  ["--loader", "native", "--predownscale"], ["--loader", "python", "--native-u8"]):
        with pytest.raises(SystemExit) as err:
            multi_train.parse_args(NET + extra)
        assert err.value.code == 2, extra
    for extra in (["--loader", "det"], ["--input-s2d", "on"], ["--loader", "python", "--predownscale"]):
        with pytest.raises(SystemExit):
            multi_eval.parse_args(NET + extra)
    for loader in ("python", "native", "device"):
        assert multi_train.parse_args(NET + ["--loader", loader]).loader == loader
        assert multi_eval.parse_args(NET + ["--loader", loader]).loader == loader
    assert multi_train.parse_args(NET + ["--loader", "native", "--native-u8"]).native_u8
    with pytest.raises(FileNotFoundError, match="no recognizable dataset"):
        multi_train.main(NET + ["--dataset-root", str(workdir / "nothing_here")])
    with pytest.raises(ValueError, match="no dataset"):
        multi_train.main(NET)
    with pytest.raises(ValueError, match="--num-classes"):
        multi_train.main(NET + _data(workdir) + ["--num-classes", "2", "--model-dir", str(workdir / "m2")])
    if not torch.cuda.is_available():
        for cli in (multi_train, multi_eval):
            with pytest.raises(SystemExit, match="no CUDA device"):
                cli.main(["--network", "resnet-18_multi", "--data-shape", "3,128,256", "--synthetic", "2"])


def test_remat_and_seg_fast_through_the_clis(workdir):
    """``multi_train --remat --seg-fast`` trains the score-then-upsample seg
    head with every residual unit rematerialised: its checkpoint equals the
    one of ``--seg-fast`` alone bit for bit (remat changes memory, not the
    step) and differs from the exact head's; ``multi_eval --seg-fast``
    scores it."""
    runs = {}
    for name, extra in (("remat_fast", ["--remat", "--seg-fast"]), ("fast", ["--seg-fast"]), ("exact", [])):
        model = workdir / f"model_{name}"
        multi_train.main(NET + _data(workdir) + ["--model-dir", str(model), "--seg-normalize", "valid",
                                                 "--end-epoch", "1", "--eval-every", "0"] + extra)
        runs[name] = torch.load(CheckpointManager(checkpoint_prefix(str(model), "resnet-18_multi", 128)).path(0),
                                weights_only=True)
    a, b, c = runs["remat_fast"], runs["fast"], runs["exact"]
    for part in ("params", "buffers", "momentum"):
        assert a[part].keys() == b[part].keys() == c[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert not torch.equal(a["params"]["seg.score3_conv.weight"], c["params"]["seg.score3_conv.weight"])
    res = multi_eval.main(NET + _data(workdir) + ["--model-dir", str(workdir / "model_remat_fast"), "--seg-fast"])
    assert 0.0 <= res["mIoU"] <= 1.0 and np.isfinite(res["accuracy"])


# ------------------------------------------------------------- prepared data


@pytest.fixture(scope="module")
def prepared(workdir):
    """A prepared-Cityscapes directory (4 train, 3 val JPEGs at 256x512,
    twice the data shape) and the same splits packed into .drec stores."""
    root = workdir / "cs"
    write_cityscapes_layout(str(root), {"train": 4, "val": 3}, hw=(256, 512), seed=1)
    for split in ("train", "val"):
        record.pack_records(imdb.load_index(str(root), split), str(workdir / "drec" / split), quiet=True)
    return str(root), str(workdir / "drec" / "train.drec")


@pytest.mark.parametrize("store", ["dir", "drec"])
def test_dataset_root_train_then_evaluate(workdir, prepared, store):
    """multi_train --dataset-root for 2 epochs (validation each epoch; the
    .drec run with --predownscale), then multi_eval --write-results
    --instance-eval on the val split: 3 result PNGs at 1024x2048, finite
    metrics, finite instance AP. The train index equals the JAX CLI's
    resolve_dataset on the same flags."""
    root = prepared[0] if store == "dir" else prepared[1]
    model, out = workdir / f"model_{store}", workdir / f"results_{store}"
    jsonl = str(workdir / f"m_{store}.jsonl")
    extra = ["--predownscale"] if store == "drec" else []
    args = NET + ["--dataset-root", root, "--model-dir", str(model), "--seg-normalize", "valid",
                  "--end-epoch", "2", "--metrics-jsonl", jsonl] + extra
    ns = multi_train.parse_args(args)
    ours, theirs = common.resolve_dataset(ns, "train"), jax_resolve_dataset(ns, "train")
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours.samples, theirs.samples):
        assert (a.image_path, a.seg_path, a.image_span, a.seg_span) == \
            (b.image_path, b.seg_path, b.image_span, b.seg_span)
        np.testing.assert_array_equal(a.label, b.label)
    st = multi_train.main(args)
    assert st.step == 4 and _epochs(model) == [0, 1]
    val = [r for r in _rows(jsonl) if r["split"] == "val"]
    assert [r["epoch"] for r in val] == [0, 1]
    for r in val:
        for k in ("mAP", "mIoU", "accuracy"):
            assert np.isfinite(r[k]) and 0.0 <= r[k] <= 1.0, (k, r[k])
    res = multi_eval.main(NET + ["--dataset-root", root, "--model-dir", str(model), "--write-results", str(out),
                                 "--instance-eval"] + extra)
    for k in ("mAP", "mIoU", "accuracy"):
        assert np.isfinite(res[k]) and 0.0 <= res[k] <= 1.0, (k, res[k])
    assert np.isfinite(res["instAP"]) and np.isfinite(res["instAP50"])
    pngs = sorted(os.listdir(out))
    assert pngs == [f"valcity_{i:06d}_000019_leftImg8bit_pred.png" for i in range(3)]
    for name in pngs:
        img = cv2.imread(str(out / name), cv2.IMREAD_UNCHANGED)
        assert img.shape == (1024, 2048) and img.dtype == np.uint8


def test_dataset_root_without_a_val_split(workdir, caplog):
    """A prepared root with no val split trains and logs that it skips the
    validation pass, as the JAX CLI does."""
    root = workdir / "cs_train_only"
    write_cityscapes_layout(str(root), {"train": 2}, hw=(128, 256), seed=2)
    with caplog.at_level("INFO"):
        st = multi_train.main(NET + ["--dataset-root", str(root), "--model-dir", str(workdir / "model_noval"),
                                     "--end-epoch", "1", "--seg-normalize", "valid"])
    assert st.step == 1
    assert "no validation split found; skipping per-epoch eval" in caplog.text


# ------------------------------------------------------- a JAX run's model dir


def test_a_jax_runs_model_dir(workdir, prepared):
    """The JAX ``multi_train`` (resnet-18_multi 128x256, b2, one epoch, its
    python loader, the prepared Cityscapes layout, whose files both CLIs
    read as they are) writes Orbax epoch 0; then, on that model dir as it is:
    the port's ``multi_eval --loader python`` agrees with the JAX
    ``multi_eval`` (every key within 1e-6 absolute: the two float32
    forwards differ by reassociation, which moves the depth errors by up to
    1.7e-7 here and leaves the det and seg metrics equal); ``multi_train --resume 0 --loader python`` continues at the JAX
    step and writes epoch 1 as ``.pt`` beside the Orbax step, its weights
    within ``assert_steps_match_jax``'s tolerances of the JAX ``--resume 0``
    (each parameter's change within 4% of the largest, each running
    statistic's within 1e-3 of the largest of its kind); and
    ``init_from_checkpoint`` from the JAX prefix equals the JAX
    ``init_from_checkpoint`` bit for bit, moving the backbone only.
    ``multi_demo``'s detector holds the JAX epoch's weights bit for bit and
    its ``main`` writes an image (``eval_voc`` and ``export_serving`` restore
    through the same ``CheckpointManager.restore``)."""
    import dataclasses
    import shutil

    import jax

    from dspnet_tpu.cli import multi_eval as jax_multi_eval
    from dspnet_tpu.cli import multi_train as jax_multi_train
    from dspnet_tpu.utils.checkpoint import CheckpointManagerWrapper
    from dspnet_tpu.utils.transfer import init_from_checkpoint as jax_init_from_checkpoint
    from dspnet_torch.api import create_model
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils.convert import to_flax_variables
    from dspnet_torch.utils.transfer import init_from_checkpoint
    from tests.torch_parity import assert_steps_match_jax, flat_tree

    jax_net = [a for a in NET if a not in ("--device", "cpu")]
    data = ["--dataset-root", prepared[0], "--loader", "python"]
    train = ["--lr", "0.001", "--seg-normalize", "valid", "--eval-every", "0"]
    jax_dir = workdir / "jax_model"
    jax_multi_train.main(jax_net + data + train + ["--end-epoch", "1", "--num-devices", "1",
                                                   "--model-dir", str(jax_dir)])
    prefix = checkpoint_prefix(str(jax_dir), "resnet-18_multi", 128)
    assert sorted(os.listdir(prefix)) == ["0"] and CheckpointManager(prefix).epochs() == [0]
    for name in ("jax_resumed", "port_resumed"):
        shutil.copytree(jax_dir, workdir / name)

    want = jax_multi_eval.main(jax_net + data + ["--model-dir", str(jax_dir)])
    got = multi_eval.main(NET + data + ["--model-dir", str(jax_dir)])
    assert set(got) == set(want)
    for k in want:
        if k == "ms_per_batch":
            continue
        assert abs(float(got[k]) - float(want[k])) <= 1e-6 or (np.isnan(got[k]) and np.isnan(want[k])), \
            (k, got[k], want[k])

    from dspnet_torch.cli import multi_demo
    from dspnet_torch.utils.checkpoint import state_from_flax

    demo = ["--network", "resnet-18_multi", "--data-shape", "3,128,256", "--model-dir", str(jax_dir), "--device", "cpu"]
    jmgr = CheckpointManagerWrapper(prefix)
    want_state = state_from_flax(jmgr.restore_raw(0)[0])
    jmgr.close()
    detector = multi_demo.get_detector(multi_demo.parse_args(demo))
    weights = detector.model.state_dict()
    for k, v in {**want_state.params, **want_state.buffers}.items():
        assert torch.equal(weights[k], v.detach()), k
    image = sorted((Path(prepared[0]) / "JPEGImages").glob("*.jpg"))[0]
    written = multi_demo.main(demo + ["--images", str(image), "--out-dir", str(workdir / "demo_jax")])
    assert len(written) == 1 and os.path.getsize(written[0]) > 0

    jax_multi_train.main(jax_net + data + train + ["--end-epoch", "2", "--num-devices", "1", "--resume", "0",
                                                   "--model-dir", str(workdir / "jax_resumed")])
    st = multi_train.main(NET + data + train + ["--end-epoch", "2", "--resume", "0",
                                                "--model-dir", str(workdir / "port_resumed")])
    assert st.step == 4
    port_prefix = checkpoint_prefix(str(workdir / "port_resumed"), "resnet-18_multi", 128)
    assert sorted(os.listdir(port_prefix)) == ["0", "0001.pt"]
    jmgr = CheckpointManagerWrapper(prefix)
    before, _ = jmgr.restore_raw(0)
    jmgr.close()
    jmgr = CheckpointManagerWrapper(checkpoint_prefix(str(workdir / "jax_resumed"), "resnet-18_multi", 128))
    after, _ = jmgr.restore_raw(1)
    jmgr.close()
    assert int(before["step"]) == 2 and int(after["step"]) == 4

    @dataclasses.dataclass(frozen=True)
    class JaxState:  # what the JAX init_from_checkpoint reads and replaces
        params: dict
        batch_stats: dict

        def replace(self, **kw):
            return dataclasses.replace(self, **kw)

    saved = torch.load(os.path.join(port_prefix, "0001.pt"), weights_only=True)
    assert saved["step"] == 4
    assert_steps_match_jax(before["params"], JaxState(after["params"], after["batch_stats"]), [],
                           to_flax_variables({**saved["params"], **saved["buffers"]}), [],
                           init_stats=before["batch_stats"])

    fresh = create_model("resnet-18_multi", (128, 256), device="cpu", generator=torch.Generator().manual_seed(7))
    state = MultiTaskSolver(fresh.model, fresh.anchors, device="cpu").init_state()
    start = jax.tree.map(np.copy, to_flax_variables({**state.params, **state.buffers}))  # not views of the state
    merged = jax_init_from_checkpoint(JaxState(start["params"], start["batch_stats"]), prefix)
    init_from_checkpoint(state, prefix)
    got_vars = to_flax_variables({**state.params, **state.buffers})
    for coll, tree in (("params", merged.params), ("batch_stats", merged.batch_stats)):
        want_flat, got_flat, old = (flat_tree(jax.tree.map(np.asarray, t))
                                    for t in (tree, got_vars[coll], start[coll]))
        assert want_flat.keys() == got_flat.keys()
        for k, v in want_flat.items():
            np.testing.assert_array_equal(got_flat[k], v, err_msg=k)
            assert np.array_equal(v, old[k]) != ("backbone" in k), k
