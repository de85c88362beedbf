"""The port's CLIs in-process on the CPU: train -> checkpoint -> resume ->
evaluate on synthetic data (resnet-18_multi at 128x256, batch 2), the
absolute-epoch checkpoint cadence, exit code 3 on divergence, and the flags
the port refuses."""

import json
import os

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
    """JAX flags the port does not honour are argparse errors; a dataset root,
    a label space wider than the head and a missing card fail loudly."""
    for extra in (["--remat"], ["--loader", "python"], ["--target-backend", "pallas"],
                  ["--num-devices", "2"], ["--seg-fast"]):
        with pytest.raises(SystemExit) as err:
            multi_train.parse_args(NET + extra)
        assert err.value.code == 2, extra
    for extra in (["--seg-fast"], ["--loader", "native"]):
        with pytest.raises(SystemExit):
            multi_eval.parse_args(NET + extra)
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
