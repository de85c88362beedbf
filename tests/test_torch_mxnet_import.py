"""The port's MXNet ``.params`` import (``dspnet_torch/utils/mxnet_import.py``,
``utils/transfer.py``, ``tools/import_mxnet.py``) against the JAX package's,
on the CPU: the binary format byte for byte, the name maps leaf for leaf, a
full resnet-18_multi inventory round trip, a JAX-written file imported by
both tools into equal states, and the detector on the imported weights."""

import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dspnet_tpu.api import create_model as jax_create_model
from dspnet_tpu.detect.detector import Detector as JaxDetector
from dspnet_tpu.tools import import_mxnet as jax_import_mxnet
from dspnet_tpu.utils import mxnet_import as jmx
from dspnet_tpu.utils import transfer as jtransfer
from dspnet_tpu.utils.checkpoint import CheckpointManagerWrapper
from dspnet_tpu.utils.checkpoint import checkpoint_prefix as jax_checkpoint_prefix
from dspnet_torch.api import create_model
from dspnet_torch.tools import import_mxnet
from dspnet_torch.train.solver import MultiTaskSolver
from dspnet_torch.utils import mxnet_import as pmx
from dspnet_torch.utils import transfer
from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix, state_from_flax
from dspnet_torch.utils.convert import to_flax_variables
from tests.torch_parity import random_flax_variables

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

H, W = 128, 256


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """A full reference-layout resnet-18_multi .params written by the JAX
    package from seeded weights, and those weights."""
    path = tmp_path_factory.mktemp("mx") / "dspnet-0007.params"
    bundle = jax_create_model("resnet-18_multi", (H, W))
    variables = random_flax_variables(bundle.model, (1, H, W, 3), seed=21, train=False)
    args, auxs = jmx.export_multitask(variables["params"], variables["batch_stats"], "resnet-18_multi", H)
    jmx.save_params(str(path), args, auxs)
    return str(path), variables


def test_save_params_bytes_equal_jax(tmp_path):
    """The writer emits the JAX writer's bytes for the same arrays (every
    dtype the format names, 0-d to 4-d)."""
    rng = np.random.RandomState(0)
    args = {"a_weight": rng.normal(size=(4, 3, 3, 3)).astype(np.float32),
            "b": np.arange(5, dtype=np.int64), "c": np.float16(rng.normal(size=(2, 2))),
            "d": rng.randint(0, 255, (3,)).astype(np.uint8), "e": np.float64(1.5) * np.ones(()),
            "f": np.arange(6, dtype=np.int32).reshape(2, 3), "g": np.arange(-2, 2, dtype=np.int8)}
    auxs = {"bn_moving_mean": rng.normal(size=(7,)).astype(np.float32)}
    jmx.save_params(str(tmp_path / "j.params"), args, auxs)
    pmx.save_params(str(tmp_path / "p.params"), args, auxs)
    assert (tmp_path / "j.params").read_bytes() == (tmp_path / "p.params").read_bytes()
    got_args, got_auxs = pmx.load_params(str(tmp_path / "j.params"))
    for k, v in args.items():
        assert got_args[k].dtype == v.dtype
        np.testing.assert_array_equal(got_args[k], v)
    np.testing.assert_array_equal(got_auxs["bn_moving_mean"], auxs["bn_moving_mean"])


def test_load_params_v1_and_legacy_layouts(tmp_path):
    """Hand-crafted bytes, independent of either writer: V1 = int64 dims;
    V2 = int32 stype then int64 dims; legacy = the first word is the ndim,
    dims uint32 (mxnet src/ndarray/ndarray.cc); a sparse record raises."""
    buf = struct.pack("<QQQ", 0x112, 0, 3)
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    buf += struct.pack("<I", 0xF993FAC8) + struct.pack("<I", 2)
    buf += struct.pack("<qq", 2, 3) + struct.pack("<iii", 1, 0, 0) + a.tobytes()
    b = np.arange(4, dtype=np.float32)
    buf += struct.pack("<I", 0xF993FAC9) + struct.pack("<i", 0)
    buf += struct.pack("<I", 1) + struct.pack("<q", 4)
    buf += struct.pack("<iii", 1, 0, 0) + b.tobytes()
    c = np.arange(6, dtype=np.int32).reshape(3, 2)
    buf += struct.pack("<I", 2) + struct.pack("<II", 3, 2) + struct.pack("<iii", 1, 0, 4) + c.tobytes()
    buf += struct.pack("<Q", 3)
    for name in ("arg:a", "aux:b", "c"):
        buf += struct.pack("<Q", len(name)) + name.encode()
    path = tmp_path / "layouts.params"
    path.write_bytes(buf)
    for mod in (pmx, jmx):
        args, auxs = mod.load_params(str(path))
        np.testing.assert_array_equal(args["a"], a)
        np.testing.assert_array_equal(auxs["b"], b)
        np.testing.assert_array_equal(args["c"], c)
        assert args["c"].dtype == np.int32
    sparse = struct.pack("<QQQ", 0x112, 0, 1) + struct.pack("<Ii", 0xF993FAC9, 1)
    (tmp_path / "sparse.params").write_bytes(sparse + bytes(64))
    with pytest.raises(ValueError, match="sparse"):
        pmx.load_params(str(tmp_path / "sparse.params"))
    (tmp_path / "bad.params").write_bytes(struct.pack("<QQQ", 0x113, 0, 0))
    with pytest.raises(ValueError, match="not an MXNet"):
        pmx.load_params(str(tmp_path / "bad.params"))


@pytest.mark.parametrize("network,shape", [("resnet-18_multi", 128), ("resnet-50_multi", 512),
                                           ("resnet-50_det", 512), ("resnet101_multi", 512)])
def test_det_tap_names_equal_jax(network, shape):
    assert pmx.det_tap_names(network, shape) == jmx.det_tap_names(network, shape)


def test_maps_equal_jax(jax_file):
    """map_multitask and export_multitask of the port's copy give the JAX
    module's trees and name inventory, leaf for leaf."""
    path, variables = jax_file
    args, auxs = pmx.load_params(path)
    jargs, jauxs = jmx.load_params(path)
    got = pmx.map_multitask(args, auxs, "resnet-18_multi", H)
    want = jmx.map_multitask(jargs, jauxs, "resnet-18_multi", H)
    _assert_trees_equal(got[0], want[0])
    _assert_trees_equal(got[1], want[1])
    assert got[2] == want[2] == []
    bb = pmx.map_resnet_backbone(args, auxs)
    jbb = jmx.map_resnet_backbone(jargs, jauxs)
    _assert_trees_equal(bb[0], jbb[0])
    _assert_trees_equal(bb[1], jbb[1])
    pargs, pauxs = pmx.export_multitask(variables["params"], variables["batch_stats"], "resnet-18_multi", H)
    assert set(pargs) == set(jargs) and set(pauxs) == set(jauxs)
    for k in jargs:
        np.testing.assert_array_equal(pargs[k], jargs[k])


def test_full_inventory_round_trip_resnet18(tmp_path):
    """The port's own weights -> export_multitask -> .params -> load_mxnet
    into a model with other weights: every reference name consumed, every
    tensor equal to the source bit for bit."""
    src = create_model("resnet-18_multi", (H, W), device="cpu", generator=torch.Generator().manual_seed(3))
    with torch.no_grad():  # shift every leaf off a fresh init (zero biases, unit scales)
        for k, t in src.model.state_dict().items():
            t.add_(0.017 if "running_var" not in k else 0.013)
    variables = to_flax_variables(src.model)
    args, auxs = pmx.export_multitask(variables["params"], variables["batch_stats"], "resnet-18_multi", H)
    for must in ("_plus5_loc_pred_conv_weight", "multi_feat_2_conv_1x1_conv_weight", "score4_conv_weight",
                 "score3_conv_bn_gamma", "conv0_weight", "stage1_unit1_bn1_gamma", "bn_data_gamma"):
        assert must in args, must
    path = str(tmp_path / "trained-0001.params")
    pmx.save_params(path, args, auxs)
    dst = create_model("resnet-18_multi", (H, W), device="cpu", generator=torch.Generator().manual_seed(99))
    unused = pmx.load_mxnet(dst.model, path, "resnet-18_multi", H)
    assert unused == []
    want = src.model.state_dict()
    for k, v in dst.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_load_mxnet_backbone_only_keeps_the_heads(tmp_path):
    """A pretrained-backbone file: the backbone is replaced, every head keeps
    its weights; a head of the wrong width raises (strict parameter
    shapes)."""
    src = create_model("resnet-18_multi", (H, W), device="cpu", generator=torch.Generator().manual_seed(4))
    variables = to_flax_variables(src.model)
    args, auxs = pmx.export_multitask(variables["params"], variables["batch_stats"], "resnet-18_multi", H)
    keep = {k: v for k, v in args.items() if k.startswith(("conv0", "bn", "stage"))}
    pmx.save_params(str(tmp_path / "bb.params"), keep, {k: v for k, v in auxs.items() if k.startswith(("bn", "stage"))})
    dst = create_model("resnet-18_multi", (H, W), device="cpu", generator=torch.Generator().manual_seed(5))
    before = {k: v.clone() for k, v in dst.model.state_dict().items()}
    assert pmx.load_mxnet(dst.model, str(tmp_path / "bb.params"), "resnet-18_multi", H) == []
    for k, v in dst.model.state_dict().items():
        assert torch.equal(v, src.model.state_dict()[k] if k.startswith("backbone.") else before[k]), k
    wide = create_model("resnet-18_multi", (H, W), num_classes=3, device="cpu")
    pmx.save_params(str(tmp_path / "all.params"), args, auxs)
    with pytest.raises(ValueError, match="shape mismatch"):
        pmx.load_mxnet(wide.model, str(tmp_path / "all.params"), "resnet-18_multi", H)


def test_merge_param_subtree_equals_jax():
    rng = np.random.RandomState(0)
    params = {"backbone": {"a": {"kernel": rng.normal(size=(3, 3)).astype(np.float32)},
                           "b": {"bias": np.zeros(4, np.float32)}},
              "seg": {"c": {"kernel": np.ones((2,), np.float32)}}}
    pre = {"backbone": {"a": {"kernel": np.full((3, 3), 2.0, np.float32)}, "x": {"bias": np.ones(1, np.float32)}}}
    _assert_trees_equal(transfer.merge_param_subtree(params, pre), jtransfer.merge_param_subtree(params, pre))
    bad = {"backbone": {"b": {"bias": np.ones(5, np.float32)}}}
    for mod in (transfer, jtransfer):
        with pytest.raises(ValueError, match="shape mismatch"):
            mod.merge_param_subtree(params, bad)
        _assert_trees_equal(mod.merge_param_subtree(params, bad, strict_shapes=False), params)


def test_init_from_checkpoint_moves_the_backbone_only(tmp_path):
    """init_from_checkpoint reads a port checkpoint without a template: the
    backbone (parameters and running statistics) comes from it, the heads
    and the momentum stay."""
    src = create_model("resnet-18_multi", (H, W), device="cpu", generator=torch.Generator().manual_seed(6))
    solver = MultiTaskSolver(src.model, src.anchors, device="cpu")
    saved = solver.init_state()
    with torch.no_grad():
        for t in saved.buffers.values():
            t.add_(0.25)
    CheckpointManager(str(tmp_path / "ck")).save(3, saved)
    dst = create_model("resnet-18_multi", (H, W), device="cpu", generator=torch.Generator().manual_seed(7))
    state = MultiTaskSolver(dst.model, dst.anchors, device="cpu").init_state()
    fresh = {k: v.detach().clone() for k, v in {**state.params, **state.buffers}.items()}
    transfer.init_from_checkpoint(state, str(tmp_path / "ck"))
    for k, v in {**state.params, **state.buffers}.items():
        want = {**saved.params, **saved.buffers}[k] if k.startswith("backbone.") else fresh[k]
        assert torch.equal(v.detach(), want.detach()), k
    assert all(v.requires_grad for v in state.params.values())


@pytest.fixture(scope="module")
def imported(jax_file, tmp_path_factory):
    """The JAX file imported by the JAX tool and by the port's tool."""
    path, _ = jax_file
    root = tmp_path_factory.mktemp("imported")
    flags = ["--params", path, "--network", "resnet-18_multi", "--data-shape", f"3,{H},{W}", "--epoch", "7"]
    jax_import_mxnet.main(flags + ["--model-dir", str(root / "jax")])
    import_mxnet.main(flags + ["--model-dir", str(root / "port"), "--device", "cpu"])
    mgr = CheckpointManagerWrapper(jax_checkpoint_prefix(str(root / "jax"), "resnet-18_multi", H))
    tree, epoch = mgr.restore_raw(7)
    mgr.close()
    return root, tree


def test_tool_state_equals_the_jax_import(imported, capsys):
    """The port tool's checkpoint equals ``state_from_flax`` of the JAX
    tool's checkpoint of the same file, bit for bit (parameters, running
    statistics, momentum, step)."""
    root, tree = imported
    want = state_from_flax(tree)
    got = torch.load(CheckpointManager(checkpoint_prefix(str(root / "port"), "resnet-18_multi", H)).path(7),
                     map_location="cpu", weights_only=True)
    assert got["step"] == want.step == 0
    for group in ("params", "buffers", "momentum"):
        ref = getattr(want, group)
        assert set(got[group]) == set(ref), group
        for k, v in ref.items():
            assert torch.equal(got[group][k], v.detach()), (group, k)


def test_detector_on_the_imported_weights_matches_jax(imported):
    """The port Detector (float32, CPU) on its imported checkpoint against the
    JAX Detector on the JAX import of the same file: det rows within 1e-4
    with ids equal, seg maps equal."""
    root, tree = imported
    bundle = jax_create_model("resnet-18_multi", (H, W))
    jdet = JaxDetector(bundle.model, {"params": tree["params"], "batch_stats": tree["batch_stats"]},
                       bundle.anchors, (H, W))
    port = create_model("resnet-18_multi", (H, W), device="cpu")
    solver = MultiTaskSolver(port.model, port.anchors, device="cpu")
    state, _ = CheckpointManager(checkpoint_prefix(str(root / "port"), "resnet-18_multi", H)).restore(
        None, solver.init_state())
    pdet = solver.make_detector(state, (H, W))
    images = np.random.RandomState(8).normal(0, 40, (2, H, W, 3)).astype(np.float32)
    want_dets, want_seg = jdet.detect(images)
    got_dets, got_seg = pdet.detect(images)
    np.testing.assert_array_equal(got_seg, want_seg)
    for g, w in zip(got_dets, want_dets):
        assert g.shape == w.shape and len(g) > 0
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_tool_then_multi_eval_and_resume(imported, tmp_path, monkeypatch):
    """multi_eval and multi_train --resume read the imported checkpoint as
    it is (resnet-18_multi 128x256, --device cpu)."""
    from dspnet_torch.cli import multi_eval, multi_train

    root, _ = imported
    monkeypatch.chdir(tmp_path)
    net = ["--network", "resnet-18_multi", "--data-shape", f"3,{H},{W}", "--batch-size", "2", "--device", "cpu",
           "--synthetic", "2", "--synthetic-dir", str(tmp_path / "synth"), "--model-dir", str(root / "port")]
    res = multi_eval.main(net)
    for key in ("mAP", "mIoU", "accuracy", "ms_per_batch"):
        assert np.isfinite(res[key]), key
    model_dir = tmp_path / "resume"
    import shutil

    shutil.copytree(root / "port", model_dir)
    resume = [a if a != str(root / "port") else str(model_dir) for a in net]
    state = multi_train.main(resume + ["--resume", "7", "--end-epoch", "9", "--seg-normalize", "valid",
                                       "--eval-every", "0"])
    assert state.step == 1  # one batch of 2 images after the import's step 0
    assert CheckpointManager(checkpoint_prefix(str(model_dir), "resnet-18_multi", H)).epochs() == [7, 8]
