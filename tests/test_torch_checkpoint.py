"""Checkpoints of the PyTorch port: the per-epoch ``torch.save`` files, the
async save from a device snapshot, failures surfacing on the next call, and
``state_from_flax`` on an Orbax checkpoint written by the JAX package."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dspnet_tpu.api import create_model as jax_create_model
from dspnet_tpu.train.solver import MultiTaskSolver as JaxSolver
from dspnet_tpu.utils.checkpoint import CheckpointManagerWrapper
from dspnet_tpu.utils.checkpoint import checkpoint_prefix as jax_checkpoint_prefix
from dspnet_torch.api import create_model
from dspnet_torch.train.solver import MultiTaskSolver, TrainState
from dspnet_torch.utils import checkpoint, orbax_read
from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix, state_from_flax
from dspnet_torch.utils.convert import load_flax_variables, to_flax_variables
from tests.torch_parity import random_flax_variables

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores


def _state(seed=0, step=3):
    g = torch.Generator().manual_seed(seed)
    params = {"a.weight": torch.randn(4, 3, 3, 3, generator=g).requires_grad_(),
              "a.bias": torch.randn(4, generator=g).requires_grad_(False)}
    buffers = {"bn.running_mean": torch.randn(4, generator=g), "bn.num_batches": torch.tensor(7)}
    momentum = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    return TrainState(step, params, buffers, momentum)


def _clone(st):
    return TrainState(st.step, *({k: v.detach().clone() for k, v in getattr(st, g).items()}
                                 for g in ("params", "buffers", "momentum")))


def _assert_equal(a, b):
    assert a.step == b.step
    for g in ("params", "buffers", "momentum"):
        x, y = getattr(a, g), getattr(b, g)
        assert set(x) == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            assert torch.equal(x[k].detach(), y[k].detach()), (g, k)


def test_checkpoint_prefix_matches_jax(tmp_path):
    assert checkpoint_prefix(str(tmp_path), "resnet-50_multi", 512) == \
        jax_checkpoint_prefix(str(tmp_path), "resnet-50_multi", 512)
    assert checkpoint_prefix("model", "resnet-18_multi", 128).endswith("model/multitask_resnet-18_multi_128")


def test_save_restore_round_trip(tmp_path):
    """A blocking save restores bit for bit into a template, keeping the
    template's tensors and requires_grad; the file is plain tensors and an
    int for torch.load(weights_only=True); the latest epoch wins."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_epoch() is None
    st = _state()
    mgr.save(0, st)
    mgr.save(4, _state(seed=1, step=9))
    assert mgr.epochs() == [0, 4] and mgr.latest_epoch() == 4
    raw = torch.load(mgr.path(0), weights_only=True)
    assert raw["step"] == 3 and set(raw) == {"params", "buffers", "momentum", "step"}
    template = _state(seed=2, step=0)
    keep = template.params["a.weight"]
    restored, ep = mgr.restore(0, template)
    assert ep == 0 and restored.params["a.weight"] is keep
    assert restored.params["a.weight"].requires_grad and not restored.params["a.bias"].requires_grad
    _assert_equal(restored, st)
    restored, ep = mgr.restore(None, _state(seed=2, step=0))
    assert ep == 4
    _assert_equal(restored, _state(seed=1, step=9))
    bad = _state()
    bad.params["extra"] = torch.zeros(1)
    with pytest.raises(KeyError, match="missing"):
        mgr.restore(0, bad)
    bad = _state()
    bad.params["a.bias"] = torch.zeros(1)  # broadcastable, yet not the saved shape
    with pytest.raises(ValueError, match=r"a.bias has shape \(4,\), the model's is \(1,\)"):
        mgr.restore(0, bad)
    assert sorted(os.listdir(mgr.prefix)) == ["0000.pt", "0004.pt"]  # no temporary files left
    mgr.close()


def test_async_save_snapshots_before_in_place_updates(tmp_path):
    """save(block=False) copies from a snapshot: updating the state in place
    right after (as the next train step does) does not reach the file."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    st = _state()
    want = _clone(st)
    mgr.save(0, st, block=False)
    with torch.no_grad():
        for g in ("params", "buffers", "momentum"):
            for v in getattr(st, g).values():
                v.mul_(0).sub_(1)
    st.step = 99
    assert mgr.latest_epoch() == 0  # joins the background write
    restored, _ = mgr.restore(0, _state(seed=5))
    _assert_equal(restored, want)
    for ep in (1, 2, 3):  # each save joins the one before
        mgr.save(ep, want, block=ep == 3)
    assert mgr.epochs() == [0, 1, 2, 3]
    mgr.close()


def test_async_save_failure_surfaces_on_the_next_call(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "ck"))

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", boom)
    mgr.save(0, _state(), block=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed") as err:
        mgr.latest_epoch()
    assert isinstance(err.value.__cause__, OSError)
    monkeypatch.undo()
    assert mgr.latest_epoch() is None  # reported once; nothing was written
    mgr.save(1, _state())
    assert mgr.latest_epoch() == 1
    mgr.close()


def test_state_from_flax_reads_a_jax_checkpoint(tmp_path):
    """A resnet-18_multi state saved by dspnet_tpu's CheckpointManagerWrapper
    (params, batch stats, a non-zero momentum trace, step) becomes a port
    TrainState whose tensors equal the JAX ones, and which loads into the
    port's model. The port's own reader (``utils/orbax_read.py``) gives
    orbax's tree leaf for leaf, bit for bit, and ``CheckpointManager``
    restores the epoch into a port state equal to ``state_from_flax``'s."""
    H, W = 128, 256
    bundle = jax_create_model("resnet-18_multi", (H, W))
    variables = random_flax_variables(bundle.model, (1, H, W, 3), seed=3, train=False)
    js = JaxSolver(bundle.model, bundle.anchors)
    st = js.init_state(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    params = jax.tree.map(jnp.asarray, variables["params"])
    rng = np.random.RandomState(1)
    momentum = jax.tree.map(lambda x: jnp.asarray(rng.normal(0, 1e-3, x.shape).astype(np.float32)), params)
    st = st.replace(params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                    opt_state=js.tx.init(params)._replace(momentum=momentum),
                    step=jnp.asarray(17, jnp.int32))
    mgr = CheckpointManagerWrapper(str(tmp_path / "ck"))
    mgr.save(2, st)
    tree, epoch = mgr.restore_raw(None)
    mgr.close()
    assert epoch == 2
    got, got_epoch = orbax_read.restore_raw(str(tmp_path / "ck"))
    assert got_epoch == 2
    want_leaves, want_def = jax.tree_util.tree_flatten_with_path(tree)
    got_leaves, got_def = jax.tree_util.tree_flatten_with_path(got)
    assert got_def == want_def and len(got_leaves) == len(want_leaves) > 100
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == np.asarray(b).tobytes(), path

    state = state_from_flax(tree)
    assert state.step == 17
    port = create_model("resnet-18_multi", (H, W), device="cpu")
    names = {n for n, _ in port.model.named_parameters()}
    assert set(state.params) == names == set(state.momentum)
    assert set(state.buffers) == {n for n, _ in port.model.named_buffers()}
    back = to_flax_variables({**state.params, **state.buffers})
    for coll in ("params", "batch_stats"):
        got = jax.tree_util.tree_leaves_with_path(back[coll])
        want = dict(jax.tree_util.tree_leaves_with_path(variables[coll]))
        assert len(got) == len(want)
        for path, leaf in got:
            np.testing.assert_array_equal(leaf, want[path])
    got_mom = to_flax_variables(state.momentum)["params"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(got_mom):
        np.testing.assert_array_equal(leaf, np.asarray(dict(jax.tree_util.tree_leaves_with_path(momentum))[path]))
    assert all(v.dtype == torch.float32 and v.requires_grad for v in state.params.values())
    template = MultiTaskSolver(port.model, port.anchors, device="cpu").init_state()
    restored, ep = CheckpointManager(str(tmp_path / "ck")).restore(None, template)
    assert ep == 2 and restored.step == 17
    for g in ("params", "buffers", "momentum"):
        for k, t in getattr(restored, g).items():
            assert torch.equal(t.detach(), getattr(state, g)[k].detach()), (g, k)

    # the converted state serves in the port as the JAX variables do
    solver = MultiTaskSolver(port.model, port.anchors, device="cpu")
    det = solver.make_detector(state, (H, W))
    ref = load_flax_variables(create_model("resnet-18_multi", (H, W), device="cpu").model, variables).eval()
    images = torch.from_numpy(np.random.RandomState(0).normal(0, 50, (1, H, W, 3)).astype(np.float32))
    with torch.no_grad():
        want_out = ref(images)
        got_out = det.model(images)
    for k in want_out:
        assert torch.equal(got_out[k], want_out[k]), k
