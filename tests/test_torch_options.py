"""The JAX package's model options in the PyTorch port, float32 on the CPU
at resnet-18_multi 128x256, on the same seeded numpy weights: ``seg_fast``
(the score-then-upsample seg head: forward and a solver step against the
JAX ``seg_fast=True`` model, the exact head's parameter tree, other
outputs) and ``remat`` (a rematerialised step equals the plain one bit for
bit, each BatchNorm's running statistics update once, and the step agrees
with the JAX ``remat=True`` step)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dspnet_tpu.api import create_model as jax_create_model
from dspnet_tpu.train.solver import MultiTaskSolver as JaxSolver
from dspnet_torch.api import create_model
from dspnet_torch.models import layers as tl
from dspnet_torch.train.solver import MultiTaskSolver
from dspnet_torch.utils.benchmark import canonical_train_batch
from dspnet_torch.utils.convert import load_flax_variables, to_flax_variables
from tests.torch_parity import assert_steps_match_jax, flat_tree, jax_solver_state, random_flax_variables

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

H, W = 128, 256


def _batch(seed=0, B=2):
    rng = np.random.RandomState(seed)
    labels = np.full((B, 16, 6), -1.0, np.float32)
    labels[:, 0] = [1, 0.2, 0.2, 0.7, 0.8, 0.3]
    labels[:, 1] = [3, 0.1, 0.4, 0.4, 0.9, 0.1]
    labels[1, 2] = [5, 0.5, 0.1, 0.9, 0.5, 0.6]
    seg = rng.randint(0, 19, (B, H // 4, W // 4)).astype(np.int32)
    seg[:, 0] = 255
    return {"images": (rng.randn(B, H, W, 3) * 50).astype(np.float32), "label_det": labels, "seg_label": seg}


def _port(variables, **kw):
    port = create_model("resnet-18_multi", (H, W), device="cpu", **kw)
    load_flax_variables(port.model, variables)
    return port


def _jax_state(js, variables):
    return jax_solver_state(js, variables, (H, W))


def _compare_steps(js, st, ps, pst, variables, batch, steps):
    """``steps`` updates of both solvers on ``batch``, at the tolerances of
    ``torch_parity.assert_steps_match_jax``."""
    want_m, got_m = [], []
    for _ in range(steps):
        st, m = js.train_step(st, batch)
        want_m.append(m)
        pst, m = ps.train_step(pst, batch)
        got_m.append(m)
    assert_steps_match_jax(variables["params"], st, want_m, to_flax_variables({**pst.params, **pst.buffers}), got_m)


# ------------------------------------------------------------- seg_fast


@pytest.fixture(scope="module")
def fast():
    """resnet-18_multi with the seg_fast head in both packages on the same
    numpy weights."""
    bundle = jax_create_model("resnet-18_multi", (H, W), seg_fast=True)
    variables = random_flax_variables(bundle.model, (1, H, W, 3), seed=3, train=False)
    return bundle, variables


@pytest.mark.parametrize("train", [False, True])
def test_seg_fast_forward_matches_jax(fast, train):
    """Eval (running statistics) and train mode (batch statistics and their
    running update): every output within 1e-4 * max|ref| (f32
    reassociation, as the exact head's test), the updated statistics within
    1e-4 * max|ref| of their tensor."""
    bundle, variables = fast
    images = np.random.RandomState(1).normal(0, 50, (2, H, W, 3)).astype(np.float32)
    port = _port(variables, seg_fast=True).model.train(train)
    assert port.seg.fast
    if train:
        want, upd = jax.jit(lambda v, x: bundle.model.apply(v, x, train=True, mutable=["batch_stats"]))(
            variables, jnp.asarray(images))
    else:
        want = jax.jit(lambda v, x: bundle.model.apply(v, x, train=False))(variables, jnp.asarray(images))
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    assert set(got) == set(want) == {"loc_preds", "cls_logits", "seg_logits"}
    for key in want:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=key)
    if train:
        stats = flat_tree(to_flax_variables(port)["batch_stats"])
        for k, w in flat_tree(upd["batch_stats"]).items():
            np.testing.assert_allclose(stats[k], w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_seg_fast_solver_step_matches_jax(fast):
    """One f32 step of the port's solver with the seg_fast head against the
    JAX ``seg_fast=True`` solver (seg_normalize valid), at the tolerances of
    ``_compare_steps``."""
    bundle, variables = fast
    kw = dict(learning_rate=1e-3, batch_size=2, seg_normalize="valid")
    js = JaxSolver(bundle.model, bundle.anchors, **kw)
    port = _port(variables, seg_fast=True)
    ps = MultiTaskSolver(port.model, port.anchors, device="cpu", **kw)
    _compare_steps(js, _jax_state(js, variables), ps, ps.init_state(), variables, _batch(), 1)


def test_seg_fast_same_parameters_other_outputs(fast):
    """The port of ``tests/test_models.py::test_seg_fast_variant_same_params_and_shapes``:
    the fast head has the exact head's parameter tree (every name, shape and
    dtype), so one checkpoint loads into either; its seg logits have the
    exact head's shape and other values (conv and resize do not commute),
    while the detection outputs, which the seg head does not reach, are
    equal bit for bit."""
    _, variables = fast
    exact, quick = _port(variables), _port(variables, seg_fast=True)
    se, sf = exact.model.state_dict(), quick.model.state_dict()
    assert [(k, v.shape, v.dtype) for k, v in se.items()] == [(k, v.shape, v.dtype) for k, v in sf.items()]
    x = torch.ones(1, H, W, 3)
    with torch.inference_mode():
        oe, of = exact.model(x), quick.model(x)
    assert oe["seg_logits"].shape == of["seg_logits"].shape == (1, H // 4, W // 4, 19)
    assert not np.allclose(oe["seg_logits"].numpy(), of["seg_logits"].numpy(), atol=1e-3)
    for key in ("loc_preds", "cls_logits"):
        assert torch.equal(oe[key], of[key])


def test_seg_fast_sums_partial_results_in_float32():
    """bf16 streams: each partial result is summed in float32 and rounded
    once to bf16, as the JAX head (its sum is not a bf16 chain)."""
    torch.manual_seed(0)
    head = create_model("resnet-18_multi", (H, W), device="cpu", seg_fast=True).model.seg
    streams = [torch.randn(1, c, h, w).bfloat16() for c, h, w in
               ((128, 1, 2), (256, 2, 4), (512, 4, 8), (512, 4, 8), (256, 8, 16), (128, 16, 32))]
    with torch.no_grad():
        head.score3_conv.weight.copy_(head.score3_conv.weight.bfloat16().float())
        got = head._score_then_upsample([s for s in streams], (16, 32))
        assert got.dtype == torch.bfloat16
        w = head.score3_conv.weight.bfloat16()
        parts, off = [], 0
        for s in streams:
            c = s.shape[1]
            y = torch.nn.functional.conv2d(s, w[:, off:off + c], padding=1)
            parts.append(tl.resize_bilinear_align_corners(y, (16, 32)).float())
            off += c
        want = sum(parts[1:], parts[0]).bfloat16()
    assert torch.equal(got, want)


# ------------------------------------------------------------- remat


def _bns(model):
    return [m for m in model.modules() if isinstance(m, tl.BatchNorm)]


@pytest.mark.parametrize("dtype,seg_fast", [("float32", False), ("bfloat16", False), ("float32", True)])
def test_remat_step_equals_plain_bit_for_bit(dtype, seg_fast):
    """Two steps with every residual unit rematerialised equal two plain
    steps bit for bit on the CPU: metrics, parameters, momentum and running
    statistics. Each BatchNorm updates its running statistics once per step
    (``running_updates``), though the backbone's run twice (first pass and
    recompute), and the template module keeps its weights and mode."""
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    plain = create_model("resnet-18_multi", (H, W), device="cpu", generator=gen(), seg_fast=seg_fast)
    remat = create_model("resnet-18_multi", (H, W), device="cpu", generator=gen(), seg_fast=seg_fast,
                         remat=True)
    assert remat.model.backbone.remat and not plain.model.backbone.remat
    batch = canonical_train_batch(2, H, W, seed=5)
    batch["images"] = batch["images"] * 100.0
    kw = dict(learning_rate=1e-2, batch_size=2, seg_normalize="valid", compute_dtype=dtype, device="cpu")
    states, metrics = [], []
    calls = {}
    for bundle in (plain, remat):
        for m in _bns(bundle.model):
            m.running_updates = 0
        hooks = [m.register_forward_hook(lambda mod, i, o: calls.__setitem__(id(mod), calls.get(id(mod), 0) + 1))
                 for m in _bns(bundle.model)]
        solver = MultiTaskSolver(bundle.model, bundle.anchors, **kw)
        st = solver.init_state()
        for _ in range(2):
            st, m = solver.train_step(st, batch)
        for h in hooks:
            h.remove()
        states.append(st)
        metrics.append({k: float(v) for k, v in m.items()})
        assert all(m.running_updates == 2 for m in _bns(bundle.model))
        assert not bundle.model.training
    assert metrics[0] == metrics[1]
    for part in ("params", "buffers", "momentum"):
        a, b = getattr(states[0], part), getattr(states[1], part)
        for k in a:
            assert torch.equal(a[k], b[k]), (part, k)
    backbone = {id(m) for m in _bns(remat.model.backbone) if m is not remat.model.backbone.bn_data
                and m is not remat.model.backbone.bn0}
    for m in _bns(remat.model):
        assert calls[id(m)] == (4 if id(m) in backbone else 2), m
    for m in _bns(plain.model):
        assert calls[id(m)] == 2
    torch.testing.assert_close(remat.model.state_dict(), plain.model.state_dict(), rtol=0, atol=0)


def test_remat_step_matches_jax():
    """Two f32 steps of the port's solver with ``remat=True`` against the
    JAX ``remat=True`` solver on the same weights and batch, at the
    tolerances of ``_compare_steps``."""
    bundle = jax_create_model("resnet-18_multi", (H, W), remat=True)
    variables = random_flax_variables(bundle.model, (1, H, W, 3), seed=6, train=False)
    kw = dict(learning_rate=1e-3, batch_size=2, seg_normalize="valid")
    js = JaxSolver(bundle.model, bundle.anchors, **kw)
    port = _port(variables, remat=True)
    ps = MultiTaskSolver(port.model, port.anchors, device="cpu", **kw)
    _compare_steps(js, _jax_state(js, variables), ps, ps.init_state(), variables, _batch(seed=2), 2)


def test_remat_reaches_resnet_backbones_only():
    """``remat`` reaches a resnet backbone, of a multitask or a plain-SSD
    network; VGG16 and inceptionv3 have none to rematerialise (as in JAX)."""
    assert create_model("resnet-18", 96, device="meta", remat=True).model.backbone.remat
    for net, size in (("vgg16_reduced", 300), ("inceptionv3", 300)):
        m = create_model(net, size, device="meta", remat=True).model
        assert not hasattr(m.backbone, "remat")
