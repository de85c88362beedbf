"""The training slice of the PyTorch port vs the JAX package, float32 on the
CPU: BatchNorm in training mode, the train-mode forward, losses, MXNet SGD,
the schedules, the freeze mask, the canonical batch, and whole solver steps
of resnet-18_multi at 128x256 from the same seeded numpy weights."""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from flax import linen as fnn

from dspnet_tpu.api import create_model as jax_create_model
from dspnet_tpu.models import layers as jl
from dspnet_tpu.train import losses as jax_losses
from dspnet_tpu.train.lr import lr_scheduler_from_epochs as jax_lr_from_epochs
from dspnet_tpu.train.lr import multifactor_schedule as jax_multifactor
from dspnet_tpu.train.optim import mxnet_sgd
from dspnet_tpu.train.solver import MultiTaskSolver as JaxSolver
from dspnet_tpu.train.solver import freeze_mask as jax_freeze_mask
from dspnet_tpu.utils.benchmark import canonical_train_batch as jax_canonical_train_batch
from dspnet_torch.api import create_model
from dspnet_torch.models import layers as tl
from dspnet_torch.train import losses
from dspnet_torch.train.lr import lr_scheduler_from_epochs, multifactor_schedule
from dspnet_torch.train.optim import MXNetSGD
from dspnet_torch.train.solver import MultiTaskSolver, TrainingDiverged, freeze_mask
from dspnet_torch.utils.benchmark import canonical_train_batch
from dspnet_torch.utils.convert import flax_path, load_flax_variables, to_flax_variables
from tests.torch_parity import random_flax_variables

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

H, W = 128, 256
TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _as_dict(tree):
    return {k: _as_dict(v) for k, v in tree.items()} if hasattr(tree, "items") else np.asarray(tree)


# ------------------------------------------------------------- BatchNorm


class _FlaxBN(fnn.Module):
    fix_gamma: bool

    @fnn.compact
    def __call__(self, x):
        return jl.BatchNorm(fix_gamma=self.fix_gamma, name="m")(x, train=True)


class _Holder(nn.Module):
    def __init__(self, m):
        super().__init__()
        self.m = m


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batchnorm_training_matches_jax(rng, fix_gamma):
    """Output, input and parameter gradients, and the updated running mean
    and (biased) variance, at rtol = atol = 1e-5 (the same f32 formula)."""
    x = rng.normal(0.5, 2, (2, 5, 6, 16)).astype(np.float32)
    cot = rng.normal(0, 1, x.shape).astype(np.float32)
    module = _FlaxBN(fix_gamma)
    variables = random_flax_variables(module, x.shape, seed=1)

    def f(params, x):
        y, upd = module.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                              mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))

    bn = load_flax_variables(_Holder(tl.BatchNorm(16, fix_gamma=fix_gamma)), variables).m.train()
    xt = _nchw(x).requires_grad_()
    yt = bn(xt)
    (yt * _nchw(cot)).sum().backward()
    np.testing.assert_allclose(yt.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx), **TOL)
    jp = gp["m"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(jp["bias"]), **TOL)
    if fix_gamma:
        assert bn.weight is None and "scale" not in jp
    else:
        np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(jp["scale"]), **TOL)
    js = stats["m"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(js["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(js["var"]), **TOL)
    # the biased variance: 0.9 * old + 0.1 * var(x) with ddof = 0
    old = variables["batch_stats"]["m"]["BatchNorm_0"]["var"]
    want_var = 0.9 * old + 0.1 * x.reshape(-1, 16).astype(np.float64).var(0)
    np.testing.assert_allclose(bn.running_var.numpy(), want_var, rtol=1e-5)


def test_batchnorm_bf16_training_keeps_f32_stats(rng):
    """bf16 activations and parameters over float32 running statistics: the
    statistics are taken in float32 and stay float32."""
    bn = tl.BatchNorm(8).train()
    x = torch.from_numpy(rng.normal(1.0, 3.0, (2, 8, 5, 7)).astype(np.float32))
    y = torch.func.functional_call(
        bn, {"weight": bn.weight.bfloat16(), "bias": bn.bias.bfloat16(),
             "running_mean": bn.running_mean, "running_var": bn.running_var},
        (x.bfloat16(),))
    assert y.dtype == torch.bfloat16 and bn.running_mean.dtype == torch.float32
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * x.double().mean((0, 2, 3)).numpy(),
                               rtol=1e-2)


# ------------------------------------------------------------- network


@pytest.fixture(scope="module")
def r18():
    """resnet-18_multi at 128x256 in both packages on the same numpy weights."""
    bundle = jax_create_model("resnet-18_multi", (H, W))
    variables = random_flax_variables(bundle.model, (1, H, W, 3), seed=3, train=False)
    return bundle, variables


def _port_model(variables):
    port = create_model("resnet-18_multi", (H, W), device="cpu")
    load_flax_variables(port.model, variables)
    return port


def test_train_mode_forward_matches_jax(r18, rng):
    """Outputs within 1e-4 * max|ref| (f32 reassociation, as the eval test)
    and every updated running statistic within 1e-4 * max|ref| of its tensor."""
    bundle, variables = r18
    images = rng.normal(0, 50, (2, H, W, 3)).astype(np.float32)
    want, upd = jax.jit(lambda v, x: bundle.model.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(images))
    port = _port_model(variables)
    model = port.model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    for key in want:
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=key)
    got_stats = dict(_leaves(to_flax_variables(model)["batch_stats"]))
    want_stats = dict(_leaves(_as_dict(upd["batch_stats"])))
    assert set(got_stats) == set(want_stats)
    for path, w in want_stats.items():
        np.testing.assert_allclose(got_stats[path], w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=path)


def test_flax_paths_and_inverse_converter(r18):
    """``to_flax_variables`` inverts ``load_flax_variables`` bit for bit, and
    ``flax_path`` names each parameter's leaf in the JAX tree."""
    _, variables = r18
    port = _port_model(variables)
    back = to_flax_variables(port.model)
    for collection in ("params", "batch_stats"):
        want = dict(_leaves(variables[collection]))
        got = dict(_leaves(back[collection]))
        assert set(got) == set(want), collection
        for path in want:
            np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    param_paths = set(dict(_leaves(variables["params"])))
    assert {flax_path(n) for n, _ in port.model.named_parameters()} == param_paths
    assert flax_path("seg.score4_conv.weight") == "seg/score4_conv/ConvTranspose_0/kernel"
    assert flax_path("backbone.bn_data.bias") == "backbone/bn_data/BatchNorm_0/bias"


@pytest.mark.parametrize("pattern", [None, "backbone/", "backbone/stage1", ".*BatchNorm_0/scale",
                                     "seg/|multibox/cls_pred"])
def test_freeze_mask_matches_jax(r18, pattern):
    _, variables = r18
    want = dict(_leaves(_as_dict(jax_freeze_mask(variables["params"], pattern))))
    port = _port_model(variables)
    got = freeze_mask(dict(port.model.named_parameters()), pattern)
    assert {flax_path(n): bool(v) for n, v in got.items()} == {p: bool(v) for p, v in want.items()}


# ------------------------------------------------------------- losses


def test_losses_match_jax(rng):
    """Each loss, its monitoring scalars, and the gradient of the combined
    objective w.r.t. every head output, at rtol = atol = 1e-5 (1e-4 relative
    for the unnormalized seg sum); both seg normalizations."""
    B, A, C = 2, 60, 9
    outputs = {
        "cls_logits": rng.normal(0, 2, (B, A, C)).astype(np.float32),
        "loc_preds": rng.normal(0, 1, (B, A, 5)).astype(np.float32),
        "seg_logits": rng.normal(0, 2, (B, 8, 16, 19)).astype(np.float32),
    }
    outputs["seg_logits"][0, 0, :4] = 0.5  # exact ties: counted correct (tie-lenient)
    cls_target = rng.randint(-1, C, (B, A)).astype(np.float32)
    loc_mask = np.repeat((cls_target > 0)[..., None], 5, -1).astype(np.float32)
    loc_target = rng.normal(0, 1, (B, A, 5)).astype(np.float32) * loc_mask
    seg = rng.randint(0, 19, (B, 8, 16)).astype(np.int32)
    seg[:, 0, 4:] = 255
    for normalize in ("null", "valid"):
        def jf(o):
            return jax_losses.multitask_loss(o, loc_target, loc_mask, cls_target, seg,
                                             seg_normalize=normalize)

        (_, want), jgrad = jax.value_and_grad(jf, has_aux=True)(jax.tree.map(jnp.asarray, outputs))
        t_out = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in outputs.items()}
        total, got = losses.multitask_loss(
            t_out, torch.from_numpy(loc_target), torch.from_numpy(loc_mask),
            torch.from_numpy(cls_target), torch.from_numpy(seg), seg_normalize=normalize)
        total.backward()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5, err_msg=k)
        for k in outputs:
            g = np.asarray(jgrad[k])
            np.testing.assert_allclose(t_out[k].grad.numpy(), g, rtol=1e-4, atol=1e-5 * np.abs(g).max(),
                                       err_msg=k)
    x = torch.tensor([-2.0, -0.5, 0.0, 0.5, 2.0])
    np.testing.assert_allclose(losses.smooth_l1(x).numpy(), [1.5, 0.125, 0.0, 0.125, 1.5], rtol=1e-6)
    loss, count = losses.cls_loss_valid(torch.zeros(1, 4, 3), torch.tensor([[0.0, 1.0, -1.0, 2.0]]))
    assert int(count) == 3 and float(loss) == pytest.approx(np.log(3.0), rel=1e-6)
    s = losses.seg_loss(torch.zeros(1, 2, 2, 19), torch.tensor([[[0, 255], [3, 255]]]), grad_scale=4.0)
    assert float(s) == pytest.approx(4.0 * 2 * np.log(19.0), rel=1e-6)


# ------------------------------------------------------------- optimizer


def test_mxnet_sgd_two_steps():
    """mom = mu*mom - lr*(g/r + wd*w); w += mom, twice (tests/test_train.py:40-57),
    and equal to the JAX transformation with a schedule read before the
    count increments."""
    w0 = np.array([1.0, -2.0], np.float32)
    g = np.array([0.5, 0.25], np.float32)
    lr, mu, wd, bs = 0.1, 0.9, 5e-4, 2
    w = torch.tensor(w0)
    mom = torch.zeros(2)
    opt = MXNetSGD(lr, mu, wd, rescale_grad=1.0 / bs)
    opt.step([w], [torch.tensor(g)], [mom], 0)
    want1 = w0 + (-lr * (g / bs + wd * w0))
    np.testing.assert_allclose(w.numpy(), want1, rtol=1e-6)
    mom1 = mom.clone().numpy()
    opt.step([w], [torch.tensor(g)], [mom], 1)
    want2 = mu * mom1 - lr * (g / bs + wd * want1)
    np.testing.assert_allclose(mom.numpy(), want2, rtol=1e-5)

    sched = multifactor_schedule(0.1, [1], 0.5)
    opt = MXNetSGD(sched, mu, wd, rescale_grad=1.0 / bs)
    tx = mxnet_sgd(jax_multifactor(0.1, [1], 0.5), mu, wd, rescale_grad=1.0 / bs)
    params = {"w": jnp.asarray(w0)}
    state = tx.init(params)
    w, mom = torch.tensor(w0), torch.zeros(2)
    for count in range(3):
        upd, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = {"w": params["w"] + upd["w"]}
        opt.step([w], [torch.tensor(g)], [mom], count)
        np.testing.assert_allclose(w.numpy(), np.asarray(params["w"]), rtol=1e-6)


def test_schedules_match_jax():
    sched, jsched = multifactor_schedule(1.0, [10, 20], 0.5), jax_multifactor(1.0, [10, 20], 0.5)
    for count in (0, 9, 10, 19, 20, 25):
        assert sched(count) == float(jsched(count))
    for args in [(0.02, "80,160", 0.5, 2975, 32, 100), (0.01, "2,4", 0.1, 10, 32, 0),
                 (0.004, "80", 1.0, 2975, 32, 0), (0.02, "3,5", 0.5, 100, 8, 4)]:
        lr, sched = lr_scheduler_from_epochs(*args)
        jlr, jsched = jax_lr_from_epochs(*args)
        assert lr == pytest.approx(jlr, rel=1e-12)
        for count in (0, 1, 11, 12, 13, 24, 100, 5000, 7440):
            assert sched(count) == pytest.approx(float(jsched(count)), rel=1e-6), (args, count)
    # a batch larger than the dataset: epoch_size 1, not 0
    _, sched = lr_scheduler_from_epochs(0.01, "2", 0.1, 10, 32)
    assert sched(0) == 0.01 and sched(2) == pytest.approx(0.001)


# ------------------------------------------------------------- batch


def test_canonical_train_batch_matches_jax():
    want = jax_canonical_train_batch(2, 64, 128, seed=3)
    got = canonical_train_batch(2, 64, 128, seed=3)
    assert set(got) == set(want) == {"images", "label_det", "seg_label"}
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert got["label_det"].shape == (2, 200, 6) and (got["label_det"][:, 8:] == -1).all()


# ------------------------------------------------------------- solver


def _tiny_batch(rng, B=2):
    labels = np.full((B, 16, 6), -1.0, np.float32)
    labels[:, 0] = [1, 0.2, 0.2, 0.7, 0.8, 0.3]
    labels[:, 1] = [3, 0.1, 0.4, 0.4, 0.9, 0.1]
    labels[1, 2] = [5, 0.5, 0.1, 0.9, 0.5, 0.6]
    seg = rng.randint(0, 19, (B, H // 4, W // 4)).astype(np.int32)
    seg[:, 0] = 255
    return {"images": (rng.randn(B, H, W, 3) * 50).astype(np.float32), "label_det": labels,
            "seg_label": seg}


def test_three_train_steps_match_jax(r18):
    """Three f32 steps of the port's solver vs ``dspnet_tpu``'s
    MultiTaskSolver from the same weights on the same batch.

    Tolerances: the loss trajectory within rtol 1e-4 (measured 2e-6);
    every running statistic within 1e-3 * max|ref| of its tensor (measured
    3e-5); each parameter's 3-step update and each momentum buffer within 4%
    of the largest update / momentum over the model (measured 0.8% / 1.2%).
    The last two are loose because the gradients of a ReLU network with
    random weights move discontinuously: perturbing the images by 1e-6
    (relative) moves the JAX package's own gradients by up to 2% in some
    tensors (ReLU and max-pool switches), and float32 reassociation between
    the two libraries perturbs as much."""
    bundle, variables = r18
    batch = _tiny_batch(np.random.RandomState(0))
    kw = dict(learning_rate=1e-3, batch_size=2, seg_normalize="valid")
    js = JaxSolver(bundle.model, bundle.anchors, **kw)
    st = js.init_state(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    params = jax.tree.map(jnp.asarray, variables["params"])
    st = st.replace(params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                    opt_state=js.tx.init(params))
    port = _port_model(variables)
    ps = MultiTaskSolver(port.model, port.anchors, device="cpu", **kw)
    pst = ps.init_state()
    for _ in range(3):
        st, want_m = js.train_step(st, batch)
        pst, got_m = ps.train_step(pst, batch)
        assert set(got_m) == set(want_m)
        for k in want_m:
            np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-4, err_msg=k)
    assert pst.step == int(st.step) == 3

    got = to_flax_variables({**pst.params, **pst.buffers})
    init = dict(_leaves(variables["params"]))
    got_p, want_p = dict(_leaves(got["params"])), dict(_leaves(_as_dict(st.params)))
    biggest = max(np.abs(want_p[k] - init[k]).max() for k in init)
    for k in init:
        np.testing.assert_allclose(got_p[k] - init[k], want_p[k] - init[k], rtol=0,
                                   atol=0.04 * biggest, err_msg=k)
    got_s, want_s = dict(_leaves(got["batch_stats"])), dict(_leaves(_as_dict(st.batch_stats)))
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=0, atol=1e-3 * np.abs(want_s[k]).max(),
                                   err_msg=k)
    got_mom = dict(_leaves(to_flax_variables(pst.momentum)["params"]))
    want_mom = dict(_leaves(_as_dict(st.opt_state.momentum)))
    biggest = max(np.abs(v).max() for v in want_mom.values())
    for k in want_mom:
        np.testing.assert_allclose(got_mom[k], want_mom[k], rtol=0, atol=0.04 * biggest, err_msg=k)
    # the template module keeps its weights and its mode
    assert not port.model.training
    untouched = dict(_leaves(to_flax_variables(port.model)["params"]))
    for k in init:
        np.testing.assert_array_equal(untouched[k], init[k], err_msg=k)


@pytest.fixture(scope="module")
def port_r18():
    return create_model("resnet-18_multi", (H, W), device="cpu")


def _solver(bundle, **kw):
    solver = MultiTaskSolver(bundle.model, bundle.anchors, learning_rate=1e-2, seg_normalize="valid",
                             device="cpu", **kw)
    return solver, solver.init_state()


def _assert_params_close(a, b, rtol=2e-5, atol=2e-6):
    for k in a.params:
        np.testing.assert_allclose(a.params[k].detach().numpy(), b.params[k].detach().numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_grad_accum_same_batch_twice_matches_single_step(port_r18):
    """Two microbatches of the same batch at grad_accum 2 are one update of
    2g / (2b) == g / b (tests/test_grad_accum.py:50-67); the running
    statistics update per microbatch."""
    batch = _tiny_batch(np.random.RandomState(7))
    s1, st1 = _solver(port_r18, batch_size=2)
    st1, _ = s1.train_step(st1, batch)
    s2, st2 = _solver(port_r18, batch_size=2, grad_accum=2)
    st2 = s2.fit(st2, [batch, batch], num_epochs=1, eval_every=0, log_fn=lambda *_: None)
    assert st2.step == 1
    _assert_params_close(st1, st2)
    # running means start at 0: one update leaves 0.1 m, two leave 0.19 m
    mean = "backbone.bn0.running_mean"
    np.testing.assert_allclose(st2.buffers[mean].numpy(), 1.9 * st1.buffers[mean].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_grad_accum_partial_tail_and_epochs(port_r18):
    """3 microbatches at grad_accum 2: one full update and one tail update;
    over 2 epochs the chunks carry across the boundary: 3 updates
    (tests/test_grad_accum.py:70-121)."""
    rng = np.random.RandomState(3)
    batches = [_tiny_batch(rng) for _ in range(3)]
    s, st = _solver(port_r18, batch_size=2, grad_accum=2)
    st = s.fit(st, batches, num_epochs=1, eval_every=0, log_fn=lambda *_: None)
    assert st.step == 2
    s, st = _solver(port_r18, batch_size=2, grad_accum=2)
    st = s.fit(st, batches, num_epochs=2, eval_every=0, log_fn=lambda *_: None)
    assert st.step == 3
    with pytest.raises(ValueError, match="fit"):
        s.train_step(st, batches[0])


def test_fit_logs_and_rejects_eval(port_r18, tmp_path):
    """Logging, the per-epoch means with the absolute epoch, the callbacks,
    and the validation pass: an eval without ``data_shape`` is rejected
    before any step; the pass runs when (absolute epoch + 1) % eval_every
    == 0 (epoch 5 of 5..6 at eval_every 2), after the epoch callback, on one
    float32 detector refreshed with the state's weights; it logs a
    validation line and sends finite metrics to the sink as 'val'."""
    from dspnet_torch.data.device_pipeline import DeviceAugIterator
    from dspnet_torch.data.synthetic import build_dataset

    val = DeviceAugIterator(build_dataset(str(tmp_path), num_samples=3, hw=(H, W), seed=91), 2, (H, W),
                            device="cpu", seed=233, enable_aug=False, shuffle=False, pad_last=True)
    rng = np.random.RandomState(9)
    s, st = _solver(port_r18, batch_size=2)
    with pytest.raises(ValueError, match="needs data_shape"):
        s.fit(st, [_tiny_batch(rng)], num_epochs=1, eval_iter=val, log_fn=lambda *_: None)
    assert st.step == 0
    lines, rows, ends = [], [], []
    st = s.fit(st, [_tiny_batch(rng), _tiny_batch(rng)], num_epochs=2, eval_iter=val, eval_every=2,
               data_shape=(H, W), log_fn=lines.append, log_every=1, epoch_offset=5,
               metrics_sink=lambda ep, split, m: rows.append((ep, split, m)),
               epoch_end_callback=lambda ep, state: ends.append((ep, state.step)))
    assert st.step == 4 and ends == [(0, 2), (1, 4)]
    assert [r[:2] for r in rows] == [(5, "train"), (5, "val"), (6, "train")]
    assert set(rows[0][2]) == {"cross_entropy", "smooth_l1", "valid_anchors", "seg_loss",
                               "seg_accuracy", "loss"}
    assert lines[0].startswith("epoch 5 batch 1: ") and any(x.startswith("epoch 6 done") for x in lines)
    val_rows = rows[1][2]
    assert {"mAP", "mIoU", "accuracy", "ms_per_batch"} <= set(val_rows)
    assert all(np.isfinite(v) for v in val_rows.values())
    assert 0.0 <= val_rows["mIoU"] <= 1.0 and 0.0 <= val_rows["accuracy"] <= 1.0
    assert sum(x.startswith("epoch 5 validation: mAP=") for x in lines) == 1
    det = s._val_detector
    assert det.dtype == torch.float32 and det.nms_thresh == 0.5
    # the detector serves the weights of the state at the pass (after epoch 5's
    # two steps), not the template's
    w = "multibox.cls_pred_0.weight"
    assert not torch.equal(det.model.state_dict()[w], port_r18.model.state_dict()[w])
    s.fit(st, [_tiny_batch(rng)], num_epochs=1, eval_iter=val, eval_every=1, log_fn=lines.append)
    assert s._val_detector is det  # one detector, refreshed
    torch.testing.assert_close(det.model.state_dict()[w], st.params[w].detach(), rtol=0, atol=0)


def test_training_diverged(port_r18):
    """A NaN metric stops fit() with TrainingDiverged at its first log sync."""
    MultiTaskSolver._check_finite({"loss": 1.0, "ce": 0.5}, 0, 20)
    with pytest.raises(TrainingDiverged, match="epoch 3 batch 20"):
        MultiTaskSolver._check_finite({"loss": float("nan")}, 3, 20)
    with pytest.raises(TrainingDiverged, match="seg-normalize"):
        MultiTaskSolver._check_finite({"loss": float("inf")}, 0, 1)
    batch = _tiny_batch(np.random.RandomState(2))
    batch["images"][0, 0, 0, 0] = np.nan
    s, st = _solver(port_r18, batch_size=2)
    with pytest.raises(TrainingDiverged):
        s.fit(st, [batch] * 3, num_epochs=1, eval_every=0, log_every=1, log_fn=lambda *_: None)


def test_bf16_compute_step_on_the_cpu(port_r18):
    """compute_dtype='bfloat16' runs on bf16 copies of float32 masters: the
    step is finite, the masters, statistics and momentum stay float32, the
    loss is near the float32 step's (within 2%: bf16 keeps ~3 digits), and
    the update points the way of the float32 update (cosine > 0.9, measured
    0.95: bf16 gradients and mining targets taken from bf16 logits move the
    update by ~30% in L2)."""
    batch = _tiny_batch(np.random.RandomState(4))
    sf, stf = _solver(port_r18, batch_size=2)
    sb, stb = _solver(port_r18, batch_size=2, compute_dtype="bfloat16")
    init = {k: v.detach().clone() for k, v in stf.params.items()}
    stf, mf = sf.train_step(stf, batch)
    stb, mb = sb.train_step(stb, batch)
    assert all(np.isfinite(float(v)) for v in mb.values())
    assert float(mb["loss"]) == pytest.approx(float(mf["loss"]), rel=2e-2)
    for d in (stb.params, stb.buffers, stb.momentum):
        assert all(v.dtype == torch.float32 for v in d.values())
    df = torch.cat([(stf.params[k] - init[k]).detach().flatten() for k in init])
    db = torch.cat([(stb.params[k] - init[k]).detach().flatten() for k in init])
    assert float(torch.nn.functional.cosine_similarity(df, db, dim=0)) > 0.9
