"""The inceptionv3 plain SSD of the PyTorch port vs the JAX package, float32
on the CPU, on the same seeded weights: the preset, the feature maps and the
anchor tables at 300 and 512 (A = 1,668 / 5,186), the parameter tree, the
forward at 160x160 in eval and train mode (batch statistics and their
running update, BatchNorm eps 1e-3), the flax round trip, two solver steps
and the detector's rows. At 160x160 the taps are 8x8 and 3x3 (A = 348)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dspnet_tpu.api import create_model as jax_create_model
from dspnet_tpu.detect.detector import Detector as JaxDetector
from dspnet_tpu.models import factory as jax_factory
from dspnet_tpu.train.solver import MultiTaskSolver as JaxSolver
from dspnet_torch.api import create_model
from dspnet_torch.detect.detector import Detector
from dspnet_torch.models import factory
from dspnet_torch.models.dspnet import SSDNet
from dspnet_torch.models.inception import INCEPTION_BN_EPS, InceptionV3
from dspnet_torch.models.layers import BatchNorm
from dspnet_torch.train.solver import MultiTaskSolver
from dspnet_torch.utils.convert import _flax_leaf, flax_to_state_dict, load_flax_variables, to_flax_variables
from tests.torch_parity import random_flax_variables

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

S = 160
A = 348  # feature maps 8, 3, 2, 1, 1, 1


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("size,shapes,num_anchors", [
    (300, [(17, 17), (8, 8), (4, 4), (2, 2), (1, 1), (1, 1)], 1668),
    (512, [(30, 30), (14, 14), (7, 7), (4, 4), (2, 2), (1, 1)], 5186),
])
def test_inception_preset_and_anchors_match_jax(size, shapes, num_anchors):
    """The preset, the six feature maps (pinned), the anchor table (bit for
    bit) and the parameter tree (every flax path and shape) equal the JAX
    package's at full size; the port's model is built on the meta device."""
    want = jax_create_model("inceptionv3", size, num_classes=20)
    got = create_model("inceptionv3", size, 20, device="meta")
    assert got.task == want.task == "ssd"
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    assert factory.feature_shapes(got.cfg, (size, size)) == shapes
    assert jax_factory.feature_shapes(want.cfg, (size, size)) == shapes
    np.testing.assert_array_equal(got.anchors, want.anchors)
    assert got.num_anchors == want.num_anchors == num_anchors
    tree = jax.eval_shape(lambda: want.model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)),
                                                  train=False))
    flax_shapes = {(p[0].key, "/".join(k.key for k in p[1:])): tuple(leaf.shape)
                   for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    port_shapes = {}
    for name, t in got.model.state_dict().items():
        collection, path = _flax_leaf(name)
        shape = tuple(t.shape)
        if path[-1] == "kernel":
            shape = (shape[2], shape[3], shape[1], shape[0])
        port_shapes[(collection, "/".join(path))] = shape
    assert port_shapes == flax_shapes
    assert "params/backbone/mixed_7/tdb/conv/kernel" in {f"{c}/{p}" for c, p in port_shapes}


def test_inception_batchnorm_eps_and_multitask_refusal():
    """Every inception BatchNorm is fix_gamma with MXNet's default eps 1e-3
    (the reference passes none); the multitask heads refuse the backbone as
    the JAX DSPNet does."""
    bns = [m for m in InceptionV3().modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 94 and INCEPTION_BN_EPS == 1e-3
    assert all(m.eps == 1e-3 and m.weight is None for m in bns)
    with pytest.raises(NotImplementedError, match="3-tap resnet"):
        create_model("inceptionv3_multi", S, device="cpu")


@pytest.fixture(scope="module")
def inception():
    """The JAX SSDNet, its seeded variables, and the port's model on them."""
    bundle = jax_create_model("inceptionv3", (S, S), num_classes=8)
    variables = random_flax_variables(bundle.model, (1, S, S, 3), seed=11, train=False)
    port = create_model("inceptionv3", (S, S), num_classes=8, device="cpu")
    load_flax_variables(port.model, variables)
    assert port.num_anchors == bundle.num_anchors == A
    np.testing.assert_array_equal(port.anchors, bundle.anchors)
    assert factory.feature_shapes(port.cfg, (S, S)) == [(8, 8), (3, 3), (2, 2), (1, 1), (1, 1), (1, 1)]
    return bundle, variables, port


def _images(seed, b=2):
    return np.random.RandomState(seed).normal(0, 50, (b, S, S, 3)).astype(np.float32)


def test_inception_forward_matches_jax_eval(inception):
    """Eval mode (running statistics) on converted weights, within
    1e-4 * max|ref| per output (f32 reassociation through 47 conv layers;
    measured 3e-6 on the taps)."""
    bundle, variables, port = inception
    images = _images(4)
    want = bundle.model.apply(variables, jnp.asarray(images), train=False)
    with torch.inference_mode():
        got = port.model.eval()(torch.from_numpy(images))
    for key, shape in (("loc_preds", (2, A, 4)), ("cls_logits", (2, A, 9))):
        w = np.asarray(want[key])
        assert got[key].shape == w.shape == shape
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=key)


def test_inception_forward_matches_jax_train(inception):
    """Train mode (batch statistics, BatchNorm eps 1e-3, and the running
    update): the outputs within 3e-3 * max|ref| and the updated running
    statistics within 1e-3 * max|ref| + 1e-6. Train-mode BatchNorm
    renormalises every layer by statistics of few values (18 per channel at
    mixed_10), so float32 reassociation grows along the chain of 47 of
    them: measured 1e-6 after the first layer, 2e-4 relative at mixed_7,
    7e-4 at mixed_10; in eval mode the same weights agree to 3e-6."""
    bundle, variables, _ = inception
    images = _images(4)
    want, updates = bundle.model.apply(variables, jnp.asarray(images), train=True, mutable=["batch_stats"])
    port = SSDNet(factory.get_config("inceptionv3", S), num_classes=8)
    load_flax_variables(port, variables)
    with torch.no_grad():
        got = port.train()(torch.from_numpy(images))
    for key in ("loc_preds", "cls_logits"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=3e-3 * np.abs(w).max(), err_msg=key)
    after = _flat(to_flax_variables(port)["batch_stats"])
    for k, w in _flat(updates["batch_stats"]).items():
        np.testing.assert_allclose(after[k], w, rtol=0, atol=1e-3 * np.abs(w).max() + 1e-6, err_msg=k)


def test_inception_flax_round_trip(inception):
    """to_flax_variables(load_flax_variables(tree)) gives the tree back bit
    for bit, every leaf."""
    _, variables, port = inception
    back = to_flax_variables(port.model)
    for coll in variables:
        want, got = _flat(variables[coll]), _flat(back[coll])
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_inception_solver_steps_match_jax(inception):
    """Two f32 steps of the port's solver on the inceptionv3 SSD vs
    ``dspnet_tpu``'s, each from the same state (the second from the JAX
    state after the first: parameters, running statistics and momentum),
    on the same batch: the same metric names, the losses within rtol 1e-5
    (measured 3e-6 / 8e-6), each parameter's update within 4% of the
    largest update over the model (the ReLU-switch bound of
    test_torch_train.py; measured 1.9%), the running statistics within
    1e-3 * max|ref|. (Chained, the two packages' second steps drift apart
    by 0.4% in the loss and 32% of an update in the stem: the first update
    carries the train-mode drift of the forward test through 47
    renormalising layers.)"""
    bundle, variables, port = inception
    labels = np.full((2, 100, 6), -1.0, np.float32)
    labels[0, 0] = [2, 0.1, 0.2, 0.6, 0.7, 0]
    labels[0, 1] = [5, 0.4, 0.1, 0.9, 0.6, 0]
    labels[1, 0] = [7, 0.2, 0.3, 0.8, 0.9, 0]
    batch = {"images": _images(0), "label_det": labels}
    js = JaxSolver(bundle.model, bundle.anchors, learning_rate=1e-3, batch_size=2)
    st = js.init_state(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    params = jax.tree.map(jnp.asarray, variables["params"])
    st = st.replace(params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                    opt_state=js.tx.init(params))
    ps = MultiTaskSolver(port.model, port.anchors, learning_rate=1e-3, batch_size=2, device="cpu")
    pst = ps.init_state()
    for step in range(2):
        before = _flat(jax.tree.map(np.asarray, st.params))
        if step:  # start from the JAX state
            tree = {"params": jax.tree.map(np.array, st.params),
                    "batch_stats": jax.tree.map(np.array, st.batch_stats)}
            with torch.no_grad():
                for k, v in flax_to_state_dict(tree).items():
                    (pst.params if k in pst.params else pst.buffers)[k].copy_(v)
                mom = flax_to_state_dict({"params": jax.tree.map(np.array, st.opt_state.momentum)})
                for k, v in mom.items():
                    pst.momentum[k].copy_(v)
        st, want_m = js.train_step(st, batch)
        pst, got_m = ps.train_step(pst, batch)
        assert set(got_m) == set(want_m) and "seg_loss" not in got_m
        for k in want_m:
            np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-5, err_msg=(step, k))
        got = to_flax_variables({**pst.params, **pst.buffers})
        after, got_p = _flat(jax.tree.map(np.asarray, st.params)), _flat(got["params"])
        biggest = max(np.abs(after[k] - v).max() for k, v in before.items())
        assert biggest > 0
        for k, v in before.items():
            np.testing.assert_allclose(got_p[k] - v, after[k] - v, rtol=0, atol=0.04 * biggest, err_msg=(step, k))
        stats = _flat(got["batch_stats"])
        for k, w in _flat(jax.tree.map(np.asarray, st.batch_stats)).items():
            np.testing.assert_allclose(stats[k], w, rtol=0, atol=1e-3 * np.abs(w).max(), err_msg=(step, k))
    assert pst.step == int(st.step) == 2


def test_inception_detector_rows_match_jax(inception):
    """``Detector.predict`` on the inceptionv3 SSD: class ids equal on at
    least 99.5% of the rows (ties in order flip), scores and boxes within
    1e-4 where the ids agree, as the JAX detector, with and without
    ``force_suppress``; K = min(400, A) rows."""
    bundle, variables, port = inception
    images = _images(3)
    for force in (False, True):
        want = np.asarray(JaxDetector(bundle.model, variables, bundle.anchors, (S, S), nms_thresh=0.45,
                                      force_suppress=force).predict(images)["det"])
        got = Detector(port.model, port.anchors, (S, S), device="cpu", nms_thresh=0.45,
                       force_suppress=force).predict(images)["det"].numpy()
        assert got.shape == want.shape == (2, A, 7)
        same = got[..., 0] == want[..., 0]
        assert same.mean() >= 0.995
        np.testing.assert_allclose(got[same][:, 1:6], want[same][:, 1:6], rtol=0, atol=1e-4)
        assert (got[..., 0] >= 0).sum() > 0
