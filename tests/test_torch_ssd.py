"""The plain-SSD models of the PyTorch port vs the JAX package, float32 on
the CPU, on the same seeded weights: the presets and anchor tables, the
three VGG16-reduced ops (L2Normalize, the 'full' max pool, the dilated
fc6), whole SSDNet forwards, a resnet-18 SSD solver step and the detector's
rows on 4-channel heads."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from dspnet_tpu.api import create_model as jax_create_model
from dspnet_tpu.detect.detector import Detector as JaxDetector
from dspnet_tpu.models import factory as jax_factory
from dspnet_tpu.models import layers as jl
from dspnet_tpu.models.dspnet import SSDNet as JaxSSDNet
from dspnet_tpu.train.solver import MultiTaskSolver as JaxSolver
from dspnet_torch.api import create_model, parse_network_name
from dspnet_torch.detect.detector import Detector
from dspnet_torch.models import factory
from dspnet_torch.models.dspnet import SSDNet
from dspnet_torch.models.layers import L2Normalize, conv, max_pool_full
from dspnet_torch.train.solver import MultiTaskSolver
from dspnet_torch.utils.convert import _flax_leaf, load_flax_variables, to_flax_variables
from tests.torch_parity import random_flax_variables

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("network,size,num_anchors", [
    ("vgg16_reduced", 300, 8732), ("vgg16_reduced", 512, 24576),
    ("legacy_vgg16_ssd_300", 300, 8732), ("legacy_vgg16_ssd_512", 512, 24564),
    ("resnet-18", 96, 812), ("resnet-50", 512, None),
])
def test_presets_anchors_and_parameters_match_jax(network, size, num_anchors):
    """The preset (every NetConfig field), the anchor table (bit for bit) and
    the parameter tree (every flax path and shape) equal the JAX package's at
    full size; the port's model is built on the meta device."""
    want = jax_create_model(network, size)
    got = create_model(network, size, device="meta")
    assert got.task == want.task == "ssd"
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    np.testing.assert_array_equal(got.anchors, want.anchors)
    assert got.num_anchors == want.num_anchors
    if num_anchors is not None:
        assert got.num_anchors == num_anchors
    shapes = jax.eval_shape(lambda: want.model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)),
                                                    train=False))
    flax_shapes = {(p[0].key, "/".join(k.key for k in p[1:])): tuple(leaf.shape)
                   for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    port_shapes = {}
    for name, t in got.model.state_dict().items():
        collection, path = _flax_leaf(name)
        shape = tuple(t.shape)
        if path[-1] == "kernel":
            shape = (shape[2], shape[3], shape[1], shape[0])
        port_shapes[(collection, "/".join(path))] = shape
    assert port_shapes == flax_shapes


def test_legacy_names_and_the_512_legacy_kernel():
    """Every legacy_vgg16_ssd* name is the legacy preset; at 512 its last
    extra layer is the 4x4 conv (legacy_vgg16_ssd_512.py:117-118)."""
    assert parse_network_name("legacy_vgg16_ssd_512") == ("legacy_vgg16_ssd", "ssd")
    assert parse_network_name("legacy_vgg16_ssd") == ("legacy_vgg16_ssd", "ssd")
    assert parse_network_name("vgg16_reduced") == ("vgg16_reduced", "ssd")
    m = create_model("legacy_vgg16_ssd_512", 512, device="meta").model
    assert m.multi_feat.multi_feat_6_conv_3x3.conv.weight.shape == (256, 128, 4, 4)
    assert factory.get_config("legacy_vgg16_ssd", 300) == factory.get_config("vgg16_reduced", 300)


def test_l2normalize_matches_jax(rng):
    """f32: within 2e-6 * max|ref| (a sum of squares over 512 channels in
    another order). bf16 input: the sum, the division and the scale run in
    float32, so the output is the f32 result of the bf16-rounded input,
    rounded once to bf16."""
    x = (rng.normal(0, 3, (2, 5, 7, 512)) * (rng.rand(2, 5, 7, 1) > 0.1)).astype(np.float32)
    scale = rng.uniform(5, 25, 512).astype(np.float32)
    want = np.asarray(jl.L2Normalize(20.0).apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x)))
    m = L2Normalize(512)
    assert torch.equal(m.scale.detach(), torch.full((512,), 20.0))
    with torch.no_grad():
        m.scale.copy_(torch.from_numpy(scale))
        got = _nhwc(m(_nchw(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())
        xb = _nchw(x).bfloat16()
        gb = m(xb)
        assert gb.dtype == torch.bfloat16
        ref = m(xb.float()).bfloat16()
        assert torch.equal(gb, ref)


@pytest.mark.parametrize("size", [(75, 75), (38, 37), (19, 20), (5, 6), (1, 2)])
def test_max_pool_full_matches_jax(rng, size):
    """MXNet's 'full' 2x2/2 pool (VGG16's pool3) equals the JAX one bit for
    bit at odd and even sizes: no window starts in the padding there."""
    x = rng.normal(0, 1, (2,) + size + (3,)).astype(np.float32)
    want = np.asarray(jl.max_pool_full(jnp.asarray(x), 2, 2))
    got = _nhwc(max_pool_full(_nchw(x), 2, 2))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_max_pool_full_refuses_a_window_in_the_padding():
    """A 3x3 stride-3 pad-1 pool on 5 cells: MXNet's ceil size (3) keeps a
    window that starts in the padding, torch's ceil_mode drops it (2); the
    function says so instead of returning the other size."""
    with pytest.raises(ValueError, match="starts in the padding"):
        max_pool_full(torch.zeros(1, 1, 5, 5), 3, 3, 1)


@pytest.mark.parametrize("size", [(19, 19), (10, 11), (3, 5)])
def test_fc6_dilated_conv_matches_jax(rng, size):
    """VGG16's fc6 (3x3, dilation 6, pad 6) at odd sizes, where most taps
    fall in the padding: within 1e-5 * max|ref|."""
    x = rng.normal(0, 1, (1,) + size + (16,)).astype(np.float32)
    k = rng.normal(0, 0.1, (3, 3, 16, 8)).astype(np.float32)
    b = rng.normal(0, 0.1, 8).astype(np.float32)
    flax_conv = fnn.Conv(8, (3, 3), padding=[(6, 6), (6, 6)], kernel_dilation=(6, 6))
    want = np.asarray(flax_conv.apply({"params": {"kernel": k, "bias": b}}, jnp.asarray(x)))
    m = conv(16, 8, 3, 1, 6, dilation=6)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        m.bias.copy_(torch.from_numpy(b))
        got = _nhwc(m(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("network,preset,size", [("vgg16_reduced", 512, 160), ("resnet-18", 96, 96)])
def test_ssdnet_forward_matches_jax(rng, network, preset, size):
    """SSDNet forwards on converted weights, within 1e-4 * max|ref| per
    output (f32 reassociation through 15-20 layers; measured 4e-6). The
    vgg16_reduced network takes the 512 preset at 160x160 (the 300 preset
    needs an input of at least ~264 for its pad-0 layers), built as the JAX
    test_det_path builds its resnet SSD."""
    cfg = jax_factory.get_config(network, preset)
    jmodel = JaxSSDNet(cfg=cfg, num_classes=8)
    variables = random_flax_variables(jmodel, (1, size, size, 3), seed=7, train=False)
    images = rng.normal(0, 50, (2, size, size, 3)).astype(np.float32)
    want = jmodel.apply(variables, jnp.asarray(images), train=False)
    port = SSDNet(factory.get_config(network, preset), num_classes=8).eval()
    load_flax_variables(port, variables)
    with torch.inference_mode():
        got = port(torch.from_numpy(images))
    anchors = factory.build_anchors(factory.get_config(network, preset), (size, size))
    np.testing.assert_array_equal(anchors, jax_factory.build_anchors(cfg, (size, size)))
    assert set(got) == set(want) == {"loc_preds", "cls_logits"}
    assert got["loc_preds"].shape == (2, anchors.shape[0], 4)
    for key in want:
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=key)
    back = to_flax_variables(port)
    for coll in variables:
        for path, leaf in jax.tree_util.tree_leaves_with_path(variables[coll]):
            node = back[coll]
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node, leaf)


@pytest.fixture(scope="module")
def r18_ssd():
    bundle = jax_create_model("resnet-18", (96, 96), num_classes=8)
    variables = random_flax_variables(bundle.model, (1, 96, 96, 3), seed=5, train=False)
    port = create_model("resnet-18", (96, 96), num_classes=8, device="cpu")
    load_flax_variables(port.model, variables)
    return bundle, variables, port


def _ssd_batch(rng):
    images = rng.normal(0, 50, (2, 96, 96, 3)).astype(np.float32)
    labels = np.full((2, 100, 6), -1.0, np.float32)
    labels[0, 0] = [2, 0.1, 0.2, 0.5, 0.7, 0]
    labels[0, 1] = [5, 0.5, 0.1, 0.9, 0.6, 0]
    labels[1, 0] = [7, 0.3, 0.3, 0.8, 0.9, 0]
    return {"images": images, "label_det": labels}


def test_ssd_solver_steps_match_jax(r18_ssd):
    """Two f32 steps of the port's solver on the 4-channel resnet-18 SSD vs
    ``dspnet_tpu``'s (the JAX test_det_path's step), same weights and batch:
    the same metric names (no seg loss), the losses within rtol 1e-4, each
    parameter's update within 4% of the largest update over the model (the
    ReLU-switch bound of test_torch_train.py)."""
    bundle, variables, port = r18_ssd
    batch = _ssd_batch(np.random.RandomState(0))
    js = JaxSolver(bundle.model, bundle.anchors, learning_rate=1e-3, batch_size=2)
    st = js.init_state(jax.random.PRNGKey(0), jnp.zeros((1, 96, 96, 3)))
    params = jax.tree.map(jnp.asarray, variables["params"])
    st = st.replace(params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                    opt_state=js.tx.init(params))
    ps = MultiTaskSolver(port.model, port.anchors, learning_rate=1e-3, batch_size=2, device="cpu")
    pst = ps.init_state()
    for _ in range(2):
        st, want_m = js.train_step(st, batch)
        pst, got_m = ps.train_step(pst, batch)
        assert set(got_m) == set(want_m) and "seg_loss" not in got_m
        for k in want_m:
            np.testing.assert_allclose(float(got_m[k]), float(want_m[k]), rtol=1e-4, err_msg=k)
    got = to_flax_variables({**pst.params, **pst.buffers})["params"]
    init, after = variables["params"], jax.tree.map(np.asarray, st.params)
    pairs = [(jax.tree_util.keystr(p), leaf) for p, leaf in jax.tree_util.tree_leaves_with_path(init)]
    flat_got = dict((jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_leaves_with_path(got))
    flat_after = dict((jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_leaves_with_path(after))
    biggest = max(np.abs(flat_after[k] - v).max() for k, v in pairs)
    assert biggest > 0
    for k, v in pairs:
        np.testing.assert_allclose(flat_got[k] - v, flat_after[k] - v, rtol=0, atol=0.04 * biggest, err_msg=k)


def test_detector_rows_on_4_channel_heads_match_jax(r18_ssd):
    """``Detector.predict`` on the 4-channel SSD (decoded distance 0):
    class ids equal on at least 99.5% of the rows (ties in order flip),
    scores and boxes within 1e-4 where the ids agree, distance all 0 on the
    scored rows, as the JAX detector; ``force_suppress`` also through."""
    bundle, variables, port = r18_ssd
    images = np.random.RandomState(3).normal(0, 50, (2, 96, 96, 3)).astype(np.float32)
    for force in (False, True):
        want = np.asarray(JaxDetector(bundle.model, variables, bundle.anchors, (96, 96), nms_thresh=0.45,
                                      force_suppress=force).predict(images)["det"])
        got = Detector(port.model, port.anchors, (96, 96), device="cpu", nms_thresh=0.45,
                       force_suppress=force).predict(images)["det"].numpy()
        assert got.shape == want.shape == (2, 400, 7)
        same = got[..., 0] == want[..., 0]
        assert same.mean() >= 0.995
        np.testing.assert_allclose(got[same][:, 1:6], want[same][:, 1:6], rtol=0, atol=1e-4)
        scored = got[..., 1] >= 0
        assert (got[scored][:, 6] == 0).all() and (want[want[..., 1] >= 0][:, 6] == 0).all()
