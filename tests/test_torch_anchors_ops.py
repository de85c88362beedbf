"""Anchors, box ops and multibox_detection of the PyTorch port vs the JAX
package, on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dspnet_tpu.api import create_model as jax_create_model
from dspnet_tpu.ops import boxes as jax_boxes
from dspnet_tpu.ops.detection import multibox_detection as jax_detection
from dspnet_torch.models import factory
from dspnet_torch.ops import boxes as torch_boxes
from dspnet_torch.ops.detection import multibox_detection

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores


@pytest.mark.parametrize("shape,num_anchors", [((512, 1024), 12264), ((128, 256), 772)])
def test_anchors_bit_identical(shape, num_anchors):
    want = jax_create_model("resnet-50_multi", shape).anchors
    got = factory.build_anchors(factory.get_config("resnet-50", shape[0]).drop_first_tap(), shape)
    assert got.shape == (num_anchors, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _random_boxes(rng, n):
    xy = rng.uniform(0.0, 0.8, (n, 2))
    wh = rng.uniform(0.0, 0.4, (n, 2))
    wh[:3] = 0.0  # zero-area boxes: union 0 between two of them
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_iou_matrix_matches_jax(rng):
    a, b = _random_boxes(rng, 40), _random_boxes(rng, 30)
    want = np.asarray(jax_boxes.iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = torch_boxes.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    # same op order in f32; 1e-6 covers one rounding of the division
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("clip", [True, False])
def test_decode_locations_matches_jax(rng, clip):
    anchors = _random_boxes(rng, 64)
    anchors[:, 2:] += 0.05  # positive extents
    loc = rng.normal(0, 1.0, (2, 64, 5)).astype(np.float32)
    wb, wd = jax_boxes.decode_locations(jnp.asarray(anchors), jnp.asarray(loc), clip=clip)
    gb, gd = torch_boxes.decode_locations(torch.from_numpy(anchors), torch.from_numpy(loc), clip=clip)
    # exp may differ by an ulp between the two math libraries
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=0, atol=1e-6)


def _head_outputs(rng, quantize):
    anchors = factory.build_anchors(factory.get_config("resnet-50", 128).drop_first_tap(), (128, 256))
    A = anchors.shape[0]
    logits = rng.normal(0, 2.0, (2, A, 9)).astype(np.float32)
    prob = np.exp(logits - logits.max(-1, keepdims=True))
    prob = (prob / prob.sum(-1, keepdims=True)).astype(np.float32)
    if quantize:  # ties in the class argmax and in the score sort
        prob = (np.round(prob * 16) / 16).astype(np.float32)
    loc = rng.normal(0, 0.5, (2, A, 5)).astype(np.float32)
    return np.swapaxes(prob, 1, 2).copy(), loc, anchors


@pytest.mark.parametrize("kwargs,quantize", [
    (dict(nms_threshold=0.45), False),
    (dict(nms_threshold=0.45, force_suppress=True), False),
    (dict(nms_threshold=0.5, nms_topk=100), False),
    (dict(nms_threshold=0.0, threshold=0.3), False),  # NMS off: (B, A, 7) in anchor order
    (dict(nms_threshold=0.5, nms_topk=-1, threshold=0.2), False),  # K = A
    (dict(nms_threshold=0.45), True),
    (dict(nms_threshold=0.45, force_suppress=True, threshold=0.3), True),
])
def test_multibox_detection_matches_jax(rng, kwargs, quantize):
    cls_prob, loc, anchors = _head_outputs(rng, quantize)
    want = np.asarray(jax_detection(jnp.asarray(cls_prob), jnp.asarray(loc), anchors, **kwargs))
    got = multibox_detection(torch.from_numpy(cls_prob), torch.from_numpy(loc), anchors, **kwargs).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    # ids (suppression and sentinel rows included) and scores exactly: they
    # are the same f32 values picked in the same stable order
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    # boxes and distance to the decode tolerance (exp may differ by an ulp)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0, atol=1e-6)
    assert (got[..., 0] == -1).any() and (got[..., 0] >= 0).any()
