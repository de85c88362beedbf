"""Whole-network forward of the PyTorch port vs the JAX DSPNet, float32 eval
on the CPU, on the same seeded weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dspnet_tpu.api import create_model as jax_create_model
from dspnet_torch.api import create_model
from dspnet_torch.detect.detector import Detector
from dspnet_torch.models.layers import BatchNorm, Deconv2x, bilinear_upsample_kernel
from dspnet_torch.utils.convert import load_flax_variables
from tests.torch_parity import random_flax_variables

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

H, W = 128, 256


@pytest.mark.parametrize("network", ["resnet-50_multi", "resnet-18_multi"])
def test_forward_matches_jax(rng, network):
    """atol = 1e-4 * max|ref| per output: f32 reassociation through ~60
    layers (JAX runs the stem as a space-to-depth conv and the seg score
    conv as a tap-split; both are the same linear maps summed in another
    order)."""
    bundle = jax_create_model(network, (H, W))
    variables = random_flax_variables(bundle.model, (1, H, W, 3), seed=7, train=False)
    images = rng.normal(0, 50, (2, H, W, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: bundle.model.apply(v, x, train=False))(variables, jnp.asarray(images))

    port = create_model(network, (H, W), device="cpu")
    load_flax_variables(port.model, variables)
    np.testing.assert_array_equal(port.anchors, bundle.anchors)
    with torch.inference_mode():
        got = port.model(torch.from_numpy(images))
    assert set(got) == set(want) == {"loc_preds", "cls_logits", "seg_logits"}
    for key in want:
        w = np.asarray(want[key])
        g = got[key].numpy()
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=key)
    assert got["seg_logits"].shape == (2, H // 4, W // 4, 19)
    assert got["loc_preds"].shape == (2, bundle.anchors.shape[0], 5)


@pytest.mark.parametrize("task,keys", [("det", {"det"}), ("seg", {"seg"})])
def test_single_task_models_serve(task, keys):
    """The _det and _seg presets are the same module with one head; the
    detector returns only that head's result."""
    bundle = create_model(f"resnet-18_{task}", (H, W), device="cpu")
    assert (bundle.anchors is None) == (task == "seg")
    det = Detector(bundle.model, bundle.anchors, (H, W), device="cpu")
    res = det.predict_raw(np.zeros((1, H, W, 3), np.uint8))
    assert set(res) == keys
    has_seg = any(n.startswith("seg.") for n, _ in bundle.model.named_parameters())
    assert has_seg == (task == "seg")


def test_create_model_seeded_init():
    a = create_model("resnet-18_multi", (H, W), device="cpu", generator=torch.Generator().manual_seed(3))
    b = create_model("resnet-18_multi", (H, W), device="cpu", generator=torch.Generator().manual_seed(3))
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert not a.model.training
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    # lecun-normal: std sqrt(1/fan_in) within sampling error on a big kernel
    w = sa["backbone.stage4_unit1.conv2.weight"]
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.02
    assert float(w.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-6
    assert sa["multibox.cls_pred_0.bias"].abs().max() == 0
    deconv = a.model.seg.score4_conv
    assert isinstance(deconv, Deconv2x)
    np.testing.assert_array_equal(deconv.weight[3, 3].detach().numpy(), bilinear_upsample_kernel(4))
    assert deconv.weight[3, 4].abs().max() == 0
    for m in a.model.modules():
        if isinstance(m, BatchNorm):
            assert m.running_mean.abs().max() == 0 and (m.running_var == 1).all()


@pytest.mark.parametrize("network,error,match", [
    ("inceptionv3", NotImplementedError, "ROADMAP"),  # plain SSD on the unported backbone
    ("vgg16_reduced_multi", NotImplementedError, "3-tap resnet"),  # no multitask VGG in the reference
    ("inceptionv3_multi", NotImplementedError, "3-tap resnet"),
])
def test_create_model_rejects_unported(network, error, match):
    with pytest.raises(error, match=match):
        create_model(network, (H, W), device="cpu")


def test_create_model_rejects_non_multiple_of_8():
    with pytest.raises(ValueError, match="divisible by 8"):
        create_model("resnet-18_multi", (100, 200), device="cpu")
