"""The serving slice of the PyTorch port vs the JAX package: uint8 BGR frames
through ``Detector.predict_raw`` (forward -> softmax -> decode -> NMS -> seg
argmax), float32 on the CPU, on the same seeded weights."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dspnet_tpu.api import create_model as jax_create_model
from dspnet_tpu.detect.detector import Detector as JaxDetector
from dspnet_tpu.ops.detection import multibox_detection as jax_detection
from dspnet_torch.api import create_model
from dspnet_torch.detect.detector import MEAN_PIXELS, Detector
from dspnet_torch.ops.detection import multibox_detection
from dspnet_torch.utils.convert import load_flax_variables
from tests.torch_parity import random_flax_variables

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

H, W = 128, 256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def slice_pair():
    bundle = jax_create_model("resnet-50_multi", (H, W))
    variables = random_flax_variables(bundle.model, (1, H, W, 3), seed=11, train=False)
    port = create_model("resnet-50_multi", (H, W), device="cpu")
    load_flax_variables(port.model, variables)
    frames = np.random.RandomState(5).randint(0, 256, (2, H, W, 3), np.uint8)
    return bundle, variables, port, frames


def test_predict_raw_matches_jax(slice_pair):
    bundle, variables, port, frames = slice_pair
    jdet = JaxDetector(bundle.model, variables, bundle.anchors, (H, W))
    pdet = Detector(port.model, port.anchors, (H, W), device="cpu", dtype=torch.float32)
    want = {k: np.asarray(v) for k, v in jdet.predict_raw(frames).items()}
    got = {k: v.numpy() for k, v in pdet.predict_raw(frames).items()}
    assert set(got) == set(want) == {"det", "seg"}
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    assert got["det"].shape == (2, 400, 7) and got["seg"].shape == (2, H // 4, W // 4)
    # argmax flips only where two logits tie to within f32 reassociation
    assert (got["seg"] == want["seg"]).mean() >= 0.999
    dets, seg = pdet.detect(frames[..., ::-1].astype(np.float32) - np.float32(MEAN_PIXELS))
    assert len(dets) == 2 and all((d[:, 0] >= 0).all() for d in dets)
    np.testing.assert_array_equal(seg, got["seg"])


def test_detection_on_jax_heads_matches_jax(slice_pair):
    """The port's detection stage, fed the JAX path's own head outputs (the
    softmax taken in JAX), reproduces the JAX det: ids and scores exactly,
    boxes and distance within 1e-6 (decode's exp may differ by an ulp)."""
    bundle, variables, _, frames = slice_pair
    images = jnp.asarray(frames)[..., ::-1].astype(jnp.float32) - jnp.asarray(MEAN_PIXELS, jnp.float32)
    out = jax.jit(lambda v, x: bundle.model.apply(v, x, train=False))(variables, images)
    cls_prob = jnp.swapaxes(jax.nn.softmax(out["cls_logits"], axis=-1), 1, 2)
    want = np.asarray(jax_detection(cls_prob, out["loc_preds"], bundle.anchors, nms_threshold=0.5))
    got = multibox_detection(torch.from_numpy(np.array(cls_prob)),
                             torch.from_numpy(np.array(out["loc_preds"])),
                             bundle.anchors, nms_threshold=0.5).numpy()
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0, atol=1e-6)
    assert (got[..., 0] >= 0).sum() > 0 and (got[..., 0] == -1).sum() > 0


def test_predict_raw_rejects_float_frames(slice_pair):
    _, _, port, frames = slice_pair
    pdet = Detector(port.model, port.anchors, (H, W), device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        pdet.predict_raw(frames.astype(np.float32))


def test_port_imports_no_jax():
    """Importing the package and every slice module loads none of jax,
    flax, cv2 or dspnet_tpu (the card's machine has none of them)."""
    modules = ["dspnet_torch", "dspnet_torch.api", "dspnet_torch.ops.anchors",
               "dspnet_torch.ops.boxes", "dspnet_torch.ops._build", "dspnet_torch.ops.nms_cuda",
               "dspnet_torch.ops.matching_cuda", "dspnet_torch.ops.target",
               "dspnet_torch.ops.detection", "dspnet_torch.models.factory",
               "dspnet_torch.models.layers", "dspnet_torch.models.resnet",
               "dspnet_torch.models.heads", "dspnet_torch.models.seg_head",
               "dspnet_torch.models.dspnet", "dspnet_torch.utils.convert",
               "dspnet_torch.utils.precision", "dspnet_torch.utils.benchmark",
               "dspnet_torch.detect.detector", "dspnet_torch.train.losses",
               "dspnet_torch.train.optim", "dspnet_torch.train.lr", "dspnet_torch.train.solver",
               "dspnet_torch.tools.export_serving"]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import dspnet_torch; dspnet_torch.create_model; dspnet_torch.Detector\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2', 'dspnet_tpu'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_detector_leaves_its_module_alone(slice_pair):
    """A bf16 Detector serves its own cast copy: the caller's float32 module
    keeps its dtype, its weights and its train mode (the JAX Detector never
    mutates the variables it is handed)."""
    _, _, port, frames = slice_pair
    model = port.model.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        det = Detector(model, port.anchors, (H, W), device="cpu", dtype=torch.bfloat16)
        det.predict_raw(frames[:1])
        assert model.training
        for k, v in model.state_dict().items():
            assert v.dtype == torch.float32, k
            assert torch.equal(v, before[k]), k
        assert all(p.dtype == torch.bfloat16 for p in det.model.parameters())
        assert not det.model.training
    finally:
        model.eval()


def test_make_detector_update_weights_matches_a_fresh_detector(slice_pair):
    """The solver's detector over a trained state, refreshed with
    ``update_weights``, gives the det of a Detector built fresh on a module
    holding the same weights."""
    from dspnet_torch.train.solver import MultiTaskSolver

    _, variables, port, frames = slice_pair
    solver = MultiTaskSolver(port.model, port.anchors, learning_rate=1e-3, batch_size=2,
                             seg_normalize="valid", device="cpu")
    state = solver.init_state()
    det = solver.make_detector(state, (H, W))
    labels = np.full((2, 8, 6), -1.0, np.float32)
    labels[:, 0] = [1, 0.2, 0.2, 0.7, 0.8, 0.3]
    batch = {"images": np.random.RandomState(1).normal(0, 50, (2, H, W, 3)).astype(np.float32),
             "label_det": labels,
             "seg_label": np.random.RandomState(2).randint(0, 19, (2, H // 4, W // 4)).astype(np.int32)}
    state, _ = solver.train_step(state, batch)
    det.update_weights(solver.detector_variables(state))
    fresh_model = create_model("resnet-50_multi", (H, W), device="cpu").model
    fresh_model.load_state_dict(solver.detector_variables(state))
    fresh = Detector(fresh_model, port.anchors, (H, W), device="cpu")
    got, want = det.predict_raw(frames), fresh.predict_raw(frames)
    assert torch.equal(got["det"], want["det"]) and torch.equal(got["seg"], want["seg"])
    stale = Detector(port.model, port.anchors, (H, W), device="cpu").predict_raw(frames)
    assert not torch.equal(stale["det"], got["det"])
