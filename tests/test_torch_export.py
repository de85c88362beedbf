"""The serving bundle of the PyTorch port (``tools/export_serving.py``) vs the
JAX tool's, on the CPU: the ``torch.export`` round trip bit for bit, the
manifest, the bundle against the JAX bundle on the same flax weights, the
NMS operator (``dspnet::nms_keep_mask``) under ``torch.library.opcheck``, a
load without the model code, and the CLI."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dspnet_tpu.api import create_model as jax_create_model
from dspnet_tpu.ops.detection import multibox_detection as jax_detection
from dspnet_tpu.tools import export_serving as jax_export
from dspnet_torch.api import create_model
from dspnet_torch.detect.detector import MEAN_PIXELS
from dspnet_torch.ops import nms_cuda
from dspnet_torch.ops.detection import multibox_detection
from dspnet_torch.tools import export_serving
from dspnet_torch.utils.convert import load_flax_variables
from tests.torch_parity import near_threshold_rows, random_flax_variables, random_nms_rows, with_boundary_rows

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

H, W, B = 128, 256, 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = np.asarray(MEAN_PIXELS, np.float32)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """The same seeded flax weights exported by both tools at B=2, and frames."""
    tmp = tmp_path_factory.mktemp("export")
    jbundle = jax_create_model("resnet-18_multi", (H, W), num_classes=8)
    variables = random_flax_variables(jbundle.model, (1, H, W, 3), seed=21, train=False)
    port = create_model("resnet-18_multi", (H, W), device="cpu")
    load_flax_variables(port.model, variables)
    jpath = jax_export.export_bundle(jbundle, variables, str(tmp / "m.jaxexp"), B, (H, W))
    ppath = export_serving.export_bundle(port, str(tmp / "m.pt2"), B, (H, W))
    frames = np.random.RandomState(7).randint(0, 256, (B, H, W, 3), np.uint8)
    return dict(jbundle=jbundle, variables=variables, port=port, jpath=jpath, ppath=ppath,
                frames=frames, tmp=tmp)


def test_roundtrip_matches_live_pipeline(bundles):
    """The loaded bundle equals the live serving module bit for bit, runs the
    plain NMS once per call on the CPU, and its manifest carries the JAX
    manifest's keys and values for the same arguments."""
    serve = export_serving.load_bundle(bundles["ppath"])
    raw = torch.from_numpy(bundles["frames"])
    calls = nms_cuda.plain_calls
    det, seg = serve(raw)
    assert nms_cuda.plain_calls == calls + 1
    with torch.no_grad():
        want_det, want_seg = export_serving.build_serve_fn(bundles["port"].model, bundles["port"].anchors)(raw)
    assert torch.equal(det, want_det) and torch.equal(seg, want_seg)
    assert det.shape == (B, 400, 7) and det.dtype == torch.float32
    assert seg.shape == (B, H // 4, W // 4) and seg.dtype == torch.int32
    manifest = json.load(open(bundles["ppath"] + ".json"))
    assert manifest == json.load(open(bundles["jpath"] + ".json"))
    assert manifest["num_anchors"] == bundles["port"].num_anchors and manifest["dtype"] == "float32"


def test_bundle_matches_jax_bundle(bundles):
    """The port's bundle and the JAX bundle on the same weights and frames:
    the same shapes and dtypes, and seg equal on >= 0.999 of the pixels
    (``test_predict_raw_matches_jax``'s tolerance: argmax flips only where
    two logits tie to within float32 reassociation)."""
    jdet, jseg = (np.asarray(x) for x in jax_export.load_bundle(bundles["jpath"])(bundles["frames"]))
    det, seg = (x.numpy() for x in export_serving.load_bundle(bundles["ppath"])(torch.from_numpy(bundles["frames"])))
    assert det.shape == jdet.shape and det.dtype == jdet.dtype == np.float32
    assert seg.shape == jseg.shape and seg.dtype == jseg.dtype == np.int32
    assert (seg == jseg).mean() >= 0.999
    assert (det[..., 0] >= 0).sum() > 0


def test_detection_on_jax_heads_matches_jax_bundle(bundles):
    """The port's detection stage at the bundle's settings (NMS 0.45, score
    0.01, top 400), fed the JAX network's own heads (the softmax taken in
    JAX), reproduces the JAX bundle's det on ids and scores exactly. Its
    boxes and distance equal the JAX detection stage's on the same heads
    within 1e-6 (decode's exp may differ by an ulp); the bundle's own are
    compared within 1e-4, since XLA compiles the exported decode fused."""
    jbundle, frames = bundles["jbundle"], bundles["frames"]
    images = jnp.asarray(frames)[..., ::-1].astype(jnp.float32) - jnp.asarray(MEAN)
    out = jax.jit(lambda v, x: jbundle.model.apply(v, x, train=False))(bundles["variables"], images)
    cls_prob = jnp.swapaxes(jax.nn.softmax(out["cls_logits"].astype(jnp.float32), axis=-1), 1, 2)
    want, _ = (np.asarray(x) for x in jax_export.load_bundle(bundles["jpath"])(frames))
    ref = np.asarray(jax_detection(cls_prob, out["loc_preds"], jbundle.anchors, threshold=0.01,
                                   nms_threshold=0.45, nms_topk=400))
    np.testing.assert_array_equal(ref[..., :2], want[..., :2])  # the JAX heads are the bundle's
    got = multibox_detection(torch.from_numpy(np.array(cls_prob)), torch.from_numpy(np.array(out["loc_preds"])),
                             jbundle.anchors, threshold=0.01, nms_threshold=0.45, nms_topk=400).numpy()
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2:], ref[..., 2:], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0, atol=1e-4)
    assert (got[..., 0] >= 0).sum() > 0 and (got[..., 0] == -1).sum() > 0


def _nms_case(case):
    rng = np.random.RandomState(31)
    if case == "near-threshold":
        return near_threshold_rows(rng, 3, 64, 0.45)
    boxes, ids, valid = with_boundary_rows(*random_nms_rows(rng, 3, 120))
    if case == "duplicates":
        boxes = np.ascontiguousarray(boxes[:, rng.randint(0, 8, 120)])
    elif case == "all-invalid":
        valid = np.zeros_like(valid)
    return boxes, ids, valid


@pytest.mark.parametrize("case", ["random", "duplicates", "all-invalid", "near-threshold"])
@pytest.mark.parametrize("force", [False, True])
def test_nms_operator_opcheck(case, force):
    """``dspnet::nms_keep_mask`` passes ``torch.library.opcheck`` (schema,
    autograd registration, the fake implementation against the real one,
    AOT dispatch with dynamic shapes) on CPU tensors, and equals the plain
    version bit for bit; ``nms_keep_mask`` goes through it."""
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in _nms_case(case)]
    op = torch.ops.dspnet.nms_keep_mask.default
    result = torch.library.opcheck(op, (*args, 0.45, force))
    assert set(result.values()) == {"SUCCESS"}, result
    want = nms_cuda.nms_keep_mask_reference(*args, 0.45, force)
    assert torch.equal(op(*args, 0.45, force), want)
    calls = nms_cuda.plain_calls
    assert torch.equal(nms_cuda.nms_keep_mask(*args, 0.45, force), want)
    assert nms_cuda.plain_calls == calls + 1 and nms_cuda.launches == 0
    if case == "all-invalid":
        assert not want.any()


def test_nms_operator_fake_shape_and_other_devices():
    """The fake implementation gives the (B, K) bool shape without running
    the plain version; a device other than cuda and cpu raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    calls = nms_cuda.plain_calls
    with FakeTensorMode():
        keep = torch.ops.dspnet.nms_keep_mask(torch.empty(2, 9, 4), torch.empty(2, 9),
                                              torch.empty(2, 9, dtype=torch.bool), 0.5, False)
    assert keep.shape == (2, 9) and keep.dtype == torch.bool and nms_cuda.plain_calls == calls
    meta = [torch.empty(1, 4, 4, device="meta"), torch.empty(1, 4, device="meta"),
            torch.empty(1, 4, dtype=torch.bool, device="meta")]
    with pytest.raises(ValueError, match="cuda or cpu"):
        nms_cuda.nms_keep_mask(*meta)


def test_load_bundle_without_model_code(bundles):
    """A fresh process loads and runs the bundle through ``load_bundle``
    with neither ``dspnet_torch.models`` nor jax imported, and gets the
    outputs of this process."""
    frames_path = bundles["tmp"] / "frames.npy"
    np.save(frames_path, bundles["frames"])
    det, seg = export_serving.load_bundle(bundles["ppath"])(torch.from_numpy(bundles["frames"]))
    want = bundles["tmp"] / "want.pt"
    torch.save({"det": det, "seg": seg}, want)
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(2)\n"
        "from dspnet_torch.tools.export_serving import load_bundle\n"
        f"serve = load_bundle({str(bundles['ppath'])!r})\n"
        f"det, seg = serve(torch.from_numpy(np.load({str(frames_path)!r})))\n"
        f"want = torch.load({str(want)!r})\n"
        "assert torch.equal(det, want['det']) and torch.equal(seg, want['seg'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'dspnet_tpu')\n"
        "             or m.startswith(('dspnet_torch.models', 'dspnet_torch.api', 'dspnet_torch.detect')))\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("network,out_type", [("resnet-18_det", "det"), ("resnet-18_seg", "seg")])
def test_single_task_bundle_returns_its_output(tmp_path, network, out_type):
    """A det-only or seg-only network's bundle returns the one output it has,
    as the JAX bundle does."""
    h, w = H, W
    port = create_model(network, (h, w), device="cpu")
    serve = export_serving.load_bundle(export_serving.export_bundle(port, str(tmp_path / "m.pt2"), 1, (h, w)))
    out = serve(torch.zeros((1, h, w, 3), dtype=torch.uint8))
    assert isinstance(out, torch.Tensor)
    assert out.shape == ((1, 400, 7) if out_type == "det" else (1, h // 4, w // 4))
    assert json.load(open(tmp_path / "m.pt2.json"))["task"] == network.split("_")[1]


def test_main_random_init_and_refused_flag(tmp_path, capsys):
    """``main --random-init --device cpu`` writes the bundle and its
    manifest; the JAX tool's TPU-only ``--pallas-nms`` is refused."""
    out = str(tmp_path / "cli" / "m.pt2")
    args = ["--network", "resnet-18_multi", "--data-shape", f"3,{H},{W}", "--batch-size", "1",
            "--out", out, "--random-init", "--device", "cpu"]
    assert export_serving.main(args) == out
    assert os.path.getsize(out) > 1000 and "exported" in capsys.readouterr().out
    manifest = json.load(open(out + ".json"))
    assert manifest["data_shape"] == [H, W] and manifest["batch_size"] == 1
    det, seg = export_serving.load_bundle(out)(torch.zeros((1, H, W, 3), dtype=torch.uint8))
    assert det.shape == (1, 400, 7) and seg.shape == (1, H // 4, W // 4)
    with pytest.raises(SystemExit):
        export_serving.main(args + ["--pallas-nms"])
    assert "--pallas-nms" in capsys.readouterr().err
