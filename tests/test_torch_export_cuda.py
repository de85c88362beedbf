"""The serving deployment path on the card: the NMS operator
``dspnet::nms_keep_mask`` on CUDA tensors, a ``torch.export`` bundle
exported and loaded there, and ``Detector(devices=[...])`` with two
replicas sharing the card.

Skips without a CUDA device (the NMS kernel has no CPU or interpret mode).
The file imports no jax, so it runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_export_cuda.py
"""

import numpy as np
import pytest
import torch

from dspnet_torch.api import create_model
from dspnet_torch.detect.detector import Detector
from dspnet_torch.ops import nms_cuda
from dspnet_torch.tools import export_serving
from tests.torch_parity import random_nms_rows, with_boundary_rows

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

H, W = 128, 256


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the NMS kernel has no CPU or interpret mode")
    return torch.device("cuda:0")


@pytest.fixture
def deterministic():
    """Full float32 and deterministic cuDNN for bit-for-bit comparisons."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.cuda
@pytest.mark.parametrize("force", [False, True])
def test_operator_launches_the_kernel(cuda_device, force):
    """On CUDA tensors the operator launches the kernel once a call and runs
    no plain version; its keep mask equals the plain version's."""
    rows = with_boundary_rows(*random_nms_rows(np.random.RandomState(3), 4, 400))
    args = [torch.from_numpy(a).to(cuda_device) for a in rows]
    launches, plain = nms_cuda.launches, nms_cuda.plain_calls
    got = torch.ops.dspnet.nms_keep_mask(*args, 0.45, force)
    assert nms_cuda.launches == launches + 1 and nms_cuda.plain_calls == plain
    assert torch.equal(got, nms_cuda.nms_keep_mask_reference(*args, 0.45, force))
    result = torch.library.opcheck(torch.ops.dspnet.nms_keep_mask.default, (*args, 0.45, force))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.cuda
def test_bundle_on_the_card_matches_predict_raw(cuda_device, deterministic, tmp_path):
    """A float32 bundle exported and loaded on the card equals
    ``Detector.predict_raw`` on the same weights bit for bit (seg as int32),
    launching the NMS kernel once a call and the plain version never."""
    bundle = create_model("resnet-18_multi", (H, W), device=cuda_device)
    serve = export_serving.load_bundle(export_serving.export_bundle(bundle, str(tmp_path / "m.pt2"), 2, (H, W)))
    det = Detector(bundle.model, bundle.anchors, (H, W), device=cuda_device, nms_thresh=0.45)
    frames = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, H, W, 3), np.uint8)).to(cuda_device)
    launches, plain = nms_cuda.launches, nms_cuda.plain_calls
    got_det, got_seg = serve(frames)
    assert nms_cuda.launches == launches + 1 and nms_cuda.plain_calls == plain
    want = det.predict_raw(frames)
    assert torch.equal(got_det, want["det"]) and torch.equal(got_seg, want["seg"].int())


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
def test_two_replicas_on_one_card(cuda_device, deterministic, B):
    """Two replicas sharing the card on two streams give the one-device
    Detector's results bit for bit."""
    bundle = create_model("resnet-18_multi", (H, W), device=cuda_device)
    one = Detector(bundle.model, bundle.anchors, (H, W), device=cuda_device)
    two = Detector(bundle.model, bundle.anchors, (H, W), devices=[cuda_device, cuda_device])
    frames = np.random.RandomState(B).randint(0, 256, (B, H, W, 3), np.uint8)
    got, want = two.predict_raw(frames), one.predict_raw(frames)
    assert all(got[k].shape[0] == B and torch.equal(got[k], want[k]) for k in want)
