"""The CUDA NMS kernel vs its plain PyTorch version, on the card.

Skips without a CUDA device (the kernel has no CPU or interpret mode). The
file imports no jax, so it also runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_nms_cuda.py
"""

import numpy as np
import pytest
import torch

from dspnet_torch.ops import nms_cuda
from tests.torch_parity import near_threshold_rows, random_nms_rows, with_boundary_rows

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the NMS kernel has no CPU or interpret mode")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("B,K", [(1, 37), (8, 400), (8, 1000), (1, 12264),
                                 (1, 1216), (1, 1217), (133, 400)])
@pytest.mark.parametrize("force", [False, True])
def test_cuda_kernel_matches_plain(cuda_device, B, K, force):
    """Bit-exact keep masks at the thresholds the repo serves with; the
    boundary rows put IoU == 0.5 pairs, duplicates and zero-area boxes in
    every image, and the last image of a batch is all invalid."""
    rng = np.random.RandomState(233)
    boxes, ids, valid = with_boundary_rows(*random_nms_rows(rng, B, K))
    if B > 1:
        valid[-1] = False
    args = [torch.from_numpy(a).to(cuda_device) for a in (boxes, ids, valid)]
    before = nms_cuda.launches
    for thr in (0.45, 0.5):
        got = nms_cuda.nms_keep_mask(*args, thr, force)
        want = nms_cuda.nms_keep_mask_reference(*args, thr, force)
        torch.cuda.synchronize()
        assert torch.equal(got, want), int((got != want).sum())
    assert nms_cuda.launches == before + 2
    if B > 1:
        assert not got[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.45, 0.5])
def test_cuda_kernel_at_the_threshold(cuda_device, thr):
    """IoUs within an ulp or two of the threshold, where the IEEE division
    decides, on one block and on a cluster of blocks per image."""
    rows = near_threshold_rows(np.random.RandomState(5), 4, 64, thr)
    args = [torch.from_numpy(a).to(cuda_device) for a in rows]
    want = nms_cuda.nms_keep_mask_reference(*args, thr)
    for cluster in (1, 8, 16):
        plan = nms_cuda.launch_plan(4, 64)._replace(cluster=cluster)
        got = nms_cuda._launch(*args, thr, False, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (cluster, int((got != want).sum()))


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_cannot_take(cuda_device):
    boxes = torch.rand(2, 16, 4, device=cuda_device)
    ids = torch.zeros(2, 16, device=cuda_device)
    valid = torch.ones(2, 16, dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        nms_cuda.nms_keep_mask(boxes.double(), ids, valid)
    with pytest.raises(ValueError, match="contiguous"):
        nms_cuda.nms_keep_mask(boxes.transpose(0, 1).contiguous().transpose(0, 1), ids, valid)
    with pytest.raises(ValueError, match="different devices"):
        nms_cuda.nms_keep_mask(boxes, ids.cpu(), valid)
