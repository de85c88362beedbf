"""The CUDA bipartite matcher vs its plain PyTorch version, on the card.

Skips without a CUDA device (the kernel has no CPU or interpret mode). The
file imports no jax, so it also runs on a machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_match_cuda.py
"""

import numpy as np
import pytest
import torch

from dspnet_torch.ops import matching_cuda
from dspnet_torch.ops.boxes import iou_matrix

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the matcher kernel has no CPU or interpret mode")
    return torch.device("cuda:0")


def _corners(rng, *shape, lo=0.05, hi=0.3):
    cx, cy = rng.uniform(0.1, 0.9, (2, *shape))
    w, h = rng.uniform(lo, hi, (2, *shape))
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


def _check(iou, col_valid):
    before = matching_cuda.launches
    got = matching_cuda.bipartite_match(iou, col_valid)
    want = matching_cuda.bipartite_match_reference(iou, col_valid)
    torch.cuda.synchronize()
    assert matching_cuda.launches == before + 1
    for g, w, name in zip(got, want, ("matched", "match_gt", "match_iou")):
        assert torch.equal(g, w), name
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B,A,L,num_gt", [(1, 12264, 200, 8), (8, 12264, 200, 50),
                                          (2, 12264, 200, 200), (1, 24576, 200, 9), (3, 150, 16, 0)])
def test_cuda_matcher_matches_plain_on_boxes(cuda_device, B, A, L, num_gt):
    rng = np.random.RandomState(A + L + num_gt)
    anchors = torch.from_numpy(_corners(rng, B, A)).to(cuda_device)
    gts = torch.from_numpy(_corners(rng, B, L, lo=0.1, hi=0.4)).to(cuda_device)
    col_valid = torch.zeros(B, L, dtype=torch.bool, device=cuda_device)
    col_valid[:, :num_gt] = True
    got = _check(iou_matrix(anchors, gts).contiguous(), col_valid)
    assert int(got[0].sum()) == B * num_gt


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_matcher_matches_plain_on_ties(cuda_device, seed):
    """IoUs on a 1/64 grid, duplicated columns, invalid columns in the middle."""
    rng = np.random.RandomState(seed)
    iou = (rng.randint(0, 8, (4, 997, 40)) / 64.0).astype(np.float32)
    iou[:, :, 30:] = iou[:, :, :10]
    col_valid = rng.rand(4, 40) > 0.3
    col_valid[3] = False
    _check(torch.from_numpy(iou).to(cuda_device), torch.from_numpy(col_valid).to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("num_gt", [matching_cuda.LIST_KEYS + 1, 50, 200])
def test_cuda_matcher_refills_exhausted_columns(cuda_device, num_gt):
    """More GTs than list keys, all on one box, plus near copies: every
    column's top-T anchors retire before it is matched, so the kernel
    rescans columns from device memory (refills > 0) and still equals the
    plain rounds."""
    rng = np.random.RandomState(num_gt)
    anchors = torch.from_numpy(_corners(rng, 1, 12264)).to(cuda_device)
    box = _corners(rng, 1, 1, lo=0.2, hi=0.3)
    gts = np.repeat(box, num_gt, axis=1) + rng.uniform(0, 1e-3, (1, num_gt, 4)).astype(np.float32) * (
        rng.rand(1, num_gt, 1) < 0.5)
    col_valid = torch.zeros(1, 200, dtype=torch.bool, device=cuda_device)
    col_valid[:, :num_gt] = True
    full = np.zeros((1, 200, 4), np.float32)
    full[:, :num_gt] = gts
    iou = iou_matrix(anchors, torch.from_numpy(full).to(cuda_device)).contiguous()
    refills = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = matching_cuda.bipartite_match(iou, col_valid, refills=refills)
    want = matching_cuda.bipartite_match_reference(iou, col_valid)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("matched", "match_gt", "match_iou")):
        assert torch.equal(g, w), name
    assert int(refills[0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("A", [1000, 12263])
def test_cuda_matcher_unequal_chunks(cuda_device, A):
    """B = 1 with S > 1 anchor chunks of unequal length (A not a multiple of S)."""
    S = matching_cuda.launch_plan(1, A, 200).chunks
    assert S > 1 and A % S
    rng = np.random.RandomState(A)
    anchors = torch.from_numpy(_corners(rng, 1, A)).to(cuda_device)
    gts = torch.from_numpy(_corners(rng, 1, 200, lo=0.1, hi=0.4)).to(cuda_device)
    col_valid = torch.from_numpy(rng.rand(1, 200) > 0.5).to(cuda_device)
    _check(iou_matrix(anchors, gts).contiguous(), col_valid)


@pytest.mark.cuda
def test_cuda_matcher_rejects_what_it_cannot_take(cuda_device):
    iou = torch.rand(2, 30, 8, device=cuda_device)
    col_valid = torch.ones(2, 8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        matching_cuda.bipartite_match(iou.double(), col_valid)
    with pytest.raises(ValueError, match="contiguous"):
        matching_cuda.bipartite_match(iou.transpose(1, 2).contiguous().transpose(1, 2), col_valid)
    with pytest.raises(ValueError, match="different devices"):
        matching_cuda.bipartite_match(iou, col_valid.cpu())


@pytest.mark.cuda
def test_solver_auto_backend_launches_the_kernel(cuda_device):
    """One resnet-18_multi train step on a CUDA batch goes through the kernel."""
    from dspnet_torch.api import create_model
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils.benchmark import canonical_train_batch

    bundle = create_model("resnet-18_multi", (128, 256), device=cuda_device)
    solver = MultiTaskSolver(bundle.model, bundle.anchors, batch_size=2, seg_normalize="valid",
                             device=cuda_device)
    state = solver.init_state()
    before = matching_cuda.launches
    state, metrics = solver.train_step(state, canonical_train_batch(2, 128, 256))
    assert matching_cuda.launches == before + 1
    assert np.isfinite(float(metrics["loss"]))
