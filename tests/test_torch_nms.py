"""NMS keep mask of the PyTorch port vs the JAX package.

The plain PyTorch version (the CPU path of ``nms_keep_mask``) is held bit
for bit against the Pallas kernel in interpret mode and against the XLA
fixpoint, as tests/test_nms_pallas.py holds those two. The CUDA kernel is
held against the plain version in tests/test_torch_nms_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dspnet_tpu.ops import boxes as jax_boxes
from dspnet_tpu.ops.detection import _nms_fixpoint
from dspnet_tpu.ops.nms_pallas import nms_keep_mask as pallas_keep_mask
from dspnet_torch.ops import nms_cuda
from tests.torch_parity import random_nms_rows, with_boundary_rows

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores


def _jax_fixpoint(boxes, ids, valid, thr, force):
    out = []
    for b in range(boxes.shape[0]):
        K = boxes.shape[1]
        iou = jax_boxes.iou_matrix(jnp.asarray(boxes[b]), jnp.asarray(boxes[b]))
        row = jnp.arange(K)
        class_ok = (jnp.ones((K, K), bool) if force
                    else jnp.asarray(ids[b])[:, None] == jnp.asarray(ids[b])[None, :])
        suppress = ((row[:, None] < row[None, :]) & class_ok & (iou >= thr)
                    & jnp.asarray(valid[b])[:, None] & jnp.asarray(valid[b])[None, :])
        out.append(np.asarray(_nms_fixpoint(jnp.asarray(valid[b]), suppress)))
    return np.stack(out)


@pytest.mark.parametrize("K", [50, 400])
@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("thr", [0.5, 0.25])
def test_plain_nms_matches_pallas_and_fixpoint(rng, K, force, thr):
    """Bit-exact keep masks; the boundary rows put IoU == thr pairs in every
    image (thr 0.5 and 0.25 are exact in f32, so `>=` decides them)."""
    boxes, ids, valid = with_boundary_rows(*random_nms_rows(rng, 2, K))
    got = nms_cuda.nms_keep_mask_reference(
        torch.from_numpy(boxes), torch.from_numpy(ids), torch.from_numpy(valid),
        thr, force).numpy()
    pallas = np.asarray(pallas_keep_mask(
        jnp.asarray(boxes), jnp.asarray(ids), jnp.asarray(valid),
        nms_threshold=thr, force_suppress=force, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, _jax_fixpoint(boxes, ids, valid, thr, force))
    # the boundary pairs decide: the unit box (row 0) is kept, and its
    # duplicate (row 2) is suppressed at any threshold
    assert got[:, 0].all() and not got[:, 2].any()
    assert (got[:, 1] == (thr > 0.5)).all()  # IoU(row 0, row 1) == 0.5


def test_dispatch_by_device(rng):
    boxes, ids, valid = random_nms_rows(rng, 2, 30)
    args = torch.from_numpy(boxes), torch.from_numpy(ids), torch.from_numpy(valid)
    before = nms_cuda.launches
    torch.testing.assert_close(nms_cuda.nms_keep_mask(*args, 0.45),
                               nms_cuda.nms_keep_mask_reference(*args, 0.45), rtol=0, atol=0)
    assert nms_cuda.launches == before  # a CPU tensor never counts as a launch
    with pytest.raises(ValueError, match="cuda or cpu"):
        nms_cuda.nms_keep_mask(*(t.to("meta") for t in args), 0.45)
    with pytest.raises(ValueError, match="must be"):
        nms_cuda.nms_keep_mask(args[0], args[1][:, :-1], args[2])


def test_all_invalid_image_keeps_nothing(rng):
    boxes, ids, valid = random_nms_rows(rng, 2, 40)
    valid[1] = False
    keep = nms_cuda.nms_keep_mask_reference(
        torch.from_numpy(boxes), torch.from_numpy(ids), torch.from_numpy(valid), 0.5)
    assert not keep[1].any() and keep[0].any()
