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
from dspnet_torch.ops import _build, nms_cuda
from tests.torch_parity import near_threshold_rows, random_nms_rows, with_boundary_rows

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


# ---------------------------------------------------------------------------
# A numpy model of csrc/nms.cu's algorithm: the same decisions on the CPU,
# where the CUDA code cannot run. Mask words as Python ints (u64), the IoU
# test with its fused-multiply-add shortcut, and the tile-by-tile scan.

_MASK64 = (1 << 64) - 1


def _iou_at_least(a, b, thr):
    """The kernel's ``iou_at_least``: float32 ops in the JAX order; the sign
    of inter - thr * union (one rounding, as the FMA) decides far from the
    threshold, the IEEE division near it."""
    f = np.float32
    thr = f(thr)
    iw = max(f(0), f(min(a[2], b[2]) - max(a[0], b[0])))
    ih = max(f(0), f(min(a[3], b[3]) - max(a[1], b[1])))
    inter = f(iw * ih)
    area_a = f(f(a[2] - a[0]) * f(a[3] - a[1]))
    area_b = f(f(b[2] - b[0]) * f(b[3] - b[1]))
    uni = f(f(area_a + area_b) - inter)
    tu = f(thr * uni)
    if tu > f(1e-30):
        r = f(float(inter) - float(thr) * float(uni))  # thr * uni is exact in float64
        if r > 0:
            return True
        if r < -tu * f(2.0 ** -20):
            return False
    iou = f(inter / uni) if uni > 0 else f(0)
    return bool(iou >= thr)


def _mask_words(boxes, ids, valid, thr, force):
    """words[i][w]: bit t says row i suppresses row 64 w + t; only the words
    the scan reads (valid rows, w >= tile(i)) are built."""
    K = len(boxes)
    T = -(-K // 64)
    key = np.where(valid, 0.0 if force else ids, np.nan)
    words = [[None] * T for _ in range(K)]
    for i in range(K):
        if not valid[i]:
            continue
        for w in range(i // 64, T):
            word = 0
            for t in range(64):
                j = 64 * w + t
                if i < j < K and key[j] == key[i] and _iou_at_least(boxes[i], boxes[j], thr):
                    word |= 1 << t
            words[i][w] = word
    return words


def _resolve_sequential(diag, cand):
    """The greedy over one tile as a chain: row r is kept when it is a
    candidate not removed by a kept row before it."""
    rem = 0
    for r in range(64):
        if (cand & ~rem) >> r & 1:
            rem |= diag[r]
    return cand & ~rem


def _resolve_wavefront(diag, cand):
    """The kernel's resolution: each row's suppressors inside the tile (the
    diagonal words transposed); then rounds in which a candidate with a kept
    suppressor is removed and one whose suppressors are all out is kept."""
    inc = [sum(1 << q for q in range(64) if diag[q] >> r & 1) for r in range(64)]
    kept, out = 0, ~cand & _MASK64
    rounds = 0
    while (kept | out) != _MASK64:
        new_kept = sum(1 << r for r in range(64) if cand >> r & 1 and not inc[r] & ~out & _MASK64)
        new_out = sum(1 << r for r in range(64) if cand >> r & 1 and inc[r] & kept)
        kept, out = kept | new_kept, out | new_out
        rounds += 1
        assert rounds <= 64
    return kept


def _tile_scan(words, valid, resolve):
    """Tile t: candidates = valid & ~removed[t]; the diagonal resolved by
    ``resolve``; then the kept rows' words ORed into removed[t+1:]."""
    K = len(valid)
    T = -(-K // 64)
    validw = [sum(1 << r for r in range(64) if 64 * t + r < K and valid[64 * t + r]) for t in range(T)]
    removed = [0] * T
    keep = np.zeros(K, bool)
    for t in range(T):
        cand = validw[t] & ~removed[t] & _MASK64
        # rows never built (invalid, past K) hold garbage the resolution must ignore
        diag = [words[64 * t + r][t] if 64 * t + r < K and words[64 * t + r][t] is not None
                else _MASK64 for r in range(64)]
        kept = resolve(diag, cand)
        for w in range(t + 1, T):
            for r in range(64):
                if kept >> r & 1:
                    removed[w] |= words[64 * t + r][w]
        for r in range(64):
            if kept >> r & 1:
                keep[64 * t + r] = True
    return keep


@pytest.mark.parametrize("resolve", [_resolve_sequential, _resolve_wavefront])
@pytest.mark.parametrize("K", [37, 64, 65, 400, 1000])
def test_tile_scan_model_matches_plain_and_pallas(rng, K, resolve):
    """The kernel's algorithm, modelled in numpy, gives the plain version's
    and the Pallas kernel's keep masks: duplicates, boundary rows (IoU on
    the threshold, zero-area boxes), IoUs within an ulp of the threshold, an
    all-invalid image, both thresholds and force_suppress on and off."""
    B = 3
    boxes, ids, valid = with_boundary_rows(*random_nms_rows(rng, B, K))
    boxes[1, 8:] = boxes[1, rng.randint(8, min(K, 20), K - 8)]  # many exact duplicates
    near = near_threshold_rows(rng, 1, min(K, 40), 0.5)[0][0]
    boxes[2, 8:8 + len(near)] = near[: K - 8]
    ids[2, 8:8 + len(near)] = 0.0
    valid[2, 8:8 + len(near)] = True
    if K == 400:
        valid[0] = False
        ids[0] = -1.0
    for thr, force in ((0.5, False), (0.45, True)) if K < 1000 else ((0.5, False),):
        want = nms_cuda.nms_keep_mask_reference(
            torch.from_numpy(boxes), torch.from_numpy(ids), torch.from_numpy(valid), thr, force).numpy()
        got = np.stack([_tile_scan(_mask_words(boxes[b], ids[b], valid[b], thr, force), valid[b], resolve)
                        for b in range(B)])
        np.testing.assert_array_equal(got, want)
        pallas = np.asarray(pallas_keep_mask(jnp.asarray(boxes), jnp.asarray(ids), jnp.asarray(valid),
                                             nms_threshold=thr, force_suppress=force, interpret=True))
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("B,K", [(1, 37), (1, 400), (128, 400), (1, 1000), (1, 12264)])
def test_launch_plan(B, K):
    """The shared-memory path while the mask fits a block, the device-memory
    path above; every plan under the 227 KB a block may use; a cluster per
    image only while the images leave SMs idle."""
    plan = nms_cuda.launch_plan(B, K)
    T = -(-K // 64)
    assert plan.shared_bytes <= _build.MAX_SHARED_BYTES
    assert plan.shared_path == (K <= 1216)
    if plan.shared_path:
        assert plan.shared_bytes == K * 32 + (K * T + 3 * T) * 8 and plan.mask_bytes == 0
        assert plan.cluster == (16 if B == 1 else 1)
    else:
        assert plan.cluster == 1 and plan.mask_bytes == B * K * T * 8
        assert plan.shared_bytes == (64 * T + 3 * T) * 8
    assert nms_cuda.launch_plan(1, 1216).shared_path and not nms_cuda.launch_plan(1, 1217).shared_path
