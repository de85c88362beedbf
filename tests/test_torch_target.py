"""Target assignment of the PyTorch port vs the JAX package, on the CPU:
``encode_targets``, the bipartite matcher's plain version (the CUDA kernel's
reference) and ``multibox_target``. Inputs are seeded numpy arrays handed to
both packages; discrete outputs are compared exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dspnet_tpu.ops import boxes as jax_boxes
from dspnet_tpu.ops import target as jax_target
from dspnet_tpu.ops.matching_pallas import bipartite_match_pallas
from dspnet_torch.data.iterator import MAX_OBJECTS
from dspnet_torch.ops import _build
from dspnet_torch.ops import boxes as box_ops
from dspnet_torch.ops import matching_cuda
from dspnet_torch.ops.target import _valid_columns, multibox_target

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores


def _corners(rng, *shape, lo=0.05, hi=0.3):
    cx, cy = rng.uniform(0.1, 0.9, (2, *shape))
    w, h = rng.uniform(lo, hi, (2, *shape))
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


def _labels(rng, B, L, counts, num_classes=8):
    labels = np.full((B, L, 6), -1.0, np.float32)
    for b, n in enumerate(counts):
        labels[b, :n, 0] = rng.randint(0, num_classes, n)
        labels[b, :n, 1:5] = np.clip(_corners(rng, n, lo=0.1, hi=0.4), 0, 1)
        labels[b, :n, 5] = rng.uniform(0, 1, n)
    return labels


def test_encode_targets_matches_jax(rng):
    """atol 1e-5: the same f32 ops; log may differ by an ulp between the
    two libraries. Degenerate GT rows (zero width) exercise the 1e-12 floor."""
    anchors = _corners(rng, 2, 50)
    gts = _corners(rng, 2, 50)
    gts[0, :5, 2] = gts[0, :5, 0]  # zero width
    dist = rng.uniform(0, 1, (2, 50)).astype(np.float32)
    want = np.asarray(jax_boxes.encode_targets(jnp.asarray(anchors), jnp.asarray(gts), jnp.asarray(dist)))
    got = box_ops.encode_targets(*map(torch.from_numpy, (anchors, gts, dist))).numpy()
    assert got.shape == (2, 50, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got[..., 4], dist / np.float32(0.1))


def _jax_match(iou, col_valid):
    outs = [jax_target._bipartite_match(jnp.asarray(iou[b]), jnp.asarray(col_valid[b]))[:3]
            for b in range(iou.shape[0])]
    return [np.stack([np.asarray(o[k]) for o in outs]) for k in range(3)]


def _assert_same_match(got, want):
    for g, w, name in zip(got, want, ("matched", "match_gt", "match_iou")):
        g = g.numpy()
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def _box_iou(rng, B, A, L):
    anchors = _corners(rng, B, A)
    gts = _corners(rng, B, L)
    return np.array(jax.vmap(jax_boxes.iou_matrix)(jnp.asarray(anchors), jnp.asarray(gts)))


@pytest.mark.parametrize("num_gt", [0, 1, 7, 16])
def test_match_reference_matches_jax_and_pallas(rng, num_gt):
    """Bit for bit against the JAX rounds and the Pallas kernel (interpret
    mode), on random boxes, where no two IoUs tie
    (tests/test_matching_pallas.py:14-35)."""
    B, A, L = 2, 150, 16
    iou = _box_iou(rng, B, A, L)
    col_valid = np.zeros((B, L), bool)
    col_valid[:, :num_gt] = True
    got = matching_cuda.bipartite_match(torch.from_numpy(iou), torch.from_numpy(col_valid))
    _assert_same_match(got, _jax_match(iou, col_valid))
    pallas = bipartite_match_pallas(jnp.asarray(iou), jnp.asarray(col_valid), interpret=True)
    _assert_same_match(got, pallas)
    assert int(got[0].sum()) == (0 if num_gt == 0 else B * num_gt)


def _greedy_oracle(iou, col_valid):
    """The sequential greedy written out in numpy: repeat the global argmax
    (first occurrence in row-major order) while it is above 1e-6."""
    B, A, L = iou.shape
    match_gt = np.full((B, A), -1, np.int32)
    match_iou = np.full((B, A), -1.0, np.float32)
    for b in range(B):
        w = np.where(col_valid[b][None, :], iou[b], np.float32(-1.0)).astype(np.float32)
        while True:
            i = int(np.argmax(w))
            a, l = divmod(i, L)
            if not w[a, l] > np.float32(1e-6):
                break
            match_gt[b, a], match_iou[b, a] = l, w[a, l]
            w[a, :] = -1.0
            w[:, l] = -1.0
    return match_gt >= 0, match_gt, match_iou


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_match_reference_quantised_ties(seed):
    """IoUs on a 1/64 grid tie often (and some sit at or below 1e-6), the
    columns are valid in a pattern with holes, and two columns are exact
    duplicates: ties go to the smallest row-major index, as in the Pallas
    kernel and the sequential greedy. (The JAX rounds differ on some of
    these ties: see the next test.)"""
    rng = np.random.RandomState(seed)
    B, A, L = 3, 97, 12
    iou = (rng.randint(0, 8, (B, A, L)) / 64.0).astype(np.float32)
    iou[:, :, 5] = iou[:, :, 2]
    iou[1, 10:20, :] = 1e-7  # positive but never above 1e-6
    col_valid = rng.rand(B, L) > 0.3
    col_valid[:, [2, 5]] = True
    col_valid[2] = False  # an image with no valid column
    got = matching_cuda.bipartite_match_reference(torch.from_numpy(iou), torch.from_numpy(col_valid))
    _assert_same_match(got, _greedy_oracle(iou, col_valid))
    pallas = bipartite_match_pallas(jnp.asarray(iou), jnp.asarray(col_valid), interpret=True)
    _assert_same_match(got, pallas)
    assert not got[0][2].any()


def test_jax_rounds_differ_from_the_greedy_on_a_late_tie():
    """The JAX package's parallel rounds (``target._bipartite_match``, its
    default off the TPU) accept an anchor's best *proposer*. Here GT 0 ties
    GT 2 for anchor 1 at 0.3 but proposes it only after losing anchor 0 to
    GT 1, so the rounds give anchor 1 to GT 2, where the greedy (the Pallas
    kernel, the reference operator, the port) gives it to GT 0."""
    iou = np.array([[[0.8, 0.9, 0.0],
                     [0.3, 0.0, 0.3]]], np.float32)
    col_valid = np.ones((1, 3), bool)
    got = matching_cuda.bipartite_match(torch.from_numpy(iou), torch.from_numpy(col_valid))
    np.testing.assert_array_equal(got[1].numpy(), [[1, 0]])
    _assert_same_match(got, _greedy_oracle(iou, col_valid))
    _assert_same_match(got, bipartite_match_pallas(jnp.asarray(iou), jnp.asarray(col_valid),
                                                   interpret=True))
    np.testing.assert_array_equal(_jax_match(iou, col_valid)[1], [[1, 2]])


def test_match_reference_vgg512_anchor_count(rng):
    """A = 24,576 anchors (the vgg@512 count, tests/test_matching_pallas.py:38)
    against the JAX rounds and the Pallas kernel."""
    B, A, L, num_gt = 1, 24576, 200, 9
    iou = _box_iou(rng, B, A, L)
    col_valid = np.zeros((B, L), bool)
    col_valid[:, :num_gt] = True
    got = matching_cuda.bipartite_match(torch.from_numpy(iou), torch.from_numpy(col_valid))
    _assert_same_match(got, _jax_match(iou, col_valid))
    pallas = bipartite_match_pallas(jnp.asarray(iou), jnp.asarray(col_valid), interpret=True)
    _assert_same_match(got, pallas)


def test_match_rejects_bad_shapes_and_devices():
    iou = torch.zeros(2, 10, 4)
    with pytest.raises(ValueError, match=r"\(B, L\)"):
        matching_cuda.bipartite_match(iou, torch.ones(2, 5, dtype=torch.bool))
    with pytest.raises(ValueError, match="cuda or cpu"):
        matching_cuda.bipartite_match(iou.to("meta"), torch.ones(2, 4, dtype=torch.bool, device="meta"))


def test_valid_columns_match_jax(rng):
    labels = _labels(rng, 3, 10, [0, 4, 10])
    labels[1, 6, 0] = 2.0  # a valid-looking row after the first pad stays invalid
    want = np.asarray(jax_target._valid_columns(jnp.asarray(labels)))
    np.testing.assert_array_equal(_valid_columns(torch.from_numpy(labels)).numpy(), want)


def _separated_logits(rng, B, C, A):
    """Class logits whose background probabilities are far apart: the
    background logit is a permutation of an evenly spaced grid and the other
    classes are small noise, so an ulp of softmax difference between the two
    libraries cannot reorder the mining rank. Anchors 0-3 share one logit
    column, so their background probabilities tie exactly in both."""
    logits = (rng.randn(B, C, A) * 0.01).astype(np.float32)
    for b in range(B):
        logits[b, 0] = np.linspace(-4.0, 4.0, A)[rng.permutation(A)]
    logits[:, :, 1:4] = logits[:, :, :1]
    return logits


def _compare_targets(got, want):
    """cls_target and loc_mask exactly; loc_target within atol 1e-5 (the
    encode's log may differ by an ulp between the libraries)."""
    loc_t, loc_m, cls_t = (t.numpy() for t in got)
    np.testing.assert_array_equal(cls_t, np.asarray(want[2]))
    np.testing.assert_array_equal(loc_m, np.asarray(want[1]))
    np.testing.assert_allclose(loc_t, np.asarray(want[0]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mining", [-1.0, 3.0])
@pytest.mark.parametrize("counts", [(0, 0), (1, 5), (12, 3)])
def test_multibox_target_matches_jax(rng, mining, counts):
    """The port's target op on the port's matcher vs the JAX op, with hard
    negative mining on and off and images with zero GTs
    (tests/test_ops.py:102-126)."""
    B, L, C = len(counts), 16, 9
    anchors = _corners(rng, 300, lo=0.05, hi=0.5)
    labels = _labels(rng, B, L, counts)
    cls_preds = _separated_logits(rng, B, C, 300)
    kw = dict(overlap_threshold=0.5, negative_mining_ratio=mining, negative_mining_thresh=0.5)
    want = jax_target.multibox_target(jnp.asarray(anchors), jnp.asarray(labels),
                                      jnp.asarray(cls_preds), **kw)
    got = multibox_target(anchors, torch.from_numpy(labels), torch.from_numpy(cls_preds), **kw)
    _compare_targets(got, want)
    cls_t = got[2].numpy()
    for b, n in enumerate(counts):
        if n == 0:  # zero GTs: everything at its init
            assert (cls_t[b] == -1).all() and (got[1][b] == 0).all() and (got[0][b] == 0).all()
        elif mining > 0:
            assert ((cls_t[b] == 0).sum()) == min(3 * (cls_t[b] > 0).sum(), 300 - (cls_t[b] > 0).sum())


def test_multibox_target_zero_overlap_threshold_matches_jax(rng):
    """overlap_threshold <= 0 keeps only the bipartite matches positive
    (multibox_target.cc:151; tests/test_ops.py:205-226)."""
    anchors = _corners(rng, 200, lo=0.05, hi=0.5)
    labels = _labels(rng, 2, 8, (4, 6))
    cls_preds = _separated_logits(rng, 2, 5, 200)
    kw = dict(overlap_threshold=0.0, negative_mining_ratio=3.0)
    want = jax_target.multibox_target(jnp.asarray(anchors), jnp.asarray(labels),
                                      jnp.asarray(cls_preds), **kw)
    got = multibox_target(torch.from_numpy(anchors)[None], torch.from_numpy(labels),
                          torch.from_numpy(cls_preds), **kw)
    _compare_targets(got, want)
    assert int((got[2] > 0).sum()) == 10  # one bipartite positive per GT


def test_multibox_target_backends_agree_on_the_cpu(rng):
    """'plain' and 'kernel'/'auto' are the same function on CPU tensors; on
    the card chip_smoke.py holds the kernel path against the plain one."""
    anchors = _corners(rng, 120)
    labels = _labels(rng, 2, 8, (3, 5))
    cls_preds = torch.from_numpy(_separated_logits(rng, 2, 4, 120))
    outs = [multibox_target(anchors, torch.from_numpy(labels), cls_preds, negative_mining_ratio=3.0,
                            bipartite_backend=backend) for backend in ("auto", "kernel", "plain")]
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="bipartite_backend"):
        multibox_target(anchors, torch.from_numpy(labels), cls_preds, bipartite_backend="pallas")


# ---------------------------------------------------------------------------
# A numpy model of csrc/match.cu's algorithm, where the CUDA code cannot
# run: per-chunk top-T keys of each valid column, merged into one top-T list
# per column, then the greedy over the lists' heads, which refills every
# exhausted column from the full matrix when an exhausted column's bound
# beats every head.

def _key(v, a):
    """(float bits << 32) | ~anchor, 0 at or below 1e-6."""
    v = np.float32(v)
    return (int(v.view(np.uint32)) << 32) | (0xFFFFFFFF - a) if v > np.float32(1e-6) else 0


def _anchor(key):
    return 0xFFFFFFFF - (key & 0xFFFFFFFF)


def _pack(key, col):
    """The greedy's order: value, then the smallest anchor, then the smallest column."""
    return (key >> 32 << 32) | ((0xFFFFFF - _anchor(key)) << 8) | (255 - col)


def _top(keys, T):
    keys = sorted((k for k in keys if k), reverse=True)[:T]
    return keys + [0] * (T - len(keys))


def _kernel_model(iou, col_valid, T, S):
    B, A, L = iou.shape
    matched = np.zeros((B, A), bool)
    match_gt = np.full((B, A), -1, np.int32)
    match_iou = np.full((B, A), -1.0, np.float32)
    refills = [0] * B
    for b in range(B):
        cols = [int(c) for c in np.nonzero(col_valid[b])[0]]
        used = np.zeros(A, bool)

        def column(c, a0, a1):
            return _top([_key(iou[b, a, c], a) for a in range(a0, a1) if not used[a]], T)

        chunks = [(A * s // S, A * (s + 1) // S) for s in range(S)]
        lists = {c: _top([k for a0, a1 in chunks for k in column(c, a0, a1)], T) for c in cols}
        ptr = {c: 0 for c in cols}
        while True:
            heads, bounds = {}, {}
            for c in cols:
                while ptr[c] < T and lists[c][ptr[c]] and used[_anchor(lists[c][ptr[c]])]:
                    ptr[c] += 1
                if ptr[c] < T and lists[c][ptr[c]]:
                    heads[c] = _pack(lists[c][ptr[c]], c)
                elif ptr[c] == T:  # ran off a full list: what is left is below its last key
                    bounds[c] = _pack(lists[c][T - 1], c)
            top = max([0, *heads.values(), *bounds.values()])
            if top == 0:
                break
            if top in bounds.values():
                for c in bounds:
                    lists[c], ptr[c] = column(c, 0, A), 0
                refills[b] += len(bounds)
                continue
            a, l = 0xFFFFFF - ((top >> 8) & 0xFFFFFF), 255 - (top & 0xFF)
            matched[b, a], match_gt[b, a] = True, l
            match_iou[b, a] = np.uint32(top >> 32).view(np.float32)
            used[a] = True
            cols.remove(l)
    return (matched, match_gt, match_iou), refills


@pytest.mark.parametrize("T", [1, 2, 4])
def test_topk_greedy_model_matches_plain_and_pallas(rng, T):
    """The kernel's algorithm at small T (so lists run out and refill), on
    random boxes, IoUs on a 1/64 grid with duplicated and invalid columns,
    and one GT repeated over every column: bit for bit with the plain
    rounds and the Pallas kernel (interpret mode)."""
    B, A, L = 3, 151, 16
    iou = _box_iou(rng, B, A, L)
    iou[1] = (rng.randint(0, 8, (A, L)) / 64.0).astype(np.float32)
    iou[1, :, 9] = iou[1, :, 3]
    iou[2] = iou[2, :, :1]  # one GT box repeated 16 times
    col_valid = np.ones((B, L), bool)
    col_valid[1, [5, 11]] = False
    S = matching_cuda.launch_plan(B, A, L).chunks
    assert S > 1 and A % S  # chunks of unequal length
    got, refills = _kernel_model(iou, col_valid, T, S)
    want = matching_cuda.bipartite_match_reference(torch.from_numpy(iou), torch.from_numpy(col_valid))
    for g, w, name in zip(got, want, ("matched", "match_gt", "match_iou")):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    pallas = bipartite_match_pallas(jnp.asarray(iou), jnp.asarray(col_valid), interpret=True)
    for g, w, name in zip(got, pallas, ("matched", "match_gt", "match_iou")):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert refills[2] > 0  # the repeated GT exhausts every list


@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("A", [12264, 24576])
def test_launch_plan(B, A):
    """At the train step's shapes (L = 200): the first pass has at least one
    block per SM (S * B >= 132, chunks of >= 64 rows) and both kernels fit
    the 227 KB a block may use."""
    plan = matching_cuda.launch_plan(B, A, 200)
    assert plan.chunks * B >= 132 and A // plan.chunks >= 64
    assert plan.list_keys == matching_cuda.LIST_KEYS
    assert plan.scratch_bytes == B * plan.chunks * 200 * plan.list_keys * 8
    assert max(plan.topk_shared_bytes, plan.greedy_shared_bytes) <= _build.MAX_SHARED_BYTES
    assert plan.greedy_shared_bytes == (200 + 512) * 8 * 8 + -(-A // 32) * 4 + 6 * 200 * 4
    with pytest.raises(ValueError, match="L <= 256"):
        matching_cuda.launch_plan(B, A, 257)


@pytest.mark.parametrize("A", [12264, 24576])
def test_max_objects_fit_the_matcher(A):
    """The loader's GT rows per image are the matcher's GT columns: the
    kernel takes every label width the loader gives (L = MAX_OBJECTS), so a
    wider label fails here, on the CPU, and not first on the card."""
    assert MAX_OBJECTS <= matching_cuda.MAX_COLUMNS
    plan = matching_cuda.launch_plan(8, A, MAX_OBJECTS)
    assert plan.greedy_shared_bytes <= _build.MAX_SHARED_BYTES
