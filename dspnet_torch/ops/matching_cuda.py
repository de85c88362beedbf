"""Greedy bipartite anchor<->GT matching: the CUDA kernel and its plain version.

``bipartite_match`` replaces the TPU kernel
``dspnet_tpu/ops/matching_pallas.py::_match_kernel`` (wrapper
``bipartite_match_pallas``): phase 1 of MultiBoxTarget. For a CUDA tensor it
launches the hand-written kernels in ``csrc/match.cu`` (a first pass over
the whole card that keeps each column's top-T keys per anchor chunk, then
one block per image that merges them and runs the greedy in one warp,
rescanning a column from device memory only when its list runs out; the
source note there says what bounds it on the card). For a CPU tensor it runs
``bipartite_match_reference``, the plain PyTorch version. Any other device
raises. There is no fallback between the two.

Semantics (the Pallas kernel's, and the reference operator's row-major
strictly-greater scan, multibox_target.cc:113-149):
repeat the global argmax over available (anchor, gt) pairs with IoU > 1e-6,
ties to the smallest row-major index ``a * L + l``; each match retires its
anchor and its GT column. Invalid columns never match.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from dspnet_torch.ops import _build

#: calls of ``bipartite_match`` that launched the kernels (two CUDA launches
#: each); a caller may reset it to 0
launches = 0
#: calls of the plain version (``bipartite_match_reference``), on any device; a path
#: on the card makes none, a caller may reset it to 0
plain_calls = 0

#: keys per column list and threads per block, csrc/match.cu's compile-time
#: kT and kThreads; the plan below owns every size derived from them
LIST_KEYS = 8
_THREADS = 512
#: the packed key's column and anchor fields (csrc/match.cu)
MAX_COLUMNS = 256
_MAX_ANCHORS = 1 << 24


class LaunchPlan(NamedTuple):
    chunks: int              # S: anchor chunks per image in the first pass
    list_keys: int           # T: keys kept per column and chunk
    scratch_bytes: int       # the (B, S, L, T) u64 chunk lists
    topk_shared_bytes: int   # first pass, per block
    greedy_shared_bytes: int  # second pass (lists, merge buffer, retired bitset, matches), per block


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, A: int, L: int) -> LaunchPlan:
    """How ``csrc/match.cu`` runs B images of an (A, L) IoU matrix, a pure
    function of its arguments and the one owner of its sizes (the kernels
    carve their shared memory as the comments below lay it out and check
    nothing): S anchor chunks per image so that the first pass has two
    blocks for each SM of an H100 (S * B >= 2 * 132), with no chunk under 64
    rows. Raises for shapes the kernels do not take."""
    if L > MAX_COLUMNS or A >= _MAX_ANCHORS:
        raise ValueError(f"the matcher kernel takes L <= {MAX_COLUMNS} and A < {_MAX_ANCHORS}, "
                         f"got A={A}, L={L}")
    S = max(1, min(-(-2 * _build.H100_SMS // max(B, 1)), A // 64))
    # first pass: the merge buffer (threads x T u64), the valid columns (L int)
    topk = _THREADS * LIST_KEYS * 8 + L * 4
    # second pass: the column lists (L x T u64), the merge buffer, the retired
    # bitset (ceil(A / 32) u32), then six int/float arrays of L
    greedy = (L + _THREADS) * LIST_KEYS * 8 + -(-A // 32) * 4 + 6 * L * 4
    if greedy > _build.MAX_SHARED_BYTES:
        raise ValueError(f"A={A}, L={L} needs {greedy} bytes of shared memory per block, "
                         f"more than the {_build.MAX_SHARED_BYTES} a block may use")
    return LaunchPlan(S, LIST_KEYS, B * S * L * LIST_KEYS * 8, topk, greedy)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build ``csrc/match.cu`` (at first use, ``ops/_build.py``) and bind it."""
    lib = _build.load_library(_build.CSRC / "match.cu")
    fn = lib.dspnet_bipartite_match
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dspnet_match_configure.argtypes = [ctypes.c_int]
    lib.dspnet_match_configure.restype = ctypes.c_int
    return lib


_configured = set()  # devices whose kernels may use _build.MAX_SHARED_BYTES


def _check_shapes(iou, col_valid):
    if iou.ndim != 3:
        raise ValueError(f"iou must be (B, A, L), got {tuple(iou.shape)}")
    if tuple(col_valid.shape) != (iou.shape[0], iou.shape[2]):
        raise ValueError(f"col_valid {tuple(col_valid.shape)} must be (B, L) = "
                         f"{(iou.shape[0], iou.shape[2])}")
    if iou.device != col_valid.device:
        raise ValueError(f"inputs on different devices: {iou.device}, {col_valid.device}")


def _launch(iou, col_valid, refills=None):
    global launches
    for name, t, dtype in (("iou", iou, torch.float32), ("col_valid", col_valid, torch.bool)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, A, L = iou.shape
    dev = iou.device
    if refills is not None and (refills.device != dev or refills.dtype != torch.int32
                                or tuple(refills.shape) != (B,)):
        raise ValueError(f"refills must be a ({B},) int32 tensor on {dev}")
    plan = launch_plan(B, A, L)
    matched = torch.empty((B, A), dtype=torch.bool, device=dev)
    match_gt = torch.empty((B, A), dtype=torch.int32, device=dev)
    match_iou = torch.empty((B, A), dtype=torch.float32, device=dev)
    if B == 0 or A == 0:
        return matched, match_gt, match_iou
    scratch = torch.empty(max(plan.scratch_bytes // 8, 1), dtype=torch.int64, device=dev)  # u64 keys
    lib = load_library()
    # enter the tensors' device only when it is not the current one
    other = dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if other else contextlib.nullcontext():
        if dev.index not in _configured:
            _build.check(lib, lib.dspnet_match_configure(_build.MAX_SHARED_BYTES), "matcher configure")
            _configured.add(dev.index)
        err = lib.dspnet_bipartite_match(
            iou.data_ptr(), col_valid.data_ptr(), matched.data_ptr(), match_gt.data_ptr(),
            match_iou.data_ptr(), scratch.data_ptr(), None if refills is None else refills.data_ptr(),
            B, A, L, plan.chunks, plan.topk_shared_bytes, plan.greedy_shared_bytes,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "bipartite match kernel launch")
    launches += 1
    return matched, match_gt, match_iou


def bipartite_match_reference(iou, col_valid):
    """Plain PyTorch matching, on any device: parallel propose/accept rounds
    that emit exactly the sequential greedy's pairs.

    Each round every open GT proposes its best available anchor (largest
    IoU, ties to the smallest anchor), and an anchor accepts a proposal only
    when the proposer is also the anchor's own best open GT (largest IoU,
    ties to the smallest GT). Such a mutually best pair comes before every
    pair that shares its anchor or its GT in the greedy's order (IoU
    descending, then row-major index), so the greedy emits it; the global
    first pair is always mutually best, so each round makes progress until
    no pair above 1e-6 is left.

    ``dspnet_tpu/ops/target.py::_bipartite_match`` lets an anchor accept its
    best *proposer* instead. On exact IoU ties that can take a pair the
    greedy does not (a GT that ties for an anchor but proposes it only in a
    later round loses it), so there the JAX rounds differ from the Pallas
    kernel and from the reference operator; without ties the two rules give
    the same matching.

    Returns ``(matched (B, A) bool, match_gt (B, A) int32 (-1 unmatched),
    match_iou (B, A) f32 (-1 unmatched))``.
    """
    global plain_calls
    plain_calls += 1
    _check_shapes(iou, col_valid)
    B, A, L = iou.shape
    dev = iou.device
    anchor_matched = torch.zeros((B, A), dtype=torch.bool, device=dev)
    match_gt = torch.full((B, A), -1, dtype=torch.int32, device=dev)
    match_iou = torch.full((B, A), -1.0, dtype=torch.float32, device=dev)
    gt_matched = torch.zeros((B, L), dtype=torch.bool, device=dev)
    if A == 0 or L == 0:
        return anchor_matched, match_gt, match_iou
    gt_range = torch.arange(L, device=dev).expand(B, L)
    while True:
        open_cols = col_valid & ~gt_matched
        avail = (~anchor_matched)[:, :, None] & open_cols[:, None, :]
        masked = torch.where(avail, iou, torch.full_like(iou, -1.0))
        prop_v = masked.amax(dim=1)  # (B, L)
        prop_a = masked.argmax(dim=1)  # first max: the smallest anchor
        row_best = masked.argmax(dim=2)  # (B, A): first max, the smallest GT
        accepted = ((prop_v > 1e-6) & open_cols
                    & (torch.gather(row_best, 1, prop_a) == gt_range))
        if not bool(accepted.any()):
            return anchor_matched, match_gt, match_iou
        b_idx, l_idx = accepted.nonzero(as_tuple=True)
        a_idx = prop_a[b_idx, l_idx]
        anchor_matched[b_idx, a_idx] = True
        match_gt[b_idx, a_idx] = l_idx.to(torch.int32)
        match_iou[b_idx, a_idx] = prop_v[b_idx, l_idx]
        gt_matched |= accepted


def bipartite_match(iou, col_valid, refills=None):
    """Batched greedy matching. iou (B, A, L) f32, col_valid (B, L) bool ->
    (matched (B, A) bool, match_gt (B, A) int32, match_iou (B, A) f32).

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version; any other device raises. ``refills``, a (B,) int32 CUDA tensor,
    receives the number of columns each image rescanned from device memory
    (a diagnostic of the kernel; the plain version has none).
    """
    _check_shapes(iou, col_valid)
    if iou.device.type == "cuda":
        return _launch(iou, col_valid, refills)
    if refills is not None:
        raise ValueError("refills counts the CUDA kernel's rescans; the plain version has none")
    if iou.device.type == "cpu":
        return bipartite_match_reference(iou, col_valid)
    raise ValueError(f"bipartite_match runs on cuda or cpu tensors, got {iou.device}")
