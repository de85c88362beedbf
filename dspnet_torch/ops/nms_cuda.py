"""Greedy class-aware NMS keep mask: the CUDA kernel and its plain version.

``nms_keep_mask`` replaces the TPU kernel
``dspnet_tpu/ops/nms_pallas.py::_nms_kernel`` (wrapper ``nms_keep_mask``).
It calls the registered operator ``dspnet::nms_keep_mask``
(``torch.ops.dspnet.nms_keep_mask``): for a CUDA tensor the operator
launches the hand-written kernel in ``csrc/nms.cu`` (the suppression bitmask
in shared memory, built by a thread block cluster per image, then a
tile-by-tile greedy scan; the source note there says what bounds it on the
card and what its design does about it); for a CPU tensor it runs
``nms_keep_mask_reference``, the plain PyTorch version. Any other device
raises. There is no fallback between the two. Its fake implementation gives
``torch.export`` and other tracers the (B, K) bool shape without running
either, so an exported program (``tools/export_serving.py``) holds a call
of the operator and launches the kernel when it runs on the card. Importing
``dspnet_torch.ops`` registers the operator, which ``torch.export.load``
needs before it reads such a program.

The kernel is compiled with ``nvcc`` for sm_90a at first use, into
``build/`` at the repository root (``ops/_build.py``), and loaded with
ctypes.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from dspnet_torch.ops import _build
from dspnet_torch.ops.boxes import iou_matrix

#: calls of the operator's CUDA implementation, each of which launched the
#: kernel (one or two CUDA launches each); a caller may reset it to 0
launches = 0
#: calls of the plain version (``nms_keep_mask_reference``), on any device; a path
#: on the card makes none, a caller may reset it to 0
plain_calls = 0

_TILE = 64  # rows per mask word (csrc/nms.cu kTile)
_MAX_CLUSTER = 16  # the largest thread block cluster Hopper schedules (8 is portable)


class LaunchPlan(NamedTuple):
    shared_path: bool  # True: mask in shared memory, one launch
    cluster: int       # blocks per image on the shared path (a thread block cluster)
    shared_bytes: int  # dynamic shared memory per block
    mask_bytes: int    # device-memory mask scratch (0 on the shared path)


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, K: int) -> LaunchPlan:
    """How ``csrc/nms.cu`` runs B images of K rows, a pure function of its
    arguments and the one owner of its sizes (the kernels carve their shared
    memory as the comments below lay it out and check nothing). The
    K x ceil(K/64) u64 mask lives in shared memory while it fits a block
    (with the boxes, their areas and class keys, and each row's suppressors
    inside its tile: K up to 1,216); then a cluster of up to 16 blocks builds
    it while the images leave SMs idle (132 // B on an H100). Above that the
    mask goes to a (B, K, T) device scratch and one block per image scans it
    a 64-row tile at a time.
    """
    T = -(-K // _TILE)
    # boxes (float4), (area, class key) (float2), the mask (K x T u64), each
    # row's suppressors inside its tile (K u64), then validw, removed, keepw
    # (T u64 each)
    image = K * (16 + 8 + 8) + (K * T + 3 * T) * 8
    if image <= _build.MAX_SHARED_BYTES:
        return LaunchPlan(True, max(1, min(_MAX_CLUSTER, _build.H100_SMS // max(B, 1))), image, 0)
    scan = (_TILE * T + 3 * T) * 8  # one 64-row tile of the mask, then validw, removed, keepw
    if scan > _build.MAX_SHARED_BYTES:
        raise ValueError(f"K={K}: a 64-row tile of the mask needs {scan} bytes of shared memory, "
                         f"more than the {_build.MAX_SHARED_BYTES} a block may use")
    return LaunchPlan(False, 1, scan, B * K * T * 8)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build ``csrc/nms.cu`` (at first use, ``ops/_build.py``) and bind it."""
    lib = _build.load_library(_build.CSRC / "nms.cu")
    fn = lib.dspnet_nms_keep_mask
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.dspnet_nms_configure.argtypes = [ctypes.c_int]
    lib.dspnet_nms_configure.restype = ctypes.c_int
    return lib


_configured = set()  # devices whose kernels may use _build.MAX_SHARED_BYTES


def _check_shapes(boxes, ids, valid):
    if boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if tuple(ids.shape) != tuple(boxes.shape[:2]) or tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(
            f"ids {tuple(ids.shape)} and valid {tuple(valid.shape)} must be (B, K) = "
            f"{tuple(boxes.shape[:2])}")
    if not (boxes.device == ids.device == valid.device):
        raise ValueError(f"inputs on different devices: {boxes.device}, {ids.device}, {valid.device}")


def _launch(boxes, ids, valid, nms_threshold, force_suppress, plan=None):
    global launches
    for name, t, dtype in (("boxes", boxes, torch.float32), ("ids", ids, torch.float32),
                           ("valid", valid, torch.bool)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (the kernel loads float4 rows)")
    B, K = valid.shape
    dev = boxes.device
    keep = torch.empty((B, K), dtype=torch.bool, device=dev)
    if B == 0 or K == 0:
        return keep
    plan = plan or launch_plan(B, K)
    lib = load_library()
    mask = (torch.empty(plan.mask_bytes // 8, dtype=torch.int64, device=dev)  # u64 bits
            if plan.mask_bytes else None)
    # enter the tensors' device only when it is not the current one
    other = dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if other else contextlib.nullcontext():
        if dev.index not in _configured:
            _build.check(lib, lib.dspnet_nms_configure(_build.MAX_SHARED_BYTES), "NMS kernel configure")
            _configured.add(dev.index)
        err = lib.dspnet_nms_keep_mask(
            boxes.data_ptr(), ids.data_ptr(), valid.data_ptr(),
            None if mask is None else mask.data_ptr(), keep.data_ptr(),
            B, K, float(nms_threshold), int(bool(force_suppress)), int(plan.shared_path),
            plan.cluster, plan.shared_bytes, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "NMS kernel launch")
    launches += 1
    return keep


def nms_keep_mask_reference(boxes, ids, valid, nms_threshold=0.5, force_suppress=False):
    """Plain PyTorch keep mask, on any device.

    The IoU matrix as ``boxes.iou_matrix``; row j suppresses row i when
    j < i, both are valid, the classes match (unless ``force_suppress``) and
    ``iou >= nms_threshold`` (compared in float32, as JAX compares f32 with a
    weak-typed Python float). Greedy NMS is the unique fixpoint of
    ``keep = valid & ~(keep @ S)``; iterating from ``keep = valid`` settles
    row i by step i + 1, so the loop ends.
    """
    global plain_calls
    plain_calls += 1
    _check_shapes(boxes, ids, valid)
    K = boxes.shape[1]
    iou = iou_matrix(boxes, boxes)
    row = torch.arange(K, device=boxes.device)
    suppress = ((row[:, None] < row[None, :]) & (iou >= nms_threshold)
                & valid[:, :, None] & valid[:, None, :])
    if not force_suppress:
        suppress &= ids[:, :, None] == ids[:, None, :]
    sup_f = suppress.float()
    keep = valid
    while True:
        hit = torch.bmm(keep.float()[:, None, :], sup_f)[:, 0] > 0.0
        new_keep = valid & ~hit
        if torch.equal(new_keep, keep):
            return new_keep
        keep = new_keep


@torch.library.custom_op("dspnet::nms_keep_mask", mutates_args=(), device_types="cpu")
def _nms_op(boxes: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor, nms_threshold: float,
            force_suppress: bool) -> torch.Tensor:
    return nms_keep_mask_reference(boxes, ids, valid, nms_threshold, force_suppress)


@_nms_op.register_kernel("cuda")
def _nms_op_cuda(boxes, ids, valid, nms_threshold, force_suppress):
    return _launch(boxes, ids, valid, nms_threshold, force_suppress)


@_nms_op.register_fake
def _nms_op_fake(boxes, ids, valid, nms_threshold, force_suppress):
    return valid.new_empty(valid.shape, dtype=torch.bool)


def nms_keep_mask(boxes, ids, valid, nms_threshold=0.5, force_suppress=False):
    """Batched keep mask. boxes (B, K, 4) f32, ids (B, K) f32 class ids,
    valid (B, K) bool -> keep (B, K) bool, through ``dspnet::nms_keep_mask``.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version; any other device raises.
    """
    _check_shapes(boxes, ids, valid)
    if boxes.device.type not in ("cuda", "cpu"):
        raise ValueError(f"nms_keep_mask runs on cuda or cpu tensors, got {boxes.device}")
    return _nms_op(boxes, ids, valid, float(nms_threshold), bool(force_suppress))
