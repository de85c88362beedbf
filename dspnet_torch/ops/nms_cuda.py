"""Greedy class-aware NMS keep mask: the CUDA kernel and its plain version.

``nms_keep_mask`` replaces the TPU kernel
``dspnet_tpu/ops/nms_pallas.py::_nms_kernel`` (wrapper ``nms_keep_mask``).
For a CUDA tensor it launches the hand-written kernel in ``csrc/nms.cu``
(bitmask build, then one sequential greedy scan per image; the source note
there says what bounds it on the card and what its design does about it).
For a CPU tensor it runs ``nms_keep_mask_reference``, the plain PyTorch
version. Any other device raises. There is no fallback between the two.

The kernel is compiled with ``nvcc`` for sm_90a at first use, into
``build/`` at the repository root (``ops/_build.py``), and loaded with
ctypes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dspnet_torch.ops import _build
from dspnet_torch.ops.boxes import iou_matrix

#: kernel launches made by ``nms_keep_mask``; a caller may reset it to 0
launches = 0


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build ``csrc/nms.cu`` (at first use, ``ops/_build.py``) and bind it."""
    lib = _build.load_library("nms")
    fn = lib.dspnet_nms_keep_mask
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_shapes(boxes, ids, valid):
    if boxes.ndim != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(boxes.shape)}")
    if tuple(ids.shape) != tuple(boxes.shape[:2]) or tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(
            f"ids {tuple(ids.shape)} and valid {tuple(valid.shape)} must be (B, K) = "
            f"{tuple(boxes.shape[:2])}")
    if not (boxes.device == ids.device == valid.device):
        raise ValueError(f"inputs on different devices: {boxes.device}, {ids.device}, {valid.device}")


def _launch(boxes, ids, valid, nms_threshold, force_suppress):
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
    keep = torch.empty((B, K), dtype=torch.bool, device=boxes.device)
    if B == 0 or K == 0:
        return keep
    words = (K + 63) // 64
    mask = torch.empty((B, K, words), dtype=torch.int64, device=boxes.device)  # uint64 bits
    lib = load_library()
    with torch.cuda.device(boxes.device):
        err = lib.dspnet_nms_keep_mask(
            boxes.data_ptr(), ids.data_ptr(), valid.data_ptr(), mask.data_ptr(), keep.data_ptr(),
            B, K, float(nms_threshold), int(bool(force_suppress)),
            torch.cuda.current_stream(boxes.device).cuda_stream)
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


def nms_keep_mask(boxes, ids, valid, nms_threshold=0.5, force_suppress=False):
    """Batched keep mask. boxes (B, K, 4) f32, ids (B, K) f32 class ids,
    valid (B, K) bool -> keep (B, K) bool.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version; any other device raises.
    """
    _check_shapes(boxes, ids, valid)
    if boxes.device.type == "cuda":
        return _launch(boxes, ids, valid, nms_threshold, force_suppress)
    if boxes.device.type == "cpu":
        return nms_keep_mask_reference(boxes, ids, valid, nms_threshold, force_suppress)
    raise ValueError(f"nms_keep_mask runs on cuda or cpu tensors, got {boxes.device}")
