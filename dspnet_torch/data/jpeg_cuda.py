"""Batched JPEG decode on the card (nvJPEG) and its plain version.

For a CUDA device, :func:`decode_batch` and :func:`decode_images` decode B
encoded buffers with nvJPEG's batched API (``csrc/jpeg.cu``, a plain C
interface bound with ctypes and built by ``ops/_build.py``, linked to the
toolkit's libnvjpeg) straight into a torch-allocated uint8 device buffer, BGR
interleaved, on the current stream of that device. For the CPU they run the
plain numpy decoder (``data/jpeg.py``), which equals cv2's pixels. Any other
device raises, and a failure of nvJPEG or of its build raises: there is no
fallback between the two.

nvJPEG does not give libjpeg's pixels: its IDCT and its 4:2:0 chroma
upsampling differ (PERF.md and ``chip_smoke.py`` hold the measured
differences; ``tests/test_torch_jpeg_cuda.py`` the gates).

The sizes come from ``nvjpegGetImageInfo``. A decoding thread holds an
``nvjpegJpegState_t`` of its own for the length of a call (from a pool, so
the prefetch thread that each epoch starts reuses the last one's); the handle
of a (device, backend) is shared. A call returns when the decode has finished on its stream: the host
buffers nvJPEG reads and the state's staging memory are then free for the
next call, and the output may be read on any stream that waits for this one.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from dspnet_torch.data import jpeg
from dspnet_torch.ops import _build

#: nvjpegBackend_t values this wrapper offers
BACKEND_DEFAULT = 0
BACKEND_HARDWARE = 3
#: the backend the loader uses: the default one. The hardware backend (the
#: H100's JPEG engines) answers "architecture mismatch" on the H100 this was
#: measured on (PERF.md), so only the default one passes there.
BACKEND = BACKEND_DEFAULT

#: batched decode calls that ran nvJPEG, and the images they decoded; a
#: caller may reset both to 0
launches = 0
images = 0

_SOURCE = _build.CSRC / "jpeg.cu"
_lock = threading.Lock()


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build ``csrc/jpeg.cu`` (at first use) and bind it."""
    lib = _build.load_library(_SOURCE)
    vp, sz, i, pi = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    for name, args in (
            ("dspnet_jpeg_create", [i, ctypes.POINTER(vp)]),
            ("dspnet_jpeg_destroy", [vp]),
            ("dspnet_jpeg_state_create", [vp, ctypes.POINTER(vp)]),
            ("dspnet_jpeg_state_destroy", [vp]),
            ("dspnet_jpeg_info", [vp, ctypes.c_char_p, sz, pi]),
            ("dspnet_jpeg_batched_supported", [vp, ctypes.c_char_p, sz, pi]),
            ("dspnet_jpeg_batched_init", [vp, vp, i, i]),
            ("dspnet_jpeg_decode_batched", [vp, vp, i, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(sz),
                                            ctypes.POINTER(vp), ctypes.POINTER(sz), vp])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def _on(device: torch.device):
    """Enter ``device`` only when it is not the current one."""
    other = device.index != torch.cuda.current_device()
    with torch.cuda.device(device) if other else contextlib.nullcontext():
        yield


_handles = {}


def _handle(device: torch.device, backend: int):
    key = (device.index, backend)
    with _lock:
        if key not in _handles:
            lib = load_library()
            h = ctypes.c_void_p()
            with _on(device):
                _build.check(lib, lib.dspnet_jpeg_create(backend, ctypes.byref(h)), "nvjpegCreateEx")
            _handles[key] = h
        return _handles[key]


_free_states = {}  # (device index, backend) -> [[state, batch it is sized for], ...]


@contextlib.contextmanager
def _state(device: torch.device, backend: int, batch: int):
    """A decode state for (device, backend), sized for ``batch``, held by
    the calling thread alone until the block ends; then it goes back to a
    pool, so a thread that decodes one epoch and ends leaves its state to
    the next (nothing is created per epoch, nothing leaks)."""
    key = (device.index, backend)
    lib = load_library()
    handle = _handle(device, backend)
    with _lock:
        pool = _free_states.setdefault(key, [])
        entry = pool.pop() if pool else None
    if entry is None:
        s = ctypes.c_void_p()
        with _on(device):
            _build.check(lib, lib.dspnet_jpeg_state_create(handle, ctypes.byref(s)), "nvjpegJpegStateCreate")
        entry = [s, 0]
    try:
        if entry[1] != batch:
            with _on(device):
                _build.check(lib, lib.dspnet_jpeg_batched_init(handle, entry[0], batch, 1),
                             "nvjpegDecodeBatchedInitialize")
            entry[1] = batch
        yield handle, entry[0]
    finally:
        with _lock:
            _free_states[key].append(entry)


def _cuda_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


_ARCH_MISMATCH = 1007  # csrc/jpeg.cu: 1000 + NVJPEG_STATUS_ARCH_MISMATCH


def backend_available(backend: int, device="cuda") -> bool:
    """Whether nvJPEG makes a handle for ``backend`` on ``device``: False
    when it answers "architecture mismatch" (the backend does not exist on
    this card or with this software); any other failure raises."""
    device = _cuda_device(device)
    with _lock:
        if (device.index, backend) in _handles:
            return True
    lib = load_library()
    h = ctypes.c_void_p()
    with _on(device):
        err = lib.dspnet_jpeg_create(backend, ctypes.byref(h))
    if err == _ARCH_MISMATCH:
        return False
    _build.check(lib, err, "nvjpegCreateEx")
    with _lock:
        if (device.index, backend) in _handles:
            _build.check(lib, lib.dspnet_jpeg_destroy(h), "nvjpegDestroy")
        else:
            _handles[(device.index, backend)] = h
    return True


def image_info(data, device="cuda", backend: int = None) -> Tuple[int, int, int, int]:
    """(components, chroma subsampling, height, width) by
    ``nvjpegGetImageInfo`` (subsampling: nvjpegChromaSubsampling_t, 0 =
    4:4:4, 1 = 4:2:2, 2 = 4:2:0, 6 = gray)."""
    device = _cuda_device(device)
    lib = load_library()
    data = bytes(data)
    out = (ctypes.c_int * 4)()
    _build.check(lib, lib.dspnet_jpeg_info(_handle(device, BACKEND if backend is None else backend),
                                           data, len(data), out), "nvjpegGetImageInfo")
    return tuple(out)


def batched_supported(data, device="cuda", backend: int = BACKEND_HARDWARE) -> bool:
    """Whether ``backend`` decodes this stream in a batch
    (``nvjpegDecodeBatchedSupported``)."""
    device = _cuda_device(device)
    lib = load_library()
    data = bytes(data)
    flag = ctypes.c_int()
    _build.check(lib, lib.dspnet_jpeg_batched_supported(_handle(device, backend), data, len(data),
                                                        ctypes.byref(flag)), "nvjpegDecodeBatchedSupported")
    return bool(flag.value)


def _decode_cuda(buffers: Sequence[bytes], device: torch.device, backend: int):
    """One flat uint8 device buffer holding every image, and their (H, W)."""
    global launches, images
    lib = load_library()
    data = [bytes(b) for b in buffers]
    shapes = [image_info(d, device, backend)[2:] for d in data]
    sizes = [h * w * 3 for h, w in shapes]
    flat = torch.empty(sum(sizes), dtype=torch.uint8, device=device)
    B = len(data)
    ptrs, offset = [], 0
    for n in sizes:
        ptrs.append(flat.data_ptr() + offset)
        offset += n
    with _state(device, backend, B) as (handle, state), _on(device):
        stream = torch.cuda.current_stream(device)
        err = lib.dspnet_jpeg_decode_batched(
            handle, state, B, (ctypes.c_char_p * B)(*data), (ctypes.c_size_t * B)(*[len(d) for d in data]),
            (ctypes.c_void_p * B)(*ptrs), (ctypes.c_size_t * B)(*[w * 3 for _, w in shapes]),
            stream.cuda_stream)
        _build.check(lib, err, "nvjpegDecodeBatched")
        stream.synchronize()  # the host buffers and the state are reused next call
    with _lock:
        launches += 1
        images += B
    return flat, shapes


def _decode_plain(buffers: Sequence[bytes]) -> List[np.ndarray]:
    out = []
    for b in buffers:
        img = jpeg.decode(b)
        out.append(np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img)
    return out


def decode_images(buffers: Sequence[bytes], device="cuda", backend: int = None) -> List[torch.Tensor]:
    """Encoded JPEGs -> one (H_i, W_i, 3) uint8 BGR tensor each on ``device``
    (the sizes may differ: on CUDA, views into one buffer)."""
    device = _cuda_device(device)
    if device.type == "cuda":
        flat, shapes = _decode_cuda(buffers, device, BACKEND if backend is None else backend)
        out, offset = [], 0
        for h, w in shapes:
            out.append(flat[offset:offset + h * w * 3].view(h, w, 3))
            offset += h * w * 3
        return out
    if device.type == "cpu":
        return [torch.from_numpy(a) for a in _decode_plain(buffers)]
    raise ValueError(f"JPEG decode runs on cuda or cpu, got {device}")


def decode_batch(buffers: Sequence[bytes], device="cuda", backend: int = None) -> torch.Tensor:
    """Encoded JPEGs of one size -> (B, H, W, 3) uint8 BGR on ``device``;
    raises ValueError when the sizes differ."""
    device = _cuda_device(device)
    if device.type == "cuda":
        flat, shapes = _decode_cuda(buffers, device, BACKEND if backend is None else backend)
        if len(set(shapes)) > 1:
            raise ValueError(f"mixed raw resolutions in one batch: {sorted(set(shapes))}")
        h, w = shapes[0]
        return flat.view(len(shapes), h, w, 3)
    if device.type == "cpu":
        arrays = _decode_plain(buffers)
        if len({a.shape for a in arrays}) > 1:
            raise ValueError(f"mixed raw resolutions in one batch: {sorted({a.shape[:2] for a in arrays})}")
        return torch.from_numpy(np.stack(arrays))
    raise ValueError(f"JPEG decode runs on cuda or cpu, got {device}")


#: how far nvJPEG's pixels may lie from libjpeg's (the plain decoder's):
#: mean |difference| over uint8 values, per chroma subsampling, on images
#: of 256x512 and more ("420"); "420_box" holds at any size against the
#: plain decoder with replicated chroma (``jpeg.decode(...,
#: fancy_upsampling=False)``), the upsampling nvJPEG appears to use: on the
#: synthetic scenes' sharp colour edges libjpeg's triangle filter and
#: replication differ by tens of levels, and small images are mostly edges
#: (PERF.md)
GATES = {"444": 0.5, "420": 1.5, "420_box": 0.5, "gray": 0.5}


def difference(got, want) -> dict:
    """Mean and max |got - want| and the share of values more than 2 levels
    apart, for two uint8 images of one shape."""
    d = np.abs(np.asarray(got, np.int16) - np.asarray(want, np.int16))
    return {"mean": float(d.mean()), "max": int(d.max()), "over2": float((d > 2).mean())}
