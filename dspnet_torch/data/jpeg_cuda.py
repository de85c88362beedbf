"""JPEG decode on the card (nvJPEG + a colour kernel of our own) and its
plain version.

For a CUDA device, :func:`decode_batch` and :func:`decode_images` decode B
encoded buffers with nvJPEG (``csrc/jpeg.cu``, a plain C interface bound
with ctypes and built by ``ops/_build.py``, linked to the toolkit's
libnvjpeg) into planar Y, Cb and Cr at each stream's own subsampling
(``NVJPEG_OUTPUT_YUV``), then :func:`ycc_to_bgr` runs the file's hand-written
kernel: libjpeg-turbo's "fancy" chroma upsampling and fixed-point colour
conversion, BGR interleaved into a torch-allocated uint8 device buffer, on
the current stream of that device. Last, each image's Exif orientation is
applied (a flip or a transpose of the tensor), as ``cv2.imread`` does. For
the CPU they run the plain numpy decoder (``data/jpeg.py``), which equals
cv2's pixels. Any other device raises, and a failure of nvJPEG, of the
kernel or of their build raises: there is no fallback between the two.

Routes, counted per image in :data:`routes`: a baseline file goes through
nvJPEG's batched call; a progressive one through its single-image call
(``nvjpegDecode``), which takes progressive streams on the default backend;
and should the batched call refuse planar output on a card, its images go
one at a time through the single-image call too, under their own count. A
file coded as RGB rather than YCbCr raises on the card (cv2 writes none).

What remains between the card's pixels and libjpeg's is nvJPEG's IDCT
against libjpeg's ISLOW (``GATES``; ``tests/test_torch_jpeg_cuda.py`` and
``chip_smoke.py`` hold it there). nvJPEG's own interleaved output
(:func:`decode_batch_interleaved`), which replicates each chroma sample,
stays on no path: ``chip_smoke.py`` times it beside the planar route.

The sizes come from ``nvjpegGetImageInfo`` and the header
(``jpeg.read_info``). A decoding thread holds an ``nvjpegJpegState_t`` of
its own for the length of a call (from a pool, so the prefetch thread that
each epoch starts reuses the last one's); the handle of a (device, backend)
is shared. A call returns when the decode has finished on its stream: the
host buffers nvJPEG reads and the state's staging memory are then free for
the next call, and the output may be read on any stream that waits for this
one.
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

#: nvjpegOutputFormat_t values the wrapper asks for (nvjpeg.h: NVJPEG_OUTPUT_YUV
#: is 1, the three planes at the stream's subsampling; 2 is Y alone)
OUTPUT_YUV = 1
OUTPUT_BGRI = 6

#: decode calls that ran nvJPEG, and the images they decoded; a caller may
#: reset both to 0
launches = 0
images = 0
#: images by nvJPEG route: "batched", "single_progressive" (a progressive
#: file), "single_batched_refused" (the batched call refused planar output)
routes = {"batched": 0, "single_progressive": 0, "single_batched_refused": 0}
#: launches of the colour kernel, and calls of its plain version (0 on the
#: card's path)
color_launches = 0
color_plain_calls = 0

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
            ("dspnet_jpeg_batched_init", [vp, vp, i, i, i]),
            ("dspnet_jpeg_decode_batched", [vp, vp, i, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(sz),
                                            ctypes.POINTER(vp), ctypes.POINTER(sz), vp]),
            ("dspnet_jpeg_decode_single", [vp, vp, ctypes.c_char_p, sz, i, ctypes.POINTER(vp),
                                           ctypes.POINTER(sz), vp]),
            ("dspnet_jpeg_ycc_to_bgr", [vp, i, vp, vp, i, i, i, i, i, i, i, i, vp, vp])):
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


_free_states = {}  # (device index, backend, kind) -> [[state, (batch, format) it is sized for], ...]


@contextlib.contextmanager
def _state(device: torch.device, backend: int, batch: int, output_format: int = OUTPUT_YUV):
    """A decode state for (device, backend), sized for ``batch`` images in
    ``output_format`` (``batch`` 0: a state for the single-image call, kept
    apart from the batched ones), held by the calling thread alone until the
    block ends; then it goes back to a pool, so a thread that decodes one
    epoch and ends leaves its state to the next (nothing is created per
    epoch, nothing leaks)."""
    key = (device.index, backend, "single" if batch == 0 else "batched")
    lib = load_library()
    handle = _handle(device, backend)
    with _lock:
        pool = _free_states.setdefault(key, [])
        entry = pool.pop() if pool else None
    if entry is None:
        s = ctypes.c_void_p()
        with _on(device):
            _build.check(lib, lib.dspnet_jpeg_state_create(handle, ctypes.byref(s)), "nvjpegJpegStateCreate")
        entry = [s, None]
    try:
        if batch and entry[1] != (batch, output_format):
            with _on(device):
                _build.check(lib, lib.dspnet_jpeg_batched_init(handle, entry[0], batch, 1, output_format),
                             "nvjpegDecodeBatchedInitialize")
            entry[1] = (batch, output_format)
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


def _info(data: bytes, device: torch.device, backend: int):
    lib = load_library()
    out = (ctypes.c_int * 10)()
    _build.check(lib, lib.dspnet_jpeg_info(_handle(device, BACKEND if backend is None else backend),
                                           data, len(data), out), "nvjpegGetImageInfo")
    return tuple(out)


def image_info(data, device="cuda", backend: int = None) -> Tuple[int, int, int, int]:
    """(components, chroma subsampling, height, width) by
    ``nvjpegGetImageInfo`` (subsampling: nvjpegChromaSubsampling_t, 0 =
    4:4:4, 1 = 4:2:2, 2 = 4:2:0, 6 = gray)."""
    out = _info(bytes(data), _cuda_device(device), backend)
    return out[0], out[1], out[2], out[6]


def component_sizes(data, device="cuda", backend: int = None) -> List[Tuple[int, int]]:
    """(height, width) of each component as ``nvjpegGetImageInfo`` gives
    them: the planes nvJPEG writes under ``NVJPEG_OUTPUT_YUV``."""
    out = _info(bytes(data), _cuda_device(device), backend)
    return [(out[2 + c], out[6 + c]) for c in range(out[0])]


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


# ------------------------------------------------------------------ colour


def _tables(device):
    return [torch.from_numpy(t).to(device=device, dtype=torch.int32)
            for t in (jpeg._CR_R, jpeg._CB_B, jpeg._CR_G, jpeg._CB_G)]


def _fancy(c: torch.Tensor, fh: int, fv: int) -> torch.Tensor:
    """``jpeg._upsample`` on an int32 (h, w) tensor: h2v1 / h2v2 fancy
    upsampling, edges replicated, a plane at most 2 wide replicated."""
    if (fh, fv) == (1, 1):
        return c
    if c.shape[1] <= 2:
        return c.repeat_interleave(fv, 0).repeat_interleave(fh, 1)
    if fv == 1:  # h2v1: 3/4 the nearer + 1/4 the further sample, biases 1 and 2
        cols, (b1, b2), shift = [c], (1, 2), 2
    else:  # h2v2: column sums 3 * this row + the nearer other row, biases 8 and 7
        cols, (b1, b2), shift = [3 * c + torch.cat([c[:1], c[:-1]]), 3 * c + torch.cat([c[1:], c[-1:]])], (8, 7), 4
    out = []
    for col in cols:
        left = torch.cat([col[:, :1], col[:, :-1]], 1)
        right = torch.cat([col[:, 1:], col[:, -1:]], 1)
        pair = torch.stack([(3 * col + left + b1) >> shift, (3 * col + right + b2) >> shift], -1)
        out.append(pair.reshape(col.shape[0], -1))
    return out[0] if fv == 1 else torch.stack(out, 1).reshape(-1, out[0].shape[1])


def ycc_to_bgr_reference(y: torch.Tensor, cb=None, cr=None, factors=(1, 1)) -> torch.Tensor:
    """The colour kernel's plain version, on any device, in integer tensor
    ops: (H, W) uint8 Y and the (h, w) uint8 Cb and Cr planes (cropped to the
    component's size, ``jpeg.decode_planes``) with chroma factors ``(fh,
    fv)`` -> (H, W, 3) uint8 BGR, ``jpeg._upsample`` then ``jpeg.ycc_to_bgr``
    bit for bit. Without ``cb`` the image is gray: Y replicated."""
    global color_plain_calls
    color_plain_calls += 1
    if cb is None:
        return y.unsqueeze(-1).expand(*y.shape, 3).contiguous()
    H, W = y.shape
    fh, fv = factors
    cb, cr = (_fancy(p.to(torch.int32), fh, fv)[:H, :W] for p in (cb, cr))
    cr_r, cb_b, cr_g, cb_g = _tables(y.device)
    yi = y.to(torch.int32)
    cbl, crl = cb.long(), cr.long()
    bgr = torch.stack([yi + cb_b[cbl], yi + ((cb_g[cbl] + cr_g[crl]) >> 16), yi + cr_r[crl]], -1)
    return bgr.clamp(0, 255).to(torch.uint8)


def ycc_to_bgr(y: torch.Tensor, cb=None, cr=None, factors=(1, 1), out=None) -> torch.Tensor:
    """libjpeg's chroma upsampling and colour conversion (see
    :func:`ycc_to_bgr_reference` for the arguments). On a CUDA tensor the
    hand-written kernel of ``csrc/jpeg.cu`` runs on the current stream,
    into ``out`` when given (a contiguous (H, W, 3) uint8 tensor), and
    counts in :data:`color_launches`; the planes may be row-strided views.
    On a CPU tensor the plain version runs; any other device raises."""
    global color_launches
    if y.device.type == "cpu":
        res = ycc_to_bgr_reference(y, cb, cr, factors)
        return res if out is None else out.copy_(res)
    if y.device.type != "cuda":
        raise ValueError(f"the colour conversion runs on cuda or cpu, got {y.device}")
    H, W = y.shape
    fh, fv = factors
    gray = cb is None
    if gray:
        cb = cr = y
    planes = (y, cb, cr)
    if any(p.dtype != torch.uint8 or p.ndim != 2 or p.stride(1) != 1 or p.device != y.device for p in planes):
        raise ValueError("ycc_to_bgr takes 2-D uint8 planes on one device, rows contiguous")
    if cb.shape != cr.shape or cb.stride(0) != cr.stride(0):
        raise ValueError(f"Cb {tuple(cb.shape)} and Cr {tuple(cr.shape)} planes differ in shape or pitch")
    if not gray and ((fh, fv) not in ((1, 1), (2, 1), (2, 2))
                     or cb.shape != (-(-H // fv), -(-W // fh))):
        raise ValueError(f"chroma {tuple(cb.shape)} with factors {(fh, fv)} does not fit a {H}x{W} image")
    if out is None:
        out = torch.empty((H, W, 3), dtype=torch.uint8, device=y.device)
    elif out.shape != (H, W, 3) or out.dtype != torch.uint8 or not out.is_contiguous() or out.device != y.device:
        raise ValueError(f"out must be a contiguous ({H}, {W}, 3) uint8 tensor on {y.device}")
    lib = load_library()
    with _on(y.device):
        err = lib.dspnet_jpeg_ycc_to_bgr(y.data_ptr(), y.stride(0), cb.data_ptr(), cr.data_ptr(), cb.stride(0),
                                         H, W, cb.shape[0], cb.shape[1], fh, fv, int(gray), out.data_ptr(),
                                         torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, err, "ycc_to_bgr kernel launch")
    color_launches += 1
    return out


# ------------------------------------------------------------------ decode

# nvJPEG statuses (1000 + status) that mean "this call does not take it"
_REFUSED = {1002, 1004, 1009}


class _Planned:
    """One image's planes in a flat device buffer, and where its BGR goes."""

    def __init__(self, data: bytes, info: jpeg.Info, sizes):
        self.data, self.info = data, info
        H, W = info.height, info.width
        if info.components == 3:
            fh, fv = info.factors
            want = (-(-H // fv), -(-W // fh))
            if any(h < want[0] or w < want[1] for h, w in sizes[1:3]):
                raise jpeg.JpegError(f"nvJPEG's chroma planes {sizes[1:3]} are smaller than {want}")
            self.shapes = [(H, W), sizes[1], sizes[2]]
        else:  # gray: room for whatever nvJPEG writes into the chroma channels
            self.shapes = [(H, W)] * 3
        self.nbytes = sum(h * w for h, w in self.shapes)


def _nvjpeg_planes(buffers: Sequence[bytes], device: torch.device, backend: int):
    """nvJPEG's planar decode of every buffer into one flat device buffer:
    the plans, each with ``views`` (Y (H, W), Cb and Cr cropped to (ceil(H /
    fv), ceil(W / fh)); Y alone for gray). Counted in :data:`launches`,
    :data:`images` and :data:`routes`."""
    global launches, images
    lib = load_library()
    data = [bytes(b) for b in buffers]
    plans = []
    for d in data:
        info = jpeg.read_info(d)
        if info.rgb:
            raise jpeg.JpegError("a JPEG coded as RGB (not YCbCr) is not decoded on the card")
        plans.append(_Planned(d, info, component_sizes(d, device, backend)))
    planes = torch.empty(sum(p.nbytes for p in plans), dtype=torch.uint8, device=device)
    offset = 0
    for p in plans:
        H, W = p.info.height, p.info.width
        fh, fv = p.info.factors
        p.ptrs, p.pitches, p.views = [], [], []
        for h, w in p.shapes:
            p.ptrs.append(planes.data_ptr() + offset)
            p.pitches.append(w)
            p.views.append(planes[offset:offset + h * w].view(h, w))
            offset += h * w
        if p.info.components == 3:
            p.views = [p.views[0]] + [v[:-(-H // fv), :-(-W // fh)] for v in p.views[1:]]
        else:
            p.views = p.views[:1]
    batched = [p for p in plans if not p.info.progressive]
    single = [(p, "single_progressive") for p in plans if p.info.progressive]
    with _on(device):
        stream = torch.cuda.current_stream(device)
        if batched and not _refuses_planar.get((device.index, backend)):
            B = len(batched)
            with _state(device, backend, B) as (handle, state):
                err = lib.dspnet_jpeg_decode_batched(
                    handle, state, B, (ctypes.c_char_p * B)(*[p.data for p in batched]),
                    (ctypes.c_size_t * B)(*[len(p.data) for p in batched]),
                    (ctypes.c_void_p * (3 * B))(*[x for p in batched for x in p.ptrs]),
                    (ctypes.c_size_t * (3 * B))(*[x for p in batched for x in p.pitches]), stream.cuda_stream)
                if err in _REFUSED:
                    _refuses_planar[(device.index, backend)] = lib.dspnet_cuda_error_string(err).decode()
                else:
                    _build.check(lib, err, "nvjpegDecodeBatched")
                    routes["batched"] += B
                    batched = []
                stream.synchronize()  # the host buffers and the state are reused next call
        single += [(p, "single_batched_refused") for p in batched]
        if single:
            with _state(device, backend, 0) as (handle, state):
                for p, route in single:
                    err = lib.dspnet_jpeg_decode_single(handle, state, p.data, len(p.data), OUTPUT_YUV,
                                                        (ctypes.c_void_p * 3)(*p.ptrs),
                                                        (ctypes.c_size_t * 3)(*p.pitches), stream.cuda_stream)
                    _build.check(lib, err, "nvjpegDecode")
                    routes[route] += 1
                    stream.synchronize()  # the state is reused by the next image
    with _lock:
        launches += 1
        images += len(data)
    return plans


def decode_planes(buffers: Sequence[bytes], device="cuda", backend: int = None):
    """nvJPEG's planes of each image before the colour kernel, as
    ``[(planes, info)]``: planes are [Y, Cb, Cr] (chroma cropped to the
    component's size, as ``jpeg.decode_planes`` returns them) or [Y] for a
    gray image, uint8 tensors on ``device``; info is ``jpeg.read_info``'s."""
    device = _cuda_device(device)
    if device.type != "cuda":
        raise ValueError(f"nvJPEG's planes live on a cuda device, got {device}")
    plans = _nvjpeg_planes(buffers, device, BACKEND if backend is None else backend)
    return [(p.views, p.info) for p in plans]


def _decode_cuda(buffers: Sequence[bytes], device: torch.device, backend: int):
    """(one flat uint8 buffer holding every image's BGR in order, each image
    as an (H, W, 3) tensor: a view into it, or a copy when its orientation
    turned it)."""
    plans = _nvjpeg_planes(buffers, device, backend)
    out = torch.empty(sum(p.info.height * p.info.width * 3 for p in plans), dtype=torch.uint8, device=device)
    result, offset = [], 0
    with _on(device):
        for p in plans:
            H, W = p.info.height, p.info.width
            img = out[offset:offset + H * W * 3].view(H, W, 3)
            offset += H * W * 3
            ycc_to_bgr(*p.views, factors=p.info.factors, out=img)
            if p.info.orientation != 1:
                img = jpeg.orient(img, p.info.orientation).contiguous()
            result.append(img)
        torch.cuda.current_stream(device).synchronize()  # the planes' buffer is free once the kernels ran
    return out, result


#: (device index, backend) -> nvJPEG's answer when its batched call refused
#: planar output there (the images then take the single-image call)
_refuses_planar = {}


def decode_batch_interleaved(buffers: Sequence[bytes], device="cuda", backend: int = None) -> torch.Tensor:
    """(B, H, W, 3) uint8 BGR from nvJPEG's own interleaved output
    (``NVJPEG_OUTPUT_BGRI``: its chroma replicated, not libjpeg's). On no
    path: ``chip_smoke.py`` times it beside the planar route. Baseline files
    of one size, no orientation; not counted."""
    device = _cuda_device(device)
    backend = BACKEND if backend is None else backend
    lib = load_library()
    data = [bytes(b) for b in buffers]
    shapes = {image_info(d, device, backend)[2:] for d in data}
    if len(shapes) != 1:
        raise ValueError(f"mixed raw resolutions in one batch: {sorted(shapes)}")
    (h, w), B = shapes.pop(), len(data)
    out = torch.empty((B, h, w, 3), dtype=torch.uint8, device=device)
    ptrs = [x for i in range(B) for x in (out[i].data_ptr(), None, None)]
    pitches = [x for _ in range(B) for x in (w * 3, 0, 0)]
    with _state(device, backend, B, OUTPUT_BGRI) as (handle, state), _on(device):
        stream = torch.cuda.current_stream(device)
        err = lib.dspnet_jpeg_decode_batched(
            handle, state, B, (ctypes.c_char_p * B)(*data), (ctypes.c_size_t * B)(*[len(d) for d in data]),
            (ctypes.c_void_p * (3 * B))(*ptrs), (ctypes.c_size_t * (3 * B))(*pitches), stream.cuda_stream)
        _build.check(lib, err, "nvjpegDecodeBatched (BGRI)")
        stream.synchronize()
    return out


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
        return _decode_cuda(buffers, device, BACKEND if backend is None else backend)[1]
    if device.type == "cpu":
        return [torch.from_numpy(a) for a in _decode_plain(buffers)]
    raise ValueError(f"JPEG decode runs on cuda or cpu, got {device}")


def decode_batch(buffers: Sequence[bytes], device="cuda", backend: int = None) -> torch.Tensor:
    """Encoded JPEGs of one size -> (B, H, W, 3) uint8 BGR on ``device``;
    raises ValueError when the sizes differ."""
    device = _cuda_device(device)
    if device.type == "cuda":
        flat, imgs = _decode_cuda(buffers, device, BACKEND if backend is None else backend)
        if len({t.shape for t in imgs}) > 1:
            raise ValueError(f"mixed raw resolutions in one batch: {sorted({tuple(t.shape[:2]) for t in imgs})}")
        if flat.numel() == sum(t.numel() for t in imgs) and all(t._base is flat for t in imgs):
            return flat.view(len(imgs), *imgs[0].shape)  # no image was turned
        return torch.stack(imgs)
    if device.type == "cpu":
        arrays = _decode_plain(buffers)
        if len({a.shape for a in arrays}) > 1:
            raise ValueError(f"mixed raw resolutions in one batch: {sorted({a.shape[:2] for a in arrays})}")
        return torch.from_numpy(np.stack(arrays))
    raise ValueError(f"JPEG decode runs on cuda or cpu, got {device}")


#: how far the card's pixels may lie from libjpeg's (the plain decoder's):
#: mean |difference| over uint8 values, per chroma subsampling, at any size.
#: With libjpeg's upsampling and colour conversion done by the colour kernel,
#: what is left is nvJPEG's IDCT against libjpeg's ISLOW (PERF.md)
GATES = {"444": 0.5, "422": 0.5, "420": 0.5, "gray": 0.5}


def difference(got, want) -> dict:
    """Mean and max |got - want| and the share of values more than 2 levels
    apart, for two uint8 images of one shape."""
    d = np.abs(np.asarray(got, np.int16) - np.asarray(want, np.int16))
    return {"mean": float(d.mean()), "max": int(d.max()), "over2": float((d > 2).mean())}
