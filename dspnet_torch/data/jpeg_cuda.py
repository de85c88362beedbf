"""JPEG decode on the card (nvJPEG + a colour kernel of our own) and its
plain version.

For a CUDA device, :func:`decode_batch` and :func:`decode_images` decode B
encoded buffers with nvJPEG (``csrc/jpeg.cu``, a plain C interface bound
with ctypes and built by ``ops/_build.py``, linked to the toolkit's
libnvjpeg) into planar components at each stream's own sampling
(``NVJPEG_OUTPUT_YUV``), then :func:`ycc_to_bgr` runs the file's hand-written
kernel: libjpeg-turbo's upsampling (each component by its own factors, the
method ``jinit_upsampler`` picks) and fixed-point colour conversion, BGR
interleaved into a torch-allocated uint8 device buffer, on the current
stream of that device. Last, each image's Exif orientation is applied (a
flip or a transpose of the tensor), as ``cv2.imread`` does. For the CPU
they run the plain numpy decoder (``data/jpeg.py``), which equals cv2's
pixels. Any other device raises, and a failure of nvJPEG, of the kernel or
of their build raises: there is no fallback between the two.

Routes, chosen per image from its header before any nvJPEG call and
counted in :data:`routes`: a lossless file (no DCT for nvJPEG to run) has
its samples reconstructed on the host (``jpeg.lossless_planes``), uploaded
and passed through the colour kernel with every factor replicated; an
arithmetic-coded file, and a progressive one with restart intervals (which
nvJPEG's single-image call refuses), is rewritten as one baseline Huffman
scan (``jpeg.transcode_baseline``: the quantised coefficients unchanged)
and decoded by nvJPEG's batched call; a baseline YCbCr or gray file goes
through nvJPEG's batched call; a progressive one through its single-image
call (``nvjpegDecode``), which takes progressive streams on the default
backend; a file coded as RGB (Adobe transform 0), CMYK or YCCK through the
single-image call with its planes unchanged (``NVJPEG_OUTPUT_UNCHANGED``),
then the colour kernel's mode for that coding; and should the batched call
refuse planar output on a card, its images go one at a time through the
single-image call too, under their own count. A stream that uses a Huffman
table it never defines (a Motion-JPEG frame) gets Annex K's tables
inserted first (``jpeg.with_default_huffman``, libjpeg's own fallback).
What cv2 returns None for (12-bit, fractional sampling factors, a lossless
file that would need a colour conversion) raises before nvJPEG, naming the
form, and so does whatever nvJPEG refuses.

:func:`encode` is the card's JPEG encoder: nvJPEG's ``nvjpegEncodeImage``
from an interleaved BGR tensor on the card (baseline JFIF, quality 95 and
4:2:0 by default, the standard Huffman tables), counted in
:data:`encodes`; on a CPU tensor it runs the plain numpy encoder
(``jpeg.encode``). A failure of nvJPEG raises.

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
OUTPUT_UNCHANGED = 0
OUTPUT_YUV = 1
OUTPUT_BGRI = 6

#: the colour kernel's mode for each coding of ``jpeg.Info.color``
#: (``csrc/jpeg.cu``: kYcc, kGray, kRgb, kCmyk, kYcck)
MODES = {"ycc": 0, "gray": 1, "rgb": 2, "cmyk": 3, "ycck": 4}
#: the encoder's chroma subsampling, nvjpegChromaSubsampling_t's 4:2:0 (cv2's
#: default, the JAX demo's output)
_CSS_420 = 2

#: decode calls that ran nvJPEG, and the images they decoded; a caller may
#: reset both to 0
launches = 0
images = 0
#: images by route: "batched", "single_progressive" (a progressive file),
#: "single_unchanged" (coded as RGB, CMYK or YCCK), "single_batched_refused"
#: (the batched call refused planar output), "transcoded" (arithmetic-coded,
#: or progressive with restart intervals: rewritten by
#: ``jpeg.transcode_baseline``, then nvJPEG), "host_lossless" (lossless:
#: samples reconstructed on the host, no nvJPEG)
routes = {"batched": 0, "single_progressive": 0, "single_unchanged": 0, "single_batched_refused": 0,
          "transcoded": 0, "host_lossless": 0}
#: images the card's encoder (nvJPEG) encoded; a caller may reset it to 0
encodes = 0
#: launches of the colour kernel (and by mode, ``MODES``), and calls of its
#: plain version (0 on the card's path)
color_launches = 0
color_mode_launches = {"ycc": 0, "gray": 0, "rgb": 0, "cmyk": 0, "ycck": 0}
#: launches of the colour kernel by each plane's factors, "1x1,2x2,2x2"
#: (" replicated" after them when ``fancy`` was off: a lossless file)
color_factor_launches = {}
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
            ("dspnet_jpeg_ycc_to_bgr", [ctypes.POINTER(vp), pi, i, i, i, i, i, vp, vp]),
            ("dspnet_jpeg_encoder_create", [vp, i, i, ctypes.POINTER(vp), ctypes.POINTER(vp), vp]),
            ("dspnet_jpeg_encoder_destroy", [vp, vp]),
            ("dspnet_jpeg_encode_bgr", [vp, vp, vp, vp, sz, i, i, ctypes.POINTER(sz), vp]),
            ("dspnet_jpeg_encode_retrieve", [vp, vp, ctypes.c_char_p, ctypes.POINTER(sz), vp])):
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


def _upsample(c: torch.Tensor, fh: int, fv: int, fancy: bool = True) -> torch.Tensor:
    """``jpeg._upsample`` on an int32 (h, w) tensor: h2v1 / h2v2 fancy on a
    plane wider than 2 samples, h1v2 fancy, replication at every other
    factor (and at all of them without ``fancy``)."""
    if (fh, fv) == (1, 1):
        return c
    if fancy and (fh, fv) == (1, 2):  # h1v2: 3/4 this row + 1/4 the nearer other, biases 1 and 2
        up, down = torch.cat([c[:1], c[:-1]]), torch.cat([c[1:], c[-1:]])
        return torch.stack([(3 * c + up + 1) >> 2, (3 * c + down + 2) >> 2], 1).reshape(-1, c.shape[1])
    if not fancy or c.shape[1] <= 2 or (fh, fv) not in ((2, 1), (2, 2)):
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


def _geometry(y, cb, k, factors, upsampling, size, out=None):
    """((H, W), each plane's factors) of a call: ``upsampling`` when given
    (``jpeg.Info.upsampling``), else Y at full size, Cb and Cr at
    ``factors``, K at full size or at the chroma's."""
    if size is None:
        size = tuple(out.shape[:2]) if out is not None else tuple(y.shape)
    if upsampling is None:
        upsampling = [(1, 1)] + ([] if cb is None else [tuple(factors)] * 2)
        if k is not None:
            upsampling.append((1, 1) if tuple(k.shape) == tuple(size) else tuple(factors))
    return tuple(size), [tuple(f) for f in upsampling]


def ycc_to_bgr_reference(y: torch.Tensor, cb=None, cr=None, factors=(1, 1), color: str = "ycc",
                         k=None, fancy: bool = True, upsampling=None, size=None) -> torch.Tensor:
    """The colour kernel's plain version, on any device, in integer tensor
    ops: (H, W) uint8 Y and the (h, w) uint8 Cb and Cr planes (cropped to the
    component's size, ``jpeg.decode_planes``) with chroma factors ``(fh,
    fv)`` (each 1..4) -> (H, W, 3) uint8 BGR, ``jpeg._upsample`` then
    ``jpeg.ycc_to_bgr`` bit for bit. Without ``cb`` the image is gray: Y
    replicated. ``color`` "rgb": the three planes are R, G, B (upsampled,
    reordered); "cmyk" / "ycck": ``k`` is the fourth plane (at full size, or
    at the chroma's), and ``jpeg.cmyk_to_bgr`` (after ``jpeg.ycck_to_cmyk``)
    gives the pixels. ``fancy`` False replicates at every factor (a lossless
    file, as libjpeg upsamples it). ``upsampling``: every plane's factors
    (``jpeg.Info.upsampling``) for a geometry where Y is subsampled too,
    with the image's ``size`` (H, W)."""
    global color_plain_calls
    color_plain_calls += 1
    (H, W), up = _geometry(y, cb, k, factors, upsampling, size)
    planes = [_upsample(p.to(torch.int32), fh, fv, fancy)[:H, :W]
              for p, (fh, fv) in zip([y, cb, cr, k][:len(up)], up)]
    yi = planes[0]
    if cb is None:
        return yi.to(torch.uint8).unsqueeze(-1).expand(H, W, 3).contiguous()
    cb, cr = planes[1:3]
    if color == "rgb":
        return torch.stack([cr, cb, yi], -1).to(torch.uint8)
    cr_r, cb_b, cr_g, cb_g = _tables(y.device)
    cbl, crl = cb.long(), cr.long()
    bgr = torch.stack([yi + cb_b[cbl], yi + ((cb_g[cbl] + cr_g[crl]) >> 16), yi + cr_r[crl]], -1)
    if color == "ycc":
        return bgr.clamp(0, 255).to(torch.uint8)
    if k is None:
        raise ValueError(f"a {color} image needs its fourth plane")
    k = planes[3]
    if color == "ycck":  # the YCbCr colour inverted and range-limited is the CMY
        cmy = (255 - bgr).clamp(0, 255)
    elif color == "cmyk":
        cmy = torch.stack([cr, cb, yi], -1)
    else:
        raise ValueError(f"color must be one of {sorted(MODES)}, got {color!r}")
    return (k[..., None] - (((255 - cmy) * k[..., None]) >> 8)).to(torch.uint8)


def ycc_to_bgr(y: torch.Tensor, cb=None, cr=None, factors=(1, 1), out=None, color: str = "ycc",
               k=None, fancy: bool = True, upsampling=None, size=None) -> torch.Tensor:
    """libjpeg's upsampling and colour conversion (see
    :func:`ycc_to_bgr_reference` for the arguments). On a CUDA tensor the
    hand-written kernel of ``csrc/jpeg.cu`` runs on the current stream,
    into ``out`` when given (a contiguous (H, W, 3) uint8 tensor), and
    counts in :data:`color_launches`; the planes may be row-strided views.
    On a CPU tensor the plain version runs; any other device raises."""
    global color_launches
    if y.device.type == "cpu":
        res = ycc_to_bgr_reference(y, cb, cr, factors, color, k, fancy, upsampling,
                                   size if size is not None or out is None else tuple(out.shape[:2]))
        return res if out is None else out.copy_(res)
    if y.device.type != "cuda":
        raise ValueError(f"the colour conversion runs on cuda or cpu, got {y.device}")
    if cb is None:
        color = "gray"
    if color not in MODES:
        raise ValueError(f"color must be one of {sorted(MODES)}, got {color!r}")
    four = color in ("cmyk", "ycck")
    if four and k is None:
        raise ValueError(f"a {color} image needs its fourth plane")
    (H, W), up = _geometry(y, cb, k if four else None, factors, upsampling, size, out)
    planes = [y] if cb is None else [y, cb, cr] + ([k] if four else [])
    if len(up) != len(planes):
        raise ValueError(f"{len(up)} upsampling factors for {len(planes)} planes")
    if any(p.dtype != torch.uint8 or p.ndim != 2 or p.stride(1) != 1 or p.device != y.device for p in planes):
        raise ValueError("ycc_to_bgr takes 2-D uint8 planes on one device, rows contiguous")
    for p, (fh, fv) in zip(planes, up):
        if not (1 <= fh <= 4 and 1 <= fv <= 4) or tuple(p.shape) != (-(-H // fv), -(-W // fh)):
            raise ValueError(f"a plane {tuple(p.shape)} with factors {(fh, fv)} does not fit a {H}x{W} image")
    if out is None:
        out = torch.empty((H, W, 3), dtype=torch.uint8, device=y.device)
    elif out.shape != (H, W, 3) or out.dtype != torch.uint8 or not out.is_contiguous() or out.device != y.device:
        raise ValueError(f"out must be a contiguous ({H}, {W}, 3) uint8 tensor on {y.device}")
    n = len(planes)
    geometry = [v for p, (fh, fv) in zip(planes, up) for v in (p.stride(0), p.shape[0], p.shape[1], fh, fv)]
    lib = load_library()
    with _on(y.device):
        err = lib.dspnet_jpeg_ycc_to_bgr((ctypes.c_void_p * n)(*[p.data_ptr() for p in planes]),
                                         (ctypes.c_int * (5 * n))(*geometry), n, H, W, MODES[color], int(fancy),
                                         out.data_ptr(), torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(lib, err, "ycc_to_bgr kernel launch")
    color_launches += 1
    color_mode_launches[color] += 1
    key = ",".join(f"{fh}x{fv}" for fh, fv in up) + ("" if fancy else " replicated")
    color_factor_launches[key] = color_factor_launches.get(key, 0) + 1
    return out


# ------------------------------------------------------------------ decode

# nvJPEG statuses (1000 + status) that mean "this call does not take it"
_REFUSED = {1002, 1004, 1009}


class _Planned:
    """One image's planes in a flat device buffer, and where its BGR goes.
    ``host`` holds a lossless file's planes, reconstructed on the host (no
    nvJPEG); ``route`` names a route chosen from the header ("transcoded",
    "host_lossless"), else None."""

    def __init__(self, data: bytes, info: jpeg.Info, sizes, route=None, host=None):
        self.data, self.info, self.route, self.host = data, info, route, host
        H, W = info.height, info.width
        want = [(-(-H // v), -(-W // h)) for h, v in info.upsampling]
        if info.components > 1:
            if any(h < wh or w < ww for (h, w), (wh, ww) in zip(sizes, want)):
                raise jpeg.JpegError(f"nvJPEG's planes {sizes[:len(want)]} are smaller than {want}")
            self.shapes, self.crops = list(sizes[:len(want)]), want
        else:  # gray: room for whatever nvJPEG writes into the chroma channels
            self.shapes, self.crops = [(H, W)] * 3, [(H, W)]
        self.nbytes = sum(h * w for h, w in self.shapes)


def _plan(data, device: torch.device, backend: int) -> _Planned:
    """The route of one file, chosen from its header before any nvJPEG
    call: a lossless file's samples are reconstructed on the host; an
    arithmetic-coded file, and a progressive one with restart intervals
    (which nvJPEG's single-image call refuses), are rewritten as baseline
    (``jpeg.transcode_baseline``); a stream that uses a Huffman table it
    never defines gets Annex K's tables (``jpeg.with_default_huffman``)."""
    data = bytes(data)
    info = jpeg.read_info(data)
    jpeg.check_sampling(info)
    if info.lossless:
        jpeg.check_conversion(info, "bgr")
        planes = jpeg.lossless_planes(data).planes
        return _Planned(data, info, [p.shape for p in planes], "host_lossless", planes)
    route = None
    if info.coding == "arithmetic" or (info.progressive and info.restart):
        data, route = jpeg.transcode_baseline(data), "transcoded"
        info = jpeg.read_info(data)
    data = jpeg.with_default_huffman(data)
    return _Planned(data, info, component_sizes(data, device, backend), route)


def _nvjpeg_planes(buffers: Sequence[bytes], device: torch.device, backend: int):
    """nvJPEG's planar decode of every buffer into one flat device buffer:
    the plans, each with ``views`` (each component's plane cropped to its
    size: Y (H, W), Cb and Cr (ceil(H / fv), ceil(W / fh)), a fourth one for
    CMYK / YCCK; Y alone for gray). Counted in :data:`launches`,
    :data:`images` and :data:`routes`."""
    global launches, images
    lib = load_library()
    plans = [_plan(b, device, backend) for b in buffers]
    planes = torch.empty(sum(p.nbytes for p in plans), dtype=torch.uint8, device=device)
    offset = 0
    for p in plans:
        p.ptrs, p.pitches, p.views = [], [], []
        for h, w in p.shapes:
            p.ptrs.append(planes.data_ptr() + offset)
            p.pitches.append(w)
            p.views.append(planes[offset:offset + h * w].view(h, w))
            offset += h * w
        p.views = [v[:h, :w] for v, (h, w) in zip(p.views, p.crops)]
    host = [p for p in plans if p.host is not None]
    card = [p for p in plans if p.host is None]
    unchanged = [p for p in card if p.info.color not in ("ycc", "gray")]
    batched = [p for p in card if not p.info.progressive and p not in unchanged]
    single = [(p, "single_progressive", OUTPUT_YUV) for p in card if p.info.progressive and p not in unchanged]
    single += [(p, "single_unchanged", OUTPUT_UNCHANGED) for p in unchanged]
    with _on(device):
        stream = torch.cuda.current_stream(device)
        for p in host:  # the host's samples into their planes
            for view, plane in zip(p.views, p.host):
                view.copy_(torch.from_numpy(plane))
            routes["host_lossless"] += 1
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
                    for p in batched:
                        routes[p.route or "batched"] += 1
                    batched = []
                stream.synchronize()  # the host buffers and the state are reused next call
        single += [(p, "single_batched_refused", OUTPUT_YUV) for p in batched]
        if single:
            with _state(device, backend, 0) as (handle, state):
                for p, route, fmt in single:
                    ptrs = (p.ptrs + [None] * 4)[:4]
                    pitches = (p.pitches + [0] * 4)[:4]
                    err = lib.dspnet_jpeg_decode_single(handle, state, p.data, len(p.data), fmt,
                                                        (ctypes.c_void_p * 4)(*ptrs),
                                                        (ctypes.c_size_t * 4)(*pitches), stream.cuda_stream)
                    if err:
                        info = p.info
                        raise jpeg.JpegError(
                            f"nvJPEG's single-image call refused a {info.components}-component {info.color} JPEG "
                            f"({'progressive' if info.progressive else 'sequential'}, upsampling {info.upsampling}, "
                            f"restart interval {info.restart or 'none'}): {lib.dspnet_cuda_error_string(err).decode()}")
                    routes[p.route or route] += 1
                    stream.synchronize()  # the state is reused by the next image
    with _lock:
        launches += 1
        images += len(plans)
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
            ycc_to_bgr(*p.views[:3], out=img, color=p.info.color, k=p.views[3] if p.info.components == 4 else None,
                       fancy=not p.info.lossless, upsampling=p.info.upsampling)
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
        jpeg.check_conversion(jpeg.read_info(b), "bgr")  # what cv2's IMREAD_COLOR refuses (decode checks the sampling)
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


# ------------------------------------------------------------------ encode

_encoders = {}  # (device index, quality, css) -> (state, params, lock)


def _encoder(device: torch.device, quality: int, css: int):
    """The (state, params, lock) of an encoder for (device, quality, chroma
    subsampling), made at first use."""
    key = (device.index, quality, css)
    handle = _handle(device, BACKEND_DEFAULT)  # takes _lock itself
    with _lock:
        if key not in _encoders:
            lib = load_library()
            state, params = ctypes.c_void_p(), ctypes.c_void_p()
            with _on(device):
                _build.check(lib, lib.dspnet_jpeg_encoder_create(
                    handle, quality, css, ctypes.byref(state), ctypes.byref(params),
                    torch.cuda.current_stream(device).cuda_stream), "nvjpegEncoder{State,Params}Create")
            _encoders[key] = (state, params, threading.Lock())
        return _encoders[key]


def encode(img, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 BGR tensor -> baseline JFIF JPEG bytes at 4:2:0. On a
    CUDA tensor nvJPEG encodes it on the card (``nvjpegEncodeImage`` on the
    current stream, after the work queued there; counted in
    :data:`encodes`); on a CPU tensor or a numpy array the plain encoder
    (``jpeg.encode``) runs. Any other device raises, and so does a failure of
    nvJPEG."""
    global encodes
    if isinstance(img, np.ndarray) or img.device.type == "cpu":
        return jpeg.encode(np.asarray(img), quality)
    if img.device.type != "cuda":
        raise ValueError(f"JPEG encode runs on cuda or cpu, got {img.device}")
    if img.dtype != torch.uint8 or img.ndim != 3 or img.shape[-1] != 3 or img.stride(1) != 3 or img.stride(2) != 1:
        raise ValueError(f"encode takes an (H, W, 3) uint8 BGR tensor, pixels contiguous, got "
                         f"{tuple(img.shape)} {img.dtype}")
    device = _cuda_device(img.device)
    H, W = img.shape[:2]
    lib = load_library()
    state, params, lock = _encoder(device, int(quality), _CSS_420)
    handle = _handle(device, BACKEND_DEFAULT)
    with lock, _on(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        length = ctypes.c_size_t()
        _build.check(lib, lib.dspnet_jpeg_encode_bgr(handle, state, params, img.data_ptr(), img.stride(0), H, W,
                                                      ctypes.byref(length), stream), "nvjpegEncodeImage")
        out = ctypes.create_string_buffer(length.value)
        _build.check(lib, lib.dspnet_jpeg_encode_retrieve(handle, state, out, ctypes.byref(length), stream),
                     "nvjpegEncodeRetrieveBitstream")
    with _lock:
        encodes += 1
    return out.raw[:length.value]


#: how far the card's pixels may lie from libjpeg's (the plain decoder's):
#: mean |difference| over uint8 values, per chroma subsampling, at any size.
#: With libjpeg's upsampling and colour conversion done by the colour kernel,
#: what is left is nvJPEG's IDCT against libjpeg's ISLOW (PERF.md)
GATES = {"444": 0.5, "422": 0.5, "420": 0.5, "gray": 0.5}
#: how far below the plain encoder's PSNR (against the source, same quality
#: and subsampling) the card encoder's may lie, in dB; the plain encoder is
#: held within 1 dB of cv2's (``tests/test_torch_jpeg.py``)
ENCODE_GATE_DB = 1.0


def difference(got, want) -> dict:
    """Mean and max |got - want| and the share of values more than 2 levels
    apart, for two uint8 images of one shape."""
    d = np.abs(np.asarray(got, np.int16) - np.asarray(want, np.int16))
    return {"mean": float(d.mean()), "max": int(d.max()), "over2": float((d > 2).mean())}
