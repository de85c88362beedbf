"""JPEG 2000 decode on the card: the host's boxes, markers and tier-2
(``data/jpeg2000.py``), then three hand-written kernels
(``csrc/jpeg2000.cu``, built by ``ops/_build.py`` and bound with ctypes),
and their plain versions.

:func:`decode` reads one file as ``cv2.imdecode`` does under its flag. The
host runs :func:`jpeg2000.prepare` (the boxes, the markers and tier-2),
:func:`pack` lays every code-block's segment bytes and the tables the
kernels read into one buffer, which goes to the card through pinned memory
on the caller's current stream, and then:

* :func:`t1_decode`: ``t1_decode_kernel``, one thread per code-block, every
  code-block of the file in one launch -> the int32 buffer of all
  tile-components' subbands (twice each coefficient plus half a step, as
  OpenJPEG keeps it);
* :func:`idwt`: ``idwt_kernel``, two launches a decomposition level (rows,
  then columns, over all tile-components), dequantising what tier-1 left
  (and one launch more for tile-components with no decomposition) -> the
  samples, int32 for 5/3 and float32 bits for 9/7, in place;
* :func:`mct_store`: ``mct_store_kernel``, one thread a pixel: inverse RCT
  or ICT, DC shift, rounding, clipping and cv2's output rule -> an (H, W[,
  C]) uint8 or uint16 tensor, BGR(A) or gray.

Each wrapper adds one to :data:`launches` where it launches its kernel and
nowhere else. On a CPU tensor each runs its plain version instead,
:func:`t1_decode_ref`, :func:`idwt_ref` and :func:`mct_store_ref` (the plain
decoder's own stages on tensors, counted in :data:`plain_calls`); on a
CUDA tensor it launches the kernel or raises. A form the kernels cannot
take (a palette, which OpenJPEG applies after decoding; a code-block of 31
bit-planes or more) raises on the card, naming it: nothing falls back to the
plain decoder, whose whole-image count ``jpeg2000.decodes`` the card's path
leaves at 0. What cv2 returns None for raises before any upload, as in the
plain decoder. A call returns when its kernels have finished on the stream.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from dspnet_torch.data import cvt_color, jpeg2000
from dspnet_torch.ops import _build

#: columns of the block table (``csrc/jpeg2000.cu``'s B_* order)
BLOCK_FIELDS = ("data", "seg", "nseg", "out", "stride", "w", "h", "orient", "numbps", "style", "roi", "flags")
#: columns of the tile-component table (T_*)
TC_FIELDS = ("off", "w", "h", "nl", "rev", "res", "x0", "y0", "prec", "mct", "comp", "pad")
#: columns of the resolution table (R_*): size, parity of the origin, and
#: half the step of LL / HL / LH / HH as float32 bits
RES_FIELDS = ("w", "h", "casx", "casy", "step_ll", "step_hl", "step_lh", "step_hh")

#: kernel launches by kernel; a caller may reset them to 0
launches = {"t1_decode": 0, "idwt": 0, "mct_store": 0}
#: calls of each plain version (0 on the card's path)
plain_calls = {"t1_decode": 0, "idwt": 0, "mct_store": 0}
#: images decoded through the kernels, by wavelet: "5/3", "9/7" or "mixed"
routes = {"5/3": 0, "9/7": 0, "mixed": 0}

_SOURCE = _build.CSRC / "jpeg2000.cu"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build ``csrc/jpeg2000.cu`` (at first use) and bind it."""
    lib = _build.load_library(_SOURCE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dspnet_j2k_t1.argtypes = [vp, vp, vp, i, vp, vp, vp]
    lib.dspnet_j2k_idwt.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
    lib.dspnet_j2k_mct_store.argtypes = [vp, vp, i, i, i, i, i, i, i, i, i, i, ctypes.POINTER(i), vp, vp]
    for f in (lib.dspnet_j2k_t1, lib.dspnet_j2k_idwt, lib.dspnet_j2k_mct_store):
        f.restype = i
    return lib


@dataclass
class Packed:
    """One file laid out for the kernels (numpy, on the host)."""

    plan: jpeg2000.Plan
    rule: jpeg2000.Rule
    blob: np.ndarray  # uint8: every block's segments, back to back
    blocks: np.ndarray  # int32 (n, BLOCK_FIELDS)
    segs: np.ndarray  # int32 (m, 2): bytes, passes
    tcs: np.ndarray  # int32 (tiles * components, TC_FIELDS)
    res: np.ndarray  # int32 (resolutions, RES_FIELDS)
    chan: List[int]  # the codestream component of each output channel
    flag_words: int

    @property
    def shape(self):
        cs = self.plan.cs
        ch = 1 if self.rule.to_gray else len(self.rule.channels)
        return (cs.height, cs.width) if ch == 1 else (cs.height, cs.width, ch)

    @property
    def levels(self) -> int:
        return int(self.tcs[:, 3].max(initial=0))


def pack(plan: jpeg2000.Plan, flags: int) -> Packed:
    """Lay ``plan`` out for the kernels under cv2's rule for ``flags``;
    raises where cv2 returns None and on forms the kernels do not take."""
    cs = plan.cs
    if plan.boxes.pclr is not None:
        raise ValueError("JPEG 2000 with a palette (pclr) is not decoded on the card (OpenJPEG applies it "
                         "after decoding; the plain decoder reads it)")
    image = jpeg2000.jp2_components(plan, [None] * len(cs.prec))
    rule = jpeg2000.output_rule(image, flags)
    chan = [image.order[c] for c in rule.channels]
    if any(t.mct not in (0, 1) for t in plan.tiles):
        raise ValueError("JPEG 2000 multiple component transform of Part 2 is not read")
    blob, blocks, segs, flag_words = [], [], [], 0
    pos = 0
    for tc, band, blk in plan.blocks:
        seg_list, w, h, orient, numbps, style, roi = jpeg2000.block_args(tc, band, blk)
        if roi + numbps >= 31:
            raise ValueError(f"JPEG 2000 code-block with {roi + numbps} bit-planes (OpenJPEG stops at 30)")
        blocks.append((pos, len(segs), len(seg_list), tc.offset + blk.by * tc.w + blk.bx, tc.w, w, h, orient,
                       numbps, style, roi, flag_words))
        for data, npass in seg_list:
            blob.append(data)
            segs.append((len(data), npass))
            pos += len(data)
        flag_words += (w + 2) * (h + 2)
    tcs, res = [], []
    for tile in plan.tiles:
        for tc in tile.comps:
            tcs.append((tc.offset, tc.w, tc.h, tc.coding.levels, int(tc.coding.reversible), len(res), tc.x0, tc.y0,
                        cs.prec[tc.comp], tile.mct, tc.comp, 0))
            for rr in tc.resolutions:
                steps = [0, 0, 0, 0]
                if not tc.coding.reversible:
                    for band in rr.bands:
                        half = np.float32(0.5) * np.float32(band.step)
                        steps[band.orient] = int(np.array(half, np.float32).view(np.int32))
                res.append((rr.x1 - rr.x0, rr.y1 - rr.y0, rr.x0 % 2, rr.y0 % 2, *steps))
    return Packed(plan, rule, np.frombuffer(b"".join(blob), np.uint8),
                  np.array(blocks, np.int32).reshape(-1, len(BLOCK_FIELDS)),
                  np.array(segs, np.int32).reshape(-1, 2), np.array(tcs, np.int32).reshape(-1, len(TC_FIELDS)),
                  np.array(res, np.int32).reshape(-1, len(RES_FIELDS)), chan, flag_words)


@dataclass
class Staged:
    """A packed file's tables as tensors on one device."""

    packed: Packed
    blob: torch.Tensor
    blocks: torch.Tensor
    segs: torch.Tensor
    tcs: torch.Tensor
    res: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.blocks.device


def stage(packed: Packed, device) -> Staged:
    """Copy the tables and the segment bytes to ``device`` in one transfer
    (through pinned memory, on the current stream, for a CUDA device)."""
    device = torch.device(device)
    tables = [packed.blocks, packed.segs, packed.tcs, packed.res]
    ints = np.concatenate([t.reshape(-1) for t in tables]).view(np.uint8)
    host = torch.from_numpy(np.concatenate([ints, packed.blob]))
    if device.type == "cuda":
        pinned = torch.empty(host.shape, dtype=torch.uint8, pin_memory=True)
        pinned.copy_(host)
        buf = pinned.to(device, non_blocking=True)
    elif device.type == "cpu":
        buf = host
    else:
        raise ValueError(f"JPEG 2000 decodes on a CUDA device or the CPU, not {device}")
    views, pos = [], 0
    for t in tables:
        n = t.size * 4
        views.append(buf[pos:pos + n].view(torch.int32).view(t.shape))
        pos += n
    return Staged(packed, buf[pos:], *views)


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def t1_decode_ref(st: Staged, map=map) -> torch.Tensor:
    """Tier-1 of every block from the staged tables, one block at a time by
    the plain decoder (``jpeg2000.t1_decode_block``) -> the int32 buffer of
    all tile-components' subbands. ``map`` may be a process pool's."""
    plain_calls["t1_decode"] += 1
    p = st.packed
    blob = st.blob.cpu().numpy().tobytes()
    blocks, segs = st.blocks.cpu().numpy(), st.segs.cpu().numpy()
    jobs = []
    for b in blocks:
        pos, seg_list = int(b[0]), []
        for k in range(int(b[1]), int(b[1]) + int(b[2])):
            n = int(segs[k, 0])
            seg_list.append((blob[pos:pos + n], int(segs[k, 1])))
            pos += n
        jobs.append((seg_list, int(b[5]), int(b[6]), int(b[7]), int(b[8]), int(b[9]), int(b[10])))
    out = np.zeros(p.plan.size, np.int32)
    for b, vals in zip(blocks, map(jpeg2000._t1_decode_star, jobs)):
        h, w = vals.shape
        idx = int(b[3]) + np.arange(h)[:, None] * int(b[4]) + np.arange(w)[None, :]
        out[idx] = vals
    return torch.from_numpy(out).to(st.device)


def t1_decode(st: Staged) -> torch.Tensor:
    """``t1_decode_kernel`` on a CUDA device (one launch for every
    code-block), :func:`t1_decode_ref` on the CPU."""
    if st.device.type == "cpu":
        return t1_decode_ref(st)
    p = st.packed
    coef = torch.zeros(max(p.plan.size, 1), dtype=torch.int32, device=st.device)
    flags = torch.zeros(max(p.flag_words, 1), dtype=torch.int32, device=st.device)
    n = len(p.blocks)
    if n:
        lib = load_library()
        err = lib.dspnet_j2k_t1(st.blob.data_ptr(), st.blocks.data_ptr(), st.segs.data_ptr(), n, coef.data_ptr(),
                                flags.data_ptr(), _stream(st.device))
        launches["t1_decode"] += 1
        _build.check(lib, err, "t1_decode_kernel")
    return coef[:p.plan.size]


def idwt_ref(st: Staged, coef: torch.Tensor) -> torch.Tensor:
    """Dequantisation and the inverse wavelet of every tile-component by the
    plain decoder (``jpeg2000.inverse_dwt``): a new tensor."""
    plain_calls["idwt"] += 1
    return torch.from_numpy(jpeg2000.inverse_dwt(st.packed.plan, coef.cpu().numpy())).to(coef.device)


def idwt(st: Staged, coef: torch.Tensor) -> torch.Tensor:
    """``idwt_kernel``, two launches a level (rows, then columns) and one for
    tile-components with no decomposition, in place on ``coef`` (returned);
    :func:`idwt_ref` on the CPU."""
    if coef.device.type == "cpu":
        return idwt_ref(st, coef)
    p = st.packed
    if not coef.is_contiguous() or coef.dtype != torch.int32 or coef.numel() != p.plan.size:
        raise ValueError("idwt takes t1_decode's contiguous int32 buffer")
    lib = load_library()
    tmp = torch.empty_like(coef)
    ntc = len(p.tcs)
    res = p.res
    plans = []
    if (p.tcs[:, 3] == 0).any():
        plans.append((0, 2, int(p.tcs[:, 2].max())))
    for level in range(1, p.levels + 1):
        rows = [res[t[5] + level, 1] for t in p.tcs if t[3] >= level]
        cols = [res[t[5] + level, 0] for t in p.tcs if t[3] >= level]
        plans += [(level, 0, int(max(rows))), (level, 1, int(max(cols)))]
    for level, direction, lines in plans:
        err = lib.dspnet_j2k_idwt(coef.data_ptr(), tmp.data_ptr(), st.tcs.data_ptr(), st.res.data_ptr(), ntc, level,
                                  direction, lines, _stream(coef.device))
        launches["idwt"] += 1
        _build.check(lib, err, "idwt_kernel")
    return coef


def mct_store_ref(st: Staged, samples: torch.Tensor) -> torch.Tensor:
    """The plain decoder's last stages (``jpeg2000.components``, the boxes'
    ``cdef`` and cv2's rule) on the sample buffer."""
    plain_calls["mct_store"] += 1
    p = st.packed
    planes = jpeg2000.components(p.plan, samples.cpu().numpy())
    img = jpeg2000.jp2_components(p.plan, planes)
    return torch.from_numpy(np.ascontiguousarray(jpeg2000.apply_rule(img, p.rule))).to(samples.device)


def mct_store(st: Staged, samples: torch.Tensor) -> torch.Tensor:
    """``mct_store_kernel``, one launch for the image; :func:`mct_store_ref`
    on the CPU."""
    if samples.device.type == "cpu":
        return mct_store_ref(st, samples)
    p = st.packed
    cs, rule = p.plan.cs, p.rule
    out = torch.empty(p.shape, dtype=torch.uint16 if rule.dtype == np.uint16 else torch.uint8, device=samples.device)
    chan = (ctypes.c_int * 4)(*(p.chan + [0] * (4 - len(p.chan)))[:4])
    lib = load_library()
    err = lib.dspnet_j2k_mct_store(samples.data_ptr(), st.tcs.data_ptr(), cs.height, cs.width, cs.tw, cs.th, cs.ntx,
                                   len(cs.prec), len(rule.channels), int(rule.to_gray), rule.shift,
                                   int(rule.dtype == np.uint16), chan, out.data_ptr(), _stream(samples.device))
    launches["mct_store"] += 1
    _build.check(lib, err, "mct_store_kernel")
    if rule.yuv:  # sYCC: cvtColor's integer YUV rule as torch ops on the card
        out = yuv_to_bgr(out)
    return out


def yuv_to_bgr(img: torch.Tensor) -> torch.Tensor:
    """``cvt_color.yuv_to_bgr`` as integer torch ops on ``img``'s device."""
    top = 255 if img.dtype == torch.uint8 else 65535
    d = (top + 1) // 2
    y, u, v = (img[..., i].to(torch.int64) for i in range(3))
    cb, cg1, cg2, cr = cvt_color.YUV2BGR
    b = y + (((u - d) * cb + 8192) >> 14)
    g = y + (((u - d) * cg1 + (v - d) * cg2 + 8192) >> 14)
    r = y + (((v - d) * cr + 8192) >> 14)
    return torch.stack([b, g, r], -1).clamp_(0, top).to(img.dtype)


def decode(data, flags: int = jpeg2000.IMREAD_COLOR, device="cuda") -> torch.Tensor:
    """JPEG 2000 bytes -> ``cv2.imdecode``'s array under ``flags`` as a
    tensor on ``device``: the three kernels on a CUDA device, their plain
    versions on the CPU. Returns when the kernels have finished."""
    device = torch.device(device)
    plan = jpeg2000.prepare(bytes(data))
    st = stage(pack(plan, flags), device)
    out = mct_store(st, idwt(st, t1_decode(st)))
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
        revs = {tc.coding.reversible for t in plan.tiles for tc in t.comps}
        routes["mixed" if len(revs) > 1 else ("5/3" if revs == {True} else "9/7")] += 1
    return out
