"""AVIF decode on the card: the host's items, headers and entropy parse
(``data/heif.py``, ``av1_obu.py``, ``av1_parse.py``), then four hand-written
kernels (``csrc/av1.cu``, built by ``ops/_build.py`` and bound with ctypes),
and their plain versions.

:func:`decode` reads one file as ``cv2.imdecode`` does under its flag. For
each AV1 item the host parses every tile, :func:`pack` lays the parse's
tables (the transform blocks in decode order with their prediction and
dequantisation constants, the coefficients, the palettes and colour maps,
the superblock waves, the deblocking edges, the CDEF indices and skip map,
the restoration rectangles) into one buffer, which goes to the card through
pinned memory on the caller's current stream, beside the constant tables
(uploaded once per device), and then:

* :func:`recon`: ``av1_recon_kernel``, one launch per superblock wavefront
  -> the frame before the loop filters (int32 planes);
* :func:`deblock`: ``av1_deblock_kernel``, one launch per direction over all
  planes -> the deblocked planes (new tensors);
* :func:`cdef`: ``av1_cdef_kernel``, one launch -> the CDEF planes;
* :func:`loop_restore`: ``av1_lr_kernel``, one launch -> the restored
  planes.

Film grain (its templates and block offsets made on the host), the grid's
assembly, the alpha plane's merge and libavif's colour rule then run as
torch ops on the card (``data/av1_grain.py``, ``data/avif.py``). Each
wrapper adds one to :data:`launches` where it launches its kernel and
nowhere else. On a CPU tensor each runs its plain version instead
(:func:`recon_ref`, :func:`deblock_ref`, :func:`cdef_ref`,
:func:`loop_restore_ref` over ``av1_recon.py`` and ``av1_filters.py``,
counted in :data:`plain_calls`): ``decode(data, flags, "cpu")`` is the
port's AVIF reader on the host (``image_io.imdecode``). On a CUDA tensor a
wrapper launches its kernel or raises; nothing falls back to a plain
version, and what cv2 returns None for raises before any upload. An
IntraBC source that the wavefront would not have finished raises, naming
it. A call returns when its kernels have finished on the stream.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from dspnet_torch.data import av1_filters, av1_parse, av1_recon, avif
from dspnet_torch.data import av1_tables as T
from dspnet_torch.data.av1_parse import KIND_INTRABC, Parsed
from dspnet_torch.ops import _build

#: columns of the kernel's transform-block table (``csrc/av1.cu``'s X_*)
TXB_FIELDS = ("kind", "plane", "x", "y", "tx", "type", "eob", "coef", "scan", "flags", "mode", "ftype", "angle",
              "fmode", "cfl", "dcq", "acq", "qm", "dqshift", "w", "h", "maxlw", "maxlh", "mvr", "mvc", "pal", "map",
              "mapw", "mapx0", "mapy0")
#: columns of the restoration rectangles (R_*)
LR_FIELDS = ("plane", "x", "y", "w", "h", "type", "s0", "s1", "c0", "c1", "c2", "c3", "c4", "c5", "set", "xq0", "xq1")
#: the constant tables in the order of ``dspnet_av1_recon``'s offsets
TABLE_LAYOUT = ("cospi", "sinpi", "fi_taps", "smooth", "dr_deriv", "mode_angle", "scans", "qm", "inv_shift")

#: kernel launches by kernel; a caller may reset them to 0
launches = {"recon": 0, "deblock": 0, "cdef": 0, "lr": 0}
#: calls of each plain version (0 on the card's path)
plain_calls = {"recon": 0, "deblock": 0, "cdef": 0, "lr": 0}

_SOURCE = _build.CSRC / "av1.cu"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build ``csrc/av1.cu`` (at first use) and bind it."""
    lib = _build.load_library(_SOURCE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.dspnet_av1_recon.argtypes = [vp, ip, i, i, i, i, i, vp, ip, vp, vp, vp, vp, i, i, vp, vp, vp, vp]
    lib.dspnet_av1_deblock.argtypes = [vp, ip, i, i, vp, i, i, i, vp]
    lib.dspnet_av1_cdef.argtypes = [vp, vp, ip, i, i, i, i, vp, i, vp, i, i, i, i, ip, vp]
    lib.dspnet_av1_lr.argtypes = [vp, vp, vp, ip, i, i, vp, i, vp, vp, vp, vp]
    for f in (lib.dspnet_av1_recon, lib.dspnet_av1_deblock, lib.dspnet_av1_cdef, lib.dspnet_av1_lr):
        f.restype = i
    return lib


def _table_arrays() -> List[np.ndarray]:
    return [T.cospi(12), T.sinpi(12), T.table("filter_intra_taps").reshape(-1), T.table("smooth_weights"),
            T.table("dr_intra_derivative"), T.table("mode_to_angle"), T.table("scans"), T.table("qm").reshape(-1),
            T.table("inv_shift").reshape(-1)]


@functools.lru_cache(maxsize=8)
def device_tables(device: torch.device) -> tuple:
    """The constant tables as one int32 tensor on ``device`` and the offset
    of each (``TABLE_LAYOUT``)."""
    arrays = [np.asarray(a).astype(np.int32).reshape(-1) for a in _table_arrays()]
    offsets = np.cumsum([0] + [len(a) for a in arrays[:-1]]).astype(np.int32)
    buf = torch.from_numpy(np.concatenate(arrays)).to(device)
    return buf, offsets


@functools.cache
def _scan_offsets() -> np.ndarray:
    lens = T.table("scan_len").astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return starts[T.table("scan_index").astype(np.int64)]


@dataclass
class Packed:
    """One frame's parse laid out for the kernels (numpy, on the host)."""

    parsed: Parsed
    txbs: np.ndarray  # int32 (n, TXB_FIELDS)
    sb_first: np.ndarray  # int32 per superblock
    sb_count: np.ndarray
    waves: List[np.ndarray]  # superblock ids of each wave
    coefs: np.ndarray  # int32
    palette: np.ndarray  # int32
    maps: np.ndarray  # uint8
    edges: List[np.ndarray]  # per direction: int32 (n, 5) plane, x, y, length, level
    cdef_idx: np.ndarray  # int8 (fb rows, fb cols)
    skip: np.ndarray  # uint8 (mi rows, mi cols)
    cdef_params: np.ndarray  # int32 (42,)
    rects: np.ndarray  # int32 (n, LR_FIELDS)
    geom: np.ndarray  # int32 (planes, 5): pitch, last x / y of the mi grid, last x / y of the frame
    dims: List[tuple]


def _wave_lag(parsed: Parsed) -> int:
    """Superblock (r, c) runs in wave c + lag * r: 2 for intra prediction's
    above-right reach; with IntraBC, 5 (64x64) or 3 (128x128), so that every
    source av1_is_dv_valid admits lies in an earlier wave."""
    h, s = parsed.frame.hdr, parsed.frame.seq
    if not h.allow_intrabc:
        return 2
    return 3 if s.sb128 else 5


def _check_intrabc(parsed: Parsed, lag: int) -> None:
    """Every IntraBC source lies in superblocks of earlier waves."""
    s = parsed.frame.seq
    sb_px = 128 if s.sb128 else 64
    for b in parsed.blocks:
        if not b[21]:
            continue
        r, c, bsize = int(b[0]), int(b[1]), int(b[2])
        y0, x0 = r * 4 + (int(b[15]) >> 3), c * 4 + (int(b[16]) >> 3)
        y1, x1 = y0 + T.BLOCK_H[bsize] + 1, x0 + T.BLOCK_W[bsize] + 1
        cur = (c * 4) // sb_px + lag * ((r * 4) // sb_px)
        for sy in range(max(0, y0) // sb_px, y1 // sb_px + 1):
            for sx in range(max(0, x0) // sb_px, x1 // sb_px + 1):
                if sx + lag * sy >= cur:
                    raise avif.AvifError(f"AVIF IntraBC source at ({y0}, {x0}) not finished by the superblock "
                                         f"wavefront (lag {lag}) before the block at ({r * 4}, {c * 4})")


def pack(parsed: Parsed) -> Packed:
    """Lay ``parsed`` out for the kernels."""
    s, h = parsed.frame.seq, parsed.frame.hdr
    bd = s.bit_depth
    k = {8: "8", 10: "10", 12: "12"}[bd]
    dcq_t, acq_t = T.table("dc_q" + k).astype(np.int64), T.table("ac_q" + k).astype(np.int64)
    tx = parsed.txbs.astype(np.int64)
    blk = parsed.blocks.astype(np.int64)
    n = len(tx)
    out = np.zeros((n, len(TXB_FIELDS)), np.int64)
    if n:
        kind, plane, x, y, txs, ttype, eob, coef, bi, mode, flags, sb, ftype, qidx, w, hh = (tx[:, i] for i in range(16))
        b = blk[bi]
        out[:, 0:8] = np.stack([kind, plane, x, y, txs, ttype, eob, np.maximum(coef, 0)], 1)
        out[:, 8] = np.where(kind == KIND_INTRABC, 0, _scan_offsets()[txs, ttype])
        out[:, 9], out[:, 10], out[:, 11] = flags, mode, ftype
        out[:, 12] = np.where(plane == 0, b[:, 5], b[:, 6])
        out[:, 13] = np.maximum(b[:, 7], 0)
        out[:, 14] = np.where(plane == 1, b[:, 8], b[:, 9])
        dc_delta = np.array([h.delta_q_y_dc, h.delta_q_u_dc, h.delta_q_v_dc])[plane]
        ac_delta = np.array([0, h.delta_q_u_ac, h.delta_q_v_ac])[plane]
        out[:, 15] = dcq_t[np.clip(qidx + dc_delta, 0, 255)]
        out[:, 16] = acq_t[np.clip(qidx + ac_delta, 0, 255)]
        seg = b[:, 19]
        lossless = np.array(h.lossless)[seg] == 1
        level = np.array(h.seg_qm_level, np.int64)[plane, seg] if h.using_qmatrix else np.full(n, 15)
        qm_tx = np.array([T.qm_offset(t) for t in range(19)], np.int64)[txs]
        use_qm = (level < 15) & (ttype < T.IDTX) & ~lossless & (kind != KIND_INTRABC)
        out[:, 17] = np.where(use_qm, (level * 2 + (plane > 0)) * 3344 + qm_tx, -1)
        pels = np.array(T.TX_W, np.int64)[txs] * np.array(T.TX_H, np.int64)[txs]
        out[:, 18] = (pels > 256).astype(np.int64) + (pels > 1024)
        out[:, 19], out[:, 20] = w, hh
        out[:, 21], out[:, 22] = b[:, 17], b[:, 18]
        out[:, 23], out[:, 24] = b[:, 15], b[:, 16]
        pal_off = b[:, 12]
        out[:, 25] = np.where(pal_off >= 0, pal_off * 24 + plane * 8, -1)
        map_off = np.where(plane == 0, b[:, 13], b[:, 14])
        out[:, 26] = np.maximum(map_off, 0)
        sx = np.where(plane > 0, s.ssx, 0)
        sy = np.where(plane > 0, s.ssy, 0)
        bw = np.array(T.BLOCK_W, np.int64)[b[:, 2]] >> sx
        out[:, 27] = np.where((plane > 0) & (bw < 4), bw + 2, bw)
        out[:, 28] = (b[:, 1] >> sx) * 4
        out[:, 29] = (b[:, 0] >> sy) * 4
    nsb = parsed.sb_rows * parsed.sb_cols
    sb_first = np.zeros(nsb, np.int64)
    sb_count = np.zeros(nsb, np.int64)
    if n:
        sbs = tx[:, 11]
        order = np.arange(n)
        first = np.full(nsb, n, np.int64)
        np.minimum.at(first, sbs, order)
        sb_first = np.where(first < n, first, 0)
        sb_count = np.bincount(sbs, minlength=nsb)
    lag = _wave_lag(parsed)
    if h.allow_intrabc:
        _check_intrabc(parsed, lag)
    rr, cc = np.divmod(np.arange(nsb), parsed.sb_cols)
    wave = cc + lag * rr
    waves = [np.nonzero(wave == w_)[0].astype(np.int32) for w_ in range(int(wave.max()) + 1)] if nsb else []
    edges = []
    for d in (0, 1):
        parts = []
        if h.lf_level[0] or h.lf_level[1]:
            for p in range(s.num_planes):
                if p and not h.lf_level[p + 1]:
                    continue
                e = av1_filters.edge_table(parsed, p, d)
                parts.append(np.concatenate([np.full((len(e), 1), p), e], 1))
        edges.append(np.concatenate(parts).astype(np.int32) if parts else np.zeros((0, 5), np.int32))
    fb_rows, fb_cols = (h.mi_rows + 15) // 16, (h.mi_cols + 15) // 16
    cdef_idx = np.ascontiguousarray(parsed.cdef_idx[:fb_rows, :fb_cols]).astype(np.int8)
    params = np.zeros(42, np.int64)
    params[0], params[1] = h.cdef_damping, bd - 8
    params[2:10] = av1_filters._UV_DIR[(s.ssx, s.ssy)]
    for i, arr in enumerate((h.cdef_y_pri, h.cdef_y_sec, h.cdef_uv_pri, h.cdef_uv_sec)):
        params[10 + 8 * i:10 + 8 * i + len(arr)] = arr
    rects = []
    for p in range(s.num_planes):
        if h.lr_type[p] == T.RESTORE_NONE:
            continue
        for x0, y0, w_, h_, ur, uc, s0, s1 in av1_filters.lr_rects(parsed, p):
            unit = parsed.lr[p].get((ur, uc))
            if unit is None or unit.kind == T.RESTORE_NONE:
                continue
            wv = unit.wiener
            rects.append((p, x0, y0, w_, h_, 1 if unit.kind == T.RESTORE_WIENER else 2, s0, s1, wv[0][0], wv[0][1],
                          wv[0][2], wv[1][0], wv[1][1], wv[1][2], unit.sgr_set, unit.sgr_xqd[0], unit.sgr_xqd[1]))
    dims = av1_recon.plane_dims(parsed)
    geom = []
    for p, (ph, pw) in enumerate(dims):
        sx, sy = (s.ssx, s.ssy) if p else (0, 0)
        geom.append((pw, ((h.mi_cols * 4) >> sx) - 1, ((h.mi_rows * 4) >> sy) - 1, ((h.width + sx) >> sx) - 1,
                     ((h.height + sy) >> sy) - 1))
    return Packed(parsed, out.astype(np.int32), sb_first.astype(np.int32), sb_count.astype(np.int32), waves,
                  parsed.coefs.astype(np.int32), parsed.palette.astype(np.int32), parsed.color_maps.astype(np.uint8),
                  edges, cdef_idx, parsed.skip.astype(np.uint8), params.astype(np.int32),
                  np.array(rects, np.int32).reshape(-1, len(LR_FIELDS)), np.array(geom, np.int32), dims)


@dataclass
class Staged:
    """A packed frame's tables as tensors on one device."""

    packed: Packed
    t: Dict[str, torch.Tensor]

    @property
    def device(self) -> torch.device:
        return self.t["txbs"].device


_INT_KEYS = ("txbs", "sb_first", "sb_count", "waves", "coefs", "palette", "edges0", "edges1", "cdef_params", "rects")


def stage(packed: Packed, device) -> Staged:
    """Copy every table to ``device`` in one transfer (through pinned memory,
    on the current stream, for a CUDA device)."""
    device = torch.device(device)
    arrays = {"txbs": packed.txbs, "sb_first": packed.sb_first, "sb_count": packed.sb_count,
              "waves": np.concatenate(packed.waves) if packed.waves else np.zeros(0, np.int32),
              "coefs": packed.coefs, "palette": packed.palette, "edges0": packed.edges[0], "edges1": packed.edges[1],
              "cdef_params": packed.cdef_params, "rects": packed.rects}
    ints = [np.ascontiguousarray(arrays[k], np.int32).reshape(-1) for k in _INT_KEYS]
    raw = [packed.maps, packed.cdef_idx.view(np.uint8).reshape(-1), packed.skip.reshape(-1)]
    host = torch.from_numpy(np.concatenate([np.concatenate(ints + [np.zeros(1, np.int32)]).view(np.uint8)] + raw
                                           + [np.zeros(8, np.uint8)]))
    if device.type == "cuda":
        pinned = torch.empty(host.shape, dtype=torch.uint8, pin_memory=True)
        pinned.copy_(host)
        buf = pinned.to(device, non_blocking=True)
    elif device.type == "cpu":
        buf = host
    else:
        raise ValueError(f"AV1 decodes on a CUDA device or the CPU, not {device}")
    t, pos = {}, 0
    for k, a in zip(_INT_KEYS, ints):
        t[k] = buf[pos:pos + a.size * 4].view(torch.int32)
        pos += a.size * 4
    pos += 4
    for k, a in zip(("maps", "cdef_idx", "skip"), raw):
        t[k] = buf[pos:pos + a.size]
        pos += a.size
    return Staged(packed, t)


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def _ptrs(planes: List[torch.Tensor]):
    return (ctypes.c_void_p * 3)(*[planes[min(i, len(planes) - 1)].data_ptr() for i in range(3)])


def _geom(p: Packed):
    g = p.geom.reshape(-1)
    return (ctypes.c_int * len(g))(*g.tolist())


def _check_planes(st: Staged, planes: List[torch.Tensor], what: str) -> None:
    for pl, d in zip(planes, st.packed.dims):
        if pl.dtype != torch.int32 or not pl.is_contiguous() or tuple(pl.shape) != d:
            raise ValueError(f"{what} takes contiguous int32 planes of the frame's layout")


def recon_ref(st: Staged) -> List[torch.Tensor]:
    """The plain reconstruction (``av1_recon.reconstruct``) -> int32 planes."""
    plain_calls["recon"] += 1
    return [torch.from_numpy(v).to(st.device) for v in av1_recon.reconstruct(st.packed.parsed)]


def recon(st: Staged) -> List[torch.Tensor]:
    """``av1_recon_kernel``, one launch per superblock wave, into zeroed
    planes; :func:`recon_ref` on the CPU."""
    if not _on_card(st.t["txbs"]):
        return recon_ref(st)
    p = st.packed
    s = p.parsed.frame.seq
    planes = [torch.zeros(d, dtype=torch.int32, device=st.device) for d in p.dims]
    lib = load_library()
    tables, offsets = device_tables(st.device)
    off = (ctypes.c_int * len(offsets))(*offsets.tolist())
    ptrs, geom = _ptrs(planes), _geom(p)
    pos = 0
    for wave in p.waves:
        err = lib.dspnet_av1_recon(ptrs, geom, len(planes), s.bit_depth, s.enable_intra_edge_filter, s.ssx, s.ssy,
                                   tables.data_ptr(), off, st.t["txbs"].data_ptr(), st.t["sb_first"].data_ptr(),
                                   st.t["sb_count"].data_ptr(), st.t["waves"].data_ptr(), pos, len(wave),
                                   st.t["coefs"].data_ptr(), st.t["palette"].data_ptr(), st.t["maps"].data_ptr(),
                                   _stream(st.device))
        launches["recon"] += 1
        _build.check(lib, err, "av1_recon_kernel")
        pos += len(wave)
    return planes


def deblock_ref(st: Staged, planes: List[torch.Tensor]) -> List[torch.Tensor]:
    plain_calls["deblock"] += 1
    out = av1_filters.deblock(st.packed.parsed, [v.cpu().numpy() for v in planes])
    return [torch.from_numpy(v.astype(np.int32)).to(planes[0].device) for v in out]


def deblock(st: Staged, planes: List[torch.Tensor]) -> List[torch.Tensor]:
    """``av1_deblock_kernel``, one launch per direction over all planes, on
    copies of ``planes``; :func:`deblock_ref` on the CPU."""
    if not _on_card(planes[0]):
        return deblock_ref(st, planes)
    _check_planes(st, planes, "deblock")
    p = st.packed
    s, h = p.parsed.frame.seq, p.parsed.frame.hdr
    out = [v.clone() for v in planes]
    lib = load_library()
    ptrs, geom = _ptrs(out), _geom(p)
    for d in (0, 1):
        n = len(p.edges[d])
        if not n:
            continue
        err = lib.dspnet_av1_deblock(ptrs, geom, len(out), s.bit_depth, st.t[f"edges{d}"].data_ptr(), n, d,
                                     h.lf_sharpness, _stream(st.device))
        launches["deblock"] += 1
        _build.check(lib, err, "av1_deblock_kernel")
    return out


def cdef_ref(st: Staged, planes: List[torch.Tensor]) -> List[torch.Tensor]:
    plain_calls["cdef"] += 1
    out = av1_filters.cdef(st.packed.parsed, [v.cpu().numpy() for v in planes])
    return [torch.from_numpy(v.astype(np.int32)).to(planes[0].device) for v in out]


def _cdef_on(p: Packed) -> bool:
    s, h = p.parsed.frame.seq, p.parsed.frame.hdr
    return bool(s.enable_cdef and not h.coded_lossless and not h.allow_intrabc)


def cdef(st: Staged, planes: List[torch.Tensor]) -> List[torch.Tensor]:
    """``av1_cdef_kernel``, one launch over every 64x64 block, into copies
    of ``planes``; :func:`cdef_ref` on the CPU."""
    if not _on_card(planes[0]):
        return cdef_ref(st, planes)
    _check_planes(st, planes, "cdef")
    p = st.packed
    s, h = p.parsed.frame.seq, p.parsed.frame.hdr
    out = [v.clone() for v in planes]
    if not _cdef_on(p):
        return out
    lib = load_library()
    prm = (ctypes.c_int * 42)(*p.cdef_params.tolist())
    fb_rows, fb_cols = p.cdef_idx.shape
    err = lib.dspnet_av1_cdef(_ptrs(planes), _ptrs(out), _geom(p), len(out), s.bit_depth, s.ssx, s.ssy,
                              st.t["cdef_idx"].data_ptr(), fb_cols, st.t["skip"].data_ptr(), h.mi_rows, h.mi_cols,
                              fb_rows, fb_cols, prm, _stream(st.device))
    launches["cdef"] += 1
    _build.check(lib, err, "av1_cdef_kernel")
    return out


def loop_restore_ref(st: Staged, deblocked: List[torch.Tensor], cdefed: List[torch.Tensor]) -> List[torch.Tensor]:
    plain_calls["lr"] += 1
    out = av1_filters.loop_restore(st.packed.parsed, [v.cpu().numpy() for v in deblocked],
                                   [v.cpu().numpy() for v in cdefed])
    return [torch.from_numpy(v.astype(np.int32)).to(cdefed[0].device) for v in out]


@functools.lru_cache(maxsize=8)
def _lr_tables(device: torch.device) -> tuple:
    sgr = torch.from_numpy(T.table("sgr_params").astype(np.int32).reshape(-1)).to(device)
    xb = torch.from_numpy(T.x_by_xplus1().astype(np.int32)).to(device)
    ob = torch.from_numpy(T.one_by_x().astype(np.int32)).to(device)
    return sgr, xb, ob


def loop_restore(st: Staged, deblocked: List[torch.Tensor], cdefed: List[torch.Tensor]) -> List[torch.Tensor]:
    """``av1_lr_kernel``, one launch over every restoration rectangle, into
    copies of ``cdefed``; :func:`loop_restore_ref` on the CPU."""
    if not _on_card(cdefed[0]):
        return loop_restore_ref(st, deblocked, cdefed)
    _check_planes(st, deblocked, "loop_restore")
    _check_planes(st, cdefed, "loop_restore")
    p = st.packed
    s = p.parsed.frame.seq
    out = [v.clone() for v in cdefed]
    n = len(p.rects)
    if not n:
        return out
    lib = load_library()
    sgr, xb, ob = _lr_tables(st.device)
    err = lib.dspnet_av1_lr(_ptrs(deblocked), _ptrs(cdefed), _ptrs(out), _geom(p), len(out), s.bit_depth,
                            st.t["rects"].data_ptr(), n, sgr.data_ptr(), xb.data_ptr(), ob.data_ptr(),
                            _stream(st.device))
    launches["lr"] += 1
    _build.check(lib, err, "av1_lr_kernel")
    return out


def decode_frame(frame, device) -> List[torch.Tensor]:
    """One AV1 frame: the host parse, the four kernels (plain versions on
    the CPU), then film grain -> planes on ``device`` cut to the frame."""
    st = stage(pack(av1_parse.parse(frame)), device)
    rec = recon(st)
    deb = deblock(st, rec)
    cd = cdef(st, deb)
    lr = loop_restore(st, deb, cd)
    return avif.finish(frame, lr)


def decode(data, flags: int = avif.IMREAD_COLOR, device="cuda") -> torch.Tensor:
    """AVIF bytes -> ``cv2.imdecode``'s array under ``flags`` as a tensor on
    ``device``: the kernels on a CUDA device, their plain versions on the
    CPU. Returns when the kernels have finished."""
    device = torch.device(device)
    if flags not in (avif.IMREAD_COLOR, avif.IMREAD_GRAYSCALE, avif.IMREAD_UNCHANGED):
        raise ValueError(f"flags must be IMREAD_COLOR, IMREAD_GRAYSCALE or IMREAD_UNCHANGED, got {flags}")
    p = avif.plan(bytes(data))
    color = avif.assemble(p, p.color, [decode_frame(c.frame, device) for c in p.color])
    alpha = None
    if p.alpha and (flags == avif.IMREAD_UNCHANGED or p.premultiplied) and not p.mono:
        alpha = avif.assemble(p, p.alpha, [decode_frame(c.frame, device) for c in p.alpha])
    out = avif.to_output(p, color, alpha, flags)
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return out
