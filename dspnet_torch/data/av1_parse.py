"""The block syntax of an AV1 key or intra-only frame (sections 5.11 and
6.10 of the AV1 specification), decoded tile by tile on the host.

:func:`parse` walks every superblock's partition tree and reads each
block's mode info (segment id, skip, CDEF index, delta q / lf, IntraBC with
its reference-MV stack, the luma and chroma modes, angle deltas, CfL alphas,
palettes with the colour cache and their colour maps, filter intra), its
transform sizes and every transform block's coefficients, with the above /
left contexts of the specification. Nothing here touches a sample: the
prediction, the inverse transforms and the loop filters read the tables it
returns (:class:`Parsed`), in the decode order, from ``data/av1_recon.py``,
``data/av1_filters.py`` or the card's kernels (``data/av1_cuda.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from dspnet_torch.data import av1_tables as T
from dspnet_torch.data.av1_obu import SEG_LVL_SKIP, Av1Error, Frame
from dspnet_torch.data.av1_symbol import SymbolDecoder

#: columns of :attr:`Parsed.txbs` (one row per transform block or IntraBC
#: prediction, in decode order)
TXB_FIELDS = ("kind", "plane", "x", "y", "tx_size", "tx_type", "eob", "coef", "block", "mode", "flags", "sb",
              "filter_type", "qidx", "w", "h")
#: kinds of a txbs row
KIND_INTRA, KIND_RESIDUAL, KIND_INTRABC = 0, 1, 2
#: flags bits of a txbs row
F_LEFT, F_ABOVE, F_ABOVE_RIGHT, F_BELOW_LEFT, F_CFL, F_PALETTE, F_FILTER_INTRA, F_LOSSLESS = (1 << i for i in range(8))
#: columns of :attr:`Parsed.blocks`
BLOCK_FIELDS = ("mi_row", "mi_col", "bsize", "y_mode", "uv_mode", "angle_y", "angle_uv", "filter_mode",
                "cfl_u", "cfl_v", "pal_y", "pal_uv", "pal_off", "map_y", "map_uv", "mv_row", "mv_col",
                "max_luma_w", "max_luma_h", "segment", "skip", "intrabc")

_PALETTE_COLOR_CONTEXT = (-1, -1, 0, -1, -1, 4, 3, 2, 1)
_SIG_REF = (((0, 1), (1, 0), (1, 1), (0, 2), (2, 0)), ((0, 1), (1, 0), (0, 2), (0, 3), (0, 4)),
            ((0, 1), (1, 0), (2, 0), (3, 0), (4, 0)))
_MAG_REF = (((0, 1), (1, 0), (1, 1)), ((0, 1), (1, 0), (0, 2)), ((0, 1), (1, 0), (2, 0)))
TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2


def tx_class(tx_type: int) -> int:
    if tx_type in (T.V_DCT, T.V_ADST, T.V_FLIPADST):
        return TX_CLASS_VERT
    if tx_type in (T.H_DCT, T.H_ADST, T.H_FLIPADST):
        return TX_CLASS_HORIZ
    return TX_CLASS_2D


def adjusted_tx_size(t: int) -> int:
    return T.tx_size_of(min(T.TX_W[t], 32), min(T.TX_H[t], 32))


def plane_residual_size(bsize: int, ssx: int, ssy: int) -> int:
    """``get_plane_residual_size`` (``Subsampled_Size``)."""
    w, h = T.BLOCK_W[bsize] >> ssx, T.BLOCK_H[bsize] >> ssy
    return T.block_size(max(w, 4), max(h, 4))


def uv_tx_size(bsize: int, ssx: int, ssy: int) -> int:
    uv = T.MAX_TX_SIZE_RECT[plane_residual_size(bsize, ssx, ssy)]
    if T.TX_W[uv] == 64 or T.TX_H[uv] == 64:
        if T.TX_W[uv] == 16:
            return T.TX_16X32
        if T.TX_H[uv] == 16:
            return T.TX_32X16
        return T.TX_32X32
    return uv


def _ext_tx_set(tx_size: int, inter: bool, reduced: bool) -> int:
    sqr_up = T.TX_SQR_UP[tx_size]
    if sqr_up > T.TX_32X32:
        return T.EXT_TX_SET_DCTONLY
    if sqr_up == T.TX_32X32:
        return T.EXT_TX_SET_DCT_IDTX if inter else T.EXT_TX_SET_DCTONLY
    if reduced:
        return T.EXT_TX_SET_DCT_IDTX if inter else T.EXT_TX_SET_DTT4_IDTX
    sqr = T.TX_SQR[tx_size]
    if inter:
        return T.EXT_TX_SET_DTT9_IDTX_1DDCT if sqr == T.TX_16X16 else T.EXT_TX_SET_ALL16
    return T.EXT_TX_SET_DTT4_IDTX if sqr == T.TX_16X16 else T.EXT_TX_SET_DTT4_IDTX_1DDCT


_EXT_TX_SET_INDEX = ((0, -1, 2, 1, -1, -1), (0, 3, -1, -1, 2, 1))


@dataclass
class LrUnit:
    kind: int = T.RESTORE_NONE
    wiener: List[List[int]] = field(default_factory=lambda: [[0, 0, 0], [0, 0, 0]])
    sgr_set: int = 0
    sgr_xqd: List[int] = field(default_factory=lambda: [0, 0])


@dataclass
class Parsed:
    frame: Frame
    blocks: np.ndarray  # int32 (n, BLOCK_FIELDS)
    txbs: np.ndarray  # int32 (m, TXB_FIELDS)
    coefs: np.ndarray  # int32: each transform block's coefficients in scan order (eob of them)
    palette: np.ndarray  # int32: each palette block's colours (y, u, v; 8 each)
    color_maps: np.ndarray  # uint8: each palette block's colour maps (y then uv)
    tx_size_map: List[np.ndarray]  # per plane, int8 at 4x4 units: LoopfilterTxSizes
    mi_size: np.ndarray  # int8 (mi_rows, mi_cols)
    skip_inter: np.ndarray  # bool (mi_rows, mi_cols): skip && is_inter
    segment: np.ndarray  # int8 (mi_rows, mi_cols)
    delta_lf: np.ndarray  # int8 (mi_rows, mi_cols, 4)
    skip: np.ndarray  # bool (mi_rows, mi_cols)
    cdef_idx: np.ndarray  # int8 (mi_rows // 16 + 1, mi_cols // 16 + 1): -1 where every block skips
    lr: List[dict]  # per plane {(unit row, unit col): LrUnit}
    lr_units: List[tuple]  # per plane (rows, cols)
    sb_rows: int
    sb_cols: int


class _Parser:
    def __init__(self, frame: Frame):
        self.f = frame
        s, h = frame.seq, frame.hdr
        self.s, self.h = s, h
        self.mi_rows, self.mi_cols = h.mi_rows, h.mi_cols
        self.ssx, self.ssy = s.ssx, s.ssy
        self.planes = s.num_planes
        self.bd = s.bit_depth
        self.sb128 = s.sb128
        self.sb_size = T.BLOCK_128X128 if s.sb128 else T.BLOCK_64X64
        self.sb4 = 32 if s.sb128 else 16
        R, C = self.mi_rows, self.mi_cols
        self.mi_size = [[0] * C for _ in range(R)]
        self.y_modes = [[0] * C for _ in range(R)]
        self.uv_modes = [[0] * C for _ in range(R)]
        self.is_inter = [[0] * C for _ in range(R)]
        self.skips = [[0] * C for _ in range(R)]
        self.seg_ids = [[0] * C for _ in range(R)]
        self.inter_tx = [[0] * C for _ in range(R)]
        self.pal_sizes = [[[0] * C for _ in range(R)] for _ in range(2)]
        self.pal_colors = [[[None] * C for _ in range(R)] for _ in range(2)]
        self.mvs = [[None] * C for _ in range(R)]
        self.decoded = [[0] * C for _ in range(R)]
        self.delta_lfs = [[None] * C for _ in range(R)]
        self.tx_types = {}  # (row4, col4) -> luma tx type
        self.lf_tx = [np.zeros(((R >> (p and self.ssy)) + 32, (C >> (p and self.ssx)) + 32), np.int8)
                      for p in range(self.planes)]
        self.cdef = np.full(((R + 15) // 16 + 2, (C + 15) // 16 + 2), -1, np.int8)
        self.blocks, self.txbs, self.coefs = [], [], []
        self.coef_pos = 0
        self.palette, self.maps, self.map_pos = [], [], 0
        self.lr = [dict() for _ in range(3)]
        self.lr_units = []
        for p in range(3):
            if p < self.planes and h.lr_type[p] != T.RESTORE_NONE:
                sx, sy = (self.ssx, self.ssy) if p else (0, 0)
                size = h.lr_unit_size[p]
                rows = max(((h.height + sy) >> sy) + (size >> 1), size) // size
                cols = max(((h.width + sx) >> sx) + (size >> 1), size) // size
                self.lr_units.append((max(rows, 1), max(cols, 1)))
            else:
                self.lr_units.append((0, 0))
        self.sb_index = 0

    # -- tiles --------------------------------------------------------------
    def run(self) -> Parsed:
        h = self.h
        sb_cols = (self.mi_cols + self.sb4 - 1) // self.sb4
        sb_rows = (self.mi_rows + self.sb4 - 1) // self.sb4
        self.sb_cols = sb_cols
        for trow, tcol, data in self.f.tiles:
            self.decode_tile(trow, tcol, data)
        R, C = self.mi_rows, self.mi_cols
        arr = lambda grid, dt: np.array(grid, dt).reshape(R, C)
        dlf = np.array([[v if v is not None else (0, 0, 0, 0) for v in row] for row in self.delta_lfs], np.int8)
        skip_inter = np.array(self.skips, bool) & np.array(self.is_inter, bool)
        blocks = np.array(self.blocks, np.int32).reshape(-1, len(BLOCK_FIELDS))
        txbs = np.array(self.txbs, np.int32).reshape(-1, len(TXB_FIELDS))
        coefs = np.concatenate(self.coefs).astype(np.int32) if self.coefs else np.zeros(0, np.int32)
        pal = np.array(self.palette, np.int32).reshape(-1) if self.palette else np.zeros(0, np.int32)
        maps = np.concatenate(self.maps).astype(np.uint8) if self.maps else np.zeros(0, np.uint8)
        return Parsed(self.f, blocks, txbs, coefs, pal, maps, self.lf_tx, arr(self.mi_size, np.int8), skip_inter,
                      arr(self.seg_ids, np.int8), dlf.reshape(R, C, 4),
                      arr(self.skips, bool), self.cdef, self.lr, self.lr_units, sb_rows, sb_cols)

    def decode_tile(self, trow: int, tcol: int, data: bytes) -> None:
        h = self.h
        self.row_start, self.row_end = h.mi_row_starts[trow], h.mi_row_starts[trow + 1]
        self.col_start, self.col_end = h.mi_col_starts[tcol], h.mi_col_starts[tcol + 1]
        self.sd = SymbolDecoder(data, bool(h.disable_cdf_update))
        self.cdf = {k: v.tolist() for k, v in T.default_cdfs(h.base_q_idx).items()}
        n = (self.mi_cols + 32) * 2
        self.above_level = [[0] * n for _ in range(3)]
        self.above_dc = [[0] * n for _ in range(3)]
        self.delta_lf = [0, 0, 0, 0]
        self.ref_sgr = [[-32, 31] for _ in range(3)]
        self.ref_wiener = [[[3, -7, 15], [3, -7, 15]] for _ in range(3)]
        self.current_q = h.base_q_idx
        for r in range(self.row_start, self.row_end, self.sb4):
            m = (self.mi_rows + 64) * 2
            self.left_level = [[0] * m for _ in range(3)]
            self.left_dc = [[0] * m for _ in range(3)]
            for c in range(self.col_start, self.col_end, self.sb4):
                self.read_deltas = h.delta_q_present
                self.sb_r, self.sb_c = r, c
                self.clear_block_decoded(r, c)
                self.read_lr(r, c)
                self.sb_index = (r // self.sb4) * self.sb_cols + c // self.sb4
                self.decode_partition(r, c, self.sb_size)
        if not self.sd.padding_ok():
            raise Av1Error("AV1 tile data overrun")

    def inside(self, r: int, c: int) -> bool:
        return self.col_start <= c < self.col_end and self.row_start <= r < self.row_end

    def clear_block_decoded(self, r: int, c: int) -> None:
        # BlockDecoded[plane][y][x] for y, x in -1 .. sb4 (offset by 1)
        sb4 = self.sb4
        self.block_decoded = []
        for p in range(self.planes):
            sx, sy = (self.ssx, self.ssy) if p else (0, 0)
            w4 = (self.col_end - c) >> sx
            h4 = (self.row_end - r) >> sy
            n = (sb4 >> min(sx, sy)) + 3
            g = [[0] * (n + 2) for _ in range(n + 2)]
            for y in range(-1, (sb4 >> sy) + 1):
                for x in range(-1, (sb4 >> sx) + 1):
                    if y < 0 and x < w4:
                        g[y + 1][x + 1] = 1
                    elif x < 0 and y < h4:
                        g[y + 1][x + 1] = 1
            g[(sb4 >> sy) + 1][0] = 0
            self.block_decoded.append(g)

    # -- loop restoration units ---------------------------------------------
    def read_lr(self, r: int, c: int) -> None:
        h = self.h
        if h.allow_intrabc:
            return
        w = h4 = self.sb4
        for p in range(self.planes):
            if h.lr_type[p] == T.RESTORE_NONE:
                continue
            sx, sy = (self.ssx, self.ssy) if p else (0, 0)
            size = h.lr_unit_size[p]
            rows, cols = self.lr_units[p]
            r0 = (r * (4 >> sy) + size - 1) // size
            r1 = min(rows, ((r + h4) * (4 >> sy) + size - 1) // size)
            c0 = (c * (4 >> sx) + size - 1) // size
            c1 = min(cols, ((c + w) * (4 >> sx) + size - 1) // size)
            for ur in range(r0, r1):
                for uc in range(c0, c1):
                    self.read_lr_unit(p, ur, uc)

    def read_lr_unit(self, p: int, ur: int, uc: int) -> None:
        sd, cdf, kind = self.sd, self.cdf, self.h.lr_type[p]
        if kind == T.RESTORE_WIENER:
            t = T.RESTORE_WIENER if sd.symbol(cdf["wiener_restore"], 2) else T.RESTORE_NONE
        elif kind == T.RESTORE_SGRPROJ:
            t = T.RESTORE_SGRPROJ if sd.symbol(cdf["sgrproj_restore"], 2) else T.RESTORE_NONE
        else:
            t = sd.symbol(cdf["switchable_restore"], 3)
        unit = LrUnit(t)
        if t == T.RESTORE_WIENER:
            for pas in range(2):
                first = 1 if p else 0
                for j in range(first, 3):
                    v = self.subexp_ref(T.WIENER_TAPS_MIN[j], T.WIENER_TAPS_MAX[j] + 1, T.WIENER_TAPS_K[j],
                                        self.ref_wiener[p][pas][j])
                    unit.wiener[pas][j] = v
                    self.ref_wiener[p][pas][j] = v
        elif t == T.RESTORE_SGRPROJ:
            s = sd.literal(T.SGRPROJ_PARAMS_BITS)
            unit.sgr_set = s
            params = T.table("sgr_params")[s]
            for i in range(2):
                lo, hi = T.SGRPROJ_XQD_MIN[i], T.SGRPROJ_XQD_MAX[i]
                if params[i]:
                    v = self.subexp_ref(lo, hi + 1, T.SGRPROJ_PRJ_SUBEXP_K, self.ref_sgr[p][i])
                else:
                    v = 0
                    if i == 1:
                        v = min(hi, max(lo, (1 << T.SGRPROJ_PRJ_BITS) - self.ref_sgr[p][0]))
                unit.sgr_xqd[i] = v
                self.ref_sgr[p][i] = v
        self.lr[p][(ur, uc)] = unit

    def subexp_ref(self, low: int, high: int, k: int, ref: int) -> int:
        mx, r = high - low, ref - low
        v = self.subexp(mx, k)
        if (r << 1) <= mx:
            x = _inverse_recenter(r, v)
        else:
            x = mx - 1 - _inverse_recenter(mx - 1 - r, v)
        return x + low

    def subexp(self, num: int, k: int) -> int:
        i = mk = 0
        while True:
            b2 = k + i - 1 if i else k
            a = 1 << b2
            if num <= mk + 3 * a:
                return self.sd.ns(num - mk) + mk
            if self.sd.literal(1):
                i += 1
                mk += a
            else:
                return self.sd.literal(b2) + mk

    # -- partitions -----------------------------------------------------------
    def decode_partition(self, r: int, c: int, bsize: int) -> None:
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        n4 = 1 << T.MI_WIDTH_LOG2[bsize]
        half = n4 >> 1
        quarter = half >> 1
        has_rows = (r + half) < self.mi_rows
        has_cols = (c + half) < self.mi_cols
        if bsize == self.sb_size:
            self.clear_cdef(r, c)
        if bsize < T.BLOCK_8X8:
            part = T.PARTITION_NONE
        else:
            bsl = T.MI_WIDTH_LOG2[bsize]
            above = self.inside(r - 1, c) and T.MI_WIDTH_LOG2[self.mi_size[r - 1][c]] < bsl
            left = self.inside(r, c - 1) and T.MI_HEIGHT_LOG2[self.mi_size[r][c - 1]] < bsl
            ctx = (bsl - 1) * 4 + left * 2 + above
            cdf = self.cdf["partition"][ctx]
            nsym = 4 if bsize == T.BLOCK_8X8 else 8 if bsize == T.BLOCK_128X128 else 10
            if has_rows and has_cols:
                part = self.sd.symbol(cdf, nsym)
            elif has_cols:
                p = 32768
                for e in (T.PARTITION_VERT, T.PARTITION_SPLIT, T.PARTITION_HORZ_A, T.PARTITION_VERT_A,
                          T.PARTITION_VERT_B) + ((T.PARTITION_VERT_4,) if bsize != T.BLOCK_128X128 else ()):
                    p -= (cdf[e - 1] if e > 0 else 32768) - cdf[e]
                part = T.PARTITION_SPLIT if self.sd.symbol([32768 - p, 0, 0], 2) else T.PARTITION_HORZ
            elif has_rows:
                p = 32768
                for e in (T.PARTITION_HORZ, T.PARTITION_SPLIT, T.PARTITION_HORZ_A, T.PARTITION_HORZ_B,
                          T.PARTITION_VERT_A) + ((T.PARTITION_HORZ_4,) if bsize != T.BLOCK_128X128 else ()):
                    p -= (cdf[e - 1] if e > 0 else 32768) - cdf[e]
                part = T.PARTITION_SPLIT if self.sd.symbol([32768 - p, 0, 0], 2) else T.PARTITION_VERT
            else:
                part = T.PARTITION_SPLIT
        sub = T.subsize(part, bsize)
        split = T.subsize(T.PARTITION_SPLIT, bsize)
        db = self.decode_block
        if part == T.PARTITION_NONE:
            db(r, c, sub)
        elif part == T.PARTITION_HORZ:
            db(r, c, sub)
            if has_rows:
                db(r + half, c, sub)
        elif part == T.PARTITION_VERT:
            db(r, c, sub)
            if has_cols:
                db(r, c + half, sub)
        elif part == T.PARTITION_SPLIT:
            self.decode_partition(r, c, sub)
            self.decode_partition(r, c + half, sub)
            self.decode_partition(r + half, c, sub)
            self.decode_partition(r + half, c + half, sub)
        elif part == T.PARTITION_HORZ_A:
            db(r, c, split)
            db(r, c + half, split)
            db(r + half, c, sub)
        elif part == T.PARTITION_HORZ_B:
            db(r, c, sub)
            db(r + half, c, split)
            db(r + half, c + half, split)
        elif part == T.PARTITION_VERT_A:
            db(r, c, split)
            db(r + half, c, split)
            db(r, c + half, sub)
        elif part == T.PARTITION_VERT_B:
            db(r, c, sub)
            db(r, c + half, split)
            db(r + half, c + half, split)
        elif part == T.PARTITION_HORZ_4:
            for i in range(4):
                if i == 0 or r + quarter * i < self.mi_rows:
                    db(r + quarter * i, c, sub)
        else:
            for i in range(4):
                if i == 0 or c + quarter * i < self.mi_cols:
                    db(r, c + quarter * i, sub)

    def clear_cdef(self, r: int, c: int) -> None:
        self.cdef[r >> 4, c >> 4] = -1
        if self.sb128:
            self.cdef[r >> 4, (c >> 4) + 1] = -1
            self.cdef[(r >> 4) + 1, c >> 4] = -1
            self.cdef[(r >> 4) + 1, (c >> 4) + 1] = -1

    # -- blocks ---------------------------------------------------------------
    def decode_block(self, r: int, c: int, bsize: int) -> None:
        h, s = self.h, self.s
        self.r, self.c, self.bsize = r, c, bsize
        bw4, bh4 = 1 << T.MI_WIDTH_LOG2[bsize], 1 << T.MI_HEIGHT_LOG2[bsize]
        if bh4 == 1 and self.ssy and not (r & 1):
            has_chroma = False
        elif bw4 == 1 and self.ssx and not (c & 1):
            has_chroma = False
        else:
            has_chroma = self.planes > 1
        self.has_chroma = has_chroma
        self.avail_u = self.inside(r - 1, c)
        self.avail_l = self.inside(r, c - 1)
        self.avail_u_chroma, self.avail_l_chroma = self.avail_u, self.avail_l
        if has_chroma:
            if self.ssy and bh4 == 1:
                self.avail_u_chroma = self.inside(r - 2, c)
            if self.ssx and bw4 == 1:
                self.avail_l_chroma = self.inside(r, c - 2)
        else:
            self.avail_u_chroma = self.avail_l_chroma = False
        b = self.mode_info()
        self.palette_tokens(b)
        self.read_block_tx_size(b)
        if b["skip"]:
            self.reset_block_context(bw4, bh4)
        rows = range(r, min(r + bh4, self.mi_rows))
        cols = range(c, min(c + bw4, self.mi_cols))
        dlf = tuple(self.delta_lf)
        for y in rows:
            for x in cols:
                self.y_modes[y][x] = b["y_mode"]
                self.uv_modes[y][x] = b["uv_mode"]
                self.is_inter[y][x] = b["intrabc"]
                self.skips[y][x] = b["skip"]
                self.mi_size[y][x] = bsize
                self.seg_ids[y][x] = b["segment"]
                self.pal_sizes[0][y][x] = b["pal_y"]
                self.pal_sizes[1][y][x] = b["pal_uv"]
                self.pal_colors[0][y][x] = b["colors"][0]
                self.pal_colors[1][y][x] = b["colors"][1]
                self.mvs[y][x] = b["mv"]
                self.decoded[y][x] = 1
                self.delta_lfs[y][x] = dlf
        self.block_index = len(self.blocks)
        self.residual(b)
        pal_off = -1
        if b["pal_y"] or b["pal_uv"]:
            pal_off = len(self.palette) // 24
            for k in range(3):
                cols_ = list(b["colors"][k] or [])
                self.palette.extend(cols_ + [0] * (8 - len(cols_)))
        self.blocks.append((r, c, bsize, b["y_mode"], b["uv_mode"], b["angle_y"], b["angle_uv"],
                            b["filter_mode"] if b["use_filter"] else -1, b["cfl_u"], b["cfl_v"], b["pal_y"],
                            b["pal_uv"], pal_off, b["map_y"], b["map_uv"], b["mv"][0], b["mv"][1],
                            b["max_luma_w"], b["max_luma_h"], b["segment"], b["skip"], b["intrabc"]))

    def mode_info(self) -> dict:
        h, sd, cdf = self.h, self.sd, self.cdf
        r, c, bsize = self.r, self.c, self.bsize
        b = dict(segment=0, skip=0, y_mode=T.DC_PRED, uv_mode=T.DC_PRED, angle_y=0, angle_uv=0, use_filter=0,
                 filter_mode=0, cfl_u=0, cfl_v=0, pal_y=0, pal_uv=0, colors=[None, None, None], map_y=-1,
                 map_uv=-1, mv=(0, 0), intrabc=0, max_luma_w=0, max_luma_h=0)
        if h.seg_id_pre_skip:
            b["segment"] = self.read_segment_id(0)
        if h.seg_id_pre_skip and h.seg_enabled and h.feature_enabled[b["segment"]][SEG_LVL_SKIP]:
            b["skip"] = 1
        else:
            ctx = (self.skips[r - 1][c] if self.avail_u else 0) + (self.skips[r][c - 1] if self.avail_l else 0)
            b["skip"] = sd.symbol(cdf["skip"][ctx], 2)
        if not h.seg_id_pre_skip:
            b["segment"] = self.read_segment_id(b["skip"])
        self.lossless = h.lossless[b["segment"]]
        # read_cdef
        if not (b["skip"] or h.coded_lossless or not self.s.enable_cdef or h.allow_intrabc):
            cr, cc = r >> 4, c >> 4
            if self.cdef[cr, cc] == -1:
                v = sd.literal(h.cdef_bits)
                w4, h4 = 1 << T.MI_WIDTH_LOG2[bsize], 1 << T.MI_HEIGHT_LOG2[bsize]
                for y in range(r & ~15, (r & ~15) + h4, 16):
                    for x in range(c & ~15, (c & ~15) + w4, 16):
                        self.cdef[y >> 4, x >> 4] = v
        # delta q / lf
        if self.read_deltas and not (bsize == self.sb_size and b["skip"]):
            a = sd.symbol(cdf["delta_q"], 4)
            if a == 3:
                n = sd.literal(3) + 1
                a = sd.literal(n) + (1 << n) + 1
            if a:
                v = -a if sd.literal(1) else a
                self.current_q = max(1, min(255, self.current_q + (v << h.delta_q_res)))
            if h.delta_lf_present:
                count = (4 if self.planes > 1 else 2) if h.delta_lf_multi else 1
                for i in range(count):
                    a = sd.symbol(cdf["delta_lf_multi"][i] if h.delta_lf_multi else cdf["delta_lf"], 4)
                    if a == 3:
                        n = sd.literal(3) + 1
                        a = sd.literal(n) + (1 << n) + 1
                    if a:
                        v = -a if sd.literal(1) else a
                        self.delta_lf[i] = max(-63, min(63, self.delta_lf[i] + (v << h.delta_lf_res)))
        self.read_deltas = 0
        b["intrabc"] = sd.symbol(cdf["intrabc"], 2) if h.allow_intrabc else 0
        if b["intrabc"]:
            b["mv"] = self.read_intrabc()
            return b
        above = self.y_modes[r - 1][c] if self.avail_u else T.DC_PRED
        left = self.y_modes[r][c - 1] if self.avail_l else T.DC_PRED
        ym = sd.symbol(cdf["kf_y_mode"][T.INTRA_MODE_CONTEXT[above]][T.INTRA_MODE_CONTEXT[left]], 13)
        b["y_mode"] = ym
        if bsize >= T.BLOCK_8X8 and T.V_PRED <= ym <= T.D67_PRED:
            b["angle_y"] = sd.symbol(cdf["angle_delta"][ym - T.V_PRED], 7) - 3
        if self.has_chroma:
            if self.lossless and plane_residual_size(bsize, self.ssx, self.ssy) == T.BLOCK_4X4:
                cfl_allowed = 1
            elif not self.lossless and max(T.BLOCK_W[bsize], T.BLOCK_H[bsize]) <= 32:
                cfl_allowed = 1
            else:
                cfl_allowed = 0
            uvm = sd.symbol(cdf["uv_mode"][cfl_allowed][ym], 14 if cfl_allowed else 13)
            b["uv_mode"] = uvm
            if uvm == T.UV_CFL_PRED:
                signs = sd.symbol(cdf["cfl_sign"], 8)
                su, sv = (signs + 1) // 3, (signs + 1) % 3
                if su:
                    a = 1 + sd.symbol(cdf["cfl_alpha"][(su - 1) * 3 + sv], 16)
                    b["cfl_u"] = -a if su == 1 else a
                if sv:
                    a = 1 + sd.symbol(cdf["cfl_alpha"][(sv - 1) * 3 + su], 16)
                    b["cfl_v"] = -a if sv == 1 else a
            if bsize >= T.BLOCK_8X8 and T.V_PRED <= uvm <= T.D67_PRED:
                b["angle_uv"] = sd.symbol(cdf["angle_delta"][uvm - T.V_PRED], 7) - 3
        if (bsize >= T.BLOCK_8X8 and T.BLOCK_W[bsize] <= 64 and T.BLOCK_H[bsize] <= 64
                and h.allow_screen_content_tools):
            self.palette_mode_info(b)
        if (self.s.enable_filter_intra and ym == T.DC_PRED and b["pal_y"] == 0
                and max(T.BLOCK_W[bsize], T.BLOCK_H[bsize]) <= 32):
            b["use_filter"] = sd.symbol(cdf["filter_intra"][bsize], 2)
            if b["use_filter"]:
                b["filter_mode"] = sd.symbol(cdf["filter_intra_mode"], 5)
        return b

    def read_segment_id(self, skip: int) -> int:
        h = self.h
        if not h.seg_enabled:
            return 0
        r, c = self.r, self.c
        ul = self.seg_ids[r - 1][c - 1] if (self.avail_u and self.avail_l) else -1
        u = self.seg_ids[r - 1][c] if self.avail_u else -1
        lf = self.seg_ids[r][c - 1] if self.avail_l else -1
        if u == -1:
            pred = 0 if lf == -1 else lf
        elif lf == -1:
            pred = u
        else:
            pred = u if ul == u else lf
        if skip:
            return pred
        if ul < 0:
            ctx = 0
        elif ul == u and ul == lf:
            ctx = 2
        elif ul == u or ul == lf or u == lf:
            ctx = 1
        else:
            ctx = 0
        v = self.sd.symbol(self.cdf["seg_spatial"][ctx], 8)
        v = _neg_deinterleave(v, pred, h.last_active_seg_id + 1)
        if v < 0 or v > h.last_active_seg_id:
            raise Av1Error("AV1 segment id past the last active segment")
        return v

    # -- palettes -------------------------------------------------------------
    def palette_mode_info(self, b: dict) -> None:
        sd, cdf, bd = self.sd, self.cdf, self.bd
        r, c, bsize = self.r, self.c, self.bsize
        bctx = T.MI_WIDTH_LOG2[bsize] + T.MI_HEIGHT_LOG2[bsize] - 2
        if b["y_mode"] == T.DC_PRED:
            ctx = (self.avail_u and self.pal_sizes[0][r - 1][c] > 0) + (self.avail_l and self.pal_sizes[0][r][c - 1] > 0)
            if sd.symbol(cdf["palette_y_mode"][bctx][ctx], 2):
                n = sd.symbol(cdf["palette_y_size"][bctx], 7) + 2
                cache = self.palette_cache(0)
                colors = []
                for v in cache:
                    if len(colors) >= n:
                        break
                    if sd.literal(1):
                        colors.append(v)
                if len(colors) < n:
                    colors.append(sd.literal(bd))
                if len(colors) < n:
                    bits = bd - 3 + sd.literal(2)
                    while len(colors) < n:
                        d = sd.literal(bits) + 1
                        v = min((1 << bd) - 1, colors[-1] + d)
                        colors.append(v)
                        rng = (1 << bd) - v - 1
                        bits = min(bits, _ceil_log2(rng))
                b["pal_y"] = n
                b["colors"][0] = sorted(colors)
        if self.has_chroma and b["uv_mode"] == T.DC_PRED:
            if sd.symbol(cdf["palette_uv_mode"][1 if b["pal_y"] else 0], 2):
                n = sd.symbol(cdf["palette_uv_size"][bctx], 7) + 2
                cache = self.palette_cache(1)
                colors = []
                for v in cache:
                    if len(colors) >= n:
                        break
                    if sd.literal(1):
                        colors.append(v)
                if len(colors) < n:
                    colors.append(sd.literal(bd))
                if len(colors) < n:
                    bits = bd - 3 + sd.literal(2)
                    while len(colors) < n:
                        d = sd.literal(bits)
                        v = min((1 << bd) - 1, colors[-1] + d)
                        colors.append(v)
                        rng = (1 << bd) - v
                        bits = min(bits, _ceil_log2(rng))
                colors_u = sorted(colors)
                if sd.literal(1):
                    bits = bd - 4 + sd.literal(2)
                    mx = 1 << bd
                    cv = [sd.literal(bd)]
                    for _ in range(1, n):
                        d = sd.literal(bits)
                        if d and sd.literal(1):
                            d = -d
                        v = cv[-1] + d
                        if v < 0:
                            v += mx
                        if v >= mx:
                            v -= mx
                        cv.append(min(mx - 1, max(0, v)))
                else:
                    cv = [sd.literal(bd) for _ in range(n)]
                b["pal_uv"] = n
                b["colors"][1] = colors_u
                b["colors"][2] = cv

    def palette_cache(self, p: int) -> list:
        r, c = self.r, self.c
        above = self.pal_colors[p][r - 1][c] if ((r * 4) % 64 and self.avail_u and self.pal_sizes[p][r - 1][c]) else []
        left = self.pal_colors[p][r][c - 1] if (self.avail_l and self.pal_sizes[p][r][c - 1]) else []
        above, left = above or [], left or []
        ai = li = 0
        out = []
        while ai < len(above) and li < len(left):
            a, lv = above[ai], left[li]
            if lv < a:
                if not out or lv != out[-1]:
                    out.append(lv)
                li += 1
            else:
                if not out or a != out[-1]:
                    out.append(a)
                ai += 1
                if lv == a:
                    li += 1
        for v in above[ai:] + left[li:]:
            if not out or v != out[-1]:
                out.append(v)
        return out

    def palette_tokens(self, b: dict) -> None:
        bsize, r, c = self.bsize, self.r, self.c
        bh, bw = T.BLOCK_H[bsize], T.BLOCK_W[bsize]
        on_h = min(bh, (self.mi_rows - r) * 4)
        on_w = min(bw, (self.mi_cols - c) * 4)
        if b["pal_y"]:
            b["map_y"] = self.map_pos
            self.maps.append(self.color_map(b["pal_y"], bw, bh, on_w, on_h, self.cdf["palette_y_color_index"]))
            self.map_pos += len(self.maps[-1])
        if b["pal_uv"]:
            bw2, bh2 = bw >> self.ssx, bh >> self.ssy
            ow, oh = on_w >> self.ssx, on_h >> self.ssy
            if bw2 < 4:
                bw2 += 2
                ow += 2
            if bh2 < 4:
                bh2 += 2
                oh += 2
            b["map_uv"] = self.map_pos
            self.maps.append(self.color_map(b["pal_uv"], bw2, bh2, ow, oh, self.cdf["palette_uv_color_index"]))
            self.map_pos += len(self.maps[-1])

    def color_map(self, n: int, bw: int, bh: int, ow: int, oh: int, cdfs) -> np.ndarray:
        sd = self.sd
        m = [[0] * bw for _ in range(bh)]
        m[0][0] = sd.ns(n)
        for i in range(1, oh + ow - 1):
            for j in range(min(i, ow - 1), max(0, i - oh + 1) - 1, -1):
                rr, cc = i - j, j
                scores = [0] * 8
                order = list(range(8))
                if cc > 0:
                    scores[m[rr][cc - 1]] += 2
                if rr > 0 and cc > 0:
                    scores[m[rr - 1][cc - 1]] += 1
                if rr > 0:
                    scores[m[rr - 1][cc]] += 2
                for k in range(3):
                    mx, mi = scores[k], k
                    for q in range(k + 1, n):
                        if scores[q] > mx:
                            mx, mi = scores[q], q
                    if mi != k:
                        mo = order[mi]
                        for q in range(mi, k, -1):
                            scores[q] = scores[q - 1]
                            order[q] = order[q - 1]
                        scores[k], order[k] = mx, mo
                hsh = scores[0] * 1 + scores[1] * 2 + scores[2] * 2
                ctx = _PALETTE_COLOR_CONTEXT[hsh]
                m[rr][cc] = order[sd.symbol(cdfs[n - 2][ctx], n)]
        for i in range(oh):
            for j in range(ow, bw):
                m[i][j] = m[i][ow - 1]
        for i in range(oh, bh):
            m[i] = list(m[oh - 1])
        return np.array(m, np.uint8).reshape(-1)

    # -- IntraBC ----------------------------------------------------------------
    def read_intrabc(self) -> tuple:
        stack = self.mv_stack()
        nearest = stack[0] if len(stack) > 0 else (0, 0)
        near = stack[1] if len(stack) > 1 else (0, 0)
        nearest, near = _lower_precision(nearest), _lower_precision(near)
        ref = nearest if nearest != (0, 0) else near
        if ref == (0, 0):
            sb4 = self.sb4
            if self.r - sb4 < self.row_start:
                ref = (0, -(sb4 * 4 + 256) * 8)
            else:
                ref = (-(sb4 * 4 * 8), 0)
        ref = ((ref[0] >> 3) * 8, (ref[1] >> 3) * 8)
        sd, cdf = self.sd, self.cdf
        joint = sd.symbol(cdf["mv_joints"], 4)
        d = [0, 0]
        if joint in (2, 3):
            d[0] = self.mv_component(0)
        if joint in (1, 3):
            d[1] = self.mv_component(1)
        mv = (((ref[0] + d[0]) >> 3) * 8, ((ref[1] + d[1]) >> 3) * 8)
        self.check_dv(mv)
        return mv

    def mv_component(self, comp: int) -> int:
        sd, cdf = self.sd, self.cdf
        k = f"mv{comp}_"
        sign = sd.symbol(cdf[k + "sign"], 2)
        cls = sd.symbol(cdf[k + "classes"], 11)
        if cls == 0:
            dd = sd.symbol(cdf[k + "class0"], 2)
            mag = 0
        else:
            dd = 0
            for i in range(cls):
                dd |= sd.symbol(cdf[k + "bits"][i], 2) << i
            mag = 2 << (cls + 2)
        mag += ((dd << 3) | (3 << 1) | 1) + 1
        return -mag if sign else mag

    def mv_stack(self) -> list:
        r, c, bsize = self.r, self.c, self.bsize
        bw4, bh4 = 1 << T.MI_WIDTH_LOG2[bsize], 1 << T.MI_HEIGHT_LOG2[bsize]
        self.stack, self.weights = [], []
        self.found = False
        self.scan_row(-1, bw4)
        above_match = self.found
        self.found = False
        self.scan_col(-1, bh4)
        left_match = self.found
        self.found = False
        if max(bw4, bh4) <= 16:
            self.scan_point(-1, bw4)
        if self.found:
            above_match = True
        num_nearest = len(self.stack)
        for i in range(num_nearest):
            self.weights[i] += 640
        self.found = False
        self.scan_point(-1, -1)
        self.found = False
        self.scan_row(-3, bw4)
        self.found = False
        self.scan_col(-3, bh4)
        self.found = False
        if bh4 > 1:
            self.scan_row(-5, bw4)
        self.found = False
        if bw4 > 1:
            self.scan_col(-5, bh4)
        _sort_stack(self.stack, self.weights, 0, num_nearest)
        _sort_stack(self.stack, self.weights, num_nearest, len(self.stack))
        out = []
        top = -((r * 4) * 8)
        bottom = ((self.mi_rows - bh4 - r) * 4) * 8
        lft = -((c * 4) * 8)
        rgt = ((self.mi_cols - bw4 - c) * 4) * 8
        for mv in self.stack:
            br, bc = 128 + bh4 * 4 * 8, 128 + bw4 * 4 * 8
            out.append((max(top - br, min(bottom + br, mv[0])), max(lft - bc, min(rgt + bc, mv[1]))))
        return out

    def scan_row(self, delta_row: int, bw4: int) -> None:
        r, c = self.r, self.c
        end4 = min(bw4, self.mi_cols - c, 16)
        delta_col = 0
        step16 = bw4 >= 16
        if abs(delta_row) > 1:
            delta_row += r & 1
            delta_col = 1 - (c & 1)
        i = 0
        while i < end4:
            mr, mc = r + delta_row, c + delta_col + i
            if not self.inside(mr, mc):
                break
            ln = min(bw4, 1 << T.MI_WIDTH_LOG2[self.mi_size[mr][mc]])
            if abs(delta_row) > 1:
                ln = max(2, ln)
            if step16:
                ln = max(4, ln)
            self.add_candidate(mr, mc, ln * 2)
            i += ln

    def scan_col(self, delta_col: int, bh4: int) -> None:
        r, c = self.r, self.c
        end4 = min(bh4, self.mi_rows - r, 16)
        delta_row = 0
        step16 = bh4 >= 16
        if abs(delta_col) > 1:
            delta_row = 1 - (r & 1)
            delta_col += c & 1
        i = 0
        while i < end4:
            mr, mc = r + delta_row + i, c + delta_col
            if not self.inside(mr, mc):
                break
            ln = min(bh4, 1 << T.MI_HEIGHT_LOG2[self.mi_size[mr][mc]])
            if abs(delta_col) > 1:
                ln = max(2, ln)
            if step16:
                ln = max(4, ln)
            self.add_candidate(mr, mc, ln * 2)
            i += ln

    def scan_point(self, dr: int, dc: int) -> None:
        mr, mc = self.r + dr, self.c + dc
        if self.inside(mr, mc) and self.decoded[mr][mc]:
            self.add_candidate(mr, mc, 4)

    def add_candidate(self, mr: int, mc: int, weight: int) -> None:
        if not self.is_inter[mr][mc]:
            return
        mv = _lower_precision(self.mvs[mr][mc])
        self.found = True
        for i, s in enumerate(self.stack):
            if s == mv:
                self.weights[i] += weight
                return
        if len(self.stack) < 8:
            self.stack.append(mv)
            self.weights.append(weight)

    def check_dv(self, mv: tuple) -> None:
        """``av1_is_dv_valid``: the source lies inside the tile, decoded, and
        at least the IntraBC delay behind in the superblock wavefront."""
        if (mv[0] & 7) or (mv[1] & 7):
            raise Av1Error("AV1 IntraBC vector with a fractional part")
        bsize = self.bsize
        bw, bh = T.BLOCK_W[bsize], T.BLOCK_H[bsize]
        dr, dc = mv[0] >> 3, mv[1] >> 3
        src_top = self.r * 4 + dr
        src_left = self.c * 4 + dc
        src_bottom = src_top + bh
        src_right = src_left + bw
        if (src_top < self.row_start * 4 or src_left < self.col_start * 4 or src_bottom > self.row_end * 4
                or src_right > self.col_end * 4):
            raise Av1Error("AV1 IntraBC source outside its tile")
        if self.has_chroma and (bw < 8 or bh < 8):
            if self.ssx and bw < 8 and src_left - 4 < self.col_start * 4:
                raise Av1Error("AV1 IntraBC chroma source outside its tile")
            if self.ssy and bh < 8 and src_top - 4 < self.row_start * 4:
                raise Av1Error("AV1 IntraBC chroma source outside its tile")
        sb_shift = 7 if self.sb128 else 6
        active_sb_row = (self.r * 4) >> sb_shift
        active_sb64_col = (self.c * 4) >> 6
        src_sb_row = (src_bottom - 1) >> sb_shift
        src_sb64_col = (src_right - 1) >> 6
        total_sb64_per_row = (((self.col_end - self.col_start - 1) * 4) >> 6) + 1
        active_sb64 = active_sb_row * total_sb64_per_row + active_sb64_col
        src_sb64 = src_sb_row * total_sb64_per_row + src_sb64_col
        if src_sb64 >= active_sb64 - 256 // 64:
            raise Av1Error("AV1 IntraBC source within the wavefront delay")
        gradient = 1 + 256 // 64 + (1 if self.sb128 else 0)
        wf_offset = gradient * (active_sb_row - src_sb_row)
        if src_sb_row > active_sb_row or src_sb64_col >= active_sb64_col - 256 // 64 + wf_offset:
            raise Av1Error("AV1 IntraBC source past the wavefront")

    # -- transform sizes ----------------------------------------------------------
    def read_block_tx_size(self, b: dict) -> None:
        h = self.h
        r, c, bsize = self.r, self.c, self.bsize
        bw4, bh4 = 1 << T.MI_WIDTH_LOG2[bsize], 1 << T.MI_HEIGHT_LOG2[bsize]
        if h.tx_mode_select and bsize > T.BLOCK_4X4 and b["intrabc"] and not b["skip"] and not self.lossless:
            mx = T.MAX_TX_SIZE_RECT[bsize]
            w4, h4 = T.TX_W[mx] >> 2, T.TX_H[mx] >> 2
            self.tx_size = mx
            for row in range(r, r + bh4, h4):
                for col in range(c, c + bw4, w4):
                    self.read_var_tx_size(row, col, mx, 0)
            return
        self.read_tx_size(not b["skip"] or not b["intrabc"])
        for y in range(r, min(r + bh4, self.mi_rows)):
            for x in range(c, min(c + bw4, self.mi_cols)):
                self.inter_tx[y][x] = self.tx_size

    def read_tx_size(self, allow_select: bool) -> None:
        bsize = self.bsize
        if self.lossless:
            self.tx_size = T.TX_4X4
            return
        mx = T.MAX_TX_SIZE_RECT[bsize]
        self.tx_size = mx
        if bsize > T.BLOCK_4X4 and allow_select and self.h.tx_mode_select:
            depth, t = 0, mx
            while t != T.TX_4X4:
                depth += 1
                t = T.SPLIT_TX_SIZE[t]
            cat, max_depth = depth - 1, min(depth, 2)
            w, hh = T.TX_W[mx], T.TX_H[mx]
            r, c = self.r, self.c
            if self.avail_u:
                above = (T.BLOCK_W[self.mi_size[r - 1][c]] if self.is_inter[r - 1][c]
                         else self.above_tx_width(r, c)) >= w
            else:
                above = 0
            if self.avail_l:
                left = (T.BLOCK_H[self.mi_size[r][c - 1]] if self.is_inter[r][c - 1]
                        else self.left_tx_height(r, c)) >= hh
            else:
                left = 0
            d = self.sd.symbol(self.cdf["tx_size"][cat][int(above) + int(left)], max_depth + 1)
            for _ in range(d):
                self.tx_size = T.SPLIT_TX_SIZE[self.tx_size]

    def above_tx_width(self, row: int, col: int) -> int:
        if row == self.r:
            if not self.avail_u:
                return 64
            if self.skips[row - 1][col] and self.is_inter[row - 1][col]:
                return T.BLOCK_W[self.mi_size[row - 1][col]]
        return T.TX_W[self.inter_tx[row - 1][col]]

    def left_tx_height(self, row: int, col: int) -> int:
        if col == self.c:
            if not self.avail_l:
                return 64
            if self.skips[row][col - 1] and self.is_inter[row][col - 1]:
                return T.BLOCK_H[self.mi_size[row][col - 1]]
        return T.TX_H[self.inter_tx[row][col - 1]]

    def read_var_tx_size(self, row: int, col: int, tx: int, depth: int) -> None:
        if row >= self.mi_rows or col >= self.mi_cols:
            return
        if tx == T.TX_4X4 or depth == 2:
            split = 0
        else:
            above = self.above_tx_width(row, col) < T.TX_W[tx]
            left = self.left_tx_height(row, col) < T.TX_H[tx]
            size = min(64, max(T.BLOCK_W[self.bsize], T.BLOCK_H[self.bsize]))
            mx = T.tx_size_of(size, size)
            ctx = (T.TX_SQR_UP[tx] != mx) * 3 + (4 - mx) * 6 + above + left
            split = self.sd.symbol(self.cdf["txfm_partition"][ctx], 2)
        w4, h4 = T.TX_W[tx] >> 2, T.TX_H[tx] >> 2
        if split:
            sub = T.SPLIT_TX_SIZE[tx]
            sw, sh = T.TX_W[sub] >> 2, T.TX_H[sub] >> 2
            for i in range(0, h4, sh):
                for j in range(0, w4, sw):
                    self.read_var_tx_size(row + i, col + j, sub, depth + 1)
        else:
            for i in range(h4):
                for j in range(w4):
                    if row + i < self.mi_rows and col + j < self.mi_cols:
                        self.inter_tx[row + i][col + j] = tx
            self.tx_size = tx

    def reset_block_context(self, bw4: int, bh4: int) -> None:
        r, c = self.r, self.c
        for p in range(1 + 2 * self.has_chroma):
            sx, sy = (self.ssx, self.ssy) if p else (0, 0)
            for i in range(c >> sx, (c + bw4) >> sx):
                self.above_level[p][i] = 0
                self.above_dc[p][i] = 0
            for i in range(r >> sy, (r + bh4) >> sy):
                self.left_level[p][i] = 0
                self.left_dc[p][i] = 0

    # -- residual ---------------------------------------------------------------
    def residual(self, b: dict) -> None:
        bsize, r, c = self.bsize, self.r, self.c
        wc = max(1, T.BLOCK_W[bsize] >> 6)
        hc = max(1, T.BLOCK_H[bsize] >> 6)
        self.b = b
        self.qidx = self.h.qindex(b["segment"], self.current_q if self.h.delta_q_present else None)
        self.max_luma = (0, 0)
        if b["intrabc"]:
            for p in range(1 + 2 * self.has_chroma):
                sx, sy = (self.ssx, self.ssy) if p else (0, 0)
                ps = plane_residual_size(bsize, sx, sy)
                self.txbs.append((KIND_INTRABC, p, (c >> sx) * 4, (r >> sy) * 4, 0, 0, 0, 0, len(self.blocks), 0,
                                  0, self.sb_index, 0, self.qidx, T.BLOCK_W[ps], T.BLOCK_H[ps]))
        for cy in range(hc):
            for cx in range(wc):
                rc, ccol = r + (cy << 4), c + (cx << 4)
                for p in range(1 + 2 * self.has_chroma):
                    sx, sy = (self.ssx, self.ssy) if p else (0, 0)
                    tx = T.TX_4X4 if self.lossless else (self.tx_size if p == 0 else uv_tx_size(bsize, sx, sy))
                    step_x, step_y = T.TX_W[tx] >> 2, T.TX_H[tx] >> 2
                    ps = plane_residual_size(bsize, sx, sy)
                    n4w, n4h = 1 << T.MI_WIDTH_LOG2[ps], 1 << T.MI_HEIGHT_LOG2[ps]
                    if b["intrabc"] and not self.lossless and p == 0:
                        self.transform_tree((ccol >> sx) * 4, (rc >> sy) * 4, n4w * 4, n4h * 4)
                    else:
                        bx, by = (c >> sx) * 4, (r >> sy) * 4
                        for y in range(0, min(n4h, 16 >> sy), step_y):
                            for x in range(0, min(n4w, 16 >> sx), step_x):
                                self.transform_block(p, bx, by, tx, x + ((cx << 4) >> sx), y + ((cy << 4) >> sy))
        b["max_luma_w"], b["max_luma_h"] = self.max_luma

    def transform_tree(self, sx0: int, sy0: int, w: int, h: int) -> None:
        if sx0 >= self.mi_cols * 4 or sy0 >= self.mi_rows * 4:
            return
        tx = self.inter_tx[sy0 >> 2][sx0 >> 2]
        if w <= T.TX_W[tx] and h <= T.TX_H[tx]:
            self.transform_block(0, sx0, sy0, tx, 0, 0)
        elif w > h:
            self.transform_tree(sx0, sy0, w // 2, h)
            self.transform_tree(sx0 + w // 2, sy0, w // 2, h)
        elif w < h:
            self.transform_tree(sx0, sy0, w, h // 2)
            self.transform_tree(sx0, sy0 + h // 2, w, h // 2)
        else:
            for dy in (0, h // 2):
                for dx in (0, w // 2):
                    self.transform_tree(sx0 + dx, sy0 + dy, w // 2, h // 2)

    def transform_block(self, p: int, bx: int, by: int, tx: int, x: int, y: int) -> None:
        b = self.b
        sx, sy = (self.ssx, self.ssy) if p else (0, 0)
        start_x, start_y = bx + 4 * x, by + 4 * y
        row, col = (start_y << sy) >> 2, (start_x << sx) >> 2
        sb_mask = 31 if self.sb128 else 15
        sub_r, sub_c = row & sb_mask, col & sb_mask
        step_x, step_y = T.TX_W[tx] >> 2, T.TX_H[tx] >> 2
        max_x, max_y = (self.mi_cols * 4) >> sx, (self.mi_rows * 4) >> sy
        if start_x >= max_x or start_y >= max_y:
            return
        flags, mode, filter_type = 0, 0, 0
        bd = self.block_decoded[p]
        if self.lossless:
            flags |= F_LOSSLESS
        if not b["intrabc"]:
            kind = KIND_INTRA
            if (p == 0 and b["pal_y"]) or (p and b["pal_uv"]):
                flags |= F_PALETTE
            else:
                is_cfl = p > 0 and b["uv_mode"] == T.UV_CFL_PRED
                mode = b["y_mode"] if p == 0 else (T.DC_PRED if is_cfl else b["uv_mode"])
                if (self.avail_l if p == 0 else self.avail_l_chroma) or x > 0:
                    flags |= F_LEFT
                if (self.avail_u if p == 0 else self.avail_u_chroma) or y > 0:
                    flags |= F_ABOVE
                if bd[(sub_r >> sy) - 1 + 1][(sub_c >> sx) + step_x + 1]:
                    flags |= F_ABOVE_RIGHT
                if bd[(sub_r >> sy) + step_y + 1][(sub_c >> sx) - 1 + 1]:
                    flags |= F_BELOW_LEFT
                if is_cfl:
                    flags |= F_CFL
                if p == 0 and b["use_filter"]:
                    flags |= F_FILTER_INTRA
                if T.V_PRED <= mode <= T.D67_PRED:
                    filter_type = self.filter_type(p)
            if p == 0:
                self.max_luma = (start_x + step_x * 4, start_y + step_y * 4)
        else:
            kind = KIND_RESIDUAL
        eob, tx_type, coef = 0, T.DCT_DCT, self.coef_pos
        if not b["skip"]:
            eob, tx_type, vals = self.coeffs(start_x, start_y, p, tx)
            if eob:
                self.coefs.append(vals)
                self.coef_pos += eob
            else:
                coef = -1
        else:
            coef = -1
            if p == 0:
                for i in range(step_y):
                    for j in range(step_x):
                        self.tx_types[((start_y >> 2) + i, (start_x >> 2) + j)] = T.DCT_DCT
            tx_type = self.plane_tx_type(p, tx, start_x >> 2, start_y >> 2)
        self.txbs.append((kind, p, start_x, start_y, tx, tx_type, eob, coef, len(self.blocks), mode, flags,
                          self.sb_index, filter_type, self.qidx, T.TX_W[tx], T.TX_H[tx]))
        lf = self.lf_tx[p]
        lf[(row >> sy):(row >> sy) + step_y, (col >> sx):(col >> sx) + step_x] = tx
        for i in range(step_y):
            for j in range(step_x):
                bd[(sub_r >> sy) + i + 1][(sub_c >> sx) + j + 1] = 1

    def filter_type(self, p: int) -> int:
        r, c = self.r, self.c
        smooth = (T.SMOOTH_PRED, T.SMOOTH_V_PRED, T.SMOOTH_H_PRED)

        def is_smooth(row: int, col: int) -> bool:
            if p == 0:
                return self.y_modes[row][col] in smooth
            if self.is_inter[row][col]:
                return False
            return self.uv_modes[row][col] in smooth

        above = left = False
        if self.avail_u if p == 0 else self.avail_u_chroma:
            rr, cc = r - 1, c
            if p:
                if self.ssx and not (c & 1):
                    cc += 1
                if self.ssy and (r & 1):
                    rr -= 1
            above = is_smooth(rr, cc)
        if self.avail_l if p == 0 else self.avail_l_chroma:
            rr, cc = r, c - 1
            if p:
                if self.ssx and (c & 1):
                    cc -= 1
                if self.ssy and not (r & 1):
                    rr += 1
            left = is_smooth(rr, cc)
        return int(above or left)

    def plane_tx_type(self, p: int, tx: int, x4: int, y4: int) -> int:
        b = self.b
        if self.lossless or T.TX_SQR_UP[tx] > T.TX_32X32:
            return T.DCT_DCT
        inter = bool(b["intrabc"])
        tset = _ext_tx_set(tx, inter, bool(self.h.reduced_tx_set))
        if p == 0:
            return self.tx_types.get((y4, x4), T.DCT_DCT)
        if inter:
            sx, sy = self.ssx, self.ssy
            t = self.tx_types.get((max(self.r, y4 << sy), max(self.c, x4 << sx)), T.DCT_DCT)
        else:
            t = T.MODE_TO_TXFM[b["uv_mode"]]
        if not T.table("ext_tx_used")[tset][t]:
            return T.DCT_DCT
        return t

    # -- coefficients -----------------------------------------------------------
    def coeffs(self, start_x: int, start_y: int, p: int, tx: int):
        sd, cdf = self.sd, self.cdf
        x4, y4 = start_x >> 2, start_y >> 2
        w4, h4 = T.TX_W[tx] >> 2, T.TX_H[tx] >> 2
        tx_ctx = (T.TX_SQR[tx] + T.TX_SQR_UP[tx] + 1) >> 1
        ptype = 1 if p else 0
        max_x4, max_y4 = self.mi_cols, self.mi_rows
        if p:
            max_x4 >>= self.ssx
            max_y4 >>= self.ssy
        al, ad = self.above_level[p], self.above_dc[p]
        ll, ld = self.left_level[p], self.left_dc[p]
        w, h = T.TX_W[tx], T.TX_H[tx]
        bs = plane_residual_size(self.bsize, self.ssx if p else 0, self.ssy if p else 0)
        if p == 0:
            top = left = 0
            for k in range(w4):
                if x4 + k < max_x4:
                    top = max(top, al[x4 + k])
            for k in range(h4):
                if y4 + k < max_y4:
                    left = max(left, ll[y4 + k])
            top, left = min(top, 255), min(left, 255)
            if T.BLOCK_W[bs] == w and T.BLOCK_H[bs] == h:
                ctx = 0
            elif top == 0 and left == 0:
                ctx = 1
            elif top == 0 or left == 0:
                ctx = 2 + (max(top, left) > 3)
            elif max(top, left) <= 3:
                ctx = 4
            elif min(top, left) <= 3:
                ctx = 5
            else:
                ctx = 6
        else:
            above = left = 0
            for i in range(w4):
                if x4 + i < max_x4:
                    above |= al[x4 + i] | ad[x4 + i]
            for i in range(h4):
                if y4 + i < max_y4:
                    left |= ll[y4 + i] | ld[y4 + i]
            ctx = (above != 0) + (left != 0) + 7
            if T.BLOCK_W[bs] * T.BLOCK_H[bs] > w * h:
                ctx += 3
        all_zero = sd.symbol(cdf["coef_txb_skip"][tx_ctx][ctx], 2)
        cul, dc_cat, eob, vals = 0, 0, 0, None
        if all_zero:
            tx_type = T.DCT_DCT
            if p == 0:
                for i in range(h4):
                    for j in range(w4):
                        self.tx_types[(y4 + i, x4 + j)] = T.DCT_DCT
            tx_type = self.plane_tx_type(p, tx, x4, y4)
        else:
            if p == 0:
                self.read_tx_type(tx, x4, y4, w4, h4)
            tx_type = self.plane_tx_type(p, tx, x4, y4)
            eob, vals, cul, dc_cat = self.read_coefs(p, tx, tx_ctx, ptype, tx_type, x4, y4, w4, h4, max_x4, max_y4)
        for i in range(w4):
            al[x4 + i] = cul
            ad[x4 + i] = dc_cat
        for i in range(h4):
            ll[y4 + i] = cul
            ld[y4 + i] = dc_cat
        return eob, tx_type, vals

    def read_tx_type(self, tx: int, x4: int, y4: int, w4: int, h4: int) -> None:
        b, h = self.b, self.h
        t = T.DCT_DCT
        inter = bool(b["intrabc"])
        tset = _ext_tx_set(tx, inter, bool(h.reduced_tx_set))
        n = int(T.table("num_ext_tx_set")[tset])
        qidx = h.qindex(b["segment"])
        if n > 1 and qidx > 0 and not b["skip"] and not (h.seg_enabled and h.feature_enabled[b["segment"]][SEG_LVL_SKIP]):
            eset = _EXT_TX_SET_INDEX[1 if inter else 0][tset]
            sqr = T.TX_SQR[tx]
            if inter:
                s = self.sd.symbol(self.cdf["inter_ext_tx"][eset][sqr], n)
            else:
                mode = T.FILTER_INTRA_MODE_TO_INTRA_DIR[b["filter_mode"]] if b["use_filter"] else b["y_mode"]
                s = self.sd.symbol(self.cdf["intra_ext_tx"][eset][sqr][mode], n)
            t = int(T.table("ext_tx_inv")[tset][s])
        for i in range(h4):
            for j in range(w4):
                self.tx_types[(y4 + i, x4 + j)] = t

    def read_coefs(self, p, tx, tx_ctx, ptype, tx_type, x4, y4, w4, h4, max_x4, max_y4):
        sd, cdf = self.sd, self.cdf
        cls = tx_class(tx_type)
        scan = T.scan(tx, tx_type)
        adj = adjusted_tx_size(tx)
        bwl = T.TX_W_LOG2[adj]
        txw, txh = T.TX_W[adj], T.TX_H[adj]
        multi = min(T.TX_W_LOG2[tx], 5) + min(T.TX_H_LOG2[tx], 5) - 4
        eob_ctx = 0 if cls == TX_CLASS_2D else 1
        eob_pt = sd.symbol(cdf[f"coef_eob{16 << multi}"][ptype][eob_ctx], 5 + multi) + 1
        eob = eob_pt if eob_pt < 2 else (1 << (eob_pt - 2)) + 1
        shift = eob_pt - 3
        if shift >= 0:
            if sd.symbol(cdf["coef_eob_extra"][tx_ctx][ptype][eob_pt - 3], 2):
                eob += 1 << shift
            for i in range(1, max(0, eob_pt - 2)):
                shift = max(0, eob_pt - 2) - 1 - i
                if sd.literal(1):
                    eob += 1 << shift
        # levels on a padded grid: (txh + 4) rows of (txw + 4)
        stride = txw + 4
        lev = [0] * ((txh + 4) * stride)
        offs = T.nz_map_offset(tx)
        base_cdf = cdf["coef_base"][tx_ctx][ptype]
        base_eob_cdf = cdf["coef_base_eob"][tx_ctx][ptype]
        br_cdf = cdf["coef_br"][min(tx_ctx, 3)][ptype]
        sig = _SIG_REF[cls]
        mag_ref = _MAG_REF[cls]
        area = txh << bwl
        quant = [0] * eob
        for c in range(eob - 1, -1, -1):
            pos = scan[c]
            row, col = pos >> bwl, pos & (txw - 1)
            li = row * stride + col
            if c == eob - 1:
                ctx = 0 if c == 0 else 1 if c <= area // 8 else 2 if c <= area // 4 else 3
                level = sd.symbol(base_eob_cdf[ctx], 3) + 1
            else:
                mag = 0
                for dr, dc in sig:
                    mag += min(lev[li + dr * stride + dc], 3)
                ctx = min((mag + 1) >> 1, 4)
                if cls == TX_CLASS_2D:
                    ctx = 0 if pos == 0 else ctx + offs[pos]
                else:
                    idx = row if cls == TX_CLASS_VERT else col
                    ctx += (26, 31, 36)[min(idx, 2)]
                level = sd.symbol(base_cdf[ctx], 4)
            if level > 2:
                mag = 0
                for dr, dc in mag_ref:
                    mag += min(lev[li + dr * stride + dc], 15)
                mag = min((mag + 1) >> 1, 6)
                if pos == 0:
                    ctx = mag
                elif cls == TX_CLASS_2D:
                    ctx = mag + (7 if row < 2 and col < 2 else 14)
                elif cls == TX_CLASS_HORIZ:
                    ctx = mag + (7 if col == 0 else 14)
                else:
                    ctx = mag + (7 if row == 0 else 14)
                bcdf = br_cdf[ctx]
                for _ in range(4):
                    k = sd.symbol(bcdf, 4)
                    level += k
                    if k < 3:
                        break
            lev[li] = level
            quant[c] = level
        cul, dc_cat = 0, 0
        for c in range(eob):
            q = quant[c]
            if q:
                if c == 0:
                    dc = 0
                    for k in range(w4):
                        if x4 + k < max_x4:
                            v = self.above_dc[p][x4 + k]
                            dc += (v == 2) - (v == 1)
                    for k in range(h4):
                        if y4 + k < max_y4:
                            v = self.left_dc[p][y4 + k]
                            dc += (v == 2) - (v == 1)
                    sctx = 1 if dc < 0 else 2 if dc > 0 else 0
                    sign = sd.symbol(cdf["coef_dc_sign"][ptype][sctx], 2)
                else:
                    sign = sd.literal(1)
                if q > 14:
                    q = sd.golomb() + 15
                if scan[c] == 0:
                    dc_cat = 1 if sign else 2
                q &= 0xFFFFF
                cul += q
                quant[c] = -q if sign else q
        return eob, quant, min(63, cul), dc_cat


def _inverse_recenter(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def _neg_deinterleave(diff: int, ref: int, mx: int) -> int:
    if not ref:
        return diff
    if ref >= mx - 1:
        return mx - diff - 1
    if 2 * ref < mx:
        if diff <= 2 * ref:
            return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
        return diff
    if diff <= 2 * (mx - ref - 1):
        return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
    return mx - (diff + 1)


def _ceil_log2(x: int) -> int:
    return 0 if x < 2 else (x - 1).bit_length()


def _lower_precision(mv: tuple) -> tuple:
    """``lower_mv_precision`` with ``force_integer_mv`` (intra frames)."""
    out = []
    for v in mv:
        a = (abs(v) + 3) >> 3
        out.append(a << 3 if v > 0 else -(a << 3))
    return tuple(out)


def _sort_stack(stack: list, weights: list, start: int, end: int) -> None:
    while end > start:
        new_end = start
        for i in range(start + 1, end):
            if weights[i - 1] < weights[i]:
                weights[i - 1], weights[i] = weights[i], weights[i - 1]
                stack[i - 1], stack[i] = stack[i], stack[i - 1]
                new_end = i
        end = new_end


def parse(frame: Frame) -> Parsed:
    """Every tile of ``frame`` -> the tables of :class:`Parsed`."""
    return _Parser(frame).run()
