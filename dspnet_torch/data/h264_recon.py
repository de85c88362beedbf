"""The plain H.264 reconstruction (ITU-T H.264 8.3-8.5) of one picture from
the parse's tables (``h264_parse``): 8-bit 4:2:0 (and 4:0:0) frames.

:func:`recon_picture` runs, for the picture's macroblocks in decode order:

* motion vectors (8.4.1): median and directional prediction with the
  neighbours' availability (slices, decode order inside the macroblock),
  P_Skip, B direct spatial (with ``colZeroFlag``) and temporal
  (``DistScaleFactor``) from the first list-1 reference's motion field,
  8x8 inference or not;
* inter prediction (8.4.2): 6-tap quarter-sample luma, eighth-sample
  bilinear chroma, the reference's samples clamped at its edges, weighted
  prediction (explicit tables, implicit weights from POC distances, the
  default average);
* the residual (8.5): dequantisation with the scaling matrices, the
  Intra16x16 and chroma DC Hadamards, the 4x4 and 8x8 inverse transforms;
* intra prediction (8.3): 4x4 with its top-right availability, 8x8 with
  its reference filter, 16x16 (plane included) and chroma, with
  ``constrained_intra_pred_flag``; I_PCM samples.

Inter macroblocks are predicted together (numpy over every 4x4 block), then
intra macroblocks one by one in decode order, since they read their
neighbours' unfiltered samples. The output is the unfiltered planes and the
picture's motion field (per 4x4 block and list: vector, reference index and
the reference picture's id), which the deblocking filter and later direct
prediction read. ``csrc/h264.cu``'s ``h264_mv_kernel``, ``h264_inter_kernel``
and ``h264_intra_kernel`` compute the same planes and motion field.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from dspnet_torch.data import h264_tables as T
from dspnet_torch.data.h264_parse import (BLK_AT, BLK_X, BLK_Y, F_CPRED, F_I16, F_IM0, F_IM1, F_MVD, F_PART, F_PRED,
                                          F_QP, F_REF0, F_SLICE, F_SUB, F_T8, F_TYPE, L_CAC, L_CDC, L_DC, PART_8x8,
                                          PART_16x16, SUB_DIRECT, SUB_PARTS, T_BDIRECT, T_BSKIP, T_I4, T_I8, T_I16,
                                          T_PCM, T_PSKIP, part_blocks, sub_blocks)


@dataclass
class SliceInfo:
    """What the reconstruction needs of one slice."""

    slice_type: int
    direct_spatial: int = 1
    #: per list: the references' picture ids, POCs and long-term flags
    ref_ids: List[List[int]] = field(default_factory=lambda: [[], []])
    ref_pocs: List[List[int]] = field(default_factory=lambda: [[], []])
    ref_long: List[List[int]] = field(default_factory=lambda: [[], []])
    #: 0 default, 1 explicit, 2 implicit
    weighted: int = 0
    luma_denom: int = 0
    chroma_denom: int = 0
    #: explicit weights per list and reference: (luma w, o, cb w, o, cr w, o)
    weights: List[List[tuple]] = field(default_factory=lambda: [[], []])
    cip: int = 0
    direct8: int = 1
    chroma_offsets: tuple = (0, 0)
    #: the six 4x4 and two 8x8 scaling lists (zig-zag order)
    lists4: Optional[list] = None
    lists8: Optional[list] = None
    deblock: tuple = (0, 0, 0)


@dataclass
class RefPicture:
    """A decoded picture as a reference: planes (deblocked) and motion."""

    pid: int
    poc: int
    y: np.ndarray
    u: Optional[np.ndarray]
    v: Optional[np.ndarray]
    mv: np.ndarray  # (2, H4, W4, 2) int32
    ref: np.ndarray  # (2, H4, W4) int32, -1 unused
    ref_id: np.ndarray  # (2, H4, W4) int32, the referenced picture's id (-1 unused)
    long_term: bool = False


def clip1(x):
    return np.clip(x, 0, 255)


def cdiv(a: int, b: int) -> int:
    """C's integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


# ------------------------------------------------------------------ residual


def level_scale4(lists4) -> np.ndarray:
    """LevelScale4x4 (6 lists, 6 qP % 6, 16 raster)."""
    out = np.zeros((6, 6, 16), np.int64)
    for i, lst in enumerate(lists4):
        w = np.zeros(16, np.int64)
        w[T.ZIGZAG4] = lst
        out[i] = w[None] * T.NORM4
    return out


def level_scale8(lists8) -> np.ndarray:
    out = np.zeros((2, 6, 64), np.int64)
    for i, lst in enumerate(lists8):
        w = np.zeros(64, np.int64)
        w[T.ZIGZAG8] = lst
        out[i] = w[None] * T.NORM8
    return out


def dequant4(c: np.ndarray, ls: np.ndarray, qp: np.ndarray) -> np.ndarray:
    """8.5.12.1 for 4x4 blocks (..., 16) with per-block ``ls`` (..., 16) and
    ``qp`` (...)."""
    qp = qp[..., None]
    q6 = qp // 6
    up = (c * ls) << np.maximum(q6 - 4, 0)
    down = (c * ls + (1 << np.maximum(3 - q6, 0))) >> np.maximum(4 - q6, 0)
    return np.where(qp >= 24, up, down)


def dequant8(c: np.ndarray, ls: np.ndarray, qp: np.ndarray) -> np.ndarray:
    qp = qp[..., None]
    q6 = qp // 6
    up = (c * ls) << np.maximum(q6 - 6, 0)
    down = (c * ls + (1 << np.maximum(5 - q6, 0))) >> np.maximum(6 - q6, 0)
    return np.where(qp >= 36, up, down)


def idct4(d: np.ndarray) -> np.ndarray:
    """8.5.12.2 on (..., 4, 4): rows, then columns, then (x + 32) >> 6."""
    d = d.astype(np.int64)

    def one(a, axis):
        a0, a1, a2, a3 = (np.take(a, k, axis=axis) for k in range(4))
        e, f, g, h = a0 + a2, a0 - a2, (a1 >> 1) - a3, a1 + (a3 >> 1)
        return np.stack([e + h, f + g, f - g, e - h], axis=axis)

    return (one(one(d, -1), -2) + 32) >> 6


def idct8(d: np.ndarray) -> np.ndarray:
    """8.5.13 on (..., 8, 8)."""
    d = d.astype(np.int64)

    def one(x, axis):
        v = [np.take(x, k, axis=axis) for k in range(8)]
        a0, a4 = v[0] + v[4], v[0] - v[4]
        a2, a6 = (v[2] >> 1) - v[6], v[2] + (v[6] >> 1)
        b0, b2, b4, b6 = a0 + a6, a4 + a2, a4 - a2, a0 - a6
        a1 = -v[3] + v[5] - v[7] - (v[7] >> 1)
        a3 = v[1] + v[7] - v[3] - (v[3] >> 1)
        a5 = -v[1] + v[7] + v[5] + (v[5] >> 1)
        a7 = v[3] + v[5] + v[1] + (v[1] >> 1)
        b1, b7 = a1 + (a7 >> 2), a7 - (a1 >> 2)
        b3, b5 = a3 + (a5 >> 2), (a3 >> 2) - a5
        return np.stack([b0 + b7, b2 + b5, b4 + b3, b6 + b1, b6 - b1, b4 - b3, b2 - b5, b0 - b7], axis=axis)

    return (one(one(d, -1), -2) + 32) >> 6


HADAMARD4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)


def residuals(table: np.ndarray, levels: np.ndarray, slices: List[SliceInfo], chroma: bool):
    """Every macroblock's residual: luma (n, 16, 16), chroma (n, 2, 8, 8)
    int64 (before the prediction is added)."""
    n = len(table)
    lv = levels.astype(np.int64)
    typ, qp, t8 = table[:, F_TYPE], table[:, F_QP].astype(np.int64), table[:, F_T8]
    intra = typ <= T_PCM
    sl = table[:, F_SLICE]
    ls4 = np.stack([level_scale4(s.lists4) for s in slices])  # (S, 6, 6, 16)
    ls8 = np.stack([level_scale8(s.lists8) for s in slices])  # (S, 2, 6, 64)
    res_y = np.zeros((n, 16, 16), np.int64)
    # ---- luma 4x4 blocks
    list_y = np.where(intra, 0, 3)
    ls = ls4[sl, list_y, qp % 6]  # (n, 16)
    blocks = lv[:, :256].reshape(n, 16, 16)
    d = dequant4(blocks, ls[:, None, :], np.repeat(qp[:, None], 16, 1))
    i16 = typ == T_I16
    if i16.any():
        c = lv[i16, L_DC:L_DC + 16].reshape(-1, 4, 4)
        f = HADAMARD4 @ c @ HADAMARD4
        q = qp[i16][:, None, None]
        l0 = ls[i16][:, 0][:, None, None]
        dc = np.where(q >= 36, (f * l0) << np.maximum(q // 6 - 6, 0),
                      (f * l0 + (1 << np.maximum(5 - q // 6, 0))) >> np.maximum(6 - q // 6, 0))
        blk_dc = dc[:, BLK_Y, BLK_X]  # (m, 16) by 4x4 block index
        d[i16, :, 0] = blk_dc
    r4 = idct4(d.reshape(n, 16, 4, 4))  # (n, 16, 4, 4)
    for b in range(16):
        y, x = 4 * BLK_Y[b], 4 * BLK_X[b]
        res_y[:, y:y + 4, x:x + 4] = r4[:, b]
    # ---- luma 8x8 blocks
    if t8.any():
        m = t8 == 1
        ls8_ = ls8[sl[m], np.where(intra[m], 0, 1), qp[m] % 6]  # (k, 64)
        c8 = lv[m, :256].reshape(-1, 4, 64)
        d8 = dequant8(c8, ls8_[:, None, :], np.repeat(qp[m][:, None], 4, 1))
        r8 = idct8(d8.reshape(-1, 4, 8, 8))
        out = np.zeros((m.sum(), 16, 16), np.int64)
        for k in range(4):
            out[:, 8 * (k >> 1):8 * (k >> 1) + 8, 8 * (k & 1):8 * (k & 1) + 8] = r8[:, k]
        res_y[m] = out
    res_y[typ == T_PCM] = 0
    res_c = np.zeros((n, 2, 8, 8), np.int64)
    if not chroma:
        return res_y, res_c
    offsets = np.array([s.chroma_offsets for s in slices], np.int64)[sl]  # (n, 2)
    for comp in range(2):
        qpc = T.CHROMA_QP[np.clip(qp + offsets[:, comp], 0, 51)].astype(np.int64)
        lsc = ls4[sl, np.where(intra, 1, 4) + comp, qpc % 6]  # (n, 16)
        c = lv[:, L_CDC + 4 * comp:L_CDC + 4 * comp + 4]
        f = np.stack([c[:, 0] + c[:, 1] + c[:, 2] + c[:, 3], c[:, 0] - c[:, 1] + c[:, 2] - c[:, 3],
                      c[:, 0] + c[:, 1] - c[:, 2] - c[:, 3], c[:, 0] - c[:, 1] - c[:, 2] + c[:, 3]], 1)
        dcc = ((f * lsc[:, :1]) << (qpc // 6)[:, None]) >> 5
        ac = lv[:, L_CAC + 64 * comp:L_CAC + 64 * comp + 64].reshape(n, 4, 16)
        dd = dequant4(ac, lsc[:, None, :], np.repeat(qpc[:, None], 4, 1))
        dd[:, :, 0] = dcc
        rc = idct4(dd.reshape(n, 4, 4, 4))
        for k in range(4):
            res_c[:, comp, 4 * (k >> 1):4 * (k >> 1) + 4, 4 * (k & 1):4 * (k & 1) + 4] = rc[:, k]
    res_c[typ == T_PCM] = 0
    return res_y, res_c


# ------------------------------------------------------------------ motion vectors


def median(a, b, c):
    return max(min(a, b), min(max(a, b), c))


class MotionField:
    """The current picture's motion per 4x4 block while its macroblocks are
    reconstructed: vectors, reference indices and ids per list, and which
    blocks are done (available to prediction)."""

    def __init__(self, w4: int, h4: int):
        self.w4, self.h4 = w4, h4
        self.mv = np.zeros((2, h4, w4, 2), np.int32)
        self.ref = np.full((2, h4, w4), -1, np.int32)
        self.ref_id = np.full((2, h4, w4), -1, np.int32)
        self.done = np.zeros((h4, w4), bool)


class MvPredictor:
    """Motion vector derivation (8.4.1) for one picture."""

    def __init__(self, table, slices: List[SliceInfo], mb_w: int, mb_h: int, col: Optional[RefPicture], poc: int):
        self.table, self.slices = table, slices
        self.mb_w, self.mb_h = mb_w, mb_h
        self.mf = MotionField(4 * mb_w, 4 * mb_h)
        self.col = col
        self.poc = poc
        self._spatial = (None, None)  # (macroblock, its spatial direct refs and predictions)

    def nb(self, x4: int, y4: int, lx: int, cur_slice: int):
        """(available, ref, mv) of the 4x4 block at (x4, y4)."""
        mf = self.mf
        if x4 < 0 or y4 < 0 or x4 >= mf.w4 or y4 >= mf.h4:
            return False, -1, (0, 0)
        mb = (y4 >> 2) * self.mb_w + (x4 >> 2)
        if self.table[mb, F_SLICE] != cur_slice or not mf.done[y4, x4]:
            return False, -1, (0, 0)
        r = int(mf.ref[lx, y4, x4])
        if r < 0:
            return True, -1, (0, 0)
        return True, r, (int(mf.mv[lx, y4, x4, 0]), int(mf.mv[lx, y4, x4, 1]))

    def neighbours(self, x4, y4, w4, lx, sl):
        a = self.nb(x4 - 1, y4, lx, sl)
        b = self.nb(x4, y4 - 1, lx, sl)
        c = self.nb(x4 + w4, y4 - 1, lx, sl)
        if not c[0]:
            c = self.nb(x4 - 1, y4 - 1, lx, sl)
        return a, b, c

    def mvp(self, x4, y4, w4, h4, lx, ref, sl, shape=None, part=0):
        """mvpLX of a partition at (x4, y4) of w4 x h4 4x4 blocks; ``shape``
        "16x8" / "8x16" selects directional prediction."""
        a, b, c = self.neighbours(x4, y4, w4, lx, sl)
        if shape == "16x8":
            if part == 0 and b[1] == ref:
                return b[2]
            if part == 1 and a[1] == ref:
                return a[2]
        elif shape == "8x16":
            if part == 0 and a[1] == ref:
                return a[2]
            if part == 1 and c[1] == ref:
                return c[2]
        if not b[0] and not c[0] and a[0]:
            b = c = a
        match = [n for n in (a, b, c) if n[1] == ref]
        if len(match) == 1:
            return match[0][2]
        return (median(a[2][0], b[2][0], c[2][0]), median(a[2][1], b[2][1], c[2][1]))

    def store(self, blocks, mbx4, mby4, lx, ref, mv, rid):
        mf = self.mf
        for blk in blocks:
            x4, y4 = mbx4 + BLK_X[blk], mby4 + BLK_Y[blk]
            mf.ref[lx, y4, x4] = ref
            mf.mv[lx, y4, x4] = mv
            mf.ref_id[lx, y4, x4] = rid

    def mark(self, blocks, mbx4, mby4):
        for blk in blocks:
            self.mf.done[mby4 + BLK_Y[blk], mbx4 + BLK_X[blk]] = True

    def macroblock(self, mb: int):
        row = self.table[mb]
        t = int(row[F_TYPE])
        sl = int(row[F_SLICE])
        s = self.slices[sl]
        mbx4, mby4 = 4 * (mb % self.mb_w), 4 * (mb // self.mb_w)
        allb = list(range(16))
        if t <= T_PCM:
            self.mark(allb, mbx4, mby4)
            return
        mvd = row[F_MVD:F_MVD + 64].reshape(2, 16, 2)
        refs = [[(int(row[F_REF0 + lx]) >> (8 * k)) & 0xFF for k in range(4)] for lx in range(2)]
        refs = [[r if r != 255 else -1 for r in rr] for rr in refs]
        if t == T_PSKIP:
            a, b, _ = self.neighbours(mbx4, mby4, 4, 0, sl)
            if not a[0] or not b[0] or (a[1] == 0 and a[2] == (0, 0)) or (b[1] == 0 and b[2] == (0, 0)):
                mv = (0, 0)
            else:
                mv = self.mvp(mbx4, mby4, 4, 4, 0, 0, sl)
            self.store(allb, mbx4, mby4, 0, 0, mv, s.ref_ids[0][0])
            self.mark(allb, mbx4, mby4)
            return
        if t in (T_BSKIP, T_BDIRECT):
            for k in range(4):
                self.direct(mb, k, s, sl, mbx4, mby4)
            return
        part = int(row[F_PART])
        if part != PART_8x8:
            pred = int(row[F_PRED])
            nparts = 1 if part == PART_16x16 else 2
            shape = (None, "16x8", "8x16")[part]
            for j in range(nparts):
                flags = (pred >> (2 * j)) & 3
                blocks = part_blocks(part, j)
                x4, y4 = mbx4 + BLK_X[blocks[0]], mby4 + BLK_Y[blocks[0]]
                w4 = 4 if part == 1 or part == 0 else 2
                h4 = 4 if part in (0, 2) else 2
                for lx in range(2):
                    if flags >> lx & 1:
                        ref = refs[lx][blocks[0] >> 2]
                        p = self.mvp(x4, y4, w4, h4, lx, ref, sl, shape, j)
                        d = mvd[lx, blocks[0]]
                        mv = (p[0] + int(d[0]), p[1] + int(d[1]))
                        self.store(blocks, mbx4, mby4, lx, ref, mv, s.ref_ids[lx][ref])
                self.mark(blocks, mbx4, mby4)
            return
        sub = int(row[F_SUB])
        for k in range(4):
            code = (sub >> (5 * k)) & 31
            if code == SUB_DIRECT:
                self.direct(mb, k, s, sl, mbx4, mby4)
                continue
            shape = code & 3
            for j in range(SUB_PARTS[shape]):
                blocks = sub_blocks(k, shape, j)
                x4, y4 = mbx4 + BLK_X[blocks[0]], mby4 + BLK_Y[blocks[0]]
                w4 = 2 if shape in (0, 1) else 1
                h4 = 2 if shape in (0, 2) else 1
                for lx in range(2):
                    if (code >> 2) >> lx & 1:
                        ref = refs[lx][k]
                        p = self.mvp(x4, y4, w4, h4, lx, ref, sl)
                        d = mvd[lx, blocks[0]]
                        mv = (p[0] + int(d[0]), p[1] + int(d[1]))
                        self.store(blocks, mbx4, mby4, lx, ref, mv, s.ref_ids[lx][ref])
                self.mark(blocks, mbx4, mby4)

    # ---- direct prediction
    def colocated(self, x4: int, y4: int):
        """(mvCol, refIdxCol, refIdCol) of the co-located 4x4 block."""
        col = self.col
        if int(col.ref[0, y4, x4]) >= 0:
            lx = 0
        elif int(col.ref[1, y4, x4]) >= 0:
            lx = 1
        else:
            return (0, 0), -1, -1
        return (int(col.mv[lx, y4, x4, 0]), int(col.mv[lx, y4, x4, 1])), int(col.ref[lx, y4, x4]), \
            int(col.ref_id[lx, y4, x4])

    def direct(self, mb: int, k: int, s: SliceInfo, sl: int, mbx4: int, mby4: int):
        blocks = [4 * k + i for i in range(4)]
        if s.direct_spatial:
            if self._spatial[0] != mb:
                self._spatial = (mb, self.spatial_refs(mbx4, mby4, s, sl))
            refs, mvps = self._spatial[1]
            col_long = self.slices[sl].ref_long[1][0]
            for blk in blocks:
                bx, by = BLK_X[blk], BLK_Y[blk]
                if s.direct8:
                    cx, cy = (3 if bx >= 2 else 0), (3 if by >= 2 else 0)
                else:
                    cx, cy = bx, by
                mvc, refc, _ = self.colocated(mbx4 + cx, mby4 + cy)
                zero = not col_long and refc == 0 and -1 <= mvc[0] <= 1 and -1 <= mvc[1] <= 1
                for lx in range(2):
                    r = refs[lx]
                    if r < 0:
                        continue
                    mv = (0, 0) if (r == 0 and zero) or refs == [-1, -1] else mvps[lx]
                    self.store([blk], mbx4, mby4, lx, r, mv, s.ref_ids[lx][r])
                if refs[0] < 0 and refs[1] < 0:
                    self.store([blk], mbx4, mby4, 0, 0, (0, 0), s.ref_ids[0][0])
                    self.store([blk], mbx4, mby4, 1, 0, (0, 0), s.ref_ids[1][0])
        else:
            for blk in blocks:
                bx, by = BLK_X[blk], BLK_Y[blk]
                if s.direct8:
                    cx, cy = (3 if bx >= 2 else 0), (3 if by >= 2 else 0)
                else:
                    cx, cy = bx, by
                mvc, refc, ridc = self.colocated(mbx4 + cx, mby4 + cy)
                if refc < 0:
                    r0 = 0
                else:
                    ids = s.ref_ids[0]
                    if ridc not in ids:
                        raise ValueError(f"temporal direct: the co-located block's reference (picture {ridc}) is "
                                         "not in the current list 0")
                    r0 = ids.index(ridc)
                poc0, poc1 = s.ref_pocs[0][r0], s.ref_pocs[1][0]
                td = max(-128, min(127, poc1 - poc0))
                if td == 0 or s.ref_long[0][r0]:
                    mv0, mv1 = mvc, (0, 0)
                else:
                    tb = max(-128, min(127, self.poc - poc0))
                    tx = cdiv(16384 + abs(cdiv(td, 2)), td)
                    dsf = max(-1024, min(1023, (tb * tx + 32) >> 6))
                    mv0 = ((dsf * mvc[0] + 128) >> 8, (dsf * mvc[1] + 128) >> 8)
                    mv1 = (mv0[0] - mvc[0], mv0[1] - mvc[1])
                self.store([blk], mbx4, mby4, 0, r0, mv0, s.ref_ids[0][r0])
                self.store([blk], mbx4, mby4, 1, 0, mv1, s.ref_ids[1][0])
        self.mark(blocks, mbx4, mby4)

    def spatial_refs(self, mbx4, mby4, s, sl):
        refs, mvps = [], []
        for lx in range(2):
            a, b, c = self.neighbours(mbx4, mby4, 4, lx, sl)
            pos = [n[1] for n in (a, b, c) if n[1] >= 0]
            refs.append(min(pos) if pos else -1)
        for lx in range(2):
            mvps.append(self.mvp(mbx4, mby4, 4, 4, lx, refs[lx], sl) if refs[lx] >= 0 else (0, 0))
        return refs, mvps


# ------------------------------------------------------------------ inter prediction


def _taps(a, axis):
    """The 6-tap sums along ``axis`` of every window of 6 (unclipped)."""
    n = a.shape[axis] - 5
    t = [np.take(a, range(k, k + n), axis=axis) for k in range(6)]
    return t[0] - 5 * t[1] + 20 * t[2] + 20 * t[3] - 5 * t[4] + t[5]


def luma_pred(refs: np.ndarray, slot: np.ndarray, x: np.ndarray, y: np.ndarray, mvx: np.ndarray,
              mvy: np.ndarray) -> np.ndarray:
    """Quarter-sample luma prediction (8.4.2.2.1) of 4x4 blocks at (x, y)
    from reference planes ``refs[slot]``: (N, 4, 4) int64."""
    h, w = refs.shape[1:]
    xi, yi = x + (mvx >> 2) - 2, y + (mvy >> 2) - 2
    cols = np.clip(xi[:, None] + np.arange(9)[None], 0, w - 1)
    rows = np.clip(yi[:, None] + np.arange(9)[None], 0, h - 1)
    win = refs[slot[:, None, None], rows[:, :, None], cols[:, None, :]].astype(np.int64)  # (N, 9, 9)
    b1 = _taps(win, 2)  # (N, 9, 4): horizontal half samples, rows -2..6
    h1 = _taps(win, 1)  # (N, 4, 9): vertical half samples, cols -2..6
    j1 = _taps(b1, 1)  # (N, 4, 4)
    G = win[:, 2:6, 2:6]
    b = clip1((b1[:, 2:6, :] + 16) >> 5)
    s = clip1((b1[:, 3:7, :] + 16) >> 5)
    hh = clip1((h1[:, :, 2:6] + 16) >> 5)
    m = clip1((h1[:, :, 3:7] + 16) >> 5)
    j = clip1((j1 + 512) >> 10)
    Hn = win[:, 2:6, 3:7]
    M = win[:, 3:7, 2:6]
    fx, fy = (mvx & 3)[:, None, None], (mvy & 3)[:, None, None]
    avg = lambda p, q: (p + q + 1) >> 1  # noqa: E731
    cases = {
        (0, 0): G, (0, 1): avg(G, hh), (0, 2): hh, (0, 3): avg(M, hh),
        (1, 0): avg(G, b), (1, 1): avg(b, hh), (1, 2): avg(hh, j), (1, 3): avg(hh, s),
        (2, 0): b, (2, 1): avg(b, j), (2, 2): j, (2, 3): avg(j, s),
        (3, 0): avg(Hn, b), (3, 1): avg(b, m), (3, 2): avg(j, m), (3, 3): avg(m, s),
    }
    out = np.zeros_like(G)
    for (cx, cy), v in cases.items():
        sel = (fx == cx) & (fy == cy)
        out = np.where(sel, v, out)
    return out


def chroma_pred(refs: np.ndarray, slot, x, y, mvx, mvy) -> np.ndarray:
    """Eighth-sample chroma prediction (8.4.2.2.2) of 2x2 blocks at chroma
    (x, y): (N, 2, 2) int64."""
    h, w = refs.shape[1:]
    xi, yi = x + (mvx >> 3), y + (mvy >> 3)
    cols = np.clip(xi[:, None] + np.arange(3)[None], 0, w - 1)
    rows = np.clip(yi[:, None] + np.arange(3)[None], 0, h - 1)
    win = refs[slot[:, None, None], rows[:, :, None], cols[:, None, :]].astype(np.int64)
    fx, fy = (mvx & 7)[:, None, None], (mvy & 7)[:, None, None]
    A, B, C, D = win[:, :2, :2], win[:, :2, 1:], win[:, 1:, :2], win[:, 1:, 1:]
    return ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B + (8 - fx) * fy * C + fx * fy * D + 32) >> 6


def weigh(p0, p1, use0, use1, w0, o0, w1, o1, denom, mode):
    """Weighted sample prediction (8.4.2.3) per block: ``mode`` 0 default,
    1 explicit, 2 implicit (bi-predicted blocks only), arrays per block."""
    sh = (slice(None),) + (None,) * (p0.ndim - 1)
    use0, use1, mode = use0[sh], use1[sh], mode[sh]
    w0, o0, w1, o1, denom = w0[sh], o0[sh], w1[sh], o1[sh], denom[sh]
    both = use0 & use1
    default = np.where(both, (p0 + p1 + 1) >> 1, np.where(use0, p0, p1))
    single_p = np.where(use0, p0, p1)
    single_w = np.where(use0, w0, w1)
    single_o = np.where(use0, o0, o1)
    rnd = np.where(denom >= 1, 1 << np.maximum(denom - 1, 0), 0)
    single = np.where(denom >= 1, ((single_p * single_w + rnd) >> denom) + single_o, single_p * single_w + single_o)
    bi = ((p0 * w0 + p1 * w1 + (1 << denom)) >> (denom + 1)) + ((o0 + o1 + 1) >> 1)
    weighted = np.where(both, bi, single)
    use = (mode == 1) | ((mode == 2) & both)
    return clip1(np.where(use, weighted, default))


def implicit_weight(s: SliceInfo, r0: int, r1: int, poc: int) -> int:
    """w1 of implicit bi-prediction (w0 = 64 - w1)."""
    p0, p1 = s.ref_pocs[0][r0], s.ref_pocs[1][r1]
    if s.ref_long[0][r0] or s.ref_long[1][r1]:
        return 32
    td = max(-128, min(127, p1 - p0))
    if td == 0:
        return 32
    tb = max(-128, min(127, poc - p0))
    tx = cdiv(16384 + abs(td) // 2, td)
    dsf = (tb * tx + 32) >> 8
    return dsf if -64 <= dsf <= 128 else 32


def inter_predict(table, mf: MotionField, slices, refs: dict, mb_w: int, mb_h: int, poc: int, chroma: bool):
    """Predictions of every inter macroblock's 4x4 blocks: (n, 16, 16) luma
    and (n, 2, 8, 8) chroma int64 (zero for intra macroblocks)."""
    n = len(table)
    typ = table[:, F_TYPE]
    inter = np.flatnonzero(typ > T_PCM)
    pred_y = np.zeros((n, 16, 16), np.int64)
    pred_c = np.zeros((n, 2, 8, 8), np.int64)
    if not len(inter):
        return pred_y, pred_c
    ids = sorted(refs)
    slot_of = {pid: k for k, pid in enumerate(ids)}
    stack_y = np.stack([refs[p].y for p in ids])
    stack_u = np.stack([refs[p].u for p in ids]) if chroma else None
    stack_v = np.stack([refs[p].v for p in ids]) if chroma else None
    mbs = np.repeat(inter, 16)
    blk = np.tile(np.arange(16), len(inter))
    bx = np.array(BLK_X)[blk]
    by = np.array(BLK_Y)[blk]
    x4 = 4 * (mbs % mb_w) + bx
    y4 = 4 * (mbs // mb_w) + by
    N = len(mbs)
    preds_y, preds_c = [], []
    use = [mf.ref[lx, y4, x4] >= 0 for lx in range(2)]
    for lx in range(2):
        rid = mf.ref_id[lx, y4, x4]
        slot = np.array([slot_of.get(int(r), 0) for r in rid], np.int64)
        mvx, mvy = mf.mv[lx, y4, x4, 0].astype(np.int64), mf.mv[lx, y4, x4, 1].astype(np.int64)
        py = luma_pred(stack_y, slot, 4 * x4, 4 * y4, mvx, mvy)
        preds_y.append(py)
        if chroma:
            preds_c.append([chroma_pred(st, slot, 2 * x4, 2 * y4, mvx, mvy) for st in (stack_u, stack_v)])
    # weights per block
    sl = table[mbs, F_SLICE]
    mode = np.array([slices[s].weighted for s in sl], np.int64)
    r0, r1 = mf.ref[0, y4, x4], mf.ref[1, y4, x4]
    params = np.zeros((N, 3, 5), np.int64)  # per plane: w0, o0, w1, o1, denom
    for i in range(N):
        s = slices[int(sl[i])]
        if s.weighted == 1:
            for p in range(3):
                denom = s.luma_denom if p == 0 else s.chroma_denom
                w0 = o0 = w1 = o1 = 0
                if r0[i] >= 0:
                    w0, o0 = s.weights[0][r0[i]][2 * p:2 * p + 2]
                if r1[i] >= 0:
                    w1, o1 = s.weights[1][r1[i]][2 * p:2 * p + 2]
                params[i, p] = (w0, o0, w1, o1, denom)
        elif s.weighted == 2 and r0[i] >= 0 and r1[i] >= 0:
            w1 = implicit_weight(s, int(r0[i]), int(r1[i]), poc)
            params[i, :] = (64 - w1, 0, w1, 0, 5)
    out_y = weigh(preds_y[0], preds_y[1], use[0], use[1], *params[:, 0].T, mode)
    for k in range(16):
        b = np.arange(len(inter)) * 16 + k
        yy, xx = 4 * BLK_Y[k], 4 * BLK_X[k]
        pred_y[inter, yy:yy + 4, xx:xx + 4] = out_y[b]
        if chroma:
            for c in range(2):
                oc = weigh(preds_c[0][c][b], preds_c[1][c][b], use[0][b], use[1][b], *params[b, 1 + c].T, mode[b])
                pred_c[inter, c, 2 * BLK_Y[k]:2 * BLK_Y[k] + 2, 2 * BLK_X[k]:2 * BLK_X[k] + 2] = oc
    return pred_y, pred_c


# ------------------------------------------------------------------ intra prediction


def intra4_pred(mode: int, top, left, topleft, topright_ok: bool) -> np.ndarray:
    """Intra_4x4 (8.3.1.2) from p[x, -1] x = 0..7 (``top``, None when not
    available; the last four substituted when ``topright_ok`` is False),
    p[-1, y] (``left``) and p[-1, -1]."""
    if top is not None:
        top = np.array(top, np.int64)
        if not topright_ok:
            top[4:] = top[3]
    if left is not None:
        left = np.array(left, np.int64)
    P = np.zeros((4, 4), np.int64)
    if mode == 0:
        P[:] = top[None, :4]
    elif mode == 1:
        P[:] = left[:, None]
    elif mode == 2:
        if top is not None and left is not None:
            P[:] = (top[:4].sum() + left.sum() + 4) >> 3
        elif left is not None:
            P[:] = (left.sum() + 2) >> 2
        elif top is not None:
            P[:] = (top[:4].sum() + 2) >> 2
        else:
            P[:] = 128
    elif mode == 3:
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    P[y, x] = (top[6] + 3 * top[7] + 2) >> 2
                else:
                    P[y, x] = (top[x + y] + 2 * top[x + y + 1] + top[x + y + 2] + 2) >> 2
    else:
        # p[-1..3 on the top row / left column] by one index: t(x) = p[x, -1], l(y) = p[-1, y], with -1 the corner
        def t(i):
            return topleft if i < 0 else top[i]

        def l(i):
            return topleft if i < 0 else left[i]

        for y in range(4):
            for x in range(4):
                if mode == 4:
                    if x > y:
                        v = (t(x - y - 2) + 2 * t(x - y - 1) + t(x - y) + 2) >> 2
                    elif x < y:
                        v = (l(y - x - 2) + 2 * l(y - x - 1) + l(y - x) + 2) >> 2
                    else:
                        v = (t(0) + 2 * topleft + l(0) + 2) >> 2
                elif mode == 5:
                    z = 2 * x - y
                    if z >= 0 and z % 2 == 0:
                        v = (t(x - (y >> 1) - 1) + t(x - (y >> 1)) + 1) >> 1
                    elif z >= 0:
                        v = (t(x - (y >> 1) - 2) + 2 * t(x - (y >> 1) - 1) + t(x - (y >> 1)) + 2) >> 2
                    elif z == -1:
                        v = (l(0) + 2 * topleft + t(0) + 2) >> 2
                    else:
                        v = (l(y - 1) + 2 * l(y - 2) + l(y - 3) + 2) >> 2
                elif mode == 6:
                    z = 2 * y - x
                    if z >= 0 and z % 2 == 0:
                        v = (l(y - (x >> 1) - 1) + l(y - (x >> 1)) + 1) >> 1
                    elif z >= 0:
                        v = (l(y - (x >> 1) - 2) + 2 * l(y - (x >> 1) - 1) + l(y - (x >> 1)) + 2) >> 2
                    elif z == -1:
                        v = (l(0) + 2 * topleft + t(0) + 2) >> 2
                    else:
                        v = (t(x - 1) + 2 * t(x - 2) + t(x - 3) + 2) >> 2
                elif mode == 7:
                    if y % 2 == 0:
                        v = (t(x + (y >> 1)) + t(x + (y >> 1) + 1) + 1) >> 1
                    else:
                        v = (t(x + (y >> 1)) + 2 * t(x + (y >> 1) + 1) + t(x + (y >> 1) + 2) + 2) >> 2
                else:  # 8: horizontal up
                    z = x + 2 * y
                    if z < 5 and z % 2 == 0:
                        v = (l(y + (x >> 1)) + l(y + (x >> 1) + 1) + 1) >> 1
                    elif z < 5:
                        v = (l(y + (x >> 1)) + 2 * l(y + (x >> 1) + 1) + l(y + (x >> 1) + 2) + 2) >> 2
                    elif z == 5:
                        v = (l(2) + 3 * l(3) + 2) >> 2
                    else:
                        v = l(3)
                P[y, x] = v
    return P


def intra8_pred(mode: int, top, left, topleft, topright_ok: bool) -> np.ndarray:
    """Intra_8x8 (8.3.2.2) with the reference sample filter: ``top`` p[x, -1]
    x = 0..15 or None, ``left`` p[-1, y] y = 0..7 or None, ``topleft`` or
    None."""
    if top is not None:
        top = np.array(top, np.int64)
        if not topright_ok:
            top[8:] = top[7]
    if left is not None:
        left = np.array(left, np.int64)
    ft = fl = ftl = None
    if top is not None:
        ft = np.zeros(16, np.int64)
        ft[0] = ((topleft + 2 * top[0] + top[1] + 2) >> 2) if topleft is not None else ((3 * top[0] + top[1] + 2) >> 2)
        ft[1:15] = (top[:14] + 2 * top[1:15] + top[2:16] + 2) >> 2
        ft[15] = (top[14] + 3 * top[15] + 2) >> 2
    if topleft is not None:
        if top is not None and left is not None:
            ftl = (top[0] + 2 * topleft + left[0] + 2) >> 2
        elif top is not None:
            ftl = (3 * topleft + top[0] + 2) >> 2
        elif left is not None:
            ftl = (3 * topleft + left[0] + 2) >> 2
        else:
            ftl = topleft
    if left is not None:
        fl = np.zeros(8, np.int64)
        fl[0] = ((topleft + 2 * left[0] + left[1] + 2) >> 2) if topleft is not None else ((3 * left[0] + left[1] + 2) >> 2)
        fl[1:7] = (left[:6] + 2 * left[1:7] + left[2:8] + 2) >> 2
        fl[7] = (left[6] + 3 * left[7] + 2) >> 2
    P = np.zeros((8, 8), np.int64)

    def t(i):
        return ftl if i < 0 else ft[i]

    def l(i):
        return ftl if i < 0 else fl[i]

    if mode == 0:
        P[:] = ft[None, :8]
    elif mode == 1:
        P[:] = fl[:, None]
    elif mode == 2:
        if ft is not None and fl is not None:
            P[:] = (ft[:8].sum() + fl.sum() + 8) >> 4
        elif fl is not None:
            P[:] = (fl.sum() + 4) >> 3
        elif ft is not None:
            P[:] = (ft[:8].sum() + 4) >> 3
        else:
            P[:] = 128
    else:
        for y in range(8):
            for x in range(8):
                if mode == 3:
                    v = (ft[14] + 3 * ft[15] + 2) >> 2 if x == 7 and y == 7 else \
                        (ft[x + y] + 2 * ft[x + y + 1] + ft[x + y + 2] + 2) >> 2
                elif mode == 4:
                    if x > y:
                        v = (t(x - y - 2) + 2 * t(x - y - 1) + t(x - y) + 2) >> 2
                    elif x < y:
                        v = (l(y - x - 2) + 2 * l(y - x - 1) + l(y - x) + 2) >> 2
                    else:
                        v = (t(0) + 2 * ftl + l(0) + 2) >> 2
                elif mode == 5:
                    z = 2 * x - y
                    if z >= 0 and z % 2 == 0:
                        v = (t(x - (y >> 1) - 1) + t(x - (y >> 1)) + 1) >> 1
                    elif z >= 0:
                        v = (t(x - (y >> 1) - 2) + 2 * t(x - (y >> 1) - 1) + t(x - (y >> 1)) + 2) >> 2
                    elif z == -1:
                        v = (l(0) + 2 * ftl + t(0) + 2) >> 2
                    else:
                        v = (l(y - 2 * x - 1) + 2 * l(y - 2 * x - 2) + l(y - 2 * x - 3) + 2) >> 2
                elif mode == 6:
                    z = 2 * y - x
                    if z >= 0 and z % 2 == 0:
                        v = (l(y - (x >> 1) - 1) + l(y - (x >> 1)) + 1) >> 1
                    elif z >= 0:
                        v = (l(y - (x >> 1) - 2) + 2 * l(y - (x >> 1) - 1) + l(y - (x >> 1)) + 2) >> 2
                    elif z == -1:
                        v = (l(0) + 2 * ftl + t(0) + 2) >> 2
                    else:
                        v = (t(x - 2 * y - 1) + 2 * t(x - 2 * y - 2) + t(x - 2 * y - 3) + 2) >> 2
                elif mode == 7:
                    if y % 2 == 0:
                        v = (t(x + (y >> 1)) + t(x + (y >> 1) + 1) + 1) >> 1
                    else:
                        v = (t(x + (y >> 1)) + 2 * t(x + (y >> 1) + 1) + t(x + (y >> 1) + 2) + 2) >> 2
                else:
                    z = x + 2 * y
                    if z < 13 and z % 2 == 0:
                        v = (l(y + (x >> 1)) + l(y + (x >> 1) + 1) + 1) >> 1
                    elif z < 13:
                        v = (l(y + (x >> 1)) + 2 * l(y + (x >> 1) + 1) + l(y + (x >> 1) + 2) + 2) >> 2
                    elif z == 13:
                        v = (l(6) + 3 * l(7) + 2) >> 2
                    else:
                        v = l(7)
                P[y, x] = v
    return P


def intra16_pred(mode: int, top, left, topleft) -> np.ndarray:
    P = np.zeros((16, 16), np.int64)
    if mode == 0:
        P[:] = np.asarray(top, np.int64)[None]
    elif mode == 1:
        P[:] = np.asarray(left, np.int64)[:, None]
    elif mode == 2:
        if top is not None and left is not None:
            P[:] = (int(np.sum(top)) + int(np.sum(left)) + 16) >> 5
        elif left is not None:
            P[:] = (int(np.sum(left)) + 8) >> 4
        elif top is not None:
            P[:] = (int(np.sum(top)) + 8) >> 4
        else:
            P[:] = 128
    else:
        t = np.asarray(top, np.int64)
        l = np.asarray(left, np.int64)
        H = sum((x + 1) * (int(t[8 + x]) - int(t[6 - x] if x < 7 else topleft)) for x in range(8))
        V = sum((y + 1) * (int(l[8 + y]) - int(l[6 - y] if y < 7 else topleft)) for y in range(8))
        a = 16 * (int(l[15]) + int(t[15]))
        b = (5 * H + 32) >> 6
        c = (5 * V + 32) >> 6
        yy, xx = np.mgrid[0:16, 0:16]
        P[:] = clip1((a + b * (xx - 7) + c * (yy - 7) + 16) >> 5)
    return P


def chroma_intra_pred(mode: int, top, left, topleft) -> np.ndarray:
    """Intra chroma (8.3.4) of an 8x8 (4:2:0) block: mode 0 DC, 1
    horizontal, 2 vertical, 3 plane."""
    P = np.zeros((8, 8), np.int64)
    if mode == 0:
        for by in range(2):
            for bx in range(2):
                tt = None if top is None else int(np.sum(top[4 * bx:4 * bx + 4]))
                ll = None if left is None else int(np.sum(left[4 * by:4 * by + 4]))
                if (bx, by) in ((0, 0), (1, 1)):
                    if tt is not None and ll is not None:
                        v = (tt + ll + 4) >> 3
                    elif ll is not None:
                        v = (ll + 2) >> 2
                    elif tt is not None:
                        v = (tt + 2) >> 2
                    else:
                        v = 128
                elif bx == 1:  # top-right block: top first
                    v = (tt + 2) >> 2 if tt is not None else ((ll + 2) >> 2 if ll is not None else 128)
                else:  # bottom-left block: left first
                    v = (ll + 2) >> 2 if ll is not None else ((tt + 2) >> 2 if tt is not None else 128)
                P[4 * by:4 * by + 4, 4 * bx:4 * bx + 4] = v
    elif mode == 1:
        P[:] = np.asarray(left, np.int64)[:, None]
    elif mode == 2:
        P[:] = np.asarray(top, np.int64)[None]
    else:
        t = np.asarray(top, np.int64)
        l = np.asarray(left, np.int64)
        H = sum((x + 1) * (int(t[4 + x]) - int(t[2 - x] if x < 3 else topleft)) for x in range(4))
        V = sum((y + 1) * (int(l[4 + y]) - int(l[2 - y] if y < 3 else topleft)) for y in range(4))
        a = 16 * (int(l[7]) + int(t[7]))
        b = (34 * H + 32) >> 6
        c = (34 * V + 32) >> 6
        yy, xx = np.mgrid[0:8, 0:8]
        P[:] = clip1((a + b * (xx - 3) + c * (yy - 3) + 16) >> 5)
    return P


class IntraRecon:
    """Intra macroblocks of one picture, one by one, on the picture's planes."""

    def __init__(self, table, slices, Y, U, V, mb_w, mb_h):
        self.table, self.slices = table, slices
        self.Y, self.U, self.V = Y, U, V
        self.mb_w, self.mb_h = mb_w, mb_h

    def ok(self, mb: int, nb: int) -> bool:
        """Whether macroblock ``nb`` is available for intra prediction of ``mb``."""
        if nb < 0:
            return False
        t = self.table
        if t[nb, F_SLICE] != t[mb, F_SLICE] or nb > mb:
            return False
        if self.slices[int(t[mb, F_SLICE])].cip and t[nb, F_TYPE] > T_PCM:
            return False
        return True

    def neighbours(self, mb):
        w = self.mb_w
        x, y = mb % w, mb // w
        a = mb - 1 if x > 0 else -1
        b = mb - w if y > 0 else -1
        c = mb - w + 1 if y > 0 and x < w - 1 else -1
        d = mb - w - 1 if y > 0 and x > 0 else -1
        return [self.ok(mb, n) for n in (a, b, c, d)]

    def macroblock(self, mb: int, res_y, res_c, levels):
        row = self.table[mb]
        t = int(row[F_TYPE])
        X, Yp = 16 * (mb % self.mb_w), 16 * (mb // self.mb_w)
        Y = self.Y
        if t == T_PCM:
            Y[Yp:Yp + 16, X:X + 16] = levels[:256].reshape(16, 16)
            if self.U is not None:
                self.U[Yp // 2:Yp // 2 + 8, X // 2:X // 2 + 8] = levels[256:320].reshape(8, 8)
                self.V[Yp // 2:Yp // 2 + 8, X // 2:X // 2 + 8] = levels[320:384].reshape(8, 8)
            return
        A, Bn, C, D = self.neighbours(mb)
        if t == T_I16:
            top = Y[Yp - 1, X:X + 16] if Bn else None
            left = Y[Yp:Yp + 16, X - 1] if A else None
            tl = int(Y[Yp - 1, X - 1]) if D else None
            mode = int(row[F_I16])
            if (mode == 0 and top is None) or (mode == 1 and left is None) or \
                    (mode == 3 and (top is None or left is None or tl is None)):
                raise ValueError(f"macroblock {mb}: Intra16x16 mode {mode} without its neighbours")
            P = intra16_pred(mode, top, left, tl)
            Y[Yp:Yp + 16, X:X + 16] = clip1(P + res_y)
        elif t == T_I4:
            modes = [((int(row[F_IM0]) >> (4 * b)) & 15) if b < 8 else ((int(row[F_IM1]) >> (4 * (b - 8))) & 15)
                     for b in range(16)]
            for b in range(16):
                bx, by = BLK_X[b], BLK_Y[b]
                x, y = X + 4 * bx, Yp + 4 * by
                has_top = by > 0 or Bn
                has_left = bx > 0 or A
                if by > 0 and bx > 0:
                    has_tl = True
                elif by > 0:
                    has_tl = A
                elif bx > 0:
                    has_tl = Bn
                else:
                    has_tl = D
                if by == 0:
                    has_tr = Bn if bx < 3 else C
                else:
                    has_tr = bx < 3 and BLK_AT[by - 1][bx + 1] < b
                top = None
                if has_top:
                    top = np.zeros(8, np.int64)
                    top[:4] = Y[y - 1, x:x + 4]
                    if has_tr:
                        top[4:] = Y[y - 1, x + 4:x + 8]
                left = Y[y:y + 4, x - 1] if has_left else None
                tl = int(Y[y - 1, x - 1]) if has_tl else None
                m = modes[b]
                need = {0: has_top, 1: has_left, 3: has_top, 7: has_top, 8: has_left,
                        4: has_top and has_left and has_tl, 5: has_top and has_left and has_tl,
                        6: has_top and has_left and has_tl}
                if not need.get(m, True):
                    raise ValueError(f"macroblock {mb}: Intra4x4 mode {m} of block {b} without its neighbours")
                P = intra4_pred(m, top, left, tl, has_tr)
                Y[y:y + 4, x:x + 4] = clip1(P + res_y[4 * by:4 * by + 4, 4 * bx:4 * bx + 4])
        elif t == T_I8:
            modes = [(int(row[F_IM0]) >> (4 * 4 * k)) & 15 if k < 2 else (int(row[F_IM1]) >> (4 * 4 * (k - 2))) & 15
                     for k in range(4)]
            for k in range(4):
                bx, by = k & 1, k >> 1
                x, y = X + 8 * bx, Yp + 8 * by
                has_top = by > 0 or Bn
                has_left = bx > 0 or A
                has_tl = True if (bx and by) else (A if by else (Bn if bx else D))
                has_tr = (Bn if bx == 0 else C) if by == 0 else (bx == 0)
                top = None
                if has_top:
                    top = np.zeros(16, np.int64)
                    top[:8] = Y[y - 1, x:x + 8]
                    if has_tr:
                        top[8:] = Y[y - 1, x + 8:x + 16]
                left = Y[y:y + 8, x - 1] if has_left else None
                tl = int(Y[y - 1, x - 1]) if has_tl else None
                m = modes[k]
                need = {0: has_top, 1: has_left, 3: has_top, 7: has_top, 8: has_left,
                        4: has_top and has_left and has_tl, 5: has_top and has_left and has_tl,
                        6: has_top and has_left and has_tl}
                if not need.get(m, True):
                    raise ValueError(f"macroblock {mb}: Intra8x8 mode {m} of block {k} without its neighbours")
                P = intra8_pred(m, top, left, tl, has_tr)
                Y[y:y + 8, x:x + 8] = clip1(P + res_y[8 * by:8 * by + 8, 8 * bx:8 * bx + 8])
        if self.U is None:
            return
        mode = int(row[F_CPRED])
        cx, cy = X // 2, Yp // 2
        for c, plane in enumerate((self.U, self.V)):
            top = plane[cy - 1, cx:cx + 8] if Bn else None
            left = plane[cy:cy + 8, cx - 1] if A else None
            tl = int(plane[cy - 1, cx - 1]) if D else None
            if (mode == 1 and left is None) or (mode == 2 and top is None) or \
                    (mode == 3 and (top is None or left is None or tl is None)):
                raise ValueError(f"macroblock {mb}: intra chroma mode {mode} without its neighbours")
            P = chroma_intra_pred(mode, top, left, tl)
            plane[cy:cy + 8, cx:cx + 8] = clip1(P + res_c[c])


def recon_picture(table: np.ndarray, levels: np.ndarray, slices: List[SliceInfo], mb_w: int, mb_h: int,
                  refs: dict, col: Optional[RefPicture], poc: int, chroma: bool):
    """One picture: -> (Y, U, V uint8 planes (U, V None for 4:0:0), its
    MotionField)."""
    n = mb_w * mb_h
    mvp = MvPredictor(table, slices, mb_w, mb_h, col, poc)
    for mb in range(n):
        mvp.macroblock(mb)
    mf = mvp.mf
    res_y, res_c = residuals(table, levels, slices, chroma)
    pred_y, pred_c = inter_predict(table, mf, slices, refs, mb_w, mb_h, poc, chroma)
    Y = np.zeros((16 * mb_h, 16 * mb_w), np.uint8)
    U = np.zeros((8 * mb_h, 8 * mb_w), np.uint8) if chroma else None
    V = np.zeros((8 * mb_h, 8 * mb_w), np.uint8) if chroma else None
    typ = table[:, F_TYPE]
    inter_y = clip1(pred_y + res_y).astype(np.uint8)
    inter_c = clip1(pred_c + res_c).astype(np.uint8)
    for mb in np.flatnonzero(typ > T_PCM):
        X, Yp = 16 * (mb % mb_w), 16 * (mb // mb_w)
        Y[Yp:Yp + 16, X:X + 16] = inter_y[mb]
        if chroma:
            U[Yp // 2:Yp // 2 + 8, X // 2:X // 2 + 8] = inter_c[mb, 0]
            V[Yp // 2:Yp // 2 + 8, X // 2:X // 2 + 8] = inter_c[mb, 1]
    intra = IntraRecon(table, slices, Y, U, V, mb_w, mb_h)
    for mb in np.flatnonzero(typ <= T_PCM):
        intra.macroblock(int(mb), res_y[mb], res_c[mb], levels[mb].astype(np.int64) & 0xFF)
    return Y, U, V, mf
