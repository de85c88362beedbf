"""AV1's three loop filters in plain numpy (sections 7.14, 7.15 and 7.17 of
the AV1 specification, with libaom 3.14's edge decisions): the deblocking
filter, CDEF and loop restoration.

:func:`deblock` filters every vertical edge of a plane, then every
horizontal one (4-, 6-, 8- and 14-sample filters; libaom's rule for which
transform edges of skipped inter blocks are left alone and for the level of
an edge whose block has level 0); filters of one pass never overlap, so a
pass is one vector operation. :func:`cdef` finds each 8x8 luma block's
direction and variance on the deblocked frame and runs the primary and
secondary taps over each plane's 8x8 (or 4x4 chroma) blocks, skipping the
blocks whose four mi units all skip and the 64x64 blocks whose index is -1.
:func:`loop_restore` runs the Wiener and self-guided filters of each
restoration unit over 64-row stripes offset by 8, reading the deblocked
frame's rows beyond each stripe boundary (two of them, then repeated) and
the CDEF output inside. Every function takes and returns int planes of the
reconstruction's layout (``av1_recon.plane_dims``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from dspnet_torch.data import av1_tables as T
from dspnet_torch.data.av1_obu import SEG_LVL_ALT_LF_Y_V
from dspnet_torch.data.av1_parse import Parsed, plane_residual_size

_BLOCK_W = np.array(T.BLOCK_W + (0,), np.int64)
_BLOCK_H = np.array(T.BLOCK_H + (0,), np.int64)
_TX_W = np.array(T.TX_W, np.int64)
_TX_H = np.array(T.TX_H, np.int64)
_TX_WL = np.array(T.TX_W_LOG2, np.int64)
_TX_HL = np.array(T.TX_H_LOG2, np.int64)


def _plane_sub(parsed: Parsed, p: int):
    s = parsed.frame.seq
    return (s.ssx, s.ssy) if p else (0, 0)


# -- deblocking -------------------------------------------------------------------

def filter_levels(parsed: Parsed, p: int, d: int) -> np.ndarray:
    """The loop filter level of every mi unit for plane ``p`` and pass ``d``
    (0 vertical edges, 1 horizontal)."""
    h = parsed.frame.hdr
    i = d if p == 0 else p + 1
    base = np.full(parsed.mi_size.shape, h.lf_level[i], np.int64)
    if h.delta_lf_present:
        k = i if h.delta_lf_multi else 0
        base = np.clip(parsed.delta_lf[..., k].astype(np.int64) + h.lf_level[i], 0, 63)
    lvl = base
    if h.seg_enabled:
        feat = SEG_LVL_ALT_LF_Y_V + i
        add = np.array([h.feature_data[s][feat] if h.feature_enabled[s][feat] else 0 for s in range(8)], np.int64)
        lvl = np.clip(lvl + add[parsed.segment.astype(np.int64)], 0, 63)
    if h.lf_delta_enabled:
        lvl = np.clip(lvl + (h.lf_ref_deltas[0] << (lvl >> 5)), 0, 63)
    return lvl


def edge_table(parsed: Parsed, p: int, d: int) -> np.ndarray:
    """The edges of one pass: int64 rows (x, y, filter length, level) in the
    plane's samples, one per filtered 4-sample edge segment."""
    s, h = parsed.frame.seq, parsed.frame.hdr
    sx, sy = _plane_sub(parsed, p)
    R4, C4 = parsed.mi_size.shape[0] >> sy, parsed.mi_size.shape[1] >> sx
    r4, c4 = np.meshgrid(np.arange(R4), np.arange(C4), indexing="ij")
    row, col = (r4 << sy) | sy, (c4 << sx) | sx
    if d == 0:
        pr, pc = row, col - (1 << sx)
        on = ((c4 << sx) * 4 < h.width) & ((r4 << sy) * 4 < h.height) & (c4 > 0)
    else:
        pr, pc = row - (1 << sy), col
        on = ((c4 << sx) * 4 < h.width) & ((r4 << sy) * 4 < h.height) & (r4 > 0)
    pr, pc = np.maximum(pr, 0), np.maximum(pc, 0)
    row = np.minimum(row, parsed.mi_size.shape[0] - 1)
    col = np.minimum(col, parsed.mi_size.shape[1] - 1)
    tx = parsed.tx_size_map[p][:R4, :C4].astype(np.int64)
    ptx = np.zeros_like(tx)
    if d == 0:
        ptx[:, 1:] = tx[:, :-1]
        coord = c4 * 4
        tdim, pdim, tsize = _TX_WL[tx], _TX_WL[ptx], _TX_W[tx]
    else:
        ptx[1:, :] = tx[:-1, :]
        coord = r4 * 4
        tdim, pdim, tsize = _TX_HL[tx], _TX_HL[ptx], _TX_H[tx]
    psize = np.array([plane_residual_size(b, sx, sy) if b < 22 else 22 for b in range(23)], np.int64)
    bsz = psize[parsed.mi_size[row, col].astype(np.int64)]
    block_edge = coord % (_BLOCK_W[bsz] if d == 0 else _BLOCK_H[bsz]) == 0
    tx_edge = coord % tsize == 0
    lv = filter_levels(parsed, p, d)
    cur_l, prev_l = lv[row, col], lv[pr, pc]
    cur_s, prev_s = parsed.skip_inter[row, col], parsed.skip_inter[pr, pc]
    apply = on & tx_edge & ((cur_l > 0) | (prev_l > 0)) & (~prev_s | ~cur_s | block_edge)
    dim = np.minimum(tdim, pdim) - 2
    if p == 0:
        length = np.array([4, 8, 14, 14, 14], np.int64)[np.clip(dim, 0, 4)]
    else:
        length = np.where(dim == 0, 4, 6)
    level = np.where(cur_l > 0, cur_l, prev_l)
    k = np.nonzero(apply)
    return np.stack([c4[k] * 4, r4[k] * 4, length[k], level[k]], axis=1).astype(np.int64).reshape(-1, 4)


def filter_lines(lines: np.ndarray, length: np.ndarray, level: np.ndarray, sharpness: int, bd: int) -> np.ndarray:
    """The deblocking filter of ``lines`` (n, 14): samples p6 .. p0, q0 ..
    q6 across an edge, with each line's filter length and level -> the new
    samples."""
    v = lines.astype(np.int64)
    P = [v[:, 6 - k] for k in range(7)]
    Q = [v[:, 7 + k] for k in range(7)]
    shift = 2 if sharpness > 4 else 1 if sharpness > 0 else 0
    lim = level >> shift
    if sharpness > 0:
        lim = np.minimum(lim, 9 - sharpness)
    lim = np.maximum(lim, 1)
    blim = 2 * (level + 2) + lim
    thr = level >> 4
    sh = bd - 8
    lim, blim, thr = lim << sh, blim << sh, thr << sh
    one = 1 << sh
    ad = lambda a, b: np.abs(a - b)
    hev = (ad(P[1], P[0]) > thr) | (ad(Q[1], Q[0]) > thr)
    mask = (ad(P[1], P[0]) <= lim) & (ad(Q[1], Q[0]) <= lim) & (ad(P[0], Q[0]) * 2 + ad(P[1], Q[1]) // 2 <= blim)
    m6 = mask & (ad(P[2], P[1]) <= lim) & (ad(Q[2], Q[1]) <= lim)
    m8 = m6 & (ad(P[3], P[2]) <= lim) & (ad(Q[3], Q[2]) <= lim)
    fmask = np.where(length == 4, mask, np.where(length == 6, m6, m8))
    flat6 = (ad(P[1], P[0]) <= one) & (ad(Q[1], Q[0]) <= one) & (ad(P[2], P[0]) <= one) & (ad(Q[2], Q[0]) <= one)
    flat8 = flat6 & (ad(P[3], P[0]) <= one) & (ad(Q[3], Q[0]) <= one)
    flat = np.where(length == 6, flat6, flat8)
    flat2 = ((ad(P[6], P[0]) <= one) & (ad(Q[6], Q[0]) <= one) & (ad(P[5], P[0]) <= one) & (ad(Q[5], Q[0]) <= one)
             & (ad(P[4], P[0]) <= one) & (ad(Q[4], Q[0]) <= one))
    out = v.copy()
    # narrow filter
    lo, hi = -(1 << (bd - 1)), (1 << (bd - 1)) - 1
    c = lambda x: np.clip(x, lo, hi)
    off = 0x80 << sh
    ps1, ps0, qs0, qs1 = P[1] - off, P[0] - off, Q[0] - off, Q[1] - off
    f = np.where(hev, c(ps1 - qs1), 0)
    f = c(f + 3 * (qs0 - ps0))
    f1 = c(f + 4) >> 3
    f2 = c(f + 3) >> 3
    n_q0 = c(qs0 - f1) + off
    n_p0 = c(ps0 + f2) + off
    f3 = (f1 + 1) >> 1
    n_q1 = np.where(hev, Q[1], c(qs1 - f3) + off)
    n_p1 = np.where(hev, P[1], c(ps1 + f3) + off)
    narrow = fmask & ((length == 4) | ~flat)
    for col, val in ((5, n_p1), (6, n_p0), (7, n_q0), (8, n_q1)):
        out[:, col] = np.where(narrow, val, out[:, col])
    # wide filters
    F = {k: (P[-k - 1] if k < 0 else Q[k]) for k in range(-7, 7)}
    for log2, n, sel in ((3, 2, fmask & (length == 6) & flat), (3, 3, fmask & (length == 8) & flat),
                         (3, 3, fmask & (length == 14) & flat & ~flat2), (4, 6, fmask & (length == 14) & flat & flat2)):
        if not sel.any():
            continue
        n2 = 0 if (log2 == 3 and n == 3) else 1
        for i in range(-n, n):
            t = 0
            for j in range(-n, n + 1):
                pp = min(max(i + j, -(n + 1)), n)
                t = t + F[pp] * (2 if abs(j) <= n2 else 1)
            val = (t + (1 << (log2 - 1))) >> log2
            out[:, 7 + i] = np.where(sel, val, out[:, 7 + i])
    return out


def deblock_pass(parsed: Parsed, plane: np.ndarray, p: int, d: int) -> np.ndarray:
    """One pass (``d`` 0: vertical edges, 1: horizontal) over a plane."""
    h, s = parsed.frame.hdr, parsed.frame.seq
    edges = edge_table(parsed, p, d)
    out = plane.copy()
    if not len(edges):
        return out
    x, y, length, level = (edges[:, k] for k in range(4))
    i = np.arange(4)
    t = np.arange(-7, 7)
    if d == 0:
        ys = (y[:, None] + i[None, :]).reshape(-1)
        xs = x.repeat(4)
        rr = ys[:, None] + 0 * t[None, :]
        cc = np.clip(xs[:, None] + t[None, :], 0, plane.shape[1] - 1)
    else:
        xs = (x[:, None] + i[None, :]).reshape(-1)
        ys = y.repeat(4)
        rr = np.clip(ys[:, None] + t[None, :], 0, plane.shape[0] - 1)
        cc = xs[:, None] + 0 * t[None, :]
    lines = plane[rr, cc]
    new = filter_lines(lines, length.repeat(4), level.repeat(4), h.lf_sharpness, s.bit_depth)
    changed = new != lines
    out[rr[changed], cc[changed]] = new[changed]
    return out


def deblock(parsed: Parsed, planes: List[np.ndarray]) -> List[np.ndarray]:
    """The deblocking filter of the frame (every plane: vertical edges, then
    horizontal)."""
    h = parsed.frame.hdr
    out = [pl.copy() for pl in planes]
    if not (h.lf_level[0] or h.lf_level[1]):
        return out
    for p in range(len(planes)):
        if p and not h.lf_level[p + 1]:
            continue
        for d in (0, 1):
            out[p] = deblock_pass(parsed, out[p], p, d)
    return out


# -- CDEF ---------------------------------------------------------------------

_DIV_TABLE = (0, 840, 420, 280, 210, 168, 140, 120, 105)
_UV_DIR = {(0, 0): tuple(range(8)), (0, 1): (1, 2, 2, 2, 3, 4, 6, 0), (1, 0): (7, 0, 2, 4, 5, 6, 6, 6),
           (1, 1): tuple(range(8))}
#: Cdef_Directions as (row, col) steps
CDEF_DIRECTIONS = (((-1, 1), (-2, 2)), ((0, 1), (-1, 2)), ((0, 1), (0, 2)), ((0, 1), (1, 2)), ((1, 1), (2, 2)),
                   ((1, 0), (2, 1)), ((1, 0), (2, 0)), ((1, 0), (2, -1)))


def _direction_maps() -> np.ndarray:
    """(8, 64, 15) one-hot maps of each 8x8 position to its line in each
    direction (``cdef_find_dir``'s partial sums)."""
    m = np.zeros((8, 64, 15), np.int64)
    for i in range(8):
        for j in range(8):
            k = i * 8 + j
            for d, line in enumerate((i + j, i + j // 2, i, 3 + i - j // 2, 7 + i - j, 3 - i // 2 + j, j,
                                      i // 2 + j)):
                m[d, k, line] = 1
    return m


_DIR_MAPS = _direction_maps()


def cdef_directions(luma: np.ndarray, rows: np.ndarray, cols: np.ndarray, bd: int) -> tuple:
    """(direction, variance) of the 8x8 luma blocks at mi (rows, cols)."""
    n = len(rows)
    if not n:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    yy = (rows[:, None] * 4 + np.arange(8)[None, :])[:, :, None]
    xx = (cols[:, None] * 4 + np.arange(8)[None, :])[:, None, :]
    x = ((luma[yy, xx].astype(np.int64) >> (bd - 8)) - 128).reshape(n, 64)
    partial = np.einsum("nk,dkl->ndl", x, _DIR_MAPS)
    sq = partial * partial
    cost = np.zeros((n, 8), np.int64)
    div = np.array(_DIV_TABLE, np.int64)
    cost[:, 2] = sq[:, 2, :8].sum(1) * div[8]
    cost[:, 6] = sq[:, 6, :8].sum(1) * div[8]
    for d in (0, 4):
        for i in range(7):
            cost[:, d] += (sq[:, d, i] + sq[:, d, 14 - i]) * div[i + 1]
        cost[:, d] += sq[:, d, 7] * div[8]
    for d in (1, 3, 5, 7):
        cost[:, d] = sq[:, d, 3:8].sum(1) * div[8]
        for j in range(3):
            cost[:, d] += (sq[:, d, j] + sq[:, d, 10 - j]) * div[2 * j + 2]
    best = np.zeros(n, np.int64)
    best_cost = np.zeros(n, np.int64)
    for d in range(8):
        better = cost[:, d] > best_cost
        best = np.where(better, d, best)
        best_cost = np.where(better, cost[:, d], best_cost)
    opp = cost[np.arange(n), (best + 4) & 7]
    return best, (best_cost - opp) >> 10


def cdef_blocks(parsed: Parsed, planes: List[np.ndarray]) -> np.ndarray:
    """Each filtered 8x8 luma block: int64 rows (mi row, mi col, cdef index,
    direction, variance), in raster order."""
    s, h = parsed.frame.seq, parsed.frame.hdr
    sk = parsed.skip
    r, c = np.meshgrid(np.arange(0, h.mi_rows, 2), np.arange(0, h.mi_cols, 2), indexing="ij")
    r, c = r.reshape(-1), c.reshape(-1)
    idx = parsed.cdef_idx[r >> 4, c >> 4].astype(np.int64)
    skip = sk[r, c] & sk[r + 1, c] & sk[r, c + 1] & sk[r + 1, c + 1]
    keep = (idx != -1) & ~skip
    r, c, idx = r[keep], c[keep], idx[keep]
    d, var = cdef_directions(planes[0], r, c, s.bit_depth)
    return np.stack([r, c, idx, d, var], axis=1).astype(np.int64).reshape(-1, 5)


def _msb(x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    v = x.copy()
    for sh in (16, 8, 4, 2, 1):
        big = v >= (1 << sh)
        out += np.where(big, sh, 0)
        v = np.where(big, v >> sh, v)
    return out


def _constrain_v(diff: np.ndarray, threshold: np.ndarray, damping: np.ndarray) -> np.ndarray:
    adj = np.maximum(0, damping - _msb(np.maximum(threshold, 1)))
    a = np.abs(diff)
    v = np.sign(diff) * np.minimum(a, np.maximum(0, threshold - (a >> adj)))
    return np.where(threshold > 0, v, 0)


def block_strengths(parsed: Parsed, blocks: np.ndarray, p: int) -> tuple:
    """Per block of ``cdef_blocks``: (primary, secondary, damping,
    direction) of plane ``p``."""
    s, h = parsed.frame.seq, parsed.frame.hdr
    sh = s.bit_depth - 8
    idx, ydir, var = blocks[:, 2], blocks[:, 3], blocks[:, 4]
    if p == 0:
        pri = np.array(h.cdef_y_pri, np.int64)[idx] << sh
        sec = np.array(h.cdef_y_sec, np.int64)[idx] << sh
        vs = np.where(var >> 6 > 0, np.minimum(_msb(np.maximum(var >> 6, 1)), 12), 0)
        direction = np.where(pri > 0, ydir, 0)
        pri = np.where(var > 0, (pri * (4 + vs) + 8) >> 4, 0)
        damping = np.full(len(idx), h.cdef_damping + sh, np.int64)
    else:
        sx, sy = s.ssx, s.ssy
        pri = np.array(h.cdef_uv_pri, np.int64)[idx] << sh
        sec = np.array(h.cdef_uv_sec, np.int64)[idx] << sh
        direction = np.where(pri > 0, np.array(_UV_DIR[(sx, sy)], np.int64)[ydir], 0)
        damping = np.full(len(idx), h.cdef_damping + sh - 1, np.int64)
    return pri, sec, damping, direction


def cdef(parsed: Parsed, planes: List[np.ndarray], blocks: np.ndarray = None) -> List[np.ndarray]:
    """CDEF of the deblocked frame: every filtered block at once."""
    s, h = parsed.frame.seq, parsed.frame.hdr
    out = [pl.copy() for pl in planes]
    if not s.enable_cdef or h.coded_lossless or h.allow_intrabc:
        return out
    if blocks is None:
        blocks = cdef_blocks(parsed, planes)
    if not len(blocks):
        return out
    dirs = np.array(CDEF_DIRECTIONS, np.int64)  # (8, 2, 2)
    for p in range(len(planes)):
        sx, sy = _plane_sub(parsed, p)
        H, W = (h.mi_rows * 4) >> sy, (h.mi_cols * 4) >> sx
        src = planes[p].astype(np.int64)
        pri, sec, damping, direction = block_strengths(parsed, blocks, p)
        bh, bw = 8 >> sy, 8 >> sx
        y0 = (blocks[:, 0] * 4) >> sy
        x0 = (blocks[:, 1] * 4) >> sx
        yy = y0[:, None, None] + np.arange(bh)[None, :, None]
        xx = x0[:, None, None] + np.arange(bw)[None, None, :]
        x = src[yy, xx]
        total = np.zeros_like(x)
        mx, mn = x.copy(), x.copy()
        pri_taps = np.where(((pri >> (s.bit_depth - 8)) & 1)[:, None] == 1, np.array([3, 3]), np.array([4, 2]))
        sec_taps = (2, 1)
        P, S, D = pri[:, None, None], sec[:, None, None], damping[:, None, None]
        for k in range(2):
            for sign in (-1, 1):
                for off in (0, -2, 2):
                    dd = (direction + off) & 7
                    dr = dirs[dd, k, 0][:, None, None]
                    dc = dirs[dd, k, 1][:, None, None]
                    ty, tx = yy + sign * dr, xx + sign * dc
                    ok = (ty >= 0) & (ty < H) & (tx >= 0) & (tx < W)
                    pv = src[np.clip(ty, 0, src.shape[0] - 1), np.clip(tx, 0, src.shape[1] - 1)]
                    if off == 0:
                        c = pri_taps[:, k][:, None, None] * _constrain_v(pv - x, P + 0 * x, D + 0 * x)
                    else:
                        c = sec_taps[k] * _constrain_v(pv - x, S + 0 * x, D + 0 * x)
                    total += np.where(ok, c, 0)
                    mx = np.where(ok, np.maximum(mx, pv), mx)
                    mn = np.where(ok, np.minimum(mn, pv), mn)
        res = np.clip(x + ((8 + total - (total < 0)) >> 4), mn, mx)
        out[p][yy, xx] = res
    return out


# -- loop restoration ------------------------------------------------------------

def _source(deblocked: np.ndarray, cdefed: np.ndarray, ys: np.ndarray, xs: np.ndarray, stripe0: int,
            stripe1: int, end_y: int, end_x: int) -> np.ndarray:
    """``get_source_sample`` at integer arrays of positions."""
    x = np.clip(xs, 0, end_x)
    y = np.clip(ys, 0, end_y)
    above = y < stripe0
    below = y > stripe1
    yd = np.where(above, np.maximum(stripe0 - 2, y), np.where(below, np.minimum(stripe1 + 2, y), y))
    return np.where(above | below, deblocked[yd, x], cdefed[y, x])


def lr_rects(parsed: Parsed, p: int) -> list:
    """Plane ``p`` cut into rectangles of one restoration unit and one
    64-row stripe: rows (x, y, w, h, unit row, unit col, stripe start,
    stripe end) over the frame's (not the mi grid's) samples."""
    h = parsed.frame.hdr
    sx, sy = _plane_sub(parsed, p)
    size = h.lr_unit_size[p]
    rows, cols = parsed.lr_units[p]
    end_x = ((h.width + sx) >> sx) - 1
    end_y = ((h.height + sy) >> sy) - 1
    cuts = {0, end_y + 1}
    for k in range(1, 64):
        y = (64 * k - 8) >> sy
        if y <= end_y:
            cuts.add(y)
        y = max(0, k * size - (8 >> sy))
        if k < rows and y <= end_y:
            cuts.add(y)
    ys = sorted(cuts)
    xs = sorted({min(k * size, end_x + 1) for k in range(cols)} | {end_x + 1})
    out = []
    for y0, y1 in zip(ys, ys[1:]):
        stripe = ((y0 << sy) + 8) // 64
        s0 = (-8 + stripe * 64) >> sy
        s1 = s0 + (64 >> sy) - 1
        ur = min(rows - 1, (y0 + (8 >> sy)) // size)
        for x0, x1 in zip(xs, xs[1:]):
            out.append((x0, y0, x1 - x0, y1 - y0, ur, min(cols - 1, x0 // size), s0, s1))
    return out


def _wiener(deb, cdf, x, y, w, hh, coeffs, s0, s1, end_y, end_x, bd):
    r0, r1 = (5, 9) if bd == 12 else (3, 11)
    taps = [np.array([c[0], c[1], c[2], 128 - 2 * (c[0] + c[1] + c[2]), c[2], c[1], c[0]], np.int64)
            for c in coeffs]
    vf, hf = taps
    off = 1 << (bd + 7 - r0 - 1)
    limit = (1 << (bd + 1 + 7 - r0)) - 1
    rr = y - 3 + np.arange(hh + 6)[:, None, None]
    cc = x - 3 + np.arange(w)[None, :, None] + np.arange(7)[None, None, :]
    src = _source(deb, cdf, rr + 0 * cc, cc + 0 * rr, s0, s1, end_y, end_x)
    inter = (src * hf).sum(-1)
    inter = np.clip((inter + (1 << (r0 - 1))) >> r0, -off, limit - off)
    v = sum(vf[t] * inter[t:t + hh] for t in range(7))
    return np.clip((v + (1 << (r1 - 1))) >> r1, 0, (1 << bd) - 1)


def _box(deb, cdf, x, y, w, hh, r, s, s0, s1, end_y, end_x, bd):
    n = (2 * r + 1) ** 2
    ys = y - 1 + np.arange(hh + 2)[:, None, None, None]
    xs = x - 1 + np.arange(w + 2)[None, :, None, None]
    dy = np.arange(-r, r + 1)[None, None, :, None]
    dx = np.arange(-r, r + 1)[None, None, None, :]
    c = _source(deb, cdf, ys + dy + 0 * xs + 0 * dx, xs + dx + 0 * ys + 0 * dy, s0, s1, end_y, end_x)
    a = (c * c).sum((2, 3))
    b = c.sum((2, 3))
    if bd > 8:
        a2 = (a + (1 << (2 * (bd - 8) - 1))) >> (2 * (bd - 8))
        d = (b + (1 << (bd - 9))) >> (bd - 8)
        pp = np.maximum(0, a2 * n - d * d)
    else:
        pp = a * n - b * b
    z = (pp * s + (1 << 19)) >> 20
    A = T.x_by_xplus1()[np.minimum(z, 255)].astype(np.int64)
    one = int(T.one_by_x()[n - 1])
    B = ((256 - A) * b * one + (1 << 11)) >> 12
    return A, B


def _selfguided(deb, cdf, x, y, w, hh, sgr_set, xqd, s0, s1, end_y, end_x, bd):
    params = T.table("sgr_params")[sgr_set]
    u = cdf[y:y + hh, x:x + w].astype(np.int64) << 4
    flts = []
    for pas in range(2):
        r, s = int(params[pas]), int(params[2 + pas])
        if not r:
            flts.append(None)
            continue
        A, B = _box(deb, cdf, x, y, w, hh, r, s, s0, s1, end_y, end_x, bd)
        pix = cdf[y:y + hh, x:x + w].astype(np.int64)
        F = np.zeros((hh, w), np.int64)
        for i in range(hh):
            if pas == 0:
                if (i & 1) == 0:
                    aa = (A[i, 1:w + 1] + A[i + 2, 1:w + 1]) * 6 + (A[i, 0:w] + A[i + 2, 0:w] + A[i, 2:w + 2]
                                                                   + A[i + 2, 2:w + 2]) * 5
                    bb = (B[i, 1:w + 1] + B[i + 2, 1:w + 1]) * 6 + (B[i, 0:w] + B[i + 2, 0:w] + B[i, 2:w + 2]
                                                                   + B[i + 2, 2:w + 2]) * 5
                    nb = 5
                else:
                    aa = A[i + 1, 1:w + 1] * 6 + (A[i + 1, 0:w] + A[i + 1, 2:w + 2]) * 5
                    bb = B[i + 1, 1:w + 1] * 6 + (B[i + 1, 0:w] + B[i + 1, 2:w + 2]) * 5
                    nb = 4
            else:
                aa = (A[i + 1, 1:w + 1] + A[i + 1, 0:w] + A[i + 1, 2:w + 2] + A[i, 1:w + 1] + A[i + 2, 1:w + 1]) * 4 \
                    + (A[i, 0:w] + A[i, 2:w + 2] + A[i + 2, 0:w] + A[i + 2, 2:w + 2]) * 3
                bb = (B[i + 1, 1:w + 1] + B[i + 1, 0:w] + B[i + 1, 2:w + 2] + B[i, 1:w + 1] + B[i + 2, 1:w + 1]) * 4 \
                    + (B[i, 0:w] + B[i, 2:w + 2] + B[i + 2, 0:w] + B[i + 2, 2:w + 2]) * 3
                nb = 5
            v = aa * pix[i] + bb
            sh = 8 + nb - 4
            F[i] = (v + (1 << (sh - 1))) >> sh
        flts.append(F)
    r0, r1 = int(params[0]), int(params[1])
    if r0 == 0:
        xq = (0, 128 - xqd[1])
    elif r1 == 0:
        xq = (xqd[0], 0)
    else:
        xq = (xqd[0], 128 - xqd[0] - xqd[1])
    v = u << 7
    if r0:
        v = v + xq[0] * (flts[0] - u)
    if r1:
        v = v + xq[1] * (flts[1] - u)
    out = (v + (1 << 10)) >> 11
    return np.clip(out, 0, (1 << bd) - 1)


def loop_restore(parsed: Parsed, deblocked: List[np.ndarray], cdefed: List[np.ndarray]) -> List[np.ndarray]:
    """Loop restoration of every plane that has a restoration type."""
    s, h = parsed.frame.seq, parsed.frame.hdr
    out = [pl.copy() for pl in cdefed]
    for p in range(len(cdefed)):
        if h.lr_type[p] == T.RESTORE_NONE:
            continue
        sx, sy = _plane_sub(parsed, p)
        end_x = ((h.width + sx) >> sx) - 1
        end_y = ((h.height + sy) >> sy) - 1
        for x, y, w, hh, ur, uc, s0, s1 in lr_rects(parsed, p):
            unit = parsed.lr[p].get((ur, uc))
            if unit is None or unit.kind == T.RESTORE_NONE:
                continue
            if unit.kind == T.RESTORE_WIENER:
                v = _wiener(deblocked[p], cdefed[p], x, y, w, hh, unit.wiener, s0, s1, end_y, end_x, s.bit_depth)
            else:
                v = _selfguided(deblocked[p], cdefed[p], x, y, w, hh, unit.sgr_set, unit.sgr_xqd, s0, s1, end_y,
                                end_x, s.bit_depth)
            out[p][y:y + hh, x:x + w] = v
    return out
