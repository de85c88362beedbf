"""AV1 intra reconstruction in plain numpy (section 7.11.2, 7.11.3 for
IntraBC, 7.12.3 and 7.13 of the AV1 specification), in the decode order of
:mod:`data.av1_parse`'s transform-block table.

For each row of :attr:`Parsed.txbs`: an IntraBC block's copy (the bilinear
rule of an unscaled reference), or an intra transform block's prediction
(palette, filter intra, directional with edge filtering and upsampling,
smooth, DC, Paeth, then CfL), then, where it has coefficients,
dequantisation (the quantizer matrices, the 24-bit mask and clamp) and the
inverse transform (DCT 4-64, ADST 4/8/16, their flips, identity, and the
Walsh-Hadamard transform of lossless blocks, each with libaom's intermediate
rounding and range clamps), added and clipped. The result is the frame
before the loop filters, one int32 plane each (luma, then chroma), cut to
the mi grid (``8 * ceil(size / 8)``) and a margin.
"""

from __future__ import annotations

from typing import List

import numpy as np

from dspnet_torch.data import av1_tables as T
from dspnet_torch.data.av1_parse import (F_ABOVE, F_ABOVE_RIGHT, F_BELOW_LEFT, F_CFL, F_FILTER_INTRA, F_LEFT,
                                         F_LOSSLESS, F_PALETTE, KIND_INTRA, KIND_INTRABC, Parsed)

MARGIN = 160
_SMOOTH_OFF = {4: 0, 8: 4, 16: 12, 32: 28, 64: 60}


# -- one-dimensional inverse transforms (libaom's av1_inv_txfm1d.c) ---------

def _r12(x):
    return (x + 2048) >> 12


def _clamp(x, bits: int):
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return np.clip(x, lo, hi)


def _hb(w0: int, a, w1: int, b):
    """``half_btf`` at cos_bit 12."""
    return _r12(w0 * a + w1 * b)


def _brev(n: int, x: int) -> int:
    r = 0
    for i in range(n):
        if x & (1 << i):
            r |= 1 << (n - 1 - i)
    return r


def idct(x: list, rng: int) -> list:
    """Inverse DCT of ``len(x)`` (4 .. 64) vectors, libaom's butterflies."""
    n = len(x)
    m = n.bit_length() - 1
    c = T.cospi(12)
    b = [x[_brev(m, i)] for i in range(n)]
    return _idct_core(b, 0, n, c, rng)


def _idct_core(b: list, base: int, n: int, c, rng: int) -> list:
    """The butterfly network over ``b[base:base + n]`` (inputs already in
    bit-reversed order); returns the outputs of that span."""
    if n == 2:
        a0, a1 = b[base], b[base + 1]
        return [_hb(c[32], a0, c[32], a1), _hb(c[32], a0, -c[32], a1)]
    half = n // 2
    even = _idct_core(b, base, half, c, rng)
    odd = _idct_odd(b[base + half:base + n], n, c, rng)
    out = [None] * n
    for i in range(half):
        out[i] = _clamp(even[i] + odd[half - 1 - i], rng)
        out[n - 1 - i] = _clamp(even[i] - odd[half - 1 - i], rng)
    return out


def _idct_odd(o: list, n: int, c, rng: int) -> list:
    """The odd half of an ``n``-point inverse DCT (``n / 2`` inputs)."""
    m = n // 2
    if n == 4:
        a, bb = o
        return [_hb(c[48], a, -c[16], bb), _hb(c[16], a, c[48], bb)]
    lg = m.bit_length() - 1
    o = list(o)
    # stage A: rotations of (k, m - 1 - k)
    for k in range(m // 2):
        q = (64 // n) * (2 * _brev(lg, k) + 1)
        a, bb = o[k], o[m - 1 - k]
        o[k] = _hb(c[64 - q], a, -c[q], bb)
        o[m - 1 - k] = _hb(c[q], a, c[64 - q], bb)
    level = 1
    while (1 << level) < m:
        g = 1 << (level - 1)
        # butterflies of blocks of 2g, every other block flipped
        for t in range(m // (2 * g)):
            s = t * 2 * g
            for i in range(g):
                a, bb = o[s + i], o[s + 2 * g - 1 - i]
                if t % 2 == 0:
                    o[s + i], o[s + 2 * g - 1 - i] = _clamp(a + bb, rng), _clamp(a - bb, rng)
                else:
                    o[s + i], o[s + 2 * g - 1 - i] = _clamp(bb - a, rng), _clamp(a + bb, rng)
        # rotations of the middle of each block of 4g in the first half
        size = n >> (level + 1)
        for t in range(max(1, (m // 2) // (4 * g))):
            s = t * 4 * g
            q = (64 // size) * (2 * _brev(max(0, (size // 2).bit_length() - 1), t) + 1) if size > 2 else 32
            for i in range(2 * g):
                p = s + g + i
                if p >= m // 2:
                    break
                mm = m - 1 - p
                a, bb = o[p], o[mm]
                if i < g:
                    o[p], o[mm] = _hb(-c[q], a, c[64 - q], bb), _hb(c[64 - q], a, c[q], bb)
                else:
                    o[p], o[mm] = _hb(-c[64 - q], a, -c[q], bb), _hb(-c[q], a, c[64 - q], bb)
        level += 1
    return o


def iadst4(x: list, rng: int) -> list:
    s = T.sinpi(12)
    x0, x1, x2, x3 = x
    s0, s1, s2, s3 = s[1] * x0, s[2] * x0, s[3] * x1, s[4] * x2
    s4, s5, s6 = s[1] * x2, s[2] * x3, s[4] * x3
    s7 = (x0 - x2) + x3
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = s[3] * s7
    s0 = s0 + s5
    s1 = s1 - s6
    y0 = s0 + s3
    y1 = s1 + s3
    y2 = s2
    y3 = s0 + s1 - s3
    return [_r12(y0), _r12(y1), _r12(y2), _r12(y3)]


def iadst8(x: list, rng: int) -> list:
    c = T.cospi(12)
    b = [x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]]
    o = [None] * 8
    for k, (p, q) in enumerate(((4, 60), (20, 44), (36, 28), (52, 12))):
        a, bb = b[2 * k], b[2 * k + 1]
        o[2 * k], o[2 * k + 1] = _hb(c[p], a, c[q], bb), _hb(c[q], a, -c[p], bb)
    b = o[:]
    for i in range(4):
        o[i], o[i + 4] = _clamp(b[i] + b[i + 4], rng), _clamp(b[i] - b[i + 4], rng)
    b = o[:]
    o[4], o[5] = _hb(c[16], b[4], c[48], b[5]), _hb(c[48], b[4], -c[16], b[5])
    o[6], o[7] = _hb(-c[48], b[6], c[16], b[7]), _hb(c[16], b[6], c[48], b[7])
    b = o[:]
    for base in (0, 4):
        for i in range(2):
            o[base + i], o[base + i + 2] = _clamp(b[base + i] + b[base + i + 2], rng), _clamp(
                b[base + i] - b[base + i + 2], rng)
    b = o[:]
    for base in (2, 6):
        o[base], o[base + 1] = _hb(c[32], b[base], c[32], b[base + 1]), _hb(c[32], b[base], -c[32], b[base + 1])
    b = o
    return [b[0], -b[4], b[6], -b[2], b[3], -b[7], b[5], -b[1]]


def iadst16(x: list, rng: int) -> list:
    c = T.cospi(12)
    b = [x[15], x[0], x[13], x[2], x[11], x[4], x[9], x[6], x[7], x[8], x[5], x[10], x[3], x[12], x[1], x[14]]
    o = [None] * 16
    for k in range(8):
        p = 2 + 8 * k
        a, bb = b[2 * k], b[2 * k + 1]
        o[2 * k], o[2 * k + 1] = _hb(c[p], a, c[64 - p], bb), _hb(c[64 - p], a, -c[p], bb)
    b = o[:]
    for i in range(8):
        o[i], o[i + 8] = _clamp(b[i] + b[i + 8], rng), _clamp(b[i] - b[i + 8], rng)
    b = o[:]
    o[8], o[9] = _hb(c[8], b[8], c[56], b[9]), _hb(c[56], b[8], -c[8], b[9])
    o[10], o[11] = _hb(c[40], b[10], c[24], b[11]), _hb(c[24], b[10], -c[40], b[11])
    o[12], o[13] = _hb(-c[56], b[12], c[8], b[13]), _hb(c[8], b[12], c[56], b[13])
    o[14], o[15] = _hb(-c[24], b[14], c[40], b[15]), _hb(c[40], b[14], c[24], b[15])
    b = o[:]
    for base in (0, 8):
        for i in range(4):
            o[base + i], o[base + i + 4] = _clamp(b[base + i] + b[base + i + 4], rng), _clamp(
                b[base + i] - b[base + i + 4], rng)
    b = o[:]
    for base in (4, 12):
        o[base], o[base + 1] = _hb(c[16], b[base], c[48], b[base + 1]), _hb(c[48], b[base], -c[16], b[base + 1])
        o[base + 2], o[base + 3] = _hb(-c[48], b[base + 2], c[16], b[base + 3]), _hb(c[16], b[base + 2], c[48],
                                                                                    b[base + 3])
    b = o[:]
    for base in (0, 4, 8, 12):
        for i in range(2):
            o[base + i], o[base + i + 2] = _clamp(b[base + i] + b[base + i + 2], rng), _clamp(
                b[base + i] - b[base + i + 2], rng)
    b = o[:]
    for base in (2, 6, 10, 14):
        o[base], o[base + 1] = _hb(c[32], b[base], c[32], b[base + 1]), _hb(c[32], b[base], -c[32], b[base + 1])
    b = o
    return [b[0], -b[8], b[12], -b[4], b[6], -b[14], b[10], -b[2], b[3], -b[11], b[15], -b[7], b[5], -b[13],
            b[9], -b[1]]


def iidentity(x: list, rng: int) -> list:
    n = len(x)
    if n == 4:
        return [_r12(v * 5793) for v in x]
    if n == 8:
        return [v * 2 for v in x]
    if n == 16:
        return [_r12(v * 2 * 5793) for v in x]
    return [v * 4 for v in x]


def _txfm_1d(kind: int, n: int):
    if kind == 3:
        return iidentity
    if kind == 0:
        return idct
    return {4: iadst4, 8: iadst8, 16: iadst16}[n]


def inverse_transform(coef: np.ndarray, tx_size: int, tx_type: int, bd: int, lossless: bool) -> np.ndarray:
    """Dequantised coefficients (th x tw, ``min(32, size)`` each) -> the
    h x w residual, libaom's ``inv_txfm2d_add_c`` before the add (flips
    applied)."""
    w, h = T.TX_W[tx_size], T.TX_H[tx_size]
    full = np.zeros((h, w), np.int64)
    th, tw = coef.shape
    full[:th, :tw] = coef
    if lossless:
        return _iwht(full)
    vt, ht = T.TX_TYPE_1D[tx_type]
    shift0, shift1 = (int(v) for v in T.table("inv_shift")[tx_size])
    lw, lh = T.TX_W_LOG2[tx_size], T.TX_H_LOG2[tx_size]
    row_rng, col_rng = bd + 8, max(bd + 6, 16)
    # rows: every row at once, a vector per column
    cols = [full[:, j] for j in range(w)]
    if abs(lw - lh) == 1:
        cols = [_r12(v * 2896) for v in cols]
    cols = [_clamp(v, row_rng) for v in cols]
    if ht == 2:
        pass  # a flipped ADST row is read backwards at the column stage
    out = _txfm_1d(ht, w)(cols, row_rng)
    if -shift0:
        out = [(v + (1 << (-shift0 - 1))) >> -shift0 for v in out]
    buf = np.stack(out, axis=1)
    if ht == 2:
        buf = buf[:, ::-1]
    rows = [_clamp(buf[i, :], col_rng) for i in range(h)]
    out = _txfm_1d(vt, h)(rows, col_rng)
    out = [(v + (1 << (-shift1 - 1))) >> -shift1 for v in out]
    res = np.stack(out, axis=0)
    if vt == 2:
        res = res[::-1, :]
    return res


def _iwht(full: np.ndarray) -> np.ndarray:
    t = full.astype(np.int64).copy()
    for shift, axis in ((2, 1), (0, 0)):
        v = [np.take(t, k, axis=axis) >> shift for k in range(4)]
        a, c, d, b = v
        a = a + c
        d = d - b
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a = a - b
        d = d + c
        t = np.stack([a, b, c, d], axis=axis)
    return t


# -- intra prediction ---------------------------------------------------------

def _edge_filter_strength(w: int, h: int, ftype: int, delta: int) -> int:
    d, wh = abs(delta), w + h
    s = 0
    if ftype == 0:
        if wh <= 8:
            s = 1 if d >= 56 else 0
        elif wh <= 16:
            s = 1 if d >= 40 else 0
        elif wh <= 24:
            s = 3 if d >= 32 else 2 if d >= 16 else 1 if d >= 8 else 0
        elif wh <= 32:
            s = 3 if d >= 32 else 2 if d >= 4 else 1 if d >= 1 else 0
        else:
            s = 3 if d >= 1 else 0
    else:
        if wh <= 8:
            s = 2 if d >= 64 else 1 if d >= 40 else 0
        elif wh <= 16:
            s = 2 if d >= 48 else 1 if d >= 20 else 0
        elif wh <= 24:
            s = 3 if d >= 4 else 0
        else:
            s = 3 if d >= 1 else 0
    return s


def _edge_filter(edge: list, sz: int, strength: int) -> None:
    """``intra_edge_filter`` on ``edge[0:sz]`` (edge[0] is the corner)."""
    if not strength:
        return
    k = T.INTRA_EDGE_KERNEL[strength - 1]
    src = edge[:sz]
    for i in range(1, sz):
        s = 0
        for j in range(5):
            s += k[j] * src[min(max(i - 2 + j, 0), sz - 1)]
        edge[i] = (s + 8) >> 4


def _upsample_use(w: int, h: int, ftype: int, delta: int) -> bool:
    d = abs(delta)
    if d <= 0 or d >= 40:
        return False
    return (w + h <= 8) if ftype else (w + h <= 16)


def _upsample(edge: list, num: int, bd: int) -> list:
    """``intra_edge_upsample``: ``edge`` holds buf[-1 .. num - 1] at 0 ..
    num; returns buf[-2 .. 2 num - 2] at 0 .. 2 num."""
    mx = (1 << bd) - 1
    dup = [edge[0]] + edge[0:num + 1] + [edge[num]]
    out = [0] * (2 * num + 1)
    out[0] = dup[0]
    for i in range(num):
        s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
        s = min(max((s + 8) >> 4, 0), mx)
        out[2 * i + 1] = s
        out[2 * i + 2] = dup[i + 2]
    return out


def predict_intra(frame: np.ndarray, x: int, y: int, flags: int, mode: int, w: int, h: int, angle_delta: int,
                  filter_mode: int, ftype: int, max_x: int, max_y: int, bd: int, edge_filter: bool) -> np.ndarray:
    """The h x w intra prediction at (x, y) of a plane (section 7.11.2)."""
    have_left, have_above = bool(flags & F_LEFT), bool(flags & F_ABOVE)
    n = w + h
    mid = 1 << (bd - 1)
    if not have_above and have_left:
        above = [int(frame[y, x - 1])] * n
    elif not have_above:
        above = [mid - 1] * n
    else:
        lim = min(max_x, x + (2 * w if flags & F_ABOVE_RIGHT else w) - 1)
        row = frame[y - 1]
        above = [int(row[min(lim, x + i)]) for i in range(n)]
    if not have_left and have_above:
        left = [int(frame[y - 1, x])] * n
    elif not have_left:
        left = [mid + 1] * n
    else:
        lim = min(max_y, y + (2 * h if flags & F_BELOW_LEFT else h) - 1)
        left = [int(frame[min(lim, y + i), x - 1]) for i in range(n)]
    if have_above and have_left:
        corner = int(frame[y - 1, x - 1])
    elif have_above:
        corner = int(frame[y - 1, x])
    elif have_left:
        corner = int(frame[y, x - 1])
    else:
        corner = mid
    mx = (1 << bd) - 1
    if flags & F_FILTER_INTRA:
        taps = T.table("filter_intra_taps")[filter_mode].astype(np.int64)
        pred = np.zeros((h, w), np.int64)
        for i2 in range(h >> 1):
            for j4 in range(w >> 2):
                p = [0] * 7
                for i in range(7):
                    if i < 5:
                        if i2 == 0:
                            p[i] = corner if (j4 << 2) + i - 1 < 0 else above[(j4 << 2) + i - 1]
                        elif j4 == 0 and i == 0:
                            p[i] = left[(i2 << 1) - 1]
                        else:
                            p[i] = int(pred[(i2 << 1) - 1, (j4 << 2) + i - 1])
                    else:
                        if j4 == 0:
                            p[i] = left[(i2 << 1) + i - 5]
                        else:
                            p[i] = int(pred[(i2 << 1) + i - 5, (j4 << 2) - 1])
                for i in range(8):
                    pr = sum(int(taps[i][j]) * p[j] for j in range(7))
                    v = (pr + 8) >> 4 if pr >= 0 else -((-pr + 8) >> 4)
                    pred[(i2 << 1) + (i >> 2), (j4 << 2) + (i & 3)] = min(max(v, 0), mx)
        return pred
    if T.V_PRED <= mode <= T.D67_PRED:
        return _directional(above, left, corner, x, y, w, h, mode, angle_delta, ftype, have_above, have_left,
                            max_x, max_y, bd, edge_filter)
    a = np.array(above[:w], np.int64)
    lc = np.array(left[:h], np.int64)
    if mode in (T.SMOOTH_PRED, T.SMOOTH_V_PRED, T.SMOOTH_H_PRED):
        sw = T.table("smooth_weights").astype(np.int64)
        wx = sw[_SMOOTH_OFF[w]:_SMOOTH_OFF[w] + w][None, :]
        wy = sw[_SMOOTH_OFF[h]:_SMOOTH_OFF[h] + h][:, None]
        if mode == T.SMOOTH_PRED:
            s = wy * a[None, :] + (256 - wy) * left[h - 1] + wx * lc[:, None] + (256 - wx) * above[w - 1]
            return (s + 256) >> 9
        if mode == T.SMOOTH_V_PRED:
            return np.broadcast_to((wy * a[None, :] + (256 - wy) * left[h - 1] + 128) >> 8, (h, w))
        return (wx * lc[:, None] + (256 - wx) * above[w - 1] + 128) >> 8
    if mode == T.DC_PRED:
        if have_left and have_above:
            avg = (int(a.sum()) + int(lc.sum()) + ((w + h) >> 1)) // (w + h)
        elif have_left:
            avg = (int(lc.sum()) + (h >> 1)) >> (h.bit_length() - 1)
        elif have_above:
            avg = (int(a.sum()) + (w >> 1)) >> (w.bit_length() - 1)
        else:
            avg = mid
        return np.full((h, w), avg, np.int64)
    # PAETH
    base = a[None, :] + lc[:, None] - corner
    pl = np.abs(base - lc[:, None])
    pt = np.abs(base - a[None, :])
    ptl = np.abs(base - corner)
    return np.where((pl <= pt) & (pl <= ptl), lc[:, None] + 0 * a[None, :],
                    np.where(pt <= ptl, a[None, :] + 0 * lc[:, None], corner))


def _directional(above, left, corner, x, y, w, h, mode, angle_delta, ftype, have_above, have_left, max_x, max_y,
                 bd, edge_filter):
    p_angle = int(T.table("mode_to_angle")[mode]) + angle_delta * 3
    # edges with the corner at index 0: A[k] = AboveRow[k - 1]
    A = [corner] + list(above)
    L = [corner] + list(left)
    up_a = up_l = 0
    if edge_filter:
        if p_angle != 90 and p_angle != 180:
            if 90 < p_angle < 180 and (w + h) >= 24:
                c = (L[1] * 5 + corner * 6 + A[1] * 5 + 8) >> 4
                A[0] = L[0] = c
            if have_above:
                st = _edge_filter_strength(w, h, ftype, p_angle - 90)
                num = min(w, max_x - x + 1) + (h if p_angle < 90 else 0) + 1
                _edge_filter(A, num, st)
            if have_left:
                st = _edge_filter_strength(w, h, ftype, p_angle - 180)
                num = min(h, max_y - y + 1) + (w if p_angle > 180 else 0) + 1
                _edge_filter(L, num, st)
        up_a = int(_upsample_use(w, h, ftype, p_angle - 90))
        if up_a:
            A = _upsample(A, w + (h if p_angle < 90 else 0), bd)  # index 0 is AboveRow[-2]
        up_l = int(_upsample_use(w, h, ftype, p_angle - 180))
        if up_l:
            L = _upsample(L, h + (w if p_angle > 180 else 0), bd)
    oa = 1 + up_a  # offset of AboveRow[0] in A
    ol = 1 + up_l
    pad = 4 * (w + h) + 16
    A = A + [A[-1]] * pad
    L = L + [L[-1]] * pad
    A = np.array(A, np.int64)
    L = np.array(L, np.int64)
    dr = T.table("dr_intra_derivative")
    i = np.arange(h, dtype=np.int64)[:, None]
    j = np.arange(w, dtype=np.int64)[None, :]
    if p_angle == 90:
        return np.broadcast_to(A[oa:oa + w][None, :], (h, w)).astype(np.int64)
    if p_angle == 180:
        return np.broadcast_to(L[ol:ol + h][:, None], (h, w)).astype(np.int64)
    if p_angle < 90:
        dx = int(dr[p_angle])
        idx = (i + 1) * dx
        base = (idx >> (6 - up_a)) + (j << up_a)
        shift = ((idx << up_a) >> 1) & 0x1F
        max_base = (w + h - 1) << up_a
        v = (A[oa + base] * (32 - shift) + A[oa + base + 1] * shift + 16) >> 5
        return np.where(base < max_base, v, A[oa + max_base])
    if p_angle > 180:
        dy = int(dr[270 - p_angle])
        idx = (j + 1) * dy
        base = (idx >> (6 - up_l)) + (i << up_l)
        shift = ((idx << up_l) >> 1) & 0x1F
        max_base = (w + h - 1) << up_l
        v = (L[ol + base] * (32 - shift) + L[ol + base + 1] * shift + 16) >> 5
        return np.where(base < max_base, v, L[ol + max_base])
    dx = int(dr[180 - p_angle])
    dy = int(dr[p_angle - 90])
    idx = (j << 6) - (i + 1) * dx
    base = idx >> (6 - up_a)
    shift = ((idx << up_a) >> 1) & 0x1F
    bclip = np.maximum(base, -oa)
    va = (A[oa + bclip] * (32 - shift) + A[oa + bclip + 1] * shift + 16) >> 5
    idy = (i << 6) - (j + 1) * dy
    basey = idy >> (6 - up_l)
    shifty = ((idy << up_l) >> 1) & 0x1F
    byc = np.maximum(basey, -ol)
    vl = (L[ol + byc] * (32 - shifty) + L[ol + byc + 1] * shifty + 16) >> 5
    return np.where(base >= -(1 << up_a), va, vl)


# -- the frame ------------------------------------------------------------------

def plane_dims(parsed: Parsed) -> List[tuple]:
    """(height, width) of each plane's buffer: the mi grid plus a margin."""
    h = parsed.frame.hdr
    s = parsed.frame.seq
    out = []
    for p in range(s.num_planes):
        sx, sy = (s.ssx, s.ssy) if p else (0, 0)
        out.append((((h.mi_rows * 4) >> sy) + MARGIN, ((h.mi_cols * 4) >> sx) + MARGIN))
    return out


def quantizers(parsed: Parsed, qidx: int, plane: int) -> tuple:
    """(dc, ac) of a plane at a block's q index."""
    h = parsed.frame.hdr
    bd = parsed.frame.seq.bit_depth
    k = {8: "8", 10: "10", 12: "12"}[bd]
    dc_delta = (h.delta_q_y_dc, h.delta_q_u_dc, h.delta_q_v_dc)[plane]
    ac_delta = (0, h.delta_q_u_ac, h.delta_q_v_ac)[plane]
    dc = int(T.table("dc_q" + k)[max(0, min(255, qidx + dc_delta))])
    ac = int(T.table("ac_q" + k)[max(0, min(255, qidx + ac_delta))])
    return dc, ac


def dequantize(parsed: Parsed, txb: np.ndarray) -> np.ndarray:
    """One transform block's coefficients -> the th x tw dequantised array."""
    kind, plane, x, y, tx, tx_type, eob, coef, blk = (int(v) for v in txb[:9])
    h = parsed.frame.hdr
    bd = parsed.frame.seq.bit_depth
    tw, th = min(32, T.TX_W[tx]), min(32, T.TX_H[tx])
    out = np.zeros(th * tw, np.int64)
    if eob <= 0:
        return out.reshape(th, tw)
    seg = int(parsed.blocks[blk, 19])
    dc, ac = quantizers(parsed, int(txb[13]), plane)
    lossless = bool(h.lossless[seg])
    level = h.seg_qm_level[plane][seg] if h.using_qmatrix and not lossless else 15
    scan = T.scan(tx, tx_type)
    vals = parsed.coefs[coef:coef + eob].astype(np.int64)
    pos = np.array(scan[:eob], np.int64)
    q = np.where(pos == 0, dc, ac).astype(np.int64)
    if level < 15 and tx_type < T.IDTX:
        qm = T.table("qm")[level, 1 if plane else 0].astype(np.int64)
        q = (qm[T.qm_offset(tx) + pos] * q + 16) >> 5
    mag = (np.abs(vals) * q) & 0xFFFFFF
    mag >>= (T.TX_W[tx] * T.TX_H[tx] > 256) + (T.TX_W[tx] * T.TX_H[tx] > 1024)
    v = np.where(vals < 0, -mag, mag)
    lim = 1 << (7 + bd)
    out[pos] = np.clip(v, -lim, lim - 1)
    return out.reshape(th, tw)


def _palette_pred(parsed: Parsed, blk: int, plane: int, x: int, y: int, w: int, h: int) -> np.ndarray:
    b = parsed.blocks[blk]
    s = parsed.frame.seq
    sx, sy = (s.ssx, s.ssy) if plane else (0, 0)
    bsize = int(b[2])
    bw = T.BLOCK_W[bsize] >> sx
    bh = T.BLOCK_H[bsize] >> sy
    if plane:
        bw += 2 if bw < 4 else 0
        bh += 2 if bh < 4 else 0
    off = int(b[13] if plane == 0 else b[14])
    cmap = parsed.color_maps[off:off + bw * bh].reshape(bh, bw)
    colors = parsed.palette[int(b[12]) * 24 + plane * 8:int(b[12]) * 24 + plane * 8 + 8]
    bx, by = (int(b[1]) >> sx) * 4, (int(b[0]) >> sy) * 4
    return colors[cmap[y - by:y - by + h, x - bx:x - bx + w]].astype(np.int64)


def predict_block(parsed: Parsed, planes: list, txb: np.ndarray) -> np.ndarray:
    """The prediction of one intra transform block (h x w int64)."""
    kind, p, x, y, tx, tx_type, eob, coef, blk, mode, flags = (int(v) for v in txb[:11])
    s, hd = parsed.frame.seq, parsed.frame.hdr
    sx, sy = (s.ssx, s.ssy) if p else (0, 0)
    w, h = T.TX_W[tx], T.TX_H[tx]
    b = parsed.blocks[blk]
    frame = planes[p]
    if flags & F_PALETTE:
        return _palette_pred(parsed, blk, p, x, y, w, h)
    max_x = ((hd.mi_cols * 4) >> sx) - 1
    max_y = ((hd.mi_rows * 4) >> sy) - 1
    angle = int(b[5] if p == 0 else b[6])
    pred = predict_intra(frame, x, y, flags, mode, w, h, angle, max(0, int(b[7])), int(txb[12]), max_x, max_y,
                         s.bit_depth, bool(s.enable_intra_edge_filter))
    if flags & F_CFL:
        pred = _cfl(planes[0], pred, x, y, w, h, sx, sy, int(b[8] if p == 1 else b[9]), int(b[17]), int(b[18]),
                    s.bit_depth)
    return pred


def _cfl(luma: np.ndarray, dc: np.ndarray, x: int, y: int, w: int, h: int, sx: int, sy: int, alpha: int,
         max_w: int, max_h: int, bd: int) -> np.ndarray:
    ly = np.minimum((y + np.arange(h)) << sy, max_h - (1 << sy))
    lx = np.minimum((x + np.arange(w)) << sx, max_w - (1 << sx))
    t = np.zeros((h, w), np.int64)
    for dy in range(sy + 1):
        for dx in range(sx + 1):
            t += luma[(ly + dy)[:, None], (lx + dx)[None, :]]
    L = t << (3 - sx - sy)
    sh = (w.bit_length() - 1) + (h.bit_length() - 1)
    avg = (int(L.sum()) + (1 << (sh - 1))) >> sh
    d = alpha * (L - avg)
    scaled = np.where(d >= 0, (d + 32) >> 6, -((-d + 32) >> 6))
    return np.clip(dc + scaled, 0, (1 << bd) - 1)


def intrabc_predict(parsed: Parsed, planes: list, txb: np.ndarray) -> None:
    """The IntraBC copy of one plane of a block (bilinear at half samples)."""
    kind, p, x, y = (int(v) for v in txb[:4])
    blk = int(txb[8])
    w, h = int(txb[14]), int(txb[15])
    s, hd = parsed.frame.seq, parsed.frame.hdr
    sx, sy = (s.ssx, s.ssy) if p else (0, 0)
    mv_r, mv_c = int(parsed.blocks[blk, 15]), int(parsed.blocks[blk, 16])
    frame = planes[p]
    r0, r1 = (5, 9) if s.bit_depth == 12 else (3, 11)
    last_x = ((hd.width + sx) >> sx) - 1
    last_y = ((hd.height + sy) >> sy) - 1
    px = (x << 4) + ((2 * mv_c) >> sx)
    py = (y << 4) + ((2 * mv_r) >> sy)
    fx, fy = px & 15, py & 15
    ix, iy = px >> 4, py >> 4
    rows = np.clip(iy + np.arange(h + 1), 0, last_y)
    cols = np.clip(ix + np.arange(w + 1), 0, last_x)
    src = frame[rows[:, None], cols[None, :]].astype(np.int64)
    hx = (src[:, :w] * (128 - 8 * fx) + src[:, 1:w + 1] * (8 * fx) + (1 << (r0 - 1))) >> r0
    out = (hx[:h] * (128 - 8 * fy) + hx[1:h + 1] * (8 * fy) + (1 << (r1 - 1))) >> r1
    frame[y:y + h, x:x + w] = np.clip(out, 0, (1 << s.bit_depth) - 1)


def reconstruct_block(parsed: Parsed, planes: list, txb: np.ndarray) -> None:
    """Dequantise, inverse transform and add one transform block."""
    kind, p, x, y, tx, tx_type, eob = (int(v) for v in txb[:7])
    if eob <= 0:
        return
    s = parsed.frame.seq
    flags = int(txb[10])
    coef = dequantize(parsed, txb)
    res = inverse_transform(coef, tx, tx_type, s.bit_depth, bool(flags & F_LOSSLESS))
    w, h = T.TX_W[tx], T.TX_H[tx]
    frame = planes[p]
    frame[y:y + h, x:x + w] = np.clip(frame[y:y + h, x:x + w] + res, 0, (1 << s.bit_depth) - 1)


def reconstruct(parsed: Parsed) -> list:
    """Every row of the transform-block table in order -> the planes before
    the loop filters (int32, :func:`plane_dims`)."""
    planes = [np.zeros(d, np.int64) for d in plane_dims(parsed)]
    for txb in parsed.txbs:
        kind = int(txb[0])
        if kind == KIND_INTRABC:
            intrabc_predict(parsed, planes, txb)
            continue
        if kind == KIND_INTRA:
            p, x, y, tx = (int(v) for v in txb[1:5])
            w, h = T.TX_W[tx], T.TX_H[tx]
            planes[p][y:y + h, x:x + w] = predict_block(parsed, planes, txb)
        reconstruct_block(parsed, planes, txb)
    return [pl.astype(np.int32) for pl in planes]
