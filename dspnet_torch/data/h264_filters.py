"""The plain H.264 deblocking filter (ITU-T H.264 8.7) of one frame, in place.

The standard defines the filter macroblock by macroblock in decode (raster)
order: each macroblock filters its vertical edges left to right, then its
horizontal edges top to bottom, luma and chroma, on samples its left and
top neighbours have already filtered. (A frame-wide pass of every vertical
edge and then every horizontal edge is not the same: macroblock (x, y)'s
top edge reads rows that (x + 1, y - 1)'s left edge has changed.)
Macroblocks on one wavefront x + 2y touch disjoint samples, so the plain
version filters a wavefront's macroblocks together, edge by edge
(``csrc/h264.cu``'s ``h264_filter_kernel`` keeps the same order with a row
of macroblocks a block, each row after the one above).

* bS (8.7.2.1): 4 on a macroblock edge with an intra side, 3 inside an intra
  macroblock, 2 where either 4x4 block (the 8x8 block under
  ``transform_size_8x8_flag``) has coefficients, 1 where the two sides use
  other reference pictures, another number of vectors, or vectors apart by
  4 quarter samples or more (FFmpeg's ``check_mv``, which is the standard's
  rule), else 0;
* alpha, beta and tC0 from the averaged QP (0 for I_PCM), the current
  slice's ``FilterOffsetA`` / ``B``, and for chroma each side's QP_C;
* ``disable_deblocking_filter_idc`` 1 filters nothing of the slice's
  macroblocks, 2 no edge shared with another slice; internal 4x4 luma edges
  are skipped in an 8x8-transform macroblock.
"""

from __future__ import annotations

import numpy as np

from dspnet_torch.data import h264_tables as T
from dspnet_torch.data.h264_parse import BLK_AT, F_NZ, F_QP, F_SLICE, F_T8, F_TYPE, T_PCM


def check_mv(mv, ref_id, p, q):
    """FFmpeg's ``check_mv`` between the 4x4 blocks at ``p`` and ``q``
    ((y4, x4) index arrays) of a motion field (``ref_id`` -1 for an unused
    list), elementwise: 1 where the sides' references or vectors differ."""
    rp0, rp1, rq0, rq1 = ref_id[0][p], ref_id[1][p], ref_id[0][q], ref_id[1][q]

    def far(a, b):
        return (np.abs(a[..., 0] - b[..., 0]) >= 4) | (np.abs(a[..., 1] - b[..., 1]) >= 4)

    mp0, mp1 = mv[0][p].astype(np.int64), mv[1][p].astype(np.int64)
    mq0, mq1 = mv[0][q].astype(np.int64), mv[1][q].astype(np.int64)
    v = rp0 != rq0
    v = np.where(~v & (rp0 != -1), far(mp0, mq0), v)
    v = np.where(~v, (rp1 != rq1) | far(mp1, mq1), v)
    cross = (rp0 != rq1) | (rp1 != rq0) | far(mp0, mq1) | far(mp1, mq0)
    return np.where(v, cross, False).astype(np.int64)


#: 4x4 block index by position in the macroblock (y, x)
_BLK = np.array(BLK_AT, np.int64)


def strengths(table, mv, ref_id, slices, mb_w: int, mb_h: int) -> np.ndarray:
    """bS of every luma edge segment of the picture: (n_mb, 2, 4, 4) by
    macroblock, direction (vertical, horizontal), edge and segment; 0 where
    the edge is not filtered (a picture edge, ``disable_deblocking_filter_idc``
    1, or 2 across slices; the 4x4 edges of an 8x8-transform macroblock)."""
    n = mb_w * mb_h
    mb = np.arange(n)[:, None, None, None]
    d = np.arange(2)[None, :, None, None]
    e = np.arange(4)[None, None, :, None]
    k = np.arange(4)[None, None, None, :]
    mx, my = mb % mb_w, mb // mb_w
    qy = 4 * my + np.where(d == 0, k, e)
    qx = 4 * mx + np.where(d == 0, e, k)
    py, px = np.where(d == 0, qy, qy - 1), np.where(d == 0, qx - 1, qx)
    shape = (n, 2, 4, 4)
    qy, qx, py, px = (np.broadcast_to(a, shape) for a in (qy, qx, py, px))
    ok = (py >= 0) & (px >= 0)
    pyc, pxc = np.maximum(py, 0), np.maximum(px, 0)
    mbq = np.broadcast_to(mb, shape)
    mbp = (pyc >> 2) * mb_w + (pxc >> 2)
    typ = table[:, F_TYPE]
    intra = (typ[mbq] <= T_PCM) | (typ[mbp] <= T_PCM)
    edge0 = np.broadcast_to(e == 0, shape)
    nz = table[:, F_NZ].astype(np.int64)
    nzq = (nz[mbq] >> _BLK[qy & 3, qx & 3]) & 1
    nzp = (nz[mbp] >> _BLK[pyc & 3, pxc & 3]) & 1
    mvc = check_mv(mv, ref_id, (pyc, pxc), (qy, qx))
    bs = np.where(intra, np.where(edge0, 4, 3), np.where((nzq | nzp) == 1, 2, mvc))
    sl = table[:, F_SLICE]
    idc = np.array([s.deblock[0] for s in slices], np.int64)[sl]
    filtered = ok & (idc[mbq] != 1)
    filtered &= ~(edge0 & (idc[mbq] == 2) & (sl[mbp] != sl[mbq]))
    filtered &= ~((table[:, F_T8][mbq] == 1) & np.broadcast_to(e % 2 == 1, shape))
    return np.where(filtered, bs, 0)


def _filter_lines(P, Q, bs, alpha, beta, tc0, chroma: bool):
    """Filters sample lines across an edge: P = (n, 4) p0..p3, Q = (n, 4)
    q0..q3 (int64, changed in place), per line ``bs``, ``alpha``, ``beta``
    and ``tc0`` (n, 3) by bS 1-3."""
    p0, p1, p2, p3 = P[:, 0], P[:, 1], P[:, 2], P[:, 3]
    q0, q1, q2, q3 = Q[:, 0], Q[:, 1], Q[:, 2], Q[:, 3]
    on = (bs > 0) & (np.abs(p0 - q0) < alpha) & (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta)
    if not on.any():
        return
    ap, aq = np.abs(p2 - p0), np.abs(q2 - q0)
    np0, np1, np2 = p0.copy(), p1.copy(), p2.copy()
    nq0, nq1, nq2 = q0.copy(), q1.copy(), q2.copy()
    weak = on & (bs < 4)
    if weak.any():
        t0 = tc0[np.arange(len(bs)), np.clip(bs - 1, 0, 2)]
        tc = t0 + 1 if chroma else t0 + (ap < beta) + (aq < beta)
        delta = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
        np0 = np.where(weak, np.clip(p0 + delta, 0, 255), np0)
        nq0 = np.where(weak, np.clip(q0 - delta, 0, 255), nq0)
        if not chroma:
            dp1 = np.clip((p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1, -t0, t0)
            dq1 = np.clip((q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1, -t0, t0)
            np1 = np.where(weak & (ap < beta), p1 + dp1, np1)
            nq1 = np.where(weak & (aq < beta), q1 + dq1, nq1)
    strong = on & (bs == 4)
    if strong.any():
        if chroma:
            np0 = np.where(strong, (2 * p1 + p0 + q1 + 2) >> 2, np0)
            nq0 = np.where(strong, (2 * q1 + q0 + p1 + 2) >> 2, nq0)
        else:
            small = np.abs(p0 - q0) < ((alpha >> 2) + 2)
            sp = strong & small & (ap < beta)
            sq = strong & small & (aq < beta)
            np0 = np.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                           np.where(strong, (2 * p1 + p0 + q1 + 2) >> 2, np0))
            np1 = np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, np1)
            np2 = np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, np2)
            nq0 = np.where(sq, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                           np.where(strong, (2 * q1 + q0 + p1 + 2) >> 2, nq0))
            nq1 = np.where(sq, (p0 + q0 + q1 + q2 + 2) >> 2, nq1)
            nq2 = np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, nq2)
    P[:, 0], P[:, 1], P[:, 2] = np0, np1, np2
    Q[:, 0], Q[:, 1], Q[:, 2] = nq0, nq1, nq2


def _edges(plane, rows, cols, vertical: bool, bs, alpha, beta, tc0, chroma: bool):
    """Filters lines of one edge of several macroblocks: line i crosses the
    edge at plane position (rows[i], cols[i]) (its first q sample)."""
    off = np.arange(-4, 4)
    if vertical:
        r, c = rows[:, None], cols[:, None] + off[None]
    else:
        r, c = rows[:, None] + off[None], cols[:, None]
    r, c = np.broadcast_to(r, (len(rows), 8)), np.broadcast_to(c, (len(rows), 8))
    px = plane[r, c].astype(np.int64)
    P, Q = px[:, 3::-1].copy(), px[:, 4:].copy()
    _filter_lines(P, Q, bs, alpha, beta, tc0, chroma)
    plane[r, c] = np.concatenate([P[:, ::-1], Q], 1).astype(plane.dtype)


def deblock_picture(Y, U, V, table, mv, ref_id, slices, mb_w: int, mb_h: int) -> None:
    """Filters the frame's planes in place (see the module's text);
    ``mv`` / ``ref_id`` the picture's motion field (2, H4, W4, 2) /
    (2, H4, W4); ``slices`` the ``h264_recon.SliceInfo`` of each slice."""
    bs_all = strengths(table, mv, ref_id, slices, mb_w, mb_h)
    typ, sl = table[:, F_TYPE], table[:, F_SLICE]
    qp = np.where(typ == T_PCM, 0, table[:, F_QP]).astype(np.int64)
    offsets = np.array([s.chroma_offsets for s in slices], np.int64)
    a_off = np.array([s.deblock[1] for s in slices], np.int64)[sl]
    b_off = np.array([s.deblock[2] for s in slices], np.int64)[sl]
    qpc = [T.CHROMA_QP[np.clip(qp + offsets[sl, c], 0, 51)].astype(np.int64) for c in range(2)]
    alpha_t, beta_t, tc0_t = T.ALPHA.astype(np.int64), T.BETA.astype(np.int64), T.TC0.astype(np.int64)
    for w in range(mb_w + 2 * (mb_h - 1)):
        ys = np.arange(mb_h)
        xs = w - 2 * ys
        keep = (xs >= 0) & (xs < mb_w)
        ys, xs = ys[keep], xs[keep]
        mbs = ys * mb_w + xs
        for d in range(2):
            vertical = d == 0
            nb = np.where(vertical, mbs - 1, mbs - mb_w)
            for e in range(4):
                bs = bs_all[mbs, d, e]  # (m, 4)
                on = bs.any(1)
                if not on.any():
                    continue
                m, x, y, bs = mbs[on], xs[on], ys[on], bs[on]
                p = nb[on] if e == 0 else m
                for plane, lines, qq in ((Y, 16, None), (U, 8, 0), (V, 8, 1)):
                    if plane is None or (qq is not None and e % 2):
                        continue
                    if qq is None:
                        qav = (qp[p] + qp[m] + 1) >> 1
                        step, size = 4, 16
                    else:
                        qav = (qpc[qq][p] + qpc[qq][m] + 1) >> 1
                        step, size = 2, 8
                    ia, ib = np.clip(qav + a_off[m], 0, 51), np.clip(qav + b_off[m], 0, 51)
                    line = np.arange(lines)
                    base_r, base_c = size * y, size * x
                    if vertical:
                        rows = (base_r[:, None] + line[None]).ravel()
                        cols = np.repeat(base_c + step * e, lines)
                    else:
                        rows = np.repeat(base_r + step * e, lines)
                        cols = (base_c[:, None] + line[None]).ravel()
                    seg = line // (4 if qq is None else 2)
                    lbs = bs[:, seg].ravel()
                    _edges(plane, rows, cols, vertical, lbs, np.repeat(alpha_t[ia], lines),
                           np.repeat(beta_t[ib], lines), np.repeat(tc0_t[ia], lines, axis=0), qq is not None)
