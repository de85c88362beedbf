"""AV1 film grain synthesis (section 7.18.3 of the AV1 specification), as
libaom's decoder applies it to the frame it outputs.

:func:`noise_planes` depends on the frame header's grain parameters and the
frame size only. The host makes the luma and chroma grain templates (the
16-bit random register over the Gaussian sequence, then the
auto-regressive filter; 73x82 samples at most) and draws each 32x32
block's offset (the generator seeded per block row); torch ops on the
planes' device gather the blocks from the templates and blend their
overlaps into one noise plane each. :func:`apply` is the part that reads
the samples: each plane's scaling function (the piecewise-linear lookup,
interpolated above 8 bits), chroma from the co-located luma average, and
the clip to the full or restricted range, as torch ops on the planes'
device: the card's for ``data/av1_cuda.py``, the CPU for its plain
versions.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from dspnet_torch.data import av1_tables as T
from dspnet_torch.data.av1_obu import FilmGrain


class _Rng:
    def __init__(self, seed: int):
        self.r = seed & 0xFFFF

    def bits(self, n: int) -> int:
        r = self.r
        bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = (r >> 1) | (bit << 15)
        self.r = r
        return (r >> (16 - n)) & ((1 << n) - 1)


def _r2(x: int, n: int) -> int:
    return (x + (1 << (n - 1))) >> n if n else x


def templates(g: FilmGrain, bd: int, mono: bool, ssx: int, ssy: int) -> List[np.ndarray]:
    """The grain templates: luma 73x82, chroma (38 or 73) x (44 or 82)."""
    gauss = T.table("gaussian_sequence")
    center = 128 << (bd - 8)
    gmin, gmax = -center, (256 << (bd - 8)) - 1 - center
    shift = 12 - bd + g.grain_scale_shift
    rng = _Rng(g.seed)
    luma = [[0] * 82 for _ in range(73)]
    if g.points_y:
        for y in range(73):
            for x in range(82):
                luma[y][x] = _r2(int(gauss[rng.bits(11)]), shift)
    lag = g.ar_coeff_lag
    ar_shift = g.ar_coeff_shift
    if g.points_y:
        for y in range(3, 73):
            for x in range(3, 82 - 3):
                s = 0
                pos = 0
                for dr in range(-lag, 1):
                    for dc in range(-lag, lag + 1):
                        if dr == 0 and dc == 0:
                            break
                        s += luma[y + dr][x + dc] * g.ar_coeffs_y[pos]
                        pos += 1
                luma[y][x] = min(gmax, max(gmin, luma[y][x] + _r2(s, ar_shift)))
    out = [np.array(luma, np.int32)]
    if mono:
        return out
    cw, ch = (44 if ssx else 82), (38 if ssy else 73)
    chroma = []
    for seed_xor, pts in ((0xB524, g.points_cb), (0x49D8, g.points_cr)):
        rng = _Rng(g.seed ^ seed_xor)
        c = [[0] * cw for _ in range(ch)]
        if pts or g.chroma_scaling_from_luma:
            for y in range(ch):
                for x in range(cw):
                    c[y][x] = _r2(int(gauss[rng.bits(11)]), shift)
        chroma.append(c)
    cb, cr = chroma
    for y in range(3, ch):
        for x in range(3, cw - 3):
            s0 = s1 = 0
            pos = 0
            for dr in range(-lag, 1):
                for dc in range(-lag, lag + 1):
                    c0 = g.ar_coeffs_cb[pos] if g.ar_coeffs_cb else 0
                    c1 = g.ar_coeffs_cr[pos] if g.ar_coeffs_cr else 0
                    if dr == 0 and dc == 0:
                        if g.points_y:
                            lx, ly = ((x - 3) << ssx) + 3, ((y - 3) << ssy) + 3
                            lum = 0
                            for i in range(ssy + 1):
                                for j in range(ssx + 1):
                                    lum += luma[ly + i][lx + j]
                            lum = _r2(lum, ssx + ssy)
                            s0 += lum * c0
                            s1 += lum * c1
                        break
                    s0 += c0 * cb[y + dr][x + dc]
                    s1 += c1 * cr[y + dr][x + dc]
                    pos += 1
            if g.points_cb or g.chroma_scaling_from_luma:
                cb[y][x] = min(gmax, max(gmin, cb[y][x] + _r2(s0, ar_shift)))
            if g.points_cr or g.chroma_scaling_from_luma:
                cr[y][x] = min(gmax, max(gmin, cr[y][x] + _r2(s1, ar_shift)))
    return out + [np.array(cb, np.int32), np.array(cr, np.int32)]


def _block_offsets(g: FilmGrain, rows: int, cols: int) -> np.ndarray:
    """The random offset of each 32x32 block: int64 (rows, cols, 2) as
    (oy, ox), from the generator seeded per block row."""
    out = np.zeros((rows, cols, 2), np.int64)
    for ln in range(rows):
        rng = _Rng(g.seed)
        rng.r ^= ((ln * 37 + 178) & 255) << 8
        rng.r ^= (ln * 173 + 105) & 255
        for bx in range(cols):
            rnd = rng.bits(8)
            out[ln, bx] = (rnd & 15, rnd >> 4)
    return out


def noise_planes(g: FilmGrain, bd: int, mono: bool, ssx: int, ssy: int, w: int, h: int,
                 device="cpu") -> List[torch.Tensor]:
    """The noise of each plane (int64, the plane's size) on ``device``: the
    templates and the blocks' offsets on the host, the blocks gathered from
    the templates and their overlaps blended as torch ops."""
    tmpl = templates(g, bd, mono, ssx, ssy)
    center = 128 << (bd - 8)
    gmin, gmax = -center, (256 << (bd - 8)) - 1 - center
    rows = (((h + 1) // 2) + 15) // 16
    cols = (((w + 1) // 2) + 15) // 16
    offs = torch.from_numpy(_block_offsets(g, rows, cols)).to(device)
    out = []
    for p in range(1 if mono else 3):
        psx, psy = (ssx, ssy) if p else (0, 0)
        ph, pw = (h + psy) >> psy, (w + psx) >> psx
        t = torch.from_numpy(tmpl[p]).to(device, torch.int64)
        oy, ox = offs[..., 0], offs[..., 1]
        poy = 6 + oy if psy else 9 + oy * 2  # (rows, cols)
        pox = 6 + ox if psx else 9 + ox * 2
        step = 32 >> psx  # a block's stride in a stripe; it covers step + 2 >> psx columns
        c = torch.arange(pw, device=device)
        b, j = c // step, c % step
        i = torch.arange(34 >> psy, device=device)[None, :, None]
        # each stripe (block row): the samples of the last block covering each column
        st = t[poy[:, b][:, None, :] + i, pox[:, b][:, None, :] + j]  # (rows, rows of a stripe, pw)
        if g.overlap:
            bp = torch.clamp(b - 1, min=0)
            jt = torch.clamp(j, max=(2 >> psx) - 1)
            old = t[poy[:, bp][:, None, :] + i, pox[:, bp][:, None, :] + step + jt]  # the previous block's tail
            if psx == 0:
                mixed = torch.where(j == 0, old * 27 + st * 17, old * 17 + st * 27)
            else:
                mixed = old * 23 + st * 22
            st = torch.where((b > 0) & (j < (2 >> psx)), torch.clamp(_r2v(mixed, 5), gmin, gmax), st)
        sh = 5 - psy
        y = torch.arange(ph, device=device)
        ln = y >> sh
        iy = y - (ln << sh)
        img = st[ln, iy]
        if g.overlap:
            above = st[torch.clamp(ln - 1, min=0), torch.clamp(iy, max=(2 >> psy) - 1) + (32 >> psy)]  # the stripe above's tail
            if psy == 0:
                mixed = torch.where((iy == 0)[:, None], above * 27 + img * 17, above * 17 + img * 27)
            else:
                mixed = above * 23 + img * 22
            on = ((ln > 0) & (iy < (2 >> psy)))[:, None]
            img = torch.where(on, torch.clamp(_r2v(mixed, 5), gmin, gmax), img)
        out.append(img)
    return out


def _r2v(x, n: int):
    return (x + (1 << (n - 1))) >> n


def scaling_luts(g: FilmGrain) -> List[np.ndarray]:
    """ScalingLut of each plane (int32, 257 entries: the last repeats)."""
    out = []
    for p in range(3):
        pts = g.points_y if (p == 0 or g.chroma_scaling_from_luma) else (g.points_cb if p == 1 else g.points_cr)
        lut = np.zeros(257, np.int32)
        if pts:
            lut[:pts[0][0]] = pts[0][1]
            for i in range(len(pts) - 1):
                dy = pts[i + 1][1] - pts[i][1]
                dx = pts[i + 1][0] - pts[i][0]
                delta = dy * ((65536 + (dx >> 1)) // dx)
                for x in range(dx):
                    lut[pts[i][0] + x] = pts[i][1] + ((x * delta + 32768) >> 16)
            lut[pts[-1][0]:256] = pts[-1][1]
        lut[256] = lut[255]
        out.append(lut)
    return out


def _scale(lut: torch.Tensor, index: torch.Tensor, bd: int) -> torch.Tensor:
    if bd == 8:
        return lut[index]
    shift = bd - 8
    x = index >> shift
    rem = index - (x << shift)
    start, end = lut[x], lut[x + 1]
    return start + (((end - start) * rem + (1 << (shift - 1))) >> shift)


def apply(planes: List[torch.Tensor], noise: List[torch.Tensor], g: FilmGrain, bd: int, ssx: int, ssy: int,
          matrix: int) -> List[torch.Tensor]:
    """Film grain on the output planes (cut to the frame size, int32
    tensors on one device) with ``noise`` (:func:`noise_planes` on that
    device) -> new planes."""
    luts = [torch.from_numpy(v).to(planes[0].device, torch.int64) for v in scaling_luts(g)]
    if g.clip_to_restricted_range:
        lo, hi_y = 16 << (bd - 8), 235 << (bd - 8)
        hi_c = hi_y if matrix == 0 else 240 << (bd - 8)
    else:
        lo, hi_y, hi_c = 0, (256 << (bd - 8)) - 1, (256 << (bd - 8)) - 1
    shift = g.scaling_shift
    y = planes[0].to(torch.int64)
    out = [None] * len(planes)
    mx = (1 << bd) - 1
    if len(planes) > 1:
        h, w = y.shape
        ch, cw = planes[1].shape
        lx = torch.arange(cw, device=y.device) << ssx
        ly = torch.arange(ch, device=y.device) << ssy
        a = y[ly][:, lx]
        if ssx:
            b = y[ly][:, torch.clamp(lx + 1, max=w - 1)]
            avg = (a + b + 1) >> 1
        else:
            avg = a
        for p, pts, mult, lmult, off in ((1, g.points_cb, g.cb_mult, g.cb_luma_mult, g.cb_offset),
                                         (2, g.points_cr, g.cr_mult, g.cr_luma_mult, g.cr_offset)):
            orig = planes[p].to(torch.int64)
            if pts or g.chroma_scaling_from_luma:
                if g.chroma_scaling_from_luma:
                    merged = avg
                else:
                    comb = avg * (lmult - 128) + orig * (mult - 128)
                    merged = torch.clamp((comb >> 6) + ((off - 256) << (bd - 8)), 0, mx)
                n = noise[p]
                n = (_scale(luts[p], merged, bd) * n + (1 << (shift - 1))) >> shift
                out[p] = torch.clamp(orig + n, lo, hi_c).to(torch.int32)
            else:
                out[p] = planes[p]
    if g.points_y:
        n = noise[0]
        n = (_scale(luts[0], y, bd) * n + (1 << (shift - 1))) >> shift
        out[0] = torch.clamp(y + n, lo, hi_y).to(torch.int32)
    else:
        out[0] = planes[0]
    return out
