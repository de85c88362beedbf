"""cv2 5.0.0's ``putText`` and ``getTextSize`` for the Hershey faces the
demo uses, on numpy, bit for bit, with no cv2 (the card's machine has none).

cv2 5 draws a Hershey call with a TrueType font it carries, "Rubik for
OpenCV Light" (``fonts/rubik_opencv.ttf``, a variable font, ``wght``
300-900; ``tests/make_text_fixtures.py`` takes it out of cv2's library).
What this module reproduces, each step measured against cv2 5.0.0 and its
machine code:

* the face: ``FONT_HERSHEY_SIMPLEX`` is size ``rint(scale * 100 / 3.7)``
  (half to even, in double), weight 400 at thickness <= 1 and 600 above;
  ``FONT_HERSHEY_PLAIN`` divides by 6.6 and takes 400 / 800. The scale is
  ``float32(size) / float32(ascent)`` pixels per font unit;
* the instance: ``avar`` and F2Dot14 rounding (:meth:`Font.normalize`),
  each tuple's scalar in 16.16 fixed point (C division), an untouched
  point's delta by IUP in integers, each tuple's contribution
  ``(delta * scalar) >> 8`` summed and shifted down 8 more: the points stay
  integers (floor). The phantom points move the ``glyf`` header's box
  (xMin by the left phantom, xMax by the advance phantom) and the advance;
  a glyph with no contours keeps ``hmtx``'s advance and no variation;
* the rasteriser: stb_truetype's (v1.26, its "v2" signed-area scanline
  rasteriser, in float32, TrueType midpoints in integers, flatness
  0.35 px), into a bitmap of the box padded by
  ``max(ceil(w / 10), ceil(h / 10)) + 10`` pixels on each side, the edges
  shifted by that padding (the shift is part of the float rounding); the
  coverage is ``int(|sum| * 255 + 0.5)`` clamped to 255, cropped to its
  non-zero pixels;
* the layout: the pen starts at ``org`` (the baseline's left end), each
  glyph's bitmap at its integer offset, the pen advancing by
  ``rint(float32(advance) * scale * 64) >> 6`` pixels; no kerning;
* the blend: glyph after glyph, ``(d * (255 - a) + c * a + 127) // 255``
  per channel;
* the size: ``((pen end + 1, size), baseline)``, the baseline being one
  more than the lowest row of ink below the text's baseline (0 if none);
  ``((0, 0), 0)`` for "".

Refused by name, where cv2 would do something else: other Hershey faces
(cv2 maps them to a serif or an italic face), ``FONT_ITALIC``,
``bottomLeftOrigin``, a thickness outside 1-3, a scale <= 0 (cv2 mirrors
the text) or one that rounds to size 0, images other than uint8 with 1 or
3 channels, and any character outside Rubik's ``cmap`` (cv2 draws those in
WenQuanYi Micro Hei, which the port does not carry), and a character
beyond printable ASCII whose glyph leaves points to IUP (cv2's IUP has
cases the port does not reproduce). ``python tests/make_text_fixtures.py
--checks`` holds every printable ASCII glyph to cv2 at sizes 4-100 and
weights 400, 600 and 800, and the blend on random triples.

Glyph bitmaps are cached per (glyph, size, weight) and each string's
layout per (text, size, weight): a video labels the same strings frame
after frame. :data:`STATS` counts the string cache's hits and misses.
"""

from __future__ import annotations

import functools
import hashlib
import math
from collections import OrderedDict
from pathlib import Path
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from dspnet_torch.utils.truetype import Font

FONT_HERSHEY_SIMPLEX = 0
FONT_HERSHEY_PLAIN = 1
FONT_ITALIC = 16

FONT_PATH = Path(__file__).resolve().parent / "fonts" / "rubik_opencv.ttf"
FONT_SHA256 = "7cdd1f5e7f04df8091c98e3ff2060b5f0d231b2582e344e7727581b7841c7b77"

#: face -> (size divisor, weight at thickness <= 1, weight above)
_FACES = {FONT_HERSHEY_SIMPLEX: (3.7, 400, 600), FONT_HERSHEY_PLAIN: (6.6, 400, 800)}
_FACE_NAMES = {0: "FONT_HERSHEY_SIMPLEX", 1: "FONT_HERSHEY_PLAIN", 2: "FONT_HERSHEY_DUPLEX",
               3: "FONT_HERSHEY_COMPLEX", 4: "FONT_HERSHEY_TRIPLEX", 5: "FONT_HERSHEY_COMPLEX_SMALL",
               6: "FONT_HERSHEY_SCRIPT_SIMPLEX", 7: "FONT_HERSHEY_SCRIPT_COMPLEX"}
_LAYOUT_CACHE = 4096

F32 = np.float32
#: the string-layout cache's hits and misses since the process started
STATS = {"hits": 0, "misses": 0}


class TextError(ValueError):
    """A call this module refuses rather than draw otherwise than cv2."""


@functools.lru_cache(maxsize=None)
def font() -> Font:
    """The font cv2 5.0.0 draws its Hershey faces with, its sha256 checked."""
    data = FONT_PATH.read_bytes()
    got = hashlib.sha256(data).hexdigest()
    if got != FONT_SHA256:
        raise TextError(f"{FONT_PATH} has sha256 {got}, not cv2 5.0.0's Rubik ({FONT_SHA256}); "
                        "rewrite it with tests/make_text_fixtures.py")
    return Font(data)


def hershey_to_truetype(face: int, scale: float, thickness: int) -> Tuple[int, int]:
    """cv2 5.0.0's (size in pixels, ``wght``) for a Hershey face, scale and
    thickness."""
    if face & FONT_ITALIC:
        raise TextError("FONT_ITALIC is refused: cv2 5 draws it with its italic Rubik, which the port does not carry")
    if face not in _FACES:
        name = _FACE_NAMES.get(face, f"font face {face}")
        raise TextError(f"{name} is refused: only FONT_HERSHEY_SIMPLEX and FONT_HERSHEY_PLAIN are drawn as cv2 5 "
                        "draws them")
    if not scale > 0:
        raise TextError(f"font scale {scale} is refused: cv2 mirrors the text at a scale <= 0")
    if thickness not in (1, 2, 3):
        raise TextError(f"thickness {thickness} is refused: only 1, 2 and 3 are drawn")
    div, thin, thick = _FACES[face]
    size = int(np.rint(float(scale) * 100.0 / div))
    if size < 1:
        raise TextError(f"font scale {scale} is refused: it rounds to a {size}-pixel font")
    return size, thin if thickness <= 1 else thick


# -- cv2's instance of a glyph ---------------------------------------------
def _scalar16(coords, start, peak, end) -> int:
    """A tuple's scalar in cv2's 16.16 fixed point: 65536 times each axis's
    factor, one C (truncating) division at a time, on F2Dot14 integers."""
    s = 65536
    for values in zip(coords, start, peak, end):
        c, st, pk, en = (int(round(float(v) * 16384)) for v in values)
        if pk == 0 or c == pk:
            continue
        if (st, en) == (min(pk, 0), max(pk, 0)):
            if c == 0 or (c > 0) != (pk > 0) or abs(c) > abs(pk):
                return 0
            s = s * abs(c) // abs(pk)
        elif c <= st or c >= en:
            return 0
        else:
            s = s * (c - st) // (pk - st) if c < pk else s * (en - c) // (en - pk)
    return s


def _fixed_deltas(gid: int, n: int, weight: int):
    """cv2's summed deltas of a glyph's ``n`` points (one per component of a
    composite) and its four phantoms, in font units, floored."""
    f = font()
    coords = f.normalize({"wght": weight})
    acc_x = np.zeros(n + 4, np.int64)
    acc_y = np.zeros(n + 4, np.int64)
    for peak, start, end, dx, dy in f.variation_tuples(gid, integer_iup=True):
        s = _scalar16(coords, start, peak, end)
        if s:
            acc_x += (dx.astype(np.int64) * s) >> 8
            acc_y += (dy.astype(np.int64) * s) >> 8
    return acc_x >> 8, acc_y >> 8


@functools.lru_cache(maxsize=None)
def _instance(gid: int, weight: int):
    """cv2's instance of a glyph at ``wght`` = ``weight``: (xs, ys int
    arrays, on-curve flags, contour ends, box (xMin, yMin, xMax, yMax),
    advance in font units); None for a glyph with no contours. A composite
    is joined as stb_truetype joins it: each component's own instance,
    moved by its offset and the offset's variation."""
    raw = font().raw_glyph(gid)
    n = len(raw.components) or len(raw.xs)
    if not n:
        return None
    dx, dy = _fixed_deltas(gid, n, weight)
    if raw.components:
        parts = []
        for i, (cid, ox, oy, m, xy) in enumerate(raw.components):
            if not xy or m != (1.0, 0.0, 0.0, 1.0):
                raise TextError(f"glyph {gid} ({_name(gid)}) is a scaled or point-matched composite, "
                                "which is refused")
            sub = _instance(cid, weight)
            if sub is not None:
                parts.append((sub[0] + ox + dx[i], sub[1] + oy + dy[i], sub[2], sub[3]))
        if not parts:
            return None
        xs, ys, on = (np.concatenate([p[k] for p in parts]) for k in range(3))
        ends, total = [], 0
        for p in parts:
            ends.extend(e + total for e in p[3])
            total += len(p[0])
    else:
        xs, ys = raw.xs.astype(np.int64) + dx[:n], raw.ys.astype(np.int64) + dy[:n]
        on, ends = raw.on_curve, list(raw.end_points)
    x0, y0, x1, y1 = raw.bbox
    box = (x0 + int(dx[n]), y0 + int(dy[n + 2]), x1 + int(dx[n + 1]), y1 + int(dy[n + 3]))
    advance = int(font().advances[gid]) + (box[2] - box[0]) - (x1 - x0)
    return xs, ys, on, ends, box, advance


def _name(gid: int) -> str:
    chars = [c for c, g in font().cmap.items() if g == gid]
    return f"U+{chars[0]:04X}" if chars else f"gid {gid}"


# -- stb_truetype's outline and rasteriser -----------------------------------
def _vertices(xs, ys, on, ends) -> List[Tuple[int, int, int, int, int]]:
    """stb_truetype's ``GetGlyphShape``: (type, x, y, cx, cy) with type 1 move,
    2 line, 3 quadratic; implied on-curve midpoints as ``(a + b) >> 1``."""
    xs, ys = [int(v) for v in xs], [int(v) for v in ys]
    out: List[Tuple[int, int, int, int, int]] = []
    n, next_move, j = len(xs), 0, 0
    was_off = start_off = False
    sx = sy = cx = cy = scx = scy = 0

    def close():
        if start_off:
            if was_off:
                out.append((3, (cx + scx) >> 1, (cy + scy) >> 1, cx, cy))
            out.append((3, sx, sy, scx, scy))
        else:
            out.append((3, sx, sy, cx, cy) if was_off else (2, sx, sy, 0, 0))

    i = 0
    while i < n:
        x, y = xs[i], ys[i]
        if next_move == i:
            if i:
                close()
            start_off = not on[i]
            if start_off:
                scx, scy = x, y
                if not on[i + 1]:
                    sx, sy = (x + xs[i + 1]) >> 1, (y + ys[i + 1]) >> 1
                else:
                    sx, sy = xs[i + 1], ys[i + 1]
                    i += 1
            else:
                sx, sy = x, y
            out.append((1, sx, sy, 0, 0))
            was_off = False
            next_move = 1 + ends[j]
            j += 1
        elif not on[i]:
            if was_off:
                out.append((3, (cx + x) >> 1, (cy + y) >> 1, cx, cy))
            cx, cy, was_off = x, y, True
        else:
            out.append((3, x, y, cx, cy) if was_off else (2, x, y, 0, 0))
            was_off = False
        i += 1
    close()
    return out


def _tesselate(points, x0, y0, x1, y1, x2, y2, flat2, n):
    if n > 16:
        return
    mx = (x0 + F32(2) * x1 + x2) / F32(4)
    my = (y0 + F32(2) * y1 + y2) / F32(4)
    dx = (x0 + x2) / F32(2) - mx
    dy = (y0 + y2) / F32(2) - my
    if dx * dx + dy * dy > flat2:
        _tesselate(points, x0, y0, (x0 + x1) / F32(2), (y0 + y1) / F32(2), mx, my, flat2, n + 1)
        _tesselate(points, mx, my, (x1 + x2) / F32(2), (y1 + y2) / F32(2), x2, y2, flat2, n + 1)
    else:
        points.append((x2, y2))


def _flatten(verts, flatness) -> List[list]:
    """stb_truetype's ``FlattenCurves``: float32 contours of points."""
    flat2 = flatness * flatness
    contours: List[list] = []
    x = y = F32(0)
    for t, vx, vy, cx, cy in verts:
        if t == 1:
            x, y = F32(vx), F32(vy)
            contours.append([(x, y)])
        elif t == 2:
            x, y = F32(vx), F32(vy)
            contours[-1].append((x, y))
        else:
            _tesselate(contours[-1], x, y, F32(cx), F32(cy), F32(vx), F32(vy), flat2, 0)
            x, y = F32(vx), F32(vy)
    return contours


class _Edge:
    __slots__ = ("x0", "y0", "x1", "y1", "invert")


class _Active:
    __slots__ = ("fx", "fdx", "fdy", "direction", "sy", "ey")


def _sort_edges(p: List[_Edge]) -> None:
    """stb_truetype's quicksort (median of three, down to 12) then insertion
    sort on ``y0``: equal keys keep stb's order, which fixes the order of
    the float sums."""
    def quick(lo: int, n: int) -> None:
        while n > 12:
            m = n >> 1
            c01, c12 = p[lo].y0 < p[lo + m].y0, p[lo + m].y0 < p[lo + n - 1].y0
            if c01 != c12:
                z = 0 if (p[lo].y0 < p[lo + n - 1].y0) == c12 else n - 1
                p[lo + z], p[lo + m] = p[lo + m], p[lo + z]
            p[lo], p[lo + m] = p[lo + m], p[lo]
            i, j = 1, n - 1
            while True:
                while p[lo + i].y0 < p[lo].y0:
                    i += 1
                while p[lo].y0 < p[lo + j].y0:
                    j -= 1
                if i >= j:
                    break
                p[lo + i], p[lo + j] = p[lo + j], p[lo + i]
                i, j = i + 1, j - 1
            if j < n - i:
                quick(lo, j)
                lo, n = lo + i, n - i
            else:
                quick(lo + i, n - i)
                n = j

    quick(0, len(p))
    for i in range(1, len(p)):
        t, j = p[i], i
        while j > 0 and t.y0 < p[j - 1].y0:
            p[j] = p[j - 1]
            j -= 1
        p[j] = t


def _clipped(sc, x: int, e: _Active, x0, y0, x1, y1) -> None:
    if y0 == y1 or y0 > e.ey or y1 < e.sy:
        return
    if y0 < e.sy:
        x0 = x0 + (x1 - x0) * (e.sy - y0) / (y1 - y0)
        y0 = e.sy
    if y1 > e.ey:
        x1 = x1 + (x1 - x0) * (e.ey - y1) / (y1 - y0)
        y1 = e.ey
    fx, fx1 = F32(x), F32(x + 1)
    if x0 <= fx and x1 <= fx:
        sc[x] += e.direction * (y1 - y0)
    elif not (x0 >= fx1 and x1 >= fx1):
        sc[x] += e.direction * (y1 - y0) * (F32(1) - ((x0 - fx) + (x1 - fx)) / F32(2))


def _fill(sc, sf, length: int, active: List[_Active], y_top) -> None:
    """stb_truetype's ``fill_active_edges_new``; ``sf`` is ``scanline2``
    (``scanline_fill - 1``), so index ``x + 1`` is the fill of ``x``."""
    y_bottom = y_top + F32(1)
    half = F32(2)
    for e in active:
        if e.fdx == 0:
            x0 = e.fx
            if x0 < length:
                if x0 >= 0:
                    _clipped(sc, int(x0), e, x0, y_top, x0, y_bottom)
                    _clipped(sf, int(x0) + 1, e, x0, y_top, x0, y_bottom)
                else:
                    _clipped(sf, 0, e, x0, y_top, x0, y_bottom)
            continue
        x0, dx, dy = e.fx, e.fdx, e.fdy
        xb = x0 + dx
        if e.sy > y_top:
            x_top, sy0 = x0 + dx * (e.sy - y_top), e.sy
        else:
            x_top, sy0 = x0, y_top
        if e.ey < y_bottom:
            x_bottom, sy1 = x0 + dx * (e.ey - y_top), e.ey
        else:
            x_bottom, sy1 = xb, y_bottom
        if 0 <= x_top < length and 0 <= x_bottom < length:
            if int(x_top) == int(x_bottom):
                x = int(x_top)
                height = (sy1 - sy0) * e.direction
                sc[x] += ((F32(x + 1) - x_top) + (F32(x + 1) - x_bottom)) / half * height
                sf[x + 1] += height
                continue
            if x_top > x_bottom:
                sy0, sy1 = y_bottom - (sy1 - y_top), y_bottom - (sy0 - y_top)
                x_top, x_bottom = x_bottom, x_top
                dx, dy = -dx, -dy
                x0, xb = xb, x0
            x1, x2 = int(x_top), int(x_bottom)
            y_crossing = y_top + dy * (F32(x1 + 1) - x0)
            y_final = y_top + dy * (F32(x2) - x0)
            if y_crossing > y_bottom:
                y_crossing = y_bottom
            sign = e.direction
            area = sign * (y_crossing - sy0)
            sc[x1] += area * (F32(x1 + 1) - x_top) / half
            if y_final > y_bottom:
                y_final = y_bottom
                if x2 > x1 + 1:  # else stb divides by zero and never reads dy
                    dy = (y_final - y_crossing) / F32(x2 - (x1 + 1))
            step = sign * dy
            for x in range(x1 + 1, x2):
                sc[x] += area + step / half
                area += step
            sc[x2] += area + sign * (((F32(x2 + 1) - F32(x2)) + (F32(x2 + 1) - x_bottom)) / half * (sy1 - y_final))
            sf[x2 + 1] += sign * (sy1 - sy0)
            continue
        for x in range(length):  # the edge leaves the bitmap: stb's brute-force clipping
            fx, fx1 = F32(x), F32(x + 1)
            y1 = (fx - x0) / dx + y_top
            y2 = (fx1 - x0) / dx + y_top
            if x0 < fx and xb > fx1:
                _clipped(sc, x, e, x0, y_top, fx, y1)
                _clipped(sc, x, e, fx, y1, fx1, y2)
                _clipped(sc, x, e, fx1, y2, xb, y_bottom)
            elif xb < fx and x0 > fx1:
                _clipped(sc, x, e, x0, y_top, fx1, y2)
                _clipped(sc, x, e, fx1, y2, fx, y1)
                _clipped(sc, x, e, fx, y1, xb, y_bottom)
            elif (x0 < fx < xb) or (xb < fx < x0):
                _clipped(sc, x, e, x0, y_top, fx, y1)
                _clipped(sc, x, e, fx, y1, xb, y_bottom)
            elif (x0 < fx1 < xb) or (xb < fx1 < x0):
                _clipped(sc, x, e, x0, y_top, fx1, y2)
                _clipped(sc, x, e, fx1, y2, xb, y_bottom)
            else:
                _clipped(sc, x, e, x0, y_top, xb, y_bottom)


def _rasterize(contours, w: int, h: int, scale, shift, off_x: int, off_y: int) -> np.ndarray:
    """stb_truetype's ``stbtt__rasterize`` (inverted y, no subsampling) and
    ``rasterize_sorted_edges``: an (h, w) uint8 coverage bitmap."""
    sx, sy, shift = scale, -scale, F32(shift)
    edges: List[_Edge] = []
    for p in contours:
        j = len(p) - 1
        for k in range(len(p)):
            if p[j][1] != p[k][1]:
                e = _Edge()
                a, b = (j, k) if p[j][1] > p[k][1] else (k, j)
                e.invert = p[j][1] > p[k][1]
                e.x0, e.y0 = p[a][0] * sx + shift, p[a][1] * sy + shift
                e.x1, e.y1 = p[b][0] * sx + shift, p[b][1] * sy + shift
                edges.append(e)
            j = k
    _sort_edges(edges)
    sentinel = _Edge()
    sentinel.y0 = F32(off_y + h) + F32(1)
    edges.append(sentinel)
    out = np.zeros((h, w), np.uint8)
    active: List[_Active] = []
    ei, off = 0, F32(off_x)
    for j in range(h):
        y_top, y_bottom = F32(off_y + j), F32(off_y + j + 1)
        active = [z for z in active if not z.ey <= y_top]
        new = []
        while edges[ei].y0 <= y_bottom:
            e = edges[ei]
            if e.y0 != e.y1:
                z = _Active()
                dxdy = (e.x1 - e.x0) / (e.y1 - e.y0)
                z.fdx, z.fdy = dxdy, (F32(1) / dxdy if dxdy != 0 else F32(0))
                z.fx = e.x0 + dxdy * (y_top - e.y0) - off
                z.direction = F32(1) if e.invert else F32(-1)
                z.sy, z.ey = e.y0, e.y1
                if j == 0 and off_y != 0 and z.ey < y_top:
                    z.ey = y_top
                new.append(z)
            ei += 1
        active = new[::-1] + active  # each new edge goes to the front
        if not active:
            continue
        sc = [F32(0)] * w
        sf = [F32(0)] * (w + 1)
        _fill(sc, sf, w, active, y_top)
        acc = F32(0)
        row = out[j]
        for i in range(w):
            acc = acc + sf[i]
            k = abs(sc[i] + acc) * F32(255) + F32(0.5)
            row[i] = min(int(k), 255)
        for z in active:
            z.fx = z.fx + z.fdx
    return out


@functools.lru_cache(maxsize=None)
def _glyph(gid: int, size: int, weight: int):
    """(coverage (h, w) uint8 cropped to its ink, x, y of its top left from
    the pen on the baseline, advance in pixels); the coverage is None for a
    glyph with no ink."""
    scale = F32(size) / F32(font().ascent)
    inst = _instance(gid, weight)
    if inst is None:
        advance = int(font().advances[gid])
        return None, 0, 0, int(np.rint(F32(advance) * scale * F32(64))) >> 6
    xs, ys, on, ends, (x0, y0, x1, y1), advance = inst
    ix0, iy0 = math.floor(F32(x0) * scale), math.floor(F32(-y1) * scale)
    ix1, iy1 = math.ceil(F32(x1) * scale), math.ceil(F32(-y0) * scale)
    w, h = ix1 - ix0, iy1 - iy0
    pad = max((h + 9) // 10, (w + 9) // 10) + 10
    contours = _flatten(_vertices(xs, ys, on, ends), F32(0.35) / scale)
    bitmap = _rasterize(contours, w + 2 * pad, h + 2 * pad, scale, pad, ix0, iy0)
    adv_px = int(np.rint(F32(advance) * scale * F32(64))) >> 6
    rows, cols = np.flatnonzero(bitmap.any(1)), np.flatnonzero(bitmap.any(0))
    if not len(rows):
        return None, 0, 0, adv_px
    r0, r1, c0, c1 = rows[0], rows[-1] + 1, cols[0], cols[-1] + 1
    return bitmap[r0:r1, c0:c1].copy(), ix0 - pad + int(c0), iy0 - pad + int(r0), adv_px


# -- layout ------------------------------------------------------------------
class _Layout(NamedTuple):
    """A string laid out at a size and weight: ``layers`` of (coverage,
    x, y) relative to the origin, drawn in order (a glyph whose ink meets
    an earlier glyph's goes to a later layer), ``width`` and ``baseline``
    as ``getTextSize`` returns them."""

    layers: List[Tuple[np.ndarray, int, int]]
    width: int
    baseline: int


def _glyph_ids(text: str) -> List[int]:
    f = font()
    out = []
    for ch in text:
        gid = f.glyph_id(ord(ch))
        if gid == 0:
            raise TextError(f"character {ch!r} (U+{ord(ch):04X}) is refused: Rubik has no glyph for it "
                            "(cv2 draws it with WenQuanYi Micro Hei, which the port does not carry)")
        if not " " <= ch <= "~" and f.uses_iup(gid):
            raise TextError(f"character {ch!r} (U+{ord(ch):04X}) is refused: its glyph's variation interpolates "
                            "untouched points, where cv2 5's rule is matched only on printable ASCII")
        out.append(gid)
    return out


_LAYOUTS: "OrderedDict[Tuple[str, int, int], _Layout]" = OrderedDict()


def _layout(text: str, size: int, weight: int) -> _Layout:
    key = (text, size, weight)
    hit = _LAYOUTS.get(key)
    if hit is not None:
        _LAYOUTS.move_to_end(key)
        STATS["hits"] += 1
        return hit
    STATS["misses"] += 1
    placed = []  # (coverage, x, y)
    pen, bottom = 0, 0
    for gid in _glyph_ids(text):
        cov, gx, gy, adv = _glyph(gid, size, weight)
        if cov is not None:
            placed.append((cov, pen + gx, gy))
            bottom = max(bottom, gy + cov.shape[0])
        pen += adv
    layers = _merge(placed)
    lay = _Layout(layers, pen + 1 if text else 0, bottom)
    _LAYOUTS[key] = lay
    if len(_LAYOUTS) > _LAYOUT_CACHE:
        _LAYOUTS.popitem(last=False)
    return lay


def _merge(placed) -> List[Tuple[np.ndarray, int, int]]:
    """Glyph bitmaps into as few layers as keep cv2's order: a glyph goes one
    layer above the highest earlier glyph whose ink it meets."""
    level, groups = [], []
    for i, (cov, x, y) in enumerate(placed):
        lv = 0
        for k in range(i):
            c2, x2, y2 = placed[k]
            ya, yb = max(y, y2), min(y + cov.shape[0], y2 + c2.shape[0])
            xa, xb = max(x, x2), min(x + cov.shape[1], x2 + c2.shape[1])
            if ya < yb and xa < xb and ((cov[ya - y:yb - y, xa - x:xb - x] > 0)
                                        & (c2[ya - y2:yb - y2, xa - x2:xb - x2] > 0)).any():
                lv = max(lv, level[k] + 1)
        level.append(lv)
        while len(groups) <= lv:
            groups.append([])
        groups[lv].append((cov, x, y))
    layers = []
    for group in groups:
        x0 = min(x for _, x, _ in group)
        y0 = min(y for _, _, y in group)
        x1 = max(x + c.shape[1] for c, x, _ in group)
        y1 = max(y + c.shape[0] for c, _, y in group)
        canvas = np.zeros((y1 - y0, x1 - x0), np.uint8)
        for c, x, y in group:
            view = canvas[y - y0:y - y0 + c.shape[0], x - x0:x - x0 + c.shape[1]]
            np.maximum(view, c, out=view)  # no ink meets within a layer
        layers.append((canvas, x0, y0))
    return layers


# -- the two calls -----------------------------------------------------------
def get_text_size(text: str, face: int, scale: float, thickness: int) -> Tuple[Tuple[int, int], int]:
    """``cv2.getTextSize``: ((width, height), baseline)."""
    size, weight = hershey_to_truetype(face, scale, thickness)
    if not text:
        return (0, 0), 0
    lay = _layout(text, size, weight)
    return (lay.width, size), lay.baseline


def _colour(color, channels: int) -> np.ndarray:
    vals = [color] if np.isscalar(color) else list(color)
    vals = (vals + [0.0] * 4)[:4]
    return np.clip(np.rint(np.asarray(vals[:channels], np.float64)), 0, 255).astype(np.int32)


def put_text(img: np.ndarray, text: str, org: Sequence[int], face: int, scale: float, color,
             thickness: int = 1, bottom_left_origin: bool = False) -> np.ndarray:
    """``cv2.putText`` on a uint8 (H, W) or (H, W, 1 or 3) image, in place:
    ``org`` is the left end of the text's baseline."""
    if bottom_left_origin:
        raise TextError("bottomLeftOrigin is refused: cv2 5 flips the text, which the port does not draw")
    size, weight = hershey_to_truetype(face, scale, thickness)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise TextError(f"image of {img.dtype} {img.shape} is refused: only uint8 with 1 or 3 channels is drawn "
                        "as cv2 draws it")
    if not text:
        return img
    lay = _layout(text, size, weight)
    view = img if img.ndim == 3 else img[:, :, None]
    colour = _colour(color, view.shape[2])
    H, W = view.shape[:2]
    ox, oy = int(org[0]), int(org[1])
    for cov, x, y in lay.layers:
        x0, y0 = ox + x, oy + y
        xa, ya = max(x0, 0), max(y0, 0)
        xb, yb = min(x0 + cov.shape[1], W), min(y0 + cov.shape[0], H)
        if xa >= xb or ya >= yb:
            continue
        a = cov[ya - y0:yb - y0, xa - x0:xb - x0].astype(np.int32)[:, :, None]
        region = view[ya:yb, xa:xb]
        region[...] = ((region.astype(np.int32) * (255 - a) + colour * a + 127) // 255).astype(np.uint8)
    return img


def clear_caches() -> None:
    """Drop the cached glyph bitmaps and layouts (and zero :data:`STATS`)."""
    _glyph.cache_clear()
    _LAYOUTS.clear()
    STATS.update(hits=0, misses=0)
