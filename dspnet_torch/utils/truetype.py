"""A TrueType reader on numpy and ``struct``: the outlines and advances of a
variable font at an instance, for :mod:`dspnet_torch.utils.text`.

It reads what a glyph's shape and advance need: ``cmap`` (formats 4 and
12), ``head``, ``hhea``, ``maxp``, ``hmtx``, ``loca``, ``glyf`` (simple and
composite glyphs), and the variation tables ``fvar``, ``avar`` (user to
normalised coordinates, rounded to F2Dot14), ``gvar`` (shared and embedded peak tuples, intermediate
regions, shared and private packed point numbers, packed deltas, IUP of the
points a tuple leaves untouched), ``HVAR`` (advances under the instance)
and ``MVAR`` (font-wide metrics under the instance). It holds no hinting
and no ``GPOS``: cv2 5.0.0 lays text out without kerning
(``tests/test_torch_text.py`` pins "AV", "To" and every other ASCII pair).

:meth:`Font.glyph` is the spec's instance in float, as fontTools computes
it. :meth:`Font.variation_tuples` hands the raw tuples to a caller that
applies them by another rule: cv2 5.0.0's font engine interpolates an
untouched point's delta in integers (``integer_iup=True``, see
:func:`_iup`) and sums the tuples in fixed point
(:mod:`dspnet_torch.utils.text`).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# simple-glyph flags
_ON_CURVE, _X_SHORT, _Y_SHORT, _REPEAT, _X_SAME, _Y_SAME = 0x01, 0x02, 0x04, 0x08, 0x10, 0x20
# composite-glyph flags
_ARGS_WORDS, _ARGS_XY, _SCALE, _MORE, _XY_SCALE, _TWO_BY_TWO = 0x01, 0x02, 0x08, 0x20, 0x40, 0x80
# gvar tuple flags
_EMBEDDED_PEAK, _INTERMEDIATE, _PRIVATE_POINTS, _SHARED_POINTS = 0x8000, 0x4000, 0x2000, 0x8000


class FontError(ValueError):
    """The font lacks a table this reader needs, or holds a form it refuses."""


@dataclass(frozen=True)
class Axis:
    tag: str
    minimum: float
    default: float
    maximum: float


@dataclass
class RawGlyph:
    """A ``glyf`` record: the header's ``bbox`` (xMin, yMin, xMax, yMax),
    and either a simple glyph's points (``xs``, ``ys`` float64,
    ``on_curve``, ``end_points``) or a composite's ``components``, each
    (glyph id, dx, dy, (a, b, c, d), offsets are xy). An empty glyph has
    neither."""

    bbox: Tuple[int, int, int, int]
    xs: np.ndarray
    ys: np.ndarray
    on_curve: np.ndarray
    end_points: List[int]
    components: List[Tuple]


@dataclass
class Outline:
    """A glyph's points in font units at an instance: ``xs``, ``ys`` (float64),
    ``on_curve`` (bool) and ``end_points`` (the last point of each contour),
    in contour order; ``bbox`` is the ``glyf`` header's (xMin, yMin, xMax,
    yMax) of the default instance. A glyph with no contours has no points."""

    xs: np.ndarray
    ys: np.ndarray
    on_curve: np.ndarray
    end_points: List[int]
    bbox: Tuple[int, int, int, int]


def _f2dot14(v: int) -> float:
    return v / 16384.0


def _round_f2dot14(v: float) -> float:
    return float(np.floor(v * 16384.0 + 0.5)) / 16384.0


def _region_scalar(coord: float, start: float, peak: float, end: float) -> float:
    """One axis's factor of a tuple's scalar (OpenType's algorithm; an
    invalid region leaves the scalar as it is)."""
    if peak == 0.0 or coord == peak or start > peak or peak > end or start < 0.0 < end:
        return 1.0
    if coord <= start or coord >= end:
        return 0.0
    return (coord - start) / (peak - start) if coord < peak else (end - coord) / (end - peak)


class Font:
    """A parsed TrueType font (``data``: the file's bytes)."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        if self.data[:4] not in (b"\x00\x01\x00\x00", b"true"):
            raise FontError("not a TrueType font (no 0x00010000 / 'true' sfnt version)")
        n = struct.unpack_from(">H", self.data, 4)[0]
        self.tables: Dict[str, Tuple[int, int]] = {}
        for i in range(n):
            tag, _, off, length = struct.unpack_from(">4sIII", self.data, 12 + 16 * i)
            self.tables[tag.decode("latin-1")] = (off, length)
        for tag in ("cmap", "head", "hhea", "maxp", "hmtx", "loca", "glyf"):
            if tag not in self.tables:
                raise FontError(f"the font has no '{tag}' table")
        head = self.tables["head"][0]
        self.units_per_em = struct.unpack_from(">H", self.data, head + 18)[0]
        self.index_to_loc = struct.unpack_from(">h", self.data, head + 50)[0]
        hhea = self.tables["hhea"][0]
        self.ascent, self.descent = struct.unpack_from(">hh", self.data, hhea + 4)
        num_hmetrics = struct.unpack_from(">H", self.data, hhea + 34)[0]
        self.num_glyphs = struct.unpack_from(">H", self.data, self.tables["maxp"][0] + 4)[0]
        self._read_hmtx(num_hmetrics)
        self._read_loca()
        self.cmap = self._read_cmap()
        self.axes = self._read_fvar()
        self._avar = self._read_avar()
        self._gvar = self._read_gvar()
        self._hvar = self._read_hvar()
        self._mvar = self._read_mvar()

    @classmethod
    def from_file(cls, path) -> "Font":
        with open(path, "rb") as f:
            return cls(f.read())

    # -- tables ------------------------------------------------------------
    def _u16(self, off: int) -> int:
        return struct.unpack_from(">H", self.data, off)[0]

    def _read_hmtx(self, num_hmetrics: int) -> None:
        pairs = np.frombuffer(self.data, ">u2", 2 * num_hmetrics, self.tables["hmtx"][0]).reshape(-1, 2)
        self.advances = np.full(self.num_glyphs, int(pairs[-1, 0]), np.int64)
        self.advances[:num_hmetrics] = pairs[:, 0]

    def _read_loca(self) -> None:
        off = self.tables["loca"][0]
        if self.index_to_loc == 0:
            self._loca = np.frombuffer(self.data, ">u2", self.num_glyphs + 1, off).astype(np.int64) * 2
        else:
            self._loca = np.frombuffer(self.data, ">u4", self.num_glyphs + 1, off).astype(np.int64)

    def _read_cmap(self) -> Dict[int, int]:
        base = self.tables["cmap"][0]
        n = self._u16(base + 2)
        subtables = {}
        for i in range(n):
            pid, eid, off = struct.unpack_from(">HHI", self.data, base + 4 + 8 * i)
            fmt = self._u16(base + off)
            subtables[(pid, eid, fmt)] = base + off
        for key in ((3, 10, 12), (0, 4, 12), (0, 6, 12), (3, 1, 4), (0, 3, 4), (0, 4, 4)):
            if key in subtables:
                return (self._cmap12 if key[2] == 12 else self._cmap4)(subtables[key])
        raise FontError(f"no Unicode cmap subtable of format 4 or 12 (has {sorted(subtables)})")

    def _cmap4(self, off: int) -> Dict[int, int]:
        seg2 = self._u16(off + 6)
        ends = np.frombuffer(self.data, ">u2", seg2 // 2, off + 14)
        starts = np.frombuffer(self.data, ">u2", seg2 // 2, off + 16 + seg2)
        deltas = np.frombuffer(self.data, ">i2", seg2 // 2, off + 16 + 2 * seg2)
        ro_off = off + 16 + 3 * seg2
        ranges = np.frombuffer(self.data, ">u2", seg2 // 2, ro_off)
        out = {}
        for i, (s, e, d, r) in enumerate(zip(starts, ends, deltas, ranges)):
            for c in range(int(s), int(e) + 1):
                if c == 0xFFFF:
                    continue
                if r == 0:
                    g = (c + int(d)) & 0xFFFF
                else:
                    g = self._u16(ro_off + 2 * i + int(r) + 2 * (c - int(s)))
                    g = (g + int(d)) & 0xFFFF if g else 0
                if g:
                    out[c] = g
        return out

    def _cmap12(self, off: int) -> Dict[int, int]:
        n = struct.unpack_from(">I", self.data, off + 12)[0]
        groups = np.frombuffer(self.data, ">u4", 3 * n, off + 16).reshape(-1, 3)
        out = {}
        for s, e, g in groups.tolist():
            for c in range(s, e + 1):
                out[c] = g + c - s
        return out

    def _read_fvar(self) -> List[Axis]:
        if "fvar" not in self.tables:
            return []
        off = self.tables["fvar"][0]
        axes_off, _, count, size = struct.unpack_from(">HHHH", self.data, off + 4)
        axes = []
        for i in range(count):
            tag, lo, df, hi = struct.unpack_from(">4siii", self.data, off + axes_off + i * size)
            axes.append(Axis(tag.decode("latin-1"), lo / 65536.0, df / 65536.0, hi / 65536.0))
        return axes

    def _read_avar(self) -> List[np.ndarray]:
        if "avar" not in self.tables:
            return []
        off = self.tables["avar"][0] + 8
        maps = []
        for _ in self.axes:
            n = self._u16(off)
            pairs = np.frombuffer(self.data, ">i2", 2 * n, off + 2).reshape(-1, 2) / 16384.0
            maps.append(pairs)
            off += 2 + 4 * n
        return maps

    def _read_gvar(self):
        if "gvar" not in self.tables:
            return None
        off = self.tables["gvar"][0]
        _, _, axis_count, shared_count, shared_off, glyph_count, flags, data_off = struct.unpack_from(
            ">HHHHIHHI", self.data, off)
        shared = np.frombuffer(self.data, ">i2", axis_count * shared_count, off + shared_off)
        shared = shared.reshape(shared_count, axis_count) / 16384.0
        if flags & 1:
            offsets = np.frombuffer(self.data, ">u4", glyph_count + 1, off + 20).astype(np.int64)
        else:
            offsets = np.frombuffer(self.data, ">u2", glyph_count + 1, off + 20).astype(np.int64) * 2
        return axis_count, shared, offsets + off + data_off

    def _read_store(self, off: int):
        """An ItemVariationStore: (regions (R, axes, 3), [(region indexes, rows)])."""
        _, regions_off, n_data = struct.unpack_from(">HIH", self.data, off)
        axis_count, region_count = struct.unpack_from(">HH", self.data, off + regions_off)
        regions = np.frombuffer(self.data, ">i2", region_count * axis_count * 3, off + regions_off + 4)
        regions = regions.reshape(region_count, axis_count, 3) / 16384.0
        data = []
        for i in range(n_data):
            d = off + struct.unpack_from(">I", self.data, off + 8 + 4 * i)[0]
            items, word_count, n_regions = struct.unpack_from(">HHH", self.data, d)
            idx = np.frombuffer(self.data, ">u2", n_regions, d + 6).astype(np.int64)
            long_words, words = bool(word_count & 0x8000), word_count & 0x7FFF
            wide, narrow = (">i4", ">i2") if long_words else (">i2", ">i1")
            wsize, nsize = (4, 2) if long_words else (2, 1)
            row = words * wsize + (n_regions - words) * nsize
            rows = np.zeros((items, n_regions), np.int64)
            base = d + 6 + 2 * n_regions
            for r in range(items):
                p = base + r * row
                rows[r, :words] = np.frombuffer(self.data, wide, words, p)
                rows[r, words:] = np.frombuffer(self.data, narrow, n_regions - words, p + words * wsize)
            data.append((idx, rows))
        return regions, data

    def _read_index_map(self, off: int) -> List[Tuple[int, int]]:
        fmt, entry = self.data[off], self.data[off + 1]
        count = self._u16(off + 2) if fmt == 0 else struct.unpack_from(">I", self.data, off + 2)[0]
        p = off + (4 if fmt == 0 else 6)
        size, inner_bits = ((entry >> 4) & 3) + 1, (entry & 0xF) + 1
        out = []
        for i in range(count):
            v = int.from_bytes(self.data[p + i * size:p + (i + 1) * size], "big")
            out.append((v >> inner_bits, v & ((1 << inner_bits) - 1)))
        return out

    def _read_hvar(self):
        if "HVAR" not in self.tables:
            return None
        off = self.tables["HVAR"][0]
        store_off, adv_map_off = struct.unpack_from(">II", self.data, off + 4)
        store = self._read_store(off + store_off)
        adv_map = self._read_index_map(off + adv_map_off) if adv_map_off else None
        return store, adv_map

    def _read_mvar(self):
        if "MVAR" not in self.tables:
            return None
        off = self.tables["MVAR"][0]
        rec_size, rec_count, store_off = struct.unpack_from(">HHH", self.data, off + 6)
        records = {}
        for i in range(rec_count):
            tag, outer, inner = struct.unpack_from(">4sHH", self.data, off + 12 + i * rec_size)
            records[tag.decode("latin-1")] = (outer, inner)
        return self._read_store(off + store_off), records

    # -- variation ---------------------------------------------------------
    def normalize(self, user: Optional[Dict[str, float]] = None) -> Tuple[float, ...]:
        """User coordinates (``{"wght": 400}``; missing axes at their
        default) -> normalised ones: default-relative, clamped to [-1, 1],
        mapped by ``avar``, then rounded to F2Dot14 (the rounding cv2 5.0.0
        applies: 400, 600 and 800 give 0.1875, 0.5125122 and 0.8125)."""
        user = dict(user or {})
        unknown = set(user) - {a.tag for a in self.axes}
        if unknown:
            raise FontError(f"the font has no axis {sorted(unknown)} (has {[a.tag for a in self.axes]})")
        out = []
        for i, a in enumerate(self.axes):
            v = min(max(float(user.get(a.tag, a.default)), a.minimum), a.maximum)
            if v < a.default:
                t = (v - a.default) / (a.default - a.minimum)
            elif v > a.default:
                t = (v - a.default) / (a.maximum - a.default)
            else:
                t = 0.0
            if self._avar:
                seg = self._avar[i]
                k = int(np.searchsorted(seg[:, 0], t, side="right")) - 1
                if 0 <= k < len(seg) - 1 and seg[k, 0] != t:
                    (a0, b0), (a1, b1) = seg[k], seg[k + 1]
                    t = b0 + (t - a0) * (b1 - b0) / (a1 - a0)
                elif 0 <= k < len(seg):
                    t = float(seg[k, 1])
            out.append(_round_f2dot14(t))
        return tuple(out)

    def _store_delta(self, store, outer: int, inner: int, coords: Sequence[float]) -> float:
        regions, data = store
        idx, rows = data[outer]
        total = 0.0
        for k, r in enumerate(idx):
            scalar = 1.0
            for c, (s, p, e) in zip(coords, regions[r]):
                scalar *= _region_scalar(c, s, p, e)
                if scalar == 0.0:
                    break
            total += scalar * float(rows[inner, k])
        return total

    def advance(self, gid: int, coords: Sequence[float] = ()) -> float:
        """The advance width in font units at ``coords`` (``hmtx`` + ``HVAR``)."""
        adv = float(self.advances[gid])
        if self._hvar is None or not any(coords):
            return adv
        store, adv_map = self._hvar
        if adv_map is None:
            outer, inner = 0, gid
        else:
            outer, inner = adv_map[min(gid, len(adv_map) - 1)]
        return adv + self._store_delta(store, outer, inner, coords)

    def metric_delta(self, tag: str, coords: Sequence[float] = ()) -> float:
        """``MVAR``'s delta for the metric ``tag`` ('hasc', 'undo', ...), 0
        where the font does not vary it."""
        if self._mvar is None or tag not in self._mvar[1] or not any(coords):
            return 0.0
        store, records = self._mvar
        return self._store_delta(store, *records[tag], coords)

    def _glyph_bytes(self, gid: int) -> bytes:
        if not 0 <= gid < self.num_glyphs:
            raise FontError(f"glyph id {gid} outside 0..{self.num_glyphs - 1}")
        g = self.tables["glyf"][0]
        return self.data[g + self._loca[gid]:g + self._loca[gid + 1]]

    def _tuples(self, gid: int, n_points: int):
        """The gvar tuples of a glyph: [(peak, start, end, point indexes or
        None for all, dx, dy)] over ``n_points`` points (phantoms included)."""
        if self._gvar is None:
            return []
        axis_count, shared, offsets = self._gvar
        lo, hi = int(offsets[gid]), int(offsets[gid + 1])
        if hi <= lo:
            return []
        d = self.data
        count, data_off = struct.unpack_from(">HH", d, lo)
        p, serial = lo + 4, lo + data_off
        shared_points = None
        if count & _SHARED_POINTS:
            shared_points, serial = self._points(serial, n_points)
        headers = []
        for _ in range(count & 0x0FFF):
            size, index = struct.unpack_from(">HH", d, p)
            p += 4
            if index & _EMBEDDED_PEAK:
                peak = np.frombuffer(d, ">i2", axis_count, p) / 16384.0
                p += 2 * axis_count
            else:
                peak = shared[index & 0x0FFF]
            if index & _INTERMEDIATE:
                start = np.frombuffer(d, ">i2", axis_count, p) / 16384.0
                end = np.frombuffer(d, ">i2", axis_count, p + 2 * axis_count) / 16384.0
                p += 4 * axis_count
            else:
                start, end = np.minimum(peak, 0.0), np.maximum(peak, 0.0)
            headers.append((size, index, peak, start, end))
        out = []
        for size, index, peak, start, end in headers:
            q = serial
            points = shared_points
            if index & _PRIVATE_POINTS:
                points, q = self._points(q, n_points)
            k = n_points if points is None else len(points)
            dx, q = self._deltas(q, k)
            dy, q = self._deltas(q, k)
            out.append((peak, start, end, points, dx, dy))
            serial += size
        return out

    def _points(self, p: int, n_points: int):
        d = self.data
        count = d[p]
        p += 1
        if count & 0x80:
            count = ((count & 0x7F) << 8) | d[p]
            p += 1
        if count == 0:
            return None, p
        pts, last = [], 0
        while len(pts) < count:
            ctrl = d[p]
            p += 1
            run = (ctrl & 0x7F) + 1
            words = ctrl & 0x80
            for _ in range(run):
                if words:
                    last += struct.unpack_from(">H", d, p)[0]
                    p += 2
                else:
                    last += d[p]
                    p += 1
                pts.append(last)
        return np.array(pts, np.int64), p

    def _deltas(self, p: int, count: int):
        d = self.data
        out = []
        while len(out) < count:
            ctrl = d[p]
            p += 1
            run = (ctrl & 0x3F) + 1
            if ctrl & 0x80:
                out.extend([0] * run)
            elif ctrl & 0x40:
                out.extend(np.frombuffer(d, ">i2", run, p).tolist())
                p += 2 * run
            else:
                out.extend(np.frombuffer(d, ">i1", run, p).tolist())
                p += run
        return np.array(out[:count], np.int64), p

    def variation_tuples(self, gid: int, integer_iup: bool = False) -> List[Tuple]:
        """The glyph's ``gvar`` tuples as (peak, start, end, dx, dy), each
        region per axis and the deltas of every point and of the four
        phantoms (float64; a point a tuple leaves out of a simple glyph gets
        its delta by IUP, one of a composite, one point per component, 0)."""
        raw = self.raw_glyph(gid)
        n = (len(raw.components) if raw.components else len(raw.xs)) + 4
        bx = np.concatenate([raw.xs, np.zeros(n - len(raw.xs))])
        by = np.concatenate([raw.ys, np.zeros(n - len(raw.ys))])
        out = []
        for peak, start, end, points, dx, dy in self._tuples(gid, n):
            if points is None:
                fx, fy = dx.astype(np.float64), dy.astype(np.float64)
            else:
                touched = np.zeros(n, bool)
                fx, fy = np.zeros(n), np.zeros(n)
                keep = points < n
                touched[points[keep]] = True
                fx[points[keep]] = dx[keep]
                fy[points[keep]] = dy[keep]
                start_pt = 0
                for ep in () if raw.components else raw.end_points:
                    sl = slice(start_pt, ep + 1)
                    fx[sl] = _iup(fx[sl], bx[sl], touched[sl], integer_iup)
                    fy[sl] = _iup(fy[sl], by[sl], touched[sl], integer_iup)
                    start_pt = ep + 1
            out.append((peak, start, end, fx, fy))
        return out

    def uses_iup(self, gid: int) -> bool:
        """Whether a tuple of the glyph or of one of its components leaves a
        point to IUP."""
        raw = self.raw_glyph(gid)
        n = (len(raw.components) if raw.components else len(raw.xs)) + 4
        if any(t[3] is not None for t in self._tuples(gid, n)) and not raw.components:
            return True
        return any(self.uses_iup(c[0]) for c in raw.components)

    def _point_deltas(self, gid: int, coords: Sequence[float]):
        """Summed (dx, dy) over the glyph's points and phantoms at ``coords``."""
        totals = None
        for peak, start, end, fx, fy in self.variation_tuples(gid) if any(coords) else ():
            scalar = 1.0
            for c, s, pk, e in zip(coords, start, peak, end):
                scalar *= _region_scalar(c, float(s), float(pk), float(e))
            totals = (0.0, 0.0) if totals is None else totals
            totals = (totals[0] + scalar * fx, totals[1] + scalar * fy)
        return totals

    # -- glyphs ------------------------------------------------------------
    def glyph_id(self, codepoint: int) -> int:
        """The glyph of a Unicode code point, 0 (.notdef) where there is none."""
        return self.cmap.get(int(codepoint), 0)

    def raw_glyph(self, gid: int) -> RawGlyph:
        """The ``glyf`` record of ``gid`` as stored (the default instance)."""
        b = self._glyph_bytes(gid)
        if len(b) < 10:
            return RawGlyph((0, 0, 0, 0), np.zeros(0), np.zeros(0), np.zeros(0, bool), [], [])
        n_contours = struct.unpack_from(">h", b, 0)[0]
        bbox = struct.unpack_from(">hhhh", b, 2)
        if n_contours >= 0:
            return RawGlyph(bbox, *_simple(b, n_contours), [])
        return RawGlyph(bbox, np.zeros(0), np.zeros(0), np.zeros(0, bool), [], _components(b))

    def glyph(self, gid: int, coords: Sequence[float] = (), _depth: int = 0) -> Outline:
        """The outline of glyph ``gid`` at normalised ``coords``, composites
        resolved into their components' points (the spec's instance, in
        float)."""
        raw = self.raw_glyph(gid)
        deltas = self._point_deltas(gid, coords)
        dx, dy = deltas if deltas is not None else (0.0, 0.0)
        if not raw.components:
            n = len(raw.xs)
            return Outline(raw.xs + (dx[:n] if n and deltas is not None else 0.0),
                           raw.ys + (dy[:n] if n and deltas is not None else 0.0),
                           raw.on_curve, list(raw.end_points), raw.bbox)
        if _depth > 8:
            raise FontError(f"glyph {gid}: composite nesting deeper than 8")
        parts_x, parts_y, parts_on, ends = [], [], [], []
        total = 0
        for k, (cid, ox, oy, m, xy) in enumerate(raw.components):
            if not xy:
                raise FontError(f"glyph {gid}: composite placed by point matching")
            sub = self.glyph(cid, coords, _depth + 1)
            ox = ox + (dx[k] if deltas is not None else 0.0)
            oy = oy + (dy[k] if deltas is not None else 0.0)
            parts_x.append(m[0] * sub.xs + m[2] * sub.ys + ox)
            parts_y.append(m[1] * sub.xs + m[3] * sub.ys + oy)
            parts_on.append(sub.on_curve)
            ends.extend(e + total for e in sub.end_points)
            total += len(sub.xs)
        return Outline(np.concatenate(parts_x), np.concatenate(parts_y), np.concatenate(parts_on), ends,
                       raw.bbox)


def _iup(delta: np.ndarray, coord: np.ndarray, touched: np.ndarray, integer: bool) -> np.ndarray:
    """Interpolate the deltas of a contour's untouched points from the touched
    neighbours on either side (OpenType's IUP, on the default coordinates).
    ``integer`` is cv2 5.0.0's rule: a point before the contour's first
    touched point or after its last one takes that point's delta (no wrap
    around), and an interpolated delta is ``(d1 * (c2 - c1) + (c - c1) *
    (d2 - d1)) / (c2 - c1)`` with C's truncating division."""
    n = len(delta)
    idx = np.flatnonzero(touched)
    if len(idx) == 0:
        return np.zeros(n)
    if len(idx) == 1:
        return np.full(n, delta[idx[0]])
    out = delta.astype(np.float64).copy()
    for k in range(len(idx)):
        i1, i2 = int(idx[k]), int(idx[(k + 1) % len(idx)])
        wrap = k == len(idx) - 1
        j = (i1 + 1) % n
        while j != i2:
            if integer and wrap:
                out[j] = delta[i1] if j > i1 else delta[i2]
            else:
                out[j] = _interpolate(coord[j], coord[i1], delta[i1], coord[i2], delta[i2], integer)
            j = (j + 1) % n
    return out


def _interpolate(c, c1, d1, c2, d2, integer: bool) -> float:
    if c1 > c2:
        c1, c2, d1, d2 = c2, c1, d2, d1
    if c1 == c2:
        return d1 if d1 == d2 else 0.0
    if c <= c1:
        return d1
    if c >= c2:
        return d2
    if not integer:
        return d1 + (c - c1) * (d2 - d1) / (c2 - c1)
    num, den = int(d1 * (c2 - c1) + (c - c1) * (d2 - d1)), int(c2 - c1)
    return (abs(num) // den) * (1 if num >= 0 else -1)


def _simple(b: bytes, n_contours: int):
    ends = list(struct.unpack_from(f">{n_contours}H", b, 10))
    n = ends[-1] + 1 if ends else 0
    p = 10 + 2 * n_contours
    p += 2 + struct.unpack_from(">H", b, p)[0]
    flags = []
    while len(flags) < n:
        f = b[p]
        p += 1
        flags.append(f)
        if f & _REPEAT:
            flags.extend([f] * b[p])
            p += 1
    flags = flags[:n]
    coords = []
    for short, same in ((_X_SHORT, _X_SAME), (_Y_SHORT, _Y_SAME)):
        v, vals = 0, []
        for f in flags:
            if f & short:
                d = b[p]
                p += 1
                v += d if f & same else -d
            elif not f & same:
                v += struct.unpack_from(">h", b, p)[0]
                p += 2
            vals.append(v)
        coords.append(np.array(vals, np.float64))
    return coords[0], coords[1], np.array([bool(f & _ON_CURVE) for f in flags]), ends


def _components(b: bytes):
    """[(glyph id, dx, dy, (a, b, c, d), offsets are xy)] of a composite glyph."""
    out, p = [], 10
    while True:
        flags, gid = struct.unpack_from(">HH", b, p)
        p += 4
        if flags & _ARGS_WORDS:
            a1, a2 = struct.unpack_from(">hh" if flags & _ARGS_XY else ">HH", b, p)
            p += 4
        else:
            a1, a2 = struct.unpack_from(">bb" if flags & _ARGS_XY else ">BB", b, p)
            p += 2
        m = (1.0, 0.0, 0.0, 1.0)
        if flags & _SCALE:
            s = _f2dot14(struct.unpack_from(">h", b, p)[0])
            m, p = (s, 0.0, 0.0, s), p + 2
        elif flags & _XY_SCALE:
            sx, sy = struct.unpack_from(">hh", b, p)
            m, p = (_f2dot14(sx), 0.0, 0.0, _f2dot14(sy)), p + 4
        elif flags & _TWO_BY_TWO:
            m, p = tuple(_f2dot14(v) for v in struct.unpack_from(">hhhh", b, p)), p + 8
        out.append((gid, a1, a2, m, bool(flags & _ARGS_XY)))
        if not flags & _MORE:
            return out
