"""The ISOBMFF items of an AVIF file (HEIF, ISO/IEC 23008-12), read as
libavif 1.4.2 reads them for cv2 5.0.0's ``imdecode``.

:func:`parse` walks ``ftyp`` (brands ``avif`` / ``avis`` / ``mif1`` /
``miaf``), ``meta`` with ``hdlr`` (``pict``), ``pitm``, ``iinf`` / ``infe``
(versions 2 and 3), ``iloc`` (versions 0-2, construction methods 0 and 1
with ``idat``, any number of extents), ``iprp`` / ``ipco`` / ``ipma`` and
``iref`` (``auxl``, ``dimg``, ``prem``), and gives each item its type, its
payload and its properties: ``av1C``, ``ispe``, ``pixi``, ``colr`` (``nclx``
and ICC), ``irot``, ``imir``, ``clap``, ``auxC`` (and the names of the rest).
An ``avis`` file without a primary item, or one whose major brand is
``avis`` (libavif's automatic source), yields its first track sample as the
colour item, with the sample entry's ``av1C`` and ``colr``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dspnet_torch.data.mp4 import boxes

ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")


class HeifError(ValueError):
    """An AVIF container the port does not read, or a broken one."""


@dataclass
class Item:
    id: int
    type: str
    data: bytes = b""
    props: Dict[str, object] = field(default_factory=dict)
    essential: List[str] = field(default_factory=list)
    refs: Dict[str, List[int]] = field(default_factory=dict)  # this item -> others, by reference type


@dataclass
class Heif:
    major: bytes
    brands: List[bytes]
    primary: int
    items: Dict[int, Item]

    def alpha_of(self, of: int) -> Optional[Item]:
        """The alpha auxiliary image of item ``of`` (``auxl`` with an alpha
        ``auxC``), if any."""
        for it in self.items.values():
            if of in it.refs.get("auxl", []) and it.props.get("auxC", b"") in ALPHA_URNS:
                return it
        return None


def _full(data: bytes, pos: int) -> Tuple[int, int, int]:
    v = data[pos]
    return v, int.from_bytes(data[pos + 1:pos + 4], "big"), pos + 4


def _uint(data: bytes, pos: int, n: int) -> Tuple[int, int]:
    return (int.from_bytes(data[pos:pos + n], "big") if n else 0), pos + n


def _cstr(data: bytes, pos: int, end: int) -> Tuple[bytes, int]:
    z = data.find(b"\0", pos, end)
    if z < 0:
        return data[pos:end], end
    return data[pos:z], z + 1


def _property(kind: bytes, data: bytes, pos: int, end: int):
    body = data[pos:end]
    if kind == b"av1C":
        return body
    if kind == b"ispe":
        _, _, p = _full(data, pos)
        return struct.unpack(">II", data[p:p + 8])
    if kind == b"pixi":
        _, _, p = _full(data, pos)
        n = data[p]
        return tuple(data[p + 1:p + 1 + n])
    if kind == b"colr":
        ctype = body[:4]
        if ctype == b"nclx":
            cp, tc, mc = struct.unpack(">HHH", body[4:10])
            return ("nclx", cp, tc, mc, body[10] >> 7)
        return ("icc", ctype, body[4:])
    if kind == b"irot":
        return body[0] & 3
    if kind == b"imir":
        return body[0] & 1
    if kind == b"clap":
        return struct.unpack(">iIiIiIiI", body[:32])
    if kind == b"auxC":
        _, _, p = _full(data, pos)
        return _cstr(data, p, end)[0]
    return body


def _iloc(data: bytes, pos: int, end: int):
    version, _, p = _full(data, pos)
    a, b = data[p], data[p + 1]
    off_size, len_size, base_size = a >> 4, a & 15, b >> 4
    idx_size = b & 15 if version in (1, 2) else 0
    p += 2
    count, p = _uint(data, p, 2 if version < 2 else 4)
    out = {}
    for _ in range(count):
        iid, p = _uint(data, p, 2 if version < 2 else 4)
        method = 0
        if version in (1, 2):
            method = int.from_bytes(data[p:p + 2], "big") & 15
            p += 2
        ref, p = _uint(data, p, 2)
        base, p = _uint(data, p, base_size)
        n, p = _uint(data, p, 2)
        extents = []
        for _ in range(n):
            _, p = _uint(data, p, idx_size)
            off, p = _uint(data, p, off_size)
            ln, p = _uint(data, p, len_size)
            extents.append((base + off, ln))
        if ref:
            raise HeifError("AVIF item stored in another file (iloc data_reference_index)")
        out[iid] = (method, extents)
    return out


def _meta(data: bytes, pos: int, end: int):
    _, _, p = _full(data, pos)
    kids = {k: (a, b) for k, a, b in boxes(data, p, end)}
    if b"hdlr" not in kids or data[kids[b"hdlr"][0] + 8:kids[b"hdlr"][0] + 12] != b"pict":
        raise HeifError("AVIF meta box without a 'pict' handler")
    if b"pitm" not in kids:
        raise HeifError("AVIF without a primary item (pitm)")
    v, _, q = _full(data, kids[b"pitm"][0])
    primary, _ = _uint(data, q, 2 if v == 0 else 4)
    items: Dict[int, Item] = {}
    if b"iinf" in kids:
        a, b = kids[b"iinf"]
        v, _, q = _full(data, a)
        _, q = _uint(data, q, 2 if v == 0 else 4)
        for k, s, e in boxes(data, q, b):
            if k != b"infe":
                continue
            v, _, r = _full(data, s)
            if v < 2:
                raise HeifError(f"AVIF infe version {v}")
            iid, r = _uint(data, r, 2 if v == 2 else 4)
            r += 2  # protection index
            items[iid] = Item(iid, data[r:r + 4].decode("latin-1"))
    locs = _iloc(data, *kids[b"iloc"]) if b"iloc" in kids else {}
    idat = data[kids[b"idat"][0]:kids[b"idat"][1]] if b"idat" in kids else b""
    for iid, (method, extents) in locs.items():
        if iid not in items:
            continue
        parts = []
        for off, ln in extents:
            src = data if method == 0 else idat
            if method not in (0, 1):
                raise HeifError(f"AVIF iloc construction method {method}")
            if ln == 0:
                ln = len(src) - off
            if off + ln > len(src):
                raise HeifError("AVIF item extent past the end of the file")
            parts.append(src[off:off + ln])
        items[iid].data = b"".join(parts)
    if b"iprp" in kids:
        a, b = kids[b"iprp"]
        props = []
        assoc = []
        for k, s, e in boxes(data, a, b):
            if k == b"ipco":
                props = [(kk.decode("latin-1"), _property(kk, data, ss, ee)) for kk, ss, ee in boxes(data, s, e)]
            elif k == b"ipma":
                v, flags, r = _full(data, s)
                n, r = _uint(data, r, 4)
                for _ in range(n):
                    iid, r = _uint(data, r, 2 if v < 1 else 4)
                    cnt = data[r]
                    r += 1
                    for _ in range(cnt):
                        if flags & 1:
                            x, r = _uint(data, r, 2)
                            ess, idx = x >> 15, x & 0x7FFF
                        else:
                            ess, idx = data[r] >> 7, data[r] & 0x7F
                            r += 1
                        assoc.append((iid, idx, ess))
        for iid, idx, ess in assoc:
            if iid in items and 1 <= idx <= len(props):
                name, val = props[idx - 1]
                items[iid].props.setdefault(name, val)
                if ess:
                    items[iid].essential.append(name)
    if b"iref" in kids:
        a, b = kids[b"iref"]
        v, _, q = _full(data, a)
        w = 2 if v == 0 else 4
        for k, s, e in boxes(data, q, b):
            src, r = _uint(data, s, w)
            n, r = _uint(data, r, 2)
            for _ in range(n):
                dst, r = _uint(data, r, w)
                if src in items:
                    items[src].refs.setdefault(k.decode("latin-1"), []).append(dst)
    return primary, items


def _first_track_sample(data: bytes, moov: Tuple[int, int]) -> Item:
    """The first sample of the first ``av01`` track, as an item."""
    for k, s, e in boxes(data, *moov):
        if k != b"trak":
            continue
        path = [b"mdia", b"minf", b"stbl"]
        pos, end = s, e
        for name in path:
            found = [(a, b) for kk, a, b in boxes(data, pos, end) if kk == name]
            if not found:
                break
            pos, end = found[0]
        else:
            tables = {kk: (a, b) for kk, a, b in boxes(data, pos, end)}
            if b"stsd" not in tables:
                continue
            a, b = tables[b"stsd"]
            entries = list(boxes(data, a + 8, b))
            if not entries or entries[0][0] != b"av01":
                continue
            _, es, ee = entries[0]
            item = Item(1, "av01")
            for kk, a2, b2 in boxes(data, es + 78, ee):  # past the VisualSampleEntry fields
                item.props.setdefault(kk.decode("latin-1"), _property(kk, data, a2, b2))
            a, b = tables[b"stsz"]
            fixed, count = struct.unpack(">II", data[a + 4:a + 12])
            size = fixed or struct.unpack(">I", data[a + 12:a + 16])[0]
            if b"stco" in tables:
                off = struct.unpack(">I", data[tables[b"stco"][0] + 8:tables[b"stco"][0] + 12])[0]
            else:
                off = struct.unpack(">Q", data[tables[b"co64"][0] + 8:tables[b"co64"][0] + 16])[0]
            item.data = data[off:off + size]
            return item
    raise HeifError("AVIF image sequence without an av01 track")


def is_avif(data: bytes) -> bool:
    """An ``ftyp`` whose major or compatible brands name AVIF (libavif's
    ``avifPeekCompatibleFileType``)."""
    if data[4:8] != b"ftyp":
        return False
    size = int.from_bytes(data[:4], "big")
    body = data[8:max(size, 16)]
    brands = [body[:4]] + [body[i:i + 4] for i in range(8, len(body) - 3, 4)]
    return any(b in (b"avif", b"avis") for b in brands)


def parse(data: bytes) -> Heif:
    top = {}
    for k, s, e in boxes(data, 0, len(data)):
        top.setdefault(k, (s, e))
    if b"ftyp" not in top:
        raise HeifError("not an AVIF file (no ftyp)")
    s, e = top[b"ftyp"]
    major = data[s:s + 4]
    brands = [major] + [data[i:i + 4] for i in range(s + 8, e - 3, 4)]
    has_meta = b"meta" in top
    if (major == b"avis" or not has_meta) and b"moov" in top:
        item = _first_track_sample(data, top[b"moov"])
        return Heif(major, brands, 1, {1: item})
    if not has_meta:
        raise HeifError("AVIF without a meta box")
    primary, items = _meta(data, *top[b"meta"])
    if primary not in items:
        raise HeifError("AVIF primary item missing from iinf")
    return Heif(major, brands, primary, items)
