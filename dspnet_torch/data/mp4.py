"""ISO base media files (MP4), read and written without cv2: the demuxer
and muxer of the port's MPEG-4 Part 2 video (``data/mpeg4.py``), the
counterpart of ``cv2.VideoCapture`` / ``cv2.VideoWriter(fourcc "mp4v")`` in
the JAX demo's video branch (``dspnet_tpu/detect/detector.py:289,313``).

:class:`Mp4Reader` walks ``moov`` / ``trak`` to the video track (a ``vide``
handler): its ``stsd`` sample entry (``mp4v`` with an ``esds`` whose
DecoderSpecificInfo holds the VOS / VO / VOL headers), ``stsz``, ``stsc``,
``stco`` / ``co64``, ``stts`` (frames per second as cv2 reports them: the
media timescale over the first sample's duration), ``stss`` and ``ctts``,
and yields the samples in decode order. An ``avc1`` / ``avc3`` entry with
an ``avcC`` is H.264 (``data/h264_cuda.py``): its ``ctts`` and an edit list
shifting by the B-frame delay are read; an edit that drops frames raises
(cv2 returns no frames for it). It refuses by name: a fragmented file
(``moof`` / ``mvex``); for mp4v an edit list that drops or shifts frames
(more than one entry, an empty edit or a non-zero media time) and
composition offsets in ``ctts`` (frames out of decode order); more than one
video track; and every other sample entry (HEVC, AV1, VP9 and the rest are
named).

:class:`Mp4Writer` writes ``ftyp`` (``isom``), ``free``, ``mdat`` and
``moov`` in the order cv2's FFmpeg muxer writes them: one ``mp4v`` track at
a 12800 timescale, an ``esds`` carrying the VOL, ``stts``, ``stss`` for
the I-VOPs, ``stsc``, ``stsz`` and ``stco`` (``co64`` once a sample lies
past 4 GiB).
"""

from __future__ import annotations

import struct
from fractions import Fraction
from typing import Iterator, List, NamedTuple, Optional


class VideoError(ValueError):
    """A video file the port does not read, or a broken one."""


#: names of the video sample entries the port does not decode
CODEC_NAMES = {
    "avc1": "H.264", "avc3": "H.264", "hvc1": "HEVC", "hev1": "HEVC", "mp4v": "MPEG-4 Part 2",
    "av01": "AV1", "vp09": "VP9", "vp08": "VP8", "mjp2": "Motion JPEG 2000", "jpeg": "Motion-JPEG",
    "mp4s": "MPEG-4 Systems", "s263": "H.263", "dvh1": "Dolby Vision", "dvhe": "Dolby Vision",
}
#: the sample entries of H.264 (an ``avcC`` box holds the configuration)
H264_ENTRIES = ("avc1", "avc3")
#: the movie and media timescales the writer uses (cv2's muxer: 1000 and
#: 512 per frame at 25 fps)
MOVIE_TIMESCALE = 1000
MEDIA_TICKS_PER_FRAME = 512
#: MPEG-4 Visual's object type in the ES descriptor
OBJECT_TYPE_MPEG4_VISUAL = 0x20


def boxes(data: bytes, pos: int, end: int):
    """(type, body start, box end) of each box from ``pos`` to ``end``."""
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            (size,) = struct.unpack(">Q", data[pos + 8:pos + 16])
            head = 16
        elif size == 0:
            size = end - pos
        if size < head:
            return
        yield kind, pos + head, min(pos + size, end)
        pos += size


def _find(data: bytes, pos: int, end: int, kind: bytes):
    return [(p, e) for k, p, e in boxes(data, pos, end) if k == kind]


def _video_traks(data: bytes):
    """(trak, mdia, stbl) spans of every track with a ``vide`` handler."""
    out = []
    for moov in _find(data, 0, len(data), b"moov"):
        for trak in _find(data, *moov, b"trak"):
            for mdia in _find(data, *trak, b"mdia"):
                hdlr = _find(data, *mdia, b"hdlr")
                if not hdlr or data[hdlr[0][0] + 8:hdlr[0][0] + 12] != b"vide":
                    continue
                for minf in _find(data, *mdia, b"minf"):
                    for stbl in _find(data, *minf, b"stbl"):
                        out.append((trak, mdia, stbl))
    return out


def probe_mp4(path: str) -> Optional[str]:
    """The format fourcc of an MP4's first video sample entry (``moov`` /
    ``trak`` with a ``vide`` handler / ``stsd``), or None when there is
    none."""
    with open(path, "rb") as f:
        data = f.read()
    for _, _, stbl in _video_traks(data):
        for p, e in _find(data, *stbl, b"stsd"):
            for kind, _, _ in boxes(data, p + 8, e):
                return kind.decode("latin-1")
    return None


def _descriptor(data: bytes, pos: int):
    """(tag, body start, body end) of the MPEG-4 descriptor at ``pos``."""
    tag = data[pos]
    pos += 1
    size = 0
    for _ in range(4):
        b = data[pos]
        pos += 1
        size = (size << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, pos + size


def _decoder_specific_info(esds: bytes) -> bytes:
    """The DecoderSpecificInfo of an ``esds`` body (after its version and
    flags): the VOS / VO / VOL headers of an MPEG-4 Part 2 track."""
    tag, p, end = _descriptor(esds, 4)
    if tag != 3:
        raise VideoError("esds without an ES descriptor")
    flags = esds[p + 2]
    p += 3
    if flags & 0x80:
        p += 2
    if flags & 0x40:
        p += 1 + esds[p]
    if flags & 0x20:
        p += 2
    while p < end:
        tag, body, stop = _descriptor(esds, p)
        if tag == 4:  # DecoderConfigDescriptor
            q = body + 13
            while q < stop:
                t, b2, s2 = _descriptor(esds, q)
                if t == 5:
                    return esds[b2:s2]
                q = s2
        p = stop
    raise VideoError("esds without a DecoderSpecificInfo")


class Stream(NamedTuple):
    """What a video file's header says of its video stream (an AVI's first
    video stream, an MP4's video track)."""

    width: int
    height: int
    fps: float
    fourcc: str
    #: frames the header declares (an AVI's main header's or OpenDML's
    #: total; an MP4's sample count)
    declared_frames: int
    #: the decoder the frames take: "mjpeg", "mpeg4" or "h264"
    codec: str = "mjpeg"
    #: the decoder's configuration (an mp4v track's VOS / VO / VOL headers,
    #: an H.264 track's avcC; none in an AVI, where both are in band)
    extradata: bytes = b""


class Mp4Reader:
    """The samples of an MP4's video track in decode order (see the module's
    text). ``stream`` holds size, fps, fourcc, codec and the VOL headers;
    ``len()`` is the sample count; iterating yields each sample's bytes;
    ``keyframes`` the sync samples' indices (all, without ``stss``)."""

    def __init__(self, path: str):
        self.path = str(path)
        with open(self.path, "rb") as f:
            self._data = data = f.read()
        top = [k for k, _, _ in boxes(data, 0, len(data))]
        if b"moof" in top or any(_find(data, p, e, b"mvex") for p, e in _find(data, 0, len(data), b"moov")):
            raise VideoError(f"{self.path}: a fragmented MP4 (moof / mvex) is not read")
        traks = _video_traks(data)
        if not traks:
            raise VideoError(f"{self.path}: an MP4 without a video track")
        if len(traks) > 1:
            raise VideoError(f"{self.path}: an MP4 with {len(traks)} video tracks is not read (cv2 decodes one of "
                           "them by FFmpeg's stream choice, which the port does not follow)")
        trak, mdia, stbl = traks[0]
        stsd = _find(data, *stbl, b"stsd")
        if not stsd:
            raise VideoError(f"{self.path}: the video track has no sample description (stsd)")
        entry = next(boxes(data, stsd[0][0] + 8, stsd[0][1]), None)
        if entry is None:
            raise VideoError(f"{self.path}: the video track's stsd is empty")
        kind, ep, ee = entry
        fourcc = kind.decode("latin-1")
        avcc = _find(data, ep + 78, ee, b"avcC") if fourcc in H264_ENTRIES else []
        if fourcc != "mp4v" and not avcc:
            name = CODEC_NAMES.get(fourcc, "an unknown codec")
            lack = " without an avcC box" if fourcc in H264_ENTRIES else ""
            raise VideoError(f"{self.path}: MP4 video coded as {name} ({fourcc!r}){lack} is not read: the port "
                           "decodes MPEG-4 Part 2 ('mp4v') and H.264 ('avc1', 'avc3') in MP4 and Motion-JPEG, "
                           "MPEG-4 Part 2 or H.264 in AVI; write the clip as H.264, mp4v or Motion-JPEG")
        h264 = bool(avcc)
        if not h264:
            self._check_edits(trak)
        mdhd = _find(data, *mdia, b"mdhd")
        if not mdhd:
            raise VideoError(f"{self.path}: the video track has no media header (mdhd)")
        mdhd = mdhd[0][0]
        if data[mdhd] == 1:
            (timescale,) = struct.unpack(">I", data[mdhd + 20:mdhd + 24])
        else:
            (timescale,) = struct.unpack(">I", data[mdhd + 12:mdhd + 16])
        width, height = struct.unpack(">HH", data[ep + 24:ep + 28])
        if h264:
            extradata = data[avcc[0][0]:avcc[0][1]]
        else:
            esds = _find(data, ep + 78, ee, b"esds")
            if not esds:
                raise VideoError(f"{self.path}: the mp4v sample entry has no esds")
            extradata = _decoder_specific_info(data[esds[0][0]:esds[0][1]])
        self._samples = self._sample_table(stbl)
        ctts = self._table(stbl, b"ctts", 8, ">Ii")
        if h264:
            self._check_h264_edits(trak, ctts)
        elif any(offset for _, offset in ctts):
            raise VideoError(f"{self.path}: composition time offsets (ctts): frames out of decode order, as "
                             "B-VOPs need, are not read")
        durations = self._table(stbl, b"stts", 8, ">II")
        fps = timescale / durations[0][1] if durations and durations[0][1] else 0.0
        stss = self._table(stbl, b"stss", 4, ">I")
        self.keyframes = [s[0] - 1 for s in stss] if _find(data, *stbl, b"stss") else list(range(len(self)))
        self.stream = Stream(width, height, fps, fourcc, len(self._samples), "h264" if h264 else "mpeg4", extradata)

    def _check_edits(self, trak) -> None:
        data = self._data
        for edts in _find(data, *trak, b"edts"):
            for p, _ in _find(data, *edts, b"elst"):
                version = data[p]
                (count,) = struct.unpack(">I", data[p + 4:p + 8])
                fmt, size = (">QqHH", 20) if version == 1 else (">IiHH", 12)
                entries = [struct.unpack(fmt, data[p + 8 + i * size:p + 8 + (i + 1) * size]) for i in range(count)]
                if len(entries) > 1 or any(e[1] != 0 or e[2] != 1 for e in entries):
                    raise VideoError(f"{self.path}: an edit list that drops or shifts frames is not read "
                                   f"(elst entries {[e[:3] for e in entries]})")

    def _check_h264_edits(self, trak, ctts) -> None:
        """An H.264 track's edit list as FFmpeg's MOV demuxer treats it
        (measured through cv2): one edit whose media time is at most the
        earliest composition time (decode time plus ``ctts`` offset: the
        B-frame delay) drops no frame; one that starts later drops frames,
        and cv2 then returns none."""
        data = self._data
        stbl = next(iter(_find(data, *trak, b"mdia")), None)
        stts = []
        if stbl is not None:
            for minf in _find(data, *stbl, b"minf"):
                for st in _find(data, *minf, b"stbl"):
                    stts = self._table(st, b"stts", 8, ">II")
        dts = [0]
        for count, delta in stts:
            for _ in range(count):
                dts.append(dts[-1] + delta)
        offsets = [off for count, off in ctts for _ in range(count)] or [0]
        first = min(d + o for d, o in zip(dts, offsets))
        for edts in _find(data, *trak, b"edts"):
            for p, _ in _find(data, *edts, b"elst"):
                version = data[p]
                (count,) = struct.unpack(">I", data[p + 4:p + 8])
                fmt, size = (">QqHH", 20) if version == 1 else (">IiHH", 12)
                entries = [struct.unpack(fmt, data[p + 8 + i * size:p + 8 + (i + 1) * size]) for i in range(count)]
                if len(entries) > 1 or any(e[1] < 0 or e[2] != 1 for e in entries):
                    raise VideoError(f"{self.path}: an edit list of {len(entries)} entries, empty edits or a rate "
                                     f"other than 1 is not read (elst entries {[e[:3] for e in entries]})")
                if entries and entries[0][1] > first:
                    raise VideoError(f"{self.path}: an edit list that drops frames (media time {entries[0][1]} "
                                     f"after the earliest composition time {first}): cv2 returns no frames from it")

    def _table(self, stbl, kind: bytes, size: int, fmt: str) -> list:
        found = _find(self._data, *stbl, kind)
        if not found:
            return []
        p = found[0][0]
        (count,) = struct.unpack(">I", self._data[p + 4:p + 8])
        return [struct.unpack(fmt, self._data[p + 8 + i * size:p + 8 + (i + 1) * size]) for i in range(count)]

    def _sample_table(self, stbl) -> List[tuple]:
        """(offset, size) of every sample, from stsz, stsc and stco / co64."""
        data = self._data
        stsz = _find(data, *stbl, b"stsz")
        if not stsz:
            raise VideoError(f"{self.path}: the video track has no sample sizes (stsz)")
        p = stsz[0][0]
        fixed, count = struct.unpack(">II", data[p + 4:p + 12])
        sizes = [fixed] * count if fixed else list(struct.unpack(f">{count}I", data[p + 12:p + 12 + 4 * count]))
        if _find(data, *stbl, b"co64"):
            chunks = [c[0] for c in self._table(stbl, b"co64", 8, ">Q")]
        else:
            chunks = [c[0] for c in self._table(stbl, b"stco", 4, ">I")]
        stsc = self._table(stbl, b"stsc", 12, ">III")
        out, s = [], 0
        for i, (first, per, _) in enumerate(stsc):
            last = stsc[i + 1][0] - 1 if i + 1 < len(stsc) else len(chunks)
            for c in range(first - 1, last):
                off = chunks[c]
                for _ in range(per):
                    if s >= count:
                        break
                    out.append((off, sizes[s]))
                    off += sizes[s]
                    s += 1
        if s != count:
            raise VideoError(f"{self.path}: the sample table places {s} of {count} samples")
        return out

    def __len__(self) -> int:
        return len(self._samples)

    def __iter__(self) -> Iterator[bytes]:
        for off, size in self._samples:
            if off + size > len(self._data):
                raise VideoError(f"{self.path}: a sample runs past the end of the file")
            yield self._data[off:off + size]

    def close(self):
        self._data = b""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _desc(tag: int, body: bytes) -> bytes:
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F, 0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


class Mp4Writer:
    """Writes MPEG-4 Part 2 samples into an MP4 (see the module's text).
    ``write(sample, keyframe)`` appends one VOP; ``close()`` writes
    ``moov``. ``config``: the VOS / VO / VOL headers (the ``esds``'s
    DecoderSpecificInfo)."""

    def __init__(self, path: str, width: int, height: int, config: bytes, fps: float = 25):
        self.path, self.width, self.height, self.config = str(path), int(width), int(height), bytes(config)
        rate = Fraction(fps).limit_denominator(1001)
        self.timescale = rate.numerator * MEDIA_TICKS_PER_FRAME
        self.delta = rate.denominator * MEDIA_TICKS_PER_FRAME
        self._f = open(self.path, "wb")
        self._f.write(_box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41"))
        self._f.write(_box(b"free"))
        self._mdat = self._f.tell()
        self._f.write(struct.pack(">I4sQ", 1, b"mdat", 0))  # 64-bit size, filled by close()
        self._sizes: List[int] = []
        self._offsets: List[int] = []
        self._keys: List[int] = []
        self._bytes = 0

    def write(self, sample: bytes, keyframe: bool) -> None:
        self._offsets.append(self._f.tell())
        self._f.write(sample)
        self._sizes.append(len(sample))
        self._bytes = max(self._bytes, len(sample))
        if keyframe:
            self._keys.append(len(self._sizes))

    def _moov(self) -> bytes:
        n = len(self._sizes)
        duration = n * self.delta
        movie = duration * MOVIE_TIMESCALE // self.timescale
        w, h = self.width, self.height
        mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, MOVIE_TIMESCALE, movie), struct.pack(">IH", 0x10000, 0x100),
                     bytes(10), _MATRIX, bytes(24), struct.pack(">I", 2))
        tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie), bytes(8), struct.pack(">hhHH", 0, 0, 0, 0),
                     _MATRIX, struct.pack(">II", w << 16, h << 16))
        elst = _full(b"elst", 0, 0, struct.pack(">IIiHH", 1, movie, 0, 1, 0))
        mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, self.timescale, duration), struct.pack(">HH", 0x55C4, 0))
        hdlr = _full(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12), b"VideoHandler\0")
        es = _desc(3, struct.pack(">HB", 1, 0) + _desc(4, struct.pack(">BB", OBJECT_TYPE_MPEG4_VISUAL, 0x11) +
                                                       struct.pack(">I", self._bytes)[1:] + struct.pack(">II", 0, 0) +
                                                       _desc(5, self.config)) + _desc(6, b"\x02"))
        esds = _full(b"esds", 0, 0, es)
        entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16), struct.pack(">HH", w, h),
                     struct.pack(">II", 0x480000, 0x480000), bytes(4), struct.pack(">H", 1), bytes(32),
                     struct.pack(">Hh", 0x18, -1), esds)
        stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), entry)
        stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, self.delta))
        stss = _full(b"stss", 0, 0, struct.pack(f">I{len(self._keys)}I", len(self._keys), *self._keys))
        stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
        stsz = _full(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *self._sizes))
        if self._offsets and self._offsets[-1] >= 1 << 32:
            stco = _full(b"co64", 0, 0, struct.pack(f">I{n}Q", n, *self._offsets))
        else:
            stco = _full(b"stco", 0, 0, struct.pack(f">I{n}I", n, *self._offsets))
        stbl = _box(b"stbl", stsd, stts, stss, stsc, stsz, stco)
        dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1), _full(b"url ", 0, 1)))
        minf = _box(b"minf", _full(b"vmhd", 0, 1, bytes(8)), dinf, stbl)
        trak = _box(b"trak", tkhd, _box(b"edts", elst), _box(b"mdia", mdhd, hdlr, minf))
        return _box(b"moov", mvhd, trak)

    def close(self) -> None:
        if self._f.closed:
            return
        end = self._f.tell()
        self._f.seek(self._mdat + 8)
        self._f.write(struct.pack(">Q", end - self._mdat))
        self._f.seek(end)
        self._f.write(self._moov())
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
