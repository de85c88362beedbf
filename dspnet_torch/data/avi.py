"""Motion-JPEG and MPEG-4 Part 2 in AVI, read without cv2, and Motion-JPEG
AVI written: the port's counterpart of ``cv2.VideoCapture`` /
``cv2.VideoWriter`` in the JAX demo's video branch
(``dspnet_tpu/detect/detector.py:289,313``).

A stream's ``codec`` says which decoder its frames take. Each frame of a
Motion-JPEG file is one JPEG, so the frames' pixels come from the
port's JPEG decoders (nvJPEG and the colour kernel on the card, the plain
decoder on the CPU: ``data/jpeg_cuda.py``), which follow libjpeg, cv2's own
MJPEG backend (``CAP_OPENCV_MJPEG``). cv2's FFmpeg backend decodes the same
frames with FFmpeg's decoder, whose pixels differ from libjpeg's
(``tests/test_torch_video.py`` measures the gap).

:class:`AviReader` parses the RIFF header list (``avih``; the first video
stream's ``strh`` and ``strf``: frames per second ``dwRate / dwScale``, the
BITMAPINFOHEADER's size and compression fourcc) and walks the ``movi``
lists in file order, the first ``RIFF AVI`` one and the OpenDML ``RIFF
AVIX`` continuations, taking the stream's ``NNdc`` / ``NNdb`` chunks and
stepping over ``JUNK``, index chunks and the pad byte after an odd-sized
chunk; it reads no index (``idx1``, ``indx``), so a file without one reads
the same. Motion-JPEG's fourccs (``MJPG``, ``mjpg``, ``AVDJ``, ``jpeg``,
``JPEG``) give ``codec`` "mjpeg", and an interlaced frame (an ``AVI1`` APP0
marking a field pair) raises. The MPEG-4 Part 2 fourccs that cv2's FFmpeg
maps to its ``mpeg4`` decoder (:data:`MPEG4_FOURCCS`: ``XVID``, ``DIVX``,
``DX50``, ``FMP4``, ``MP4V``, ``mp4v`` and the others measured) give
"mpeg4": each frame chunk is one VOP, the VOL headers in band
(``data/mpeg4_cuda.py`` decodes them). The H.264 fourccs cv2's FFmpeg maps
to its ``h264`` decoder (:data:`H264_FOURCCS`: ``H264``, ``X264``,
``avc1``, ``DAVC``, ``VSSH`` and the others measured) give "h264": each
chunk holds Annex B NAL units, the parameter sets in band
(``data/h264_cuda.py`` decodes them). Every other fourcc raises and names
it.

:class:`AviWriter` writes AVI 1.0 with ``idx1`` (fourcc ``MJPG``, 25 frames
per second by default as the JAX branch writes), the OpenDML header list
(``odml``/``dmlh``), a super index (``indx``) and a standard index chunk
(``ix00``) for each ``movi`` list; a file that would pass 1 GiB goes on in
``RIFF AVIX`` segments, as OpenDML writers do. cv2's own Motion-JPEG reader
parses every RIFF segment as a whole AVI (a header list, a ``movi`` list,
an ``idx1``) and stops at a continuation without them, so each ``AVIX``
segment here also repeats the header list and ends with an ``idx1`` of its
own frames; FFmpeg and this reader step over both.

:func:`open_video` opens an AVI as :class:`AviReader` and an MP4 as
``data/mp4.py``'s ``Mp4Reader``, which reads an ``mp4v`` or H.264
(``avc1`` / ``avc3``) track and refuses every other codec by name (HEVC,
AV1, VP9, ...). :func:`probe_mp4`
lives in ``data/mp4.py`` now and is imported here for its callers.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Iterator, List, Optional, Tuple, Union

from dspnet_torch.data import mp4
from dspnet_torch.data.mp4 import Stream, VideoError, probe_mp4  # noqa: F401 (probe_mp4 moved to mp4.py)

#: BITMAPINFOHEADER compression fourccs of Motion-JPEG
MJPEG_FOURCCS = (b"MJPG", b"mjpg", b"AVDJ", b"jpeg", b"JPEG")
#: fourccs of MPEG-4 Part 2 that cv2's FFmpeg reads with its ``mpeg4``
#: decoder (each checked here with a cv2-written clip whose header was
#: given that fourcc)
MPEG4_FOURCCS = (b"XVID", b"xvid", b"DIVX", b"divx", b"DX50", b"dx50", b"FMP4", b"fmp4", b"MP4V", b"mp4v",
                 b"MP4S", b"mp4s", b"M4S2", b"m4s2", b"DIV1", b"div1", b"BLZ0", b"FFDS", b"3IV2", b"SEDG",
                 b"WV1F", b"DXGM", b"PM4V", b"SMP4", b"XVIX", b"SIPP", b"RMP4")
#: fourccs cv2's FFmpeg reads with its ``h264`` decoder (each checked here
#: with an AVI of Annex B samples given that fourcc; others give no frames)
H264_FOURCCS = (b"H264", b"h264", b"X264", b"x264", b"avc1", b"AVC1", b"Avc1", b"DAVC", b"davc", b"SMV2", b"smv2",
                b"VSSH", b"vssh", b"Q264", b"q264", b"V264", b"v264", b"GAVC", b"gavc", b"UMSV", b"umsv", b"tshd",
                b"TSHD", b"INMC", b"inmc", b"AI5Q", b"ai5q")
#: the size at which the writer starts the next RIFF segment (OpenDML)
RIFF_LIMIT = 1 << 30
#: super index entries the writer reserves: one per RIFF segment
SUPER_INDEX_ENTRIES = 256

_AVIF_HASINDEX, _AVIF_ISINTERLEAVED, _AVIF_TRUSTCKTYPE = 0x10, 0x100, 0x800
_AVIIF_KEYFRAME = 0x10


def _fourcc(b: bytes) -> str:
    return b.decode("latin-1")


class AviReader:
    """The frames of a Motion-JPEG or MPEG-4 Part 2 AVI, as each frame
    chunk's bytes (a JPEG, or a VOP) in file order.

    ``stream`` holds the size, frames per second and fourcc; ``len()`` is the
    number of frame chunks found; iterating yields each frame's bytes."""

    def __init__(self, path: str):
        self.path = str(path)
        self._f: BinaryIO = open(self.path, "rb")
        try:
            self._size = os.fstat(self._f.fileno()).st_size
            self.stream, self._ids = self._header()
            self._chunks = self._walk()
        except Exception:
            self._f.close()
            raise

    # -- parsing

    def _read(self, pos: int, n: int) -> bytes:
        self._f.seek(pos)
        return self._f.read(n)

    def _chunk(self, pos: int, end: int) -> Optional[Tuple[bytes, int, int]]:
        """(fourcc, data position, data size) of the chunk at ``pos``, its
        size cut to ``end``; None past the end."""
        if pos + 8 > end:
            return None
        head = self._read(pos, 8)
        if len(head) < 8:
            return None
        (size,) = struct.unpack("<I", head[4:])
        return head[:4], pos + 8, min(size, end - pos - 8)

    def _header(self):
        head = self._read(0, 12)
        if head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise VideoError(f"{self.path}: not an AVI file (no RIFF AVI header)")
        riff_end = min(8 + struct.unpack("<I", head[4:8])[0], self._size)
        pos, hdrl = 12, None
        while (c := self._chunk(pos, riff_end)) is not None:
            fcc, data, size = c
            if fcc == b"LIST" and self._read(data, 4) == b"hdrl":
                hdrl = (data + 4, data + size)
                break
            pos = data + size + (size & 1)
        if hdrl is None:
            raise VideoError(f"{self.path}: AVI without a header list (hdrl)")
        avih, streams, dmlh = None, [], None
        pos = hdrl[0]
        while (c := self._chunk(pos, hdrl[1])) is not None:
            fcc, data, size = c
            if fcc == b"avih":
                avih = self._read(data, min(size, 56))
            elif fcc == b"LIST":
                kind = self._read(data, 4)
                if kind == b"strl":
                    streams.append(self._strl(data + 4, data + size))
                elif kind == b"odml":
                    sub = self._chunk(data + 4, data + size)
                    if sub and sub[0] == b"dmlh" and sub[2] >= 4:
                        (dmlh,) = struct.unpack("<I", self._read(sub[1], 4))
            pos = data + size + (size & 1)
        if avih is None or len(avih) < 40:
            raise VideoError(f"{self.path}: AVI without a main header (avih)")
        video = [(i, s) for i, s in enumerate(streams) if s[0] == b"vids"]
        if not video:
            raise VideoError(f"{self.path}: AVI without a video stream")
        index, (_, strh, strf) = video[0]
        if strh is None or len(strh) < 32 or strf is None or len(strf) < 20:
            raise VideoError(f"{self.path}: the video stream has no strh / strf header")
        scale, rate = struct.unpack("<II", strh[20:28])
        width, height = struct.unpack("<ii", strf[4:12])
        compression = strf[16:20]
        if compression not in MJPEG_FOURCCS + MPEG4_FOURCCS + H264_FOURCCS:
            raise VideoError(f"{self.path}: the video stream is coded as {_fourcc(compression)!r} "
                             f"(fourcc {compression!r}); the port reads Motion-JPEG "
                             f"({', '.join(_fourcc(f) for f in MJPEG_FOURCCS)}), MPEG-4 Part 2 "
                             f"({', '.join(_fourcc(f) for f in MPEG4_FOURCCS)}) and H.264 "
                             f"({', '.join(_fourcc(f) for f in H264_FOURCCS)}) AVI; write the clip as H.264, mp4v "
                             "or Motion-JPEG")
        if scale == 0 or rate == 0:
            raise VideoError(f"{self.path}: the video stream's rate is {rate}/{scale}")
        (total,) = struct.unpack("<I", avih[16:20])
        codec = "mjpeg" if compression in MJPEG_FOURCCS else ("h264" if compression in H264_FOURCCS else "mpeg4")
        stream = Stream(width, abs(height), rate / scale, _fourcc(compression), dmlh if dmlh else total, codec)
        ids = (f"{index:02d}dc".encode(), f"{index:02d}db".encode())
        return stream, ids

    def _strl(self, pos: int, end: int):
        strh = strf = None
        while (c := self._chunk(pos, end)) is not None:
            fcc, data, size = c
            if fcc == b"strh":
                strh = self._read(data, min(size, 56))
            elif fcc == b"strf":
                strf = self._read(data, min(size, 40))
            pos = data + size + (size & 1)
        return (strh[:4] if strh else None), strh, strf

    def _walk(self) -> List[Tuple[int, int]]:
        """(position, size) of every frame chunk of the stream, over the RIFF
        AVI and RIFF AVIX segments' movi lists in file order."""
        chunks, pos = [], 0
        while (c := self._chunk(pos, self._size)) is not None:
            fcc, data, size = c
            if fcc == b"RIFF" and self._read(data, 4) in (b"AVI ", b"AVIX"):
                self._movi(data + 4, data + size, chunks, top=True)
            pos = data + size + (size & 1)
        return chunks

    def _movi(self, pos: int, end: int, chunks: list, top: bool = False):
        while (c := self._chunk(pos, end)) is not None:
            fcc, data, size = c
            if fcc == b"LIST":
                kind = self._read(data, 4)
                if kind == b"movi" or (kind == b"rec " and not top):
                    self._movi(data + 4, data + size, chunks)
            elif not top and fcc in self._ids and size > 0:
                chunks.append((data, size))
            pos = data + size + (size & 1)

    # -- frames

    def __len__(self) -> int:
        return len(self._chunks)

    def __iter__(self) -> Iterator[bytes]:
        for pos, size in self._chunks:
            data = self._read(pos, size)
            if self.stream.codec == "mjpeg":
                _check_frame(data, self.path)
            yield data

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _check_frame(data: bytes, path: str):
    """Raise on a frame that is not one progressive-scan image: not a JPEG,
    or an ``AVI1`` APP0 marking one field of an interlaced pair."""
    if data[:2] != b"\xff\xd8":
        raise VideoError(f"{path}: a frame chunk is not a JPEG stream (no SOI marker)")
    if data[2:4] == b"\xff\xe0" and data[6:10] == b"AVI1" and len(data) > 10 and data[10] != 0:
        raise VideoError(f"{path}: interlaced Motion-JPEG (an AVI1 field pair, polarity {data[10]}) is "
                         "not read")


class AviWriter:
    """Writes JPEG frames into a Motion-JPEG AVI (see the module's text).
    ``write(jpeg_bytes)`` appends one frame; ``close()`` finishes the
    headers and indexes. ``_riff_limit``: the segment size (tests make it
    small to reach the ``AVIX`` continuation)."""

    def __init__(self, path: str, width: int, height: int, fps: float = 25, _riff_limit: int = RIFF_LIMIT):
        self.path, self.width, self.height, self.fourcc = str(path), int(width), int(height), b"MJPG"
        self.rate, self.scale = _rational(fps)
        self._limit = _riff_limit
        self._f = open(self.path, "wb")
        self._frames = 0
        self._max_chunk = 0
        self._segments = []  # (ix00 position, ix00 size, frames) per RIFF
        self._hdrls = []  # where each copy of the header list starts
        self._write_header()
        self._open_movi()

    def _write_header(self):
        self._f.write(b"RIFF\0\0\0\0AVI ")
        self._riff_start = 0
        self._write_hdrl()

    def _write_hdrl(self):
        """The header list, its counts left 0 until :meth:`close` fills every
        copy (offsets of its fields from the list's start in ``_at``)."""
        f = self._f
        hdrl = self._list(b"hdrl")
        self._hdrls.append(hdrl)
        at = {}
        f.write(b"avih" + struct.pack("<I", 56))
        at["avih"] = f.tell() - hdrl
        f.write(bytes(56))
        strl = self._list(b"strl")
        f.write(b"strh" + struct.pack("<I", 56))
        at["strh"] = f.tell() - hdrl
        f.write(bytes(56))
        f.write(b"strf" + struct.pack("<I", 40))
        f.write(struct.pack("<IiiHH4sIiiII", 40, self.width, self.height, 1, 24, self.fourcc,
                            self.width * self.height * 3, 0, 0, 0, 0))
        indx_size = 24 + 16 * SUPER_INDEX_ENTRIES
        f.write(b"indx" + struct.pack("<I", indx_size))
        at["indx"] = f.tell() - hdrl
        f.write(bytes(indx_size))
        self._close_list(strl)
        odml = self._list(b"odml")
        f.write(b"dmlh" + struct.pack("<I", 248))
        at["dmlh"] = f.tell() - hdrl
        f.write(bytes(248))
        self._close_list(odml)
        self._close_list(hdrl)
        self._at = at

    def _list(self, kind: bytes) -> int:
        pos = self._f.tell()
        self._f.write(b"LIST\0\0\0\0" + kind)
        return pos

    def _close_list(self, pos: int):
        end = self._f.tell()
        self._f.seek(pos + 4)
        self._f.write(struct.pack("<I", end - pos - 8))
        self._f.seek(end)

    def _open_movi(self):
        self._movi = self._list(b"movi")
        self._movi_frames = []  # (data position, size)

    def _close_segment(self, last: bool):
        """End the current movi list with its ix00, then the RIFF with the
        idx1 of its frames (offsets from the 'movi' id), and patch the RIFF's
        size."""
        f = self._f
        ix = f.tell()
        base = self._movi
        n = len(self._movi_frames)
        f.write(b"ix00" + struct.pack("<I", 24 + 8 * n))
        f.write(struct.pack("<HBBI4sQI", 2, 0, 1, n, b"00dc", base, 0))
        f.write(b"".join(struct.pack("<II", pos - base, size) for pos, size in self._movi_frames))
        self._segments.append((ix, 32 + 8 * n, n))
        self._close_list(self._movi)
        f.write(b"idx1" + struct.pack("<I", 16 * n))
        f.write(b"".join(struct.pack("<4sIII", b"00dc", _AVIIF_KEYFRAME, pos - 8 - (base + 8), size)
                         for pos, size in self._movi_frames))
        end = f.tell()
        f.seek(self._riff_start + 4)
        f.write(struct.pack("<I", end - self._riff_start - 8))
        f.seek(end)
        if not last:
            if len(self._segments) >= SUPER_INDEX_ENTRIES:
                raise VideoError(f"{self.path}: more than {SUPER_INDEX_ENTRIES} RIFF segments")
            self._riff_start = end
            f.write(b"RIFF\0\0\0\0AVIX")
            self._write_hdrl()
            self._open_movi()

    def write(self, frame: bytes):
        """Append one JPEG frame."""
        frame = bytes(frame)
        if frame[:2] != b"\xff\xd8":
            raise ValueError("a Motion-JPEG frame is a JPEG stream (SOI first)")
        size = len(frame)
        padded = 8 + size + (size & 1)
        # what closing this segment adds: its ix00 and idx1 with this frame's entries
        closing = 32 + 8 + 24 * (len(self._movi_frames) + 1)
        if self._movi_frames and self._f.tell() + padded + closing - self._riff_start > self._limit:
            self._close_segment(last=False)
        pos = self._f.tell()
        self._f.write(b"00dc" + struct.pack("<I", size) + frame + (b"\0" if size & 1 else b""))
        self._movi_frames.append((pos + 8, size))
        self._frames += 1
        self._max_chunk = max(self._max_chunk, size)

    def close(self):
        if self._f.closed:
            return
        f = self._f
        self._close_segment(last=True)
        end = f.tell()
        first = self._segments[0][2]
        w, h = self.width, self.height
        fields = {
            "avih": struct.pack("<10I", round(1e6 * self.scale / self.rate),
                                int(self._max_chunk * self.rate / self.scale), 0,
                                _AVIF_HASINDEX | _AVIF_ISINTERLEAVED | _AVIF_TRUSTCKTYPE, first, 0, 1,
                                self._max_chunk, w, h) + bytes(16),
            "strh": struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", self.fourcc, 0, 0, 0, 0, self.scale, self.rate, 0,
                                self._frames, self._max_chunk, -1, 0, 0, 0, w, h),
            "indx": struct.pack("<HBBI4s12x", 4, 0, 0, len(self._segments), b"00dc")
            + b"".join(struct.pack("<QII", pos, size, n) for pos, size, n in self._segments),
            "dmlh": struct.pack("<I", self._frames),
        }
        for hdrl in self._hdrls:
            for name, value in fields.items():
                f.seek(hdrl + self._at[name])
                f.write(value)
        f.seek(end)
        f.close()

    @property
    def frames(self) -> int:
        return self._frames

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _rational(fps: float) -> Tuple[int, int]:
    """(rate, scale) with rate / scale = fps: integers as they are, else
    over 1000 (29.97 -> 29970 / 1000)."""
    if float(fps).is_integer():
        return int(fps), 1
    return round(fps * 1000), 1000


# ------------------------------------------------------------------ open


def open_video(path) -> Union[AviReader, mp4.Mp4Reader]:
    """A video file's frames: an AVI opens as :class:`AviReader`, an MP4 as
    ``mp4.Mp4Reader`` (an ``mp4v`` or H.264 track; every other codec raises
    with its name); anything else raises. Both readers' ``stream.codec``
    says "mjpeg", "mpeg4" or "h264"."""
    path = str(path)
    with open(path, "rb") as f:
        head = f.read(12)
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return AviReader(path)
    if head[4:8] in (b"ftyp", b"moov", b"mdat", b"free", b"wide"):
        return mp4.Mp4Reader(path)
    raise VideoError(f"{path}: not a video file the port reads (Motion-JPEG, MPEG-4 Part 2 or H.264 AVI, mp4v or "
                     "H.264 MP4)")
