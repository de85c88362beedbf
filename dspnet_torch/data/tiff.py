"""TIFF without cv2: libtiff 4.7.1 as cv2 5.0.0's ``grfmt_tiff.cpp`` drives
it, pixel for pixel (measured in ``tests/test_torch_image_formats.py``).

The file: classic TIFF (``II*\\0`` / ``MM\\0*``) and BigTIFF, the first IFD
only, turned by its Orientation tag under every flag as cv2 turns it;
strips or tiles, chunky or planar; compression none, LZW (and the
old-style LSB-first LZW libtiff still reads), Deflate (8 and 32946, through
``zlib``), PackBits, JPEG (7: ``JPEGTables`` and each strip or tile make a
stream for ``data/jpeg.py``, which is counted apart from JPEG files) and
CCITT RLE, Group 3 and Group 4 (``data/ccitt.py``); predictor 2 at 8, 16
and 32 bits and predictor 3 (floating point). Compressions this libtiff
build has no codec for (old-style JPEG, JBIG, ZSTD, WebP, LZMA and the
rest) raise by name, as cv2 returns None for them; so do cv2's 8-bit
reads of uncompressed tiles whose size is not a multiple of 1024 bytes
(libtiff 4.7.1's RGBA tile reader, measured over 384 geometries).

What cv2 makes of the samples depends on the flag, as ``TiffDecoder``
decides:

* ``IMREAD_UNCHANGED`` of 16-bit samples, of 32-bit integers and of floats
  gives the samples themselves (RGB returned BGR, RGBA BGRA);
* every 8-bit read (``IMREAD_COLOR``, ``IMREAD_GRAYSCALE``, and
  ``IMREAD_UNCHANGED`` of samples of 8 bits or fewer) goes through
  libtiff's ``TIFFReadRGBAStrip`` / ``TIFFReadRGBATile``, emulated in
  :func:`_rgba`: gray through libtiff's bitmap tables (min-is-white
  inverted, 16 bits by the high byte, fewer than 8 scaled to 0..255);
  RGB 16 bits by ``(v + 128) // 257``; unassociated alpha premultiplied by
  ``(v * a + 127) // 255``; palettes through the colour map (a 16-bit map
  by its high byte); CMYK by ``(255 - k) * (255 - c) // 255``; YCbCr by
  libtiff's ``TIFFYCbCrtoRGB`` tables, JPEG-coded YCbCr by libjpeg;
  except a single strip of 8-bit min-is-black gray or RGB (with associated
  alpha or no ExtraSamples tag if four samples), which cv2 reads by
  scanline and keeps as stored. cv2 refuses (None) what
  ``TIFFRGBAImageOK`` refuses, 32-bit and float samples among them;
* gray from colour is cv2's float32 ``BGRA2Gray`` rule
  (``data/cvt_color.py``).

Write: LZW with horizontal prediction for integer samples and no
compression for floats, cv2's strips of about 8 KiB and its sample formats,
BGR stored RGB, and, as cv2 writes BGRA, no ExtraSamples tag (so cv2 keeps
the fourth sample as it is); cv2 reads it back to the same array (not
libtiff's bytes).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from dspnet_torch.data import ccitt, cvt_color, jpeg

MAGICS = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")

# tags
WIDTH, HEIGHT, BPS, COMPRESSION, PHOTOMETRIC, FILLORDER = 256, 257, 258, 259, 262, 266
STRIP_OFFSETS, ORIENTATION, SPP, ROWS_PER_STRIP, STRIP_BYTES = 273, 274, 277, 278, 279
PLANAR, T4OPTIONS, T6OPTIONS, PREDICTOR, COLORMAP = 284, 292, 293, 317, 320
TILE_W, TILE_H, TILE_OFFSETS, TILE_BYTES = 322, 323, 324, 325
INKSET, EXTRA, SAMPLE_FORMAT, JPEG_TABLES = 332, 338, 339, 347
YCBCR_COEF, YCBCR_SUB, REF_BW = 529, 530, 532

#: compressions this libtiff build has no codec for -> their names
REFUSED = {6: "old-style JPEG (6)", 9: "JBIG (9)", 10: "JBIG (10)", 32766: "NeXT", 32771: "CCITT RLEW",
           32809: "ThunderScan", 32895: "IT8CTPAD", 32896: "IT8LW", 32897: "IT8MP", 32898: "IT8BL",
           32908: "PixarFilm", 32909: "PixarLog", 32947: "DCS", 34661: "JBIG",
           34676: "SGILog", 34677: "SGILog24", 34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA",
           50000: "ZSTD", 50001: "WebP", 50002: "JPEG XL"}
NAMES = {1: "none", 2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4", 5: "LZW", 7: "JPEG",
         8: "Deflate", 32946: "Deflate (old code)", 32773: "PackBits"}

_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 8), 6: ("b", 1), 7: ("B", 1),
          8: ("h", 2), 9: ("i", 4), 10: ("i", 8), 11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8),
          17: ("q", 8), 18: ("Q", 8)}


class TiffError(ValueError):
    pass


# ------------------------------------------------------------------ IFD


def read_ifd(data: bytes):
    """The first IFD -> ({tag: tuple of values}, byte order "<" or ">")."""
    if data[:4] not in MAGICS or len(data) < 8:
        raise TiffError("not a TIFF file")
    e = "<" if data[:2] == b"II" else ">"
    big = data[2:4] in (b"+\x00", b"\x00+")
    if big:
        (off,) = struct.unpack_from(e + "Q", data, 8)
        (n,) = struct.unpack_from(e + "Q", data, off)
        pos, esize, vsize = off + 8, 20, 8
    else:
        (off,) = struct.unpack_from(e + "I", data, 4)
        if off + 2 > len(data):
            raise TiffError("TIFF IFD offset past the end")
        (n,) = struct.unpack_from(e + "H", data, off)
        pos, esize, vsize = off + 2, 12, 4
    fields = {}
    for i in range(n):
        p = pos + i * esize
        if big:
            tag, typ, cnt = struct.unpack_from(e + "HHQ", data, p)
        else:
            tag, typ, cnt = struct.unpack_from(e + "HHI", data, p)
        if typ not in _TYPES:
            continue
        fmt, size = _TYPES[typ]
        total = size * cnt
        vp = p + esize - vsize
        if total > vsize:
            (vp,) = struct.unpack_from(e + ("Q" if big else "I"), data, vp)
        raw = data[vp:vp + total]
        if len(raw) < total:
            raise TiffError(f"TIFF tag {tag} runs past the end of the file")
        if typ in (5, 10):
            nums = struct.unpack(e + fmt * (2 * cnt), raw)
            vals = tuple(np.float32(np.float32(a) / np.float32(b)) if b else np.float32(0)
                         for a, b in zip(nums[0::2], nums[1::2]))
        elif typ == 2:
            vals = (raw,)
        else:
            vals = struct.unpack(e + fmt * cnt, raw)
        fields[tag] = vals
    return fields, e


def _get(f, tag, default=None):
    v = f.get(tag)
    return default if v is None else v[0]


# ------------------------------------------------------------------ codecs


def lzw_decode(data: bytes, size: int) -> bytes:
    """TIFF LZW (MSB first, early change) or, when the stream starts as old
    libtiff wrote it (``00``, then an odd byte), the LSB-first form."""
    if len(data) >= 2 and data[0] == 0 and data[1] & 1:
        return _lzw(data, size, msb=False)
    return _lzw(data, size, msb=True)


def _lzw(data: bytes, size: int, msb: bool) -> bytes:
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    n = len(data) * 8
    buf = bytes(data) + b"\0\0\0"
    order = "big" if msb else "little"
    pos, width, prev = 0, 9, None
    early = 1 if msb else 0
    mask = (1 << width) - 1
    while pos + width <= n and len(out) < size:
        window = int.from_bytes(buf[pos >> 3:(pos >> 3) + 3], order)
        code = (window >> (24 - (pos & 7) - width) if msb else window >> (pos & 7)) & mask
        pos += width
        if code == 256:
            table = table[:258]
            width, prev = 9, None
            mask = (1 << width) - 1
            continue
        if code == 257:
            break
        if prev is None:
            if code > 255:
                raise TiffError(f"TIFF LZW code {code} after a clear code")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise TiffError(f"TIFF LZW code {code} past the table ({len(table)})")
        out += entry
        prev = entry
        if len(table) + early >= (1 << width) and width < 12:
            width += 1
            mask = (1 << width) - 1
    return bytes(out[:size])


def packbits_decode(data: bytes, size: int) -> bytes:
    out, pos, n = bytearray(), 0, len(data)
    while pos < n and len(out) < size:
        c = data[pos]
        pos += 1
        if c < 128:
            out += data[pos:pos + c + 1]
            pos += c + 1
        elif c > 128:
            if pos < n:
                out += bytes([data[pos]]) * (257 - c)
            pos += 1
    return bytes(out[:size])


# ------------------------------------------------------------------ samples


class _Image:
    """The fields the decoder uses."""

    def __init__(self, f: dict, e: str):
        self.f, self.e = f, e
        self.w, self.h = _get(f, WIDTH, 0), _get(f, HEIGHT, 0)
        if self.w <= 0 or self.h <= 0:
            raise TiffError(f"TIFF size {self.w}x{self.h}")
        self.bps = _get(f, BPS, 1)
        self.spp = _get(f, SPP, 1)
        self.compression = _get(f, COMPRESSION, 1)
        self.photometric = _get(f, PHOTOMETRIC)
        self.planar = _get(f, PLANAR, 1)
        self.predictor = _get(f, PREDICTOR, 1)
        self.sample_format = _get(f, SAMPLE_FORMAT, 1)
        self.extra = f.get(EXTRA, ())
        self.orientation = _get(f, ORIENTATION, 1)
        self.tiled = TILE_OFFSETS in f
        if self.tiled:
            self.cw, self.ch = _get(f, TILE_W), _get(f, TILE_H)
            self.offsets, self.counts = f[TILE_OFFSETS], f.get(TILE_BYTES, ())
        else:
            self.cw = self.w
            rps = _get(f, ROWS_PER_STRIP, self.h)
            self.ch = self.h if rps == 0 or rps > self.h else rps
            if STRIP_OFFSETS not in f:
                raise TiffError("TIFF without strip offsets")
            self.offsets, self.counts = f[STRIP_OFFSETS], f.get(STRIP_BYTES, ())
        if len(set(f.get(BPS, (self.bps,)))) != 1:
            raise TiffError(f"TIFF with unequal bits per sample {f.get(BPS)}")


def _dtype(img: _Image):
    bps, fmt = img.bps, img.sample_format
    if fmt == 3:
        return {16: np.float16, 32: np.float32, 64: np.float64}.get(bps)
    if fmt == 2:
        return {8: np.int8, 16: np.int16, 32: np.int32, 64: np.int64}.get(bps)
    return {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}.get(bps)


def _decompress(data: bytes, img: _Image, k: int, size: int) -> bytes:
    """Strip or tile ``k`` decompressed (any codec but JPEG and CCITT) to
    ``size`` bytes; libtiff zero-fills a short one."""
    off = img.offsets[k]
    cnt = img.counts[k] if k < len(img.counts) else len(data) - off
    raw = data[off:off + cnt]
    c = img.compression
    if c == 1:
        out = raw
    elif c == 5:
        out = lzw_decode(raw, size)
    elif c in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, size)
        except zlib.error as e:
            raise TiffError(f"TIFF Deflate data: {e}") from None
    elif c == 32773:
        out = packbits_decode(raw, size)
    else:
        raise TiffError(f"TIFF compression {c}")
    return out.ljust(size, b"\0")[:size]


def _chunk_bytes(data: bytes, img: _Image, k: int, rows: int, cols: int, nsamp: int) -> bytes:
    """Strip or tile ``k`` decompressed (not JPEG): rows x cols pixels of
    ``nsamp`` samples each, rows padded to whole bytes."""
    row_bytes = (cols * nsamp * img.bps + 7) // 8
    if img.compression in (2, 3, 4):
        off = img.offsets[k]
        cnt = img.counts[k] if k < len(img.counts) else len(data) - off
        c = img.compression
        bits = ccitt.decode(data[off:off + cnt], cols, rows, c, _get(img.f, T4OPTIONS if c == 3 else T6OPTIONS, 0),
                            reverse=_get(img.f, FILLORDER, 1) == 2)
        return np.packbits(bits, axis=1).tobytes()
    return _decompress(data, img, k, row_bytes * rows)


def _undo_predictor(rows: np.ndarray, img: _Image) -> np.ndarray:
    """(rows, cols, nsamp) samples, native values -> predictor undone."""
    if img.predictor == 1:
        return rows
    if img.predictor == 2:
        if img.bps not in (8, 16, 32) or rows.dtype.kind == "f":
            raise TiffError(f"TIFF horizontal predictor at {img.bps} bits: libtiff refuses it")
        u = rows.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[rows.dtype.itemsize])
        return np.cumsum(u, axis=1, dtype=u.dtype).view(rows.dtype)
    raise TiffError(f"TIFF predictor {img.predictor}")


def _float_predictor(raw: bytes, rows: int, cols: int, nsamp: int, bps: int, dtype) -> np.ndarray:
    """Predictor 3: per row, bytes summed with stride ``nsamp``, then the
    byte planes (most significant first) interleaved."""
    nb = bps // 8
    b = np.frombuffer(raw, np.uint8)[:rows * cols * nsamp * nb].reshape(rows, -1)
    acc = np.cumsum(b.reshape(rows, -1, nsamp), axis=1, dtype=np.uint8).reshape(rows, -1)
    planes = acc.reshape(rows, nb, cols * nsamp).transpose(0, 2, 1)
    return np.ascontiguousarray(planes).view(np.dtype(dtype).newbyteorder(">")).astype(dtype).reshape(
        rows, cols, nsamp)


def _to_samples(raw: bytes, img: _Image, rows: int, cols: int, nsamp: int) -> np.ndarray:
    """Decompressed chunk -> (rows, cols, nsamp): uint8 for 8 bits or
    fewer (unpacked, not scaled), else the dtype of the sample format."""
    bps = img.bps
    if img.predictor == 3:
        if _dtype(img) is None or np.dtype(_dtype(img)).kind != "f":
            raise TiffError("TIFF floating-point predictor on integer samples")
        return _float_predictor(raw, rows, cols, nsamp, bps, _dtype(img))
    if bps < 8 or bps in (10, 12, 14):
        row_bytes = (cols * nsamp * bps + 7) // 8
        b = np.frombuffer(raw, np.uint8)[:rows * row_bytes].reshape(rows, row_bytes)
        if bps < 8:
            out = cvt_color.unpack_bits(b, cols * nsamp, bps)
        else:  # cv2 unpacks 10-, 12- and 14-bit samples to the top bits of 16
            bitsarr = np.unpackbits(b, axis=1)[:, :cols * nsamp * bps].reshape(rows, -1, bps)
            out = (bitsarr.astype(np.uint16) << np.arange(15, 15 - bps, -1, dtype=np.uint16)).sum(-1, dtype=np.uint16)
        return _undo_predictor(out.reshape(rows, cols, nsamp), img)
    dt = _dtype(img)
    if dt is None:
        raise TiffError(f"TIFF with {bps}-bit samples of format {img.sample_format}")
    a = np.frombuffer(raw, np.dtype(dt).newbyteorder(img.e), rows * cols * nsamp).astype(dt)
    return _undo_predictor(a.reshape(rows, cols, nsamp), img)


def _jpeg_chunk(data: bytes, img: _Image, k: int):
    """A JPEG-coded strip or tile -> (its component planes upsampled, the
    JPEG colour space libtiff asks libjpeg for: "rgb" or None for none)."""
    off = img.offsets[k]
    cnt = img.counts[k] if k < len(img.counts) else len(data) - off
    raw = data[off:off + cnt]
    tables = img.f.get(JPEG_TABLES)
    if tables:
        t = tables[0] if isinstance(tables[0], bytes) else bytes(tables)
        raw = t[:-2] + raw[2:]  # the tables' SOI..(no EOI) + the chunk after its SOI
    planes, info = jpeg.stream_planes(raw)
    jpeg.check_sampling(info)
    full = [jpeg._upsample(p, *fac)[:info.height, :info.width] for p, fac in zip(planes, info.upsampling)]
    return full, info


def samples(data: bytes, img: _Image):
    """The whole image's samples: (H, W, spp) as :func:`_to_samples` makes
    them, or, for JPEG, ("jpeg", (H, W, 3|1) uint8 RGB / gray)."""
    c = img.compression
    if c in REFUSED or c not in NAMES:
        raise TiffError(f"TIFF compression {REFUSED.get(c, c)}: this libtiff build (cv2 5.0.0's) does not "
                        "decode it, and cv2 returns None")
    if c in (2, 3, 4) and img.bps != 1:
        raise TiffError(f"TIFF {NAMES[c]} on {img.bps}-bit samples: CCITT codes 1-bit images only, and cv2 "
                        "returns None")
    nplanes = img.spp if img.planar == 2 else 1
    nsamp = 1 if img.planar == 2 else img.spp
    across = -(-img.w // img.cw)
    down = -(-img.h // img.ch)
    per_plane = across * down
    if len(img.offsets) < per_plane * nplanes:
        raise TiffError(f"TIFF has {len(img.offsets)} strips / tiles, {per_plane * nplanes} expected")
    planes = []
    for p in range(nplanes):
        full = None
        for t in range(per_plane):
            ty, tx = divmod(t, across)
            y0, x0 = ty * img.ch, tx * img.cw
            rows = img.ch if img.tiled else min(img.ch, img.h - y0)
            k = p * per_plane + t
            if c == 7:
                chunk, info = _jpeg_chunk(data, img, k)
                chunk = np.stack(chunk, -1)
            else:
                chunk = _to_samples(_chunk_bytes(data, img, k, rows, img.cw, nsamp), img, rows, img.cw, nsamp)
            if full is None:
                full = np.zeros((down * img.ch, across * img.cw, chunk.shape[2]), chunk.dtype)
            hh, ww = min(rows, chunk.shape[0]), min(img.cw, chunk.shape[1])
            full[y0:y0 + hh, x0:x0 + ww] = chunk[:hh, :ww]
        planes.append(full[:img.h, :img.w])
    out = np.concatenate(planes, axis=2) if nplanes > 1 else planes[0]
    return out


# ------------------------------------------------------------------ libtiff RGBA


def _photometric(img: _Image) -> int:
    if img.photometric is not None:
        return img.photometric
    return 1 if img.spp - len(img.extra) <= 1 else 2  # libtiff's guess: min-is-black or RGB


def _alpha(img: _Image) -> int:
    """libtiff's ``img->alpha``: 1 associated, 2 unassociated, 0 none."""
    if not img.extra:
        return 0
    if img.extra[0] == 0:
        return 1 if img.spp > 3 else 0
    return img.extra[0] if img.extra[0] in (1, 2) else 0


def rgba_refusal(img: _Image):
    """What ``TIFFRGBAImageOK`` says of the image, or None when it is OK."""
    bps, spp = img.bps, img.spp
    if bps not in (1, 2, 4, 8, 16):
        return f"libtiff's RGBA reader takes 1, 2, 4, 8 and 16-bit samples, not {bps}"
    if img.sample_format == 3:
        return "libtiff's RGBA reader takes no floating-point samples"
    ph = _photometric(img)
    colorchannels = spp - len(img.extra)
    if ph in (0, 1):
        if img.planar == 1 and spp != 1 and bps < 8:
            return f"libtiff's RGBA reader takes no chunky {bps}-bit gray with {spp} samples"
    elif ph == 3:
        if img.planar == 1 and spp != 1 and bps < 8:
            return "libtiff's RGBA reader takes no chunky palette image with extra samples below 8 bits"
        if bps > 8:
            return f"libtiff's RGBA reader takes no {bps}-bit palette image"
    elif ph == 5:
        if _get(img.f, INKSET, 1) != 1:
            return "libtiff's RGBA reader takes CMYK ink sets only"
        if spp < 4:
            return f"libtiff's RGBA reader takes separated images of 4 samples or more, not {spp}"
        if bps != 8:
            return f"libtiff's RGBA reader takes 8-bit CMYK only, not {bps}"
    elif ph == 6:
        if img.planar != 1:
            return "libtiff's RGBA reader takes chunky YCbCr only"
        if bps != 8:
            return "libtiff's RGBA reader takes 8-bit YCbCr only"
    elif ph == 2:
        if colorchannels < 3:
            return f"libtiff's RGBA reader takes RGB with 3 colour channels, not {colorchannels}"
    else:
        return f"libtiff's RGBA reader takes no photometric interpretation {ph}"
    return None


def _gray_map(img: _Image) -> np.ndarray:
    """libtiff's ``setupMap``: stored value -> 0..255 (16 bits by the high
    byte), min-is-white inverted."""
    bps = img.bps
    rng = 255 if bps in (8, 16) else (1 << bps) - 1
    x = np.arange(rng + 1)
    m = ((rng - x) * 255 // rng) if _photometric(img) == 0 else (x * 255 // rng)
    return m.astype(np.uint8)


def _colormap(img: _Image) -> np.ndarray:
    """(2**bps, 3) RGB uint8: a 16-bit map by its high byte; an 8-bit one
    (no entry past 255), as libtiff's ``checkcmap`` assumes, as it is."""
    cm = np.array(img.f[COLORMAP], np.int64)
    n = 1 << img.bps
    if len(cm) < 3 * n:
        raise TiffError(f"TIFF colour map of {len(cm)} entries, {3 * n} expected")
    cm = cm[:3 * n].reshape(3, n).T
    if (cm >= 256).any():
        cm = cm >> 8
    return cm.astype(np.uint8)


_LUT16 = ((np.arange(65536) + 128) // 257).astype(np.uint8)
_UA = ((np.arange(256)[:, None] * np.arange(256)[None, :] + 127) // 255).astype(np.uint8)  # [a, v]


def _ycbcr_tables(img: _Image):
    """libtiff's ``TIFFYCbCrToRGBInit`` tables over 0..255, float32 where
    libtiff computes in float."""
    f32 = np.float32
    luma = img.f.get(YCBCR_COEF, (f32(0.299), f32(0.587), f32(0.114)))
    lr, lg, lb = (f32(v) for v in luma)
    ref = img.f.get(REF_BW, (f32(0), f32(255), f32(128), f32(255), f32(128), f32(255)))
    ref = [f32(v) for v in ref]

    def fix(x):
        return np.int32(np.trunc(f32(x) * f32(65536) + f32(0.5)))

    f1 = f32(2) - f32(2) * lr
    d1 = fix(np.clip(f1, 0, 2))
    f2 = lr * f1 / lg
    d2 = -fix(np.clip(f2, 0, 2))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(np.clip(f3, 0, 2))
    f4 = lb * f3 / lg
    d4 = -fix(np.clip(f4, 0, 2))
    x = np.arange(-128, 128).astype(f32)

    def code2v(c, rb, rw, cr):
        den = (rw - rb) if (rw - rb) != 0 else f32(1)
        return ((c - rb) * f32(cr)) / den

    cr = np.clip(code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127), -128 * 32, 128 * 32).astype(np.int64)
    cb = np.clip(code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127), -128 * 32, 128 * 32).astype(np.int64)
    ytab = np.clip(code2v(x + f32(128), ref[0], ref[1], 255), -128 * 32, 128 * 32).astype(np.int64)
    cr_r = (int(d1) * cr + (1 << 15)) >> 16
    cb_b = (int(d3) * cb + (1 << 15)) >> 16
    cr_g = int(d2) * cr
    cb_g = int(d4) * cb + (1 << 15)
    return ytab, cr_r, cb_b, cr_g, cb_g


def _ycbcr_to_rgb(y, cb, cr, tables):
    ytab, cr_r, cb_b, cr_g, cb_g = tables
    yv = ytab[y]
    r = yv + cr_r[cr]
    g = yv + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yv + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _raw_ycbcr(data: bytes, img: _Image) -> np.ndarray:
    """YCbCr with its subsampling (not JPEG-coded), as libtiff's
    ``putcontig8bitYCbCr*tile`` read it: each block of h x v luma samples
    then Cb and Cr, the chroma repeated over the block; a strip holds its
    rows, a tile its whole width and height, cut at the image's edge. In a
    4x4 tile cut at the right edge libtiff skips the blocks it does not
    show at 10 bytes a block, not 18 (``fromskew / 4 * (4 * 2 + 2)`` in
    ``putcontig8bitYCbCr44tile``), and so reads each later row of blocks
    from there (measured against cv2 5.0.0)."""
    sh, sv = img.f.get(YCBCR_SUB, (2, 2))[:2]
    if (sh, sv) not in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)):  # libtiff's put routines
        raise TiffError(f"TIFF YCbCr subsampling {sh}x{sv}: libtiff's RGBA reader has no routine for it, "
                        "and cv2 returns None")
    tables = _ycbcr_tables(img)
    out = np.zeros((img.h, img.w, 3), np.uint8)
    unit = sh * sv + 2
    across = -(-img.w // img.cw) if img.tiled else 1
    for k in range(-(-img.h // img.ch) * across):
        y0, x0 = k // across * img.ch, k % across * img.cw
        cols = img.cw if img.tiled else img.w
        rows = img.ch if img.tiled else min(img.ch, img.h - y0)
        nbh, bw = -(-rows // sv), -(-cols // sh)
        size = nbh * bw * unit
        raw = np.frombuffer(_decompress(data, img, k, size), np.uint8)
        h, w = min(rows, img.h - y0), min(cols, img.w - x0)
        if img.tiled and (sh, sv) == (4, 4) and w < cols:
            used = -(-w // 4)
            stride = used * unit + (cols - w) // 4 * 10
            starts = np.arange(nbh)[:, None] * stride + np.arange(bw)[None, :] * unit
            starts = np.where(np.arange(bw)[None, :] < used, starts, 0)
            blocks = raw[np.minimum(starts[..., None] + np.arange(unit), size - 1)]
        else:
            blocks = raw[:size].reshape(nbh, bw, unit)
        ys = blocks[..., :sh * sv].reshape(nbh, bw, sv, sh).transpose(0, 2, 1, 3).reshape(nbh * sv, bw * sh)
        cb = np.repeat(np.repeat(blocks[..., -2], sv, 0), sh, 1)
        cr = np.repeat(np.repeat(blocks[..., -1], sv, 0), sh, 1)
        rgb = _ycbcr_to_rgb(ys, cb, cr, tables)
        out[y0:y0 + h, x0:x0 + w] = rgb[:h, :w]
    return out


def _bw16_high_bytes(data: bytes, img: _Image, s: np.ndarray) -> np.ndarray:
    """The high byte of each 16-bit gray sample as libtiff's
    ``put16bitbwtile`` reads it. In a chunky tile cut at the right edge it
    steps from row to row by the cut-off pixels counted as bytes
    (``pp += fromskew``, not scaled by the 2 * samples bytes of a pixel), so
    each row after the first is read from a shifted offset, a byte pair that
    may straddle two samples (measured against cv2 5.0.0: the same array on
    every run and whatever bytes follow the image)."""
    g = (s[..., 0] >> 8).astype(np.uint8)
    if not img.tiled or img.planar != 1 or img.w % img.cw == 0:
        return g
    spp, tw, th = img.spp, img.cw, img.ch
    x0 = (img.w // tw) * tw
    npix = img.w - x0
    stride = npix * 2 * spp + (tw - npix)
    across = -(-img.w // tw)
    for ty in range(-(-img.h // th)):
        raw = np.frombuffer(_chunk_bytes(data, img, ty * across + across - 1, th, tw, spp), np.uint8)
        if img.e == ">":  # libtiff swabs 16-bit samples to the host's (little-endian) order
            raw = raw.reshape(-1, 2)[:, ::-1].reshape(-1)
        rows = min(th, img.h - ty * th)
        at = np.arange(rows)[:, None] * stride + np.arange(npix)[None, :] * 2 * spp + 1
        g[ty * th:ty * th + rows, x0:] = raw[np.minimum(at, len(raw) - 1)]
    return g


def _rgba(data: bytes, img: _Image) -> np.ndarray:
    """(H, W, 4) RGBA as ``TIFFReadRGBAStrip`` / ``Tile`` produce it (top
    row first)."""
    why = rgba_refusal(img)
    if why:
        raise TiffError(f"{why}: cv2 returns None")
    ph = _photometric(img)
    if ph == 6 and img.compression != 7:
        rgb = _raw_ycbcr(data, img)
        return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)
    s = samples(data, img)
    h, w = img.h, img.w
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if img.compression == 7:
        # libjpeg's output: RGB (YCbCr converted), or the raw components
        if s.shape[2] == 1:
            out[..., :3] = _gray_map(img)[s[..., 0]][..., None] if ph in (0, 1) else s
        else:
            out[..., :3] = s[..., :3]
        return out
    alpha = _alpha(img)
    if ph in (0, 1):
        if img.planar == 2 and ph == 0:  # libtiff's separate path reads gray unmapped
            g = s[..., 0] if img.bps == 8 else _LUT16[s[..., 0]]
        elif img.bps == 16 and img.planar == 2:  # and maps 16 bits through Bitdepth16To8
            g = _gray_map(img)[_LUT16[s[..., 0]]]
        elif img.bps == 16:
            g = _gray_map(img)[_bw16_high_bytes(data, img, s)]
        else:
            g = _gray_map(img)[s[..., 0]]
        out[..., :3] = g[..., None]
        if img.bps == 8 and alpha and img.spp == 2 and img.planar == 1:
            out[..., 3] = s[..., 1]
        elif img.planar == 2 and img.spp >= 2 and alpha:
            a = s[..., 1] if img.bps == 8 else _LUT16[s[..., 1]]
            out[..., 3] = a
            if alpha == 2:
                out[..., :3] = _UA[a[..., None], out[..., :3]]
        return out
    if ph == 3:
        out[..., :3] = _colormap(img)[s[..., 0]]
        return out
    if ph == 5:
        px = s.astype(np.int64)
        k = 255 - px[..., 3]
        for i in range(3):
            out[..., i] = (k * (255 - px[..., i])) // 255
        return out
    # RGB
    px = s if img.bps == 8 else _LUT16[s]
    out[..., :3] = px[..., :3]
    if alpha and img.spp >= 4:
        a = px[..., 3]
        out[..., 3] = a
        if alpha == 2:
            out[..., :3] = _UA[a[..., None], px[..., :3]]
    return out


# ------------------------------------------------------------------ cv2's reader


def _cv2_type(img: _Image):
    """(numpy dtype, channels) of cv2's ``TiffDecoder::readHeader``."""
    bps, fmt, ph = img.bps, img.sample_format, _photometric(img)
    ncn = img.spp
    if ncn > 4:
        raise TiffError(f"TIFF with {ncn} samples a pixel: cv2 takes 1 to 4")
    if bps == 1:
        if fmt not in (1, 2):
            raise TiffError("1-bit TIFF of a float format")
        return np.uint8, 3 if ph == 3 else 1
    if bps in (2, 4) and ph == 3:
        return np.uint8, 3
    if bps == 8:
        if fmt not in (1, 2):
            raise TiffError("8-bit TIFF of a float format: cv2 returns None")
        return (np.int8 if fmt == 2 else np.uint8), 3 if ph == 3 else (1 if ncn == 2 else ncn)
    if bps in (10, 12, 14, 16):
        if fmt not in (1, 2):
            raise TiffError(f"{bps}-bit float TIFF: cv2 returns None")
        if bps == 16 and ncn == 2 and fmt == 1:  # gray + alpha: 8-bit gray through the RGBA reader (measured)
            return np.uint8, 1
        return (np.int16 if fmt == 2 else np.uint16), ncn
    if bps == 32:
        if fmt not in (2, 3):
            raise TiffError("32-bit unsigned TIFF: cv2 takes signed or float 32-bit samples, and returns None")
        return (np.float32 if fmt == 3 else np.int32), ncn
    if bps == 64:
        if fmt != 3:
            raise TiffError("64-bit integer TIFF: cv2 returns None")
        return np.float64, ncn
    raise TiffError(f"{bps}-bit TIFF: cv2 takes 1, 8, 10, 12, 14, 16, 32 and 64 bits (2 and 4 for a palette "
                    "only), and returns None")


def _scanline_route(img: _Image) -> bool:
    """cv2's ``doReadScanline``: one strip of 8-bit min-is-black gray or
    RGB, chunky (16-bit strips read as libtiff's RGBA reader reads them);
    four samples only with associated alpha or with no ExtraSamples tag
    at all (as cv2 writes BGRA)."""
    ncn = img.spp
    ok = (not img.tiled and ncn in (1, 3, 4) and img.bps == 8 and img.ch == img.h
          and _photometric(img) in (1, 2) and img.planar != 2)
    if ok and ncn == 4 and EXTRA in img.f:  # without the tag cv2 keeps the fourth sample as alpha
        ok = len(img.extra) == 1 and img.extra[0] == 1
    return ok


def _bgra_out(rgba: np.ndarray, channels: int) -> np.ndarray:
    if channels == 4:
        return np.ascontiguousarray(rgba[..., [2, 1, 0, 3]])
    if channels == 3:
        return np.ascontiguousarray(rgba[..., [2, 1, 0]])
    if channels == 1:
        return cvt_color.bgr_to_gray(rgba, rgb=True)
    raise TiffError(f"cv2 reads no {channels}-channel 8-bit TIFF (BGR and BGRA only): it returns None")


def decode(data: bytes, flags: int) -> np.ndarray:
    """TIFF bytes -> cv2.imdecode's array under ``flags``, turned by the
    Orientation tag (2-8) as cv2 turns it under every flag."""
    img = _Image(*read_ifd(data))
    if img.orientation not in range(1, 9):
        raise TiffError(f"TIFF orientation {img.orientation}")
    return np.ascontiguousarray(jpeg.orient(_decode(data, img, flags), img.orientation))


def _decode(data: bytes, img: _Image, flags: int) -> np.ndarray:
    """The image as stored (top row first), under ``flags``."""
    dtype, channels = _cv2_type(img)
    if flags != -1:
        dtype, channels = np.uint8, 3 if flags == 1 else 1
    nbits = np.dtype(dtype).itemsize * 8
    if nbits == 8:
        if rgba_refusal(img):
            raise TiffError(rgba_refusal(img) + ": cv2 returns None")
        tile_bytes = img.ch * ((img.cw * (1 if img.planar == 2 else img.spp) * img.bps + 7) // 8)
        if _photometric(img) == 6 and img.compression != 7:  # subsampled YCbCr: blocks of h x v + 2
            sh, sv = img.f.get(YCBCR_SUB, (2, 2))[:2]
            tile_bytes = -(-img.ch // sv) * -(-img.cw // sh) * (sh * sv + 2)
        if img.tiled and img.compression == 1 and tile_bytes % 1024:
            raise TiffError(f"uncompressed TIFF tiles of {tile_bytes} bytes: libtiff 4.7.1's RGBA tile reader takes "
                            "them only in multiples of 1024 bytes, and cv2 returns None")
        if _scanline_route(img):  # 8-bit samples kept as stored (alpha too)
            s = samples(data, img).astype(np.uint8)
            rgba = s if img.spp == 4 else np.full(s.shape[:2] + (4,), 255, np.uint8)
            if img.spp != 4:
                rgba[..., :3] = s
        else:
            rgba = _rgba(data, img)
        return _bgra_out(rgba, channels).view(dtype) if dtype == np.int8 else _bgra_out(rgba, channels)
    # 16, 32 and 64 bits: the samples themselves
    if img.photometric == 6 or img.compression == 7:
        raise TiffError("cv2 reads YCbCr / JPEG TIFF only through libtiff's RGBA reader (8 bits)")
    s = samples(data, img).astype(dtype)
    ncn = img.spp
    if ncn == 2:
        raise TiffError("cv2 reads no two-sample TIFF beyond 8 bits (it reads past each pixel)")
    if channels == 1:
        if ncn == 1:
            return np.ascontiguousarray(s[..., 0])
        return cvt_color.bgr_to_gray(s[..., :3], rgb=True)
    if ncn == 1:
        return cvt_color.gray_to_bgr(s[..., 0])
    if ncn == 3:
        return np.ascontiguousarray(s[..., ::-1])
    if ncn == 4:
        return np.ascontiguousarray(s[..., [2, 1, 0, 3]] if channels == 4 else s[..., [2, 1, 0]])
    raise TiffError(f"cv2 reads no {ncn}-sample TIFF at {nbits} bits")


# ------------------------------------------------------------------ write


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW as libtiff's ``LZWEncode`` writes it: a clear code first,
    codes 9 to 12 bits wide (each width one code before a reader's early
    change needs it), a clear code when the table is full, the end code
    last."""
    out, acc, nacc = bytearray(), 0, 0
    width = 9

    def emit(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    emit(256)
    table, nxt = {}, 258
    cur = -1
    for b in data:
        if cur < 0:
            cur = b
            continue
        key = (cur << 8) | b
        code = table.get(key)
        if code is not None:
            cur = code
            continue
        emit(cur)
        if nxt == 4094:  # the table is full: clear it
            emit(256)
            table.clear()
            nxt, width = 258, 9
        else:
            table[key] = nxt
            nxt += 1
            if nxt > (1 << width) - 1:
                width += 1
        cur = b
    if cur >= 0:
        emit(cur)
        nxt += 1
        if nxt == 4094:
            emit(256)
            width = 9
        elif nxt > (1 << width) - 1:
            width += 1
    emit(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def encode(img: np.ndarray) -> bytes:
    """(H, W[, C]) of uint8, int8, uint16, int16, int32, float32 or
    float64, C 1, 3 or 4 (BGR / BGRA) -> a little-endian TIFF cv2 reads
    back to the same array."""
    img = np.asarray(img)
    nch = 1 if img.ndim == 2 else img.shape[2]
    fmt = {np.dtype(np.uint8): 1, np.dtype(np.int8): 2, np.dtype(np.uint16): 1, np.dtype(np.int16): 2,
           np.dtype(np.int32): 2, np.dtype(np.float32): 3, np.dtype(np.float64): 3}.get(img.dtype)
    if fmt is None or nch not in (1, 3, 4) or img.ndim not in (2, 3):
        raise TiffError(f"TIFF is written from 1, 3 or 4 channels of 8-, 16-, 32-bit integers or floats, "
                        f"got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    px = img.reshape(h, w, nch)
    if nch >= 3:
        px = px[..., [2, 1, 0, 3][:nch]]
    px = np.ascontiguousarray(px).astype(img.dtype.newbyteorder("<"))
    bps = img.dtype.itemsize * 8
    row_bytes = w * nch * img.dtype.itemsize
    rps = max(1, min(h, 8192 // row_bytes))
    floats = fmt == 3
    strips = []
    for y in range(0, h, rps):
        block = px[y:y + rps]
        if floats:
            strips.append(block.tobytes())
            continue
        u = block.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[img.dtype.itemsize])
        diff = u.copy()
        diff[:, 1:] = u[:, 1:] - u[:, :-1]  # horizontal differencing, per sample
        strips.append(lzw_encode(diff.astype(diff.dtype.newbyteorder("<")).tobytes()))
    entries = [(WIDTH, 4, [w]), (HEIGHT, 4, [h]), (BPS, 3, [bps] * nch), (COMPRESSION, 3, [1 if floats else 5]),
               (PHOTOMETRIC, 3, [2 if nch >= 3 else 1]), (STRIP_OFFSETS, 4, [0] * len(strips)),
               (SPP, 3, [nch]), (ROWS_PER_STRIP, 4, [rps]), (STRIP_BYTES, 4, [len(s) for s in strips]),
               (PLANAR, 3, [1])]
    if not floats:
        entries.append((PREDICTOR, 3, [2]))
    entries.append((SAMPLE_FORMAT, 3, [fmt] * nch))
    entries.sort()
    # layout: header, strips, then the IFD and its out-of-line values
    body = bytearray(b"II*\x00\x00\x00\x00\x00")
    offsets = []
    for s in strips:
        offsets.append(len(body))
        body += s
        if len(body) & 1:
            body += b"\0"
    ifd_pos = len(body)
    n = len(entries)
    extra_pos = ifd_pos + 2 + 12 * n + 4
    ifd, extra = bytearray(struct.pack("<H", n)), bytearray()
    for tag, typ, vals in entries:
        if tag == STRIP_OFFSETS:
            vals = offsets
        fmt_c = "H" if typ == 3 else "I"
        raw = struct.pack("<" + fmt_c * len(vals), *vals)
        if len(raw) <= 4:
            ifd += struct.pack("<HHI", tag, typ, len(vals)) + raw.ljust(4, b"\0")
        else:
            ifd += struct.pack("<HHII", tag, typ, len(vals), extra_pos + len(extra))
            extra += raw
            if len(extra) & 1:
                extra += b"\0"
    ifd += b"\0\0\0\0"
    body[4:8] = struct.pack("<I", ifd_pos)
    return bytes(body + ifd + extra)
