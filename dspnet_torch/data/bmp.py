"""Windows BMP without cv2: the reader and writer of cv2 5.0.0's
``grfmt_bmp.cpp``, pixel for pixel.

Read: the OS/2 12-byte header and the 40-, 108- (V4) and 124-byte (V5)
Windows headers; 1, 4 and 8 bits a pixel through a palette (a palette whose
entries are all gray makes a one-channel image, as cv2's ``IsColorPalette``
decides), RLE8 and RLE4 with their end-of-line, end-of-bitmap and delta
escapes (skipped pixels take palette entry 0, as cv2 fills them; cv2's
RLE4 reads each escape as an end of row), 16 bits as
5-5-5 or, with BI_BITFIELDS masks, 5-6-5 (each field shifted up, its low
bits zero), 24 bits, and 32 bits (BGRA under ``IMREAD_UNCHANGED`` when the
file has BI_BITFIELDS, BGR otherwise); rows bottom-up, or top-down for a
negative height. Gray from colour is cvtColor's 14-bit rule, or from
32 bits with BI_BITFIELDS under a V4 or V5 header cv2's float32 rule (``data/cvt_color.py``;
measured over all 2**24 colours). An OS/2 file reads as
one channel under ``IMREAD_UNCHANGED`` whatever it holds, as cv2 types it.

Write: what ``cv2.imencode('.bmp')`` writes, byte for byte: a gray image at
8 bits with a 256-entry gray palette, BGR at 24 bits, BGRA at 32 bits under
a V5 header with BI_BITFIELDS masks and the sRGB colour space; rows
bottom-up, padded to 4 bytes with zeros."""

from __future__ import annotations

import struct

import numpy as np

from dspnet_torch.data import cvt_color

MAGIC = b"BM"
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


class BmpError(ValueError):
    pass


class _Header:
    pass


def read_header(data: bytes) -> _Header:
    """The fields cv2's ``BmpDecoder::readHeader`` keeps."""
    if data[:2] != MAGIC or len(data) < 26:
        raise BmpError("not a BMP file")
    h = _Header()
    h.offset, size = struct.unpack_from("<II", data, 10)
    h.palette, h.v4 = None, size >= 108
    pos = 14 + 4
    if size >= 36:
        h.width, height, planes_bpp, h.compression = struct.unpack_from("<iiIi", data, pos)
        h.bpp = planes_bpp >> 16
        (clrused,) = struct.unpack_from("<i", data, pos + 28)
        if not 0 <= h.compression <= BI_BITFIELDS:
            raise BmpError(f"BMP compression {h.compression} is not one cv2 reads")
        if h.bpp <= 8:
            if not 0 <= clrused <= 256:
                raise BmpError(f"BMP palette of {clrused} entries")
            n = clrused or (1 << h.bpp)
            start = 14 + size
            raw = np.frombuffer(data[start:start + 4 * n], np.uint8).reshape(-1, 4)
            h.palette = np.zeros((256, 3), np.uint8)
            h.palette[:len(raw)] = raw[:, :3]
        elif h.bpp == 16 and h.compression == BI_BITFIELDS:
            r, g, b = struct.unpack_from("<III", data, pos + 36)
            if (r, g, b) == (0x7C00, 0x3E0, 0x1F):
                h.bpp = 15
            elif (r, g, b) != (0xF800, 0x7E0, 0x1F):
                raise BmpError(f"BMP 16-bit masks {r:#x} {g:#x} {b:#x} are neither 5-5-5 nor 5-6-5")
        elif h.bpp == 16 and h.compression == BI_RGB:
            h.bpp = 15
    elif size == 12:
        h.width, height, planes_bpp = struct.unpack_from("<HHI", data, pos)
        h.bpp, h.compression = planes_bpp >> 16, BI_RGB
        if h.bpp <= 8:
            n = 1 << h.bpp
            raw = np.frombuffer(data[14 + 12:14 + 12 + 3 * n], np.uint8).reshape(-1, 3)
            h.palette = np.zeros((256, 3), np.uint8)
            h.palette[:len(raw)] = raw
    else:
        raise BmpError(f"BMP header of {size} bytes (12, 40, 108 and 124 are read)")
    h.bottom_up = height > 0
    h.height = abs(height)
    ok = h.width > 0 and h.height > 0 and (
        (h.bpp in (1, 4, 8, 15, 16, 24, 32) and h.compression == BI_RGB)
        or (h.bpp in (15, 16, 32) and h.compression == BI_BITFIELDS)
        or (h.bpp == 4 and h.compression == BI_RLE4) or (h.bpp == 8 and h.compression == BI_RLE8))
    if not ok:
        raise BmpError(f"BMP at {h.bpp} bits with compression {h.compression} is not one cv2 reads")
    if h.palette is not None:
        h.channels = 3 if cvt_color.is_color_palette(h.palette[:1 << h.bpp]) else 1
    else:
        h.channels = 4 if h.bpp == 32 and h.compression != BI_RGB else 3
    if size == 12:  # cv2 types an OS/2 file one-channel whatever it holds
        h.channels = 1
    return h


def _rle(data: bytes, h: _Header) -> np.ndarray:
    """RLE8 / RLE4 -> (height, width) palette indices in file row order,
    with cv2's cursor (measured): a run or a literal must end within its
    row; an RLE8 run that reaches the row's end moves to the next row, and
    an end-of-line right after it does not skip a row; in RLE8 end-of-line,
    end-of-bitmap and delta fill the pixels they pass with index 0; in RLE4
    end-of-line and end-of-bitmap both fill to the end of the row only (an
    early end-of-bitmap leaves cv2 reading past the stream: None) and a
    delta moves right only, by its first byte."""
    w, hh = h.width, h.height
    out = np.zeros(w * hh, np.uint8)
    rle8 = h.compression == BI_RLE8
    pos, y, x, wrapped = h.offset, 0, 0, False

    def fill(n, y, x):
        # cv2's FillUniColor with palette entry 0: a do-while over rows
        while True:
            m = max(0, min(n, w - x))
            x += m
            n -= m
            if x >= w:
                x, y = 0, y + 1
                if y >= hh:
                    break
            if n <= 0:
                break
        return y, x

    while True:
        if pos + 2 > len(data):
            raise BmpError("BMP RLE stream ends before its end-of-bitmap")
        n, code = data[pos], data[pos + 1]
        pos += 2
        if n:  # a run
            if x + n > w:
                raise BmpError(f"BMP RLE run of {n} past the end of row {y}")
            base = y * w + x
            if rle8:
                out[base:base + n] = code
                x += n
                wrapped = x == w
                if wrapped:
                    x, y = 0, y + 1
                    if y >= hh:
                        break
            else:
                out[base:base + n] = np.array([code >> 4, code & 15], np.uint8)[np.arange(n) & 1]
                x += n
        elif code > 2:  # literal
            if x + code > w:
                raise BmpError(f"BMP RLE literal of {code} past the end of row {y}")
            base = y * w + x
            if rle8:
                out[base:base + code] = np.frombuffer(data, np.uint8, code, pos)
                pos += (code + 1) & ~1
            else:
                nbytes = (code + 1) >> 1
                packed = np.frombuffer(data, np.uint8, nbytes, pos)
                out[base:base + code] = np.stack([packed >> 4, packed & 15], 1).reshape(-1)[:code]
                pos += (nbytes + 1) & ~1
            x += code
            wrapped = False
        else:
            if not rle8:  # RLE4: each escape only ends the row, a delta moves right only
                skip = w - x
                if code == 2:
                    skip = data[pos]
                    pos += 2
            elif code == 0 and wrapped and x == 0:
                wrapped = False
                continue
            elif code == 2:
                skip = data[pos] + data[pos + 1] * w
                pos += 2
            elif code == 1:
                skip = (w - x) + (hh - y) * w
            else:
                skip = w - x
            y, x = fill(skip, y, x)
            wrapped = False
            if y >= hh:
                break
    return out.reshape(hh, w)


def decode(data: bytes, flags: int) -> np.ndarray:
    """BMP bytes -> cv2.imdecode's array under ``flags`` (-1 unchanged, 0
    gray, 1 colour)."""
    h = read_header(data)
    channels = h.channels if flags == -1 else (3 if flags == 1 else 1)
    color = channels > 1
    w, hh, bpp = h.width, h.height, h.bpp
    if h.compression in (BI_RLE8, BI_RLE4):
        idx = _rle(data, h)
    else:
        pitch = ((w * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & -4
        if h.offset + pitch * hh > len(data):
            raise BmpError(f"BMP pixel data is {len(data) - h.offset} bytes, {pitch * hh} expected")
        rows = np.frombuffer(data, np.uint8, pitch * hh, h.offset).reshape(hh, pitch)
        if bpp <= 8:
            idx = rows[:, :w] if bpp == 8 else cvt_color.unpack_bits(rows, w, bpp)
        elif bpp in (15, 16):
            t = rows[:, :2 * w].copy().view("<u2").astype(np.int32)
            if bpp == 15:
                bgr = np.stack([(t << 3) & 0xF8, (t >> 2) & 0xF8, (t >> 7) & 0xF8], -1)
            else:
                bgr = np.stack([(t << 3) & 0xF8, (t >> 3) & 0xFC, (t >> 8) & 0xF8], -1)
            bgr = bgr.astype(np.uint8)
            img = bgr if color else cvt_color.bgr_to_gray(bgr)
        else:
            img = rows[:, :w * (bpp // 8)].reshape(hh, w, bpp // 8)
            if channels == 4:
                img = img.copy()
            elif bpp == 32 and not color and h.v4 and h.compression == BI_BITFIELDS:
                img = cvt_color.bgra_to_gray(img)
            else:
                img = np.ascontiguousarray(img[..., :3]) if color else cvt_color.bgr_to_gray(img)
    if bpp <= 8:
        bgr = h.palette[idx]
        img = bgr if color else cvt_color.bgr_to_gray(bgr)
    if h.bottom_up:
        img = img[::-1]
    return np.ascontiguousarray(img)


def encode(img: np.ndarray) -> bytes:
    """(H, W) / (H, W, 3) / (H, W, 4) uint8 -> ``cv2.imencode('.bmp')``'s
    bytes."""
    img = np.asarray(img)
    channels = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype != np.uint8 or channels not in (1, 3, 4):
        raise BmpError(f"BMP holds uint8 gray, BGR or BGRA, got {img.dtype} {img.shape}")
    height, width = img.shape[:2]
    step = (width * channels + 3) & -4
    header_size = 124 if channels == 4 else 40
    palette = cvt_color.gray_palette(8) if channels == 1 else None
    head_len = 14 + header_size + (1024 if channels == 1 else 0)
    out = bytearray(MAGIC + struct.pack("<IIIIiiHHIIiiII", head_len + step * height, 0, head_len, header_size,
                                        width, height, 1, channels * 8, BI_BITFIELDS if channels == 4 else BI_RGB,
                                        0, 0, 0, 0, 0))
    if channels == 4:
        out += struct.pack("<IIII4s", 0xFF0000, 0xFF00, 0xFF, 0xFF000000, b"BGRs") + bytes(124 - 60)
    if palette is not None:
        out += np.concatenate([palette, np.zeros((256, 1), np.uint8)], 1).tobytes()
    rows = np.zeros((height, step), np.uint8)
    rows[:, :width * channels] = img.reshape(height, -1)
    return bytes(out) + rows[::-1].tobytes()
