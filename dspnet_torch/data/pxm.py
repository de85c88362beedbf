"""Netpbm images without cv2: PBM / PGM / PPM (``P1``-``P6``), PAM
(``P7``) and PFM (``PF`` / ``Pf``), read and written as cv2 5.0.0's
``grfmt_pxm.cpp``, ``grfmt_pam.cpp`` and ``grfmt_pfm.cpp`` do (measured in
``tests/test_torch_image_formats.py``).

PxM. Header numbers are separated by white space and ``#`` comments
anywhere; the pixels start one byte after the last number. A bit (P1, P4)
is black when set: 255 for 0, 0 for 1. ASCII gray and colour (P2, P3) scale
a sample by ``v * 255 // maxval`` when maxval is below 256; binary files
(P5, P6) keep the stored byte whatever maxval says. maxval above 255 makes
16-bit big-endian samples, kept under ``IMREAD_UNCHANGED`` and reduced to
their high byte otherwise. Colour is stored RGB and returned BGR; gray from
colour is cvtColor's 14-bit rule. An ASCII file whose last number runs into
the end of the data is refused, as cv2 reads one byte past every number.

PAM. ``WIDTH``, ``HEIGHT``, ``DEPTH``, ``MAXVAL`` and ``TUPLTYPE`` lines up
to ``ENDHDR``. Samples are kept in their stored order when the flag asks
for as many channels as the file has (cv2 writes and reads PAM colour
unswapped); otherwise cv2's own conversions, quirks included: ``RGB``
swaps to BGR (or to gray by the 14-bit rule); ``GRAYSCALE_ALPHA`` and
``RGB_ALPHA`` step through the first ``width`` samples of a row a pixel at a
time, so only ``ceil(width / depth)`` pixels are filled (gray ones three
times over) and the rest of the row, which cv2 leaves as it found it, is 0
here; where the gray ones would run past the row (always for
``GRAYSCALE_ALPHA``) cv2 writes past the end of its image, and the read is
refused; ``BLACKANDWHITE`` reads its rows
as packed bits. Without ``TUPLTYPE`` one 8-bit channel is gray and three
are RGB; two or four channels (as cv2 writes BGRA), or 16-bit samples (as
cv2 writes them), are refused, as are ``BLACKANDWHITE_ALPHA`` files.

PFM. Little-endian when the scale is negative, rows bottom-up, RGB returned
BGR, every sample times ``1 / |scale|`` in float32; under ``IMREAD_COLOR``
and ``IMREAD_GRAYSCALE`` the floats go through ``saturate_cast<uchar>``
(half to even; inf and values past the int range give 0) without a factor
of 255, and the channel count stays the
file's.

Writers: binary PBM (a pixel is set where the gray value is 0), PGM / PPM
(``.pnm`` by channel count) at maxval 255 or 65535, PAM in the array's own
channel order, PFM little-endian (scale -1), each byte for byte as
``cv2.imencode`` writes them.
"""

from __future__ import annotations

import numpy as np

from dspnet_torch.data import cvt_color


class PxmError(ValueError):
    pass


_SPACE = b" \t\n\r\x0b\x0c"


class _Numbers:
    """cv2's ``ReadNumber``: skip white space and ``#`` comments (to the end
    of the line), read decimal digits, and consume the byte after them."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise PxmError("PxM data ends inside a number (cv2 reads one byte past each)")
        c = self.data[self.pos]
        self.pos += 1
        return c

    def number(self, maxdigits: int = 0) -> int:
        c = self.byte()
        while not 48 <= c <= 57:
            if c == 35:  # '#'
                while c not in (10, 13):
                    c = self.byte()
                c = self.byte()
            elif c in _SPACE:
                while c in _SPACE:
                    c = self.byte()
            else:
                raise PxmError(f"PxM: unexpected byte {c:#x} where a number should be")
        val, digits = 0, 0
        while True:
            val = val * 10 + c - 48
            digits += 1
            if maxdigits and digits >= maxdigits:
                break
            c = self.byte()
            if not 48 <= c <= 57:
                break
        return val


def _out_type(depth16: bool, channels: int, flags: int):
    if flags == -1:
        return depth16, channels
    return False, 3 if flags == 1 else 1


def decode_pnm(data: bytes, flags: int) -> np.ndarray:
    kind = data[1:2]
    if data[:1] != b"P" or kind not in b"123456" or not kind:
        raise PxmError("not a PBM / PGM / PPM file")
    k = int(kind)
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[k]
    binary = k >= 4
    nums = _Numbers(data, 2)
    w, h = nums.number(), nums.number()
    maxval = nums.number() if bpp > 1 else 1
    if not (w > 0 and h > 0 and 0 < maxval < 65536):
        raise PxmError(f"PxM header {w}x{h} maxval {maxval}")
    nch = 3 if bpp == 24 else 1
    depth16 = maxval > 255
    out16, out_ch = _out_type(depth16, nch, flags)
    if bpp == 1:
        if binary:
            pitch = (w + 7) // 8
            raw = _take(data, nums.pos, pitch * h)
            bits = cvt_color.unpack_bits(raw.reshape(h, pitch), w, 1)
        else:
            bits = np.array([nums.number(1) != 0 for _ in range(w * h)], np.uint8).reshape(h, w)
        img = np.where(bits == 1, 0, 255).astype(np.uint8)
        return cvt_color.gray_to_bgr(img) if out_ch == 3 else img
    n = w * h * nch
    if binary:
        if depth16:
            samples = _take(data, nums.pos, 2 * n).view(">u2").astype(np.uint16)
        else:
            samples = _take(data, nums.pos, n)
    else:
        codes = np.minimum(np.array([nums.number() for _ in range(n)], np.int64), maxval)
        samples = codes.astype(np.uint16) if depth16 else (codes * 255 // maxval).astype(np.uint8)
    samples = samples.reshape(h, w, nch) if nch == 3 else samples.reshape(h, w)
    if depth16 and not out16:
        samples = (samples >> 8).astype(np.uint8)
    if nch == 1:
        return cvt_color.gray_to_bgr(samples) if out_ch == 3 else samples
    if out_ch == 3:
        return np.ascontiguousarray(samples[..., ::-1])
    return cvt_color.bgr_to_gray(samples, rgb=True)


def _take(data: bytes, pos: int, n: int) -> np.ndarray:
    if pos + n > len(data):
        raise PxmError(f"image data is {len(data) - pos} bytes, {n} expected")
    return np.frombuffer(data, np.uint8, n, pos)


# ------------------------------------------------------------------ PAM

#: TUPLTYPE -> (gray, blue, green, red) source channel of cv2's layout
_PAM_LAYOUT = {"BLACKANDWHITE": (0, 0, 0, 0), "GRAYSCALE": (0, 0, 0, 0), "GRAYSCALE_ALPHA": (0, 0, 0, 0),
               "RGB": (0, 2, 1, 0), "RGB_ALPHA": (0, 2, 1, 0)}


def _pam_header(data: bytes):
    fields, pos = {}, 3
    if data[:3] not in (b"P7\n", b"P7\r", b"P7 "):
        raise PxmError("not a PAM file")
    while True:
        end = data.find(b"\n", pos)
        if end < 0:
            raise PxmError("PAM header without ENDHDR")
        line = data[pos:end].split(b"#", 1)[0].strip()
        pos = end + 1
        if not line:
            continue
        key, _, value = line.partition(b" ")
        key = key.decode("latin-1").upper()
        if key == "ENDHDR":
            return fields, pos
        fields[key] = value.strip().decode("latin-1")


def decode_pam(data: bytes, flags: int) -> np.ndarray:
    fields, pos = _pam_header(data)
    try:
        w, h, nch, maxval = (int(fields[k]) for k in ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL"))
    except (KeyError, ValueError) as e:
        raise PxmError(f"PAM header {fields}: {e}") from None
    tupl = fields.get("TUPLTYPE")
    if tupl is None:
        if nch not in (1, 3) or maxval > 255:
            raise PxmError(f"PAM of depth {nch}, maxval {maxval} without TUPLTYPE: cv2 cannot tell its format "
                           "(it guesses gray or RGB at 8 bits only)")
        tupl = "GRAYSCALE" if nch == 1 else "RGB"
    if tupl not in _PAM_LAYOUT:
        raise PxmError(f"PAM TUPLTYPE {tupl} is not one cv2 reads")
    if not (w > 0 and h > 0 and 0 < maxval < 65536 and 0 < nch <= 4):
        raise PxmError(f"PAM header {w}x{h}x{nch} maxval {maxval}")
    depth16 = maxval > 255
    out16, out_ch = _out_type(depth16, nch, flags)
    n = w * h * nch
    if tupl == "BLACKANDWHITE":
        # cv2 reads each row's w * depth bytes as packed bits, 1 = 255
        raw = _take(data, pos, n * (2 if depth16 else 1)).reshape(h, -1)
        img = cvt_color.unpack_bits(raw, w, 1) * np.uint8(255)
        return cvt_color.gray_to_bgr(img) if out_ch == 3 else img
    samples = (_take(data, pos, 2 * n).view(">u2").astype(np.uint16) if depth16 else _take(data, pos, n).copy())
    if depth16 and not out16:
        samples = (samples >> 8).astype(np.uint8)
    rows = samples.reshape(h, w * nch)
    if out_ch == nch:
        return rows.reshape(h, w, nch) if nch > 1 else rows
    if tupl == "RGB":  # rgb_convert
        rgb = rows.reshape(h, w, 3)
        return np.ascontiguousarray(rgb[..., ::-1]) if out_ch == 3 else cvt_color.bgr_to_gray(rgb, rgb=True)
    # basic_conversion: one pixel per `nch` samples while inside the first w samples
    gray_c, b_c, g_c, r_c = _PAM_LAYOUT[tupl]
    out = np.zeros((h, w * (3 if out_ch == 3 else 1)), rows.dtype)
    if out_ch == 3:
        starts = np.arange(0, w, nch)
        filled = np.stack([rows[:, starts + b_c], rows[:, starts + g_c], rows[:, starts + r_c]], -1)
        out[:, :filled.shape[1] * 3] = filled.reshape(h, -1)
        return out.reshape(h, w, 3)
    if 3 * -(-w // nch) > w:
        raise PxmError(f"PAM {tupl} read as gray: cv2 5.0.0 writes 3 bytes a pixel into its one-channel "
                       "image and past the image's end, so it is refused")
    trip = np.repeat(rows[:, np.arange(0, w, nch) + gray_c], 3, axis=1)
    out[:, :trip.shape[1]] = trip
    return out


# ------------------------------------------------------------------ PFM


def decode_pfm(data: bytes, flags: int) -> np.ndarray:
    if data[:2] not in (b"PF", b"Pf"):
        raise PxmError("not a PFM file")
    nch = 3 if data[1:2] == b"F" else 1
    nums = _Numbers(data, 2)
    w, h = nums.number(), nums.number()
    # the scale: a decimal number up to the next white space
    pos = nums.pos
    while pos < len(data) and data[pos] in _SPACE:
        pos += 1
    end = pos
    while end < len(data) and data[end] not in _SPACE:
        end += 1
    try:
        scale = float(data[pos:end])
    except ValueError:
        raise PxmError(f"PFM scale {data[pos:end]!r}") from None
    if scale == 0 or not (w > 0 and h > 0):
        raise PxmError(f"PFM header {w}x{h} scale {scale}")
    n = w * h * nch
    raw = _take(data, end + 1, 4 * n).view("<f4" if scale < 0 else ">f4").astype(np.float32)
    img = raw.reshape(h, w, nch)[::-1]
    if nch == 3:
        img = img[..., ::-1]
    img = img * (np.float32(1) / np.float32(abs(scale)))
    img = img[..., 0] if nch == 1 else img
    if flags != -1:
        img = cvt_color.saturate_u8(img)
    return np.ascontiguousarray(img)


# ------------------------------------------------------------------ writers


def encode_pbm(img: np.ndarray) -> bytes:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise PxmError(f"PBM is written from a uint8 gray image, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    pitch = (w + 7) // 8
    bits = np.zeros((h, pitch * 8), np.uint8)
    bits[:, :w] = img == 0
    return f"P4\n{w} {h}\n".encode() + np.packbits(bits, axis=1).tobytes()


def encode_pnm(img: np.ndarray, kind: str = "auto") -> bytes:
    """``kind``: "pgm" (gray only), "ppm" (BGR only) or "auto" (``.pnm``)."""
    img = np.asarray(img)
    nch = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype not in (np.uint8, np.uint16) or nch not in (1, 3) or (kind == "pgm" and nch != 1) \
            or (kind == "ppm" and nch != 3):
        raise PxmError(f"{kind.upper()} is written from uint8 / uint16 "
                       f"{'gray' if kind == 'pgm' else 'BGR' if kind == 'ppm' else 'gray or BGR'}, "
                       f"got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    maxval = 65535 if img.dtype == np.uint16 else 255
    pix = img[..., ::-1] if nch == 3 else img
    body = np.ascontiguousarray(pix).astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return f"P{5 if nch == 1 else 6}\n{w} {h}\n{maxval}\n".encode() + body


def encode_pam(img: np.ndarray) -> bytes:
    img = np.asarray(img)
    nch = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype not in (np.uint8, np.uint16) or nch not in (1, 2, 3, 4):
        raise PxmError(f"PAM is written from uint8 / uint16 with 1-4 channels, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    maxval = 65535 if img.dtype == np.uint16 else 255
    body = np.ascontiguousarray(img).astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {nch}\nMAXVAL {maxval}\nENDHDR\n".encode() + body


def encode_pfm(img: np.ndarray) -> bytes:
    img = np.asarray(img)
    nch = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype not in (np.uint8, np.uint16, np.float32) or nch not in (1, 3):
        raise PxmError(f"PFM is written from 1 or 3 channels of uint8, uint16 or float32, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    pix = img.astype("<f4")[::-1]
    if nch == 3:
        pix = pix[..., ::-1]
    return f"P{'F' if nch == 3 else 'f'}\n{w} {h}\n-1\n".encode() + np.ascontiguousarray(pix).tobytes()


def decode(data: bytes, flags: int) -> np.ndarray:
    """Any of the three families, by signature."""
    if data[:2] in (b"PF", b"Pf"):
        return decode_pfm(data, flags)
    if data[:2] == b"P7":
        return decode_pam(data, flags)
    return decode_pnm(data, flags)
