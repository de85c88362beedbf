"""Baseline JPEG on numpy: a decoder that gives libjpeg-turbo's pixels and an
encoder (the port's counterpart of ``cv2.imdecode`` / ``cv2.imwrite`` on
JPEG, ``dspnet_tpu/data/iterator.py:73,76`` and
``dspnet_tpu/data/synthetic.py:153``).

This is the plain codec: the CPU path and the host-side tools use it. On the
card, images are decoded by nvJPEG (``data/jpeg_cuda.py``) and nothing on
that path calls :func:`decode`.

**Decoder.** Baseline and extended sequential Huffman JPEG, 8-bit, one or
three components, sampling factors 1x1 (4:4:4), 2x1 (4:2:2) and 2x2 (4:2:0)
for luma with 1x1 chroma, restart intervals, any image size. It follows what
libjpeg-turbo does by default, which is how cv2 decodes:

* the ISLOW integer IDCT (``jidctint.c``), vectorised over all blocks, with
  its ``DESCALE`` rounding and its post-IDCT range-limit table;
* "fancy" triangular chroma upsampling (``jdsample.c``): h2v1 with rounding
  biases 1 and 2, h2v2 with biases 8 and 7, the image edges replicated (the
  row above the first and below the last are copies of them); a component
  no wider than 2 samples is replicated instead, as libjpeg-turbo does;
* the fixed-point YCbCr -> RGB tables of ``jdcolor.c`` (16 fraction bits);
* a gray image gives one plane (``imdecode`` replicates it for colour).

So the pixels equal cv2's bit for bit (``tests/test_torch_jpeg.py``). The
Huffman stage is a Python loop over 16-bit lookup tables: fine at test sizes
and for checks, slow (about a second) at 1024x2048. Progressive,
arithmetic-coded, lossless, 12-bit and CMYK files raise :class:`JpegError`.
The APP1 Exif ``Orientation`` tag (values 2-8) is applied after the colour
conversion, a flip or a transpose, as ``cv2.imread`` and ``cv2.imdecode``
do under ``IMREAD_COLOR``. :func:`decode_planes` stops before the upsampling
and returns the cropped component planes, which is what the card's colour
kernel (``csrc/jpeg.cu``) takes from nvJPEG.

**Encoder.** Baseline JFIF, the Annex K quantisation tables scaled by the IJG
quality rule, 4:2:0 (cv2's default), 4:2:2, 4:4:4 or gray, the standard
Huffman tables, no restart markers; ``progressive=True`` writes the same
quantised coefficients as a progressive file (spectral selection only: one
DC scan, then one AC scan per component), which the plain decoder does not
read and nvJPEG and libjpeg do. The DCT is an exact float DCT rounded to the
nearest step, so the bytes are not cv2's, but any decoder reads them. The
Huffman bit packing is vectorised (symbol arrays, cumulative bit offsets,
``np.packbits``, 0xFF stuffing).

Channel order follows cv2: colour arrays are BGR in and out.
"""

from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple, Tuple

import numpy as np


class JpegError(ValueError):
    """A JPEG stream this codec does not read, or a broken one."""


#: images :func:`decode` has decoded; a caller may reset it to 0 (the card's
#: loader path must leave it there)
decodes = 0


#: zigzag index -> natural (row-major) index in an 8x8 block
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_SOF_UNSUPPORTED = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "differential arithmetic sequential",
    0xCE: "differential arithmetic progressive", 0xCF: "differential arithmetic lossless",
}


# ------------------------------------------------------------------ header


def _segments(data: bytes, pos: int):
    """(marker, body, position after it) for each marker segment from
    ``pos``, until EOI or the end of the data."""
    while True:
        while pos < len(data) and data[pos] != 0xFF:  # garbage between segments
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= len(data) or data[pos] == 0xD9:
            return
        marker = data[pos]
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            pos += 1
            continue
        if pos + 3 > len(data):
            raise JpegError("JPEG stream ends inside a marker")
        (length,) = struct.unpack(">H", data[pos + 1:pos + 3])
        body = data[pos + 3:pos + 1 + length]
        if len(body) != length - 2:
            raise JpegError(f"JPEG segment 0xFF{marker:02X} is truncated")
        pos += 1 + length
        yield marker, body, pos


def _check_soi(data: bytes):
    if data[:2] != b"\xff\xd8":
        raise JpegError("not a JPEG stream (no SOI marker)")


def read_header(data) -> Tuple[int, int, int]:
    """(height, width, components) from the frame header, without decoding."""
    data = bytes(data)
    _check_soi(data)
    for marker, body, _ in _segments(data, 2):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            _, height, width, ncomp = struct.unpack(">BHHB", body[:6])
            return height, width, ncomp
        if marker == 0xDA:
            break
    raise JpegError("JPEG stream has no frame header")


# ------------------------------------------------------------------ Huffman


def _huffman_codes(bits, values) -> List[Tuple[int, int, int]]:
    """(length, code, symbol) of the canonical code (Annex C)."""
    out, code, k = [], 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out.append((length, code, values[k]))
            code += 1
            k += 1
        code <<= 1
    return out


def _lookup_table(bits, values) -> List[int]:
    """65,536 entries, one per 16-bit window: (code length << 8) | symbol, or
    0 where no code starts the window."""
    lut = np.zeros(1 << 16, np.int64)
    for length, code, sym in _huffman_codes(bits, values):
        if code >= 1 << length:
            raise JpegError("JPEG Huffman table is over-subscribed")
        start = code << (16 - length)
        lut[start:start + (1 << (16 - length))] = (length << 8) | sym
    return lut.tolist()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _windows(seg: bytes) -> List[int]:
    """For each byte offset i, the 40-bit big-endian window of bytes i..i+4,
    over the segment and 8 zero bytes after it."""
    a = np.frombuffer(seg + b"\x00" * 12, np.uint8).astype(np.int64)
    n = len(seg) + 8
    w = (a[:n] << 32) | (a[1:n + 1] << 24) | (a[2:n + 2] << 16) | (a[3:n + 3] << 8) | a[4:n + 4]
    return w.tolist()


def _entropy_segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data of one scan from ``pos``: its restart
    intervals with byte stuffing removed, and the position of the marker
    that ends the scan."""
    segs, start = [], pos
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            segs.append(data[start:].replace(b"\xff\x00", b"\xff"))
            return segs, len(data)
        nb = data[i + 1]
        if nb == 0x00 or nb == 0xFF:
            pos = i + 1 if nb == 0xFF else i + 2
            continue
        if 0xD0 <= nb <= 0xD7:  # RSTn: the next interval starts after it
            segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
            start = pos = i + 2
            continue
        segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        return segs, i


def _decode_scan(segs, scan, frame, restart, coefs):
    """Huffman-decode one sequential scan into the components' zigzag
    coefficient arrays (``coefs[c]``: (nbh, nbw, 64) int32)."""
    comps = frame["comps"]
    hmax, vmax = frame["hmax"], frame["vmax"]
    mcux, mcuy = frame["mcux"], frame["mcuy"]
    ids = [c for c, _, _ in scan]
    if len(ids) == 1:  # non-interleaved: the component's own block grid
        c = ids[0]
        bw = _ceil_div(_ceil_div(frame["width"] * comps[c]["h"], hmax), 8)
        bh = _ceil_div(_ceil_div(frame["height"] * comps[c]["v"], vmax), 8)
        units = [[(c, by, bx)] for by in range(bh) for bx in range(bw)]
    else:
        units = []
        for my in range(mcuy):
            for mx in range(mcux):
                unit = []
                for c in ids:
                    h, v = comps[c]["h"], comps[c]["v"]
                    for yy in range(v):
                        for xx in range(h):
                            unit.append((c, my * v + yy, mx * h + xx))
                units.append(unit)
    tables = {c: (dc, ac) for c, dc, ac in scan}
    per_seg = restart if restart else len(units)
    nseg = _ceil_div(len(units), per_seg) if units else 0
    if len(segs) < nseg:
        segs = list(segs) + [b""] * (nseg - len(segs))
    for si in range(nseg):
        pos_l, val_l = [], []
        try:
            nbits = _decode_units(units[si * per_seg:(si + 1) * per_seg], _windows(segs[si]), tables,
                                  {c: coefs[c].shape[1] for c in ids}, pos_l, val_l)
        except IndexError:
            nbits = None
        if nbits is None or nbits > 8 * len(segs[si]):
            raise JpegError("corrupt JPEG data: the scan ends early")
        if pos_l:  # (component, flat index) pairs, scattered per component
            pos = np.asarray(pos_l, np.int64)
            val = np.asarray(val_l, np.int64)
            for c in ids:
                sel = (pos & 255) == c
                coefs[c].reshape(-1)[pos[sel] >> 8] = val[sel]


_MASKS = [(1 << s) - 1 for s in range(17)]
_NATURAL = NATURAL_ORDER.tolist()


def _decode_units(units, w, tables, widths, pos_l, val_l) -> int:
    """Decode the blocks of one restart interval from the bit windows ``w``;
    append each nonzero coefficient as ``((flat index << 8) | component,
    value)`` (the DC as the running sum of its differences); return the
    bits read."""
    masks, natural = _MASKS, _NATURAL
    pred = {}
    p = 0
    for unit in units:
        for c, by, bx in unit:
            dc_lut, ac_lut = tables[c]
            base = (by * widths[c] + bx) * 64
            t = dc_lut[(w[p >> 3] >> (24 - (p & 7))) & 0xFFFF]
            if not t:
                raise JpegError("corrupt JPEG data: bad DC Huffman code")
            p += t >> 8
            s = t & 255
            v = 0
            if s:
                v = (w[p >> 3] >> (40 - (p & 7) - s)) & masks[s]
                p += s
                if v < (1 << (s - 1)):
                    v -= masks[s]
            v += pred.get(c, 0)
            pred[c] = v
            if v:
                pos_l.append((base << 8) | c)
                val_l.append(v)
            k = 1
            while k < 64:
                t = ac_lut[(w[p >> 3] >> (24 - (p & 7))) & 0xFFFF]
                if not t:
                    raise JpegError("corrupt JPEG data: bad AC Huffman code")
                p += t >> 8
                rs = t & 255
                s = rs & 15
                if s:
                    k += rs >> 4
                    if k > 63:
                        raise JpegError("corrupt JPEG data: AC run past the block")
                    v = (w[p >> 3] >> (40 - (p & 7) - s)) & masks[s]
                    p += s
                    if v < (1 << (s - 1)):
                        v -= masks[s]
                    pos_l.append(((base + natural[k]) << 8) | c)
                    val_l.append(v)
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:  # EOB
                    break
    return p


# ------------------------------------------------------------------ IDCT

_CONST_BITS, _PASS1_BITS = 13, 2


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(x):
    """The ISLOW butterfly of ``jidctint.c`` on 8 int64 arrays; returns the 8
    outputs before descaling."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * 4433
    tmp2 = z1 + z3 * -15137
    tmp3 = z1 + z2 * 6270
    tmp0 = (x[0] + x[4]) << _CONST_BITS
    tmp1 = (x[0] - x[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069 + z5, z4 * -3196 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantized coefficients [row = vertical frequency] -> (N, 8,
    8) uint8 samples, libjpeg's ISLOW IDCT and range limit bit for bit (its
    all-zero-AC shortcuts equal the full formula, so none is needed)."""
    d = coef.astype(np.int64)
    # pass 1: columns; results scaled by 2**PASS1_BITS
    ws = np.stack([_descale(o, _CONST_BITS - _PASS1_BITS)
                   for o in _idct_1d([d[:, k, :] for k in range(8)])], axis=1)
    # pass 2: rows; descale by 8 and undo PASS1_BITS
    out = np.stack([_descale(o, _CONST_BITS + _PASS1_BITS + 3)
                    for o in _idct_1d([ws[:, :, k] for k in range(8)])], axis=2)
    # the post-IDCT range-limit table: index (v & 1023), centred on 128
    return np.clip(((out + 512) & 1023) - 512 + 128, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ upsampling


def _fancy_h2v1(c: np.ndarray) -> np.ndarray:
    """(h, w) uint8 -> (h, 2w): 3/4 nearer + 1/4 further sample, biases 1
    and 2, edges replicated (``h2v1_fancy_upsample``)."""
    x = c.astype(np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.uint8)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out


def _fancy_h2v2(c: np.ndarray) -> np.ndarray:
    """(h, w) uint8 -> (2h, 2w): 9/16, 3/16, 3/16, 1/16 weights, biases 8 and
    7, edges replicated (``h2v2_fancy_upsample`` with the main controller's
    context rows)."""
    x = c.astype(np.int32)
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.uint8)
    for r, col in ((0, 3 * x + up), (1, 3 * x + down)):
        left = np.concatenate([col[:, :1], col[:, :-1]], axis=1)
        right = np.concatenate([col[:, 1:], col[:, -1:]], axis=1)
        out[r::2, 0::2] = (3 * col + left + 8) >> 4
        out[r::2, 1::2] = (3 * col + right + 7) >> 4
    return out


def _upsample(c: np.ndarray, fh: int, fv: int) -> np.ndarray:
    if (fh, fv) == (1, 1):
        return c
    if c.shape[1] <= 2:  # libjpeg-turbo replicates a component this narrow
        return np.repeat(np.repeat(c, fv, axis=0), fh, axis=1)
    if (fh, fv) == (2, 1):
        return _fancy_h2v1(c)
    return _fancy_h2v2(c)


# ------------------------------------------------------------------ colour


def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _X + (1 << 15)) >> 16
_CB_B = (_fix(1.77200) * _X + (1 << 15)) >> 16
_CR_G = -_fix(0.71414) * _X
_CB_G = -_fix(0.34414) * _X + (1 << 15)


def ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's ``ycc_rgb_convert`` (its fixed-point tables), BGR out."""
    yi = y.astype(np.int64)
    r = yi + _CR_R[cr]
    g = yi + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = yi + _CB_B[cb]
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ Exif


def _exif_orientation(body: bytes) -> int:
    """The ``Orientation`` tag (0x0112) of an APP1 Exif body, 1 when it is
    absent, unreadable or outside 1..8."""
    tiff = body[6:]
    if body[:6] != b"Exif\x00\x00" or len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    try:
        (ifd,) = struct.unpack_from(e + "I", tiff, 4)
        (n,) = struct.unpack_from(e + "H", tiff, ifd)
        for k in range(n):
            tag, kind, count = struct.unpack_from(e + "HHI", tiff, ifd + 2 + 12 * k)
            if tag == 0x0112 and kind == 3 and count >= 1:
                (value,) = struct.unpack_from(e + "H", tiff, ifd + 2 + 12 * k + 8)
                return value if 1 <= value <= 8 else 1
    except struct.error:
        return 1
    return 1


def orient(img, orientation: int):
    """Apply an Exif orientation (1..8) to an (H, W, ...) numpy array or
    torch tensor, as cv2's ``ExifTransform``: 2 flips left-right, 3 turns
    180 degrees, 4 flips up-down, 5 transposes, 6 transposes and flips
    left-right, 7 transposes and turns 180 degrees, 8 transposes and flips
    up-down."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(0, 1) if hasattr(img, "flip") else np.swapaxes(img, 0, 1)
    axes = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    if not axes:
        return img
    return img.flip(axes) if hasattr(img, "flip") else np.flip(img, axes)


# ------------------------------------------------------------------ decode


class Info(NamedTuple):
    """What the marker segments before the first scan say of an image."""

    height: int
    width: int
    components: int
    #: chroma upsampling factors (horizontal, vertical): (1, 1) for 4:4:4
    #: and gray, (2, 1) for 4:2:2, (2, 2) for 4:2:0
    factors: Tuple[int, int]
    progressive: bool
    #: the three components are R, G, B (Adobe transform 0, or no JFIF and
    #: component ids 'R', 'G', 'B'), not YCbCr
    rgb: bool
    #: the Exif orientation, 1..8
    orientation: int


def _frame(body: bytes) -> dict:
    """A frame header's fields; raises on a precision, component count or
    sampling layout that neither decoder here reads."""
    precision, height, width, ncomp = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise JpegError(f"{precision}-bit JPEG is not supported (8-bit is)")
    if ncomp not in (1, 3):
        raise JpegError(f"JPEG with {ncomp} components is not supported (gray and "
                        "YCbCr are; CMYK is not)")
    if height == 0 or width == 0:
        raise JpegError("JPEG frame has a zero dimension")
    comps, order = {}, []
    for k in range(ncomp):
        cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
        comps[cid] = {"h": hv >> 4, "v": hv & 15, "tq": tq}
        order.append(cid)
    hmax = max(c["h"] for c in comps.values())
    vmax = max(c["v"] for c in comps.values())
    frame = {"height": height, "width": width, "comps": comps, "order": order,
             "hmax": hmax, "vmax": vmax,
             "mcux": _ceil_div(width, 8 * hmax), "mcuy": _ceil_div(height, 8 * vmax)}
    if ncomp == 1:
        comps[order[0]].update(h=1, v=1)
        frame.update(hmax=1, vmax=1, mcux=_ceil_div(width, 8), mcuy=_ceil_div(height, 8))
    else:
        luma, cb, cr = (comps[c] for c in order)
        if (cb["h"], cb["v"], cr["h"], cr["v"]) != (1, 1, 1, 1) or \
                (luma["h"], luma["v"]) not in ((1, 1), (2, 1), (2, 2)):
            raise JpegError("JPEG sampling factors " + ", ".join(
                f"{c['h']}x{c['v']}" for c in (luma, cb, cr))
                            + " are not supported (luma 1x1, 2x1 or 2x2 over 1x1 chroma are)")
    return frame


def _is_rgb(frame: dict, jfif: bool, adobe_transform) -> bool:
    if len(frame["order"]) != 3:
        return False
    return (adobe_transform == 0 if adobe_transform is not None
            else (not jfif and frame["order"] == [ord("R"), ord("G"), ord("B")]))


def read_info(data) -> Info:
    """The header of a JPEG stream without decoding it: sizes, chroma
    factors, progressive or not, the colour space and the Exif orientation.
    Raises :class:`JpegError` on a form neither the plain decoder nor the
    card reads (arithmetic coding, lossless, 12-bit, CMYK, other sampling
    factors); a progressive file passes (the card decodes it)."""
    data = bytes(data)
    _check_soi(data)
    jfif, adobe, orientation, frame, sof = False, None, 1, None, None
    for marker, body, _ in _segments(data, 2):
        if marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xE1 and body[:6] == b"Exif\x00\x00" and orientation == 1:
            orientation = _exif_orientation(body)
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker in _SOF_UNSUPPORTED and marker != 0xC2:
            raise JpegError(f"{_SOF_UNSUPPORTED[marker]} JPEG is not supported")
        elif marker in (0xC0, 0xC1, 0xC2):
            frame, sof = _frame(body), marker
        elif marker == 0xDA:
            break
    if frame is None:
        raise JpegError("JPEG stream has no frame header before its first scan")
    return Info(frame["height"], frame["width"], len(frame["order"]),
                (frame["hmax"], frame["vmax"]), sof == 0xC2,
                _is_rgb(frame, jfif, adobe), orientation)


class Planes(NamedTuple):
    """A decoded image before chroma upsampling: its component planes, each
    cropped to the component's own size (``ceil(H * v / vmax)`` by
    ``ceil(W * h / hmax)``), and the image's :class:`Info`."""

    planes: List[np.ndarray]
    info: Info


def decode_planes(data) -> Planes:
    """JPEG bytes -> the component planes after the IDCT, before chroma
    upsampling, colour conversion and orientation (counted in
    :data:`decodes`)."""
    global decodes
    decodes += 1
    data = bytes(data)
    qtables: Dict[int, np.ndarray] = {}
    dc_tables: Dict[int, list] = {}
    ac_tables: Dict[int, list] = {}
    frame = None
    restart = 0
    adobe_transform = None
    jfif = False
    orientation = 1
    coefs: Dict[int, np.ndarray] = {}
    comp_q: Dict[int, np.ndarray] = {}
    _check_soi(data)
    gen = _segments(data, 2)
    while True:
        try:
            marker, body, pos = next(gen)
        except StopIteration:
            break
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = (np.frombuffer(body[i + 1:i + 1 + n], ">u2") if pq
                        else np.frombuffer(body[i + 1:i + 1 + n], np.uint8)).astype(np.int64)
                q = np.zeros(64, np.int64)
                q[NATURAL_ORDER] = vals
                qtables[tq] = q
                i += 1 + n
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                bits = list(body[i + 1:i + 17])
                n = sum(bits)
                vals = list(body[i + 17:i + 17 + n])
                (ac_tables if tc else dc_tables)[th] = _lookup_table(bits, vals)
                i += 17 + n
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xE1 and body[:6] == b"Exif\x00\x00" and orientation == 1:
            orientation = _exif_orientation(body)
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker in _SOF_UNSUPPORTED:
            raise JpegError(f"{_SOF_UNSUPPORTED[marker]} JPEG is not supported (baseline and "
                            "extended sequential Huffman are)")
        elif marker in (0xC0, 0xC1):  # baseline / extended sequential Huffman
            frame = _frame(body)
            for cid in frame["order"]:
                c = frame["comps"][cid]
                coefs[cid] = np.zeros((frame["mcuy"] * c["v"], frame["mcux"] * c["h"], 64), np.int32)
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise JpegError("JPEG scan before its frame header")
            ns = body[0]
            scan = []
            for k in range(ns):
                cid, t = body[1 + 2 * k], body[2 + 2 * k]
                if cid not in frame["comps"]:
                    raise JpegError(f"JPEG scan names unknown component {cid}")
                if (t >> 4) not in dc_tables or (t & 15) not in ac_tables:
                    raise JpegError("JPEG scan uses an undefined Huffman table")
                scan.append((cid, dc_tables[t >> 4], ac_tables[t & 15]))
                if cid not in comp_q:
                    tq = frame["comps"][cid]["tq"]
                    if tq not in qtables:
                        raise JpegError(f"JPEG quantization table {tq} is not defined")
                    comp_q[cid] = qtables[tq]
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                raise JpegError("JPEG scan is not sequential (spectral selection or "
                                "successive approximation)")
            segs, end = _entropy_segments(data, pos)
            _decode_scan(segs, scan, frame, restart, coefs)
            gen = _segments(data, end)
    if frame is None or len(comp_q) != len(frame["order"]):
        raise JpegError("JPEG stream ends before every component was scanned")

    planes = []
    for cid in frame["order"]:
        c = frame["comps"][cid]
        blocks = coefs[cid].astype(np.int64) * comp_q[cid]
        nbh, nbw = blocks.shape[:2]
        pix = idct_islow(blocks.reshape(-1, 8, 8)).reshape(nbh, nbw, 8, 8)
        plane = pix.transpose(0, 2, 1, 3).reshape(nbh * 8, nbw * 8)
        dh = _ceil_div(frame["height"] * c["v"], frame["vmax"])
        dw = _ceil_div(frame["width"] * c["h"], frame["hmax"])
        planes.append(np.ascontiguousarray(plane[:dh, :dw]))
    info = Info(frame["height"], frame["width"], len(planes), (frame["hmax"], frame["vmax"]), False,
                _is_rgb(frame, jfif, adobe_transform), orientation)
    return Planes(planes, info)


def decode(data, apply_orientation: bool = True) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 BGR, or (H, W) uint8 for a gray image,
    turned by its Exif orientation unless ``apply_orientation`` is False (as
    ``cv2.imdecode`` under ``IMREAD_UNCHANGED``)."""
    planes, info = decode_planes(data)
    fh, fv = info.factors
    full = [planes[0]] + [_upsample(p, fh, fv)[:info.height, :info.width]
                          for p in planes[1:]]
    if len(full) == 1:
        img = full[0]
    elif info.rgb:
        img = np.stack(full[::-1], axis=-1)
    else:
        img = ycc_to_bgr(*full)
    if apply_orientation:
        img = orient(img, info.orientation)
    return np.ascontiguousarray(img)


# ------------------------------------------------------------------ encode

# Annex K.1 quantization tables, natural order
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99], np.int64)


def _ac_values(head):
    """An Annex K.3 AC table's values: the listed head, then every other
    (run, size) symbol in ascending order."""
    rest = sorted(set(range(256)) & ({(r << 4) | s for r in range(16) for s in range(1, 11)}
                                     | {0x00, 0xF0}) - set(head))
    return list(head) + rest


# Annex K.3: (BITS, HUFFVAL) of the four standard tables
STD_HUFFMAN = {
    "dc_luma": ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    "dc_chroma": ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    "ac_luma": ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], _ac_values([
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
        0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
        0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A])),
    "ac_chroma": ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _ac_values([
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
        0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
        0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1])),
}


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """The IJG quality scaling (``jpeg_quality_scaling``,
    ``jpeg_add_quant_table`` with force_baseline): natural order, 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _code_arrays(name):
    """(code, length) arrays indexed by symbol for a standard table."""
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    for length, c, sym in _huffman_codes(*STD_HUFFMAN[name]):
        code[sym], size[sym] = c, length
    return code, size


_DCT = np.array([[(np.sqrt(0.125) if u == 0 else 0.5) * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def _rgb_to_ycc(b, g, r):
    """libjpeg's ``rgb_ycc_convert`` (fixed point, 16 fraction bits)."""
    half, off = 1 << 15, 128 << 16
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + off + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + off + half - 1) >> 16
    return y, cb, cr


def _blocks(plane: np.ndarray, nbh: int, nbw: int) -> np.ndarray:
    """(nbh*8, nbw*8) samples -> (nbh, nbw, 64) zigzag-ordered level-shifted
    float DCT coefficients."""
    x = plane.astype(np.float64).reshape(nbh, 8, nbw, 8).transpose(0, 2, 1, 3) - 128.0
    rows = (x.reshape(-1, 8) @ _DCT.T).reshape(-1, 8, 8)  # along each row
    f = (rows.transpose(0, 2, 1).reshape(-1, 8) @ _DCT.T).reshape(-1, 8, 8).transpose(0, 2, 1)
    return f.reshape(nbh, nbw, 64)[..., NATURAL_ORDER]


def _bit_size(v: np.ndarray) -> np.ndarray:
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _pack(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate ``lens[i]`` low bits of ``vals[i]``, pad the last byte
    with 1-bits, stuff a 0x00 after every 0xFF."""
    total = int(lens.sum())
    nbytes = -(-total // 8)
    starts = np.cumsum(lens) - lens
    event = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
    shift = (lens[event] - 1 - (np.arange(total, dtype=np.int64) - starts[event]))
    bits = np.ones(nbytes * 8, np.uint8)
    bits[:total] = (vals[event] >> shift) & 1
    out = np.packbits(bits)
    ff = np.flatnonzero(out == 0xFF)
    return np.insert(out, ff + 1, 0).tobytes()


#: luma sampling factors (horizontal, vertical) over 1x1 chroma
_SUBSAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}


def encode(img: np.ndarray, quality: int = 95, subsampling: str = "420", progressive: bool = False) -> bytes:
    """(H, W, 3) uint8 BGR or (H, W) gray -> JFIF JPEG bytes.
    ``subsampling``: "420" (cv2's default), "422" or "444" for colour.
    ``progressive``: the same quantised coefficients in a progressive file
    (SOF2): one interleaved DC scan, then one AC scan (1..63) per component,
    no successive approximation."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[-1] != 3):
        raise ValueError(f"JPEG holds (H, W) or (H, W, 3) uint8 arrays, got {img.shape} {img.dtype}")
    if subsampling not in _SUBSAMPLING:
        raise ValueError(f"subsampling must be one of {sorted(_SUBSAMPLING)}, got {subsampling!r}")
    H, W = img.shape[:2]
    if not (0 < H < 65536 and 0 < W < 65536):
        raise ValueError(f"JPEG dimensions must lie in 1..65535, got {H}x{W}")
    gray = img.ndim == 2
    fh, fv = (1, 1) if gray else _SUBSAMPLING[subsampling]
    mcuy, mcux = _ceil_div(H, 8 * fv), _ceil_div(W, 8 * fh)
    pad = lambda p: np.pad(p, ((0, mcuy * 8 * fv - H), (0, mcux * 8 * fh - W)), mode="edge")  # noqa: E731
    qt = [quality_table(_STD_LUMA_Q, quality), quality_table(_STD_CHROMA_Q, quality)]
    if gray:
        planes = [pad(img.astype(np.int64))]
    else:
        b, g, r = (img[..., k].astype(np.int32) for k in range(3))
        planes = [pad(p) for p in _rgb_to_ycc(b, g, r)]
        if (fh, fv) == (2, 2):  # h2v2_downsample: 2x2 sums, biases 1, 2, 1, 2 along a row
            bias = np.tile([1, 2], mcux * 4)
            for k in (1, 2):
                p = planes[k]
                planes[k] = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + bias) >> 2
        elif (fh, fv) == (2, 1):  # h2v1_downsample: pair sums, biases 0, 1 along a row
            bias = np.tile([0, 1], mcux * 4)
            for k in (1, 2):
                p = planes[k]
                planes[k] = (p[:, 0::2] + p[:, 1::2] + bias) >> 1

    def quantize(plane, q, nbh, nbw):
        coef = _blocks(plane, nbh, nbw)
        step = q[NATURAL_ORDER].astype(np.float64)
        return (np.sign(coef) * np.floor(np.abs(coef) / step + 0.5)).astype(np.int64)

    per_mcu = fh * fv
    luma = quantize(planes[0], qt[0], mcuy * fv, mcux * fh)
    # blocks in scan order: per MCU, the luma blocks row by row, then Cb, Cr
    luma = luma.reshape(mcuy, fv, mcux, fh, 64).transpose(0, 2, 1, 3, 4).reshape(mcuy * mcux, per_mcu, 64)
    parts, comp = [luma], [0] * per_mcu
    if not gray:
        for k in (1, 2):
            parts.append(quantize(planes[k], qt[1], mcuy, mcux).reshape(mcuy * mcux, 1, 64))
            comp.append(k)
    blocks = np.concatenate(parts, axis=1)
    blocks = blocks.reshape(-1, 64)
    comp = np.tile(np.asarray(comp, np.int64), mcuy * mcux)
    chroma = comp > 0
    nb = len(blocks)

    dc_code = [_code_arrays("dc_luma"), _code_arrays("dc_chroma")]
    ac_code = [_code_arrays("ac_luma"), _code_arrays("ac_chroma")]

    def lookup(tables, which, sym):
        code = np.where(which, tables[1][0][sym], tables[0][0][sym])
        size = np.where(which, tables[1][1][sym], tables[0][1][sym])
        return code, size

    # DC: differences from the previous block of the same component
    dc = blocks[:, 0]
    diff = np.empty(nb, np.int64)
    for k in range(3 if not gray else 1):
        idx = np.flatnonzero(comp == k)
        diff[idx] = np.diff(dc[idx], prepend=0)
    s = _bit_size(diff)
    code, clen = lookup(dc_code, chroma, s)
    extra = np.where(diff < 0, diff - 1, diff) & ((1 << s) - 1)
    dc_events = (np.arange(nb, dtype=np.int64) * 1024, (code << s) | extra, clen + s)

    # AC: nonzero coefficients with their zero runs (ZRL for each 16 zeros);
    # event keys are block * 1024 + position in the block
    keys, vals, lens = [], [], []
    blocks[:, 1:] = np.clip(blocks[:, 1:], -1023, 1023)  # baseline AC sizes stop at 10 bits
    bi, ki = np.nonzero(blocks[:, 1:])
    ki = ki + 1
    v = blocks[bi, ki]
    prev = np.concatenate([[0], ki[:-1]])
    first = np.concatenate([[True], bi[1:] != bi[:-1]])
    run = ki - np.where(first, 0, prev) - 1
    s = _bit_size(v)
    sym = ((run & 15) << 4) | s
    code, clen = lookup(ac_code, chroma[bi], sym)
    extra = np.where(v < 0, v - 1, v) & ((1 << s) - 1)
    keys.append(bi * 1024 + ki * 8 + 7)
    vals.append((code << s) | extra)
    lens.append(clen + s)
    nzrl = run >> 4
    for j in range(3):
        has = nzrl > j
        code, clen = lookup(ac_code, chroma[bi[has]], np.full(int(has.sum()), 0xF0))
        keys.append(bi[has] * 1024 + ki[has] * 8 + j)
        vals.append(code)
        lens.append(clen)
    # EOB after the last nonzero coefficient unless it is the 63rd (in a
    # progressive AC scan the same symbol is EOB0: a run of one block)
    last = np.zeros(nb, np.int64)
    last[bi] = ki  # the last write per block wins: ki ascends within a block
    eob = last < 63
    code, clen = lookup(ac_code, chroma[eob], np.zeros(int(eob.sum()), np.int64))
    keys.append(np.flatnonzero(eob) * 1024 + 1023)
    vals.append(code)
    lens.append(clen)
    ac_events = tuple(np.concatenate(x) for x in (keys, vals, lens))

    def packed(events):
        order = np.argsort(events[0], kind="stable")
        return _pack(events[1][order], events[2][order])

    def segment(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = [b"\xff\xd8", segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    ntab = 1 if gray else 2
    for t in range(ntab):
        out.append(segment(0xDB, bytes([t]) + qt[t][NATURAL_ORDER].astype(np.uint8).tobytes()))
    ncomp = 1 if gray else 3
    sof = struct.pack(">BHHB", 8, H, W, ncomp) + bytes([1, (fh << 4) | fv, 0])
    if not gray:
        sof += bytes([2, 0x11, 1, 3, 0x11, 1])
    out.append(segment(0xC2 if progressive else 0xC0, sof))
    names = [("dc_luma", 0x00), ("ac_luma", 0x10)] + ([] if gray else [("dc_chroma", 0x01), ("ac_chroma", 0x11)])
    for name, tc_th in names:
        bits, values = STD_HUFFMAN[name]
        out.append(segment(0xC4, bytes([tc_th] + bits + values)))
    tables = [(1, 0x00)] + ([] if gray else [(2, 0x11), (3, 0x11)])
    if not progressive:
        sos = bytes([ncomp]) + b"".join(bytes(t) for t in tables) + bytes([0, 63, 0])
        out += [segment(0xDA, sos), packed(tuple(np.concatenate(x) for x in zip(dc_events, ac_events)))]
    else:
        out += [segment(0xDA, bytes([ncomp]) + b"".join(bytes(t) for t in tables) + bytes([0, 0, 0])),
                packed(dc_events)]
        # a component's own AC scan covers its own block grid (ceil of its
        # size over 8), in raster order: the MCU padding is not in it
        mcu_index, j = np.divmod(np.arange(nb, dtype=np.int64), per_mcu + (0 if gray else 2))
        my, mx = np.divmod(mcu_index, mcux)
        for k, (cid, tab) in enumerate(tables):
            f = (fh, fv) if k == 0 else (1, 1)
            rows = _ceil_div(_ceil_div(H * f[1], fv), 8)
            cols = _ceil_div(_ceil_div(W * f[0], fh), 8)
            by = my * f[1] + (j // fh if k == 0 else 0)
            bx = mx * f[0] + (j % fh if k == 0 else 0)
            inside = (comp == k) & (by < rows) & (bx < cols)
            rank = np.where(inside, by * cols + bx, -1)
            sel = inside[ac_events[0] >> 10]
            events = (rank[ac_events[0][sel] >> 10] * 1024 + (ac_events[0][sel] & 1023),
                      ac_events[1][sel], ac_events[2][sel])
            out += [segment(0xDA, bytes([1, cid, tab & 0x0F]) + bytes([1, 63, 0])), packed(events)]
    out.append(b"\xff\xd9")
    return b"".join(out)
