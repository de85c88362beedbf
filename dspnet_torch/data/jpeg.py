"""JPEG on numpy: a decoder that gives libjpeg-turbo's pixels and an
encoder (the port's counterpart of ``cv2.imdecode`` / ``cv2.imwrite`` on
JPEG, ``dspnet_tpu/data/iterator.py:73,76`` and
``dspnet_tpu/data/synthetic.py:153``).

This is the plain codec: the CPU path and the host-side tools use it. On the
card, images are decoded by nvJPEG (``data/jpeg_cuda.py``) and nothing on
that path calls :func:`decode`.

**Decoder.** Every 8-bit JPEG that cv2 5.0.0 (libjpeg-turbo 3.1.2) reads:
sequential and progressive frames, Huffman-coded (SOF0, SOF1, SOF2) or
arithmetic-coded (SOF9, SOF10: ``jdarith.c``'s decoder with the Qe table
of ``jaricom.c``, DAC conditioning, statistics reset at each restart), and
lossless frames (SOF3: ``jdlhuff.c``'s differences, predictors 1-7 and the
point transform of ``jdlossls.c``); progressive scans of all four kinds (DC
first and refinement, AC first with end-of-band runs, AC refinement with
correction bits; the coefficients gather across scans, then go through the
same IDCT); gray, three components (YCbCr, or RGB by an Adobe transform 0
or the component ids 'R', 'G', 'B' without JFIF, as ``jdapimin.c``
decides) and four (CMYK, or YCCK by an Adobe transform 2); any sampling
factors 1..4 whose ratio to the largest is integral (4:1:1, 4:4:0 and the
rest; a fractional ratio raises where an output needs the component, as
libjpeg's ``jinit_upsampler`` does); restart intervals, any image size. A
scan that names a Huffman table no DHT segment defined gets the Annex K
table of its number (0 luma, 1 chroma), as libjpeg-turbo's ``jstdhuff.c``
does (Motion-JPEG frames often carry no DHT). It follows what libjpeg-turbo
does by default, which is how cv2 decodes:

* the ISLOW integer IDCT (``jidctint.c``), vectorised over all blocks, with
  its ``DESCALE`` rounding and its post-IDCT range-limit table;
* upsampling as ``jinit_upsampler`` picks it (``jdsample.c``): "fancy"
  triangular h2v1 with rounding biases 1 and 2, h2v2 with biases 8 and 7,
  h1v2 (4:4:0) with biases 1 and 2, the image edges replicated; a component
  no wider than 2 samples at h2v1 / h2v2, and every other integral ratio
  (4:1:1 among them), replicated; a lossless file replicated at every ratio
  (libjpeg upsamples without an IDCT so);
* the fixed-point YCbCr -> RGB tables of ``jdcolor.c`` (16 fraction bits);
  RGB-coded planes are only reordered; YCCK becomes CMYK by
  ``ycck_cmyk_convert``, and CMYK becomes BGR by cv2's own rule
  (:func:`cmyk_to_bgr`, measured against cv2 5.0.0);
* a gray image gives one plane (``imdecode`` replicates it for colour);
* a lossless file converts no colour (:func:`check_conversion`: cv2 returns
  None for a YCbCr-coded one, and for a gray one under IMREAD_COLOR).

libjpeg-turbo smooths the blocks of a progressive image only while some of
their first coefficients still lack bits (``jdcoefct.c::smoothing_ok``); a
file whose scans leave them so raises here, and a complete one is not
smoothed, so no smoothing is done (measured against cv2 in the tests).

So the pixels equal cv2's bit for bit (``tests/test_torch_jpeg.py`` over
the committed forms of ``tests/fixtures/jpeg_forms/``, written by
libjpeg-turbo's and GDCM's IJG writers). The entropy stages are Python
loops: Huffman over 16-bit lookup tables, arithmetic decision by decision;
fine at test sizes and for checks, slow at 1024x2048 (about a second;
progressive and arithmetic files more). 12-bit, arithmetic-coded lossless
and hierarchical files raise :class:`JpegError` (cv2 returns None for
12-bit; no writer here makes the other two).
The APP1 Exif ``Orientation`` tag (values 2-8) is applied after the colour
conversion, a flip or a transpose, as ``cv2.imread`` and ``cv2.imdecode``
do under ``IMREAD_COLOR``. :func:`decode_planes` stops before the upsampling
and returns the cropped component planes, which is what the card's colour
kernel (``csrc/jpeg.cu``) takes from nvJPEG; :func:`lossless_planes` is the
card's host stage for lossless files and :func:`transcode_baseline` its
rewrite of arithmetic-coded and progressive-with-restart files as one
baseline Huffman scan for nvJPEG.

**Encoder.** Baseline JFIF, the Annex K quantisation tables scaled by the IJG
quality rule, 4:2:0 (cv2's default), 4:2:2, 4:4:4 or gray, the standard
Huffman tables, no restart markers; ``progressive=True`` writes the same
quantised coefficients as a progressive file (spectral selection only: one
DC scan, then one AC scan per component). The DCT is an exact float DCT rounded to the
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


#: images :func:`decode` has decoded, and images :func:`encode` has encoded;
#: a caller may reset them to 0 (the card's paths must leave them there)
decodes = 0
encodes = 0


#: zigzag index -> natural (row-major) index in an 8x8 block
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

#: frame markers neither decoder here reads: hierarchical (differential)
#: frames and arithmetic-coded lossless ones
_SOF_UNSUPPORTED = {
    0xC5: "differential sequential", 0xC6: "differential progressive", 0xC7: "differential lossless",
    0xCB: "arithmetic-coded lossless", 0xCD: "differential arithmetic sequential",
    0xCE: "differential arithmetic progressive", 0xCF: "differential arithmetic lossless",
}
#: frame markers read here: (coding, process)
_SOF = {0xC0: ("huffman", "sequential"), 0xC1: ("huffman", "sequential"), 0xC2: ("huffman", "progressive"),
        0xC3: ("huffman", "lossless"), 0xC9: ("arithmetic", "sequential"),
        0xCA: ("arithmetic", "progressive")}
#: libjpeg's largest sampling factor (MAX_SAMP_FACTOR) and blocks in an
#: interleaved MCU (D_MAX_BLOCKS_IN_MCU)
_MAX_SAMP = 4
_MAX_MCU_BLOCKS = 10


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


def _scan_units(frame, ids) -> list:
    """The scan's MCUs in order, each the (component, block row, block
    column) of its blocks: a one-component scan walks the component's own
    block grid (ceil of its size over 8), an interleaved one the frame's
    MCUs."""
    comps = frame["comps"]
    if len(ids) == 1:  # non-interleaved: the component's own block grid
        c = ids[0]
        bw = _ceil_div(_ceil_div(frame["width"] * comps[c]["h"], frame["hmax"]), 8)
        bh = _ceil_div(_ceil_div(frame["height"] * comps[c]["v"], frame["vmax"]), 8)
        return [[(c, by, bx)] for by in range(bh) for bx in range(bw)]
    units = []
    for my in range(frame["mcuy"]):
        for mx in range(frame["mcux"]):
            unit = []
            for c in ids:
                h, v = comps[c]["h"], comps[c]["v"]
                for yy in range(v):
                    for xx in range(h):
                        unit.append((c, my * v + yy, mx * h + xx))
            units.append(unit)
    return units


def _intervals(segs, units, restart):
    """(units, bit windows, bytes) of each restart interval of a scan."""
    per_seg = restart if restart else len(units)
    nseg = _ceil_div(len(units), per_seg) if units else 0
    if len(segs) < nseg:
        segs = list(segs) + [b""] * (nseg - len(segs))
    for si in range(nseg):
        yield units[si * per_seg:(si + 1) * per_seg], _windows(segs[si]), len(segs[si])


def _decode_scan(segs, scan, frame, restart, coefs):
    """Huffman-decode one sequential scan into the components' coefficient
    arrays (``coefs[c]``: (nbh, nbw, 64) int32, natural order)."""
    ids = [c for c, _, _ in scan]
    tables = {c: (dc, ac) for c, dc, ac in scan}
    for units, w, nbytes in _intervals(segs, _scan_units(frame, ids), restart):
        pos_l, val_l = [], []
        try:
            nbits = _decode_units(units, w, tables, {c: coefs[c].shape[1] for c in ids}, pos_l, val_l)
        except IndexError:
            nbits = None
        if nbits is None or nbits > 8 * nbytes:
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


#: libjpeg's natural order with 16 entries of 63 past the end, where a
#: corrupt run may index
_NATURAL_PAD = _NATURAL + [63] * 16


def _decode_progressive_scan(segs, scan, frame, restart, coefs, widths, band):
    """Huffman-decode one progressive scan (``jdphuff.c``) into the
    components' flat coefficient lists (``coefs[c]``, natural order), in
    place. ``band`` is the scan's (Ss, Se, Ah, Al)."""
    ids = [c for c, _, _ in scan]
    tables = {c: (dc, ac) for c, dc, ac in scan}
    for units, w, nbytes in _intervals(segs, _scan_units(frame, ids), restart):
        try:
            nbits = _progressive_units(units, w, tables, widths, coefs, *band)
        except IndexError:
            nbits = None
        if nbits is None or nbits > 8 * nbytes:
            raise JpegError("corrupt JPEG data: the scan ends early")


def _progressive_units(units, w, tables, widths, coefs, ss, se, ah, al) -> int:
    """One restart interval of a progressive scan: DC first (the difference
    scaled by 2**Al), DC refinement (one bit), AC first (end-of-band runs
    over blocks) or AC refinement (a correction bit for each coefficient
    already nonzero, new coefficients of +-2**Al); returns the bits read."""
    masks, natural = _MASKS, _NATURAL_PAD
    p = 0
    if ss == 0:  # DC scans, interleaved or not
        pred = {}
        for unit in units:
            for c, by, bx in unit:
                blk, i = coefs[c], (by * widths[c] + bx) * 64
                if ah:
                    if (w[p >> 3] >> (39 - (p & 7))) & 1:
                        blk[i] |= 1 << al
                    p += 1
                    continue
                t = tables[c][0][(w[p >> 3] >> (24 - (p & 7))) & 0xFFFF]
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
                blk[i] = v << al
        return p
    eobrun = 0
    p1, m1 = 1 << al, -(1 << al)
    for (c, by, bx), in units:  # an AC scan holds one component
        ac_lut, blk = tables[c][1], coefs[c]
        base = (by * widths[c] + bx) * 64
        k = ss
        if not ah:  # AC first
            if eobrun:
                eobrun -= 1
                continue
            while k <= se:
                t = ac_lut[(w[p >> 3] >> (24 - (p & 7))) & 0xFFFF]
                if not t:
                    raise JpegError("corrupt JPEG data: bad AC Huffman code")
                p += t >> 8
                r, s = (t & 255) >> 4, t & 15
                if s:
                    k += r
                    v = (w[p >> 3] >> (40 - (p & 7) - s)) & masks[s]
                    p += s
                    if v < (1 << (s - 1)):
                        v -= masks[s]
                    blk[base + natural[k]] = v << al
                elif r == 15:
                    k += 15
                else:  # EOBr: this block and 2**r + r more bits - 1 after it
                    eobrun = 1 << r
                    if r:
                        eobrun += (w[p >> 3] >> (40 - (p & 7) - r)) & masks[r]
                        p += r
                    eobrun -= 1
                    break
                k += 1
            continue
        # AC refinement
        if not eobrun:
            while k <= se:
                t = ac_lut[(w[p >> 3] >> (24 - (p & 7))) & 0xFFFF]
                if not t:
                    raise JpegError("corrupt JPEG data: bad AC Huffman code")
                p += t >> 8
                r, s = (t & 255) >> 4, t & 15
                if s:  # a newly nonzero coefficient, its sign in one bit
                    s = p1 if (w[p >> 3] >> (39 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (w[p >> 3] >> (40 - (p & 7) - r)) & masks[r]
                        p += r
                    break  # the rest of the block goes with the run
                # pass the nonzero coefficients (a correction bit each) and r
                # zero ones
                while k <= se:
                    i = base + natural[k]
                    cur = blk[i]
                    if cur:
                        if (w[p >> 3] >> (39 - (p & 7))) & 1 and not cur & p1:
                            blk[i] = cur + p1 if cur >= 0 else cur + m1
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    blk[base + natural[k]] = s
                k += 1
        if eobrun:  # inside a run: correction bits for the nonzero ones left
            while k <= se:
                i = base + natural[k]
                cur = blk[i]
                if cur:
                    if (w[p >> 3] >> (39 - (p & 7))) & 1 and not cur & p1:
                        blk[i] = cur + p1 if cur >= 0 else cur + m1
                    p += 1
                k += 1
            eobrun -= 1
    return p


# ------------------------------------------------------------------ arithmetic

#: jaricom.c's ``jpeg_aritab`` (Table D.2 of T.81): (Qe, next index after
#: an LPS, next index after an MPS, switch the MPS sense); the last entry is
#: the fixed 0.5 bin of T.851 that libjpeg codes signs and refinements with
_ARITAB = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0),
    (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0), (0x001a, 33, 10, 0),
    (0x000d, 35, 11, 0), (0x0006, 9, 12, 0), (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0), (0x0406, 49, 25, 0),
    (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0),
    (0x002c, 33, 9, 0), (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0), (0x0861, 78, 49, 0), (0x0706, 79, 50, 0),
    (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0),
    (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1),
    (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0),
    (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0), (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0), (0x34ee, 91, 85, 0),
    (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0),
    (0x56a8, 95, 96, 1), (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0), (0x5597, 110, 109, 0), (0x504f, 111, 107, 0),
    (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]
_QE = [q for q, _, _, _ in _ARITAB]
_NEXT_LPS = [(switch << 7) | lps for _, lps, _, switch in _ARITAB]  # the sense switch in bit 7
_NEXT_MPS = [mps for _, _, mps, _ in _ARITAB]
#: statistics bins per DC and per AC conditioning table (jdarith.c)
_DC_BINS, _AC_BINS = 64, 256
#: the default conditioning (L, U) of a DC table and Kx of an AC table
_DAC_DEFAULT = (0, 1, 5)


class _Arith:
    """``jdarith.c``'s decoder over one restart interval's bytes (stuffing
    removed): the C register holds the interval's base and the bits not yet
    used, ``ct`` counts those bits. Past the interval's last byte it reads
    zeros, as libjpeg does once it meets a marker."""

    __slots__ = ("data", "n", "pos", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.data, self.n, self.pos, self.c, self.a, self.ct = data, len(data), 0, 0, 0, -16

    def __call__(self, st, i: int) -> int:
        """One binary decision with the statistics bin ``st[i]`` (updated)."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:  # renormalise, reading a byte when the bits run out (D.2.6)
            ct -= 1
            if ct < 0:
                if self.pos < self.n:
                    c = (c << 8) | self.data[self.pos]
                    self.pos += 1
                else:
                    c <<= 8
                ct += 8
                if ct < 0:  # the first two bytes
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        k = sv & 0x7F
        qe = _QE[k]
        a -= qe
        temp = a << ct
        if c >= temp:  # the LPS interval, or an MPS after a conditional exchange (D.2.4, D.2.5)
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ _NEXT_MPS[k]
            else:
                st[i] = (sv & 0x80) ^ _NEXT_LPS[k]
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ _NEXT_LPS[k]
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ _NEXT_MPS[k]
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _arith_corrupt():
    return JpegError("corrupt JPEG data: an arithmetic-coded magnitude or run overflows")


def _arith_dc(dec, st, ctx, cond):
    """A DC difference (F.1.4.4.1): (difference, the next conditioning
    context). ``st`` is the table's bins, ``ctx`` the component's context,
    ``cond`` the table's (L, U)."""
    if not dec(st, ctx):
        return 0, 0
    sign = dec(st, ctx + 1)
    i = ctx + 2 + sign
    m = dec(st, i)
    if m:
        i = 20
        while dec(st, i):
            m <<= 1
            if m == 0x8000:
                raise _arith_corrupt()
            i += 1
    if m < (1 << cond[0]) >> 1:
        nxt = 0
    elif m > (1 << cond[1]) >> 1:
        nxt = 12 + 4 * sign
    else:
        nxt = 4 + 4 * sign
    v = m
    i += 14
    while m > 1:
        m >>= 1
        if dec(st, i):
            v |= m
    v += 1
    return (-v if sign else v), nxt


def _arith_ac(dec, st, fixed, blk, base, ss, se, kx, al, natural):
    """AC coefficients ss..se of one block (F.1.4.4.2), each written as
    ``v << al`` at its natural index."""
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if dec(st, i):  # end of block
            return
        while not dec(st, i + 1):
            i += 3
            k += 1
            if k > se:
                raise _arith_corrupt()
        sign = dec(fixed, 0)
        i += 2
        m = dec(st, i)
        if m and dec(st, i):
            m <<= 1
            i = 189 if k <= kx else 217
            while dec(st, i):
                m <<= 1
                if m == 0x8000:
                    raise _arith_corrupt()
                i += 1
        v = m
        i += 14
        while m > 1:
            m >>= 1
            if dec(st, i):
                v |= m
        v += 1
        blk[base + natural[k]] = (-v if sign else v) << al
        k += 1


def _arith_ac_refine(dec, st, fixed, blk, base, ss, se, al, natural):
    """An AC refinement of one block: a correction bit for each coefficient
    already nonzero, new coefficients of +-2**al, the end-of-block flag
    tested only past the previous stage's last nonzero one (EOBx)."""
    p1, m1 = 1 << al, -(1 << al)
    kex = se
    while kex > 0 and not blk[base + natural[kex]]:
        kex -= 1
    k = ss
    while k <= se:
        i = 3 * (k - 1)
        if k > kex and dec(st, i):
            return
        while True:
            j = base + natural[k]
            cur = blk[j]
            if cur:
                if dec(st, i + 2):
                    blk[j] = cur + (m1 if cur < 0 else p1)
                break
            if dec(st, i + 1):
                blk[j] = m1 if dec(fixed, 0) else p1
                break
            i += 3
            k += 1
            if k > se:
                raise _arith_corrupt()
        k += 1


def _wrap16(v: int) -> int:
    """A JCOEF (int16) cast."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _decode_arith_scan(segs, scan, frame, restart, coefs, widths, band, progressive, conditioning):
    """One arithmetic-coded scan (``jdarith.c``), sequential or any of the
    four progressive kinds, into the components' flat coefficient lists.
    ``scan`` is [(component, DC table, AC table)]; statistics live per
    table, the DC context and last value per component; each restart
    interval starts them afresh."""
    ss, se, ah, al = band
    natural = _NATURAL_PAD
    ids = [c for c, _, _ in scan]
    dc_tab = {c: d for c, d, _ in scan}
    ac_tab = {c: a for c, _, a in scan}
    dc_first = not progressive or (ss == 0 and ah == 0)
    ac_used = not progressive or ss > 0
    fixed = bytearray([113])
    units_all = _scan_units(frame, ids)
    per = restart if restart else len(units_all)
    nseg = _ceil_div(len(units_all), per) if units_all else 0
    for si in range(nseg):
        dec = _Arith(segs[si] if si < len(segs) else b"")
        dc_stats = {t: bytearray(_DC_BINS) for t in set(dc_tab.values())} if dc_first else {}
        ac_stats = {t: bytearray(_AC_BINS) for t in set(ac_tab.values())} if ac_used else {}
        last = dict.fromkeys(ids, 0)
        ctx = dict.fromkeys(ids, 0)
        for unit in units_all[si * per:(si + 1) * per]:
            for c, by, bx in unit:
                blk, base = coefs[c], (by * widths[c] + bx) * 64
                if progressive and ss == 0 and ah:  # DC refinement: the next bit, fixed bin
                    if dec(fixed, 0):
                        blk[base] |= 1 << al
                    continue
                if dc_first and ss == 0:
                    t = dc_tab[c]
                    v, ctx[c] = _arith_dc(dec, dc_stats[t], ctx[c], conditioning["dc"].get(t, _DAC_DEFAULT[:2]))
                    if v:
                        last[c] = _wrap16(last[c] + v)
                    blk[base] = _wrap16(last[c] << al) if progressive else last[c]
                    if progressive:
                        continue
                t = ac_tab[c]
                if progressive and ah:
                    _arith_ac_refine(dec, ac_stats[t], fixed, blk, base, ss, se, al, natural)
                else:
                    _arith_ac(dec, ac_stats[t], fixed, blk, base, max(ss, 1), se if progressive else 63,
                              conditioning["ac"].get(t, _DAC_DEFAULT[2]), al if progressive else 0, natural)


# ------------------------------------------------------------------ lossless


def _lossless_differences(w, n_units, luts) -> Tuple[list, int]:
    """Huffman-decode ``n_units`` MCUs of a lossless scan (``jdlhuff.c``),
    one difference per entry of ``luts`` (the DC table of each sample of the
    MCU, in order): SSSS 0-15 with that many extra bits, 16 meaning 32768
    with none. Returns the differences and the bits read."""
    masks = _MASKS
    out = []
    p = 0
    for _ in range(n_units):
        for lut in luts:
            t = lut[(w[p >> 3] >> (24 - (p & 7))) & 0xFFFF]
            if not t:
                raise JpegError("corrupt JPEG data: bad lossless Huffman code")
            p += t >> 8
            s = t & 255
            if s == 0:
                out.append(0)
            elif s == 16:
                out.append(32768)
            else:
                v = (w[p >> 3] >> (40 - (p & 7) - s)) & masks[s]
                p += s
                out.append(v - masks[s] if v < (1 << (s - 1)) else v)
    return out, p


def _decode_lossless_scan(segs, scan, frame, restart, diffs):
    """One lossless scan's differences into each component's (rows, cols)
    grid ``diffs[c]`` (MCU padding included): an interleaved scan walks the
    frame's MCUs (h x v samples of each component), a one-component scan the
    component's own sample grid. Returns the grid rows at which a restart
    interval starts, per component (each must start an MCU row, as libjpeg's
    lossless coder requires)."""
    ids = [c for c, _, _ in scan]
    comps = frame["comps"]
    luts = {c: dc for c, dc, _ in scan}
    if len(ids) == 1:
        c = ids[0]
        ch = _ceil_div(frame["height"] * comps[c]["v"], frame["vmax"])
        cw = _ceil_div(frame["width"] * comps[c]["h"], frame["hmax"])
        grid, row_units, per_unit = (ch, cw), cw, [luts[c]]
        shape = {c: (1, 1)}
    else:
        grid, row_units = (frame["mcuy"], frame["mcux"]), frame["mcux"]
        per_unit = [luts[c] for c in ids for _ in range(comps[c]["h"] * comps[c]["v"])]
        shape = {c: (comps[c]["v"], comps[c]["h"]) for c in ids}
    n = grid[0] * grid[1]
    per = restart or n
    if restart and restart % row_units:
        raise JpegError(f"lossless JPEG with a restart interval of {restart} samples, not a whole number of "
                        f"rows of {row_units}, is not supported")
    flat, starts = [], []
    for si in range(_ceil_div(n, per)):
        seg = segs[si] if si < len(segs) else b""
        count = min(per, n - si * per)
        try:
            vals, nbits = _lossless_differences(_windows(seg), count, per_unit)
        except IndexError:
            nbits = None
        if nbits is None or nbits > 8 * len(seg):
            raise JpegError("corrupt JPEG data: the scan ends early")
        flat += vals
        starts.append(si * per // row_units)
    a = np.asarray(flat, np.int64).reshape(grid[0], grid[1], -1)
    k = 0
    rows = {}
    for c in ids:
        v, h = shape[c]
        part = a[:, :, k:k + v * h].reshape(grid[0], grid[1], v, h).transpose(0, 2, 1, 3)
        full = part.reshape(grid[0] * v, grid[1] * h)
        diffs[c][:full.shape[0], :full.shape[1]] = full
        k += v * h
        rows[c] = [r * v for r in starts]
    return rows


def _undifference(d: np.ndarray, predictor: int, pt: int, first_rows) -> np.ndarray:
    """``jdlossls.c``'s undifferencing of one component's (rows, cols)
    differences, modulo 2**16: the first row of the scan and of each restart
    interval predicts its first sample as 2**(P - Pt - 1) and the rest from
    the left (predictor 1); every other row predicts its first sample from
    above (predictor 2) and the rest by ``predictor`` (1 Ra, 2 Rb, 3 Rc, 4
    Ra + Rb - Rc, 5 Ra + ((Rb - Rc) >> 1), 6 Rb + ((Ra - Rc) >> 1), 7 (Ra +
    Rb) >> 1). Predictors 1 and 2 are cumulative sums over the whole grid,
    3, 4 and 5 one vector step a row, 6 and 7 a loop over the samples."""
    mask = 0xFFFF
    rows, cols = d.shape
    x = np.empty_like(d)
    bounds = sorted(set(first_rows) | {0}) + [rows]
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        if r0 >= rows:
            break
        x[r0] = ((1 << (8 - pt - 1)) + np.cumsum(d[r0])) & mask
        if r1 - r0 == 1:
            continue
        blk = d[r0 + 1:r1]
        if predictor == 1:
            col0 = x[r0, 0] + np.cumsum(blk[:, 0])
            rest = np.cumsum(blk[:, 1:], axis=1)
            x[r0 + 1:r1, 0] = col0 & mask
            x[r0 + 1:r1, 1:] = (col0[:, None] + rest) & mask
        elif predictor == 2:
            x[r0 + 1:r1] = (x[r0] + np.cumsum(blk, axis=0)) & mask
        elif predictor in (3, 4, 5):
            for y in range(r0 + 1, r1):
                up = x[y - 1]
                first = (d[y, 0] + up[0]) & mask
                x[y, 0] = first
                if predictor == 3:
                    x[y, 1:] = (d[y, 1:] + up[:-1]) & mask
                else:
                    step = up[1:] - up[:-1] if predictor == 4 else (up[1:] - up[:-1]) >> 1
                    x[y, 1:] = (first + np.cumsum(d[y, 1:] + step)) & mask
        elif predictor in (6, 7):
            for y in range(r0 + 1, r1):
                up, dy = x[y - 1].tolist(), d[y].tolist()
                ra = (dy[0] + up[0]) & mask
                row = [ra]
                if predictor == 6:
                    for j in range(1, cols):
                        ra = (dy[j] + up[j] + ((ra - up[j - 1]) >> 1)) & mask
                        row.append(ra)
                else:
                    for j in range(1, cols):
                        ra = (dy[j] + ((ra + up[j]) >> 1)) & mask
                        row.append(ra)
                x[y] = row
        else:
            raise JpegError(f"lossless JPEG predictor {predictor} does not exist (1-7 do)")
    return x


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


def _fancy_h1v2(c: np.ndarray) -> np.ndarray:
    """(h, w) uint8 -> (2h, w): 3/4 this row + 1/4 the nearer other one,
    biases 1 (upper) and 2 (lower), edges replicated
    (``h1v2_fancy_upsample``)."""
    x = c.astype(np.int32)
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.uint8)
    out[0::2] = (3 * x + up + 1) >> 2
    out[1::2] = (3 * x + down + 2) >> 2
    return out


def _upsample(c: np.ndarray, fh: int, fv: int, fancy: bool = True) -> np.ndarray:
    """A component plane up by integral factors (fh, fv), as
    ``jinit_upsampler`` picks the method: h2v1 and h2v2 fancy on a plane
    wider than 2 samples, h1v2 fancy, and replication for every other
    ratio (``h2v1_upsample``, ``h2v2_upsample``, ``int_upsample``) and for
    all of them when ``fancy`` is False (a lossless file: libjpeg does no
    fancy upsampling without an IDCT)."""
    if (fh, fv) == (1, 1):
        return c
    if fancy and (fh, fv) == (1, 2):
        return _fancy_h1v2(c)
    if fancy and c.shape[1] > 2 and (fh, fv) == (2, 1):
        return _fancy_h2v1(c)
    if fancy and c.shape[1] > 2 and (fh, fv) == (2, 2):
        return _fancy_h2v2(c)
    return np.repeat(np.repeat(c, fv, axis=0), fh, axis=1)


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
    #: the chroma's upsampling factors (horizontal, vertical): the second
    #: component's, (1, 1) for 4:4:4 and gray, (2, 1) for 4:2:2, (2, 2) for
    #: 4:2:0, (4, 1) for 4:1:1, (1, 2) for 4:4:0
    factors: Tuple[int, int]
    progressive: bool
    #: how the components are coded: "gray", "ycc" (YCbCr), "rgb" (Adobe
    #: transform 0, or no JFIF and component ids 'R', 'G', 'B'), "cmyk" or
    #: "ycck" (four components, by the Adobe transform), as ``jdapimin.c``
    #: decides
    color: str
    #: the Exif orientation, 1..8
    orientation: int
    #: each component's upsampling factors (horizontal, vertical); None for
    #: a fractional ratio (:func:`check_sampling`)
    upsampling: Tuple[Tuple[int, int], ...] = ()
    #: MCUs per restart interval before the first scan (0: none)
    restart: int = 0
    #: the entropy coding: "huffman" or "arithmetic"
    coding: str = "huffman"
    #: a lossless (SOF3) frame: predicted samples, no DCT
    lossless: bool = False


def _frame(body: bytes, lossless: bool = False) -> dict:
    """A frame header's fields; raises on a precision, component count or
    sampling factor that libjpeg (and so cv2) does not read as 8-bit
    samples (every factor 1..4). A component whose ratio to the largest
    factors is fractional gets upsampling None: libjpeg refuses it only
    when an output needs that component (:func:`check_sampling`)."""
    precision, height, width, ncomp = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise JpegError(f"{precision}-bit JPEG is not supported (8-bit is; cv2 reads no other)")
    if ncomp not in (1, 3, 4):
        raise JpegError(f"JPEG with {ncomp} components is not supported (gray, three and four are)")
    if height == 0 or width == 0:
        raise JpegError("JPEG frame has a zero dimension")
    comps, order = {}, []
    for k in range(ncomp):
        cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
        comps[cid] = {"h": hv >> 4, "v": hv & 15, "tq": tq}
        order.append(cid)
    factors = ", ".join(f"{comps[k]['h']}x{comps[k]['v']}" for k in order)
    if any(not (1 <= c["h"] <= _MAX_SAMP and 1 <= c["v"] <= _MAX_SAMP) for c in comps.values()):
        raise JpegError(f"JPEG sampling factors {factors} are not supported (each lies in 1..{_MAX_SAMP})")
    if ncomp == 1:
        comps[order[0]].update(h=1, v=1)
    hmax = max(c["h"] for c in comps.values())
    vmax = max(c["v"] for c in comps.values())
    for c in comps.values():  # a fractional ratio: None (see check_sampling)
        c["up"] = None if hmax % c["h"] or vmax % c["v"] else (hmax // c["h"], vmax // c["v"])
    unit = 1 if lossless else 8
    return {"height": height, "width": width, "comps": comps, "order": order, "hmax": hmax, "vmax": vmax,
            "mcux": _ceil_div(width, unit * hmax), "mcuy": _ceil_div(height, unit * vmax)}


def _color(frame: dict, jfif: bool, adobe_transform) -> str:
    """libjpeg-turbo's ``default_decompress_parms``: JFIF means YCbCr; else an
    Adobe transform decides (0 RGB, else YCbCr; for four components 0 CMYK,
    else YCCK); else the component ids ('R', 'G', 'B' is RGB)."""
    n = len(frame["order"])
    if n == 1:
        return "gray"
    if n == 4:
        return "cmyk" if adobe_transform in (None, 0) else "ycck"
    if jfif:
        return "ycc"
    if adobe_transform is not None:
        return "rgb" if adobe_transform == 0 else "ycc"
    return "rgb" if frame["order"] == [ord("R"), ord("G"), ord("B")] else "ycc"


def _info(frame: dict, sof: int, jfif: bool, adobe, orientation: int, restart: int) -> Info:
    coding, process = _SOF[sof]
    up = tuple(frame["comps"][c]["up"] for c in frame["order"])
    return Info(frame["height"], frame["width"], len(frame["order"]), (up[1] if len(up) > 1 else None) or (1, 1),
                process == "progressive", _color(frame, jfif, adobe), orientation, up, restart, coding,
                process == "lossless")


def read_info(data) -> Info:
    """The header of a JPEG stream without decoding it: sizes, chroma
    factors, progressive or not, the coding, lossless or not, the colour
    space and the Exif orientation. Raises :class:`JpegError` on a form the
    decoders do not read (hierarchical, arithmetic-coded lossless, 12-bit,
    fractional sampling factors)."""
    data = bytes(data)
    _check_soi(data)
    jfif, adobe, orientation, frame, sof, restart = False, None, 1, None, None, 0
    for marker, body, _ in _segments(data, 2):
        if marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE1 and body[:6] == b"Exif\x00\x00" and orientation == 1:
            orientation = _exif_orientation(body)
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker in _SOF_UNSUPPORTED:
            raise JpegError(f"{_SOF_UNSUPPORTED[marker]} JPEG is not supported")
        elif marker in _SOF:
            frame, sof = _frame(body, marker == 0xC3), marker
        elif marker == 0xDA:
            break
    if frame is None:
        raise JpegError("JPEG stream has no frame header before its first scan")
    return _info(frame, sof, jfif, adobe, orientation, restart)


def _dht_tables(body: bytes):
    """(class, number, BITS, HUFFVAL) of each table in a DHT segment."""
    i = 0
    while i < len(body):
        tc, th = body[i] >> 4, body[i] & 15
        bits = list(body[i + 1:i + 17])
        n = sum(bits)
        yield tc, th, bits, list(body[i + 17:i + 17 + n])
        i += 17 + n


#: Annex K's table for each (class, number) a scan may use undefined
#: (``jstdhuff.c``: number 0 the luma tables, 1 the chroma ones)
_STD_BY_SLOT = {(0, 0): "dc_luma", (1, 0): "ac_luma", (0, 1): "dc_chroma", (1, 1): "ac_chroma"}


def _std_table(tc: int, th: int):
    if (tc, th) not in _STD_BY_SLOT:
        raise JpegError(f"JPEG scan uses Huffman table {th}, which is not defined")
    return STD_HUFFMAN[_STD_BY_SLOT[(tc, th)]]


def with_default_huffman(data) -> bytes:
    """``data`` with a DHT segment after SOI holding Annex K's table for
    every (class, number) a scan uses before any DHT defines it, so a
    decoder without libjpeg's fallback (nvJPEG) reads it; ``data`` itself
    when no scan needs one (a later DHT still replaces a table, as in
    libjpeg)."""
    data = bytes(data)
    _check_soi(data)
    defined, missing, progressive, frame_components = set(), [], False, 0
    gen = _segments(data, 2)
    while True:
        marker, body, pos = next(gen, (None, None, None))
        if marker is None:
            break
        if marker == 0xC4:
            defined |= {(tc, th) for tc, th, _, _ in _dht_tables(body)}
        elif marker in (0xC0, 0xC1, 0xC2):
            progressive, frame_components = marker == 0xC2, body[5]
        elif marker == 0xDA:
            ns = body[0]
            ss, se, ah = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4
            for k in range(ns):
                t = body[2 + 2 * k]
                used = [(0, t >> 4), (1, t & 15)]
                if progressive:
                    used = [] if (ss == 0 and ah) else [(0, t >> 4)] if ss == 0 else [(1, t & 15)]
                missing += [u for u in used if u not in defined and u not in missing]
            if not progressive and not missing and ns == frame_components:
                return data  # one sequential scan of every component: nothing further is read
            gen = _segments(data, _entropy_segments(data, pos)[1])
    if not missing:
        return data
    body = b"".join(bytes([(tc << 4) | th]) + bytes(_std_table(tc, th)[0]) + bytes(_std_table(tc, th)[1])
                    for tc, th in missing)
    return data[:2] + struct.pack(">BBH", 0xFF, 0xC4, len(body) + 2) + body + data[2:]


class Planes(NamedTuple):
    """A decoded image before upsampling: its component planes, each
    cropped to the component's own size (``ceil(H * v / vmax)`` by
    ``ceil(W * h / hmax)``), and the image's :class:`Info`."""

    planes: List[np.ndarray]
    info: Info


#: coefficients whose missing bits make libjpeg-turbo smooth a progressive
#: image's blocks (``jdcoefct.c``: the DC and the first 9 AC, SAVED_COEFS)
_SMOOTHED = 10


class _Parsed(NamedTuple):
    """A stream read up to its coefficients (or, lossless, its samples)."""

    frame: dict
    info: Info
    #: per component id: quantised coefficients in natural order (a flat
    #: list or an (nbh, nbw, 64) array), or the lossless sample grid
    coefs: dict
    #: per component id: its quantisation table (natural order)
    q: dict
    #: per table number: its precision as written (0 8-bit, 1 16-bit)
    q_precision: dict
    #: every APPn segment before the first scan, marker and length included
    app: list


def _parse(data) -> _Parsed:
    """Read every marker segment and scan of a stream: Huffman or arithmetic
    entropy decoding into quantised coefficients, or a lossless stream into
    its samples."""
    data = bytes(data)
    qtables: Dict[int, np.ndarray] = {}
    q_precision: Dict[int, int] = {}
    dc_tables: Dict[int, list] = {}
    ac_tables: Dict[int, list] = {}
    conditioning = {"dc": {}, "ac": {}}  # DAC: DC table -> (L, U), AC table -> Kx
    frame = None
    sof = None
    restart = 0
    adobe_transform = None
    jfif = False
    orientation = 1
    coefs: Dict[int, object] = {}
    coef_bits: Dict[int, list] = {}  # progressive: each coefficient's Al so far, -1 before its first scan
    first_restart = None  # the interval at the first scan
    comp_q: Dict[int, np.ndarray] = {}
    app = []
    _check_soi(data)
    gen = _segments(data, 2)
    while True:
        try:
            marker, body, pos = next(gen)
        except StopIteration:
            break
        if 0xE0 <= marker <= 0xEF and first_restart is None:
            app.append(data[pos - len(body) - 4:pos])
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = (np.frombuffer(body[i + 1:i + 1 + n], ">u2") if pq
                        else np.frombuffer(body[i + 1:i + 1 + n], np.uint8)).astype(np.int64)
                q = np.zeros(64, np.int64)
                q[NATURAL_ORDER] = vals
                qtables[tq], q_precision[tq] = q, pq
                i += 1 + n
        elif marker == 0xC4:  # DHT
            for tc, th, bits, vals in _dht_tables(body):
                (ac_tables if tc else dc_tables)[th] = _lookup_table(bits, vals)
        elif marker == 0xCC:  # DAC: arithmetic conditioning (jdmarker.c's get_dac)
            for i in range(0, len(body) - 1, 2):
                index, val = body[i], body[i + 1]
                if index >= 32:
                    raise JpegError(f"JPEG DAC names table {index}")
                if index >= 16:
                    conditioning["ac"][index - 16] = val
                elif (val & 15) > (val >> 4):
                    raise JpegError(f"JPEG DAC conditioning {val:#04x}: L above U")
                else:
                    conditioning["dc"][index] = (val & 15, val >> 4)
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xE1 and body[:6] == b"Exif\x00\x00" and orientation == 1:
            orientation = _exif_orientation(body)
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker in _SOF_UNSUPPORTED:
            raise JpegError(f"{_SOF_UNSUPPORTED[marker]} JPEG is not supported (sequential, progressive and "
                            "lossless, Huffman or arithmetic-coded, are)")
        elif marker in _SOF:
            sof = marker
            lossless = marker == 0xC3
            frame = _frame(body, lossless)
            flat = _SOF[marker][0] == "arithmetic" or _SOF[marker][1] == "progressive"
            unit = 1 if lossless else 64
            for cid in frame["order"]:
                c = frame["comps"][cid]
                shape = (frame["mcuy"] * c["v"], frame["mcux"] * c["h"])
                coefs[cid] = (np.zeros(shape, np.int64) if lossless
                              else [0] * (shape[0] * shape[1] * unit) if flat else np.zeros(shape + (64,), np.int32))
                coef_bits[cid] = [-1] * 64
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise JpegError("JPEG scan before its frame header")
            coding, process = _SOF[sof]
            progressive, lossless = process == "progressive", process == "lossless"
            first_restart = restart if first_restart is None else first_restart
            ns = body[0]
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            ah, al = a >> 4, a & 15
            if lossless and not (1 <= ss <= 7 and ah == 0 and al < 8):
                raise JpegError(f"bad lossless JPEG scan (predictor {ss}, point transform {al})")
            if process == "sequential" and (ss, se, a) != (0, 63, 0):
                raise JpegError("sequential JPEG scan with a spectral band or successive approximation")
            if progressive and ((se != 0 if ss == 0 else (ss > se or se > 63 or ns != 1))
                                or (ah and al != ah - 1) or al > 13):
                raise JpegError(f"bad progressive JPEG scan (Ss {ss}, Se {se}, Ah {ah}, Al {al}, "
                                f"{ns} components)")
            ids = [body[1 + 2 * k] for k in range(ns)]
            if any(cid not in frame["comps"] for cid in ids):
                raise JpegError(f"JPEG scan names unknown components {ids}")
            blocks = sum(frame["comps"][c]["h"] * frame["comps"][c]["v"] for c in ids)
            if ns > 1 and blocks > _MAX_MCU_BLOCKS:
                raise JpegError(f"JPEG scan with {blocks} blocks in an MCU is not supported (libjpeg takes "
                                f"{_MAX_MCU_BLOCKS})")
            # the Huffman tables this scan reads: an undefined one is Annex K's
            need_dc = lossless or not progressive or (ss == 0 and not ah)
            need_ac = not lossless and (not progressive or ss > 0)
            scan = []
            for k, cid in enumerate(ids):
                t = body[2 + 2 * k]
                if coding == "arithmetic":
                    scan.append((cid, t >> 4, t & 15))
                else:
                    for need, tables, tc, th in ((need_dc, dc_tables, 0, t >> 4),
                                                 (need_ac, ac_tables, 1, t & 15)):
                        if need and th not in tables:
                            tables[th] = _lookup_table(*_std_table(tc, th))
                    scan.append((cid, dc_tables.get(t >> 4), ac_tables.get(t & 15)))
                if cid not in comp_q:
                    tq = frame["comps"][cid]["tq"]
                    if tq not in qtables and not lossless:
                        raise JpegError(f"JPEG quantization table {tq} is not defined")
                    comp_q[cid] = qtables.get(tq)
                coef_bits[cid][ss:se + 1] = [al] * (se + 1 - ss)
            segs, end = _entropy_segments(data, pos)
            widths = {cid: frame["mcux"] * frame["comps"][cid]["h"] for cid in frame["order"]}
            if lossless:
                diffs = {cid: np.zeros_like(coefs[cid]) for cid in ids}
                starts = _decode_lossless_scan(segs, scan, frame, restart, diffs)
                for cid in ids:
                    coefs[cid] = (_undifference(diffs[cid], ss, al, starts[cid]) << al) & 0xFF
            elif coding == "arithmetic":
                _decode_arith_scan(segs, scan, frame, restart, coefs, widths, (ss, se, ah, al), progressive,
                                   conditioning)
            elif progressive:
                _decode_progressive_scan(segs, scan, frame, restart, coefs, widths, (ss, se, ah, al))
            else:
                _decode_scan(segs, scan, frame, restart, coefs)
            gen = _segments(data, end)
    if frame is None or len(comp_q) != len(frame["order"]):
        raise JpegError("JPEG stream ends before every component was scanned")
    info = _info(frame, sof, jfif, adobe_transform, orientation, first_restart or 0)
    if info.progressive and all(coef_bits[c][0] >= 0 for c in frame["order"]) and any(
            b != 0 for c in frame["order"] for b in coef_bits[c][1:_SMOOTHED]):
        raise JpegError("progressive JPEG whose scans leave low coefficients without all their bits: "
                        "libjpeg smooths such blocks, which this decoder does not")
    return _Parsed(frame, info, coefs, comp_q, q_precision, app)


def _planes(p: _Parsed) -> List[np.ndarray]:
    """Each component's plane, cropped: the lossless samples, or the
    dequantised coefficients through the ISLOW IDCT."""
    frame, planes = p.frame, []
    for cid in frame["order"]:
        c = frame["comps"][cid]
        if p.info.lossless:
            plane = p.coefs[cid].astype(np.uint8)
        else:
            shape = (frame["mcuy"] * c["v"], frame["mcux"] * c["h"], 64)
            blocks = np.asarray(p.coefs[cid], np.int64).reshape(shape) * p.q[cid]
            nbh, nbw = blocks.shape[:2]
            pix = idct_islow(blocks.reshape(-1, 8, 8)).reshape(nbh, nbw, 8, 8)
            plane = pix.transpose(0, 2, 1, 3).reshape(nbh * 8, nbw * 8)
        dh = _ceil_div(frame["height"] * c["v"], frame["vmax"])
        dw = _ceil_div(frame["width"] * c["h"], frame["hmax"])
        planes.append(np.ascontiguousarray(plane[:dh, :dw]))
    return planes


def decode_planes(data) -> Planes:
    """JPEG bytes -> the component planes after the IDCT (a lossless file's
    samples), before upsampling, colour conversion and orientation (counted
    in :data:`decodes`)."""
    global decodes
    decodes += 1
    p = _parse(data)
    return Planes(_planes(p), p.info)


def lossless_planes(data) -> Planes:
    """A lossless JPEG's component planes as :func:`decode_planes` gives
    them, not counted in :data:`decodes`: the card's route for lossless
    files (no DCT for nvJPEG to run) reconstructs them on the host. Raises
    on any other file."""
    p = _parse(data)
    if not p.info.lossless:
        raise JpegError("lossless_planes reads lossless JPEG only")
    return Planes(_planes(p), p.info)


def check_sampling(info: Info, components=None):
    """Raise where a component an output needs (``components``: indices,
    all by default) has a fractional ratio to the largest sampling factors:
    libjpeg's ``jinit_upsampler`` refuses it and cv2 returns None. (A gray
    read of a YCbCr file needs the first component alone.)"""
    needed = range(info.components) if components is None else components
    if any(info.upsampling[k] is None for k in needed):
        raise JpegError(f"JPEG sampling factors with a fractional ratio ({info.upsampling}, None where it is "
                        "fractional) are not upsampled by libjpeg, and cv2 returns None")


def check_conversion(info: Info, output: str):
    """Raise where libjpeg-turbo refuses the colour conversion ``output``
    ("bgr" or "gray") asks of this file, so ``cv2.imdecode`` returns None:
    a lossless file converts no colour (measured against cv2 5.0.0: gray
    only to gray, RGB only to BGR, YCbCr and YCCK to nothing)."""
    if not info.lossless:
        return
    same = {"gray": "gray", "rgb": "bgr", "cmyk": "bgr"}.get(info.color)
    if same != output:
        raise JpegError(f"a lossless JPEG coded as {info.color} does not convert to {output} (libjpeg converts "
                        "no colour in a lossless file, and cv2 returns None)")


def cmyk_to_bgr(c: np.ndarray, m: np.ndarray, y: np.ndarray, k: np.ndarray) -> np.ndarray:
    """cv2's CMYK -> BGR after libjpeg's CMYK output (``icvCvt_CMYK2BGR``,
    as cv2 5.0.0 decodes, measured in ``tests/test_torch_jpeg.py``): each of
    C, M, Y becomes ``k - ((255 - v) * k >> 8)``, stored as R, G, B."""
    ki = k.astype(np.int32)
    r, g, b = (ki - (((255 - v.astype(np.int32)) * ki) >> 8) for v in (c, m, y))
    return np.stack([b, g, r], axis=-1).astype(np.uint8)


def ycck_to_cmyk(y, cb, cr, k):
    """libjpeg's ``ycck_cmyk_convert``: YCbCr to RGB by the colour tables,
    then C, M, Y = 255 - R, G, B (clamped), K as it is."""
    yi = y.astype(np.int64)
    rgb = (yi + _CR_R[cr], yi + ((_CB_G[cb] + _CR_G[cr]) >> 16), yi + _CB_B[cb])
    return [np.clip(255 - v, 0, 255).astype(np.uint8) for v in rgb] + [k]


def decode(data, apply_orientation: bool = True) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 BGR, or (H, W) uint8 for a gray image,
    turned by its Exif orientation unless ``apply_orientation`` is False (as
    ``cv2.imdecode`` under ``IMREAD_UNCHANGED``)."""
    planes, info = decode_planes(data)
    check_sampling(info)
    if info.lossless and info.color != "gray":
        check_conversion(info, "bgr")
    full = [_upsample(p, *f, fancy=not info.lossless)[:info.height, :info.width]
            for p, f in zip(planes, info.upsampling)]
    if info.color == "gray":
        img = full[0]
    elif info.color == "rgb":
        img = np.stack(full[::-1], axis=-1)
    elif info.color == "ycc":
        img = ycc_to_bgr(*full)
    else:
        img = cmyk_to_bgr(*(ycck_to_cmyk(*full) if info.color == "ycck" else full))
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


def _scan_events(blocks: np.ndarray, comp: np.ndarray, chroma: np.ndarray):
    """The Huffman events of blocks in scan order (``blocks`` (N, 64)
    zigzag-ordered quantised coefficients, ``comp`` each block's component
    index, ``chroma`` whether it takes Annex K's chroma tables): (sort keys,
    code bits, lengths) of the DC differences and of the AC run/size
    symbols, keyed block * 1024 + position, so that sorting them by key
    gives the scan's bit order."""
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
    for k in range(int(comp.max()) + 1):
        idx = np.flatnonzero(comp == k)
        diff[idx] = np.diff(dc[idx], prepend=0)
    s = _bit_size(diff)
    if int(s.max(initial=0)) > 11 or int(np.abs(blocks[:, 1:]).max(initial=0)) > 1023:
        raise JpegError("JPEG coefficients past 8-bit baseline's sizes (DC differences of 11 bits, AC of 10) "
                        "have no code in Annex K's tables")
    code, clen = lookup(dc_code, chroma, s)
    extra = np.where(diff < 0, diff - 1, diff) & ((1 << s) - 1)
    dc_events = (np.arange(nb, dtype=np.int64) * 1024, (code << s) | extra, clen + s)

    # AC: nonzero coefficients with their zero runs (ZRL for each 16 zeros);
    # event keys are block * 1024 + position in the block
    keys, vals, lens = [], [], []
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
    return dc_events, ac_events


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _std_dht(chroma: bool) -> List[bytes]:
    """DHT segments of Annex K's tables: luma as tables 0, and chroma as
    tables 1 when ``chroma``."""
    names = [("dc_luma", 0x00), ("ac_luma", 0x10)] + ([("dc_chroma", 0x01), ("ac_chroma", 0x11)] if chroma else [])
    return [_segment(0xC4, bytes([tc_th] + STD_HUFFMAN[name][0] + STD_HUFFMAN[name][1])) for name, tc_th in names]


#: luma sampling factors (horizontal, vertical) over 1x1 chroma
_SUBSAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}


def encode(img: np.ndarray, quality: int = 95, subsampling: str = "420", progressive: bool = False) -> bytes:
    """(H, W, 3) uint8 BGR or (H, W) gray -> JFIF JPEG bytes.
    ``subsampling``: "420" (cv2's default), "422" or "444" for colour.
    ``progressive``: the same quantised coefficients in a progressive file
    (SOF2): one interleaved DC scan, then one AC scan (1..63) per component,
    no successive approximation."""
    global encodes
    encodes += 1
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

    blocks[:, 1:] = np.clip(blocks[:, 1:], -1023, 1023)  # baseline AC sizes stop at 10 bits
    dc_events, ac_events = _scan_events(blocks, comp, chroma)

    def packed(events):
        order = np.argsort(events[0], kind="stable")
        return _pack(events[1][order], events[2][order])

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    ntab = 1 if gray else 2
    for t in range(ntab):
        out.append(_segment(0xDB, bytes([t]) + qt[t][NATURAL_ORDER].astype(np.uint8).tobytes()))
    ncomp = 1 if gray else 3
    sof = struct.pack(">BHHB", 8, H, W, ncomp) + bytes([1, (fh << 4) | fv, 0])
    if not gray:
        sof += bytes([2, 0x11, 1, 3, 0x11, 1])
    out.append(_segment(0xC2 if progressive else 0xC0, sof))
    out += _std_dht(chroma=not gray)
    tables = [(1, 0x00)] + ([] if gray else [(2, 0x11), (3, 0x11)])
    if not progressive:
        sos = bytes([ncomp]) + b"".join(bytes(t) for t in tables) + bytes([0, 63, 0])
        out += [_segment(0xDA, sos), packed(tuple(np.concatenate(x) for x in zip(dc_events, ac_events)))]
    else:
        out += [_segment(0xDA, bytes([ncomp]) + b"".join(bytes(t) for t in tables) + bytes([0, 0, 0])),
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
            out += [_segment(0xDA, bytes([1, cid, tab & 0x0F]) + bytes([1, 63, 0])), packed(events)]
    out.append(b"\xff\xd9")
    return b"".join(out)


# ------------------------------------------------------------------ transcode


def transcode_baseline(data) -> bytes:
    """A DCT-based JPEG (arithmetic-coded, progressive, or any Huffman
    form) rewritten as one interleaved sequential Huffman scan, as
    ``jpegtran`` would: the quantised coefficients unchanged, the
    quantisation tables as written (a 16-bit one makes the frame SOF1), the
    component ids and sampling factors, every APPn segment before the first
    scan (so JFIF, Exif orientation and the Adobe transform survive); Annex
    K's Huffman tables (luma for the first component, chroma for the rest),
    no restart intervals. The card sends the files nvJPEG refuses through
    this; the bit packing is :func:`encode`'s."""
    p = _parse(data)
    if p.info.lossless:
        raise JpegError("a lossless JPEG has no DCT coefficients to transcode")
    frame, order = p.frame, p.frame["order"]
    comps = frame["comps"]
    mcuy, mcux = frame["mcuy"], frame["mcux"]
    per_mcu = [comps[c]["h"] * comps[c]["v"] for c in order]
    if len(order) > 1 and sum(per_mcu) > _MAX_MCU_BLOCKS:
        raise JpegError(f"JPEG sampling factors with {sum(per_mcu)} blocks in an MCU do not fit one "
                        f"interleaved baseline scan ({_MAX_MCU_BLOCKS} do)")
    parts, comp = [], []
    for k, cid in enumerate(order):
        h, v = comps[cid]["h"], comps[cid]["v"]
        zz = np.asarray(p.coefs[cid], np.int64).reshape(mcuy * v, mcux * h, 64)[..., NATURAL_ORDER]
        parts.append(zz.reshape(mcuy, v, mcux, h, 64).transpose(0, 2, 1, 3, 4).reshape(mcuy * mcux, v * h, 64))
        comp += [k] * (v * h)
    blocks = np.concatenate(parts, axis=1).reshape(-1, 64)
    comp = np.tile(np.asarray(comp, np.int64), mcuy * mcux)
    dc_events, ac_events = _scan_events(blocks, comp, comp > 0)
    events = tuple(np.concatenate(x) for x in zip(dc_events, ac_events))
    ordered = np.argsort(events[0], kind="stable")
    scan = _pack(events[1][ordered], events[2][ordered])

    out = [b"\xff\xd8", *p.app]
    wide = False
    for tq in sorted({comps[c]["tq"] for c in order}):
        q = p.q[next(c for c in order if comps[c]["tq"] == tq)][NATURAL_ORDER]
        pq = p.q_precision.get(tq, 0)
        wide |= bool(pq)
        out.append(_segment(0xDB, bytes([(pq << 4) | tq]) + (q.astype(">u2") if pq else q.astype(np.uint8)).tobytes()))
    sof = struct.pack(">BHHB", 8, frame["height"], frame["width"], len(order)) + b"".join(
        bytes([c, (comps[c]["h"] << 4) | comps[c]["v"], comps[c]["tq"]]) for c in order)
    out.append(_segment(0xC1 if wide else 0xC0, sof))
    out += _std_dht(chroma=len(order) > 1)
    sos = bytes([len(order)]) + b"".join(bytes([c, 0x00 if k == 0 else 0x11]) for k, c in enumerate(order))
    out += [_segment(0xDA, sos + bytes([0, 63, 0])), scan, b"\xff\xd9"]
    return b"".join(out)
