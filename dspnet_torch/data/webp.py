"""WebP without cv2: libwebp's decoder as cv2 5.0.0's ``grfmt_webp.cpp``
calls it (``WebPDecodeBGR(A)Into``, default options), and a lossless
writer; measured in ``tests/test_torch_image_formats.py``.

The container: ``RIFF....WEBP`` with a ``VP8 `` (lossy, ``data/vp8.py``),
a ``VP8L`` (lossless, here) or a ``VP8X`` chunk (extended: ``ALPH`` alpha
beside ``VP8 ``, or an animation, ``ANIM`` and ``ANMF`` frames). An image
has alpha when the ``VP8X`` flags or the ``VP8L`` header say so; cv2 then
reads BGRA (``IMREAD_UNCHANGED``), otherwise BGR. An animation is read as
cv2 5's ``WebPAnimDecoder`` gives its first frame: the frame decoded at its
offset on a canvas of transparent black, BGRA. ``IMREAD_COLOR`` drops
alpha; ``IMREAD_GRAYSCALE`` is cv2 5's cvtColor (15-bit weights).

VP8L (RFC 9649): the prefix-coded image with its colour cache, LZ77
backward references with the 120-entry distance map, meta prefix codes,
and the four transforms undone in reverse order: predictor (14 modes, the
top-right of the last column being the row's first pixel), cross-colour,
subtract-green and colour indexing with pixel bundling.

ALPH: raw or VP8L-compressed (the green channel of a header-less VP8L
image), then the none, horizontal, vertical or gradient unfilter.

Write: VP8L, as cv2 writes by default with no quality given: one prefix
code group, subtract-green as the only transform, runs of equal pixels as
LZ77 copies at distance 1 and repeats of the row above at the width; cv2
reads it back to the same array (BGRA included, transparent pixels keeping
their colour, which cv2's own encoder does not).
"""

from __future__ import annotations

import struct

import numpy as np

from dspnet_torch.data import cvt_color, jpeg, vp8


class WebPError(ValueError):
    pass


# ------------------------------------------------------------------ bits


class _Bits:
    """LSB-first bit reader."""

    def __init__(self, data: bytes, pos: int = 0):
        self.buf = bytes(data) + b"\0" * 8
        self.n = len(data) * 8
        self.pos = pos * 8

    def read(self, k: int) -> int:
        if k == 0:
            return 0
        p = self.pos
        v = (int.from_bytes(self.buf[p >> 3:(p >> 3) + 4], "little") >> (p & 7)) & ((1 << k) - 1)
        self.pos = p + k
        if self.pos > self.n:
            raise WebPError("VP8L data ends early")
        return v


# ------------------------------------------------------------------ prefix codes

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


class _Code:
    """A canonical prefix code read LSB first: a table over ``bits`` bits of
    (symbol << 4 | length), or a single symbol read with no bits."""

    def __init__(self, lengths):
        lengths = np.asarray(lengths, np.int64)
        syms = np.nonzero(lengths)[0]
        if len(syms) == 0:
            raise WebPError("VP8L prefix code with no symbol")
        if len(syms) == 1:
            self.bits, self.single = 0, int(syms[0])
            return
        self.single = None
        lens = lengths[syms]
        # canonical codes: by length, then symbol
        order = np.lexsort((syms, lens))
        syms, lens = syms[order], lens[order]
        code, prev, codes = 0, int(lens[0]), []
        for ln in lens.tolist():
            code <<= ln - prev
            prev = ln
            codes.append(code)
            code += 1
        if code != 1 << prev:
            raise WebPError("VP8L prefix code is not complete")
        self.bits = int(lens.max())
        table = np.zeros(1 << self.bits, np.int64)
        for s, ln, c in zip(syms.tolist(), lens.tolist(), codes):
            rev = int(f"{c:0{ln}b}"[::-1], 2)
            table[rev::1 << ln] = (s << 4) | ln
        self.table = table.tolist()

    def read(self, br: _Bits) -> int:
        if self.single is not None:
            return self.single
        p = br.pos
        e = self.table[(int.from_bytes(br.buf[p >> 3:(p >> 3) + 4], "little") >> (p & 7)) & ((1 << self.bits) - 1)]
        br.pos = p + (e & 15)
        if br.pos > br.n:
            raise WebPError("VP8L data ends early")
        return e >> 4


def _read_code(br: _Bits, alphabet: int) -> _Code:
    lengths = [0] * alphabet
    if br.read(1):  # simple code: one or two symbols
        n = br.read(1) + 1
        first8 = br.read(1)
        s0 = br.read(8 if first8 else 1)
        if s0 >= alphabet:
            raise WebPError("VP8L simple code symbol past the alphabet")
        lengths[s0] = 1
        if n == 2:
            s1 = br.read(8)
            if s1 >= alphabet:
                raise WebPError("VP8L simple code symbol past the alphabet")
            lengths[s1] = 1
        return _Code(lengths)
    ncl = br.read(4) + 4
    cl_lengths = [0] * 19
    for i in range(ncl):
        cl_lengths[_CODE_LENGTH_ORDER[i]] = br.read(3)
    cl = _Code(cl_lengths)
    if br.read(1):
        nbits = 2 + 2 * br.read(3)
        max_symbol = 2 + br.read(nbits)
        if max_symbol > alphabet:
            raise WebPError("VP8L code length count past the alphabet")
    else:
        max_symbol = alphabet
    sym, prev = 0, 8
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = cl.read(br)
        if c < 16:
            lengths[sym] = c
            sym += 1
            if c:
                prev = c
        else:
            extra, base = ((2, 3), (3, 3), (7, 11))[c - 16]
            rep = br.read(extra) + base
            if sym + rep > alphabet:
                raise WebPError("VP8L code lengths past the alphabet")
            val = prev if c == 16 else 0
            lengths[sym:sym + rep] = [val] * rep
            sym += rep
    return _Code(lengths)


def _prefix_value(sym: int, br: _Bits) -> int:
    """A length or distance from its prefix symbol and extra bits."""
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


_DIST_MAP = (
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b,
    0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d,
    0x68, 0x02, 0x67, 0x69, 0x12, 0x1e, 0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70)


def _distance(code: int, width: int) -> int:
    if code > 120:
        return code - 120
    m = _DIST_MAP[code - 1]
    d = (m >> 4) * width + (8 - (m & 15))
    return max(d, 1)


# ------------------------------------------------------------------ image streams


def _entropy_image(br: _Bits, w: int, h: int, top: bool) -> list:
    """One entropy-coded image -> w * h ARGB ints. ``top``: the main image,
    which may carry meta prefix codes."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise WebPError(f"VP8L colour cache of {cache_bits} bits")
    meta, meta_bits, mw = None, 0, 0
    if top and br.read(1):
        meta_bits = br.read(3) + 2
        mw = -(-w // (1 << meta_bits))
        mh = -(-h // (1 << meta_bits))
        meta = [(p >> 8) & 0xFFFF for p in _entropy_image(br, mw, mh, False)]
    ngroups = (max(meta) + 1) if meta else 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = []
    for _ in range(ngroups):
        groups.append([_read_code(br, 256 + 24 + cache_size), _read_code(br, 256), _read_code(br, 256),
                       _read_code(br, 256), _read_code(br, 40)])
    n = w * h
    px = [0] * n
    cache = [0] * cache_size
    shift = 32 - cache_bits
    cached = 0  # pixels up to here are in the cache
    pos = 0
    grp = groups[0]
    while pos < n:
        if meta:
            y, x = divmod(pos, w)
            grp = groups[meta[(y >> meta_bits) * mw + (x >> meta_bits)]]
        g = grp[0].read(br)
        if g < 256:
            r = grp[1].read(br)
            b = grp[2].read(br)
            a = grp[3].read(br)
            px[pos] = (a << 24) | (r << 16) | (g << 8) | b
            pos += 1
        elif g < 280:
            length = _prefix_value(g - 256, br)
            dist = _distance(_prefix_value(grp[4].read(br), br), w)
            if dist > pos or pos + length > n:
                raise WebPError("VP8L backward reference outside the image")
            src = pos - dist
            if dist >= length:
                px[pos:pos + length] = px[src:src + length]
            elif dist == 1:
                px[pos:pos + length] = [px[src]] * length
            else:
                for i in range(length):
                    px[pos + i] = px[src + i]
            pos += length
        else:
            if cache_size == 0 or g - 280 >= cache_size:
                raise WebPError("VP8L colour cache code without a cache")
            while cached < pos:
                p = px[cached]
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
                cached += 1
            px[pos] = cache[g - 280]
            pos += 1
        if cache_size:
            while cached < pos:
                p = px[cached]
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = p
                cached += 1
    return px


def _channels(px) -> np.ndarray:
    """ARGB ints -> (n, 4) uint8 [a, r, g, b]."""
    a = np.asarray(px, np.uint32)
    return np.stack([(a >> 24), (a >> 16) & 255, (a >> 8) & 255, a & 255], -1).astype(np.uint8)


def _avg(a, b):
    return ((a.astype(np.int32) + b) >> 1).astype(np.int32)


def _predict_row(mode: int, L, T, TL, TR):
    """One prediction per pixel for a row's pixels (int32 arrays (k, 4))."""
    if mode == 0:
        return np.broadcast_to(np.array([255, 0, 0, 0], np.int32), T.shape)
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg(_avg(L, TR), T)
    if mode == 6:
        return _avg(L, TL)
    if mode == 7:
        return _avg(L, T)
    if mode == 8:
        return _avg(TL, T)
    if mode == 9:
        return _avg(T, TR)
    if mode == 10:
        return _avg(_avg(L, TL), _avg(T, TR))
    if mode == 11:
        pl = np.abs(T - TL).sum(-1, keepdims=True)
        pt = np.abs(L - TL).sum(-1, keepdims=True)
        return np.where(pl < pt, L, T)
    if mode == 12:
        return np.clip(L + T - TL, 0, 255)
    if mode == 13:
        a = _avg(L, T)
        d = a - TL
        return np.clip(a + np.trunc(d / 2).astype(np.int32), 0, 255)
    raise WebPError(f"VP8L predictor mode {mode}")


def _inverse_predictor(img: np.ndarray, bits: int, modes: list, w: int, h: int) -> np.ndarray:
    """img: (h, w, 4) uint8 residuals [a, r, g, b] -> pixels."""
    out = img.astype(np.int32)
    bw = -(-w // (1 << bits))
    # row 0: the first pixel from opaque black, the rest from the left
    out[0, 0] = (out[0, 0] + [255, 0, 0, 0]) & 255
    out[0] = np.cumsum(out[0], axis=0) & 255
    for y in range(1, h):
        out[y, 0] = (out[y, 0] + out[y - 1, 0]) & 255
        prev = out[y - 1]
        trow = np.concatenate([prev[1:], out[y, :1]])  # TR of the last column: this row's first pixel
        row_modes = [modes[(y >> bits) * bw + (x >> bits)] for x in range(0, w, 1 << bits)]
        x = 1
        while x < w:
            block_end = min(w, ((x >> bits) + 1) << bits)
            mode = row_modes[x >> bits]
            if mode in (0, 2, 3, 4, 9):  # no left neighbour needed: the block at once
                sl = slice(x, block_end)
                pred = _predict_row(mode, None, prev[sl], prev[x - 1:block_end - 1], trow[sl])
                out[y, sl] = (out[y, sl] + pred) & 255
                x = block_end
                continue
            for xx in range(x, block_end):
                pred = _predict_row(mode, out[y, xx - 1:xx], prev[xx:xx + 1], prev[xx - 1:xx], trow[xx:xx + 1])
                out[y, xx] = (out[y, xx] + pred[0]) & 255
            x = block_end
    return out.astype(np.uint8)


def decode_vp8l(data: bytes, with_header: bool = True, size=None) -> np.ndarray:
    """A VP8L bitstream -> (H, W, 4) uint8 [a, r, g, b], and whether the
    header says alpha is used. Without a header (ALPH) ``size`` is (w, h)."""
    br = _Bits(data)
    if with_header:
        if data[:1] != b"\x2f":
            raise WebPError("not a VP8L bitstream")
        br.read(8)
        w, h = br.read(14) + 1, br.read(14) + 1
        alpha = br.read(1)
        if br.read(3) != 0:
            raise WebPError("VP8L version is not 0")
    else:
        w, h = size
        alpha = 1
    transforms = []
    xsize = w
    seen = set()
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise WebPError(f"VP8L transform {kind} twice")
        seen.add(kind)
        if kind in (0, 1):
            bits = br.read(3) + 2
            sub = _entropy_image(br, -(-xsize // (1 << bits)), -(-h // (1 << bits)), False)
            transforms.append((kind, bits, sub, xsize))
        elif kind == 2:
            transforms.append((2, 0, None, xsize))
        else:
            n = br.read(8) + 1
            table = _channels(_entropy_image(br, n, 1, False)).astype(np.int32)
            table = np.cumsum(table, axis=0) & 255
            bits = 3 if n <= 2 else 2 if n <= 4 else 1 if n <= 16 else 0
            transforms.append((3, bits, table.astype(np.uint8), xsize))
            xsize = -(-xsize // (1 << bits))
    img = _channels(_entropy_image(br, xsize, h, True)).reshape(h, xsize, 4)
    for kind, bits, sub, width in reversed(transforms):
        if kind == 0:
            modes = [(p >> 8) & 15 for p in sub]
            img = _inverse_predictor(img, bits, modes, width, h)
        elif kind == 1:
            bw = -(-width // (1 << bits))
            m = _channels(sub).reshape(-1, bw, 4).astype(np.int8).astype(np.int32)
            yy = (np.arange(h) >> bits)[:, None]
            xx = (np.arange(width) >> bits)[None, :]
            e = m[yy, xx]  # [a, r, g, b] of the element: b = green_to_red, g = green_to_blue, r = red_to_blue
            g2r, g2b, r2b = e[..., 3], e[..., 2], e[..., 1]
            px = img.astype(np.int32)
            green = px[..., 2].astype(np.int8).astype(np.int32)
            red = (px[..., 1] + ((g2r * green) >> 5)) & 255
            blue = (px[..., 3] + ((g2b * green) >> 5) + ((r2b * red.astype(np.int8).astype(np.int32)) >> 5)) & 255
            img = np.stack([px[..., 0], red, px[..., 2], blue], -1).astype(np.uint8)
        elif kind == 2:
            px = img.astype(np.int32)
            img = np.stack([px[..., 0], (px[..., 1] + px[..., 2]) & 255, px[..., 2], (px[..., 3] + px[..., 2]) & 255],
                           -1).astype(np.uint8)
        else:
            table = sub
            if bits:
                per = 1 << bits
                nb = 8 >> bits
                xs = np.arange(width)
                idx = (img[:, xs >> bits, 2].astype(np.int32) >> ((xs & (per - 1)) * nb)) & ((1 << nb) - 1)
            else:
                idx = img[..., 2].astype(np.int32)
            full = np.zeros((256, 4), np.uint8)
            full[:len(table)] = table
            img = full[idx]
    return img, bool(alpha)


# ------------------------------------------------------------------ container


def _chunks(data: bytes):
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise WebPError("not a WebP file")
    (riff,) = struct.unpack_from("<I", data, 4)
    end = min(len(data), 8 + riff)
    pos, out = 12, []
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        (n,) = struct.unpack_from("<I", data, pos + 4)
        out.append((tag, pos + 8, n))
        pos += 8 + n + (n & 1)
    return out


def _unfilter_alpha(a: np.ndarray, method: int) -> np.ndarray:
    """libwebp's alpha unfilters: 1 horizontal, 2 vertical, 3 gradient;
    the first row always from the left (0 before it), the first column
    from above."""
    if method == 0:
        return a
    out = a.astype(np.int32)
    h, w = out.shape
    out[0] = np.cumsum(out[0]) & 255
    for y in range(1, h):
        prev = out[y - 1]
        if method == 2:
            out[y] = (out[y] + prev) & 255
        elif method == 1:
            out[y, 0] = (out[y, 0] + prev[0]) & 255
            out[y] = np.cumsum(out[y]) & 255
        else:
            row = out[y]
            left = top_left = int(prev[0])
            for x in range(w):
                top = int(prev[x])
                left = (int(row[x]) + min(max(left + top - top_left, 0), 255)) & 255
                top_left = top
                row[x] = left
    return out.astype(np.uint8)


def _alpha_plane(data: bytes, w: int, h: int) -> np.ndarray:
    head = data[0]
    method, filt = head & 3, (head >> 2) & 3
    if method == 0:
        if len(data) - 1 < w * h:
            raise WebPError("ALPH data is cut short")
        a = np.frombuffer(data, np.uint8, w * h, 1).reshape(h, w)
    elif method == 1:
        img, _ = decode_vp8l(data[1:], with_header=False, size=(w, h))
        a = img[..., 2]
    else:
        raise WebPError(f"ALPH compression {method}")
    return _unfilter_alpha(a, filt)


def _frame(data: bytes, chunks):
    """The image chunks (ALPH?, VP8 / VP8L) -> (H, W, 4) BGRA, has alpha."""
    alph = next(((p, n) for t, p, n in chunks if t == b"ALPH"), None)
    for tag, p, n in chunks:
        if tag == b"VP8L":
            argb, alpha = decode_vp8l(data[p:p + n])
            bgra = argb[..., [3, 2, 1, 0]]
            return np.ascontiguousarray(bgra), alpha
        if tag == b"VP8 ":
            bgr = vp8.decode(data[p:p + n])
            h, w = bgr.shape[:2]
            a = _alpha_plane(data[alph[0]:alph[0] + alph[1]], w, h) if alph else np.full((h, w), 255, np.uint8)
            return np.concatenate([bgr, a[..., None]], -1), alph is not None
    raise WebPError("WebP without a VP8 or VP8L chunk")


def decode_bgra(data: bytes):
    """-> ((H, W, 4) BGRA, whether cv2 reads it with alpha)."""
    chunks = _chunks(data)
    if not chunks:
        raise WebPError("WebP without chunks")
    first = chunks[0][0]
    if first == b"VP8X":
        p = chunks[0][1]
        flags = data[p]
        cw = int.from_bytes(data[p + 4:p + 7], "little") + 1
        ch = int.from_bytes(data[p + 7:p + 10], "little") + 1
        if flags & 0x02:  # animation: the first frame on a transparent canvas
            for tag, fp, n in chunks:
                if tag == b"ANMF":
                    x = int.from_bytes(data[fp:fp + 3], "little") * 2
                    y = int.from_bytes(data[fp + 3:fp + 6], "little") * 2
                    sub, pos = [], fp + 16
                    while pos + 8 <= fp + n:
                        t = data[pos:pos + 4]
                        (m,) = struct.unpack_from("<I", data, pos + 4)
                        sub.append((t, pos + 8, m))
                        pos += 8 + m + (m & 1)
                    frame, _ = _frame(data, sub)
                    canvas = np.zeros((ch, cw, 4), np.uint8)
                    fh, fw = frame.shape[:2]
                    canvas[y:y + fh, x:x + fw] = frame[:ch - y, :cw - x]
                    return canvas, True
            raise WebPError("animated WebP without a frame")
        frame, _ = _frame(data, chunks[1:])
        return frame, bool(flags & 0x10)
    return _frame(data, chunks)


def exif_orientation(data: bytes) -> int:
    """The Exif orientation of an ``EXIF`` chunk (a TIFF header, or one
    after ``Exif\\0\\0``), 1 without one."""
    for tag, p, n in _chunks(data):
        if tag == b"EXIF":
            body = data[p:p + n]
            return jpeg._exif_orientation(body if body.startswith(b"Exif\0\0") else b"Exif\0\0" + body)
    return 1


def decode(data: bytes, flags: int) -> np.ndarray:
    """-> cv2's array under ``flags``; under IMREAD_COLOR and
    IMREAD_GRAYSCALE the ``EXIF`` chunk's orientation applied, as cv2 5.0.0
    does (``tests/test_torch_image_formats.py``)."""
    bgra, alpha = decode_bgra(data)
    if flags == -1:
        return np.ascontiguousarray(bgra if alpha else bgra[..., :3])
    img = bgra[..., :3] if flags == 1 else cvt_color.cvtcolor_gray(bgra)
    return np.ascontiguousarray(jpeg.orient(img, exif_orientation(data)))


# ------------------------------------------------------------------ write


class _BitWriter:
    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, v: int, k: int):
        self.acc |= v << self.n
        self.n += k
        while self.n >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.n -= 8

    def bytes(self) -> bytes:
        if self.n:
            self.out.append(self.acc & 255)
            self.acc, self.n = 0, 0
        return bytes(self.out)


def _lengths(freq: np.ndarray, limit: int = 15) -> np.ndarray:
    """Huffman code lengths (at most ``limit``) for symbol frequencies."""
    import heapq

    n = len(freq)
    syms = [i for i in range(n) if freq[i]]
    lengths = np.zeros(n, np.int64)
    if not syms:
        return lengths
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths
    scale = 1
    while True:
        f = [max(1, int(freq[i]) // scale) for i in syms]
        heap = [(f[k], k, (k,)) for k in range(len(syms))]
        heapq.heapify(heap)
        depth = [0] * len(syms)
        tie = len(syms)
        while len(heap) > 1:
            a, b = heapq.heappop(heap), heapq.heappop(heap)
            for k in a[2] + b[2]:
                depth[k] += 1
            heapq.heappush(heap, (a[0] + b[0], tie, a[2] + b[2]))
            tie += 1
        if max(depth) <= limit:
            for k, s in enumerate(syms):
                lengths[s] = depth[k]
            return lengths
        scale *= 2


def _canonical(lengths: np.ndarray) -> dict:
    """symbol -> (bit-reversed code, length), LSB-first ready."""
    syms = [s for s in np.argsort(lengths, kind="stable") if lengths[s]]
    syms.sort(key=lambda s: (lengths[s], s))
    code, prev, out = 0, int(lengths[syms[0]]), {}
    for s in syms:
        ln = int(lengths[s])
        code <<= ln - prev
        prev = ln
        out[int(s)] = (int(f"{code:0{ln}b}"[::-1], 2), ln)
        code += 1
    return out


def _write_code(bw: _BitWriter, lengths: np.ndarray):
    """A normal prefix code (its code lengths coded by the code-length
    code, symbols 0-15 only, no repeats)."""
    used = np.nonzero(lengths)[0]
    if len(used) <= 2 and used.max(initial=0) < 256:  # a simple code
        syms = list(used) if len(used) else [0]
        bw.put(1, 1)
        bw.put(len(syms) - 1, 1)
        if syms[0] < 2:
            bw.put(0, 1)
            bw.put(int(syms[0]), 1)
        else:
            bw.put(1, 1)
            bw.put(int(syms[0]), 8)
        if len(syms) == 2:
            bw.put(int(syms[1]), 8)
        return
    bw.put(0, 1)
    cl_freq = np.bincount(lengths, minlength=19)
    cl_len = _lengths(cl_freq, 7)
    if (cl_len > 0).sum() == 1:  # the code-length code needs two symbols
        other = 1 if cl_len[0] == 0 else 0
        cl_len[other] = 1
    order_len = [int(cl_len[i]) for i in _CODE_LENGTH_ORDER]
    ncl = 19
    while ncl > 4 and order_len[ncl - 1] == 0:
        ncl -= 1
    bw.put(ncl - 4, 4)
    for i in range(ncl):
        bw.put(order_len[i], 3)
    bw.put(0, 1)  # max_symbol = the alphabet
    codes = _canonical(cl_len)
    for ln in lengths.tolist():
        c, k = codes[ln]
        bw.put(c, k)


def encode(img: np.ndarray) -> bytes:
    """(H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA uint8 -> a VP8L WebP."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] not in (3, 4)):
        raise WebPError(f"WebP is written from uint8 gray, BGR or BGRA, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if w > 16384 or h > 16384:
        raise WebPError(f"WebP holds at most 16384 x 16384, got {w} x {h}")
    if img.ndim == 2:
        img = cvt_color.gray_to_bgr(img)
    alpha = img.shape[2] == 4
    bgra = img if alpha else np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], -1)
    a, r, g, b = (bgra[..., i].astype(np.int32) for i in (3, 2, 1, 0))
    r, b = (r - g) & 255, (b - g) & 255  # subtract green
    argb = ((a << 24) | (r << 16) | (g << 8) | b).astype(np.int64).reshape(-1)
    # symbols: literal pixels, or runs of 3 or more as copies of the pixel
    # to the left (distance code 2) or of the row above (distance code 1)
    n = len(argb)
    same_left = np.zeros(n, bool)
    same_left[1:] = argb[1:] == argb[:-1]
    same_up = np.zeros(n, bool)
    same_up[w:] = argb[w:] == argb[:-w]
    events = []  # (0, pixel index, 0) a literal, (1, length, distance code) a copy
    i = 0
    while i < n:
        if same_left[i] or same_up[i]:
            src, code = (same_left, 2) if same_left[i] else (same_up, 1)
            j = i
            while j < n and src[j] and j - i < 4096:
                j += 1
            if j - i >= 3:
                events.append((1, j - i, code))
                i = j
                continue
        events.append((0, i, 0))
        i += 1
    green_f = np.zeros(280, np.int64)
    rf, bf, af = (np.zeros(256, np.int64) for _ in range(3))
    df = np.zeros(40, np.int64)
    lit = np.array([e[1] for e in events if e[0] == 0], np.int64)
    np.add.at(green_f, (argb[lit] >> 8) & 255, 1)
    np.add.at(rf, (argb[lit] >> 16) & 255, 1)
    np.add.at(bf, argb[lit] & 255, 1)
    np.add.at(af, (argb[lit] >> 24) & 255, 1)

    def prefix(v):  # a length or distance code >= 1 -> (symbol, extra bit count, extra bits)
        v -= 1
        if v < 4:
            return v, 0, 0
        hb = v.bit_length() - 1
        extra = hb - 1
        return 2 * hb + ((v >> (hb - 1)) & 1), extra, v & ((1 << extra) - 1)

    for kind, ln, dc in events:
        if kind == 1:
            green_f[256 + prefix(ln)[0]] += 1
            df[prefix(dc)[0]] += 1
    lens = [_lengths(x) for x in (green_f, rf, bf, af, df)]
    bw = _BitWriter()
    bw.put(0x2F, 8)
    bw.put(w - 1, 14)
    bw.put(h - 1, 14)
    bw.put(1 if alpha else 0, 1)
    bw.put(0, 3)
    bw.put(1, 1)  # a transform: subtract green
    bw.put(2, 2)
    bw.put(0, 1)  # no more transforms
    bw.put(0, 1)  # no colour cache
    bw.put(0, 1)  # no meta prefix codes
    for ln in lens:
        _write_code(bw, ln)
    codes = [_canonical(x) if (x > 0).sum() > 1 else None for x in lens]

    def put_sym(k, s):
        if codes[k] is not None:
            c, ln = codes[k][s]
            bw.put(c, ln)

    for kind, v, dc in events:
        if kind == 0:
            p = int(argb[v])
            put_sym(0, (p >> 8) & 255)
            put_sym(1, (p >> 16) & 255)
            put_sym(2, p & 255)
            put_sym(3, (p >> 24) & 255)
        else:
            s, eb, ev = prefix(v)
            put_sym(0, 256 + s)
            bw.put(ev, eb)
            s, eb, ev = prefix(dc)
            put_sym(4, s)
            bw.put(ev, eb)
    payload = bw.bytes()
    chunk = b"VP8L" + struct.pack("<I", len(payload)) + payload + (b"\0" if len(payload) & 1 else b"")
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk
