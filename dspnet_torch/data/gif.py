"""GIF without cv2: the reader of cv2 5.0.0's own ``grfmt_gif.cpp`` (not
giflib) and a palette writer, measured in
``tests/test_torch_image_formats.py``.

Read: GIF87a and GIF89a; the LZW stream with its code-size growth, clear
codes and end code; global and local colour tables; interlaced frames (the
four passes); the Graphic Control Extension's transparent index. The first
frame is composed as cv2 composes it: on a canvas of the logical screen's
size that starts as the background colour with alpha 0 (see
:func:`decode`), a frame's pixels written at its offset with alpha 255
except where they hold the transparent index, which leaves the canvas as
it was. ``IMREAD_UNCHANGED`` gives BGRA when any frame's Graphic Control
Extension names a transparent index and BGR otherwise; ``IMREAD_COLOR`` drops
alpha; ``IMREAD_GRAYSCALE`` is cv2 5's cvtColor (15-bit weights).

Write: a GIF89a with one frame and a global colour table of exactly the
array's colours (gray, BGR, or BGRA whose alpha is all 255), LZW-coded, so
it reads back equal. An array with more than 256 colours is refused: cv2
quantises it to a fixed palette (and refuses a gray array), which no
reader can undo.
"""

from __future__ import annotations

import struct

import numpy as np

from dspnet_torch.data import cvt_color

MAGICS = (b"GIF87a", b"GIF89a")


class GifError(ValueError):
    pass


def lzw_decode(data: bytes, min_size: int, npix: int) -> np.ndarray:
    """GIF LZW -> the first ``npix`` indices (fewer if the stream ends)."""
    if not 1 <= min_size <= 11:
        raise GifError(f"GIF LZW minimum code size {min_size}")
    clear, end = 1 << min_size, (1 << min_size) + 1
    base = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(base)
    out = bytearray()
    size, prev = min_size + 1, None
    buf = bytes(data) + b"\0\0\0"
    nbits, pos = len(data) * 8, 0
    mask = (1 << size) - 1
    while pos + size <= nbits and len(out) < npix:
        code = (int.from_bytes(buf[pos >> 3:(pos >> 3) + 3], "little") >> (pos & 7)) & mask
        pos += size
        if code == clear:
            table = list(base)
            size, prev = min_size + 1, None
            mask = (1 << size) - 1
            continue
        if code == end:
            break
        if prev is None:
            if code >= clear:
                raise GifError(f"GIF LZW code {code} after a clear code")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table) and code < 4096:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise GifError(f"GIF LZW code {code} past the table ({len(table)})")
        out += entry
        prev = entry
        if len(table) == mask + 1 and size < 12:
            size += 1
            mask = (1 << size) - 1
    return np.frombuffer(bytes(out[:npix]), np.uint8)


def _sub_blocks(data: bytes, pos: int):
    chunks = []
    while True:
        if pos >= len(data):
            raise GifError("GIF data ends inside a block")
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(chunks), pos
        chunks.append(data[pos:pos + n])
        pos += n


def _table(data: bytes, pos: int, flags: int):
    n = 1 << ((flags & 7) + 1)
    if pos + 3 * n > len(data):
        raise GifError("GIF colour table is cut short")
    return np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3), pos + 3 * n


def first_frame(data: bytes):
    """-> (canvas (H, W, 4) RGBA, whether any Graphic Control Extension of
    the file names a transparent index)."""
    if data[:6] not in MAGICS or len(data) < 13:
        raise GifError("not a GIF file")
    sw, sh, flags, bg, _ = struct.unpack_from("<HHBBB", data, 6)
    pos = 13
    gct = None
    if flags & 0x80:
        gct, pos = _table(data, pos, flags)
    canvas = np.zeros((sh, sw, 4), np.uint8)
    if gct is not None and bg < len(gct):
        canvas[..., :3] = gct[bg]
    transparent = None
    while True:
        if pos >= len(data):
            raise GifError("GIF data ends before its first frame")
        kind = data[pos]
        pos += 1
        if kind == 0x21:
            label = data[pos]
            body, pos = _sub_blocks(data, pos + 1)
            if label == 0xF9 and len(body) >= 4:
                transparent = body[3] if body[0] & 1 else None
        elif kind == 0x2C:
            x0, y0, w, h, iflags = struct.unpack_from("<HHHHB", data, pos)
            pos += 9
            table = gct
            if iflags & 0x80:
                table, pos = _table(data, pos, iflags)
            if table is None:
                raise GifError("GIF frame without a colour table")
            min_size = data[pos]
            lzw, pos = _sub_blocks(data, pos + 1)
            idx = lzw_decode(lzw, min_size, w * h)
            if len(idx) < w * h:
                raise GifError(f"GIF frame has {len(idx)} of its {w * h} pixels")
            idx = idx.reshape(h, w)
            if iflags & 0x40:  # interlaced: rows 0::8, 4::8, 2::4, 1::2
                order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                        np.arange(1, h, 2)])
                rows = np.empty_like(idx)
                rows[order] = idx
                idx = rows
            full = np.zeros((256, 4), np.uint8)
            full[:len(table), :3] = table
            full[:, 3] = 255
            px = full[idx]
            if transparent is not None:
                keep = idx != transparent
            else:
                keep = np.ones(idx.shape, bool)
            hh, ww = min(h, sh - y0), min(w, sw - x0)
            if hh > 0 and ww > 0:
                region = canvas[y0:y0 + hh, x0:x0 + ww]
                k = keep[:hh, :ww]
                region[k] = px[:hh, :ww][k]
            return canvas, transparent is not None or _any_transparency(data, pos)
        elif kind == 0x3B:
            raise GifError("GIF has no frame")
        else:
            raise GifError(f"GIF block {kind:#x} is not one GIF has")


def _any_transparency(data: bytes, pos: int) -> bool:
    """Whether a Graphic Control Extension after ``pos`` (the frames after
    the first, their data skipped) names a transparent index."""
    while pos < len(data):
        kind = data[pos]
        pos += 1
        if kind == 0x21:
            label = data[pos]
            body, pos = _sub_blocks(data, pos + 1)
            if label == 0xF9 and len(body) >= 4 and body[0] & 1:
                return True
        elif kind == 0x2C:
            iflags = data[pos + 8]
            pos += 9 + (3 << ((iflags & 7) + 1) if iflags & 0x80 else 0)
            _, pos = _sub_blocks(data, pos + 1)
        else:
            return False
    return False


def decode(data: bytes, flags: int) -> np.ndarray:
    rgba, gce = first_frame(data)
    bgra = rgba[..., [2, 1, 0, 3]]
    if flags == -1:
        return np.ascontiguousarray(bgra if gce else bgra[..., :3])
    if flags == 1:
        return np.ascontiguousarray(bgra[..., :3])
    return cvt_color.cvtcolor_gray(bgra)


# ------------------------------------------------------------------ write


def lzw_encode(idx: bytes, min_size: int) -> bytes:
    """Indices -> GIF LZW bytes: a clear code first, codes growing to 12
    bits, a clear code whenever the table fills, the end code last."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out, acc, nacc = bytearray(), 0, 0
    size = min_size + 1

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    emit(clear)
    table, nxt = {}, end + 1
    cur = -1
    for b in idx:
        if cur < 0:
            cur = b
            continue
        key = (cur << 8) | b
        code = table.get(key)
        if code is not None:
            cur = code
            continue
        emit(cur)
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt - 1 == (1 << size) and size < 12:
                size += 1
        else:
            emit(clear)
            table.clear()
            nxt, size = end + 1, min_size + 1
        cur = b
    if cur >= 0:
        emit(cur)
    emit(end)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def encode(img: np.ndarray) -> bytes:
    """(H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA (alpha all 255) uint8
    with at most 256 colours -> GIF89a bytes that read back equal."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] not in (3, 4)):
        raise GifError(f"GIF is written from uint8 gray, BGR or BGRA, got {img.dtype} {img.shape}")
    if img.ndim == 3 and img.shape[2] == 4:
        if not (img[..., 3] == 255).all():
            raise GifError("GIF keeps no alpha but transparency: a BGRA image must be opaque")
        img = img[..., :3]
    h, w = img.shape[:2]
    if img.ndim == 2:
        key = img.astype(np.int32)
    else:
        key = (img[..., 2].astype(np.int32) << 16) | (img[..., 1].astype(np.int32) << 8) | img[..., 0]
    colors, idx = np.unique(key.reshape(-1), return_inverse=True)
    if len(colors) > 256:
        raise GifError(f"GIF holds at most 256 colours and this image has {len(colors)}; cv2 quantises such "
                       "an image to its own palette, which the port does not")
    bits = max(1, int(len(colors) - 1).bit_length())
    table = np.zeros((1 << bits, 3), np.uint8)
    if img.ndim == 2:
        table[:len(colors)] = colors[:, None].astype(np.uint8)
    else:
        table[:len(colors)] = np.stack([colors >> 16, (colors >> 8) & 255, colors & 255], -1).astype(np.uint8)
    min_size = max(2, bits)
    lzw = lzw_encode(idx.astype(np.uint8).tobytes(), min_size)
    blocks = b"".join(bytes([len(lzw[i:i + 255])]) + lzw[i:i + 255] for i in range(0, len(lzw), 255))
    return (b"GIF89a" + struct.pack("<HHBBB", w, h, 0x80 | 0x70 | (bits - 1), 0, 0) + table.tobytes()
            + b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + bytes([min_size]) + blocks + b"\x00\x3b")
