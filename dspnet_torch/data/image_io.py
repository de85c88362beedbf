"""Image files without cv2: PNG on numpy and ``zlib``, JPEG through the
plain codec of ``data/jpeg.py``.

The JAX package reads and writes its data through ``cv2.imread`` /
``cv2.imwrite``; the port runs where OpenCV (and PIL) are not installed, so
it carries the codecs its data path needs.

* :func:`imread` / :func:`imdecode` pick the format from the magic bytes,
  as ``cv2.imread`` does, never from the file name. PNG and baseline JPEG
  decode here (JPEG to libjpeg-turbo's pixels, as cv2 gives them); anything
  else raises. On the card the loader decodes JPEG with nvJPEG instead
  (``data/jpeg_cuda.py``); this module is the CPU path and the host tools'.
* The PNG reader takes 8-bit gray, RGB and RGBA and 16-bit gray (and 16-bit
  colour), non-interlaced, with all five row filters, so it reads the PNGs
  cv2 writes (libpng picks a filter per row). Sub and Up are vectorised;
  Average and Paeth depend on the pixel to their left and loop over the row.
* :func:`imwrite` picks the format by extension, as ``cv2.imwrite`` does:
  ``.jpg`` / ``.jpeg`` write baseline JPEG at quality 95 with 4:2:0 chroma
  (cv2's defaults), any other name PNG with filter 0 (None). PNG is
  lossless, so a PNG written here and read back (here or by cv2) is the same
  array.

Channel order follows cv2: colour arrays are BGR (BGRA) in and out.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from dspnet_torch.data import jpeg

# cv2's flag values, so call sites read like the JAX package's
IMREAD_UNCHANGED = -1
IMREAD_COLOR = 1

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"

# PNG colour type -> channels (0 gray, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}


# ----------------------------------------------------------------- decode


def _unfilter_average(raw: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        out[i] = (raw[i] + ((left + prev[i]) >> 1)) & 0xFF
    return out


def _unfilter_paeth(raw: bytes, prev: bytes, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        if i >= bpp:
            a, c = out[i - bpp], prev[i - bpp]
        else:
            a = c = 0
        b = prev[i]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (raw[i] + pred) & 0xFF
    return out


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: (height, stride) uint8."""
    if len(data) != height * (stride + 1):
        raise ValueError(f"PNG image data is {len(data)} bytes, expected {height * (stride + 1)}")
    rows = np.frombuffer(data, np.uint8).reshape(height, stride + 1)
    if not rows[:, 0].any():  # every row unfiltered, as imwrite writes them
        return rows[:, 1:]
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, raw = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = raw
        elif kind == 1:  # Sub: a running sum per byte of the pixel, mod 256
            cur = np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = raw + prev
        elif kind == 3:
            cur = np.frombuffer(_unfilter_average(raw.tobytes(), prev.tobytes(), bpp), np.uint8)
        elif kind == 4:
            cur = np.frombuffer(_unfilter_paeth(raw.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind} (0-4 exist)")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> the stored array: (H, W) gray, (H, W, 3) RGB or (H, W, 4)
    RGBA; uint8, or uint16 for 16-bit images."""
    if data[:8] != PNG_MAGIC:
        raise ValueError("not a PNG stream")
    pos, header, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG stream ends before IEND")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} is truncated or fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind[0] & 0x20 == 0:  # a critical chunk this reader does not know
            raise ValueError(f"PNG chunk {kind!r} is not supported")
    if header is None:
        raise ValueError("PNG stream has no IHDR")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"PNG colour type {color} at bit depth {depth} is not supported "
                         "(8/16-bit gray, RGB and RGBA are)")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    channels, nbytes = _CHANNELS[color], depth // 8
    bpp = channels * nbytes
    pix = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if nbytes == 2:
        pix = pix.view(">u2").astype(np.uint16)
    img = pix.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def imdecode(buf, flags: int = IMREAD_COLOR) -> np.ndarray:
    """Encoded PNG or JPEG bytes -> array, like ``cv2.imdecode``.
    ``IMREAD_COLOR``: (H, W, 3) uint8 BGR (gray replicated, alpha dropped,
    16-bit reduced to its high byte as libpng's strip_16 does);
    ``IMREAD_UNCHANGED``: the stored array, colour as BGR / BGRA."""
    data = bytes(buf)
    if data[:8] == PNG_MAGIC:
        img = decode_png(data)
        if img.ndim == 3:
            img = img[..., [2, 1, 0, 3][:img.shape[-1]]]  # RGB(A) -> BGR(A)
    elif data[:3] == JPEG_MAGIC:
        # gray, or BGR already; the Exif orientation applied as cv2 does it,
        # under IMREAD_COLOR only
        img = jpeg.decode(data, apply_orientation=flags == IMREAD_COLOR)
    else:
        raise ValueError(f"unknown image format (magic bytes {data[:8]!r})")
    if flags == IMREAD_UNCHANGED:
        return img
    if flags != IMREAD_COLOR:
        raise ValueError(f"flags must be IMREAD_COLOR or IMREAD_UNCHANGED, got {flags}")
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """Read an image file, format by content (see :func:`imdecode`)."""
    with open(path, "rb") as f:
        return imdecode(f.read(), flags)


# ----------------------------------------------------------------- encode


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA, uint8 or uint16 -> PNG
    bytes, every row with filter 0, zlib level 1 (fast; the data path writes
    flat-coloured scenes, which compress well at any level)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG holds uint8 or uint16, got {img.dtype}")
    channels = 1 if img.ndim == 2 else img.shape[-1]
    color = {1: 0, 3: 2, 4: 6}.get(channels)
    if img.ndim not in (2, 3) or color is None:
        raise ValueError(f"PNG holds (H, W), (H, W, 3) or (H, W, 4) arrays, got {img.shape}")
    height, width = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    pix = img.astype(">u2") if depth == 16 else img
    rows = np.ascontiguousarray(pix).view(np.uint8).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)
    return (PNG_MAGIC + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 1))
            + _chunk(b"IEND", b""))


def imwrite(path: str, img: np.ndarray) -> str:
    """Write ``img`` (gray, BGR or BGRA, like ``cv2.imwrite``) in the format
    of the extension of ``path``: JPEG (quality 95, 4:2:0, cv2's defaults)
    for ``.jpg`` / ``.jpeg``, PNG otherwise. The file appears whole (written
    to a temporary name, then renamed)."""
    img = np.asarray(img)
    if os.path.splitext(path)[1].lower() in (".jpg", ".jpeg"):
        data = jpeg.encode(img, 95)
    else:
        if img.ndim == 3 and img.shape[-1] in (3, 4):
            img = img[..., [2, 1, 0, 3][:img.shape[-1]]]  # BGR(A) -> RGB(A)
        data = encode_png(img)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def nearest_index(src: int, dst: int) -> np.ndarray:
    """cv2's ``INTER_NEAREST`` source indices along one axis (``resizeNN``):
    floor(d * (1 / (dst / src))) in float64, capped at src - 1. The exact
    rational floor(d * src / dst) differs from it at some sizes."""
    return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64), src - 1)


def resize_nearest(img: np.ndarray, hw) -> np.ndarray:
    """(h, w, ...) -> (H, W, ...), ``cv2.resize(..., INTER_NEAREST)``'s
    pixels (:func:`nearest_index` on each axis)."""
    H, W = int(hw[0]), int(hw[1])
    h, w = img.shape[:2]
    return img[nearest_index(h, H)[:, None], nearest_index(w, W)[None, :]]
