"""Image files without cv2: every still-image format cv2 5.0.0 reads,
decoded on numpy (and torch for AVIF's colour), and the ones it writes
beside AVIF, encoded.

The JAX package reads and writes its data through ``cv2.imread`` /
``cv2.imdecode`` / ``cv2.imwrite``; the port runs where OpenCV (and PIL)
are not installed, so it carries the codecs its data path needs, each held
bit for bit to cv2 5.0.0 under ``IMREAD_COLOR``, ``IMREAD_GRAYSCALE`` and
``IMREAD_UNCHANGED`` (``tests/test_torch_tools.py``,
``tests/test_torch_jpeg.py``, ``tests/test_torch_image_formats.py`` over
the committed forms of ``tests/fixtures/``).

* :func:`imread` / :func:`imdecode` pick the decoder from the signature, as
  cv2's ``findDecoder`` does, never from the file name: PNG and JPEG here
  and in ``data/jpeg.py``; ``BM`` BMP (``data/bmp.py``); ``P1``-``P7`` and
  ``PF`` / ``Pf`` PBM, PGM, PPM, PAM and PFM (``data/pxm.py``); Sun raster
  (``data/sunras.py``); ``#?RADIANCE`` / ``#?RGBE`` HDR (``data/hdr.py``);
  ``II*`` / ``MM*`` TIFF and BigTIFF (``data/tiff.py``, with
  ``data/ccitt.py``); ``RIFF....WEBP`` (``data/webp.py``, lossy frames in
  ``data/vp8.py``); ``GIF87a`` / ``GIF89a`` (``data/gif.py``); JPEG 2000,
  ``jP`` boxes and raw ``FF 4F FF 51`` codestreams (``data/jpeg2000.py``);
  an ``ftyp`` box naming ``avif`` or ``avis`` among its brands, AVIF
  (``data/av1_cuda.py``'s decoder with its plain versions: HEIF items, AV1
  intra decoding and libavif's colour rule, ``data/avif.py``). Any form
  cv2 returns None for raises, by name.
  On the card the loader decodes JPEG files with nvJPEG
  (``data/jpeg_cuda.py``) and JPEG 2000 files with the kernels of
  ``data/jpeg2000_cuda.py`` and AVIF files with the kernels of
  ``data/av1_cuda.py``; every other format decodes here, on the host, and
  its array is uploaded.
* What each flag returns follows each of cv2's readers, which differ: gray
  from colour is libpng's ``rgb_to_gray`` for PNG (:func:`rgb_to_gray`), the
  codecs' 14-bit rule for BMP, PxM, Sun raster and TIFF, cv2 5's 15-bit
  cvtColor for HDR, GIF and WebP (``data/cvt_color.py``); 16 bits become 8
  by the high byte (PNG, PxM, PAM) or by libtiff's ``(v + 128) // 257``
  (TIFF RGB); floats by ``saturate_cast`` of ``v`` (PFM) or of ``v * 255``
  (HDR). The PNG reader takes every colour type at every bit depth PNG
  allows (gray 1/2/4/8/16, RGB 8/16, palette 1/2/4/8 with ``PLTE`` and
  ``tRNS``, gray+alpha and RGBA 8/16), interlaced or not, with all five row
  filters; Average and Paeth depend on the pixel to their left and loop over
  the row.
* :func:`imwrite` / :func:`imencode` pick the format by extension, with
  cv2's names: ``.jpg`` / ``.jpeg`` / ``.jpe`` baseline JPEG at quality 95
  with 4:2:0 chroma (cv2's defaults, not its bytes), ``.png`` PNG with
  filter 0, ``.bmp`` / ``.dib``, ``.pbm`` / ``.pgm`` / ``.ppm`` / ``.pnm``,
  ``.pam``, ``.pfm``, ``.sr`` / ``.ras`` and ``.hdr`` / ``.pic`` as cv2's
  own bytes, ``.tif`` / ``.tiff`` (LZW), ``.webp`` (lossless VP8L),
  ``.gif`` (an exact palette) and ``.jp2`` (lossless 5/3, which cv2 writes
  only at ``IMWRITE_JPEG2000_COMPRESSION_X1000`` 1000; below 32 pixels on
  a side it raises, as cv2's OpenJPEG writer fails there) as files cv2 reads
  back to the same array. An extension with no writer here raises
  (``.avif``, which cv2 writes; ``.j2k``, ``.pxm`` and ``.exr``, which it
  has no writer for; and the rest): no format is written under another's
  name.

Channel order follows cv2: colour arrays are BGR (BGRA) in and out.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np

from dspnet_torch.data import av1_cuda, bmp, cvt_color, gif, hdr, heif, jpeg, jpeg2000, pxm, sunras, tiff, webp

# cv2's flag values, so call sites read like the JAX package's
IMREAD_UNCHANGED = -1
IMREAD_GRAYSCALE = 0
IMREAD_COLOR = 1

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"

# PNG colour type -> (stored channels, bit depths the standard allows):
# 0 gray, 2 RGB, 3 palette index, 4 gray+alpha, 6 RGBA
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)),
                6: (4, (8, 16))}

# libpng's rgb_to_gray weights as cv2 sets them (png_set_rgb_to_gray(png,
# 1, 0.299, 0.587)): 0.299 and 0.587 in libpng's fixed point (x 100000),
# scaled to 15 bits with truncation; blue takes what is left
GRAY_RED = 29900 * 32768 // 100000
GRAY_GREEN = 58700 * 32768 // 100000
GRAY_BLUE = 32768 - GRAY_RED - GRAY_GREEN


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


#: Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _samples(raw: bytes, width: int, height: int, channels: int, depth: int) -> np.ndarray:
    """One image's (or one Adam7 pass's) filtered rows -> (height, width,
    channels) samples as stored."""
    bits = channels * depth
    pix = _unfilter(raw, height, (width * bits + 7) // 8, max(1, bits // 8))
    if depth == 16:
        pix = pix.view(">u2").astype(np.uint16)
    elif depth < 8:
        pix = cvt_color.unpack_bits(pix, width, depth)
    return pix.reshape(height, width, channels)


class PngChunks(NamedTuple):
    """What :func:`png_chunks` keeps of a PNG stream."""

    header: tuple  # IHDR: width, height, depth, colour type, compression, filter, interlace
    idat: bytes
    palette: Optional[np.ndarray]
    trns: Optional[bytes]
    exif: Optional[bytes]  # the eXIf body before the image data (a TIFF header)
    animated: bool  # an acTL chunk
    first_frame: Optional[tuple]  # (fcTL fields, fdAT data) where the IDAT is not a frame


def png_chunks(data: bytes) -> PngChunks:
    """Walk a PNG stream's chunks, each CRC checked."""
    if data[:8] != PNG_MAGIC:
        raise ValueError("not a PNG stream")
    pos, header, idat, palette, trns, exif = 8, None, [], None, None, None
    animated, idat_is_frame, frame, fdat, collecting = False, False, None, [], False
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
        elif kind == b"PLTE":
            if length % 3 or not 0 < length <= 768:
                raise ValueError(f"PNG palette of {length} bytes")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"eXIf" and not idat:
            exif = body
        elif kind == b"acTL":
            animated = True
        elif kind == b"fcTL":
            if not idat:
                idat_is_frame = True
            # the first frame's fdAT chunks run up to the next fcTL
            collecting = frame is None and not idat_is_frame
            if collecting:
                frame = struct.unpack(">IIIIIHHBB", body)
        elif kind == b"fdAT" and collecting:
            fdat.append(body[4:])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind[0] & 0x20 == 0:  # a critical chunk this reader does not know
            raise ValueError(f"PNG chunk {kind!r} is not supported")
    if header is None:
        raise ValueError("PNG stream has no IHDR")
    first = (frame, b"".join(fdat)) if animated and frame is not None else None
    return PngChunks(header, b"".join(idat), palette, trns, exif, animated, first)


def _image_samples(raw: bytes, width: int, height: int, channels: int, depth: int, interlace: int) -> np.ndarray:
    """One image's zlib-inflated data -> (height, width, channels) samples
    as stored, interlaced or not."""
    if not interlace:
        return _samples(raw, width, height, channels, depth)
    # Adam7: seven reduced images one after another, each filtered on its
    # own (a pass with no columns or no rows has no bytes at all)
    pix = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = _ceil_div(width - x0, dx), _ceil_div(height - y0, dy)
        if pw <= 0 or ph <= 0:
            continue
        n = ph * ((pw * channels * depth + 7) // 8 + 1)
        pix[y0::dy, x0::dx] = _samples(raw[pos:pos + n], pw, ph, channels, depth)
        pos += n
    if pos != len(raw):
        raise ValueError(f"interlaced PNG image data is {len(raw)} bytes, its passes {pos}")
    return pix


def _check_header(c: PngChunks):
    width, height, depth, color, _, _, interlace = c.header
    if color not in _COLOR_TYPES or depth not in _COLOR_TYPES[color][1]:
        raise ValueError(f"PNG colour type {color} at bit depth {depth} is not valid PNG")
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace} does not exist (0 and 1, Adam7, do)")
    if color == 3 and c.palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    return width, height, depth, color, interlace


def read_png(data: bytes):
    """PNG bytes -> the samples as stored, (H, W, channels) uint8 (any depth
    up to 8, not scaled) or uint16, with the colour type, the bit depth and
    the palette ((n, 3) uint8) and ``tRNS`` bytes, each None when absent."""
    c = png_chunks(data)
    width, height, depth, color, interlace = _check_header(c)
    pix = _image_samples(zlib.decompress(c.idat), width, height, _COLOR_TYPES[color][0], depth, interlace)
    return pix, color, depth, c.palette, c.trns


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> the array ``cv2.imdecode(..., IMREAD_UNCHANGED)`` gives,
    in RGB(A) order: (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA; uint8, or
    uint16 for 16-bit images. Gray below 8 bits is scaled to 0..255; a
    palette is expanded (to RGBA with a ``tRNS`` chunk); an RGB ``tRNS``
    colour becomes alpha 0 (elsewhere the maximum); gray+alpha becomes RGBA;
    a gray ``tRNS`` is ignored."""
    return _expand(*read_png(data))


def _expand(pix, color, depth, palette, trns) -> np.ndarray:
    """Stored samples -> the array cv2 gives under IMREAD_UNCHANGED, in
    RGB(A) order (see :func:`decode_png`)."""
    if color == 0:
        if depth < 8:
            pix = pix * np.uint8(255 // ((1 << depth) - 1))
        return pix[..., 0]
    if color == 3:
        idx = pix[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError(f"PNG index {int(idx.max())} past its {len(palette)}-entry palette")
        rgb = palette[idx]
        if trns is None:
            return rgb
        alpha = np.full(256, 255, np.uint8)
        alpha[:len(trns)] = np.frombuffer(trns[:256], np.uint8)
        return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
    if color == 2 and trns is not None and len(trns) == 6:
        key = np.frombuffer(trns, ">u2").astype(pix.dtype)
        top = np.iinfo(pix.dtype).max
        alpha = np.where((pix == key).all(-1), 0, top).astype(pix.dtype)
        return np.concatenate([pix, alpha[..., None]], axis=-1)
    if color == 4:
        return pix[..., [0, 0, 0, 1]]
    return pix


def decode_png_frame(data: bytes) -> Tuple[np.ndarray, PngChunks]:
    """The image cv2 5.0.0 reads from PNG bytes (measured on PIL's APNGs,
    ``tests/test_torch_image_formats.py``): an APNG whose ``IDAT`` is not
    one of its frames (no ``fcTL`` before it) gives its first ``fdAT``
    frame, placed at its offset on a canvas of zeros, where a source blend
    and an over blend (onto nothing yet) both copy it; any other PNG its
    ``IDAT`` image. RGB(A) order, as :func:`decode_png`."""
    c = png_chunks(data)
    width, height, depth, color, interlace = _check_header(c)
    channels = _COLOR_TYPES[color][0]
    if c.first_frame is None:
        pix = _image_samples(zlib.decompress(c.idat), width, height, channels, depth, interlace)
        return _expand(pix, color, depth, c.palette, c.trns), c
    (_, fw, fh, fx, fy, _, _, _, _), raw = c.first_frame
    if fx + fw > width or fy + fh > height or not fw or not fh:
        raise ValueError(f"APNG frame {fw}x{fh} at ({fx}, {fy}) outside its {width}x{height} canvas")
    frame = _expand(_image_samples(zlib.decompress(raw), fw, fh, channels, depth, interlace), color, depth,
                    c.palette, c.trns)
    canvas = np.zeros((height, width) + frame.shape[2:], frame.dtype)
    canvas[fy:fy + fh, fx:fx + fw] = frame
    return canvas, c


def png_orientation(c: PngChunks) -> int:
    """The Exif orientation of a PNG's ``eXIf`` chunk (a bare TIFF header),
    1 without one."""
    if c.exif is None:
        return 1
    return jpeg._exif_orientation(c.exif if c.exif.startswith(b"Exif\0\0") else b"Exif\0\0" + c.exif)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) RGB uint8 or uint16 -> gray of the same dtype, libpng's
    ``png_do_rgb_to_gray`` without gamma, as cv2's PNG reader runs it for
    ``IMREAD_GRAYSCALE``: a pixel with R == G == B keeps its value; any other
    is (rc R + gc G + bc B) >> 15 with the 15-bit weights above, truncated at
    8 bits and rounded (+16384) at 16 bits."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 16384 if rgb.dtype == np.uint16 else 0
    mixed = (GRAY_RED * r + GRAY_GREEN * g + GRAY_BLUE * b + half) >> 15
    return np.where((r == g) & (g == b), r, mixed).astype(rgb.dtype)


def imdecode(buf, flags: int = IMREAD_COLOR) -> np.ndarray:
    """Encoded image bytes -> array, like ``cv2.imdecode``: the format by
    signature (see the module's text), the array under ``flags`` as cv2's
    reader for that format makes it. For PNG and JPEG: ``IMREAD_COLOR``
    (H, W, 3) uint8 BGR (gray replicated, alpha dropped, 16-bit reduced to
    its high byte as libpng's strip_16 does); ``IMREAD_GRAYSCALE`` (H, W)
    uint8 (colour PNGs through :func:`rgb_to_gray` before the 16-bit
    reduction; a JPEG's luma plane); ``IMREAD_UNCHANGED`` the stored array,
    colour as BGR / BGRA. Raises ``ValueError`` (naming the form) where cv2
    returns None."""
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_UNCHANGED):
        raise ValueError(f"flags must be IMREAD_COLOR, IMREAD_GRAYSCALE or IMREAD_UNCHANGED, got {flags}")
    data = bytes(buf)
    if data[:8] == PNG_MAGIC:
        img, chunks = decode_png_frame(data)
        if img.ndim == 3:
            img = img[..., [2, 1, 0, 3][:img.shape[-1]]]  # RGB(A) -> BGR(A)
        if chunks.animated and img.dtype == np.uint16 and flags != IMREAD_UNCHANGED:
            # cv2's APNG reader takes 16 bits to 8 by v / 255, rounded and
            # saturated (measured), before any gray conversion
            img = np.minimum((img.astype(np.int32) + 127) // 255, 255).astype(np.uint8)
        if flags == IMREAD_GRAYSCALE and img.ndim == 3:
            # an APNG goes through cvtColor (15 bits), any other PNG through
            # libpng's rgb_to_gray
            if chunks.animated:
                img = cvt_color.cvtcolor_gray(img)
            else:
                img = rgb_to_gray(img[..., 2::-1])
        if flags != IMREAD_UNCHANGED:
            img = np.ascontiguousarray(jpeg.orient(img, png_orientation(chunks)))
    elif data[:3] == JPEG_MAGIC:
        if flags == IMREAD_GRAYSCALE:
            img = _jpeg_luma(data)
        else:
            # gray, or BGR already; the Exif orientation applied as cv2 does
            # it, unless the image is read unchanged
            if flags == IMREAD_COLOR:
                jpeg.check_conversion(jpeg.read_info(data), "bgr")
            img = jpeg.decode(data, apply_orientation=flags == IMREAD_COLOR)
    else:
        return _decoder(data)(data, flags)
    if flags == IMREAD_UNCHANGED:
        return img
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if flags == IMREAD_GRAYSCALE:
        return img
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _decoder(data: bytes):
    """The reader of a format other than PNG and JPEG, chosen from the
    signature as cv2's ``findDecoder`` chooses it."""
    if data[:2] == bmp.MAGIC:
        return bmp.decode
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return webp.decode
    if data[:4] in tiff.MAGICS:
        return tiff.decode
    if data[:6] in gif.MAGICS:
        return gif.decode
    if data.startswith(hdr.MAGICS):
        return hdr.decode
    if data[:4] == sunras.MAGIC:
        return sunras.decode
    if data[:1] == b"P" and data[1:2] and data[1:2] in b"1234567Ff":
        return pxm.decode
    if jpeg2000.is_jpeg2000(data):
        return jpeg2000.decode
    if heif.is_avif(data):
        return _avif_decode
    raise ValueError(f"unknown image format (magic bytes {data[:8]!r})")


def _avif_decode(data: bytes, flags: int) -> np.ndarray:
    """AVIF through ``data/av1_cuda.py``'s decoder with its plain versions
    on the CPU."""
    return np.ascontiguousarray(av1_cuda.decode(data, flags, "cpu").numpy())


#: cv2's CMYK -> gray weights (``icvCvt_CMYK2Gray_8u_C4C1R``: 0.299,
#: 0.587, 0.114 at 14 fraction bits, rounded)
_CMYK_GRAY = (4899, 9617, 1868)


def _jpeg_luma(data: bytes) -> np.ndarray:
    """A JPEG under ``IMREAD_GRAYSCALE``, as cv2 5.0.0 reads it (measured in
    ``tests/test_torch_jpeg.py``): a YCbCr (or gray) stream gives its luma
    plane as decoded (upsampled where the luma is subsampled; the chroma is
    not read, so a fractional chroma ratio does not matter); an RGB-coded one libjpeg's ``rgb_gray_convert`` of the
    upsampled planes ((19595 R + 38470 G + 7471 B + 32768) >> 16); CMYK (and
    YCCK, after ``ycck_cmyk_convert``) cv2's own CMYK -> gray: each of C, M,
    Y through :func:`jpeg.cmyk_to_bgr`'s rule, then (4899 R + 9617 G + 1868
    B + 8192) >> 14. Then the Exif orientation. A lossless file converts no
    colour: only a gray one reads."""
    planes, info = jpeg.decode_planes(data)
    jpeg.check_conversion(info, "gray")
    if info.color in ("gray", "ycc"):  # the first component alone, upsampled where it is subsampled
        jpeg.check_sampling(info, [0])
        gray = jpeg._upsample(planes[0], *info.upsampling[0], fancy=not info.lossless)[:info.height, :info.width]
    else:
        jpeg.check_sampling(info)
        full = [jpeg._upsample(p, *f, fancy=not info.lossless)[:info.height, :info.width]
                for p, f in zip(planes, info.upsampling)]
        if info.color == "rgb":
            r, g, b = (p.astype(np.int64) for p in full)
            gray = (jpeg._fix(0.29900) * r + jpeg._fix(0.58700) * g + jpeg._fix(0.11400) * b + (1 << 15)) >> 16
        else:
            bgr = jpeg.cmyk_to_bgr(*(jpeg.ycck_to_cmyk(*full) if info.color == "ycck" else full)).astype(np.int64)
            wr, wg, wb = _CMYK_GRAY
            gray = (wb * bgr[..., 0] + wg * bgr[..., 1] + wr * bgr[..., 2] + (1 << 13)) >> 14
        gray = gray.astype(np.uint8)
    return np.ascontiguousarray(jpeg.orient(gray, info.orientation))


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


def _encode_png_bgr(img: np.ndarray) -> bytes:
    if img.ndim == 3 and img.shape[-1] in (3, 4):
        img = img[..., [2, 1, 0, 3][:img.shape[-1]]]  # BGR(A) -> RGB(A)
    return encode_png(img)


#: extension -> encoder of an array, with cv2's names
_WRITERS = {".jpg": lambda img: jpeg.encode(img, 95), ".png": _encode_png_bgr, ".bmp": bmp.encode,
            ".pbm": pxm.encode_pbm, ".pgm": lambda img: pxm.encode_pnm(img, "pgm"),
            ".ppm": lambda img: pxm.encode_pnm(img, "ppm"), ".pnm": pxm.encode_pnm, ".pam": pxm.encode_pam,
            ".pfm": pxm.encode_pfm, ".tif": tiff.encode, ".webp": webp.encode, ".gif": gif.encode,
            ".sr": sunras.encode, ".hdr": hdr.encode, ".jp2": lambda img: jpeg2000.encode(img)}
_WRITERS.update({alias: _WRITERS[name] for alias, name in ((".jpeg", ".jpg"), (".jpe", ".jpg"), (".dib", ".bmp"),
                                                            (".tiff", ".tif"), (".ras", ".sr"), (".pic", ".hdr"))})


def imencode(ext: str, img: np.ndarray) -> bytes:
    """``img`` (gray, BGR or BGRA, like ``cv2.imencode``) in the format of
    ``ext`` (a file extension, ``.bmp`` or ``bmp``); raises on an extension
    with no writer here."""
    ext = ext.lower() if ext.startswith(".") else "." + ext.lower()
    writer = _WRITERS.get(ext)
    if writer is None:
        raise ValueError(f"no image writer for the extension {ext!r} (the port writes "
                         f"{' '.join(sorted(_WRITERS))}; it writes no format under another's name)")
    return writer(np.asarray(img))


def imwrite(path: str, img: np.ndarray) -> str:
    """Write ``img`` (gray, BGR or BGRA, like ``cv2.imwrite``) in the format
    of the extension of ``path`` (:func:`imencode`; the module's text lists
    them); an extension with no writer raises before anything is written.
    The file appears whole (written to a temporary name, then renamed)."""
    data = imencode(os.path.splitext(path)[1], img)
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
