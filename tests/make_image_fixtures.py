"""Write the committed still-image forms under
``tests/fixtures/image_forms/``: BMP, PBM/PGM/PPM/PAM/PFM, Sun raster,
Radiance HDR, TIFF, WebP, GIF and PNG files that ``cv2.imdecode`` reads (or
refuses), for the port's readers to read the same way on a machine that has
no cv2.

    python tests/make_image_fixtures.py

Needs cv2 and PIL. The files come from three writers: cv2's own encoders
(``cv2.imencode`` with its flags), PIL's (palette, 1-bit and RGBA BMP and
TIFF, CCITT TIFF, palette and animated GIF, WebP with alpha and animated
WebP), and the small writers below for the forms neither writes (RLE BMP,
OS/2 headers, 16-bit BMP, ASCII and low-maxval PxM, PAM tuple types,
big-endian PFM, RLE and RGB-ordered Sun raster, old-style and flat HDR
scanlines, planar, tiled, big-endian and predictor TIFFs, YCbCr tiles,
16-bit gray + alpha). PNG and WebP files with an Exif orientation and
APNGs (PIL's) hold cv2's orientation and first-frame rules. Sizes are small
(37x53, 64x96, odd widths), except one 1024x2048 lossy WebP and one
1024x2048 GIF of an untextured ``synthetic.make_example`` scene, which the
card's smoke test times.

``forms.json`` records each file's form and, under IMREAD_COLOR,
IMREAD_GRAYSCALE and IMREAD_UNCHANGED, the sha256, dtype and shape of
cv2's array, or null where cv2 returns None. Two PAM cases are special
(see :func:`pam_alpha_columns`): where cv2 fills only the first columns of
each row the record holds those columns (``columns``) and their sha256,
and where cv2 would write past its image it is not run and the record is
null, as the port refuses the read. The directory stays under 1 MB.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "image_forms"
BIG = (1024, 2048)
FLAGS = {"color": 1, "gray": 0, "unchanged": -1}


def scenes() -> dict:
    """The source images by name: (H, W, 3) BGR, (H, W, 4) BGRA or (H, W)
    gray uint8, and 16-bit and float ones."""
    import cv2

    sys.path.insert(0, str(ROOT))
    from dspnet_torch.data import synthetic

    rng = np.random.RandomState(15)
    noise = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    smooth = cv2.GaussianBlur(rng.randint(0, 256, (37, 53, 3)).astype(np.uint8), (5, 5), 1.5)
    street = synthetic.make_example(rng, (64, 96), 4)[0]
    alpha = np.concatenate([smooth, rng.randint(0, 256, (37, 53, 1)).astype(np.uint8)], -1)
    alpha[::7, ::5, 3] = 0
    alpha[1::9, ::3, 3] = 255
    return {"noise": noise, "smooth": smooth, "street": street, "gray": smooth[..., 1].copy(), "bgra": alpha,
            "noise16": rng.randint(0, 65536, (19, 27, 3)).astype(np.uint16),
            "gray16": (smooth[..., 0].astype(np.uint16) * 257 + rng.randint(0, 256, (37, 53))).astype(np.uint16),
            "float": (rng.rand(19, 27, 3) * 1.5).astype(np.float32), "bits": (smooth[..., 0] > 120)}


def pil(img, mode=None, **save):
    """Bytes of PIL's writer; ``img`` BGR(A) / gray numpy, or a PIL image."""
    from PIL import Image

    if isinstance(img, np.ndarray):
        if img.ndim == 3:
            img = img[..., [2, 1, 0, 3][:img.shape[2]]]
        img = Image.fromarray(img)
    if mode:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, **save)
    return buf.getvalue()


def cv2_bytes(ext, img, params=()):
    import cv2

    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok, ext
    return buf.tobytes()


# ------------------------------------------------------------------ BMP


def bmp_file(rows: bytes, w: int, h: int, bpp: int, compression=0, palette=None, header=40, clrused=0,
             masks=None) -> bytes:
    """A BMP with the given pixel bytes (rows as stored), header size
    (12 OS/2, 40, 108 V4, 124 V5), palette ((n, 3) BGR) and masks."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, abs(h), 1, bpp)
        pal = b"" if palette is None else np.asarray(palette, np.uint8).tobytes()
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, h, 1, bpp, compression, len(rows), 2835, 2835, clrused, 0)
        if header > 40:
            info += struct.pack("<IIII", *(tuple(masks or ()) + (0, 0, 0, 0))[:4])
            info += bytes(header - len(info))
        elif masks is not None:  # after a 40-byte header
            info += struct.pack("<III", *masks[:3])
        pal = b""
        if palette is not None:
            p = np.asarray(palette, np.uint8)
            pal = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1).tobytes()
    off = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(rows), 0, 0, off) + info + pal + rows


def bmp_rows(pix: np.ndarray, bpp: int, topdown=False) -> bytes:
    """(H, W) indices (bpp <= 8) or (H, W, bytes) samples -> padded rows,
    bottom-up unless ``topdown``."""
    h, w = pix.shape[:2]
    if bpp < 8:
        per = 8 // bpp
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = pix
        shifts = (np.arange(per)[::-1] * bpp).astype(np.uint8)
        raw = (padded.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)
    else:
        raw = pix.reshape(h, -1).view(np.uint8) if pix.dtype != np.uint8 else pix.reshape(h, -1)
    step = (raw.shape[1] + 3) & -4
    out = np.zeros((h, step), np.uint8)
    out[:, :raw.shape[1]] = raw
    return (out if topdown else out[::-1]).tobytes()


def rle_encode(idx: np.ndarray, four: bool, deltas=False) -> bytes:
    """(H, W) palette indices -> an RLE8 (RLE4 with ``four``) stream,
    bottom-up: runs of three or more equal pixels (in RLE4 also runs of two
    alternating ones), literals between them, end-of-line after each row and
    end-of-bitmap. With ``deltas`` a few rows are cut short by end-of-line,
    one jump goes by delta and the last rows by an early end-of-bitmap (cv2
    fills what they skip with entry 0)."""
    h, w = idx.shape
    out = bytearray()
    rows = idx[::-1].astype(int)
    y = 0
    while y < h:
        row, x = rows[y], 0
        end = w - 7 if deltas and y % 5 == 3 else w
        if deltas and y == 2:  # 3 right and 1 down
            out += bytes([0, 2, 3, 1])
            x, y = 3, y + 1
            row = rows[y]
        while x < end:
            run = 1
            while x + run < end and run < 255 and row[x + run] == row[x]:
                run += 1
            if four and run < 3 and x + 4 <= end and row[x] != row[x + 1] and row[x] == row[x + 2] \
                    and row[x + 1] == row[x + 3]:
                out += bytes([4, (row[x] << 4) | row[x + 1]])
                x += 4
            elif run >= 3 or end - x < 3:
                out += bytes([run, row[x] * 17 if four else row[x]])
                x += run
            else:
                n = 3
                while x + n < end and n < 255 and not (
                        x + n + 2 < end and row[x + n] == row[x + n + 1] == row[x + n + 2]):
                    n += 1
                lit = np.zeros(n + (n & 1), np.uint8)
                lit[:n] = row[x:x + n]
                data = bytes((lit[0::2] << 4) | lit[1::2]) if four else bytes(lit[:n])
                out += bytes([0, n]) + data + (b"\0" if len(data) & 1 else b"")
                x += n
        y += 1
        if deltas and y == h - 3:
            break
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp_forms(s: dict) -> dict:
    from PIL import Image

    f = {}
    for name in ("gray", "smooth", "bgra"):
        f[f"cv2_{name}.bmp"] = (cv2_bytes(".bmp", s[name]), f"cv2.imencode {s[name].shape}")
    street = s["street"]
    f["pil_1bit.bmp"] = (pil(s["smooth"], "1", format="BMP"), "PIL mode 1: 1 bpp, black/white palette")
    f["pil_gray_l.bmp"] = (pil(s["smooth"], "L", format="BMP"), "PIL mode L: 8 bpp gray palette")
    f["pil_palette.bmp"] = (pil(Image.fromarray(street[..., ::-1]).quantize(200), format="BMP"),
                            "PIL mode P: 8 bpp colour palette of 200")
    f["pil_rgba32.bmp"] = (pil(s["bgra"], format="BMP"), "PIL RGBA: 32 bpp BI_RGB")
    rng = np.random.RandomState(1)
    pal16 = rng.randint(0, 256, (16, 3))
    idx4 = (street.sum(-1) // 48 % 16).astype(np.uint8)
    h, w = idx4.shape
    f["pal4.bmp"] = (bmp_file(bmp_rows(idx4, 4), w, h, 4, palette=pal16), "4 bpp colour palette")
    pal256 = rng.randint(0, 256, (256, 3))
    idx8 = (street.sum(-1) // 3).astype(np.uint8)
    f["pal8_clrused60.bmp"] = (bmp_file(bmp_rows(idx8 % 60, 8), w, h, 8, palette=pal256[:60], clrused=60),
                               "8 bpp, 60 palette entries (biClrUsed)")
    f["pal8_topdown.bmp"] = (bmp_file(bmp_rows(idx8, 8, topdown=True), w, -h, 8, palette=pal256),
                             "8 bpp, top-down (negative height)")
    f["rle8.bmp"] = (bmp_file(rle_encode(idx8, False), w, h, 8, compression=1, palette=pal256), "RLE8")
    f["rle8_delta.bmp"] = (bmp_file(rle_encode(idx8, False, deltas=True), w, h, 8, compression=1, palette=pal256),
                           "RLE8 with early end-of-line, delta and early end-of-bitmap")
    f["rle4.bmp"] = (bmp_file(rle_encode(idx4, True), w, h, 4, compression=2, palette=pal16), "RLE4")
    f["rle4_delta.bmp"] = (bmp_file(rle_encode(idx4, True, deltas=True), w, h, 4, compression=2, palette=pal16),
                           "RLE4 with early end-of-line, delta and early end-of-bitmap")
    f["rle8_graypal.bmp"] = (bmp_file(rle_encode(idx8, False), w, h, 8, compression=1,
                                      palette=np.repeat(np.arange(256)[:, None], 3, 1)), "RLE8, gray palette")
    b, g, r = (street[..., i].astype(np.uint16) for i in range(3))
    p555 = (b >> 3) | ((g >> 3) << 5) | ((r >> 3) << 10)
    p565 = (b >> 3) | ((g >> 2) << 5) | ((r >> 3) << 11)
    f["rgb555.bmp"] = (bmp_file(bmp_rows(p555.astype("<u2")[..., None], 16), w, h, 16), "16 bpp BI_RGB (5-5-5)")
    f["bitfields565.bmp"] = (bmp_file(bmp_rows(p565.astype("<u2")[..., None], 16), w, h, 16, compression=3,
                                      masks=(0xF800, 0x7E0, 0x1F)), "16 bpp BI_BITFIELDS 5-6-5")
    f["bitfields555.bmp"] = (bmp_file(bmp_rows(p555.astype("<u2")[..., None], 16), w, h, 16, compression=3,
                                      masks=(0x7C00, 0x3E0, 0x1F)), "16 bpp BI_BITFIELDS 5-5-5")
    f["os2_pal8.bmp"] = (bmp_file(bmp_rows(idx8, 8), w, h, 8, palette=pal256, header=12), "OS/2 12-byte header, 8 bpp")
    f["os2_24.bmp"] = (bmp_file(bmp_rows(s["smooth"], 24), 53, 37, 24, header=12), "OS/2 12-byte header, 24 bpp")
    f["v4_24.bmp"] = (bmp_file(bmp_rows(s["smooth"], 24), 53, 37, 24, header=108), "V4 header, 24 bpp")
    f["v4_32_bitfields.bmp"] = (bmp_file(bmp_rows(s["bgra"], 32), 53, 37, 32, compression=3, header=108,
                                         masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)), "V4 header, 32 bpp BI_BITFIELDS")
    f["v5_32_rgb.bmp"] = (bmp_file(bmp_rows(s["bgra"], 32), 53, 37, 32, header=124), "V5 header, 32 bpp BI_RGB")
    f["bitfields32_40.bmp"] = (bmp_file(bmp_rows(s["bgra"], 32), 53, 37, 32, compression=3,
                                        masks=(0xFF0000, 0xFF00, 0xFF)), "40-byte header, 32 bpp BI_BITFIELDS")
    f["topdown_24.bmp"] = (bmp_file(bmp_rows(s["noise"], 24, topdown=True), 53, -37, 24), "24 bpp top-down")
    return f


# ------------------------------------------------------------------ PxM


def ascii_pnm(kind: int, img: np.ndarray, maxval: int, comments=False) -> bytes:
    """P1 / P2 / P3 with ``img`` as stored (RGB for P3), optional comments."""
    h, w = img.shape[:2]
    head = f"P{kind}\n" + ("# a comment\n" if comments else "") + f"{w} {h}" + (" # size\n" if comments else "\n")
    if kind != 1:
        head += f"{maxval}\n"
    vals = img.reshape(h, -1)
    if kind == 1:  # digits without spaces on odd rows
        body = "\n".join(("" if y % 2 else " ").join(str(int(v)) for v in row) for y, row in enumerate(vals))
    else:
        body = "\n".join(" ".join(str(int(v)) for v in row) for row in vals)
    return (head + body + "\n").encode()


def pam_file(img: np.ndarray, maxval: int, tupl=None) -> bytes:
    h, w = img.shape[:2]
    nch = 1 if img.ndim == 2 else img.shape[2]
    head = f"P7\n# comment\nWIDTH {w}\nHEIGHT {h}\nDEPTH {nch}\nMAXVAL {maxval}\n"
    head += (f"TUPLTYPE {tupl}\n" if tupl else "") + "ENDHDR\n"
    return head.encode() + img.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def pfm_file(img: np.ndarray, scale: float) -> bytes:
    h, w = img.shape[:2]
    nch = 1 if img.ndim == 2 else 3
    head = f"P{'F' if nch == 3 else 'f'}\n{w} {h}\n{scale}\n".encode()
    return head + img[::-1].astype("<f4" if scale < 0 else ">f4").tobytes()


def pxm_forms(s: dict) -> dict:
    f = {}
    g, c, g16, c16 = s["gray"], s["smooth"], s["gray16"], s["noise16"]
    f["cv2_gray.pgm"] = (cv2_bytes(".pgm", g), "cv2 P5")
    f["cv2_color.ppm"] = (cv2_bytes(".ppm", c), "cv2 P6")
    f["cv2_gray16.pgm"] = (cv2_bytes(".pgm", g16), "cv2 P5 16-bit")
    f["cv2_color16.ppm"] = (cv2_bytes(".ppm", c16), "cv2 P6 16-bit")
    f["cv2_gray.pbm"] = (cv2_bytes(".pbm", g // 2), "cv2 P4 (0 -> set bit)")
    f["cv2_ascii.pgm"] = (cv2_bytes(".pgm", g, [3, 0]), "cv2 P2 (IMWRITE_PXM_BINARY 0)")
    f["cv2_ascii.ppm"] = (cv2_bytes(".ppm", c, [3, 0]), "cv2 P3")
    f["cv2_gray.pam"] = (cv2_bytes(".pam", g), "cv2 PAM depth 1")
    f["cv2_color.pam"] = (cv2_bytes(".pam", c), "cv2 PAM depth 3 (BGR as stored)")
    f["cv2_bgra.pam"] = (cv2_bytes(".pam", s["bgra"]), "cv2 PAM depth 4, no TUPLTYPE: cv2 refuses it")
    f["cv2_color.pfm"] = (cv2_bytes(".pfm", s["float"]), "cv2 PF")
    f["cv2_gray.pfm"] = (cv2_bytes(".pfm", s["float"][..., 0].copy()), "cv2 Pf")
    f["cv2_u8.pfm"] = (cv2_bytes(".pfm", c), "cv2 PF from uint8 (values 0-255)")
    bits = s["bits"].astype(np.uint8)
    f["ascii_comments.pbm"] = (ascii_pnm(1, bits, 1, True), "P1 with comments, digits run together")
    f["ascii_max100.pgm"] = (ascii_pnm(2, g * 100 // 255, 100, True), "P2 maxval 100 (scaled)")
    f["ascii_max1000.ppm"] = (ascii_pnm(3, (c16 % 1001)[..., ::-1], 1000), "P3 maxval 1000 (16-bit)")
    f["ascii_max255.ppm"] = (ascii_pnm(3, c[:19, :27, ::-1], 255, True), "P3 maxval 255")
    f["binary_max100.pgm"] = (b"P5\n53 37\n100\n" + (g * 100 // 255).tobytes(), "P5 maxval 100 (bytes kept)")
    f["binary_max4000.ppm"] = (b"P6\n27 19\n4000\n" + (c16 % 4001).astype(">u2").tobytes(), "P6 maxval 4000")
    f["binary_comment.pgm"] = (b"P5\n# c1\n53\n# c2\n37 255\n" + g.tobytes(), "P5 with comments between numbers")
    f["pam_gray_alpha.pam"] = (pam_file(s["bgra"][..., 2:4].copy(), 255, "GRAYSCALE_ALPHA"), "PAM GRAYSCALE_ALPHA")
    f["pam_rgb_alpha.pam"] = (pam_file(s["bgra"], 255, "RGB_ALPHA"), "PAM RGB_ALPHA")
    f["pam_rgb.pam"] = (pam_file(c, 255, "RGB"), "PAM RGB")
    f["pam_rgb16.pam"] = (pam_file(c16, 65535, "RGB"), "PAM RGB 16-bit")
    f["pam_gray16.pam"] = (pam_file(g16, 65535, "GRAYSCALE"), "PAM GRAYSCALE 16-bit")
    f["pam_bw.pam"] = (pam_file(bits, 1, "BLACKANDWHITE"), "PAM BLACKANDWHITE (cv2 reads rows as packed bits)")
    f["pam_bw_alpha.pam"] = (pam_file(np.stack([bits, bits], -1), 1, "BLACKANDWHITE_ALPHA"),
                             "PAM BLACKANDWHITE_ALPHA: cv2 refuses it")
    f["pam_gray_alpha16.pam"] = (pam_file(np.stack([g16, g16 // 3], -1), 65535, "GRAYSCALE_ALPHA"),
                                 "PAM GRAYSCALE_ALPHA 16-bit")
    fl = s["float"]
    f["pfm_be_scale2.pfm"] = (pfm_file(fl[..., ::-1] * 300, 2.0), "PF big-endian, scale 2, values past 255")
    f["pfm_le_scale05.pfm"] = (pfm_file(fl[..., 0] - 0.5, -0.5), "Pf little-endian, scale 0.5, negative values")
    return f


# ------------------------------------------------------------------ Sun raster


def sun_rle(raw: bytes) -> bytes:
    """Sun's byte RLE: a run of 3 or more (or of 0x80 bytes) as 80 n-1 v,
    a lone 0x80 as 80 00."""
    out, i = bytearray(), 0
    while i < len(raw):
        v, n = raw[i], 1
        while i + n < len(raw) and raw[i + n] == v and n < 256:
            n += 1
        if n >= 3 or (v == 0x80 and n > 1):
            out += bytes([0x80, n - 1, v])
        elif v == 0x80:
            out += b"\x80\x00"
        else:
            out += bytes([v]) * n
        i += n
    return bytes(out)


def sun_file(pix: np.ndarray, bpp: int, kind=1, cmap=None) -> bytes:
    """``pix``: (H, W) indices / bits or (H, W, C) bytes as stored; ``cmap``
    (n, 3) RGB."""
    h, w = pix.shape[:2]
    if bpp == 1:
        pitch = ((w + 7) // 8 + 1) & -2
        rows = np.zeros((h, pitch * 8), np.uint8)
        rows[:, :w] = pix
        rows = np.packbits(rows, axis=1)
    else:
        raw = pix.reshape(h, -1)
        pitch = (raw.shape[1] + 1) & -2
        rows = np.zeros((h, pitch), np.uint8)
        rows[:, :raw.shape[1]] = raw
    body = rows.tobytes()
    if kind == 2:
        body = sun_rle(body)
    m = b"" if cmap is None else np.asarray(cmap, np.uint8).T.tobytes()
    return b"\x59\xa6\x6a\x95" + struct.pack(">7i", w, h, bpp, len(body), kind, 1 if len(m) else 0, len(m)) + m + body


def held(img: np.ndarray) -> np.ndarray:
    """``img`` in a zeroed buffer with room after it: cv2's Sun raster
    writer pads an odd last row with the byte after the image, which is
    then 0 and the file the same in every run."""
    buf = np.zeros(img.nbytes + 64, np.uint8)
    out = buf[:img.nbytes].view(img.dtype).reshape(img.shape)
    out[...] = img
    return out


def sun_forms(s: dict) -> dict:
    f = {}
    for name in ("gray", "smooth", "bgra"):
        f[f"cv2_{name}.sr"] = (cv2_bytes(".sr", held(s[name])), f"cv2.imencode {s[name].shape}")
    street, bits = s["street"], s["bits"].astype(np.uint8)
    rng = np.random.RandomState(2)
    cmap = rng.randint(0, 256, (256, 3))
    idx = (street.sum(-1) // 3).astype(np.uint8)
    idx[5, 3:20] = 0x80  # runs and lone bytes of the escape value
    idx[6, ::2] = 0x80
    f["bits_nomap.ras"] = (sun_file(bits, 1), "1 bit, no map")
    f["bits_map.ras"] = (sun_file(bits, 1, cmap=[[10, 200, 30], [250, 5, 90]]), "1 bit, 2-entry colour map")
    f["bits_rle.ras"] = (sun_file(bits, 1, kind=2), "1 bit, RT_BYTE_ENCODED")
    f["pal8.ras"] = (sun_file(idx, 8, cmap=cmap), "8 bit, RMT_EQUAL_RGB colour map")
    f["pal8_rle.ras"] = (sun_file(idx, 8, kind=2, cmap=cmap[:200]), "8 bit, RLE, 200-entry colour map")
    f["gray8_map.ras"] = (sun_file(idx, 8, cmap=np.repeat(np.arange(256)[:, None], 3, 1)), "8 bit, gray map")
    f["gray8_rle_odd.ras"] = (sun_file(s["gray"], 8, kind=2), "8 bit gray, RLE, odd width (padding)")
    f["rgb24_format_rgb.ras"] = (sun_file(s["smooth"][..., ::-1], 24, kind=3), "24 bit RT_FORMAT_RGB")
    f["bgr24_rle.ras"] = (sun_file(street, 24, kind=2), "24 bit BGR, RLE")
    x = np.concatenate([np.zeros((37, 53, 1), np.uint8), s["smooth"]], -1)
    f["xbgr32.ras"] = (sun_file(s["bgra"], 32), "32 bit, RT_STANDARD")
    f["xrgb32_format_rgb.ras"] = (sun_file(x[..., ::-1].copy(), 32, kind=3), "32 bit RT_FORMAT_RGB")
    f["bgr24_old.ras"] = (sun_file(s["noise"], 24, kind=0), "24 bit RT_OLD")
    return f


# ------------------------------------------------------------------ HDR


def hdr_forms(s: dict) -> dict:
    import cv2

    from dspnet_torch.data import hdr

    f = {}
    fl = (np.random.RandomState(16).rand(37, 53, 3) * 1.5).astype(np.float32)
    fl[3, :20] = 0  # zero pixels and runs
    fl[4, :] = fl[4, :1]
    fl[5, 10:30] *= 40
    f["cv2_float.hdr"] = (cv2_bytes(".hdr", fl), "cv2 float32, RLE scanlines")
    f["cv2_u8.hdr"] = (cv2_bytes(".hdr", s["street"]), "cv2 from uint8 (scaled by 1/255)")
    f["cv2_gray.hdr"] = (cv2_bytes(".hdr", s["gray"]), "cv2 from gray")
    f["cv2_narrow.hdr"] = (cv2_bytes(".hdr", fl[:, :7].copy()), "cv2 width 7: flat scanlines")
    f["cv2_flat.hdr"] = (cv2_bytes(".hdr", fl, [cv2.IMWRITE_HDR_COMPRESSION, cv2.IMWRITE_HDR_COMPRESSION_NONE]),
                         "cv2 IMWRITE_HDR_COMPRESSION_NONE: flat")
    body = hdr.encode(fl).split(b"+X 53\n", 1)[1]
    f["header_lines.hdr"] = (b"#?RGBE\n# made by hand\nEXPOSURE=1.5\nGAMMA=2.2\nFORMAT=32-bit_rle_rgbe\n\n-Y 37 +X 53\n"
                             + body, "#?RGBE, comment, EXPOSURE and GAMMA lines")
    f["orient_plus_y.hdr"] = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 37 +X 53\n" + body,
                              "+Y orientation: cv2 refuses it")
    f["xyze.hdr"] = (b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 37 +X 53\n" + body, "XYZE: cv2 refuses it")
    rgbe = np.random.RandomState(3).randint(0, 256, (6, 5, 4)).astype(np.uint8)
    rgbe[2, 1] = [1, 1, 1, 3]  # an old-style run, which rgbe.cpp reads as a pixel
    rgbe[4, :, 3] = 0
    f["old_run_flat.hdr"] = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 6 +X 5\n" + rgbe.tobytes(),
                             "flat scanlines with an old-style run (read as a pixel)")
    return f


# ------------------------------------------------------------------ GIF


def gif_file(screen, frames, gct=None, bg=0, version=b"GIF89a") -> bytes:
    """A GIF from parts. ``frames``: dicts with ``idx`` (h, w) indices and
    optional ``at`` (x, y), ``lct`` (n, 3) RGB, ``interlace``, ``gce``
    (transparent index or None, disposal), ``min_size``."""
    from dspnet_torch.data import gif

    def table(t):
        t = np.asarray(t, np.uint8)
        bits = max(1, (len(t) - 1).bit_length())
        full = np.zeros((1 << bits, 3), np.uint8)
        full[:len(t)] = t
        return bits, full.tobytes()

    sw, sh = screen
    flags = 0x70
    body = b""
    if gct is not None:
        bits, tb = table(gct)
        flags |= 0x80 | (bits - 1)
        body = tb
    out = version + struct.pack("<HHBBB", sw, sh, flags, bg, 0) + body
    for fr in frames:
        idx = np.asarray(fr["idx"], np.uint8)
        h, w = idx.shape
        if "gce" in fr:
            trans, disposal = fr["gce"]
            out += b"\x21\xf9\x04" + struct.pack("<BHB", (disposal << 2) | (trans is not None), 10,
                                                  trans or 0) + b"\x00"
        x, y = fr.get("at", (0, 0))
        iflags = 0x40 if fr.get("interlace") else 0
        lct = b""
        if fr.get("lct") is not None:
            bits, lct = table(fr["lct"])
            iflags |= 0x80 | (bits - 1)
        if fr.get("interlace"):
            idx = np.concatenate([idx[0::8], idx[4::8], idx[2::4], idx[1::2]])
        ms = fr.get("min_size", 8)
        lzw = gif.lzw_encode(idx.tobytes(), ms)
        blocks = b"".join(bytes([len(lzw[i:i + 255])]) + lzw[i:i + 255] for i in range(0, len(lzw), 255))
        out += b"\x2c" + struct.pack("<HHHHB", x, y, w, h, iflags) + lct + bytes([ms]) + blocks + b"\x00"
    return out + b"\x3b"


def gif_forms(s: dict) -> dict:
    from PIL import Image

    f = {}
    street = s["street"]
    rng = np.random.RandomState(4)
    pal = rng.randint(0, 256, (256, 3))
    idx = (street.sum(-1) // 3).astype(np.uint8)
    h, w = idx.shape
    f["cv2_color.gif"] = (cv2_bytes(".gif", s["smooth"]), "cv2 (its fixed palette, quantised)")
    f["pil_palette.gif"] = (pil(Image.fromarray(street[..., ::-1]).quantize(100), format="GIF"), "PIL P, 100 colours")
    f["pil_gray.gif"] = (pil(s["gray"], "L", format="GIF"), "PIL L")
    f["pil_interlace.gif"] = (pil(Image.fromarray(street[..., ::-1]).quantize(60), format="GIF", interlace=True),
                              "PIL interlaced")
    q = Image.fromarray(street[..., ::-1]).quantize(64)
    f["pil_transparent.gif"] = (pil(q, format="GIF", transparency=3), "PIL transparency index 3")
    frames = [q, Image.fromarray(s["street"][::-1, :, ::-1].copy()).quantize(64)]
    buf = io.BytesIO()
    frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:], duration=80, loop=0)
    f["pil_animated.gif"] = (buf.getvalue(), "PIL animated, two frames (the first is read)")
    f["gif87_gct.gif"] = (gif_file((w, h), [{"idx": idx}], gct=pal, version=b"GIF87a"), "GIF87a, global table")
    f["lct_offset.gif"] = (gif_file((w, h), [{"idx": idx[5:40, 7:60], "at": (7, 5), "lct": pal[::-1]}], gct=pal,
                                    bg=9), "a smaller frame at (7, 5) with a local table, background 9")
    f["gce_notrans.gif"] = (gif_file((w, h), [{"idx": idx, "gce": (None, 1)}], gct=pal), "GCE without transparency")
    f["gce_trans_offset.gif"] = (gif_file((w, h), [{"idx": idx[:30, :50], "at": (20, 10), "gce": (idx[3, 3], 2)}],
                                          gct=pal, bg=200),
                                 "GCE transparency in a frame at (20, 10), background 200, disposal 2")
    small = (idx // 64).astype(np.uint8)
    f["min_size2_interlace_lct.gif"] = (gif_file((w, h), [{"idx": small, "lct": pal[:4], "interlace": True,
                                                           "min_size": 2}]), "4 colours, code size 2, interlaced, "
                                                                              "local table only")
    big = rng.randint(0, 256, (64, 96)).astype(np.uint8)  # many codes: table resets
    f["noise_reset.gif"] = (gif_file((96, 64), [{"idx": big}], gct=pal), "noise: the code table fills and resets")
    return f


# ------------------------------------------------------------------ TIFF


def tiff_file(tags: dict, chunks: list, order="<", big=False) -> bytes:
    """A TIFF with one IFD: ``tags`` {tag: (type, values)} (SHORT 3, LONG
    4, RATIONAL 5 as (num, den) pairs, UNDEFINED 7 as bytes); the chunk
    offsets and byte counts (tags 273 / 279, or 324 / 325 with tiles) are
    filled in from ``chunks``."""
    tiled = 322 in tags
    off_tag, cnt_tag = (324, 325) if tiled else (273, 279)
    head = 16 if big else 8
    body = bytearray()
    offsets = []
    for c in chunks:
        offsets.append(head + len(body))
        body += c
        if len(body) & 1:
            body += b"\0"
    tags = dict(tags)
    tags[off_tag] = (16 if big else 4, offsets)
    tags[cnt_tag] = (16 if big else 4, [len(c) for c in chunks])
    ifd_pos = head + len(body)
    n = len(tags)
    esize, vsize = (20, 8) if big else (12, 4)
    extra_pos = ifd_pos + (8 if big else 2) + esize * n + vsize
    ifd, extra = bytearray(struct.pack(order + ("Q" if big else "H"), n)), bytearray()
    fmt = {3: "H", 4: "I", 5: "II", 7: "B", 16: "Q", 11: "f", 12: "d"}
    for tag in sorted(tags):
        typ, vals = tags[tag]
        if typ == 7:
            raw, count = bytes(vals), len(vals)
        elif typ == 5:
            raw, count = b"".join(struct.pack(order + "II", *v) for v in vals), len(vals)
        else:
            raw, count = struct.pack(order + fmt[typ] * len(vals), *vals), len(vals)
        if len(raw) <= vsize:
            ifd += struct.pack(order + ("HHQ" if big else "HHI"), tag, typ, count) + raw.ljust(vsize, b"\0")
        else:
            ifd += struct.pack(order + ("HHQQ" if big else "HHII"), tag, typ, count, extra_pos + len(extra))
            extra += raw
            if len(extra) & 1:
                extra += b"\0"
    ifd += bytes(vsize)
    if big:
        header = (b"II" if order == "<" else b"MM") + struct.pack(order + "HHHQ", 43, 8, 0, ifd_pos)
    else:
        header = (b"II" if order == "<" else b"MM") + struct.pack(order + "HI", 42, ifd_pos)
    return header + bytes(body) + bytes(ifd) + bytes(extra)


def tiff_simple(px: np.ndarray, photometric: int, order="<", compress=None, predictor=1, rps=None, planar=False,
                tile=None, extra=None, fmt=1, bps=None, colormap=None, big=False, more=None) -> bytes:
    """``px``: (H, W, spp) samples (uint8 / uint16 / float / packed bytes
    when ``bps`` < 8 is given with (H, row bytes, 1)). ``compress``: None,
    "deflate" or "packbits"-free raw; ``predictor`` 2 or 3 applied here."""
    h, w, spp = px.shape
    bps = bps or px.dtype.itemsize * 8
    dt = px.dtype.newbyteorder(order) if px.dtype.itemsize > 1 else px.dtype

    def encode(block):  # block (rows, cols, spp)
        if predictor == 2:
            u = block.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[block.dtype.itemsize])
            d = u.copy()
            d[:, 1:] = u[:, 1:] - u[:, :-1]
            raw = d.astype(u.dtype.newbyteorder(order)).tobytes()
        elif predictor == 3:
            nb = block.dtype.itemsize
            be = block.astype(block.dtype.newbyteorder(">")).view(np.uint8).reshape(block.shape[0], -1, nb)
            planes = be.transpose(0, 2, 1).reshape(block.shape[0], -1)  # MSB plane first
            st = planes.reshape(block.shape[0], -1, block.shape[2]) if False else planes
            d = st.copy()
            d[:, spp_c:] = st[:, spp_c:] - st[:, :-spp_c]
            raw = d.tobytes()
        else:
            raw = block.astype(dt).tobytes()
        return zlib.compress(raw) if compress == "deflate" else raw

    spp_c = 1 if planar else spp
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp), 259: (3, [8 if compress == "deflate" else 1]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [2 if planar else 1]), 339: (3, [fmt] * spp)}
    if predictor > 1:
        tags[317] = (3, [predictor])
    if extra is not None:
        tags[338] = (3, list(extra))
    if colormap is not None:
        tags[320] = (3, list(np.asarray(colormap).T.reshape(-1)))
    chunks = []
    planes = [px[..., i:i + 1] for i in range(spp)] if planar else [px]
    if tile:
        th, tw = tile
        tags[322], tags[323] = (4, [tw]), (4, [th])
        for pl in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw, pl.shape[2]), pl.dtype)
                    blk = pl[y:y + th, x:x + tw]
                    t[:blk.shape[0], :blk.shape[1]] = blk
                    chunks.append(encode(t))
    else:
        rps = rps or h
        tags[278] = (4, [rps])
        for pl in planes:
            for y in range(0, h, rps):
                chunks.append(encode(pl[y:y + rps]))
    tags.update(more or {})
    return tiff_file(tags, chunks, order, big)


def tiff_forms(s: dict) -> dict:
    import cv2
    from PIL import Image

    f = {}
    C, P = cv2.IMWRITE_TIFF_COMPRESSION, cv2.IMWRITE_TIFF_PREDICTOR
    smooth, street, g = s["smooth"], s["street"], s["gray"]
    f["cv2_gray.tif"] = (cv2_bytes(".tif", g), "cv2 default: LZW, predictor 2, one strip")
    f["cv2_bgr.tif"] = (cv2_bytes(".tif", smooth), "cv2 BGR")
    f["cv2_bgra.tif"] = (cv2_bytes(".tif", s["bgra"]), "cv2 BGRA (no ExtraSamples)")
    f["cv2_u16.tif"] = (cv2_bytes(".tif", s["noise16"], [cv2.IMWRITE_TIFF_ROWSPERSTRIP, 8]),
                        "cv2 16-bit BGR, strips of 8 rows")
    f["cv2_u16_gray.tif"] = (cv2_bytes(".tif", s["gray16"]), "cv2 16-bit gray, one strip (cv2's scanline read)")
    f["cv2_u16_onestrip.tif"] = (cv2_bytes(".tif", s["noise16"][:20], [cv2.IMWRITE_TIFF_ROWSPERSTRIP, 20]),
                                 "cv2 16-bit BGR in one strip")
    f["cv2_s16.tif"] = (cv2_bytes(".tif", (s["gray16"].astype(np.int32) - 30000).astype(np.int16)), "cv2 int16")
    f["cv2_s8.tif"] = (cv2_bytes(".tif", (g.astype(np.int16) - 128).astype(np.int8)), "cv2 int8")
    f["cv2_s32.tif"] = (cv2_bytes(".tif", s["gray16"].astype(np.int32) * 7 - 99999), "cv2 int32")
    f["cv2_f32.tif"] = (cv2_bytes(".tif", s["float"]), "cv2 float32 BGR, uncompressed")
    f["cv2_f64.tif"] = (cv2_bytes(".tif", s["float"][..., 0].astype(np.float64)), "cv2 float64 gray")
    for code, name in ((1, "none"), (7, "jpeg"), (8, "deflate"), (32946, "deflate_old"), (32773, "packbits")):
        ok, buf = cv2.imencode(".tif", street, [C, code])
        if ok:
            f[f"cv2_bgr_{name}.tif"] = (buf.tobytes(), f"cv2 compression {code}")
        else:
            print(f"cv2 writes no TIFF compression {code}")
    f["cv2_gray_jpeg.tif"] = (cv2_bytes(".tif", g, [C, 7]), "cv2 gray JPEG")
    f["cv2_lzw_nopred.tif"] = (cv2_bytes(".tif", smooth, [P, 1]), "cv2 LZW without predictor")
    f["cv2_u16_pred_packbits.tif"] = (cv2_bytes(".tif", s["noise16"], [C, 32773]), "cv2 16-bit PackBits")
    f["cv2_multistrip.tif"] = (cv2_bytes(".tif", street, [cv2.IMWRITE_TIFF_ROWSPERSTRIP, 7]), "cv2 strips of 7 rows")
    bits = s["bits"]
    for comp in ("group3", "group4", "tiff_ccitt", "packbits", "tiff_lzw"):
        f[f"pil_1bit_{comp}.tif"] = (pil(Image.fromarray(bits), format="TIFF", compression=comp), f"PIL 1-bit {comp}")
    f["pil_1bit_g3_2d.tif"] = (pil(Image.fromarray(bits), format="TIFF", compression="group3",
                                   tiffinfo={292: 1}), "PIL 1-bit Group 3 2D")
    f["pil_gray_deflate.tif"] = (pil(g, "L", format="TIFF", compression="tiff_adobe_deflate"), "PIL L Deflate")
    f["pil_palette.tif"] = (pil(Image.fromarray(street[..., ::-1]).quantize(100), format="TIFF"),
                            "PIL P (16-bit colour map)")
    f["pil_rgb_jpeg.tif"] = (pil(street, format="TIFF", compression="jpeg"), "PIL RGB as JPEG (YCbCr 2x2)")
    f["pil_ycbcr.tif"] = (pil(street, "YCbCr", format="TIFF"), "PIL YCbCr, uncompressed")
    f["pil_rgba.tif"] = (pil(s["bgra"], format="TIFF", compression="tiff_lzw"), "PIL RGBA (unassociated alpha)")
    f["pil_la.tif"] = (pil(s["bgra"][..., [0, 0, 0, 3]].copy(), "LA", format="TIFF"), "PIL LA")
    f["pil_cmyk.tif"] = (pil(street, "CMYK", format="TIFF", compression="tiff_lzw"), "PIL CMYK, LZW")
    f["pil_i16.tif"] = (pil(Image.fromarray(s["gray16"]), format="TIFF"), "PIL I;16")
    f["pil_i32.tif"] = (pil(Image.fromarray(s["gray16"].astype(np.int32) - 5000), format="TIFF"), "PIL I (int32)")
    f["pil_f.tif"] = (pil(Image.fromarray(s["float"][..., 0].copy()), format="TIFF"), "PIL F (float32)")
    u16 = s["noise16"]
    f["planar_rgb.tif"] = (tiff_simple(street[..., ::-1].copy(), 2, planar=True, compress="deflate"),
                           "planar RGB, Deflate")
    f["planar_rgba_unassoc.tif"] = (tiff_simple(s["bgra"][..., [2, 1, 0, 3]].copy(), 2, planar=True, extra=[2]),
                                    "planar RGBA, unassociated alpha")
    la16 = np.random.RandomState(16).randint(0, 65536, (19, 27, 2)).astype(np.uint16)
    for ph, tile, extra in ((1, None, 2), (1, None, 1), (0, None, 2), (1, (32, 64), 2), (0, (32, 64), 0),
                            (1, (16, 16), 2)):
        name = f"planar_ga16_{'white' if ph == 0 else 'black'}_{'tiles%dx%d' % tile if tile else 'strips'}_x{extra}.tif"
        f[name] = (tiff_simple(la16, ph, extra=[extra], planar=True, tile=tile),
                   f"planar 16-bit gray + alpha (ExtraSamples {extra}), min-is-{'white' if ph == 0 else 'black'}, "
                   + (f"tiles of {tile[0]}x{tile[1]}" if tile else "strips"))
    f["tiled_rgb16.tif"] = (tiff_simple(u16[..., ::-1].copy(), 2, tile=(32, 32)), "tiles of 32x32, 16-bit RGB")
    f["tiled_rgb_deflate.tif"] = (tiff_simple(street[..., ::-1].copy(), 2, tile=(16, 16), compress="deflate"),
                                  "tiles of 16x16, RGB, Deflate")
    f["tiled_gray_raw_16x48.tif"] = (tiff_simple(g[..., None], 1, tile=(16, 48)),
                                     "uncompressed tiles of 768 bytes: cv2's 8-bit reads refuse them")
    f["tiled_rgb16_raw_16x16.tif"] = (tiff_simple(u16[..., ::-1].copy(), 2, tile=(16, 16)),
                                      "uncompressed 16-bit tiles of 1,536 bytes: read only unchanged")
    f["tiled_gray_deflate.tif"] = (tiff_simple(g[..., None], 1, tile=(16, 32), compress="deflate"),
                                   "tiles of 16x32, gray, Deflate")
    f["be_rgb16_pred.tif"] = (tiff_simple(u16[..., ::-1].copy(), 2, order=">", predictor=2, compress="deflate",
                                          rps=8), "big-endian 16-bit RGB, predictor 2, Deflate")
    f["be_f32_pred3.tif"] = (tiff_simple(s["float"][..., 0:1].copy(), 1, order=">", predictor=3, compress="deflate",
                                         fmt=3, rps=10), "big-endian float32, predictor 3, Deflate")
    f["le_f32_pred3_rgb.tif"] = (tiff_simple(s["float"].copy(), 2, predictor=3, compress="deflate", fmt=3),
                                 "float32 RGB, predictor 3")
    f["bigtiff_gray.tif"] = (tiff_simple(g[..., None], 1, big=True, rps=9), "BigTIFF gray")
    for b in (2, 4):
        packed = np.packbits(np.unpackbits((g >> (8 - b))[..., None], axis=2)[..., 8 - b:].reshape(37, -1), axis=1)
        f[f"gray{b}bit.tif"] = (tiff_simple(packed[..., None], 1, bps=b), f"{b}-bit gray")
    pal16 = np.random.RandomState(5).randint(0, 256, (16, 3))
    idx4 = (street.sum(-1) // 48 % 16).astype(np.uint8)
    packed4 = ((idx4[:, 0::2] << 4) | idx4[:, 1::2]).astype(np.uint8)
    f["palette4_cmap8.tif"] = (tiff_simple(packed4[..., None], 3, bps=4, colormap=pal16),
                               "4-bit palette, 8-bit colour map")
    f["miniswhite_onestrip.tif"] = (tiff_simple(g[..., None], 0), "min-is-white 8-bit, one strip")
    f["miniswhite_strips.tif"] = (tiff_simple(g[..., None], 0, rps=5), "min-is-white 8-bit, strips of 5")
    f["rgba_assoc_onestrip.tif"] = (tiff_simple(s["bgra"][..., [2, 1, 0, 3]].copy(), 2, extra=[1]),
                                    "RGBA associated alpha, one strip")
    f["rgba_assoc_strips.tif"] = (tiff_simple(s["bgra"][..., [2, 1, 0, 3]].copy(), 2, extra=[1], rps=6),
                                  "RGBA associated alpha, strips")
    f["rgba16_unassoc.tif"] = (tiff_simple(np.concatenate([u16, u16[..., :1] // 3], -1), 2, extra=[2], rps=4),
                               "16-bit RGBA unassociated")
    f["cmyk_planar.tif"] = (tiff_simple(np.concatenate([street, g[:1, :1, None].repeat(64, 0).repeat(96, 1)], -1)
                                        if False else np.random.RandomState(6).randint(0, 256, (37, 53, 4))
                                        .astype(np.uint8), 5, planar=True), "CMYK planar")
    from dspnet_torch.data import gif as gif_codec

    raw = g.tobytes()  # GIF's LZW is libtiff's old-style (LSB-first) LZW
    f["lzw_oldstyle.tif"] = (tiff_file({256: (4, [53]), 257: (4, [37]), 258: (3, [8]), 259: (3, [5]),
                                        262: (3, [1]), 277: (3, [1]), 278: (4, [37])},
                                       [gif_codec.lzw_encode(raw, 8)]), "old-style (LSB-first) LZW")
    f["ccitt4_8bit.tif"] = (tiff_simple(g[..., None], 1, more={259: (3, [4])}), "Group 4 on 8-bit samples: refused")
    for code, name in ((50000, "zstd"), (50001, "webp"), (34661, "jbig")):
        f[f"{name}_tag.tif"] = (tiff_simple(g[..., None], 1, more={259: (3, [code])}),
                                f"compression {code} ({name}): refused")
    for o in range(2, 9):
        f[f"orientation{o}.tif"] = (tiff_simple(street[:21, :30, ::-1].copy(), 2, rps=8, more={274: (3, [o])}),
                                    f"Orientation {o}")
    f["orientation6_gray16.tif"] = (tiff_simple(s["gray16"][..., None], 1, more={274: (3, [6])}),
                                    "Orientation 6, 16-bit gray")
    f["old_jpeg6.tif"] = (tiff_simple(g[..., None], 1, more={259: (3, [6])}), "compression 6: cv2 refuses it")
    f["lzma_tag.tif"] = (tiff_simple(g[..., None], 1, more={259: (3, [34925])}), "LZMA (34925): cv2 refuses it")
    f["gray12.tif"] = (tiff_simple(np.frombuffer(np.random.RandomState(7).randint(0, 256, 37 * 80).astype(np.uint8),
                                                 np.uint8).reshape(37, 80, 1), 1, bps=12, more={256: (4, [53])}),
                       "12-bit gray")
    # uncompressed / Deflate YCbCr tiles (libtiff's putcontig8bitYCbCr*tile)
    for (sh, sv), (th, tw), comp in (((2, 2), (64, 64), None), ((2, 1), (32, 32), None), ((1, 1), (32, 32), None),
                                     ((2, 2), (16, 16), "deflate"), ((4, 4), (16, 16), "deflate"),
                                     ((2, 2), (32, 32), None), ((1, 4), (16, 16), "deflate")):
        kind = "Deflate" if comp else "uncompressed"
        f[f"ycbcr{sh}{sv}_tiles{th}x{tw}_{'deflate' if comp else 'raw'}.tif"] = (
            ycbcr_tiles(np.random.RandomState(sh * 10 + sv + th), (20, 30), (sh, sv), (th, tw), comp),
            f"YCbCr {sh}x{sv} in {th}x{tw} tiles, {kind}")
    la16 = np.random.RandomState(16).randint(0, 65536, (19, 27, 2)).astype(np.uint16)
    f["gray16_alpha.tif"] = (tiff_simple(la16, 1, extra=[2]), "16-bit gray + unassociated alpha, strips")
    f["gray16_alpha_be_tiles.tif"] = (tiff_simple(la16, 1, extra=[2], order=">", tile=(16, 16)),
                                      "16-bit gray + alpha, big-endian 16x16 tiles (cut at the right edge)")
    f["gray16_alpha_white.tif"] = (tiff_simple(la16, 0, extra=[0], tile=(32, 64)),
                                   "16-bit min-is-white + extra sample, a 32x64 tile")
    return f


def ycbcr_tiles(rng, hw, sub, tile, compress=None) -> bytes:
    """A YCbCr TIFF in tiles of random blocks (any bytes are YCbCr samples):
    each tile ceil(th / v) x ceil(tw / h) blocks of h x v luma samples, Cb
    and Cr."""
    (h, w), (sh, sv), (th, tw) = hw, sub, tile
    chunks = []
    for _ in range(-(-h // th) * -(-w // tw)):
        raw = rng.randint(16, 240, -(-th // sv) * -(-tw // sh) * (sh * sv + 2)).astype(np.uint8).tobytes()
        chunks.append(zlib.compress(raw) if compress else raw)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [8 if compress else 1]), 262: (3, [6]),
            277: (3, [3]), 284: (3, [1]), 322: (4, [tw]), 323: (4, [th]), 530: (3, [sh, sv])}
    return tiff_file(tags, chunks)


# ------------------------------------------------------------------ PNG


def png_forms(s: dict) -> dict:
    """PIL's PNGs with an Exif orientation (``eXIf``) and PIL's APNGs, with
    and without a default image, RGB and RGBA, with each dispose and blend
    op (cv2 reads the first frame)."""
    from PIL import Image

    f = {}
    street = s["street"][:20, :30]
    for o in range(1, 9):
        exif = Image.Exif()
        exif[0x0112] = o
        f[f"exif{o}.png"] = (pil(street, exif=exif.tobytes(), format="PNG"), f"PIL PNG, Exif orientation {o}")
    rng = np.random.RandomState(17)
    for mode in ("RGB", "RGBA"):
        frames = []
        for _ in range(3):
            a = rng.randint(0, 256, (12, 16, len(mode))).astype(np.uint8)
            if mode == "RGBA":
                a[::3, ::2, 3] = 0
            frames.append(Image.fromarray(a, mode))
        for default in (False, True):
            for dispose, blend in ((0, 0), (1, 0), (2, 0), (0, 1), (2, 1)):
                buf = io.BytesIO()
                frames[0].save(buf, format="PNG", save_all=True, append_images=frames[1:], default_image=default,
                               disposal=dispose, blend=blend, duration=40)
                name = f"apng_{mode.lower()}_{'default' if default else 'frame0'}_d{dispose}b{blend}.png"
                f[name] = (buf.getvalue(), f"PIL APNG {mode}, {'a default image' if default else 'IDAT as frame 0'}"
                                           f", dispose {dispose}, blend {blend}")
    rng = np.random.RandomState(20)
    for ct, kind in ((2, "rgb"), (6, "rgba"), (0, "gray"), (4, "graya")):
        frames = [rng.randint(0, 65536, (12, 16, {0: 1, 4: 2, 2: 3, 6: 4}[ct])).astype(np.uint16) for _ in range(3)]
        for default in (False, True):
            f[f"apng16_{kind}_{'default' if default else 'frame0'}.png"] = (
                apng16(frames, ct, default), f"16-bit APNG, colour type {ct}, "
                                             f"{'a default image' if default else 'IDAT as frame 0'}, by hand")
    return f


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def apng16(frames, color_type: int, default: bool) -> bytes:
    """A 16-bit APNG of ``frames`` ((H, W, C) uint16, C by ``color_type``)
    written chunk by chunk (neither cv2 nor PIL writes one): ``acTL``, then the
    first frame in ``IDAT`` (a default image outside the animation when
    ``default``, else frame 0 behind its ``fcTL``), then each later frame
    as ``fcTL`` + ``fdAT`` (no offsets, dispose and blend 0)."""
    h, w = frames[0].shape[:2]

    def idat(a):
        rows = a.astype(">u2").reshape(h, -1).view(np.uint8).reshape(h, -1)
        return zlib.compress(b"".join(b"\0" + r.tobytes() for r in rows))

    out = [b"\x89PNG\r\n\x1a\n", _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, color_type, 0, 0, 0)),
           _png_chunk(b"acTL", struct.pack(">II", len(frames) - int(default), 0))]
    seq = 0
    for i, frame in enumerate(frames):
        if i or not default:
            out.append(_png_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0, 1, 25, 0, 0)))
            seq += 1
        if i == 0:
            out.append(_png_chunk(b"IDAT", idat(frame)))
        else:
            out.append(_png_chunk(b"fdAT", struct.pack(">I", seq) + idat(frame)))
            seq += 1
    out.append(_png_chunk(b"IEND", b""))
    return b"".join(out)


# ------------------------------------------------------------------ WebP


def webp_forms(s: dict) -> dict:
    import cv2
    from PIL import Image

    f = {}
    Q = cv2.IMWRITE_WEBP_QUALITY
    smooth, street, noise = s["smooth"], s["street"], s["noise"]
    f["cv2_lossless.webp"] = (cv2_bytes(".webp", smooth), "cv2 default: VP8L")
    f["cv2_lossless_street.webp"] = (cv2_bytes(".webp", street), "cv2 VP8L, a street scene")
    f["cv2_lossless_noise.webp"] = (cv2_bytes(".webp", noise), "cv2 VP8L, noise")
    f["cv2_lossless_gray.webp"] = (cv2_bytes(".webp", s["gray"]), "cv2 VP8L from gray")
    f["cv2_lossless_bgra.webp"] = (cv2_bytes(".webp", s["bgra"]), "cv2 VP8L BGRA (transparent colour dropped)")
    for q in (10, 50, 80, 100):
        f[f"cv2_q{q}.webp"] = (cv2_bytes(".webp", smooth, [Q, q]), f"cv2 VP8 quality {q}")
    f["cv2_q80_street.webp"] = (cv2_bytes(".webp", street, [Q, 80]), "cv2 VP8 quality 80, a street scene")
    f["cv2_q75_noise.webp"] = (cv2_bytes(".webp", noise, [Q, 75]), "cv2 VP8 quality 75, noise")
    f["cv2_q80_bgra.webp"] = (cv2_bytes(".webp", s["bgra"], [Q, 80]), "cv2 VP8 + ALPH")
    f["pil_lossless_m6.webp"] = (pil(street, format="WEBP", lossless=True, method=6), "PIL VP8L method 6")
    f["pil_lossless_m0.webp"] = (pil(noise, format="WEBP", lossless=True, method=0), "PIL VP8L method 0")
    f["pil_lossless_exact.webp"] = (pil(s["bgra"], format="WEBP", lossless=True, exact=True),
                                    "PIL VP8L RGBA, exact")
    f["pil_palette.webp"] = (pil(Image.fromarray(street[..., ::-1]).quantize(16).convert("RGB"), format="WEBP",
                                 lossless=True), "PIL VP8L of 16 colours (colour indexing, bundling)")
    f["pil_palette2.webp"] = (pil(Image.fromarray(street[..., ::-1]).quantize(2).convert("RGB"), format="WEBP",
                                  lossless=True), "PIL VP8L of 2 colours (8 pixels a byte)")
    f["pil_lossy_alpha_m6.webp"] = (pil(s["bgra"], format="WEBP", quality=60, method=6, alpha_quality=100),
                                    "PIL VP8 + ALPH, method 6")
    f["pil_lossy_alpha_lowq.webp"] = (pil(s["bgra"], format="WEBP", quality=30, method=2, alpha_quality=40),
                                      "PIL VP8 + ALPH, alpha quality 40")
    f["pil_lossy_sharp.webp"] = (pil(street, format="WEBP", quality=90, method=4), "PIL VP8 quality 90")
    f["pil_lossy_odd.webp"] = (pil(noise[:35, :51], format="WEBP", quality=50), "PIL VP8 51x35")
    for o in range(1, 9):
        exif = Image.Exif()
        exif[0x0112] = o
        f[f"exif{o}.webp"] = (pil(street[:20, :30], format="WEBP", lossless=o % 2 == 1, exif=exif.tobytes()),
                              f"PIL WebP ({'VP8L' if o % 2 else 'VP8'}), Exif orientation {o}")
    fr = [Image.fromarray(street[..., ::-1]), Image.fromarray(street[::-1, :, ::-1].copy())]
    for lossless in (True, False):
        buf = io.BytesIO()
        fr[0].save(buf, format="WEBP", save_all=True, append_images=fr[1:], duration=100, lossless=lossless,
                   quality=70)
        f[f"pil_anim_{'lossless' if lossless else 'lossy'}.webp"] = (buf.getvalue(), "PIL animation, two frames")
    return f


# ------------------------------------------------------------------ main


def big_forms() -> dict:
    """The 1024x2048 untextured scene as lossy WebP and as GIF, for the
    card's timings."""
    import cv2
    from PIL import Image

    from dspnet_torch.data import synthetic

    scene = synthetic.make_example(np.random.RandomState(18), BIG, 4)[0]
    return {"big_lossy.webp": (cv2_bytes(".webp", scene, [cv2.IMWRITE_WEBP_QUALITY, 80]),
                               "cv2 VP8 quality 80, 1024x2048 street scene"),
            "big.gif": (pil(Image.fromarray(scene[..., ::-1]).quantize(256), format="GIF"),
                        "PIL P of 256 colours, 1024x2048 street scene")}


def all_forms() -> dict:
    s = scenes()
    forms = {}
    for maker in (bmp_forms, pxm_forms, sun_forms, hdr_forms, gif_forms, tiff_forms, png_forms, webp_forms):
        forms.update(maker(s))
    forms.update(big_forms())
    return forms


def pam_alpha_columns(data: bytes, flag: int):
    """A PAM with an alpha TUPLTYPE read into fewer channels: cv2 fills only
    the first columns of each row (``basic_conversion`` steps through the
    first ``width`` samples a pixel at a time) and leaves the rest as it
    found the buffer. -> (columns cv2 defines, or None for all of them;
    whether cv2 writes past its image, so that it must not be run)."""
    if not data.startswith(b"P7") or flag == -1:
        return None, False
    head = data.split(b"ENDHDR", 1)[0].decode("latin-1")
    fields = dict(line.split(None, 1) for line in head.splitlines()[1:] if line and not line.startswith("#"))
    if not fields.get("TUPLTYPE", "").endswith("_ALPHA") or fields["TUPLTYPE"].startswith("BLACK"):
        return None, False
    w, nch = int(fields["WIDTH"]), int(fields["DEPTH"])
    n = -(-w // nch)
    if flag == 1:
        return n, False
    return (3 * n, False) if 3 * n <= w else (None, True)


def cv2_record(data: bytes) -> dict:
    import cv2

    out = {}
    for key, flag in FLAGS.items():
        columns, overruns = pam_alpha_columns(data, flag)
        if overruns:  # the port refuses it; cv2 is not run on it
            out[key] = None
            continue
        img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        if img is not None and columns is not None:
            img = img[:, :columns]
        out[key] = None if img is None else {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
                                             "dtype": str(img.dtype), "shape": list(img.shape)}
        if columns is not None and img is not None:
            out[key]["columns"] = columns
    return out


def main():
    forms = all_forms()
    FIXTURE.mkdir(parents=True, exist_ok=True)
    for old in FIXTURE.iterdir():
        old.unlink()
    meta = {}
    for name, (data, form) in sorted(forms.items()):
        (FIXTURE / name).write_bytes(data)
        meta[name] = {"form": form, "bytes": len(data), "cv2": cv2_record(data)}
    import cv2

    (FIXTURE / "forms.json").write_text(json.dumps({"cv2": cv2.__version__, "files": meta}, indent=0, sort_keys=True)
                                        + "\n")
    total = sum(p.stat().st_size for p in FIXTURE.iterdir())
    print(f"{len(meta)} files, {total} bytes in {FIXTURE}")
    assert total < 1 << 20, total


if __name__ == "__main__":
    main()
