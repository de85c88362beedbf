"""Write the committed JPEG 2000 forms under
``tests/fixtures/jpeg2000_forms/``: ``.jp2`` files and raw ``.j2k``
codestreams that ``cv2.imdecode`` reads (or refuses), for the port's reader
(``dspnet_torch/data/jpeg2000.py``) and the card's decoder to read the same
way on a machine that has no cv2.

    python tests/make_jpeg2000_fixtures.py

Needs cv2 and PIL (with OpenJPEG). The files come from three writers:
cv2's (``cv2.imencode(".jp2")``, lossy by default and lossless at
``IMWRITE_JPEG2000_COMPRESSION_X1000`` 1000), PIL's (5/3 and 9/7, tiles,
precincts, code-block sizes, each progression order, several quality layers,
``mct`` off, ``no_jp2``, gray, gray+alpha, RGBA and 16-bit), and the port's
own encoder through its fixture options for what neither exposes: each
code-block style (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM, combined),
SOP / EPH, packed headers in PPM and PPT, an ROI maxshift, no decomposition
at all. Boxes are added by hand for a palette (``pclr`` / ``cmap``) and for
channel definitions that reorder (``cdef``); a signed component, a precision
below 8 and an image offset are forms cv2 returns None for. Sizes stay small
(37x53, 64x96, 70x130), as the plain tier-1 is Python; one 1024x2048 9/7
file of a textured street scene (PIL at rate 100, about 63 KB) is for the
card's smoke test.

``forms.json`` records each file's form and, under IMREAD_COLOR,
IMREAD_GRAYSCALE and IMREAD_UNCHANGED, the sha256, dtype and shape of cv2's
array, or null where cv2 returns None.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "jpeg2000_forms"
BIG = (1024, 2048)
FLAGS = {"color": 1, "gray": 0, "unchanged": -1}
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def scenes() -> dict:
    import cv2

    sys.path.insert(0, str(ROOT))
    from dspnet_torch.data import synthetic

    rng = np.random.RandomState(16)
    smooth = cv2.GaussianBlur(rng.randint(0, 256, (37, 53, 3)).astype(np.uint8), (5, 5), 1.5)
    multi = cv2.GaussianBlur(rng.randint(0, 256, (70, 130, 3)).astype(np.uint8), (5, 5), 1.5)
    street = synthetic.make_example(rng, (64, 96), 4)[0]
    alpha = np.concatenate([smooth, rng.randint(0, 256, (37, 53, 1)).astype(np.uint8)], -1)
    return {"smooth": smooth, "multi": multi, "street": street, "gray": smooth[..., 1].copy(), "bgra": alpha,
            "u16": (cv2.GaussianBlur(rng.randint(0, 65536, (32, 40, 3)).astype(np.uint16), (3, 3), 1)),
            "gray16": (smooth[..., 0].astype(np.uint16) * 257 + rng.randint(0, 256, (37, 53))).astype(np.uint16),
            "index": rng.randint(0, 200, (37, 53)).astype(np.uint8),
            "palette": rng.randint(0, 256, (200, 3)).astype(np.uint8),
            "palette16": rng.randint(0, 65536, 200).astype(np.uint16)}


def cv2_bytes(img, params=()):
    import cv2

    ok, buf = cv2.imencode(".jp2", img, list(params))
    assert ok
    return buf.tobytes()


def pil(img, mode=None, **save):
    """PIL's JPEG 2000 bytes of a BGR(A) / gray / uint16 numpy image."""
    from PIL import Image

    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, format="JPEG2000", **save)
    return buf.getvalue()


def box(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data) + 8) + kind + data


def with_header_boxes(jp2: bytes, extra: bytes, enumcs=None) -> bytes:
    """``jp2`` (the port's ``.jp2``) with ``extra`` boxes after ``colr`` in
    ``jp2h``, and its colour space set to ``enumcs`` where given."""
    from dspnet_torch.data import jpeg2000

    def sub(kind):
        pos = jp2.index(kind) - 4
        (n,) = struct.unpack_from(">I", jp2, pos)
        return bytearray(jp2[pos + 8:pos + n])

    colr = sub(b"colr")
    if enumcs is not None:
        colr[3:7] = struct.pack(">I", enumcs)
    head = box(b"jp2h", box(b"ihdr", bytes(sub(b"ihdr"))) + box(b"colr", bytes(colr)) + extra)
    return (jpeg2000.JP2_MAGIC + box(b"ftyp", b"jp2 \0\0\0\0jp2 ") + head
            + box(b"jp2c", jpeg2000.read_boxes(jp2).codestream))


def patch_siz(jp2: bytes, comp: int, ssiz: int) -> bytes:
    """``jp2`` with component ``comp``'s Ssiz byte replaced."""
    pos = jp2.index(b"\xff\x4f\xff\x51") + 42 + 3 * comp
    return jp2[:pos] + bytes([ssiz]) + jp2[pos + 1:]


def cv2_forms(s: dict) -> dict:
    import cv2

    X = cv2.IMWRITE_JPEG2000_COMPRESSION_X1000
    return {
        "cv2_default.jp2": (cv2_bytes(s["smooth"]), "cv2 default (5/3 at its default rate)"),
        "cv2_lossless.jp2": (cv2_bytes(s["smooth"], [X, 1000]), "cv2 lossless"),
        "cv2_rate100.jp2": (cv2_bytes(s["street"], [X, 100]), "cv2 at compression x1000 = 100, a street scene"),
        "cv2_gray.jp2": (cv2_bytes(s["gray"]), "cv2 from gray"),
        "cv2_bgra.jp2": (cv2_bytes(s["bgra"], [X, 1000]), "cv2 BGRA lossless"),
        "cv2_u16.jp2": (cv2_bytes(s["u16"], [X, 1000]), "cv2 uint16 BGR lossless"),
        "cv2_gray16.jp2": (cv2_bytes(s["gray16"], [X, 1000]), "cv2 uint16 gray lossless"),
    }


def pil_forms(s: dict) -> dict:
    sm, multi = s["smooth"], s["multi"]
    f = {
        "pil_53.jp2": (pil(sm, "RGB"), "PIL 5/3"),
        "pil_97.jp2": (pil(sm, "RGB", irreversible=True), "PIL 9/7"),
        "pil_97_db.jp2": (pil(s["street"], "RGB", irreversible=True, quality_mode="dB", quality_layers=[45]),
                          "PIL 9/7 at 45 dB, a street scene"),
        "pil_97_tiles_rpcl.jp2": (pil(multi, "RGB", irreversible=True, tile_size=(32, 32), codeblock_size=(32, 32),
                                      num_resolutions=4, progression="RPCL"),
                                  "PIL 9/7, 32x32 tiles and code-blocks, 4 resolutions, RPCL"),
        "pil_53_tiles_cprl.jp2": (pil(multi, "RGB", tile_size=(48, 40), codeblock_size=(8, 32), num_resolutions=3,
                                      precinct_size=(16, 16), progression="CPRL"),
                                  "PIL 5/3, 40x48 tiles, 8x32 code-blocks, 16x16 precincts, CPRL"),
        "pil_97_layers_pcrl.jp2": (pil(multi, "RGB", irreversible=True, progression="PCRL", precinct_size=(32, 64),
                                       codeblock_size=(16, 16), quality_mode="rates", quality_layers=[40, 10, 2]),
                                   "PIL 9/7, 3 layers, 64x32 precincts, PCRL"),
        "pil_97_db_layers.jp2": (pil(sm, "RGB", irreversible=True, quality_mode="dB", quality_layers=[30, 40, 50]),
                                 "PIL 9/7, 3 layers by dB"),
        "pil_mct_off.jp2": (pil(sm, "RGB", mct=0), "PIL 5/3 without the component transform"),
        "pil_gray.jp2": (pil(sm, "L"), "PIL gray"),
        "pil_la.jp2": (pil(sm, "LA"), "PIL gray + alpha"),
        "pil_rgba.jp2": (pil(s["bgra"], "RGBA"), "PIL RGBA (cdef)"),
        "pil_i16.jp2": (pil(s["gray16"]), "PIL I;16 5/3"),
        "pil_i16_97.jp2": (pil(s["gray16"], irreversible=True), "PIL I;16 9/7"),
        "pil_nojp2.j2k": (pil(sm, "RGB", no_jp2=True), "PIL raw codestream, RGB"),
        "pil_nojp2_gray.j2k": (pil(sm, "L", no_jp2=True), "PIL raw codestream, gray"),
        "pil_nojp2_la.j2k": (pil(sm, "LA", no_jp2=True), "PIL raw codestream, gray + alpha"),
        "pil_nojp2_rgba.j2k": (pil(s["bgra"], "RGBA", no_jp2=True), "PIL raw codestream, RGBA"),
        "pil_offset.jp2": (pil(sm, "RGB", offset=(3, 5), tile_offset=(0, 0), tile_size=(40, 40)),
                           "PIL with an image offset (cv2 returns None)"),
    }
    for prog in PROGRESSIONS:
        f[f"pil_53_layers_{prog.lower()}.jp2"] = (
            pil(multi, "RGB", progression=prog, precinct_size=(64, 64), codeblock_size=(16, 16),
                quality_mode="rates", quality_layers=[40, 10, 2]),
            f"PIL 5/3, 3 layers, 64x64 precincts, 16x16 code-blocks, {prog}")
    return f


def port_forms(s: dict) -> dict:
    from dspnet_torch.data import jpeg2000 as J

    sm = s["smooth"]
    f = {
        "port_gray.jp2": (J.encode(s["gray"]), "the port's writer, gray"),
        "port_bgr.jp2": (J.encode(sm), "the port's writer, BGR"),
        "port_bgra.jp2": (J.encode(s["bgra"]), "the port's writer, BGRA"),
        "port_u16.jp2": (J.encode(s["u16"]), "the port's writer, uint16 BGR"),
        "port_precincts_rpcl.jp2": (J.encode(s["multi"], precincts=[(4, 4), (4, 4), (5, 5), (5, 5), (6, 6), (6, 6)],
                                             progression="RPCL"),
                                    "the port's writer, precincts 16 to 64, RPCL"),
        "port_sop_eph.jp2": (J.encode(sm, sop=True, eph=True, progression="PCRL"), "SOP and EPH markers, PCRL"),
        "port_ppm.jp2": (J.encode(sm, packed="ppm", sop=True), "packet headers in PPM"),
        "port_ppt.jp2": (J.encode(sm, packed="ppt", eph=True), "packet headers in PPT"),
        "port_roi.jp2": (J.encode(sm, roi_shift=11), "ROI maxshift 11 over each subband's top-left quarter"),
        "port_levels0.jp2": (J.encode(sm, levels=0, cblk=(5, 5)), "no decomposition, 32x32 code-blocks"),
        "port_raw.j2k": (J.encode(sm, codestream=True), "the port's writer, a raw codestream"),
    }
    for name, style in (("bypass", J.BYPASS), ("reset", J.RESET), ("termall", J.TERMALL), ("vsc", J.VSC),
                        ("pterm", J.PTERM), ("segsym", J.SEGSYM), ("bypass_termall", J.BYPASS | J.TERMALL),
                        ("reset_vsc_segsym", J.RESET | J.VSC | J.SEGSYM), ("all_styles", 63)):
        f[f"port_style_{name}.jp2"] = (J.encode(sm, style=style, cblk=(4, 4)),
                                       f"code-block style {name} (0x{style:02x}), 16x16 code-blocks")
    # boxes by hand
    index = J.encode(s["index"])
    pclr = struct.pack(">HB", 200, 3) + bytes([7, 7, 7]) + s["palette"].tobytes()
    cmap = b"".join(struct.pack(">HBB", 0, 1, k) for k in range(3))
    f["box_pclr.jp2"] = (with_header_boxes(index, box(b"pclr", pclr) + box(b"cmap", cmap), J.SRGB),
                         "palette of 200 RGB entries (pclr + cmap) over 8-bit indices")
    pclr16 = struct.pack(">HB", 200, 1) + bytes([15]) + s["palette16"].astype(">u2").tobytes()
    f["box_pclr16.jp2"] = (with_header_boxes(index, box(b"pclr", pclr16) + box(b"cmap", struct.pack(">HBB", 0, 1, 0)),
                                             J.GRAY), "16-bit gray palette over 8-bit indices")
    cdef = struct.pack(">H", 3) + b"".join(struct.pack(">HHH", c, 0, 3 - c) for c in range(3))
    f["box_cdef_reversed.jp2"] = (with_header_boxes(J.encode(sm), box(b"cdef", cdef)),
                                  "cdef naming the components in reverse")
    cdef = struct.pack(">H", 4) + struct.pack(">HHH", 0, 1, 0) + b"".join(
        struct.pack(">HHH", c, 0, c) for c in range(1, 4))
    f["box_cdef_alpha_first.jp2"] = (with_header_boxes(J.encode(s["bgra"]), box(b"cdef", cdef)),
                                     "cdef with alpha as component 0")
    f["port_sycc.jp2"] = (J.encode(sm, colour=J.SYCC), "sYCC (colr 18) of three full-size 8-bit components")
    f["port_sycc16.jp2"] = (J.encode(s["u16"], colour=J.SYCC), "sYCC (colr 18) of three full-size 16-bit components")
    f["box_sycc_gray.jp2"] = (with_header_boxes(J.encode(s["gray"]), b"", J.SYCC), "sYCC (colr 18) over one component")
    f["box_sycc_bgra.jp2"] = (with_header_boxes(J.encode(s["bgra"]), b"", J.SYCC), "sYCC (colr 18) over four components")
    f["refused_signed.jp2"] = (patch_siz(J.encode(sm), 1, 0x87), "a signed component (cv2 returns None)")
    f["refused_prec7.jp2"] = (patch_siz(J.encode(s["gray"]), 0, 0x06), "precision 7 (cv2 returns None)")
    return f


def big_forms() -> dict:
    """The 1024x2048 textured street scene as 9/7 at about 63 KB."""
    from dspnet_torch.data import synthetic

    scene = big_scene(synthetic)
    return {"big_97.jp2": (pil(scene, "RGB", irreversible=True, quality_mode="rates", quality_layers=[100]),
                           "PIL 9/7 at rate 100, 1024x2048 textured street scene")}


def big_scene(synthetic) -> np.ndarray:
    """The card's 1024x2048 scene: ``synthetic.make_example`` with
    ``texture_offsets`` laid over it (``chip_smoke.py`` makes the same)."""
    img = synthetic.make_example(np.random.RandomState(19), BIG, 4)[0]
    tex = synthetic.texture_offsets(np.random.RandomState(20), BIG)
    return np.clip(img + tex, 0, 255).astype(np.uint8)


def all_forms() -> dict:
    s = scenes()
    forms = {}
    for maker in (cv2_forms, pil_forms, port_forms):
        forms.update(maker(s))
    forms.update(big_forms())
    return forms


def cv2_record(data: bytes) -> dict:
    import cv2

    out = {}
    for key, flag in FLAGS.items():
        img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        out[key] = None if img is None else {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
                                             "dtype": str(img.dtype), "shape": list(img.shape)}
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
