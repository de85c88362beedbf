"""Write the committed AVIF forms under ``tests/fixtures/avif_forms/``: the
files ``cv2.imdecode`` reads (or refuses), for the port's reader
(``dspnet_torch/data/avif.py``) and the card's decoder to read the same way
on a machine that has no cv2.

    python tests/make_avif_fixtures.py

Needs cv2 and PIL (Pillow's AVIF plugin, libavif 1.3.0 on libaom). The files
come from three writers: cv2's (``cv2.imencode(".avif")`` at qualities 30 /
75 / default / 100, speeds 0 / 5 / default / 10, depths 8 / 10 / 12, gray,
odd sizes), Pillow's (4:4:4 / 4:2:2 / 4:0:0, alpha, lossless, tiles, limited
and full range, quantizer matrices, film grain test tables, screen content
for palettes and IntraBC, loop restoration, 128x128 superblocks, an image
sequence), and the container writer here (:func:`container`), which lays
those AV1 payloads into hand-made HEIF boxes: a ``grid``, ``idat``
(construction method 1), several extents, ``irot`` / ``imir`` / ``clap``,
``nclx`` matrices and an ICC ``colr``, no ``colr`` at all, a premultiplied
alpha (``prem``) and the forms the port refuses by name. Sizes stay small
(at most 256x384), as the plain decoder is Python; two 1024x2048 textured
street scenes (cv2's default and speed 0, whose frame uses loop
restoration) are for the card's smoke test.

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
FIXTURE = ROOT / "tests" / "fixtures" / "avif_forms"
BIG = (1024, 2048)
FLAGS = {"color": 1, "gray": 0, "unchanged": -1}


# -- a HEIF writer ------------------------------------------------------------------

def box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", len(body) + 8) + kind + body


def full(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def prop_ispe(w: int, h: int) -> bytes:
    return full(b"ispe", 0, 0, struct.pack(">II", w, h))


def prop_pixi(depths) -> bytes:
    return full(b"pixi", 0, 0, bytes([len(depths)] + list(depths)))


def prop_nclx(cp: int, tc: int, mc: int, full_range: int) -> bytes:
    return box(b"colr", b"nclx", struct.pack(">HHHB", cp, tc, mc, full_range << 7))


def prop_icc(profile: bytes) -> bytes:
    return box(b"colr", b"prof", profile)


def prop_auxc(urn: bytes) -> bytes:
    return full(b"auxC", 0, 0, urn + b"\0")


def container(items: list, primary: int, refs: list = (), method: int = 0, extents: int = 1,
              major: bytes = b"avif") -> bytes:
    """HEIF bytes: ``items`` as dicts {id, type, data, props (box bytes),
    hidden}, ``refs`` as (type, from, [to])."""
    props, assoc = [], []
    for it in items:
        idx = []
        for pb in it.get("props", []):
            if pb not in props:
                props.append(pb)
            idx.append(props.index(pb) + 1)
        assoc.append((it["id"], idx))
    ipma = struct.pack(">I", len(assoc)) + b"".join(
        struct.pack(">HB", iid, len(idx)) + bytes([(0x80 if props[i - 1][4:8] in (b"av1C", b"irot", b"imir", b"clap", b"a1lx", b"lsel") else 0) | i for i in idx])
        for iid, idx in assoc)
    iprp = box(b"iprp", box(b"ipco", *props), full(b"ipma", 0, 0, ipma))
    iinf = full(b"iinf", 0, 0, struct.pack(">H", len(items)), *[
        full(b"infe", 2, 1 if it.get("hidden") else 0, struct.pack(">HH", it["id"], 0), it["type"].encode(), b"\0")
        for it in items])
    iref = b""
    if refs:
        iref = full(b"iref", 0, 0, *[box(kind.encode(), struct.pack(">HH", a, len(bs)), *[struct.pack(">H", b) for b in bs])
                                     for kind, a, bs in refs])
    hdlr = full(b"hdlr", 0, 0, b"\0" * 4, b"pict", b"\0" * 12, b"\0")
    pitm = full(b"pitm", 0, 0, struct.pack(">H", primary))
    ftyp = box(b"ftyp", major, struct.pack(">I", 0), b"avif", b"mif1", b"miaf")

    def layout(base: int):
        chunks, entries, pos = [], [], base
        for it in items:
            data = it["data"]
            cut = [len(data) * k // extents for k in range(extents + 1)]
            ext = []
            for a, b in zip(cut, cut[1:]):
                ext.append((pos if method == 0 else pos - base, b - a))
                chunks.append(data[a:b])
                pos += b - a
            entries.append((it["id"], ext))
        version = 1 if method else 0
        body = struct.pack(">BB", 0x44, 0x00) + struct.pack(">H", len(entries))
        for iid, ext in entries:
            body += struct.pack(">H", iid)
            if version:
                body += struct.pack(">H", method)
            body += struct.pack(">HH", 0, len(ext)) + b"".join(struct.pack(">II", o, n) for o, n in ext)
        return full(b"iloc", version, 0, body), b"".join(chunks)

    iloc, payload = layout(0)
    if method == 1:
        meta = full(b"meta", 0, 0, hdlr, pitm, iloc, iinf, iref, iprp, box(b"idat", payload))
        return ftyp + meta
    meta = full(b"meta", 0, 0, hdlr, pitm, iloc, iinf, iref, iprp)
    base = len(ftyp) + len(meta) + 8
    iloc, payload = layout(base)
    meta = full(b"meta", 0, 0, hdlr, pitm, iloc, iinf, iref, iprp)
    return ftyp + meta + box(b"mdat", payload)


# -- the writers ------------------------------------------------------------------

def scenes() -> dict:
    import cv2

    sys.path.insert(0, str(ROOT))
    from dspnet_torch.data import synthetic

    rng = np.random.RandomState(19)
    street = synthetic.make_example(rng, (96, 128), 4)[0]
    tex = cv2.GaussianBlur(rng.randint(0, 256, (64, 96, 3)).astype(np.uint8), (3, 3), 0.8)
    noisy = np.clip(street.astype(int) + rng.randint(-30, 30, street.shape), 0, 255).astype(np.uint8)
    screen = np.full((192, 256, 3), 248, np.uint8)
    for i in range(8):  # repeated lines, which IntraBC copies
        cv2.putText(screen, "Hello AVIF text line", (4, 20 + 22 * i), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (40, 0, 200), 1)
    cv2.rectangle(screen, (200, 10), (250, 60), (30, 160, 30), -1)
    alpha = rng.randint(0, 256, (96, 128)).astype(np.uint8)
    return {"street": street, "tex": tex, "noisy": noisy, "screen": screen, "alpha": alpha}


def cv2_avif(img, params=()) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".avif", img, list(params))
    assert ok
    return buf.tobytes()


def pil_avif(img, **save) -> bytes:
    from PIL import Image

    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="AVIF", **save)
    return buf.getvalue()


def payload(data: bytes) -> dict:
    """The primary AV1 item of an AVIF file: data, av1C, size, depths, colr."""
    sys.path.insert(0, str(ROOT))
    from dspnet_torch.data import heif

    h = heif.parse(data)
    it = h.items[h.primary]
    w, hh = it.props["ispe"]
    out = {"data": it.data, "av1C": box(b"av1C", it.props["av1C"]), "w": w, "h": hh,
           "pixi": tuple(it.props.get("pixi", (8, 8, 8))), "colr": it.props.get("colr")}
    a = h.alpha_of(h.primary)
    if a is not None:
        out["alpha"] = {"data": a.data, "av1C": box(b"av1C", a.props["av1C"]), "w": a.props["ispe"][0],
                        "h": a.props["ispe"][1]}
    return out


def coded(p: dict, iid: int, *extra: bytes, colr: bytes = None, hidden=False) -> dict:
    props = [p["av1C"], prop_ispe(p["w"], p["h"]), prop_pixi(p["pixi"])]
    if colr is None and p["colr"] is not None:
        c = p["colr"]
        colr = prop_nclx(*c[1:5]) if c[0] == "nclx" else prop_icc(c[2])
    if colr:
        props.append(colr)
    return {"id": iid, "type": "av01", "data": p["data"], "props": props + list(extra), "hidden": hidden}


def cv2_forms(s: dict) -> dict:
    import cv2

    st = s["street"]
    q, sp, dp = cv2.IMWRITE_AVIF_QUALITY, cv2.IMWRITE_AVIF_SPEED, cv2.IMWRITE_AVIF_DEPTH
    u10 = st.astype(np.uint16) * 4 + 2
    u12 = st.astype(np.uint16) * 16 + 7
    return {
        "cv2_default.avif": (cv2_avif(st), "cv2 defaults (quality 95, speed 9, 8-bit 4:2:0, qm, CDEF)"),
        "cv2_q30.avif": (cv2_avif(st, [q, 30]), "cv2 quality 30"),
        "cv2_q75.avif": (cv2_avif(st, [q, 75]), "cv2 quality 75"),
        "cv2_q100.avif": (cv2_avif(st, [q, 100]), "cv2 quality 100: lossless 4:4:4, identity matrix"),
        "cv2_s0.avif": (cv2_avif(s["noisy"], [sp, 0]), "cv2 speed 0: loop restoration"),
        "cv2_s5.avif": (cv2_avif(st, [sp, 5]), "cv2 speed 5"),
        "cv2_s10.avif": (cv2_avif(st, [sp, 10]), "cv2 speed 10"),
        "cv2_tex_s0.avif": (cv2_avif(s["tex"], [sp, 0]), "cv2 speed 0 on texture: switchable restoration"),
        "cv2_d10.avif": (cv2_avif(u10, [dp, 10]), "cv2 10-bit"),
        "cv2_d12.avif": (cv2_avif(u12, [dp, 12]), "cv2 12-bit (profile 2)"),
        "cv2_gray.avif": (cv2_avif(st[..., 1]), "cv2 gray: monochrome"),
        "cv2_gray_d10.avif": (cv2_avif(u10[..., 1], [dp, 10]), "cv2 gray 10-bit"),
        "cv2_gray_d12.avif": (cv2_avif(u12[..., 1], [dp, 12]), "cv2 gray 12-bit"),
        "cv2_1x1.avif": (cv2_avif(st[:1, :1]), "cv2 1x1"),
        "cv2_7x5.avif": (cv2_avif(st[:5, :7]), "cv2 7x5"),
        "cv2_65x129.avif": (cv2_avif(cv2.resize(st, (129, 65))), "cv2 129x65"),
        "cv2_screen_s0.avif": (cv2_avif(s["screen"], [sp, 0]), "cv2 speed 0 on screen content: palettes, IntraBC"),
    }


def pil_forms(s: dict) -> dict:
    st, noisy, screen = s["street"], s["noisy"], s["screen"]
    rgba = np.concatenate([st, s["alpha"][..., None]], -1)
    out = {
        "pil_444.avif": (pil_avif(st, subsampling="4:4:4"), "Pillow 4:4:4"),
        "pil_422.avif": (pil_avif(st, subsampling="4:2:2"), "Pillow 4:2:2"),
        "pil_400.avif": (pil_avif(st, subsampling="4:0:0"), "Pillow 4:0:0 (monochrome)"),
        "pil_alpha.avif": (pil_avif(rgba), "Pillow RGBA: alpha auxiliary image"),
        "pil_alpha444.avif": (pil_avif(rgba, subsampling="4:4:4"), "Pillow RGBA 4:4:4"),
        "pil_lossless.avif": (pil_avif(st, quality=100, subsampling="4:4:4"), "Pillow lossless (quality 100)"),
        "pil_tiles.avif": (pil_avif(st, tile_rows=1, tile_cols=1), "Pillow 2x2 tiles"),
        "pil_limited.avif": (pil_avif(st, range="limited"), "Pillow limited range"),
        "pil_full.avif": (pil_avif(st, range="full"), "Pillow full range"),
        "pil_limited444.avif": (pil_avif(st, subsampling="4:4:4", range="limited"), "Pillow limited range 4:4:4"),
        "pil_qm.avif": (pil_avif(noisy, quality=40, advanced={"enable-qm": "1"}), "Pillow quantizer matrices"),
        "pil_screen.avif": (pil_avif(screen, advanced={"tune-content": "screen"}), "Pillow screen content: palettes, IntraBC"),
        "pil_screen444.avif": (pil_avif(screen, subsampling="4:4:4", advanced={"tune-content": "screen"}),
                               "Pillow screen content 4:4:4"),
        "pil_s0.avif": (pil_avif(noisy, speed=0), "Pillow speed 0: 128x128 superblocks, loop restoration"),
        "pil_lr.avif": (pil_avif(noisy, speed=0, advanced={"enable-restoration": "1", "enable-cdef": "1"}),
                        "Pillow loop restoration and CDEF"),
        "pil_sb128.avif": (pil_avif(noisy, advanced={"sb-size": "128", "enable-cdef": "1"}), "Pillow 128x128 superblocks"),
        "pil_444cdef.avif": (pil_avif(noisy, subsampling="4:4:4", advanced={"enable-cdef": "1"}), "Pillow 4:4:4 CDEF"),
        "pil_422cdef.avif": (pil_avif(noisy, subsampling="4:2:2", advanced={"enable-cdef": "1"}), "Pillow 4:2:2 CDEF"),
        "pil_q20.avif": (pil_avif(noisy, quality=20), "Pillow quality 20"),
        "pil_deltalf.avif": (pil_avif(noisy, speed=0, advanced={"deltaq-mode": "3", "delta-lf-mode": "1"}),
                             "Pillow speed 0 with delta q and delta loop filter levels"),
        "pil_q95.avif": (pil_avif(noisy, quality=95), "Pillow quality 95"),
        "pil_odd_grain444.avif": (pil_avif(st[:95, :127], subsampling="4:4:4", advanced={"film-grain-test": "3"}),
                                  "Pillow film grain table 3, 4:4:4, odd size"),
        "pil_odd_grain422.avif": (pil_avif(st[:95, :127], subsampling="4:2:2", advanced={"film-grain-test": "5"}),
                                  "Pillow film grain table 5, 4:2:2, odd size"),
    }
    for t in (1, 6, 10, 16):
        out[f"pil_grain{t}.avif"] = (pil_avif(st, advanced={"film-grain-test": str(t)}), f"Pillow film grain table {t}")
    from PIL import Image

    frames = [Image.fromarray(st[..., ::-1]), Image.fromarray(noisy[..., ::-1])]
    buf = io.BytesIO()
    frames[0].save(buf, format="AVIF", save_all=True, append_images=frames[1:])
    out["pil_sequence.avif"] = (buf.getvalue(), "Pillow two-frame image sequence (avis): the first frame")
    return out


def made_forms(s: dict) -> dict:
    """Hand-assembled containers around cv2's and Pillow's payloads."""
    st = s["street"]
    base = payload(cv2_avif(st))
    b444 = payload(cv2_avif(st, [__import__("cv2").IMWRITE_AVIF_QUALITY, 100]))
    alpha = payload(pil_avif(np.concatenate([st, s["alpha"][..., None]], -1)))
    out = {}
    one = lambda *extra, colr=None, **kw: container([coded(base, 1, *extra, colr=colr)], 1, **kw)
    out["made_idat.avif"] = (one(method=1), "construction method 1: the payload in idat")
    out["made_extents.avif"] = (one(extents=3), "three extents")
    out["made_idat_extents.avif"] = (one(method=1, extents=2), "idat, two extents")
    for a in (1, 2, 3):
        out[f"made_irot{a}.avif"] = (one(box(b"irot", bytes([a]))), f"irot {90 * a} degrees")
    for a in (0, 1):
        out[f"made_imir{a}.avif"] = (one(box(b"imir", bytes([a]))), f"imir axis {a}")
    clap = box(b"clap", struct.pack(">iIiIiIiI", 64, 1, 48, 1, 0, 1, 0, 1))
    out["made_clap.avif"] = (one(clap), "clap 64x48 centred")
    for mc in (1, 5, 6, 9):
        out[f"made_nclx_mc{mc}.avif"] = (one(colr=prop_nclx(1, 13, mc, 1)), f"nclx matrix {mc}, full range")
    out["made_nclx_mc1_limited.avif"] = (one(colr=prop_nclx(1, 1, 1, 0)), "nclx matrix 1, limited range")
    out["made_nclx_mc0.avif"] = (container([coded(b444, 1, colr=prop_nclx(1, 13, 0, 1))], 1),
                                 "nclx matrix 0 (identity) on a 4:4:4 payload")
    out["made_icc.avif"] = (one(colr=prop_icc(b"\0" * 128)), "an ICC colr: CICP from the sequence header")
    out["made_nocolr.avif"] = (one(colr=b""), "no colr: CICP from the sequence header")
    # a 2x2 grid of tiles cut from one scene, output size below the tiles'
    # a 2x2 grid of 64x64 tiles (cv2 refuses smaller ones) cut to 120x100
    sq = __import__("cv2").resize(st, (128, 128))
    tiles = [payload(cv2_avif(sq[y:y + 64, x:x + 64])) for y in (0, 64) for x in (0, 64)]
    items = [{"id": 1, "type": "grid", "data": struct.pack(">BBBBHH", 0, 0, 1, 1, 120, 100),
              "props": [prop_ispe(120, 100), prop_pixi((8, 8, 8)), prop_nclx(1, 13, 6, 1)]}]
    items += [coded(t, 2 + k, hidden=True) for k, t in enumerate(tiles)]
    out["made_grid.avif"] = (container(items, 1, refs=[("dimg", 1, [2, 3, 4, 5])]), "a 2x2 grid cut to 120x100")
    small = [payload(cv2_avif(st[y:y + 48, x:x + 64])) for y in (0, 48) for x in (0, 64)]
    items = [{"id": 1, "type": "grid", "data": struct.pack(">BBBBHH", 0, 0, 1, 1, 128, 96),
              "props": [prop_ispe(128, 96), prop_pixi((8, 8, 8)), prop_nclx(1, 13, 6, 1)]}]
    items += [coded(t, 2 + k, hidden=True) for k, t in enumerate(small)]
    out["made_grid_small.avif"] = (container(items, 1, refs=[("dimg", 1, [2, 3, 4, 5])]),
                                   "a 2x2 grid of 64x48 tiles: cv2 returns None (MIAF's 64-sample minimum)")
    aitem = {"id": 2, "type": "av01", "data": alpha["alpha"]["data"], "hidden": True,
             "props": [alpha["alpha"]["av1C"], prop_ispe(alpha["alpha"]["w"], alpha["alpha"]["h"]), prop_pixi((8,)),
                       prop_auxc(b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha")]}
    out["made_alpha.avif"] = (container([coded(alpha, 1), aitem], 1, refs=[("auxl", 2, [1])]), "alpha by auxl")
    out["made_prem.avif"] = (container([coded(alpha, 1), aitem], 1, refs=[("auxl", 2, [1]), ("prem", 1, [2])]),
                             "premultiplied alpha (prem): refused by the port")
    out["made_a1lx.avif"] = (one(box(b"a1lx", b"\0\0\0\0\0\0\0")), "a layered image (a1lx): refused by the port")
    return out


def big_forms() -> dict:
    import cv2

    sys.path.insert(0, str(ROOT))
    from dspnet_torch.data import synthetic

    rng = np.random.RandomState(22)
    img = synthetic.make_example(rng, BIG, 8)[0]
    img = np.clip(img.astype(np.int16) + rng.randint(-16, 17, img.shape), 0, 255).astype(np.uint8)
    return {"big_default.avif": (cv2_avif(img), "cv2 defaults, 1024x2048 textured street scene"),
            "big_s0.avif": (cv2_avif(img, [cv2.IMWRITE_AVIF_SPEED, 0]),
                            "cv2 speed 0 (loop restoration), 1024x2048 textured street scene")}


def cv2_record(data: bytes) -> dict:
    import cv2

    out = {}
    for key, flag in FLAGS.items():
        img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        out[key] = None if img is None else {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
                                             "dtype": str(img.dtype), "shape": list(img.shape)}
    return out


def all_forms() -> dict:
    s = scenes()
    return {**cv2_forms(s), **pil_forms(s), **made_forms(s), **big_forms()}


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
    assert total < 3 << 20, total


if __name__ == "__main__":
    main()
