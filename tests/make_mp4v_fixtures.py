"""Write the committed MPEG-4 Part 2 forms under ``tests/fixtures/mp4v_forms/``
and record what cv2 decodes of each, so that the port's decoders (the plain
one here, the card's kernels on the card's machine, which has no cv2) are
held to cv2's frames.

    python tests/make_mp4v_fixtures.py

* ``cv2_*``: cv2's own writer (``cv2.VideoWriter``, FFmpeg's ``mpeg4``
  encoder, Simple Profile, I- and P-VOPs, a GOP of 12): ``mp4v`` in
  ``.mp4`` at 176x144 (three GOPs, sub-pixel motion), at 232x136 (not a
  multiple of 16, large motion) and at 2048x1024 (the demo's frame size, a
  GOP of 12 frames: half-pel MVs with ``f_code`` up to 6, both rounding
  types, intra macroblocks in P-VOPs, MVs off the edges of a large frame),
  ``XVID``, ``DIVX`` and ``FMP4`` in ``.avi``; the content moves by whole
  and fractional pixels and an object leaves the frame (unrestricted
  MVs).
* ``w_*``: the port's per-symbol writer (``tests/mp4v_forms_writer.py``)
  for what cv2's writer cannot make here: 4MV (with MVs off the frame's
  edges, ``f_code`` 1-3 and both rounding types), resync markers and video
  packets with ``header_extension_code``, rounding type 1 from samples of
  0, MPEG quantisation with loaded and with default matrices, DQUANT,
  intra macroblocks with AC prediction in P-VOPs, ``intra_dc_vlc_thr``,
  VOPs with ``vop_coded`` 0, every TCOEF code of both tables with escapes
  1, 2 and 3, and an odd height (96x63: the deliberate difference below).
* ``r_*``: one small stream per refused tool (the port raises, naming it).

``forms.json`` records for each stream its container, fourcc, size, fps and
cv2's frame count, and each frame's sha256 as cv2 returns it (BGR) and of
its luma plane (``CAP_PROP_CONVERT_RGB`` 0 returns the Y plane), and for a
refusal the words the port's error must hold; for the odd-height form (the
deliberate difference) also the port's frames' sha256 and their mean and
largest gap to cv2's. Every file stays under 1 MB.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))
FIXTURE = ROOT / "tests" / "fixtures" / "mp4v_forms"
SEED = 17


def texture(rng, h: int, w: int, black: bool = True, grain: int = 6) -> np.ndarray:
    """A smooth random colour texture, one random colour every ``grain``
    pixels, with flat black and white bands (samples of 0 pin the
    rounding-type-1 half-pel rule)."""
    import cv2

    base = rng.integers(0, 256, (h // grain + 2, w // grain + 2, 3), dtype=np.uint8)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    if black:
        img[h // 3:h // 3 + max(4, h // 10)] = 0
        img[:, w // 3:w // 3 + max(4, w // 12)] = 255
        img[2 * h // 3:2 * h // 3 + 6, w // 2:w // 2 + w // 5] = (250, 250, 250)
    return img


def clip(rng, h: int, w: int, n: int, step=(3.5, -2.25), grain: int = 6) -> list:
    """n frames of a texture moving by ``step`` pixels a frame (fractional
    steps give sub-pixel motion), with a disc that leaves the frame."""
    import cv2

    pad = int(abs(step[0]) * n + abs(step[1]) * n) + 8
    base = texture(rng, h + 2 * pad, w + 2 * pad, grain=grain)
    frames = []
    for i in range(n):
        m = np.float32([[1, 0, -pad - step[0] * i], [0, 1, -pad - step[1] * i]])
        f = cv2.warpAffine(base, m, (w, h), flags=cv2.INTER_LINEAR)
        cx, cy = int(w * 0.5 + i * w * 0.11), int(h * 0.5 - i * h * 0.09)
        cv2.circle(f, (cx, cy), max(6, w // 8), (0, 0, 255), -1)
        cv2.rectangle(f, (w - 1 - cx, h - 1 - cy), (w - 1 - cx + w // 6, h - 1 - cy + h // 6), (255, 255, 0), -1)
        frames.append(f)
    return frames


def cv2_write(path: Path, fourcc: str, frames) -> None:
    import cv2

    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25, (w, h))
    assert vw.isOpened(), path
    for f in frames:
        vw.write(f)
    vw.release()


def port_write(path: Path, fw, samples) -> None:
    from dspnet_torch.data import mp4

    with mp4.Mp4Writer(str(path), fw.width, fw.height, fw.config) as out:
        for data, key in samples:
            out.write(data, key)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def cv2_read(path: Path, convert: bool = True):
    import cv2

    params = [] if convert else [cv2.CAP_PROP_CONVERT_RGB, 0]
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG, params)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    fps, count = cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return frames, fps, count


# ------------------------------------------------------------------ the port's forms

def w_forms(rng):
    """(name, FormWriter, [(sample, keyframe)], what it exercises)."""
    from dspnet_torch.data import mpeg4
    from mp4v_forms_writer import FormWriter, Mb

    out = []
    I, P, P4, INTRA = mpeg4.MODE_INTER, mpeg4.MODE_INTER, mpeg4.MODE_INTER4V, mpeg4.MODE_INTRA

    def mvs4(r, lim):
        return [tuple(int(v) for v in r.integers(-lim, lim + 1, 2)) for _ in range(4)]

    # 4MV, MVs off the edges, f_code 1-3, both rounding types, at a size
    # that is not a multiple of 16
    frames = clip(rng, 88, 120, 7, (2.5, 1.5))
    fw = FormWriter(120, 88)
    samples = [(fw.vop(frames[0], "I", 4), True)]
    for k in range(1, 7):
        fcode = 1 + (k - 1) % 3
        lim = (16 << (fcode - 1)) - 1
        plan = {}
        for i in range(fw.vol.mb_num):
            kind = rng.integers(0, 10)
            if kind < 5:
                plan[i] = Mb(P4, mvs4(rng, lim))
            elif kind < 8:
                plan[i] = Mb(I, [tuple(int(v) for v in rng.integers(-lim, lim + 1, 2))] * 4)
            elif kind < 9:
                plan[i] = Mb(INTRA)
        samples.append((fw.vop(frames[k], "P", 4 + k % 3, plan, fcode=fcode, rounding=k % 2), False))
    out.append(("w_4mv.mp4", fw, samples, "4MV and 1MV P-VOPs, MVs off the frame's edges, f_code 1-3, rounding 0 and 1, "
                                          "120x88"))

    # video packets with header_extension_code, packet quantisers, intra
    # with AC prediction, 4MV and DQUANT across packet edges
    frames = clip(rng, 80, 112, 5, (1.5, 2.5))
    fw = FormWriter(112, 80, resync_every=5, hec=True)
    n = fw.vol.mb_num
    plan = {i: Mb(INTRA, dquant=int(rng.integers(0, 4)) if i % 3 == 0 else None, ac_pred=i % 2) for i in range(n)}
    samples = [(fw.vop(frames[0], "I", 6, plan, packet_qp={10: 9, 20: 4}), True)]
    for k in range(1, 5):
        plan = {}
        for i in range(n):
            kind = rng.integers(0, 8)
            if kind < 3:
                plan[i] = Mb(P4, mvs4(rng, 15))
            elif kind < 5:
                plan[i] = Mb(INTRA, ac_pred=int(rng.integers(0, 2)), dquant=int(rng.integers(0, 4)) if kind == 4 else None)
            elif kind < 7:
                plan[i] = Mb(I, [tuple(int(v) for v in rng.integers(-15, 16, 2))] * 4,
                             dquant=int(rng.integers(0, 4)) if kind == 6 else None)
        samples.append((fw.vop(frames[k], "P", 5, plan, packet_qp={15: 7}, rounding=k % 2), False))
    out.append(("w_resync.mp4", fw, samples, "resync markers every 5 macroblocks, video packet headers with HEC and "
                                             "quant_scale, intra AC prediction, 4MV, DQUANT"))

    # MPEG quantisation: loaded matrices, then the default ones
    for name, intra_m, inter_m in (("w_mpeg_quant.mp4", [8 + (i * 7) % 40 for i in range(64)],
                                    [16 + (i * 5) % 30 for i in range(64)]),
                                   ("w_mpeg_default.mp4", None, None)):
        frames = clip(rng, 64, 96, 5, (3.5, -1.5))
        fw = FormWriter(96, 64, mpeg_quant=True, intra_matrix=intra_m, inter_matrix=inter_m)
        samples = [(fw.vop(frames[0], "I", 3), True)]
        for k in range(1, 5):
            plan = {i: Mb(I, [(7, -3)] * 4) if i % 4 else Mb(INTRA, ac_pred=1) for i in range(fw.vol.mb_num)}
            samples.append((fw.vop(frames[k], "P", 2 + k, plan, rounding=k % 2), False))
        what = "MPEG quantisation with loaded intra and inter matrices" if intra_m else \
            "MPEG quantisation with the default matrices"
        out.append((name, fw, samples, what + ", intra and inter blocks (the inter mismatch control)"))

    # DQUANT everywhere, intra AC prediction across neighbours of other
    # quantisers, in I- and P-VOPs
    frames = clip(rng, 64, 96, 5, (-2.5, 0.5))
    fw = FormWriter(96, 64)
    n = fw.vol.mb_num
    plan = {i: Mb(INTRA, dquant=int(rng.integers(0, 4)), ac_pred=1) for i in range(n)}
    samples = [(fw.vop(frames[0], "I", 8, plan), True)]
    for k in range(1, 5):
        plan = {i: Mb(INTRA if i % 2 else I, dquant=int(rng.integers(0, 4)), ac_pred=1) for i in range(n)}
        samples.append((fw.vop(frames[k], "P", 8, plan), False))
    out.append(("w_dquant.mp4", fw, samples, "DQUANT on every macroblock, intra AC prediction from neighbours of "
                                             "other quantisers (the rescaling), in I- and P-VOPs"))

    # intra_dc_vlc_thr 3 (DC as AC from QP 17), quantisers crossing it
    frames = clip(rng, 48, 64, 4, (1.0, 1.0))
    fw = FormWriter(64, 48, dc_threshold=3)
    n = fw.vol.mb_num
    samples = [(fw.vop(frames[0], "I", 16, {i: Mb(INTRA, dquant=(2, 1, 3, 0)[i % 4], ac_pred=i % 2)
                                            for i in range(n)}), True)]
    for k in range(1, 4):
        samples.append((fw.vop(frames[k], "P", 17, {i: Mb(INTRA, dquant=(0, 2)[i % 2], ac_pred=1) if i % 3 == 0
                                                    else Mb(I, [(2, 1)] * 4) for i in range(n)}), False))
    out.append(("w_dc_threshold.mp4", fw, samples, "intra_dc_vlc_thr 3: intra DC coded as AC from QP 17, "
                                                   "quantisers crossing it"))

    # vop_coded = 0
    frames = clip(rng, 48, 64, 6, (2.0, 1.0))
    fw = FormWriter(64, 48)
    samples = [(fw.vop(frames[0], "I", 4), True), (fw.vop(frames[1], "P", 4), False), (fw.skipped_vop(), False),
               (fw.vop(frames[3], "P", 4), False), (fw.skipped_vop(), False), (fw.vop(frames[5], "P", 4), False)]
    out.append(("w_not_coded.mp4", fw, samples, "VOPs with vop_coded 0 between coded P-VOPs"))

    # rounding type 1 from a reference of samples 0 beside odd ones (where
    # FFmpeg's x86 no-rounding half-pel average is not the standard's)
    fw = FormWriter(64, 48)
    n = fw.vol.mb_num
    lv = np.zeros((6, 64), np.int64)
    lv[:, 1], lv[:, 8], lv[:, 9] = 3, -2, 1  # a small ripple around 0 (DC level 0)
    dark = {i: Mb(INTRA, levels=lv * (1 if i % 2 else -1)) for i in range(n)}
    flat = np.zeros((48, 64, 3), np.uint8)
    samples = [(fw.vop(flat, "I", 2, dark), True)]
    for k, mv in enumerate([(1, 0), (0, 1), (1, 1), (3, -1), (-1, 3)]):
        plan = {i: Mb(I, [mv] * 4, levels=np.zeros((6, 64), np.int64)) if i % 3 else
                Mb(P4, [mv, (1, 0), (0, 1), (1, 1)], levels=np.zeros((6, 64), np.int64)) for i in range(n)}
        samples.append((fw.vop(flat, "P", 2, plan, rounding=1 - k % 2 * 0), False))
    out.append(("w_rounding.mp4", fw, samples, "rounding type 1 half-pel prediction from samples of 0 beside odd ones"))

    # every TCOEF code of both tables, and escapes 1, 2 and 3
    out.append(("w_codes.mp4",) + codes_form(rng))

    # an odd height, which cv2 converts to BGR through swscale's scaling
    # path (the port's colour rule is the unscaled converter's)
    frames = clip(rng, 63, 96, 3, (1.5, 0.5))
    fw = FormWriter(96, 63)
    samples = [(fw.vop(frames[0], "I", 4), True)] + [(fw.vop(f, "P", 4), False) for f in frames[1:]]
    out.append(("w_odd_height.mp4", fw, samples, "an odd height (96x63): luma equal to cv2's; cv2's colour through "
                                                 "swscale's scaling path is a deliberate difference"))
    return out


def codes_form(rng):
    """An I-VOP and a P-VOP whose blocks' levels are given outright: every
    (last, run, level) of the intra and of the inter table, then levels and
    runs past each table (escapes 1 and 2) and large levels (escape 3)."""
    from dspnet_torch.data import mpeg4
    from mp4v_forms_writer import FormWriter, Mb

    def symbols(rll, lmax, rmax):
        syms = [(r, l) for last, r, l in rll if last == 0]
        syms += [(r, int(lmax[0, r]) + 1 + (r % 2)) for r in range(int(np.nonzero(lmax[0])[0].max()) + 1)]
        syms += [(int(rmax[0, l]) + 1 + (l % 3), l) for l in range(1, int(lmax[0, 0]) + 1)]
        syms += [(int(rng.integers(0, 20)), int(v)) for v in (100, -100, 2047, -2047, 600, -777, 1234, 64)]
        lasts = [(r, l) for last, r, l in rll if last == 1]
        lasts += [(r, int(lmax[1, r]) + 1) for r in range(int(np.nonzero(lmax[1])[0].max()) + 1)]
        lasts += [(int(rmax[1, l]) + 2, l) for l in range(1, int(lmax[1, 0]) + 1)]
        return syms, lasts

    def blocks(syms, lasts, first):
        """Fill blocks in scan order: symbols until the block is full, then
        one of ``lasts`` as its last; -> (64,) raster level lists."""
        out, pos, cur, li = [], first, [0] * 64, 0
        for r, l in syms:
            if pos + r + 1 > 50:
                rr, ll = lasts[li % len(lasts)]
                li += 1
                if pos + rr + 1 <= 63:
                    cur[mpeg4.ZIGZAG[pos + rr + 1]] = ll if li % 2 else -ll
                out.append(cur)
                pos, cur = first, [0] * 64
            pos += r + 1
            cur[mpeg4.ZIGZAG[pos]] = l if (pos % 2) else -l
        while li < len(lasts):
            rr, ll = lasts[li]
            li += 1
            if first + rr + 1 <= 63:
                cur[mpeg4.ZIGZAG[first + rr + 1]] = ll
            out.append(cur)
            cur = [0] * 64
        return out

    fw = FormWriter(96, 64)
    n = fw.vol.mb_num
    intra_blocks = blocks(*symbols(mpeg4.INTRA_RLL, mpeg4.INTRA_LMAX, mpeg4.INTRA_RMAX), 0)
    inter_blocks = blocks(*symbols(mpeg4.INTER_RLL, mpeg4.INTER_LMAX, mpeg4.INTER_RMAX), -1)
    assert len(intra_blocks) <= 6 * n and len(inter_blocks) <= 6 * n, (len(intra_blocks), len(inter_blocks))

    def plan(blks, mode):
        out = {}
        for i in range(n):
            lv = np.zeros((6, 64), np.int64)
            for b in range(6):
                if i * 6 + b < len(blks):
                    lv[b] = blks[i * 6 + b]
            if mode == mpeg4.MODE_INTRA:
                lv[:, 0] = 16
            out[i] = Mb(mode, levels=lv)
        return out

    frame = np.full((64, 96, 3), 128, np.uint8)
    samples = [(fw.vop(frame, "I", 2, plan(intra_blocks, mpeg4.MODE_INTRA)), True),
               (fw.vop(frame, "P", 2, plan(inter_blocks, mpeg4.MODE_INTER)), False)]
    return fw, samples, "every intra and inter TCOEF code, escapes 1, 2 and 3 (levels to +-2047)"


# ------------------------------------------------------------------ refusals

def r_forms():
    """(name, config, samples, the words the port's error holds)."""
    from dspnet_torch.data import mpeg4
    from mp4v_forms_writer import FormWriter, vol_bits

    frame = np.full((16, 16, 3), 90, np.uint8)
    fw = FormWriter(16, 16)
    i_vop = fw.vop(frame, "I", 4)

    def vop_of(kind_bits: int) -> bytes:
        w = mpeg4.BitWriter().put(0x1B6, 32).put(kind_bits, 2).put(0, 1).put(1, 1).put(1, 5).put(1, 1).put(1, 1)
        return w.put(0, 1).put(0, 3).put(4, 5).put(1, 3).stuff().bytes()

    out = [("r_bvop.mp4", fw.config, [i_vop, vop_of(2)], "B-VOPs"),
           ("r_svop.mp4", fw.config, [i_vop, vop_of(3)], "S(GMC)-VOPs"),
           ("r_packed.mp4", fw.config, [i_vop + vop_of(1)], "packed bitstream"),
           ("r_divx_packed.mp4", vol_bits(16, 16, user_data=b"DivX503b1393p"), [i_vop], "DivX packed bitstream"),
           ("r_xvid.mp4", vol_bits(16, 16, user_data=b"XviD0050"), [i_vop], "XviD")]
    flags = [("r_quarter_pel.mp4", dict(ver_id=2, quarter=True), "quarter-pel"),
             ("r_interlaced.mp4", dict(interlaced=True), "interlaced"),
             ("r_partitioned.mp4", dict(partitioned=True), "data partitioning"),
             ("r_rvlc.mp4", dict(partitioned=True, rvlc=True), "reversible VLC"),
             ("r_nbit.mp4", dict(not_8_bit=True), "N-bit"),
             ("r_scalability.mp4", dict(scalability=True), "scalability"),
             ("r_shape.mp4", dict(shape=1), "non-rectangular shape"),
             ("r_sprite.mp4", dict(sprite=1), "sprites"),
             ("r_complexity.mp4", dict(complexity=True), "complexity estimation")]
    for name, kw, words in flags:
        out.append((name, vol_bits(16, 16, **kw), [i_vop], words))
    return out


def main() -> None:
    from dspnet_torch.data import mp4

    rng = np.random.default_rng(SEED)
    FIXTURE.mkdir(parents=True, exist_ok=True)
    for old in FIXTURE.iterdir():
        old.unlink()
    forms = {}
    cv2_forms = [("cv2_mp4v.mp4", "mp4v", clip(rng, 144, 176, 26, (3.5, -2.25)),
                  "cv2's mp4v writer, 176x144, three GOPs, sub-pixel motion, an object leaving the frame"),
                 ("cv2_mp4v_232x136.mp4", "mp4v", clip(rng, 136, 232, 14, (19.0, -13.0)),
                  "cv2's mp4v writer at 232x136 (not a multiple of 16), large motion (f_code > 1)"),
                 ("cv2_xvid.avi", "XVID", clip(rng, 96, 128, 14, (2.5, 1.5)), "cv2's XVID AVI, two GOPs"),
                 ("cv2_divx.avi", "DIVX", clip(rng, 96, 128, 14, (-4.5, 3.0)), "cv2's DIVX AVI, two GOPs"),
                 ("cv2_fmp4.avi", "FMP4", clip(rng, 96, 128, 14, (7.0, -0.5)), "cv2's FMP4 AVI, two GOPs")]
    # the demo's frame size, from a generator of its own (the forms above
    # stay as they were); a coarser texture keeps it under 1 MB
    cv2_forms.append(("cv2_mp4v_2048x1024.mp4", "mp4v",
                      clip(np.random.default_rng(SEED + 1), 1024, 2048, 12, (21.5, -9.5), grain=16),
                      "cv2's mp4v writer at 2048x1024, 12 frames (a GOP): half-pel MVs with f_code up to 6, "
                      "rounding 0 and 1, intra macroblocks in P-VOPs, MVs off the frame's edges"))
    for name, fourcc, frames, what in cv2_forms:
        cv2_write(FIXTURE / name, fourcc, frames)
        forms[name] = {"source": "cv2", "what": what}
    for name, fw, samples, what in w_forms(rng):
        port_write(FIXTURE / name, fw, samples)
        forms[name] = {"source": "port writer", "what": what, "samples": len(samples)}
    for name, config, samples, words in r_forms():
        with mp4.Mp4Writer(str(FIXTURE / name), 16, 16, config) as out:
            for k, s in enumerate(samples):
                out.write(s, k == 0)
        forms[name] = {"source": "refusal", "refused": words}
    for name, rec in forms.items():
        path = FIXTURE / name
        assert path.stat().st_size < 1 << 20, name
        rec["bytes"] = path.stat().st_size
        if rec["source"] == "refusal":
            continue
        frames, fps, count = cv2_read(path)
        luma, _, _ = cv2_read(path, convert=False)
        assert frames and len(luma) == len(frames), name
        rec.update({"fourcc": name.split(".")[0].split("_")[1].upper() if name.endswith(".avi") else "mp4v",
                    "width": frames[0].shape[1], "height": frames[0].shape[0], "fps": fps, "declared": count,
                    "frames": len(frames), "bgr_sha256": [sha(f) for f in frames],
                    "luma_sha256": [sha(f) for f in luma]})
        if frames[0].shape[0] % 2:
            # the deliberate difference: the port's frames, and their gap to cv2's
            from dspnet_torch.data import avi, mpeg4_cuda

            with avi.open_video(path) as reader:
                dec = mpeg4_cuda.Decoder("cpu", reader.stream.extradata, reader.stream.fourcc)
                port = [f.numpy() for f in dec.decode(list(reader))]
            gap = np.concatenate([np.abs(a.astype(np.int16) - b).ravel() for a, b in zip(port, frames)])
            rec.update({"port_bgr_sha256": [sha(f) for f in port],
                        "bgr_gap": {"mean": round(float(gap.mean()), 4), "max": int(gap.max())}})
    (FIXTURE / "forms.json").write_text(json.dumps(forms, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in FIXTURE.iterdir())
    print(f"{len(forms)} forms, {total} bytes")


if __name__ == "__main__":
    main()
