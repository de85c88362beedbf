"""H.264 read as cv2 5.0.0 reads it (FFmpeg's h264 decoder behind
``cv2.VideoCapture``, the JAX branch's ``dspnet_tpu/detect/detector.py:289``),
on the CPU: ``data/h264_cuda.Decoder`` runs the plain stages there
(``h264_parse``, ``h264_recon``, ``h264_filters``), which the card's
kernels equal (``tests/test_torch_h264_emulated.py`` holds the kernels'
source to them on the CPU, ``chip_smoke.py`` phase 23 on the card).

* every committed form of ``tests/fixtures/h264_forms/`` (from
  ``tests/make_h264_fixtures.py``) gives cv2's frames: the same count, order
  and sha256 of every BGR frame (``forms.json``); each refusal raises naming
  what the stream holds; the 1024x2048 clip's first picture on the CPU (its
  every frame in the emulated-kernel test: the plain decoder takes tens of
  seconds a picture at that size);
* the tables against libavcodec's bytes (``tests/make_h264_tables.py``
  extracts them anew) and by structure;
* plain stages against independent steps of their own: the transforms,
  6-tap interpolation and weighted prediction on random blocks;
* refusals by name on hand-made streams;
* the JAX branch against the port's ``detect_video`` on an H.264 clip;
* a hypothesis property: small random-syntax streams from the writer equal
  cv2's decode.
"""

from __future__ import annotations

import functools
import hashlib
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dspnet_torch.data import avi, h264_cuda, h264_recon
from dspnet_torch.data import h264_nal as N
from dspnet_torch.data import h264_tables as T
from tests import h264_writer as W
from tests import make_h264_fixtures as F

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

ROOT = Path(__file__).resolve().parents[1]
FORMS = ROOT / "tests" / "fixtures" / "h264_forms"
META = json.loads((FORMS / "forms.json").read_text())["forms"]


def sha(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def cv2_frames(path):
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG)
    out = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        out.append(img)
    cap.release()
    return out


def port_frames(path, limit=None):
    """The port's frames of a file on the CPU (the first ``limit`` samples
    only, then flushed, when given)."""
    with avi.open_video(path) as reader:
        samples, stream = list(reader), reader.stream
    assert stream.codec == "h264"
    dec = h264_cuda.Decoder("cpu", stream.extradata, stream.fourcc)
    samples = samples[:limit] if limit else samples
    out = []
    for i in range(0, len(samples), 8):
        out += dec.decode(samples[i:i + 8])
    return [f.numpy() for f in out + dec.flush()]


@functools.lru_cache(maxsize=None)
def decoded(name):
    """Each form decoded once: (sha256 list, or the refusal's message)."""
    try:
        return [sha(f) for f in port_frames(FORMS / name, limit=1 if name.startswith("big") else None)], None
    except avi.VideoError as e:  # H264Error is one
        return None, str(e)


@pytest.mark.parametrize("name", sorted(META))
def test_committed_form_equals_cv2(name):
    """A committed form through the port on the CPU: cv2's frames in number,
    order and pixels (sha256), or the refusal naming its tool."""
    m = META[name]
    got, refused = decoded(name)
    if "refused" in m:
        assert got is None and m["refused"] in refused, refused
        return
    assert refused is None, refused
    if name.startswith("big"):  # the first picture, I: displayed first
        assert got == m["bgr_sha256"][:1] and m["frames"] == 13
        return
    assert got == m["bgr_sha256"]


def test_forms_cover_the_tools():
    """The committed forms: every coding tool the decoder reads has a form,
    each form is at most 1 MB, and cv2's frame counts are recorded."""
    names = set(META)
    assert {"cavlc_intra.mp4", "cavlc_p_4refs.mp4", "cavlc_longterm_mmco.mp4", "cabac_ipbb_spatial.mp4",
            "cabac_ipbb_temporal.mp4", "cabac_wp_explicit.mp4", "cabac_wp_implicit.mp4", "cabac_poc1.mp4",
            "cabac_poc2.mp4", "cabac_init_idc.mp4", "high_8x8_cabac.mp4", "high_8x8_cavlc.mp4",
            "high_scaling_sps.mp4", "high_scaling_pps.mp4", "crop_right_bottom_top.mp4", "avc3_inband.mp4",
            "annexb_h264.avi", "no_vui.mp4", "vui_no_restriction.mp4", "full_range.mp4", "bt709.mp4",
            "big_1024x2048.mp4"} <= names
    assert sum("refused" in m for m in META.values()) >= 12
    assert all((FORMS / n).stat().st_size <= 1 << 20 for n in names)
    assert META["big_1024x2048.mp4"]["frames"] == 13
    # FFmpeg's reorder heuristic drops a frame of the pyramid without VUI
    assert META["no_vui_pyramid.mp4"]["frames"] == 8


def test_tables_against_libavcodec():
    """``h264_tables.npz`` holds what ``make_h264_tables.py`` reads from cv2's
    libavcodec now, table by table (found by first values, checked by
    structure there)."""
    from tests import make_h264_tables as M

    fresh = M.extract(M.libavcodec())
    saved = np.load(ROOT / "dspnet_torch" / "data" / "h264_tables.npz")
    assert sorted(fresh) == sorted(saved.files)
    for k in fresh:
        np.testing.assert_array_equal(fresh[k], saved[k], err_msg=k)


def test_tables_by_structure():
    """Prefix codes, zig-zags, the CABAC state machine and normAdjust."""
    for table in T.COEFF_TOKEN + T.TOTAL_ZEROS + T.CDC_TOTAL_ZEROS + T.RUN_BEFORE:
        codes = sorted(table)
        for i, (l1, c1) in enumerate(codes):
            for l2, c2 in codes[i + 1:]:
                assert not (l2 >= l1 and c2 >> (l2 - l1) == c1)
    for zz, n in ((T.ZIGZAG4, 4), (T.ZIGZAG8, 8)):
        assert sorted(zz) == list(range(n * n))
        assert all(abs(zz[i + 1] // n - zz[i] // n) <= 1 and abs(zz[i + 1] % n - zz[i] % n) <= 1
                   for i in range(n * n - 1))
    assert list(T.TRANS_MPS[:62]) == list(range(1, 63)) and T.RANGE_LPS.shape == (64, 4)
    assert (np.diff(T.RANGE_LPS[:63], axis=1) > 0).all() and (T.RANGE_LPS[63] == 2).all()
    assert T.NORM4[0, 0] == 10 and T.NORM4[0, 5] == 16 and T.NORM4[0, 1] == 13
    assert T.NORM8[0, 0] == 20 and T.NORM8[5, 63] == 32 and T.NORM8[5, 18] == 58
    assert T.CHROMA_QP[29] == 29 and T.CHROMA_QP[30] == 29 and T.CHROMA_QP[51] == 39
    assert (T.CABAC_INIT[3, 11:60] == 0).all()


def _idct4_spec(d):
    """8.5.12.2 written out per element."""
    d = [list(map(int, r)) for r in d]
    f = [[0] * 4 for _ in range(4)]
    for i in range(4):
        e0 = d[i][0] + d[i][2]
        e1 = d[i][0] - d[i][2]
        e2 = (d[i][1] >> 1) - d[i][3]
        e3 = d[i][1] + (d[i][3] >> 1)
        f[i] = [e0 + e3, e1 + e2, e1 - e2, e0 - e3]
    r = [[0] * 4 for _ in range(4)]
    for j in range(4):
        g0 = f[0][j] + f[2][j]
        g1 = f[0][j] - f[2][j]
        g2 = (f[1][j] >> 1) - f[3][j]
        g3 = f[1][j] + (f[3][j] >> 1)
        h = [g0 + g3, g1 + g2, g1 - g2, g0 - g3]
        for i in range(4):
            r[i][j] = (h[i] + 32) >> 6
    return np.array(r)


def test_plain_stages_against_independent_steps():
    """The plain transforms and interpolation against element-by-element
    versions of the standard's equations on random blocks."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        d = rng.integers(-2000, 2000, (4, 4))
        np.testing.assert_array_equal(h264_recon.idct4(d[None])[0], _idct4_spec(d))
    for _ in range(20):
        d = rng.integers(-1000, 1000, (8, 8))
        np.testing.assert_array_equal(h264_recon.idct8(d[None])[0], _idct8_spec(d))
    # luma interpolation: half samples by the 6-tap filter, per sample
    ref = rng.integers(0, 256, (1, 24, 24)).astype(np.uint8)
    for mvx in range(-6, 7):
        for mvy in range(-6, 7):
            got = h264_recon.luma_pred(ref, np.array([0]), np.array([8]), np.array([8]), np.array([mvx]),
                                       np.array([mvy]))[0]
            want = _luma_spec(ref[0].astype(np.int64), 8, 8, mvx, mvy)
            np.testing.assert_array_equal(got, want, err_msg=f"mv {mvx}, {mvy}")


def _idct8_spec(d):
    """8.5.13 written out per element: rows, then columns."""
    def one(x):
        x = [int(v) for v in x]
        a = [x[0] + x[4], 0, (x[2] >> 1) - x[6], 0, x[0] - x[4], 0, x[2] + (x[6] >> 1), 0]
        a[1] = -x[3] + x[5] - x[7] - (x[7] >> 1)
        a[3] = x[1] + x[7] - x[3] - (x[3] >> 1)
        a[5] = -x[1] + x[7] + x[5] + (x[5] >> 1)
        a[7] = x[3] + x[5] + x[1] + (x[1] >> 1)
        b = [a[0] + a[6], a[1] + (a[7] >> 2), a[4] + a[2], a[3] + (a[5] >> 2), a[4] - a[2], (a[3] >> 2) - a[5],
             a[0] - a[6], a[7] - (a[1] >> 2)]
        return [b[0] + b[7], b[2] + b[5], b[4] + b[3], b[6] + b[1], b[6] - b[1], b[4] - b[3], b[2] - b[5], b[0] - b[7]]

    rows = [one(r) for r in d]
    cols = [one([rows[i][j] for i in range(8)]) for j in range(8)]
    return np.array([[(cols[j][i] + 32) >> 6 for j in range(8)] for i in range(8)])


def _luma_spec(p, x0, y0, mvx, mvy):
    """8.4.2.2.1 per sample, from the standard's sample names."""
    def s(x, y):
        return int(p[min(max(y, 0), p.shape[0] - 1), min(max(x, 0), p.shape[1] - 1)])

    def tap(v):
        return v[0] - 5 * v[1] + 20 * v[2] + 20 * v[3] - 5 * v[4] + v[5]

    def c1(v):
        return min(max(v, 0), 255)

    out = np.zeros((4, 4), np.int64)
    for i in range(4):
        for j in range(4):
            xi, yi = x0 + j + (mvx >> 2), y0 + i + (mvy >> 2)
            fx, fy = mvx & 3, mvy & 3
            G, H, M = s(xi, yi), s(xi + 1, yi), s(xi, yi + 1)
            b1 = tap([s(xi + k, yi) for k in range(-2, 4)])
            h1 = tap([s(xi, yi + k) for k in range(-2, 4)])
            s1 = tap([s(xi + k, yi + 1) for k in range(-2, 4)])
            m1 = tap([s(xi + 1, yi + k) for k in range(-2, 4)])
            j1 = tap([tap([s(xi + k, yi + r) for k in range(-2, 4)]) for r in range(-2, 4)])
            b, h, ss, m, jj = c1((b1 + 16) >> 5), c1((h1 + 16) >> 5), c1((s1 + 16) >> 5), c1((m1 + 16) >> 5), \
                c1((j1 + 512) >> 10)
            a = lambda u, v: (u + v + 1) >> 1  # noqa: E731
            table = {(0, 0): G, (0, 1): a(G, h), (0, 2): h, (0, 3): a(M, h), (1, 0): a(G, b), (1, 1): a(b, h),
                     (1, 2): a(h, jj), (1, 3): a(h, ss), (2, 0): b, (2, 1): a(b, jj), (2, 2): jj, (2, 3): a(jj, ss),
                     (3, 0): a(H, b), (3, 1): a(b, m), (3, 2): a(jj, m), (3, 3): a(m, ss)}
            out[i, j] = table[(fx, fy)]
    return out


def _sps_stream(tmp_path, name, **kw):
    sps = W.make_sps(**kw)
    bw = W.BitWriter()
    N.sps_syntax(bw, sps)
    bw.trailing()
    path = tmp_path / name
    W.write_mp4(path, [b"\x00\x00\x00\x02\x09\xf0"], 176, 144, W.avcc([W.nal(3, N.NAL_SPS, bw.data())], []))
    return path


def test_refusals_by_name(tmp_path):
    """Streams the port does not read raise naming the tool: a PPS with slice
    groups (FMO), an SP slice, data partitioning, a gap in frame_num, an edit
    list that drops frames (cv2 returns no frames for it), MMCO 5, an
    interlaced SPS, a bit depth above 8."""
    sw = W.StreamWriter(1)
    sps = sw.add_sps(W.make_sps())
    bw = W.BitWriter()
    for v in (0, 0):
        bw.ue(v)
    bw.u(2, 0)
    bw.ue(2)  # num_slice_groups_minus1
    bw.trailing()
    fmo = W.nal(3, N.NAL_PPS, bw.data())
    with pytest.raises(N.H264Error, match="slice groups"):
        h264_cuda.Decoder("cpu", W.avcc([sps], [fmo]))
    pps = sw.add_pps(W.make_pps())
    dec = h264_cuda.Decoder("cpu", W.avcc([sps], [pps]))
    with pytest.raises(N.H264Error, match="data partitioning"):
        dec.decode([W.length_prefixed([bytes([0x62, 0x80])])])
    bw = W.BitWriter()
    for v in (0, 3, 0):  # first_mb, slice_type SP, pps
        bw.ue(v)
    bw.trailing()
    with pytest.raises(N.H264Error, match="SP slice"):
        h264_cuda.Decoder("cpu", W.avcc([sps], [pps])).decode([W.length_prefixed([W.nal(2, 1, bw.data())])])
    i0 = sw.picture(dict(slice_type_raw=7, pps_id=0, frame_num=0, idr_pic_id=0, slice_qp=28), 5, 3)
    gap = sw.picture(dict(slice_type_raw=5, pps_id=0, frame_num=3, slice_qp=28, num_ref_idx=[1, 0]), 1, 2)
    with pytest.raises(N.H264Error, match="gap in frame_num"):
        h264_cuda.Decoder("cpu", W.avcc([sps], [pps])).decode([W.length_prefixed(i0), W.length_prefixed(gap)])
    _, params, pics, size = F.stream(8, {}, F.CABAC, F.gop(4))
    cts, shift = F.composition([h["poc_lsb"] for h, _, _ in F.gop(4)])
    path = tmp_path / "drop.mp4"
    W.write_mp4(path, [W.length_prefixed(p) for p in pics], size[0], size[1], W.avcc(params[:1], params[1:]),
                cts=cts, edit=(shift + 512, 160))
    assert cv2_frames(path) == []
    with pytest.raises(avi.VideoError, match="edit list that drops frames"):
        avi.open_video(path)
    _, params, pics, size = F.stream(9, dict(max_num_ref_frames=4), F.CABAC,
                                     [F.I(), F.Pp(1, 2), F.Pp(2, 4, mmco=[(5, 0, 0)])])
    dec = h264_cuda.Decoder("cpu", W.avcc(params[:1], params[1:]))
    with pytest.raises(N.H264Error, match="memory_management_control_operation 5"):
        dec.decode([W.length_prefixed(p) for p in pics])
    for name, kw, what in (("i.mp4", dict(frame_mbs_only_flag=0, mb_adaptive_frame_field_flag=0), "interlaced"),
                           ("b.mp4", dict(profile_idc=110, bit_depth_luma_minus8=1), "bits")):
        p = _sps_stream(tmp_path, name, **kw)
        with avi.open_video(p) as reader:
            with pytest.raises(N.H264Error, match=what):
                h264_cuda.Decoder("cpu", reader.stream.extradata)


def test_skipped_nal_units_as_ffmpeg(tmp_path):
    """NAL units FFmpeg's decoder skips (access unit delimiters, SEI, filler
    data, end of sequence) between the pictures of an Annex B AVI change
    nothing: the port's frames are cv2's."""
    _, params, pics, size = F.stream(12, {}, F.CABAC, F.gop(4))
    aud, sei, fill, eos = b"\x09\xf0", b"\x06\x05\x02\xaa\xbb\x80", b"\x0c" + b"\xff" * 5 + b"\x80", b"\x0a"
    samples = [W.annexb(([aud] if k % 2 else []) + (params if k == 0 else []) + [sei] + p + [fill])
               for k, p in enumerate(pics)]
    samples[-1] += W.annexb([eos])
    path = tmp_path / "skips.avi"
    W.write_avi(path, samples, size[0], size[1], b"H264")
    want = cv2_frames(path)
    assert len(want) == 4
    got = port_frames(path)
    assert len(got) == 4 and all(np.array_equal(a, b) for a, b in zip(got, want))


@settings(max_examples=5, deadline=None, suppress_health_check=list(HealthCheck), derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1), cabac=st.booleans(), high=st.booleans(), slices=st.booleans())
def test_random_streams_equal_cv2(tmp_path_factory, seed, cabac, high, slices):
    """Random-syntax streams from the writer (a seeded I P B B, a few
    macroblock rows, CAVLC or CABAC, Main or High) decode as cv2 decodes
    them."""
    tmp = tmp_path_factory.mktemp("h264_prop")
    sps_kw = dict(F.HIGH if high else F.MAIN, mb_width=6, mb_height=4)
    pps_kw = dict(F.CABAC if cabac else {}, **(F.T8 if high else {}))
    sw, params, pics, size = F.stream(seed, sps_kw, pps_kw, F.gop(4), dict(t8=0.5), slices=[0, 7] if slices else None)
    del sw
    path = tmp / "p.mp4"
    W.write_mp4(path, [W.length_prefixed(p) for p in pics], size[0], size[1], W.avcc(params[:1], params[1:]))
    want = cv2_frames(path)
    got = port_frames(path)
    assert len(got) == len(want) == 4
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------------ the JAX branch

from tests.test_torch_video import (FRAME_HW, THRESH, _check_written, _frames, _jax_branch_vs_port,  # noqa: E402
                                    served)  # noqa: F401


def _pcm_clip(path, frames):
    """The frames as H.264 (Baseline, CAVLC, every macroblock I_PCM, so the
    coded samples are the frames' own 4:2:0 BT.601 samples): an IDR picture
    and then I pictures, one a sample, in an ``avc1`` MP4."""
    h, w = frames[0].shape[:2]
    sw = W.StreamWriter(0)
    params = [sw.add_sps(W.make_sps(mb_width=w // 16, mb_height=h // 16, pic_order_cnt_type=2)),
              sw.add_pps(W.make_pps())]
    pics = []
    for k, img in enumerate(frames):
        b, g, r = (img[..., c].astype(np.int64) for c in range(3))
        y = np.clip(((66 * r + 129 * g + 25 * b + 128) >> 8) + 16, 0, 255)
        u = np.clip(((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128, 0, 255).reshape(h // 2, 2, w // 2, 2).mean((1, 3))
        v = np.clip(((112 * r - 94 * g - 18 * b + 128) >> 8) + 128, 0, 255).reshape(h // 2, 2, w // 2, 2).mean((1, 3))
        u, v = np.rint(u).astype(np.int64), np.rint(v).astype(np.int64)

        def force(wk, name, info, y=y, u=u, v=v):
            if name == "mb_type":
                return 25
            if name == "pcm":
                mx, my = wk.mb % (w // 16), wk.mb // (w // 16)
                return np.concatenate([y[16 * my:16 * my + 16, 16 * mx:16 * mx + 16].ravel(),
                                       u[8 * my:8 * my + 8, 8 * mx:8 * mx + 8].ravel(),
                                       v[8 * my:8 * my + 8, 8 * mx:8 * mx + 8].ravel()])
            return None

        header = dict(slice_type_raw=7, pps_id=0, frame_num=k, idr_pic_id=0, slice_qp=26)
        pics.append(sw.picture(header, N.NAL_IDR if k == 0 else N.NAL_SLICE, 3, dict(force=force)))
    W.write_mp4(path, [W.length_prefixed(p) for p in pics], w, h, W.avcc(params[:1], params[1:]))


def _coded_clip(path, frames):
    """The frames as H.264 Main profile CABAC, I P B B P in decode order
    (display 0, 3, 1, 2, 4): the IDR picture's macroblocks I_PCM (the
    writer has no intra encoder), every P and B macroblock 16x16 with the
    scene's motion (8 samples a frame, so the whole-sample vector 32 (d - r)
    quarter samples from display d to its reference r: P_L0 and B_Bi),
    random residuals at QP 30-36 and the deblocking filter on, in an
    ``avc1`` MP4."""
    h, w = frames[0].shape[:2]
    sw = W.StreamWriter(31)
    sps = W.make_sps(**dict(F.MAIN, mb_width=w // 16, mb_height=h // 16, max_num_ref_frames=2))
    params = [sw.add_sps(sps), sw.add_pps(W.make_pps(**F.CABAC))]
    b, g, r = (frames[0][..., c].astype(np.int64) for c in range(3))
    y = np.clip(((66 * r + 129 * g + 25 * b + 128) >> 8) + 16, 0, 255)
    u = np.clip(((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128, 0, 255).reshape(h // 2, 2, w // 2, 2).mean((1, 3))
    v = np.clip(((112 * r - 94 * g - 18 * b + 128) >> 8) + 128, 0, 255).reshape(h // 2, 2, w // 2, 2).mean((1, 3))
    u, v = np.rint(u).astype(np.int64), np.rint(v).astype(np.int64)

    def pcm(wk, name, info):
        if name == "mb_type":
            return 25
        if name == "pcm":
            mx, my = wk.mb % (w // 16), wk.mb // (w // 16)
            return np.concatenate([y[16 * my:16 * my + 16, 16 * mx:16 * mx + 16].ravel(),
                                   u[8 * my:8 * my + 8, 8 * mx:8 * mx + 8].ravel(),
                                   v[8 * my:8 * my + 8, 8 * mx:8 * mx + 8].ravel()])
        return None

    pics = [sw.picture(F.I()[0], N.NAL_IDR, 3, dict(force=pcm))]
    # (header, NAL type, ref_idc, display, the displays of its list 0 and list 1 references)
    for (hd, kind, ref), disp, lists in ((F.Pp(1, 6), 3, (0, None)), (F.Bb(2, 2), 1, (0, 3)),
                                          (F.Bb(2, 4), 2, (0, 3)), (F.Pp(2, 8), 4, (3, None))):
        mv = {lx: 32 * (disp - rd) for lx, rd in enumerate(lists) if rd is not None}

        def force(wk, name, info, p=hd["slice_type_raw"] == 5, mv=mv):
            if name == "mb_type":
                return 0 if p else 3
            if name == "mb_skip_flag":
                return 0
            if name == "ref_idx":
                return 0
            if name == "mvd":
                first = wk.mb == wk.h.first_mb
                return (mv[info["lx"]] if info["comp"] == 0 else 0) if first else 0
            return None

        pics.append(sw.picture(hd, kind, ref, dict(force=force, cbp=0.25, density=0.08, level=2, qp=(30, 36), dqp=1)))
    W.write_mp4(path, [W.length_prefixed(p) for p in pics], w, h, W.avcc(params[:1], params[1:]))


@pytest.mark.parametrize("coding", ["cabac_ipbbp", "pcm"])
def test_jax_branch_equals_the_port_on_an_h264_clip(served, tmp_path, monkeypatch, coding):  # noqa: F811
    """The JAX branch (``detect_and_visualize`` reading through cv2's FFmpeg
    backend, which picks FFmpeg's h264 decoder) against the port's
    ``detect_video`` on an H.264 clip of the street scenes the other
    comparisons use (``_frames(3, 5)``): coded with CABAC, P and B pictures
    and the deblocking filter (:func:`_coded_clip`), and as I_PCM
    macroblocks alone (:func:`_pcm_clip`). The port's decoded frames equal
    cv2's; the rendered frames equal, text included, as the mp4v comparison
    holds them; both name ``detection_out.mp4`` (mp4v, whatever the input
    codec), and the port's is read back by cv2."""
    _, jdet, pdet, _ = served
    clip = tmp_path / "clip.mp4"
    frames = _frames(3, 5)
    assert frames[0].shape[:2] == FRAME_HW
    (_coded_clip if coding == "cabac_ipbbp" else _pcm_clip)(clip, frames)
    want = cv2_frames(clip)
    mine = port_frames(clip)
    assert len(mine) == len(want) == 5 and all(np.array_equal(a, b) for a, b in zip(mine, want))
    got = _jax_branch_vs_port(jdet, pdet, str(clip), cv2.CAP_FFMPEG, tmp_path, monkeypatch)
    written = pdet.detect_and_visualize(str(clip), str(tmp_path / "port"), thresh=THRESH)
    assert written == [str(tmp_path / "port" / "detection_out.mp4")]
    _check_written(written[0], got)
