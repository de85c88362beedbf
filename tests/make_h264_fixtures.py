"""Writes ``tests/fixtures/h264_forms/``: H.264 streams from
``tests/h264_writer.py`` in MP4 (``avc1`` / ``avc3``) and AVI, and
``forms.json`` with what cv2 5.0.0 (FFmpeg's h264 decoder, ``CAP_FFMPEG``)
returns for each: the frame count and the sha256 of every BGR frame in
order. cv2 5.0.0's wheel decodes H.264 but writes none, so the streams come from the
port's own writer and are judged only by cv2's decode.

The small forms (176x144 and below, a few frames each) cover CAVLC
(Constrained Baseline: intra modes at picture and slice edges, I_PCM, every
P partition, far motion vectors, several slices, constrained intra, the
deblocking modes and offsets, QP 0-51 with chroma offsets, up to four
references with list modification, MMCO and long-term references,
``frame_num`` gaps the SPS allows), CABAC
(Main: I / P / B, direct spatial and temporal, B_Skip, bi-prediction,
explicit and implicit weights, POC types 0 / 1 / 2, ``cabac_init_idc``
0-2), High (the 8x8 transform and intra 8x8, SPS and PPS scaling lists with
their fall-backs), the containers and flags (a cropped size, ``avc3`` with
parameter sets in band under several ids, an AVI, the VUI with and without
``bitstream_restriction`` and without VUI, full range, BT.709, a B-frame
edit list), and one form per refusal (recording what cv2 returns for it). One 1024x2048 clip, High profile
CABAC, I P B B..., codes a textured scene's known quarter-sample shift a
frame as its motion, with residuals at a dashcam's rate.

Run where cv2 is installed: ``python tests/make_h264_fixtures.py``.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from tests import h264_writer as W  # noqa: E402
from dspnet_torch.data import h264_nal as N  # noqa: E402

FIXTURE = ROOT / "tests" / "fixtures" / "h264_forms"
#: the big clip's size, frames and shift per frame (quarter samples)
BIG = dict(height=1024, width=2048, frames=13, shift=(5, -3))


def vui(reorder=2, **kw) -> N.Syntax:
    v = N.Syntax(aspect_ratio_info_present_flag=0, overscan_info_present_flag=0, video_signal_type_present_flag=0,
                 chroma_loc_info_present_flag=0, timing_info_present_flag=0, nal_hrd_parameters_present_flag=0,
                 vcl_hrd_parameters_present_flag=0, pic_struct_present_flag=0, bitstream_restriction_flag=1,
                 motion_vectors_over_pic_boundaries_flag=1, max_bytes_per_pic_denom=0, max_bits_per_mb_denom=0,
                 log2_max_mv_length_horizontal=15, log2_max_mv_length_vertical=15, max_num_reorder_frames=reorder,
                 max_dec_frame_buffering=4)
    v.update(kw)
    return v


MAIN = dict(profile_idc=77, pic_order_cnt_type=0, log2_max_poc_lsb=8, max_num_ref_frames=3,
            vui_parameters_present_flag=1, vui=vui())
HIGH = dict(MAIN, profile_idc=100)
CABAC = dict(entropy_coding_mode_flag=1)
T8 = dict(transform_8x8_mode_flag=1, pic_scaling_matrix_present_flag=0, second_chroma_qp_index_offset=0)


def I(fn=0, poc=0, qp=28, db=(0, 0, 0), **kw):
    return dict(slice_type_raw=7, pps_id=0, frame_num=fn, idr_pic_id=0, poc_lsb=poc, slice_qp=qp, deblock=list(db),
                **kw), N.NAL_IDR, 3


def Pp(fn, poc=0, nref=1, qp=28, db=(0, 0, 0), idc=0, ref=2, **kw):
    return dict(slice_type_raw=5, pps_id=0, frame_num=fn, poc_lsb=poc, slice_qp=qp, deblock=list(db),
                num_ref_idx=[nref, 0], cabac_init_idc=idc, **kw), N.NAL_SLICE, ref


def Bb(fn, poc, n0=1, n1=1, qp=28, db=(0, 0, 0), idc=0, spatial=1, ref=0, **kw):
    return dict(slice_type_raw=6, pps_id=0, frame_num=fn, poc_lsb=poc, slice_qp=qp, deblock=list(db),
                num_ref_idx=[n0, n1], cabac_init_idc=idc, direct_spatial_mv_pred_flag=spatial, **kw), N.NAL_SLICE, ref


def weights(seed, n0, n1, denom=(5, 4)):
    """An explicit weight table within the standard's bi-prediction range."""
    r = np.random.default_rng(seed)
    t = [[], []]
    for lx, n in enumerate((n0, n1)):
        for _ in range(n):
            luma = (int(r.integers(-10, 60)), int(r.integers(-20, 20))) if r.random() < 0.7 else None
            chroma = [(int(r.integers(-5, 30)), int(r.integers(-10, 10))) for _ in range(2)] if r.random() < 0.6 else None
            t[lx].append((luma, chroma))
    return N.Syntax(luma_log2_denom=denom[0], chroma_log2_denom=denom[1], table=t)


def gop(n=7):
    """I P B B P B B ... in decode order (POC = 2 x display index)."""
    out = [I()]
    fn, anchor = 1, 0
    while len(out) < n:
        nxt = anchor + 3
        out.append(Pp(fn, 2 * nxt))
        if len(out) < n:
            out.append(Bb(fn + 1, 2 * (anchor + 1)))
        if len(out) < n:
            out.append(Bb(fn + 1, 2 * (anchor + 2)))
        fn += 1
        anchor = nxt
    return out


def stream(seed, sps_kw, pps_kw, frames, cfg=None, slices=None, baseline=False):
    """(writer, [SPS, PPS NAL], [picture NAL lists]) of one stream."""
    sw = W.StreamWriter(seed)
    sps = W.make_sps(**sps_kw) if baseline else W.make_sps(**dict(MAIN, **sps_kw))
    pps = W.make_pps(**pps_kw)
    params = [sw.add_sps(sps), sw.add_pps(pps)]
    pics = [sw.picture(h, t, r, cfg, slices=slices) for h, t, r in frames]
    return sw, params, pics, (16 * sps.mb_width, 16 * sps.mb_height)


def small_forms() -> dict:
    """name -> (container, params, pictures, size, extra)."""
    f = {}
    B4 = dict(max_num_ref_frames=4)
    # ---- CAVLC, Constrained Baseline (POC type 2)
    f["cavlc_intra.mp4"] = ("mp4", *stream(1, {}, {}, [I()], dict(i16=0.35, pcm=0.05), baseline=True)[1:], {})
    f["cavlc_intra_slices.mp4"] = ("mp4", *stream(2, {}, {}, [I(), I()], dict(i16=0.3, pcm=0.03),
                                                  slices=[0, 13, 40, 41, 80], baseline=True)[1:], {})
    f["cavlc_p_partitions.mp4"] = ("mp4", *stream(3, dict(max_num_ref_frames=1), {},
                                                  [I(), Pp(1), Pp(2), Pp(3)], dict(far=0.1), baseline=True)[1:], {})
    f["cavlc_p_4refs.mp4"] = ("mp4", *stream(4, B4, {}, [I()] + [Pp(k, nref=min(k, 4)) for k in range(1, 7)], None,
                                             baseline=True)[1:], {})
    f["cavlc_cip.mp4"] = ("mp4", *stream(5, {}, dict(constrained_intra_pred_flag=1), [I(), Pp(1), Pp(2)],
                                         dict(intra=0.4), baseline=True)[1:], {})
    f["cavlc_qp_range.mp4"] = ("mp4", *stream(6, {}, dict(chroma_qp_index_offset=5),
                                              [I(qp=45, db=(0, 6, -4)), Pp(1, qp=12, db=(2, -6, 6)),
                                               Pp(2, qp=51, db=(1, 0, 0))], dict(qp=(0, 51), dqp=12),
                                              slices=[0, 50], baseline=True)[1:], {})
    lt = [I(), Pp(1, 2), Pp(2, 4, nref=2, modification=[[(0, 1), (1, 0)], []]), Pp(3, 6, nref=3, mmco=[(1, 1, 0)]),
          Pp(4, 8, nref=2, mmco=[(4, 2, 0), (3, 0, 1)]), Pp(5, 10, nref=3, modification=[[(2, 1), (0, 0)], []]),
          Pp(6, 12, nref=3, mmco=[(1, 0, 0), (6, 0, 0)]), Pp(7, 14, nref=3, mmco=[(2, 1, 0)]),
          Bb(8, 13, n0=3, n1=2, modification=[[(2, 0)], [(0, 0)]]), Pp(8, 16, nref=4)]
    f["cavlc_longterm_mmco.mp4"] = ("mp4", *stream(7, dict(B4), {}, lt)[1:], {})
    # ---- CABAC, Main (POC type 0 unless said)
    f["cabac_ipbb_spatial.mp4"] = ("mp4", *stream(10, {}, CABAC, gop(7))[1:], {})
    g = [(dict(h, direct_spatial_mv_pred_flag=0) if h["slice_type_raw"] == 6 else h, t, r) for h, t, r in gop(7)]
    f["cabac_ipbb_temporal.mp4"] = ("mp4", *stream(11, {}, CABAC, g, dict(direct=0.5, skip=0.3))[1:], {})
    f["cabac_init_idc.mp4"] = ("mp4", *stream(12, {}, CABAC, [I(), Pp(1, 2, idc=1), Pp(2, 4, nref=2, idc=2),
                                                             Bb(3, 3, n0=2, n1=1, idc=1), Pp(3, 6, idc=0)])[1:], {})
    f["cabac_longterm_mmco.mp4"] = ("mp4", *stream(13, dict(B4), CABAC, lt)[1:], {})
    f["cabac_wp_explicit.mp4"] = ("mp4", *stream(14, {}, dict(CABAC, weighted_pred_flag=1, weighted_bipred_idc=1),
                                                 [I(), Pp(1, 6, weights=weights(1, 1, 0)),
                                                  Bb(2, 2, n0=1, n1=2, weights=weights(3, 1, 2)),
                                                  Bb(2, 4, n0=2, n1=1, spatial=0, weights=weights(4, 2, 1, (6, 6))),
                                                  Pp(2, 8, nref=2, weights=weights(5, 2, 0, (0, 1)))])[1:], {})
    f["cabac_wp_implicit.mp4"] = ("mp4", *stream(15, {}, dict(CABAC, weighted_bipred_idc=2),
                                                 [I(), Pp(1, 6), Bb(2, 2, n0=1, n1=2), Pp(2, 12, nref=2),
                                                  Bb(3, 8, n0=2, n1=2, spatial=0), Bb(3, 10, n0=2, n1=2)])[1:], {})
    poc1 = dict(pic_order_cnt_type=1, delta_pic_order_always_zero_flag=0, offset_for_non_ref_pic=-2,
                offset_for_top_to_bottom_field=0, offset_for_ref_frame=[4, 2])
    f["cabac_poc1.mp4"] = ("mp4", *stream(16, poc1, CABAC, [I(delta_poc=[0, 0]), Pp(1, delta_poc=[2, 0]),
                                                            Bb(2, 0, delta_poc=[-3, 0]), Pp(2, delta_poc=[0, 0])])[1:],
                           {})
    f["cabac_poc2.mp4"] = ("mp4", *stream(17, dict(pic_order_cnt_type=2), CABAC,
                                          [I(), Pp(1), Pp(2, ref=0), Pp(2)])[1:], {})
    f["cabac_slices_pb.mp4"] = ("mp4", *stream(18, {}, CABAC, gop(4), slices=[0, 30, 31, 60])[1:], {})
    f["cabac_cip_nodirect8.mp4"] = ("mp4", *stream(19, dict(direct_8x8_inference_flag=0),
                                                   dict(CABAC, constrained_intra_pred_flag=1), gop(4),
                                                   dict(intra=0.3))[1:], {})
    f["cabac_deblock.mp4"] = ("mp4", *stream(20, {}, dict(CABAC, chroma_qp_index_offset=-4),
                                             [I(db=(0, 6, -6)), Pp(1, 6, db=(2, -4, 4)), Bb(2, 2, db=(0, 12, 12)),
                                              Bb(2, 4, db=(2, -12, -12))], dict(qp=(10, 51), dqp=10),
                                             slices=[0, 30, 60])[1:], {})
    # ---- High
    f["high_8x8_cabac.mp4"] = ("mp4", *stream(30, dict(HIGH), dict(T8, **CABAC), gop(7), dict(t8=0.6))[1:], {})
    f["high_8x8_cavlc.mp4"] = ("mp4", *stream(31, dict(HIGH), T8, gop(4), dict(t8=0.6))[1:], {})
    lists = [[int(x) for x in np.random.default_rng(k).integers(4, 40, 16 if k < 6 else 64)] for k in range(8)]
    f["high_scaling_sps.mp4"] = ("mp4", *stream(32, dict(HIGH, seq_scaling_matrix_present_flag=1,
                                                         lists=[lists[0], None, "default", lists[3], None, None,
                                                                lists[6], None]), dict(T8, **CABAC),
                                                [I(), Pp(1, 2)])[1:], {})
    f["high_scaling_pps.mp4"] = ("mp4", *stream(33, dict(HIGH, seq_scaling_matrix_present_flag=1,
                                                         lists=[lists[0]] + [None] * 7),
                                                dict(T8, pic_scaling_matrix_present_flag=1,
                                                     lists=[None, lists[1], None, "default", lists[4], None, None,
                                                            lists[7]], second_chroma_qp_index_offset=-3,
                                                     chroma_qp_index_offset=2), [I(), Pp(1, 2)])[1:], {})
    f["high_scaling_pps_only.mp4"] = ("mp4", *stream(34, dict(HIGH), dict(T8, pic_scaling_matrix_present_flag=1,
                                                                           lists=[lists[2], None, None, None, lists[5],
                                                                                  None, "default", None]),
                                                     [I(), Pp(1, 2)])[1:], {})
    # ---- containers and flags
    f["crop_right_bottom_top.mp4"] = ("mp4", *stream(40, dict(frame_cropping_flag=1, crop=[0, 3, 2, 5]), CABAC,
                                                     [I(), Pp(1, 2)])[1:], {})
    f["no_vui.mp4"] = ("mp4", *stream(41, dict(vui_parameters_present_flag=0), CABAC, gop(8))[1:], {})
    f["vui_no_restriction.mp4"] = ("mp4", *stream(42, dict(vui=vui(bitstream_restriction_flag=0)), CABAC,
                                                  gop(8))[1:], {})
    pyramid = [I(), Pp(1, 8), Pp(2, 4), Bb(3, 2), Bb(3, 6), Pp(3, 16), Pp(4, 12), Bb(5, 10), Bb(5, 14)]
    f["no_vui_pyramid.mp4"] = ("mp4", *stream(43, dict(vui_parameters_present_flag=0), CABAC, pyramid)[1:], {})
    f["full_range.mp4"] = ("mp4", *stream(44, dict(vui=vui(video_signal_type_present_flag=1, video_format=5,
                                                            video_full_range_flag=1,
                                                            colour_description_present_flag=0)), CABAC,
                                          [I(), Pp(1, 2)])[1:], {})
    f["bt709.mp4"] = ("mp4", *stream(45, dict(vui=vui(video_signal_type_present_flag=1, video_format=5,
                                                       video_full_range_flag=0, colour_description_present_flag=1,
                                                       colour_primaries=1, transfer_characteristics=1,
                                                       matrix_coefficients=1)), CABAC, [I(), Pp(1, 2)])[1:], {})
    f["bt709_full.mp4"] = ("mp4", *stream(46, dict(vui=vui(video_signal_type_present_flag=1, video_format=5,
                                                            video_full_range_flag=1, colour_description_present_flag=1,
                                                            colour_primaries=1, transfer_characteristics=1,
                                                            matrix_coefficients=1)), CABAC, [I(), Pp(1, 2)])[1:], {})
    f["jax_clip_512x256.mp4"] = ("mp4", *stream(50, dict(mb_width=32, mb_height=16), CABAC, gop(5),
                                                dict(density=0.05, cbp=0.3))[1:], {})
    gap = dict(gaps_in_frame_num_value_allowed_flag=1, max_num_ref_frames=3)
    f["cabac_frame_num_gaps.mp4"] = ("mp4", *stream(51, gap, CABAC, [I(), Pp(1, 2), Pp(3, 6, nref=3), Pp(4, 8, nref=3),
                                                                    Pp(7, 14, nref=3), Pp(8, 16, nref=2)])[1:], {})
    f["cavlc_frame_num_gaps.mp4"] = ("mp4", *stream(52, gap, {}, [I(), Pp(2, 4, nref=2), Pp(3, 6, nref=3)],
                                                    baseline=True)[1:], {})
    f["annexb_h264.avi"] = ("avi", *stream(47, {}, CABAC, gop(7))[1:], dict(fourcc=b"H264"))
    f["annexb_x264.avi"] = ("avi", *stream(48, {}, {}, [I(), Pp(1, 2), Pp(2, 4)])[1:], dict(fourcc=b"X264"))
    f["ctts_edit_shift.mp4"] = ("mp4", *stream(49, {}, CABAC, gop(7))[1:], dict(ctts=True, edit=0))
    return f


def avc3_form():
    """Parameter sets in band (``avc3``) under two SPS and three PPS ids,
    switched between pictures, and repeated."""
    sw = W.StreamWriter(60)
    s0 = W.make_sps(**dict(MAIN, sps_id=0))
    s1 = W.make_sps(**dict(HIGH, sps_id=1, log2_max_poc_lsb=6))
    p0 = W.make_pps(pps_id=0, sps_id=0, **CABAC)
    p1 = W.make_pps(pps_id=1, sps_id=1, **dict(T8, **CABAC))
    p2 = W.make_pps(pps_id=2, sps_id=1, chroma_qp_index_offset=3, **T8)
    nals = [sw.add_sps(s0), sw.add_pps(p0)]
    pics = [nals + sw.picture(*I())]
    pics.append(sw.picture(*Pp(1, 2)))
    nals = [sw.add_sps(s1), sw.add_pps(p1), sw.add_pps(p2)]
    h, t, r = I(qp=30)
    pics.append(nals + sw.picture(dict(h, pps_id=1, idr_pic_id=1), t, r))
    h, t, r = Pp(1, 2)
    pics.append(sw.picture(dict(h, pps_id=2), t, r))
    h, t, r = Pp(2, 4)
    pics.append([sw.add_pps(p1)] + sw.picture(dict(h, pps_id=1), t, r))
    return pics


def refusal_forms() -> dict:
    """name -> (file bytes builder args, what the port's refusal names)."""
    out = {}

    def sps_only(name, refused, **kw):
        sps = W.make_sps(**kw)
        bw = W.BitWriter()
        N.sps_syntax(bw, sps)
        bw.trailing()
        sps_nal = W.nal(3, N.NAL_SPS, bw.data())
        out[name] = (sps_nal, refused)

    sps_only("refused_interlaced.mp4", "interlaced", **dict(MAIN, frame_mbs_only_flag=0, mb_adaptive_frame_field_flag=1,
                                                            mb_height=5))
    sps_only("refused_high10.mp4", "bits", **dict(MAIN, profile_idc=110, bit_depth_luma_minus8=2,
                                                   bit_depth_chroma_minus8=2))
    sps_only("refused_422.mp4", "4:2:2", **dict(MAIN, profile_idc=122, chroma_format_idc=2))
    sps_only("refused_lossless.mp4", "lossless", **dict(MAIN, profile_idc=244, chroma_format_idc=1,
                                                         qpprime_y_zero_transform_bypass_flag=1))
    sps_only("refused_monochrome.mp4", "monochrome", **dict(MAIN, profile_idc=100, chroma_format_idc=0))
    sps_only("refused_left_crop.mp4", "left frame crop", **dict(MAIN, frame_cropping_flag=1, crop=[2, 0, 0, 0]))
    return out


def refusal_streams() -> dict:
    """name -> (a function writing the file at a path, what the refusal
    names): streams with a tool the port refuses past the SPS."""
    out = {}

    def fmo(path):
        sw = W.StreamWriter(0)
        sps = sw.add_sps(W.make_sps())
        bw = W.BitWriter()
        for v in (0, 0):  # pps_id, sps_id
            bw.ue(v)
        bw.u(2, 0)  # entropy_coding_mode_flag, bottom_field_pic_order_in_frame_present_flag
        bw.ue(2)  # num_slice_groups_minus1
        bw.ue(0)  # slice_group_map_type 0
        for _ in range(3):
            bw.ue(10)  # run_length_minus1
        bw.trailing()
        W.write_mp4(path, [b"\x00\x00\x00\x02\x09\xf0"], 176, 144, W.avcc([sps], [W.nal(3, N.NAL_PPS, bw.data())]))

    def slices(path, frames, sps_kw=None, pps_kw=None, edit=None):
        _, params, pics, size = stream(5, dict(sps_kw or {}), dict(pps_kw or {}), frames)
        kw = {}
        if edit is not None:
            kw["cts"], shift = composition([h["poc_lsb"] for h, _, _ in frames])
            kw["edit"] = (shift + edit, len(pics) * 40)
        W.write_mp4(path, [W.length_prefixed(p) for p in pics], size[0], size[1], W.avcc(params[:1], params[1:]),
                    **kw)

    def sp_slice(path):
        sw = W.StreamWriter(0)
        params = [sw.add_sps(W.make_sps(profile_idc=88)), sw.add_pps(W.make_pps())]
        bw = W.BitWriter()
        for v in (0, 3, 0):  # first_mb_in_slice, slice_type SP, pps_id
            bw.ue(v)
        bw.trailing()
        W.write_mp4(path, [W.length_prefixed([W.nal(2, N.NAL_SLICE, bw.data())])], 176, 144,
                    W.avcc(params[:1], params[1:]))

    def partitioned(path):
        sw = W.StreamWriter(0)
        params = [sw.add_sps(W.make_sps(profile_idc=88)), sw.add_pps(W.make_pps())]
        W.write_mp4(path, [W.length_prefixed([bytes([0x62, 0x80])])], 176, 144, W.avcc(params[:1], params[1:]))

    out["refused_fmo.mp4"] = (fmo, "slice groups")
    out["refused_sp_slice.mp4"] = (sp_slice, "SP slice")
    out["refused_data_partitioning.mp4"] = (partitioned, "data partitioning")
    out["refused_frame_num_gap.mp4"] = (lambda p: slices(p, [I(), Pp(1, 2), Pp(3, 6)]), "gap in frame_num")
    out["refused_mmco5.mp4"] = (lambda p: slices(p, [I(), Pp(1, 2), Pp(2, 4, mmco=[(5, 0, 0)]), Pp(1, 2)],
                                                 dict(max_num_ref_frames=4), CABAC),
                                "memory_management_control_operation 5")
    out["refused_edit_drop.mp4"] = (lambda p: slices(p, gop(4), {}, CABAC, edit=512), "edit list that drops frames")
    return out


def cv2_frames(path: Path):
    import cv2

    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG)
    frames = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(img)
    cap.release()
    return frames


def sha(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def write(path: Path, container: str, params, pics, size, extra: dict):
    w, h = size
    if container == "avi":
        samples = [W.annexb((params if k == 0 else []) + p) for k, p in enumerate(pics)]
        W.write_avi(path, samples, w, h, extra.get("fourcc", b"H264"))
        return
    fourcc = extra.get("entry", b"avc1")
    cfg = W.avcc(params[:1], params[1:]) if params else W.avcc([], [])
    samples = [W.length_prefixed(p) for p in pics]
    kw = {}
    if extra.get("ctts"):
        kw["cts"] = extra["cts"]
        kw["edit"] = (extra["edit"], len(samples) * 40) if "edit" in extra else None
    W.write_mp4(path, samples, w, h, cfg, fourcc=fourcc, **kw)


def big_clip():
    """The 1024x2048 High profile CABAC clip: I P B B ... in decode order,
    four slices a picture; P and B macroblocks are 16x16 with the scene's
    known motion (the shift a frame times the distance), residuals drawn at
    a dashcam's rate."""
    H, Wd, n, (sx, sy) = BIG["height"], BIG["width"], BIG["frames"], BIG["shift"]
    sw = W.StreamWriter(70)
    sps = W.make_sps(**dict(HIGH, mb_width=Wd // 16, mb_height=H // 16, level_idc=51, max_num_ref_frames=2))
    pps = W.make_pps(**dict(T8, **CABAC, pic_init_qp=30))
    params = [sw.add_sps(sps), sw.add_pps(pps)]
    rows = H // 16
    slices = [k * rows // 4 * (Wd // 16) for k in range(4)]
    order = gop(n)
    pics = []
    pocs = []
    for h, t, r in order:
        poc = h["poc_lsb"]
        pocs.append(poc)
        st = h["slice_type_raw"]
        if st == 7:
            cfg = dict(i16=0.3, pcm=0.0, density=0.1, level=3, qp=(28, 34), dqp=1, t8=0.5)
        else:
            disp = poc // 2
            if st == 5:
                prev = max(q // 2 for q in pocs[:-1])
                mv = {0: ((disp - prev) * -sx, (disp - prev) * -sy)}
            else:
                before = max(q // 2 for q in pocs[:-1] if q < poc)
                after = min(q // 2 for q in pocs[:-1] if q > poc)
                mv = {0: ((disp - before) * -sx, (disp - before) * -sy), 1: ((after - disp) * sx, (after - disp) * sy)}

            def force(w, name, info, st=st, mv=mv):
                if name == "mb_type":
                    return 0 if st == 5 else 3
                if name == "mb_skip_flag":
                    return 0
                if name == "ref_idx":
                    return 0
                if name == "mvd":
                    lx, comp = info["lx"], info["comp"]
                    return mv[lx][comp] if w.mb == w.h.first_mb else 0
                return None

            cfg = dict(force=force, cbp=0.25, density=0.08, level=2, qp=(30, 36), dqp=1, t8=0.5)
        pics.append(sw.picture(h, t, r, cfg, slices=slices))
    return params, pics, (Wd, H), pocs


def composition(pocs, delta=512):
    """ctts offsets of frames in decode order with POC = 2 x display index,
    shifted by the B-frame delay, and that delay."""
    disp = [p // 2 for p in pocs]
    offs = [d * delta - k * delta for k, d in enumerate(disp)]
    shift = -min(offs) if min(offs) < 0 else 0
    shift = max(shift, 2 * delta)
    return [o + shift for o in offs], shift


def main():
    FIXTURE.mkdir(parents=True, exist_ok=True)
    for old in FIXTURE.iterdir():
        old.unlink()
    meta = {}
    forms = small_forms()
    for name, (container, params, pics, size, extra) in forms.items():
        if extra.get("ctts"):
            pocs = [h["poc_lsb"] for h, _, _ in gop(len(pics))]
            extra["cts"], shift = composition(pocs)
            extra["edit"] = shift
        write(FIXTURE / name, container, params, pics, size, extra)
    # avc3: parameter sets in band
    pics = avc3_form()
    samples = [W.length_prefixed(p) for p in pics]
    W.write_mp4(FIXTURE / "avc3_inband.mp4", samples, 176, 144, W.avcc([], []), fourcc=b"avc3")
    forms["avc3_inband.mp4"] = ("mp4", None, pics, (176, 144), {"form": "avc3"})
    # the big clip, with ctts and a B-frame delay edit
    params, pics, size, pocs = big_clip()
    cts, shift = composition(pocs)
    W.write_mp4(FIXTURE / "big_1024x2048.mp4", [W.length_prefixed(p) for p in pics], size[0], size[1],
                W.avcc(params[:1], params[1:]), cts=cts, edit=(shift, len(pics) * 40))
    forms["big_1024x2048.mp4"] = ("mp4", params, pics, size, {})
    for name, (sps_nal, refused) in refusal_forms().items():
        W.write_mp4(FIXTURE / name, [b"\x00\x00\x00\x02\x09\xf0"], 176, 144, W.avcc([sps_nal], []))
        forms[name] = ("mp4", None, None, None, {"refused": refused})
    for name, (make, refused) in refusal_streams().items():
        make(FIXTURE / name)
        forms[name] = ("mp4", None, None, None, {"refused": refused})
    for name in sorted(forms):
        path = FIXTURE / name
        frames = cv2_frames(path)
        rec = {"bytes": path.stat().st_size, "frames": len(frames), "bgr_sha256": [sha(f) for f in frames]}
        extra = forms[name][-1]
        if "refused" in extra:
            rec["refused"] = extra["refused"]
        meta[name] = rec
        print(name, rec["bytes"], rec["frames"], flush=True)
    import cv2

    (FIXTURE / "forms.json").write_text(json.dumps({"cv2": cv2.__version__, "forms": meta}, indent=1, sort_keys=True)
                                        + "\n")
    total = sum(p.stat().st_size for p in FIXTURE.iterdir())
    print(f"{len(meta)} forms, {total} bytes in {FIXTURE}")
    assert all(p.stat().st_size <= 1 << 20 for p in FIXTURE.iterdir())


if __name__ == "__main__":
    main()
