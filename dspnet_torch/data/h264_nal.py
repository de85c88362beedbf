"""H.264 NAL units, parameter sets and slice headers (ITU-T H.264 clause 7),
on the host: the part of the port's H.264 decoder that cv2's FFmpeg runs
before any macroblock.

* :func:`split_annexb` / :func:`split_length` cut a sample into NAL units
  (Annex B start codes, as an AVI holds them; ``avcC`` length prefixes, as
  an MP4 does); :func:`unescape` removes emulation prevention bytes;
  :func:`parse_avcc` reads an ``avcC`` box body.
* :class:`BitReader` reads an RBSP. Every syntax function of this module takes an
  ``io`` with ``u(n, v)``, ``ue(v)``, ``se(v)`` and ``more_rbsp_data(v)``
  and a :class:`Syntax` record: reading, each call returns the value read
  and ``v`` is None; a writer (``tests/h264_writer.py``) passes the value
  to write and gets it back, so one function states each syntax once.
* :func:`sps_syntax`, :func:`pps_syntax` and :func:`slice_header_syntax`
  cover the Baseline, Main and High profiles for 8-bit 4:2:0 (and 4:0:0)
  progressive frames: scaling lists with their fall-back rules (rules A and
  B, :func:`scaling_lists`), POC types 0 / 1 / 2, frame cropping, the VUI
  with ``bitstream_restriction``, ``transform_8x8_mode_flag``, weighted
  prediction tables, reference list modification, ``dec_ref_pic_marking``
  and the deblocking parameters.

Refused by name (:class:`H264Error`): interlaced coding
(``frame_mbs_only_flag`` 0: PAFF / MBAFF), slice groups (FMO), SP / SI
slices, data partitioning (NAL types 2-4), bit depths above 8, chroma
formats other than 4:2:0 and 4:0:0, separate colour planes, lossless
transform bypass, and redundant pictures. NAL types FFmpeg's decoder skips
(SEI 6, access unit delimiter 9, end of sequence / stream 10-11, filler 12,
SPS extension 13, SVC / MVC prefix and extension 14, 15, 20, auxiliary
slice 19, and the reserved ones) are skipped.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from dspnet_torch.data.h264_tables import DEFAULT4, DEFAULT8
from dspnet_torch.data.mp4 import VideoError


class H264Error(VideoError):
    """An H.264 stream the port does not read, or a broken one."""


#: NAL unit types
NAL_SLICE, NAL_IDR, NAL_SPS, NAL_PPS = 1, 5, 7, 8
#: slice types (slice_type % 5)
P, B, I, SP, SI = 0, 1, 2, 3, 4
#: profiles the High profile syntax (chroma format, bit depth, scaling) belongs to
HIGH_PROFILES = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135)


class Syntax(dict):
    """A syntax structure's elements by name; a missing one reads as None."""

    __getattr__ = dict.get

    def __setattr__(self, key, value):
        self[key] = value


# ------------------------------------------------------------------ NAL units


def split_annexb(data: bytes) -> List[bytes]:
    """The NAL units of an Annex B byte stream (start codes 00 00 01, with or
    without a leading zero byte; trailing zero bytes dropped)."""
    out, pos, n = [], [], len(data)
    i = data.find(b"\x00\x00\x01")
    while i >= 0:
        pos.append(i + 3)
        i = data.find(b"\x00\x00\x01", i + 3)
    for k, start in enumerate(pos):
        end = pos[k + 1] - 3 if k + 1 < len(pos) else n
        nal = data[start:end].rstrip(b"\x00")
        if nal:
            out.append(nal)
    return out


def split_length(data: bytes, size: int) -> List[bytes]:
    """The NAL units of a sample of ``size``-byte big-endian length prefixes."""
    out, pos = [], 0
    while pos + size <= len(data):
        n = int.from_bytes(data[pos:pos + size], "big")
        pos += size
        if n == 0 or pos + n > len(data):
            raise H264Error(f"a NAL unit length of {n} at byte {pos - size} of a {len(data)}-byte sample")
        out.append(data[pos:pos + n])
        pos += n
    return out


def unescape(nal: bytes) -> bytes:
    """The RBSP of a NAL unit's payload: every 00 00 03 -> 00 00."""
    if b"\x00\x00\x03" not in nal:
        return nal
    out, i = bytearray(), 0
    while True:
        j = nal.find(b"\x00\x00\x03", i)
        if j < 0:
            out += nal[i:]
            return bytes(out)
        out += nal[i:j + 2]
        i = j + 3


def parse_avcc(avcc: bytes) -> Tuple[int, List[bytes]]:
    """(NAL length size, its SPS and PPS NAL units) of an ``avcC`` body."""
    if len(avcc) < 7 or avcc[0] != 1:
        raise H264Error(f"an avcC of {len(avcc)} bytes, version {avcc[:1].hex()}: not an AVC configuration")
    size = (avcc[4] & 3) + 1
    nals, pos = [], 6
    for count_mask in (0x1F, 0xFF):
        count = avcc[pos - 1] & count_mask
        for _ in range(count):
            n = int.from_bytes(avcc[pos:pos + 2], "big")
            nals.append(avcc[pos + 2:pos + 2 + n])
            pos += 2 + n
        pos += 1
    return size, nals


class BitReader:
    """Reads an RBSP (bytes without emulation prevention), MSB first."""

    writing = False

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.end = len(data) * 8

    def u(self, n: int, v=None) -> int:
        pos, data = self.pos, self.data
        if pos + n > self.end:
            raise H264Error(f"the RBSP ends at bit {self.end}, reading {n} bits at {pos}")
        out = 0
        for _ in range(n):
            out = (out << 1) | ((data[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos = pos
        return out

    def bit(self) -> int:
        pos = self.pos
        if pos >= self.end:
            raise H264Error(f"the RBSP ends at bit {self.end}")
        self.pos = pos + 1
        return (self.data[pos >> 3] >> (7 - (pos & 7))) & 1

    def ue(self, v=None) -> int:
        zeros = 0
        while self.bit() == 0:
            zeros += 1
            if zeros > 31:
                raise H264Error(f"an Exp-Golomb code of more than 31 leading zeros at bit {self.pos}")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self, v=None) -> int:
        k = self.ue()
        return (k + 1) >> 1 if k & 1 else -(k >> 1)

    def more_rbsp_data(self, v=None) -> bool:
        """Whether data precede the RBSP's stop bit."""
        last = len(self.data) - 1
        while last >= 0 and self.data[last] == 0:
            last -= 1
        if last < 0:
            return False
        byte = self.data[last]
        stop = last * 8 + 7 - ((byte & -byte).bit_length() - 1)
        return self.pos < stop


# ------------------------------------------------------------------ SPS / PPS


def scaling_list(io, size: int, values: Optional[List[int]]) -> Tuple[List[int], bool]:
    """scaling_list(): (the list in zig-zag order, useDefaultScalingMatrixFlag).
    Writing, ``values`` is the list to write (None: the default matrix)."""
    last = nxt = 8
    out = []
    for j in range(size):
        if nxt != 0:
            delta = None
            if io.writing:
                target = 0 if values is None else values[j]
                delta = ((target - last + 128) % 256) - 128
            delta = io.se(delta)
            nxt = (last + delta + 256) % 256
            if j == 0 and nxt == 0:
                return [], True
        out.append(last if nxt == 0 else nxt)
        last = out[-1]
    return out, False


def _lists(io, s: Syntax, count: int):
    """The scaling list flags and lists of an SPS or PPS into ``s.lists``:
    per list None (not present), "default", or its values (zig-zag)."""
    given = (s.lists or []) + [None] * count
    lists = []
    for i in range(count):
        present = io.u(1, int(given[i] is not None) if io.writing else None)
        if not present:
            lists.append(None)
            continue
        vals, use_default = scaling_list(io, 16 if i < 6 else 64, None if given[i] == "default" else given[i])
        lists.append("default" if use_default else vals)
    s.lists = lists


def scaling_lists(sps: Syntax, pps: Optional[Syntax] = None) -> Tuple[List[List[int]], List[List[int]]]:
    """The six 4x4 and two 8x8 weight lists (zig-zag order) in force: the
    SPS's with fall-back rule A, the PPS's with rule B over them (rule A
    when the SPS has none); flat 16 where neither has a matrix."""

    def resolve(lists, fallback4, fallback8):
        l4, l8 = [], []
        for i in range(6):
            v = lists[i] if i < len(lists) else None
            if v is None:
                v = fallback4[i // 3] if i % 3 == 0 else l4[i - 1]
            elif v == "default":
                v = list(DEFAULT4[i // 3])
            l4.append(list(v))
        for i in range(2):
            v = lists[6 + i] if 6 + i < len(lists) else None
            if v is None:
                v = fallback8[i]
            elif v == "default":
                v = list(DEFAULT8[i])
            l8.append(list(v))
        return l4, l8

    flat4, flat8 = [[16] * 16] * 6, [[16] * 64] * 2
    defaults4, defaults8 = [list(DEFAULT4[0]), list(DEFAULT4[1])], [list(DEFAULT8[0]), list(DEFAULT8[1])]
    if sps.seq_scaling_matrix_present_flag:
        s4, s8 = resolve(sps.lists, defaults4, defaults8)
    else:
        s4, s8 = flat4, flat8
    if pps is None or not pps.pic_scaling_matrix_present_flag:
        return s4, s8
    if sps.seq_scaling_matrix_present_flag:
        return resolve(pps.lists, [s4[0], s4[3]], s8)
    return resolve(pps.lists, defaults4, defaults8)


def hrd_syntax(io, h: Syntax):
    h.cpb_cnt_minus1 = io.ue(h.cpb_cnt_minus1)
    h.bit_rate_scale = io.u(4, h.bit_rate_scale)
    h.cpb_size_scale = io.u(4, h.cpb_size_scale)
    for k in ("bit_rate_value_minus1", "cpb_size_value_minus1", "cbr_flag"):
        h[k] = list(h.get(k) or [])
    for i in range(h.cpb_cnt_minus1 + 1):
        got = [h[k][i] if i < len(h[k]) else None for k in ("bit_rate_value_minus1", "cpb_size_value_minus1", "cbr_flag")]
        vals = (io.ue(got[0]), io.ue(got[1]), io.u(1, got[2]))
        for k, v in zip(("bit_rate_value_minus1", "cpb_size_value_minus1", "cbr_flag"), vals):
            if i < len(h[k]):
                h[k][i] = v
            else:
                h[k].append(v)
    for k in ("initial_cpb_removal_delay_length_minus1", "cpb_removal_delay_length_minus1",
              "dpb_output_delay_length_minus1", "time_offset_length"):
        h[k] = io.u(5, h.get(k))


def vui_syntax(io, v: Syntax):
    v.aspect_ratio_info_present_flag = io.u(1, v.aspect_ratio_info_present_flag)
    if v.aspect_ratio_info_present_flag:
        v.aspect_ratio_idc = io.u(8, v.aspect_ratio_idc)
        if v.aspect_ratio_idc == 255:
            v.sar_width = io.u(16, v.sar_width)
            v.sar_height = io.u(16, v.sar_height)
    v.overscan_info_present_flag = io.u(1, v.overscan_info_present_flag)
    if v.overscan_info_present_flag:
        v.overscan_appropriate_flag = io.u(1, v.overscan_appropriate_flag)
    v.video_signal_type_present_flag = io.u(1, v.video_signal_type_present_flag)
    if v.video_signal_type_present_flag:
        v.video_format = io.u(3, v.video_format)
        v.video_full_range_flag = io.u(1, v.video_full_range_flag)
        v.colour_description_present_flag = io.u(1, v.colour_description_present_flag)
        if v.colour_description_present_flag:
            v.colour_primaries = io.u(8, v.colour_primaries)
            v.transfer_characteristics = io.u(8, v.transfer_characteristics)
            v.matrix_coefficients = io.u(8, v.matrix_coefficients)
    v.chroma_loc_info_present_flag = io.u(1, v.chroma_loc_info_present_flag)
    if v.chroma_loc_info_present_flag:
        v.chroma_sample_loc_type_top_field = io.ue(v.chroma_sample_loc_type_top_field)
        v.chroma_sample_loc_type_bottom_field = io.ue(v.chroma_sample_loc_type_bottom_field)
    v.timing_info_present_flag = io.u(1, v.timing_info_present_flag)
    if v.timing_info_present_flag:
        v.num_units_in_tick = io.u(32, v.num_units_in_tick)
        v.time_scale = io.u(32, v.time_scale)
        v.fixed_frame_rate_flag = io.u(1, v.fixed_frame_rate_flag)
    for k in ("nal_hrd", "vcl_hrd"):
        v[k + "_parameters_present_flag"] = io.u(1, v.get(k + "_parameters_present_flag"))
        if v[k + "_parameters_present_flag"]:
            v[k] = v.get(k) or Syntax()
            hrd_syntax(io, v[k])
    if v.nal_hrd_parameters_present_flag or v.vcl_hrd_parameters_present_flag:
        v.low_delay_hrd_flag = io.u(1, v.low_delay_hrd_flag)
    v.pic_struct_present_flag = io.u(1, v.pic_struct_present_flag)
    v.bitstream_restriction_flag = io.u(1, v.bitstream_restriction_flag)
    if v.bitstream_restriction_flag:
        v.motion_vectors_over_pic_boundaries_flag = io.u(1, v.motion_vectors_over_pic_boundaries_flag)
        for k in ("max_bytes_per_pic_denom", "max_bits_per_mb_denom", "log2_max_mv_length_horizontal",
                  "log2_max_mv_length_vertical", "max_num_reorder_frames", "max_dec_frame_buffering"):
            v[k] = io.ue(v.get(k))


def sps_syntax(io, s: Syntax):
    """seq_parameter_set_rbsp() without its trailing bits."""
    s.profile_idc = io.u(8, s.profile_idc)
    s.constraint_flags = io.u(8, s.constraint_flags)
    s.level_idc = io.u(8, s.level_idc)
    s.sps_id = io.ue(s.sps_id)
    if not io.writing:
        s.chroma_format_idc, s.bit_depth_luma_minus8, s.bit_depth_chroma_minus8 = 1, 0, 0
        s.qpprime_y_zero_transform_bypass_flag = s.seq_scaling_matrix_present_flag = 0
    if s.profile_idc in HIGH_PROFILES:
        s.chroma_format_idc = io.ue(s.chroma_format_idc)
        if s.chroma_format_idc == 3:
            s.separate_colour_plane_flag = io.u(1, s.separate_colour_plane_flag)
        s.bit_depth_luma_minus8 = io.ue(s.bit_depth_luma_minus8)
        s.bit_depth_chroma_minus8 = io.ue(s.bit_depth_chroma_minus8)
        s.qpprime_y_zero_transform_bypass_flag = io.u(1, s.qpprime_y_zero_transform_bypass_flag)
        s.seq_scaling_matrix_present_flag = io.u(1, s.seq_scaling_matrix_present_flag)
        if s.seq_scaling_matrix_present_flag:
            _lists(io, s, 8 if s.chroma_format_idc != 3 else 12)
    s.log2_max_frame_num = io.ue(None if s.log2_max_frame_num is None else s.log2_max_frame_num - 4) + 4
    s.pic_order_cnt_type = io.ue(s.pic_order_cnt_type)
    if s.pic_order_cnt_type == 0:
        s.log2_max_poc_lsb = io.ue(None if s.log2_max_poc_lsb is None else s.log2_max_poc_lsb - 4) + 4
    elif s.pic_order_cnt_type == 1:
        s.delta_pic_order_always_zero_flag = io.u(1, s.delta_pic_order_always_zero_flag)
        s.offset_for_non_ref_pic = io.se(s.offset_for_non_ref_pic)
        s.offset_for_top_to_bottom_field = io.se(s.offset_for_top_to_bottom_field)
        given = s.offset_for_ref_frame
        n = io.ue(None if given is None else len(given))
        s.offset_for_ref_frame = [io.se(None if given is None else given[i]) for i in range(n)]
    s.max_num_ref_frames = io.ue(s.max_num_ref_frames)
    s.gaps_in_frame_num_value_allowed_flag = io.u(1, s.gaps_in_frame_num_value_allowed_flag)
    s.mb_width = io.ue(None if s.mb_width is None else s.mb_width - 1) + 1
    s.mb_height = io.ue(None if s.mb_height is None else s.mb_height - 1) + 1
    s.frame_mbs_only_flag = io.u(1, s.frame_mbs_only_flag)
    if not s.frame_mbs_only_flag:
        s.mb_adaptive_frame_field_flag = io.u(1, s.mb_adaptive_frame_field_flag)
    s.direct_8x8_inference_flag = io.u(1, s.direct_8x8_inference_flag)
    s.frame_cropping_flag = io.u(1, s.frame_cropping_flag)
    s.crop = list(s.crop) if s.crop else [0, 0, 0, 0]
    if s.frame_cropping_flag:
        s.crop = [io.ue(c) for c in s.crop]  # left, right, top, bottom
    s.vui_parameters_present_flag = io.u(1, s.vui_parameters_present_flag)
    if s.vui_parameters_present_flag:
        s.vui = s.vui if s.vui is not None else Syntax()
        vui_syntax(io, s.vui)


def pps_syntax(io, p: Syntax, sps_by_id: dict):
    """pic_parameter_set_rbsp() without its trailing bits."""
    p.pps_id = io.ue(p.pps_id)
    p.sps_id = io.ue(p.sps_id)
    p.entropy_coding_mode_flag = io.u(1, p.entropy_coding_mode_flag)
    p.bottom_field_pic_order_in_frame_present_flag = io.u(1, p.bottom_field_pic_order_in_frame_present_flag)
    p.num_slice_groups_minus1 = io.ue(p.num_slice_groups_minus1)
    if p.num_slice_groups_minus1:
        raise H264Error(f"a PPS with {p.num_slice_groups_minus1 + 1} slice groups (FMO) is not read")
    p.num_ref_idx_default = [io.ue(None if p.num_ref_idx_default is None else p.num_ref_idx_default[k] - 1) + 1
                             for k in range(2)]
    p.weighted_pred_flag = io.u(1, p.weighted_pred_flag)
    p.weighted_bipred_idc = io.u(2, p.weighted_bipred_idc)
    p.pic_init_qp = io.se(None if p.pic_init_qp is None else p.pic_init_qp - 26) + 26
    p.pic_init_qs = io.se(None if p.pic_init_qs is None else p.pic_init_qs - 26) + 26
    p.chroma_qp_index_offset = io.se(p.chroma_qp_index_offset)
    p.deblocking_filter_control_present_flag = io.u(1, p.deblocking_filter_control_present_flag)
    p.constrained_intra_pred_flag = io.u(1, p.constrained_intra_pred_flag)
    p.redundant_pic_cnt_present_flag = io.u(1, p.redundant_pic_cnt_present_flag)
    p.transform_8x8_mode_flag = p.transform_8x8_mode_flag or 0
    p.pic_scaling_matrix_present_flag = p.pic_scaling_matrix_present_flag or 0
    if io.more_rbsp_data(p.second_chroma_qp_index_offset is not None if io.writing else None):
        p.transform_8x8_mode_flag = io.u(1, p.transform_8x8_mode_flag)
        p.pic_scaling_matrix_present_flag = io.u(1, p.pic_scaling_matrix_present_flag)
        if p.pic_scaling_matrix_present_flag:
            sps = sps_by_id.get(p.sps_id)
            if sps is None:
                raise H264Error(f"PPS {p.pps_id} names SPS {p.sps_id}, which the stream has not sent")
            _lists(io, p, 6 + (2 if p.transform_8x8_mode_flag else 0) * (3 if sps.chroma_format_idc == 3 else 1))
        p.second_chroma_qp_index_offset = io.se(p.second_chroma_qp_index_offset)
    else:
        p.second_chroma_qp_index_offset = p.chroma_qp_index_offset


def check_sps(s: Syntax) -> None:
    """Raises, naming the tool, for what the port does not decode."""
    if not s.frame_mbs_only_flag:
        raise H264Error("an interlaced H.264 stream (frame_mbs_only_flag 0: PAFF / MBAFF) is not read")
    if s.chroma_format_idc not in (0, 1):
        raise H264Error(f"H.264 chroma_format_idc {s.chroma_format_idc} (4:2:2 / 4:4:4) is not read: the port "
                        "decodes 4:2:0 and 4:0:0")
    if s.bit_depth_luma_minus8 or s.bit_depth_chroma_minus8:
        raise H264Error(f"H.264 at {8 + s.bit_depth_luma_minus8} bits (High 10 and above) is not read: the port "
                        "decodes 8-bit streams")
    if s.qpprime_y_zero_transform_bypass_flag:
        raise H264Error("H.264 lossless transform bypass (qpprime_y_zero_transform_bypass_flag) is not read")
    if s.pic_order_cnt_type not in (0, 1, 2):
        raise H264Error(f"H.264 pic_order_cnt_type {s.pic_order_cnt_type}")


# ------------------------------------------------------------------ slice header


def slice_header_syntax(io, h: Syntax, nal_type: int, nal_ref_idc: int, sps_by_id: dict, pps_by_id: dict):
    """slice_header(); ``h.sps`` / ``h.pps`` are set to the parameter sets
    it names. Writing, ``h`` holds every element to write under the names
    reading gives it (``modification``: per list [(idc, value)];
    ``weights.table``: per list, per reference ((w, o) or None,
    [(w, o), (w, o)] or None); ``mmco``: [(op, a, b)])."""
    wr = io.writing

    def v(name):
        return h.get(name) if wr else None

    h.first_mb = io.ue(v("first_mb"))
    h.slice_type_raw = io.ue(v("slice_type_raw"))
    h.slice_type = h.slice_type_raw % 5
    if h.slice_type in (SP, SI):
        raise H264Error(f"an H.264 {'SP' if h.slice_type == SP else 'SI'} slice is not read")
    h.pps_id = io.ue(v("pps_id"))
    pps = pps_by_id.get(h.pps_id)
    if pps is None:
        raise H264Error(f"a slice names PPS {h.pps_id}, which the stream has not sent")
    sps = sps_by_id.get(pps.sps_id)
    if sps is None:
        raise H264Error(f"PPS {h.pps_id} names SPS {pps.sps_id}, which the stream has not sent")
    h.pps, h.sps = pps, sps
    h.nal_type, h.nal_ref_idc = nal_type, nal_ref_idc
    h.idr = nal_type == NAL_IDR
    h.frame_num = io.u(sps.log2_max_frame_num, v("frame_num"))
    if h.idr:
        h.idr_pic_id = io.ue(v("idr_pic_id"))
    if sps.pic_order_cnt_type == 0:
        h.poc_lsb = io.u(sps.log2_max_poc_lsb, v("poc_lsb"))
        h.delta_poc_bottom = (io.se(v("delta_poc_bottom")) if pps.bottom_field_pic_order_in_frame_present_flag
                              else 0)
    else:
        h.poc_lsb = h.delta_poc_bottom = 0
    delta = list(v("delta_poc") or [0, 0])
    h.delta_poc = [0, 0]
    if sps.pic_order_cnt_type == 1 and not sps.delta_pic_order_always_zero_flag:
        h.delta_poc[0] = io.se(delta[0] if wr else None)
        if pps.bottom_field_pic_order_in_frame_present_flag:
            h.delta_poc[1] = io.se(delta[1] if wr else None)
    if pps.redundant_pic_cnt_present_flag:
        h.redundant_pic_cnt = io.ue(v("redundant_pic_cnt"))
        if h.redundant_pic_cnt:
            raise H264Error("a redundant H.264 picture (redundant_pic_cnt > 0) is not read")
    if h.slice_type == B:
        h.direct_spatial_mv_pred_flag = io.u(1, v("direct_spatial_mv_pred_flag"))
    lists = 2 if h.slice_type == B else (1 if h.slice_type == P else 0)
    given = list(v("num_ref_idx") or [0, 0])
    h.num_ref_idx = [0, 0]
    if lists:
        override = io.u(1, int(given[:lists] != pps.num_ref_idx_default[:lists]) if wr else None)
        for lx in range(lists):
            h.num_ref_idx[lx] = io.ue(given[lx] - 1 if wr else None) + 1 if override else pps.num_ref_idx_default[lx]
        if max(h.num_ref_idx) > 32:
            raise H264Error(f"num_ref_idx_active {h.num_ref_idx} above 32")
    # ref_pic_list_modification()
    mods = v("modification") or [[], []]
    h.modification = [[], []]
    for lx in range(lists):
        if io.u(1, int(bool(mods[lx])) if wr else None):
            k = 0
            while True:
                idc = io.ue((mods[lx][k][0] if k < len(mods[lx]) else 3) if wr else None)
                if idc == 3:
                    break
                if idc > 3:
                    raise H264Error(f"modification_of_pic_nums_idc {idc}")
                h.modification[lx].append((idc, io.ue(mods[lx][k][1] if wr else None)))
                k += 1
    # pred_weight_table()
    given_w = v("weights")
    h.weights = None
    if (pps.weighted_pred_flag and h.slice_type == P) or (pps.weighted_bipred_idc == 1 and h.slice_type == B):
        h.weights = wt = Syntax()
        wt.luma_log2_denom = io.ue(given_w.luma_log2_denom if wr else None)
        wt.chroma_log2_denom = io.ue(given_w.chroma_log2_denom if wr else None) if sps.chroma_format_idc else 0
        if wt.luma_log2_denom > 7 or wt.chroma_log2_denom > 7:
            raise H264Error(f"a weight denominator above 2^7: {wt.luma_log2_denom}, {wt.chroma_log2_denom}")
        wt.table = [[], []]
        for lx in range(lists):
            for i in range(h.num_ref_idx[lx]):
                g = given_w.table[lx][i] if wr else None
                luma = chroma = None
                if io.u(1, int(g[0] is not None) if wr else None):
                    luma = (io.se(g[0][0] if wr else None), io.se(g[0][1] if wr else None))
                if sps.chroma_format_idc and io.u(1, int(g[1] is not None) if wr else None):
                    chroma = [(io.se(g[1][c][0] if wr else None), io.se(g[1][c][1] if wr else None)) for c in range(2)]
                for ww, oo in ([luma] if luma else []) + (chroma or []):
                    if not (-128 <= ww <= 127 and -128 <= oo <= 127):
                        raise H264Error(f"a prediction weight or offset out of range: {ww}, {oo}")
                wt.table[lx].append((luma, chroma))
    # dec_ref_pic_marking()
    ops = (v("mmco") or []) if wr else None
    h.mmco = []
    if nal_ref_idc:
        if h.idr:
            h.no_output_of_prior_pics_flag = io.u(1, v("no_output_of_prior_pics_flag") or 0 if wr else None)
            h.long_term_reference_flag = io.u(1, v("long_term_reference_flag") or 0 if wr else None)
        else:
            if io.u(1, int(bool(ops)) if wr else None):
                k = 0
                while True:
                    op = io.ue((ops[k][0] if k < len(ops) else 0) if wr else None)
                    if op == 0:
                        break
                    if op > 6:
                        raise H264Error(f"memory_management_control_operation {op}")
                    a = io.ue(ops[k][1] if wr else None) if op in (1, 2, 3, 4) else 0
                    b = io.ue(ops[k][2] if wr else None) if op in (3, 6) else 0
                    h.mmco.append((op, a, b))
                    k += 1
    if not h.idr or not nal_ref_idc:
        h.long_term_reference_flag = 0
    h.cabac_init_idc = 0
    if pps.entropy_coding_mode_flag and h.slice_type != I:
        h.cabac_init_idc = io.ue(v("cabac_init_idc"))
        if h.cabac_init_idc > 2:
            raise H264Error(f"cabac_init_idc {h.cabac_init_idc}")
    h.slice_qp = pps.pic_init_qp + io.se(h.slice_qp - pps.pic_init_qp if wr else None)
    if not 0 <= h.slice_qp <= 51:
        raise H264Error(f"SliceQPY {h.slice_qp}")
    deblock = list(v("deblock") or [0, 0, 0])  # idc, alpha offset, beta offset
    h.deblock = [0, 0, 0]
    if pps.deblocking_filter_control_present_flag:
        h.deblock[0] = io.ue(deblock[0] if wr else None)
        if h.deblock[0] > 2:
            raise H264Error(f"disable_deblocking_filter_idc {h.deblock[0]}")
        if h.deblock[0] != 1:
            h.deblock[1] = 2 * io.se(deblock[1] // 2 if wr else None)
            h.deblock[2] = 2 * io.se(deblock[2] // 2 if wr else None)


# ------------------------------------------------------------------ a stream's NAL units


class NalUnit:
    """One NAL unit: its header and RBSP."""

    __slots__ = ("ref_idc", "type", "rbsp")

    def __init__(self, nal: bytes):
        if not nal or nal[0] & 0x80:
            raise H264Error(f"a NAL unit with forbidden_zero_bit set or empty ({nal[:1].hex()})")
        self.ref_idc = (nal[0] >> 5) & 3
        self.type = nal[0] & 31
        self.rbsp = unescape(nal[1:])


#: NAL unit types the decoder skips, as FFmpeg's does
SKIPPED = {0, 6, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31}
