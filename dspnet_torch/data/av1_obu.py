"""AV1 open bitstream units (section 5 of the AV1 specification) as far as
a still image needs them: OBU headers, the sequence header (reduced and
full), the uncompressed header of a key or intra-only frame and the tile
groups' tile bytes.

:func:`read_frame` takes one temporal unit (an AVIF item's payload, with the
``av1C`` box's configuration OBUs as the fallback sequence header) and
returns the :class:`SequenceHeader`, the :class:`FrameHeader` and each
tile's bytes. It refuses by name what a still image read here never holds:
an inter frame, a shown existing frame, superres, more than one frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from dspnet_torch.data.av1_tables import REMAP_LR_TYPE, RESTORE_NONE

OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER, OBU_FRAME_HEADER, OBU_TILE_GROUP, OBU_METADATA, OBU_FRAME, \
    OBU_REDUNDANT_FRAME_HEADER, OBU_TILE_LIST = range(1, 9)
OBU_PADDING = 15
KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME = range(4)
SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
SEG_FEATURE_MAX = (255, 63, 63, 63, 63, 7, 0, 0)
SEG_LVL_ALT_Q, SEG_LVL_ALT_LF_Y_V = 0, 1
SEG_LVL_REF_FRAME, SEG_LVL_SKIP, SEG_LVL_GLOBALMV = 5, 6, 7


class Av1Error(ValueError):
    """An AV1 stream the port does not read, or a broken one."""


class BitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.bit = pos * 8

    def f(self, n: int) -> int:
        x = 0
        for _ in range(n):
            byte = self.data[self.bit >> 3] if (self.bit >> 3) < len(self.data) else 0
            x = (x << 1) | ((byte >> (7 - (self.bit & 7))) & 1)
            self.bit += 1
        return x

    def su(self, n: int) -> int:
        v = self.f(n)
        sign = 1 << (n - 1)
        return v - 2 * sign if v & sign else v

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        return v if v < m else (v << 1) - m + self.f(1)

    def uvlc(self) -> int:
        lead = 0
        while not self.f(1):
            lead += 1
            if lead >= 32:
                return (1 << 32) - 1
        return self.f(lead) + (1 << lead) - 1

    def leb128(self) -> int:
        v = 0
        for i in range(8):
            b = self.f(8)
            v |= (b & 0x7F) << (i * 7)
            if not b & 0x80:
                break
        return v

    def byte_align(self) -> None:
        self.bit = (self.bit + 7) & ~7

    @property
    def byte(self) -> int:
        return self.bit >> 3


@dataclass
class SequenceHeader:
    profile: int = 0
    still_picture: int = 0
    reduced: int = 0
    timing_info_present: int = 0
    equal_picture_interval: int = 0
    decoder_model_info_present: int = 0
    buffer_removal_time_length: int = 0
    frame_presentation_time_length: int = 0
    op_idc: List[int] = field(default_factory=list)
    decoder_model_present_for_op: List[int] = field(default_factory=list)
    frame_width_bits: int = 0
    frame_height_bits: int = 0
    max_width: int = 0
    max_height: int = 0
    frame_id_numbers_present: int = 0
    id_len: int = 0
    sb128: int = 0
    enable_filter_intra: int = 0
    enable_intra_edge_filter: int = 0
    enable_order_hint: int = 0
    order_hint_bits: int = 0
    force_screen_content_tools: int = 2
    force_integer_mv: int = 2
    enable_superres: int = 0
    enable_cdef: int = 0
    enable_restoration: int = 0
    bit_depth: int = 8
    mono: int = 0
    color_description_present: int = 0
    color_primaries: int = 2
    transfer: int = 2
    matrix: int = 2
    color_range: int = 0
    ssx: int = 1
    ssy: int = 1
    chroma_sample_position: int = 0
    separate_uv_delta_q: int = 0
    film_grain_params_present: int = 0

    @property
    def num_planes(self) -> int:
        return 1 if self.mono else 3


def parse_sequence_header(r: BitReader) -> SequenceHeader:
    s = SequenceHeader()
    s.profile = r.f(3)
    s.still_picture = r.f(1)
    s.reduced = r.f(1)
    if s.profile > 2:
        raise Av1Error(f"AV1 seq_profile {s.profile}")
    if s.reduced:
        s.op_idc = [0]
        r.f(5)  # seq_level_idx[0]
        s.decoder_model_present_for_op = [0]
    else:
        s.timing_info_present = r.f(1)
        buffer_delay_length = 0
        if s.timing_info_present:
            r.f(32)
            r.f(32)
            s.equal_picture_interval = r.f(1)
            if s.equal_picture_interval:
                r.uvlc()
            s.decoder_model_info_present = r.f(1)
            if s.decoder_model_info_present:
                buffer_delay_length = r.f(5) + 1
                r.f(32)
                s.buffer_removal_time_length = r.f(5) + 1
                s.frame_presentation_time_length = r.f(5) + 1
        initial_display_delay_present = r.f(1)
        count = r.f(5) + 1
        for _ in range(count):
            s.op_idc.append(r.f(12))
            level = r.f(5)
            if level > 7:
                r.f(1)
            present = 0
            if s.decoder_model_info_present:
                present = r.f(1)
                if present:
                    r.f(buffer_delay_length)
                    r.f(buffer_delay_length)
                    r.f(1)
            s.decoder_model_present_for_op.append(present)
            if initial_display_delay_present and r.f(1):
                r.f(4)
    s.frame_width_bits = r.f(4) + 1
    s.frame_height_bits = r.f(4) + 1
    s.max_width = r.f(s.frame_width_bits) + 1
    s.max_height = r.f(s.frame_height_bits) + 1
    if not s.reduced:
        s.frame_id_numbers_present = r.f(1)
    if s.frame_id_numbers_present:
        delta = r.f(4) + 2
        s.id_len = r.f(3) + 1 + delta
    s.sb128 = r.f(1)
    s.enable_filter_intra = r.f(1)
    s.enable_intra_edge_filter = r.f(1)
    if not s.reduced:
        r.f(1)  # interintra compound
        r.f(1)  # masked compound
        r.f(1)  # warped motion
        r.f(1)  # dual filter
        s.enable_order_hint = r.f(1)
        if s.enable_order_hint:
            r.f(1)  # jnt comp
            r.f(1)  # ref frame mvs
        if r.f(1):  # seq_choose_screen_content_tools
            s.force_screen_content_tools = 2
        else:
            s.force_screen_content_tools = r.f(1)
        if s.force_screen_content_tools > 0:
            s.force_integer_mv = 2 if r.f(1) else r.f(1)
        else:
            s.force_integer_mv = 2
        if s.enable_order_hint:
            s.order_hint_bits = r.f(3) + 1
    s.enable_superres = r.f(1)
    s.enable_cdef = r.f(1)
    s.enable_restoration = r.f(1)
    # color_config
    high = r.f(1)
    if s.profile == 2 and high:
        s.bit_depth = 12 if r.f(1) else 10
    else:
        s.bit_depth = 10 if high else 8
    s.mono = 0 if s.profile == 1 else r.f(1)
    s.color_description_present = r.f(1)
    if s.color_description_present:
        s.color_primaries, s.transfer, s.matrix = r.f(8), r.f(8), r.f(8)
    if s.mono:
        s.color_range = r.f(1)
        s.ssx = s.ssy = 1
        s.separate_uv_delta_q = 0
    else:
        if s.color_primaries == 1 and s.transfer == 13 and s.matrix == 0:
            s.color_range = 1
            s.ssx = s.ssy = 0
        else:
            s.color_range = r.f(1)
            if s.profile == 0:
                s.ssx = s.ssy = 1
            elif s.profile == 1:
                s.ssx = s.ssy = 0
            elif s.bit_depth == 12:
                s.ssx = r.f(1)
                s.ssy = r.f(1) if s.ssx else 0
            else:
                s.ssx, s.ssy = 1, 0
            if s.ssx and s.ssy:
                s.chroma_sample_position = r.f(2)
        s.separate_uv_delta_q = r.f(1)
    s.film_grain_params_present = r.f(1)
    return s


@dataclass
class FilmGrain:
    apply: int = 0
    seed: int = 0
    points_y: List[Tuple[int, int]] = field(default_factory=list)
    chroma_scaling_from_luma: int = 0
    points_cb: List[Tuple[int, int]] = field(default_factory=list)
    points_cr: List[Tuple[int, int]] = field(default_factory=list)
    scaling_shift: int = 8
    ar_coeff_lag: int = 0
    ar_coeffs_y: List[int] = field(default_factory=list)
    ar_coeffs_cb: List[int] = field(default_factory=list)
    ar_coeffs_cr: List[int] = field(default_factory=list)
    ar_coeff_shift: int = 6
    grain_scale_shift: int = 0
    cb_mult: int = 0
    cb_luma_mult: int = 0
    cb_offset: int = 0
    cr_mult: int = 0
    cr_luma_mult: int = 0
    cr_offset: int = 0
    overlap: int = 0
    clip_to_restricted_range: int = 0


@dataclass
class FrameHeader:
    frame_type: int = KEY_FRAME
    show_frame: int = 1
    showable_frame: int = 0
    error_resilient: int = 1
    disable_cdf_update: int = 0
    allow_screen_content_tools: int = 0
    force_integer_mv: int = 1
    width: int = 0
    height: int = 0
    render_width: int = 0
    render_height: int = 0
    mi_cols: int = 0
    mi_rows: int = 0
    allow_intrabc: int = 0
    disable_frame_end_update_cdf: int = 1
    # tiles
    tile_cols: int = 1
    tile_rows: int = 1
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    mi_col_starts: List[int] = field(default_factory=list)
    mi_row_starts: List[int] = field(default_factory=list)
    context_update_tile_id: int = 0
    tile_size_bytes: int = 4
    # quantizer
    base_q_idx: int = 0
    delta_q_y_dc: int = 0
    delta_q_u_dc: int = 0
    delta_q_u_ac: int = 0
    delta_q_v_dc: int = 0
    delta_q_v_ac: int = 0
    using_qmatrix: int = 0
    qm_y: int = 15
    qm_u: int = 15
    qm_v: int = 15
    # segmentation
    seg_enabled: int = 0
    seg_update_map: int = 0
    feature_enabled: List[List[int]] = field(default_factory=lambda: [[0] * 8 for _ in range(8)])
    feature_data: List[List[int]] = field(default_factory=lambda: [[0] * 8 for _ in range(8)])
    seg_id_pre_skip: int = 0
    last_active_seg_id: int = 0
    # delta q / lf
    delta_q_present: int = 0
    delta_q_res: int = 0
    delta_lf_present: int = 0
    delta_lf_res: int = 0
    delta_lf_multi: int = 0
    lossless: List[int] = field(default_factory=lambda: [0] * 8)
    coded_lossless: int = 0
    all_lossless: int = 0
    seg_qm_level: List[List[int]] = field(default_factory=lambda: [[15] * 8 for _ in range(3)])
    # loop filter
    lf_level: List[int] = field(default_factory=lambda: [0, 0, 0, 0])
    lf_sharpness: int = 0
    lf_delta_enabled: int = 0
    lf_ref_deltas: List[int] = field(default_factory=lambda: [1, 0, 0, 0, -1, 0, -1, -1])
    lf_mode_deltas: List[int] = field(default_factory=lambda: [0, 0])
    # cdef
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_y_pri: List[int] = field(default_factory=lambda: [0])
    cdef_y_sec: List[int] = field(default_factory=lambda: [0])
    cdef_uv_pri: List[int] = field(default_factory=lambda: [0])
    cdef_uv_sec: List[int] = field(default_factory=lambda: [0])
    # loop restoration
    lr_type: List[int] = field(default_factory=lambda: [RESTORE_NONE] * 3)
    lr_unit_size: List[int] = field(default_factory=lambda: [64, 64, 64])
    uses_lr: int = 0
    tx_mode_select: int = 0
    only_4x4: int = 0
    reduced_tx_set: int = 0
    grain: FilmGrain = field(default_factory=FilmGrain)

    def qindex(self, segment_id: int, current: Optional[int] = None) -> int:
        """``get_qindex``: the segment's q index from ``base_q_idx`` (or a
        delta-q ``current`` base)."""
        base = self.base_q_idx if current is None else current
        if self.seg_enabled and self.feature_enabled[segment_id][SEG_LVL_ALT_Q]:
            return max(0, min(255, base + self.feature_data[segment_id][SEG_LVL_ALT_Q]))
        return base


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def _tile_info(r: BitReader, s: SequenceHeader, h: FrameHeader) -> None:
    sb_shift = 5 if s.sb128 else 4
    sb_cols = (h.mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (h.mi_rows + (1 << sb_shift) - 1) >> sb_shift
    sb_size = sb_shift + 2
    max_tile_width_sb = 4096 >> sb_size
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols, _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    if r.f(1):  # uniform
        h.tile_cols_log2 = min_log2_cols
        while h.tile_cols_log2 < max_log2_cols and r.f(1):
            h.tile_cols_log2 += 1
        w = (sb_cols + (1 << h.tile_cols_log2) - 1) >> h.tile_cols_log2
        h.mi_col_starts = [x << sb_shift for x in range(0, sb_cols, w)] + [h.mi_cols]
        h.tile_rows_log2 = max(min_log2_tiles - h.tile_cols_log2, 0)
        while h.tile_rows_log2 < max_log2_rows and r.f(1):
            h.tile_rows_log2 += 1
        ht = (sb_rows + (1 << h.tile_rows_log2) - 1) >> h.tile_rows_log2
        h.mi_row_starts = [y << sb_shift for y in range(0, sb_rows, ht)] + [h.mi_rows]
    else:
        widest, start, starts = 0, 0, []
        while start < sb_cols:
            starts.append(start << sb_shift)
            size = r.ns(min(sb_cols - start, max_tile_width_sb)) + 1
            widest = max(widest, size)
            start += size
        h.mi_col_starts = starts + [h.mi_cols]
        area = (sb_rows * sb_cols) >> (min_log2_tiles + 1) if min_log2_tiles > 0 else sb_rows * sb_cols
        max_h = max(area // widest, 1)
        start, starts = 0, []
        while start < sb_rows:
            starts.append(start << sb_shift)
            start += r.ns(min(sb_rows - start, max_h)) + 1
        h.mi_row_starts = starts + [h.mi_rows]
        h.tile_cols_log2 = _tile_log2(1, len(h.mi_col_starts) - 1)
        h.tile_rows_log2 = _tile_log2(1, len(h.mi_row_starts) - 1)
    h.tile_cols = len(h.mi_col_starts) - 1
    h.tile_rows = len(h.mi_row_starts) - 1
    if h.tile_cols_log2 > 0 or h.tile_rows_log2 > 0:
        h.context_update_tile_id = r.f(h.tile_rows_log2 + h.tile_cols_log2)
        h.tile_size_bytes = r.f(2) + 1


def _delta_q(r: BitReader) -> int:
    return r.su(7) if r.f(1) else 0


def parse_frame_header(r: BitReader, s: SequenceHeader, temporal_id: int = 0, spatial_id: int = 0) -> FrameHeader:
    h = FrameHeader()
    if s.reduced:
        h.frame_type, h.show_frame = KEY_FRAME, 1
    else:
        if r.f(1):
            raise Av1Error("AV1 show_existing_frame in a still image")
        h.frame_type = r.f(2)
        if h.frame_type not in (KEY_FRAME, INTRA_ONLY_FRAME):
            raise Av1Error("AV1 inter frame (only key and intra-only frames are read)")
        h.show_frame = r.f(1)
        if h.show_frame and s.decoder_model_info_present and not s.equal_picture_interval:
            r.f(s.frame_presentation_time_length)
        h.showable_frame = (h.frame_type != KEY_FRAME) if h.show_frame else r.f(1)
        h.error_resilient = 1 if (h.frame_type == KEY_FRAME and h.show_frame) else r.f(1)
    h.disable_cdf_update = r.f(1)
    h.allow_screen_content_tools = r.f(1) if s.force_screen_content_tools == 2 else s.force_screen_content_tools
    if h.allow_screen_content_tools and s.force_integer_mv == 2:
        r.f(1)
    h.force_integer_mv = 1
    if s.frame_id_numbers_present:
        r.f(s.id_len)
    frame_size_override = 0 if s.reduced else r.f(1)
    r.f(s.order_hint_bits)
    # primary_ref_frame is PRIMARY_REF_NONE for intra frames
    if s.decoder_model_info_present:
        if r.f(1):  # buffer_removal_time_present_flag
            for op, idc in enumerate(s.op_idc):
                if s.decoder_model_present_for_op[op]:
                    in_t = (idc >> temporal_id) & 1
                    in_s = (idc >> (spatial_id + 8)) & 1
                    if idc == 0 or (in_t and in_s):
                        r.f(s.buffer_removal_time_length)
    refresh = 0xFF
    if not (h.frame_type == KEY_FRAME and h.show_frame):
        refresh = r.f(8)
    if refresh != 0xFF and h.error_resilient and s.enable_order_hint:
        for _ in range(8):
            r.f(s.order_hint_bits)
    # frame_size
    if frame_size_override:
        h.width = r.f(s.frame_width_bits) + 1
        h.height = r.f(s.frame_height_bits) + 1
    else:
        h.width, h.height = s.max_width, s.max_height
    if s.enable_superres and r.f(1):
        raise Av1Error("AV1 superres (use_superres) is not read")
    h.mi_cols = 2 * ((h.width + 7) >> 3)
    h.mi_rows = 2 * ((h.height + 7) >> 3)
    if r.f(1):  # render_and_frame_size_different
        h.render_width = r.f(16) + 1
        h.render_height = r.f(16) + 1
    else:
        h.render_width, h.render_height = h.width, h.height
    if h.allow_screen_content_tools:
        h.allow_intrabc = r.f(1)
    h.disable_frame_end_update_cdf = 1 if (s.reduced or h.disable_cdf_update) else r.f(1)
    _tile_info(r, s, h)
    # quantization_params
    h.base_q_idx = r.f(8)
    h.delta_q_y_dc = _delta_q(r)
    if s.num_planes > 1:
        diff_uv = r.f(1) if s.separate_uv_delta_q else 0
        h.delta_q_u_dc, h.delta_q_u_ac = _delta_q(r), _delta_q(r)
        if diff_uv:
            h.delta_q_v_dc, h.delta_q_v_ac = _delta_q(r), _delta_q(r)
        else:
            h.delta_q_v_dc, h.delta_q_v_ac = h.delta_q_u_dc, h.delta_q_u_ac
    h.using_qmatrix = r.f(1)
    if h.using_qmatrix:
        h.qm_y = r.f(4)
        h.qm_u = r.f(4)
        h.qm_v = r.f(4) if s.separate_uv_delta_q else h.qm_u
    # segmentation_params
    h.seg_enabled = r.f(1)
    if h.seg_enabled:
        h.seg_update_map = 1
        for i in range(8):
            for j in range(8):
                if r.f(1):
                    h.feature_enabled[i][j] = 1
                    bits, limit = SEG_FEATURE_BITS[j], SEG_FEATURE_MAX[j]
                    if SEG_FEATURE_SIGNED[j]:
                        v = max(-limit, min(limit, r.su(1 + bits)))
                    else:
                        v = max(0, min(limit, r.f(bits)))
                    h.feature_data[i][j] = v
        for i in range(8):
            for j in range(8):
                if h.feature_enabled[i][j]:
                    h.last_active_seg_id = i
                    if j >= SEG_LVL_REF_FRAME:
                        h.seg_id_pre_skip = 1
    # delta_q / delta_lf params
    if h.base_q_idx > 0:
        h.delta_q_present = r.f(1)
        if h.delta_q_present:
            h.delta_q_res = r.f(2)
    if h.delta_q_present:
        if not h.allow_intrabc:
            h.delta_lf_present = r.f(1)
        if h.delta_lf_present:
            h.delta_lf_res = r.f(2)
            h.delta_lf_multi = r.f(1)
    h.coded_lossless = 1
    for seg in range(8):
        q = h.qindex(seg)
        h.lossless[seg] = int(q == 0 and h.delta_q_y_dc == 0 and h.delta_q_u_ac == 0 and h.delta_q_u_dc == 0
                              and h.delta_q_v_ac == 0 and h.delta_q_v_dc == 0)
        if not h.lossless[seg]:
            h.coded_lossless = 0
        if h.using_qmatrix:
            if h.lossless[seg]:
                h.seg_qm_level[0][seg] = h.seg_qm_level[1][seg] = h.seg_qm_level[2][seg] = 15
            else:
                h.seg_qm_level[0][seg], h.seg_qm_level[1][seg], h.seg_qm_level[2][seg] = h.qm_y, h.qm_u, h.qm_v
    h.all_lossless = h.coded_lossless
    # loop_filter_params
    if not (h.coded_lossless or h.allow_intrabc):
        h.lf_level[0], h.lf_level[1] = r.f(6), r.f(6)
        if s.num_planes > 1 and (h.lf_level[0] or h.lf_level[1]):
            h.lf_level[2], h.lf_level[3] = r.f(6), r.f(6)
        h.lf_sharpness = r.f(3)
        h.lf_delta_enabled = r.f(1)
        if h.lf_delta_enabled and r.f(1):
            for i in range(8):
                if r.f(1):
                    h.lf_ref_deltas[i] = r.su(7)
            for i in range(2):
                if r.f(1):
                    h.lf_mode_deltas[i] = r.su(7)
    # cdef_params
    if not (h.coded_lossless or h.allow_intrabc or not s.enable_cdef):
        h.cdef_damping = r.f(2) + 3
        h.cdef_bits = r.f(2)
        h.cdef_y_pri, h.cdef_y_sec, h.cdef_uv_pri, h.cdef_uv_sec = [], [], [], []
        for _ in range(1 << h.cdef_bits):
            h.cdef_y_pri.append(r.f(4))
            v = r.f(2)
            h.cdef_y_sec.append(v + (v == 3))
            if s.num_planes > 1:
                h.cdef_uv_pri.append(r.f(4))
                v = r.f(2)
                h.cdef_uv_sec.append(v + (v == 3))
            else:
                h.cdef_uv_pri.append(0)
                h.cdef_uv_sec.append(0)
    # lr_params
    if not (h.all_lossless or h.allow_intrabc or not s.enable_restoration):
        uses_chroma = 0
        for i in range(s.num_planes):
            h.lr_type[i] = REMAP_LR_TYPE[r.f(2)]
            if h.lr_type[i] != RESTORE_NONE:
                h.uses_lr = 1
                uses_chroma |= i > 0
        if h.uses_lr:
            if s.sb128:
                shift = r.f(1) + 1
            else:
                shift = r.f(1)
                if shift:
                    shift += r.f(1)
            size = 256 >> (2 - shift)
            uv_shift = r.f(1) if (s.ssx and s.ssy and uses_chroma) else 0
            h.lr_unit_size = [size, size >> uv_shift, size >> uv_shift]
    # read_tx_mode
    if h.coded_lossless:
        h.only_4x4 = 1
    else:
        h.tx_mode_select = r.f(1)
    h.reduced_tx_set = r.f(1)
    # film_grain_params
    if s.film_grain_params_present and (h.show_frame or h.showable_frame):
        g = h.grain
        g.apply = r.f(1)
        if g.apply:
            g.seed = r.f(16)
            g.points_y = [(r.f(8), r.f(8)) for _ in range(r.f(4))]
            g.chroma_scaling_from_luma = 0 if s.mono else r.f(1)
            if not (s.mono or g.chroma_scaling_from_luma or (s.ssx == 1 and s.ssy == 1 and not g.points_y)):
                g.points_cb = [(r.f(8), r.f(8)) for _ in range(r.f(4))]
                g.points_cr = [(r.f(8), r.f(8)) for _ in range(r.f(4))]
            g.scaling_shift = r.f(2) + 8
            g.ar_coeff_lag = r.f(2)
            num_pos_luma = 2 * g.ar_coeff_lag * (g.ar_coeff_lag + 1)
            if g.points_y:
                num_pos_chroma = num_pos_luma + 1
                g.ar_coeffs_y = [r.f(8) - 128 for _ in range(num_pos_luma)]
            else:
                num_pos_chroma = num_pos_luma
            if g.chroma_scaling_from_luma or g.points_cb:
                g.ar_coeffs_cb = [r.f(8) - 128 for _ in range(num_pos_chroma)]
            if g.chroma_scaling_from_luma or g.points_cr:
                g.ar_coeffs_cr = [r.f(8) - 128 for _ in range(num_pos_chroma)]
            g.ar_coeff_shift = r.f(2) + 6
            g.grain_scale_shift = r.f(2)
            if g.points_cb:
                g.cb_mult, g.cb_luma_mult, g.cb_offset = r.f(8), r.f(8), r.f(9)
            if g.points_cr:
                g.cr_mult, g.cr_luma_mult, g.cr_offset = r.f(8), r.f(8), r.f(9)
            g.overlap = r.f(1)
            g.clip_to_restricted_range = r.f(1)
    return h


@dataclass
class Frame:
    seq: SequenceHeader
    hdr: FrameHeader
    tiles: List[Tuple[int, int, bytes]]  # (tile row, tile col, bytes)


def obus(data: bytes):
    """(type, temporal id, spatial id, payload start, payload end) of each OBU."""
    pos = 0
    while pos < len(data):
        r = BitReader(data, pos)
        if r.f(1):
            raise Av1Error("AV1 OBU with the forbidden bit set")
        kind = r.f(4)
        ext = r.f(1)
        has_size = r.f(1)
        r.f(1)
        tid = sid = 0
        if ext:
            tid, sid = r.f(3), r.f(2)
            r.f(3)
        size = r.leb128() if has_size else len(data) - r.byte
        start = r.byte
        if start + size > len(data):
            raise Av1Error("AV1 OBU past the end of the item")
        yield kind, tid, sid, start, start + size
        pos = start + size


def _tile_group(data: bytes, start: int, end: int, h: FrameHeader, r: BitReader, tiles: list) -> bool:
    n = h.tile_cols * h.tile_rows
    flag = r.f(1) if n > 1 else 0
    if flag:
        bits = h.tile_cols_log2 + h.tile_rows_log2
        tg_start, tg_end = r.f(bits), r.f(bits)
    else:
        tg_start, tg_end = 0, n - 1
    r.byte_align()
    pos = r.byte
    for num in range(tg_start, tg_end + 1):
        if num == tg_end:
            size = end - pos
        else:
            size = int.from_bytes(data[pos:pos + h.tile_size_bytes], "little") + 1
            pos += h.tile_size_bytes
        if pos + size > end or size <= 0:
            raise Av1Error("AV1 tile size past its tile group")
        tiles.append((num // h.tile_cols, num % h.tile_cols, data[pos:pos + size]))
        pos += size
    return tg_end == n - 1


def read_frame(data: bytes, config_obus: bytes = b"") -> Frame:
    """The first frame of a temporal unit: its headers and tile bytes."""
    seq: Optional[SequenceHeader] = None
    if config_obus:
        for kind, _, _, a, b in obus(config_obus):
            if kind == OBU_SEQUENCE_HEADER:
                seq = parse_sequence_header(BitReader(config_obus[:b], a))
    hdr: Optional[FrameHeader] = None
    tiles: list = []
    for kind, tid, sid, a, b in obus(data):
        if kind == OBU_SEQUENCE_HEADER:
            seq = parse_sequence_header(BitReader(data[:b], a))
        elif kind in (OBU_FRAME, OBU_FRAME_HEADER):
            if seq is None:
                raise Av1Error("AV1 frame before any sequence header")
            if hdr is not None:
                if kind == OBU_FRAME_HEADER:
                    continue  # a redundant copy
                raise Av1Error("AV1 item holding more than one frame (a layered image)")
            r = BitReader(data[:b], a)
            hdr = parse_frame_header(r, seq, tid, sid)
            if kind == OBU_FRAME:
                r.byte_align()
                if _tile_group(data, a, b, hdr, r, tiles):
                    break
        elif kind == OBU_TILE_GROUP:
            if hdr is None:
                raise Av1Error("AV1 tile group before its frame header")
            if _tile_group(data, a, b, hdr, BitReader(data[:b], a), tiles):
                break
    if hdr is None or seq is None:
        raise Av1Error("AV1 item without a frame")
    if len(tiles) != hdr.tile_cols * hdr.tile_rows:
        raise Av1Error("AV1 frame with missing tiles")
    return Frame(seq, hdr, tiles)
