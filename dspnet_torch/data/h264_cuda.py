"""H.264 decode on the card: the host's NAL units, parameter sets, slice
headers and decoded picture buffer (``data/h264_nal.py``,
``data/h264_dpb.py``), then three hand-written kernels (``csrc/h264.cu``,
built by ``ops/_build.py`` and bound with ctypes), and their plain versions.

:class:`Decoder` decodes a stream's samples in batches (``video.
DECODE_BATCH`` of them at a time): the host splits each sample into NAL
units, reads the parameter sets and slice headers and plans each picture in
the DPB (POC, reference lists as picture ids, marking, output order);
:func:`stage` copies the batch's slice data and its slice table to the card
once through pinned memory on the caller's current stream; then

* :func:`parse`: ``h264_parse_kernel``, a warp per slice (lane 0 runs the
  slice's chain of bins and symbols from shared memory, the warp stores
  each macroblock's results), every slice of the batch in one launch -> per
  picture the macroblock table (``h264_parse.MB_FIELDS``) and the int16
  levels;
* :func:`recon`: per picture ``h264_mv_kernel`` (the motion vectors, rows
  of macroblocks over the grid in the standard's order),
  ``h264_inter_kernel`` (every macroblock's residual and the inter
  prediction, a block a macroblock) and ``h264_intra_kernel`` (the intra
  macroblocks in the standard's order) -> the unfiltered Y, U, V planes and
  the picture's motion field (kept on the card for later direct prediction
  and deblocking);
* :func:`deblock`: per picture ``h264_bs_kernel`` (every boundary strength)
  and ``h264_filter_kernel`` (the edges in the standard's order), in place;
* the crop, and ``mpeg4_cuda.yuv420_to_bgr`` (``yuv420_to_bgr_kernel``)
  for cv2's BGR frames.

Each stage adds one to :data:`launches` a call (a picture; the parse a
batch) and each launch of a kernel one to :data:`kernel_launches`, where it
launches it and nowhere else. On a CPU tensor each runs its plain version (``h264_parse``,
``h264_recon``, ``h264_filters``; counted in :data:`plain_calls`); on a
CUDA tensor it launches the kernel or raises. A stream the port does not
read raises ``h264_nal.H264Error`` naming what it holds; nothing on a card
falls back to a plain version. ``Decoder.decode`` returns the frames cv2
would have returned by then (FFmpeg's output delay);
``Decoder.flush`` the rest at the end of the stream.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dspnet_torch.data import h264_filters, h264_parse, h264_recon, mpeg4, mpeg4_cuda
from dspnet_torch.data import h264_nal as N
from dspnet_torch.data.h264_dpb import Dpb, Frame
from dspnet_torch.data.h264_recon import RefPicture, SliceInfo
from dspnet_torch.ops import _build

#: the kernels of each stage, in the order a call launches them
KERNELS = {"h264_parse": ("h264_parse_kernel",),
           "h264_recon": ("h264_mv_kernel", "h264_inter_kernel", "h264_intra_kernel"),
           "h264_deblock": ("h264_bs_kernel", "h264_filter_kernel")}
#: calls of each stage on a card (a picture; the parse a batch); a caller may reset them to 0
launches = {"h264_parse": 0, "h264_recon": 0, "h264_deblock": 0}
#: launches of each kernel
kernel_launches = {k: 0 for names in KERNELS.values() for k in names}
#: calls of each plain version (0 on the card's path)
plain_calls = {"h264_parse": 0, "h264_recon": 0, "h264_deblock": 0}

_SOURCE = _build.CSRC / "h264.cu"


@dataclass
class SliceJob:
    """One slice of a batch: its header, RBSP and where its data start."""

    h: N.Syntax
    rbsp: bytes
    pos: int
    picture: int  # index of its picture in the batch
    index: int  # its number within the picture


@dataclass
class PicturePlan:
    """One picture of a batch as the DPB planned it."""

    frame: Frame
    sps: N.Syntax
    slices: List[SliceInfo]
    outputs: List[Frame]
    col: Optional[int]  # the picture id of RefPicList1[0] (B pictures)
    gaps: List[Tuple[Frame, int]]  # frames a frame_num gap stands for, and whose samples each copies
    #: the references' ids as the slices name them (a gap frame by its source's) -> a picture holding them
    ref_pics: Dict[int, int]


def crop_rect(sps: N.Syntax) -> Tuple[int, int, int, int]:
    """(x, y, width, height) of the frame cv2 returns: the SPS's cropping in
    units of 2 samples (4:2:0; 1 for 4:0:0), applied whole (measured: cv2's
    frames are cropped on every side, the left included)."""
    unit = 2 if sps.chroma_format_idc == 1 else 1
    left, right, top, bottom = (c * unit for c in sps.crop) if sps.frame_cropping_flag else (0, 0, 0, 0)
    w, h = 16 * sps.mb_width, 16 * sps.mb_height
    return left, top, w - left - right, h - top - bottom


def colour(sps: N.Syntax) -> tuple:
    """swscale's coefficients for the stream's VUI: ``matrix_coefficients``
    and ``video_full_range_flag`` (BT.601 limited without them)."""
    v = sps.vui
    if v is None or not v.video_signal_type_present_flag:
        return mpeg4.swscale_colour()
    matrix = v.matrix_coefficients if v.colour_description_present_flag else 2
    return mpeg4.swscale_colour(matrix, bool(v.video_full_range_flag))


def check_output(sps: N.Syntax) -> None:
    """Raises for what cv2 returns and the port does not follow (measured)."""
    if sps.chroma_format_idc == 0:
        raise N.H264Error("monochrome (4:0:0) H.264 is not read: cv2's conversion of its gray frames is not "
                          "followed")
    if sps.frame_cropping_flag and sps.crop[0]:
        raise N.H264Error(f"H.264 with a left frame crop ({2 * sps.crop[0]} samples) is not read: cv2's frames of "
                          "it are measured to differ from the cropped picture")
    v = sps.vui
    if v is not None and v.video_signal_type_present_flag and v.colour_description_present_flag and \
            v.matrix_coefficients not in mpeg4._YUV2RGB_TABLES:
        raise N.H264Error(f"H.264 with matrix_coefficients {v.matrix_coefficients} is not read: cv2's colour for "
                          "it is measured for BT.601 and BT.709 only")


class Decoder:
    """One H.264 stream's decoder on ``device`` (a card, or the CPU through
    the plain versions): ``decode(samples)`` -> the frames cv2 returns by
    then, as (H, W, 3) uint8 BGR tensors on the device; ``flush()`` the
    delayed ones at the end. ``config``: an MP4 track's ``avcC`` (samples
    are then length-prefixed), empty for Annex B samples (AVI); ``fourcc``
    its tag."""

    def __init__(self, device, config: bytes = b"", fourcc: str = "avc1"):
        self.device = torch.device(device)
        self.fourcc = fourcc
        self.sps: Dict[int, N.Syntax] = {}
        self.pps: Dict[int, N.Syntax] = {}
        self.length_size = None
        if config:
            self.length_size, nals = N.parse_avcc(config)
            for nal in nals:
                self._nal(N.NalUnit(nal))
        self.dpb = Dpb()
        self.pics: Dict[int, RefPicture] = {}  # decoded pictures still referenced or awaiting output
        self.sps_of: Dict[int, N.Syntax] = {}
        #: the stages a decode runs, this module's functions; a caller may wrap one on an instance to time it or
        #: to hold it to its plain version, and the decode stays the one path
        self.stages = {"parse": parse, "recon": recon, "deblock": deblock, "colour": mpeg4_cuda.yuv420_to_bgr}

    # ------------------------------------------------------------ host side
    def _nal(self, nal: N.NalUnit):
        if nal.type == N.NAL_SPS:
            s = N.Syntax()
            N.sps_syntax(N.BitReader(nal.rbsp), s)
            N.check_sps(s)
            check_output(s)
            self.sps[s.sps_id] = s
        elif nal.type == N.NAL_PPS:
            p = N.Syntax()
            N.pps_syntax(N.BitReader(nal.rbsp), p, self.sps)
            self.pps[p.pps_id] = p
        elif nal.type in (2, 3, 4):
            raise N.H264Error(f"H.264 data partitioning (NAL type {nal.type}) is not read")

    def _slices(self, samples: List[bytes]) -> List[List[SliceJob]]:
        """The batch's slices grouped into pictures (7.4.1.2.4)."""
        pictures: List[List[SliceJob]] = []
        for data in samples:
            nals = N.split_length(data, self.length_size) if self.length_size else N.split_annexb(data)
            for raw in nals:
                nal = N.NalUnit(raw)
                if nal.type in (N.NAL_SLICE, N.NAL_IDR):
                    r = N.BitReader(nal.rbsp)
                    h = N.Syntax()
                    N.slice_header_syntax(r, h, nal.type, nal.ref_idc, self.sps, self.pps)
                    prev = pictures[-1][-1].h if pictures else None
                    new = prev is None or h.first_mb <= prev.first_mb or h.frame_num != prev.frame_num or \
                        h.pps_id != prev.pps_id or bool(h.nal_ref_idc) != bool(prev.nal_ref_idc) or \
                        h.idr != prev.idr or h.poc_lsb != prev.poc_lsb or h.delta_poc != prev.delta_poc or \
                        (h.idr and h.idr_pic_id != prev.idr_pic_id)
                    if new:
                        pictures.append([])
                    pictures[-1].append(SliceJob(h, nal.rbsp, r.pos, len(pictures) - 1, len(pictures[-1])))
                elif nal.type in N.SKIPPED:
                    continue
                else:
                    self._nal(nal)
        return pictures

    def _plan(self, pictures: List[List[SliceJob]]) -> List[PicturePlan]:
        plans = []
        for jobs in pictures:
            h0 = jobs[0].h
            sps = h0.sps
            f, gaps = self.dpb.start(h0)
            infos = []
            col = None
            ref_pics = {}
            for job in jobs:
                h = job.h
                h.poc = f.poc
                lists = self.dpb.lists(h)
                ref_pics.update((g.alias, g.pid) for lst in lists for g in lst)
                pps = h.pps
                l4, l8 = N.scaling_lists(sps, pps)
                s = SliceInfo(h.slice_type, int(h.direct_spatial_mv_pred_flag or 0),
                              [[g.alias for g in lst] for lst in lists], [[g.poc for g in lst] for lst in lists],
                              [[int(g.ref == "long") for g in lst] for lst in lists],
                              cip=int(pps.constrained_intra_pred_flag), direct8=int(sps.direct_8x8_inference_flag),
                              chroma_offsets=(pps.chroma_qp_index_offset, pps.second_chroma_qp_index_offset),
                              lists4=l4, lists8=l8, deblock=tuple(h.deblock))
                if h.slice_type == N.B:
                    col = lists[1][0].pid
                    if pps.weighted_bipred_idc == 2:
                        s.weighted = 2
                if h.weights is not None:
                    s.weighted = 1
                    s.luma_denom, s.chroma_denom = h.weights.luma_log2_denom, h.weights.chroma_log2_denom
                    for lx in range(2):
                        for luma, chroma in h.weights.table[lx]:
                            lw = luma or (1 << s.luma_denom, 0)
                            cw = chroma or [(1 << s.chroma_denom, 0)] * 2
                            s.weights[lx].append((lw[0], lw[1], cw[0][0], cw[0][1], cw[1][0], cw[1][1]))
                infos.append(s)
            self.dpb.mark(f, h0, sps.max_num_ref_frames)
            outs = self.dpb.add(f, sps)
            plans.append(PicturePlan(f, sps, infos, outs, col, gaps, ref_pics))
        return plans

    # ------------------------------------------------------------ decoding
    def decode(self, samples: List[bytes]) -> List[torch.Tensor]:
        pictures = self._slices(samples)
        if not pictures:
            return []
        plans = self._plan(pictures)
        jobs = [(j, plans[j.picture].sps) for p in pictures for j in p]
        tables = self.stages["parse"](jobs, len(pictures), self.device)
        out = []
        for plan, (table, levels) in zip(plans, tables):
            self._picture(plan, table, levels)
            out += [self._frame(f) for f in plan.outputs]
        self._release()
        return out

    def _picture(self, plan: PicturePlan, table, levels):
        """One picture from its parsed tables: the frames of a frame_num gap
        before it, the reconstruction from its references, the filter; kept
        as a reference."""
        self._fill_gaps(plan)
        refs = {alias: self.pics[pid] for alias, pid in plan.ref_pics.items()}
        col = self.pics.get(plan.col) if plan.col is not None else None
        y, u, v, mf = self.stages["recon"](table, levels, plan.slices, plan.sps, refs, col, plan.frame.poc)
        self.stages["deblock"](y, u, v, table, mf, plan.slices, plan.sps)
        self.pics[plan.frame.pid] = RefPicture(plan.frame.pid, plan.frame.poc, y, u, v, mf.mv, mf.ref, mf.ref_id,
                                               plan.frame.ref == "long")
        self.sps_of[plan.frame.pid] = plan.sps

    def _fill_gaps(self, plan: PicturePlan):
        """The frames of a frame_num gap: the copied picture's samples, no
        motion (intra-like; FFmpeg's is undefined there)."""
        for g, src in plan.gaps:
            p = self.pics[src]
            none = torch.full_like(p.ref, -1)
            self.pics[g.pid] = RefPicture(g.pid, g.poc, p.y, p.u, p.v, torch.zeros_like(p.mv), none, none.clone())
            self.sps_of[g.pid] = self.sps_of[src]

    def flush(self) -> List[torch.Tensor]:
        out = [self._frame(f) for f in self.dpb.flush()]
        self._release()
        return out

    def _release(self):
        keep = {f.pid for f in self.dpb.frames} | {f.pid for f in self.dpb.delayed}
        for pid in list(self.pics):
            if pid not in keep:
                del self.pics[pid]

    def _frame(self, f: Frame) -> torch.Tensor:
        pic, sps = self.pics[f.pid], self.sps_of[f.pid]
        x, y, w, h = crop_rect(sps)
        Y = pic.y[y:y + h, x:x + w].contiguous()
        U = pic.u[y // 2:(y + h + 1) // 2, x // 2:(x + w + 1) // 2].contiguous()
        V = pic.v[y // 2:(y + h + 1) // 2, x // 2:(x + w + 1) // 2].contiguous()
        return self.stages["colour"](Y, U, V, h, w, colour(sps))


# ------------------------------------------------------------------ the card's tables

#: columns of the parse kernel's slice table (``csrc/h264.cu``'s S_* order)
SLICE_FIELDS = ("offset", "bytes", "bit", "picture", "index", "first_mb", "slice_type", "cabac", "cabac_init_idc",
                "slice_qp", "nref0", "nref1", "t8_mode", "cip", "direct8", "chroma", "mb_width", "mb_height")
#: the parse kernel's status codes
PARSE_ERRORS = {1: "an invalid VLC or Exp-Golomb code", 2: "a value out of range", 3: "the slice's data ending early",
                5: "data after the slice's last macroblock"}
#: the per-slice record of the reconstruction and deblocking kernels (int32 words)
RECORD = 3056
R_SLOT, R_POC, R_LONG, R_PID, R_WEIGHTS, R_IMPLICIT, R_DSF, R_LS4, R_LS8 = 16, 80, 144, 208, 272, 656, 1680, 1712, 2288
NO_DSF = 1 << 20
#: scratch bytes per macroblock of the parse kernel
N_SCRATCH = 32
#: bytes after a batch's last slice, so the kernel's word loads of its last bytes stay inside
PAD = 8


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build ``csrc/h264.cu`` (at first use) and bind it."""
    lib = _build.load_library(_SOURCE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dspnet_h264_parse.argtypes = [vp, vp, i, vp, i, i, vp, vp, vp, i, vp, vp, vp]
    lib.dspnet_h264_recon_stage.argtypes = [i, vp, vp, vp, vp, vp, i, i, i, i, vp, vp, vp, i, i, vp, vp, vp, vp, vp,
                                            vp, vp, vp, vp]
    lib.dspnet_h264_deblock_stage.argtypes = [i, vp, vp, vp, vp, vp, i, i, i, vp, vp, vp, i, i, vp, vp, vp]
    for f in (lib.dspnet_h264_parse, lib.dspnet_h264_recon_stage, lib.dspnet_h264_deblock_stage,
              lib.dspnet_h264_tables_size, lib.dspnet_h264_record_size):
        f.restype = i
    return lib


#: bits the first level of a CAVLC lookup table is indexed by
VLC_FIRST_BITS = 8


def _vlc_codes() -> List[Tuple[np.ndarray, np.ndarray]]:
    """The CAVLC code tables as (lengths, codes), in ``csrc/h264.cu``'s V_*
    order: coeff_token by nC table (4), chroma DC coeff_token, total_zeros by
    TotalCoeff (15), chroma DC total_zeros (3), run_before by zerosLeft (7);
    a code's symbol is its index in the table."""
    from dspnet_torch.data import h264_tables as T

    return ([(T.COEFF_TOKEN_LEN[t].ravel(), T.COEFF_TOKEN_BITS[t].ravel()) for t in range(4)]
            + [(T.CDC_TOKEN_LEN.ravel(), T.CDC_TOKEN_BITS.ravel())]
            + [(T.TOTAL_ZEROS_LEN[k], T.TOTAL_ZEROS_BITS[k]) for k in range(15)]
            + [(T.CDC_TOTAL_ZEROS_LEN[k], T.CDC_TOTAL_ZEROS_BITS[k]) for k in range(3)]
            + [(T.RUN_LEN[k], T.RUN_BITS[k]) for k in range(7)])


@functools.cache
def vlc_tables() -> np.ndarray:
    """The CAVLC codes as the parse kernel's two-level lookup tables, one
    int32 region: [0] its size, [1 + k] where table k's first level starts,
    then the tables. A first level is indexed by the next 8 bits; an entry
    is ``symbol << 8 | length``, 0 where no code starts, or ``-(start << 4 |
    bits)`` for a second level at ``start`` indexed by the ``bits`` bits
    after the first 8. Raises on codes that are not prefix-free."""
    codes = _vlc_codes()
    out = [0] * (1 + len(codes))
    for k, (lens, bits) in enumerate(codes):
        first = [0] * (1 << VLC_FIRST_BITS)
        longer: Dict[int, list] = {}

        def fill(table, lo, span, entry):
            if any(table[lo:lo + span]):
                raise ValueError(f"CAVLC code table {k} is not prefix-free")
            table[lo:lo + span] = [entry] * span

        for sym, (n, code) in enumerate(zip(lens.tolist(), bits.tolist())):
            if not n:
                continue
            if n <= VLC_FIRST_BITS:
                shift = VLC_FIRST_BITS - n
                fill(first, code << shift, 1 << shift, sym << 8 | n)
            else:
                longer.setdefault(code >> (n - VLC_FIRST_BITS), []).append((n, code, sym))
        out[1 + k] = len(out)
        out += first
        for prefix, entries in sorted(longer.items()):
            if first[prefix]:
                raise ValueError(f"CAVLC code table {k} is not prefix-free")
            sub_bits = max(n for n, _, _ in entries) - VLC_FIRST_BITS
            second = [0] * (1 << sub_bits)
            for n, code, sym in entries:
                rest, shift = code & ((1 << (n - VLC_FIRST_BITS)) - 1), sub_bits - (n - VLC_FIRST_BITS)
                fill(second, rest << shift, 1 << shift, sym << 8 | n)
            out[out[1 + k] + prefix] = -(len(out) << 4 | sub_bits)
            out += second
    out[0] = len(out)
    return np.array(out, np.int32)


@functools.cache
def _host_tables() -> np.ndarray:
    """The parse, reconstruction and deblocking tables in ``csrc/h264.cu``'s
    O_* order, one int32 array, then the CAVLC lookup tables
    (:func:`vlc_tables`)."""
    from dspnet_torch.data import h264_tables as T

    parts = [T.CABAC_INIT.ravel(), T.RANGE_LPS.ravel(), T.TRANS_MPS, T.TRANS_LPS, np.append(T.SIG8x8, 0),
             np.append(T.LAST8x8, 0), T.COEFF_TOKEN_LEN.ravel(), T.COEFF_TOKEN_BITS.ravel(), T.CDC_TOKEN_LEN.ravel(),
             T.CDC_TOKEN_BITS.ravel(), T.TOTAL_ZEROS_LEN.ravel(), T.TOTAL_ZEROS_BITS.ravel(),
             T.CDC_TOTAL_ZEROS_LEN.ravel(), T.CDC_TOTAL_ZEROS_BITS.ravel(), T.RUN_LEN.ravel(), T.RUN_BITS.ravel(),
             T.CBP_INTRA, T.CBP_INTER, np.array(h264_parse._CBP_400[0] + h264_parse._CBP_400[1]), T.ZIGZAG4,
             T.ZIGZAG8, T.ALPHA, T.BETA, T.TC0.ravel(), T.CHROMA_QP, vlc_tables()]
    return np.concatenate([np.asarray(x, np.int64) for x in parts]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_host_tables()).to(device)


def _upload(arrays: List[np.ndarray], device: torch.device) -> List[torch.Tensor]:
    """Host arrays to ``device`` in one transfer (through pinned memory on
    the current stream for a card), as views of one buffer."""
    raw = [np.ascontiguousarray(a).view(np.uint8).ravel() for a in arrays]
    sizes = [len(r) for r in raw]
    pad = [(-s) % 8 for s in sizes]
    host = torch.from_numpy(np.concatenate([np.concatenate([r, np.zeros(p, np.uint8)]) for r, p in zip(raw, pad)]))
    if device.type == "cuda":
        pinned = torch.empty(host.shape, dtype=torch.uint8, pin_memory=True)
        pinned.copy_(host)
        buf = pinned.to(device, non_blocking=True)
    else:
        buf = host
    out, pos = [], 0
    for a, s, p in zip(arrays, sizes, pad):
        out.append(buf[pos:pos + s].view(torch.from_numpy(np.zeros(0, a.dtype)).dtype).view(a.shape))
        pos += s + p
    return out


def stage(jobs: List[Tuple[SliceJob, N.Syntax]], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every slice's RBSP back to back and the slice table
    (:data:`SLICE_FIELDS`) on ``device``, in one transfer."""
    rows, pos, blobs = [], 0, []
    for job, sps in jobs:
        h = job.h
        rows.append((pos, len(job.rbsp), job.pos, job.picture, job.index, h.first_mb, h.slice_type,
                     int(h.pps.entropy_coding_mode_flag), h.cabac_init_idc, h.slice_qp, h.num_ref_idx[0],
                     h.num_ref_idx[1], int(h.pps.transform_8x8_mode_flag), int(h.pps.constrained_intra_pred_flag),
                     int(sps.direct_8x8_inference_flag), int(sps.chroma_format_idc != 0), sps.mb_width, sps.mb_height))
        blobs.append(job.rbsp)
        pos += len(job.rbsp)
    table = np.array(rows, np.int32).reshape(-1, len(SLICE_FIELDS))
    bits = np.frombuffer(b"".join(blobs) + bytes(PAD), np.uint8)
    b, t = _upload([bits, table], torch.device(device))
    return b, t


def slice_records(slices: List[SliceInfo], slot_of: Dict[int, int], poc: int) -> np.ndarray:
    """Each slice's record for the reconstruction and deblocking kernels."""
    out = np.zeros((len(slices), RECORD), np.int32)
    for k, s in enumerate(slices):
        r = out[k]
        r[:14] = (s.slice_type, s.direct_spatial, s.weighted, s.luma_denom, s.chroma_denom, s.cip, s.direct8,
                  s.chroma_offsets[0], s.chroma_offsets[1], s.deblock[0], s.deblock[1], s.deblock[2],
                  len(s.ref_ids[0]), len(s.ref_ids[1]))
        for lx in range(2):
            for i, pid in enumerate(s.ref_ids[lx]):
                r[R_SLOT + 32 * lx + i] = slot_of.get(pid, 0)
                r[R_POC + 32 * lx + i] = s.ref_pocs[lx][i]
                r[R_LONG + 32 * lx + i] = s.ref_long[lx][i]
                r[R_PID + 32 * lx + i] = pid
            for i, w in enumerate(s.weights[lx]):
                r[R_WEIGHTS + 192 * lx + 6 * i:R_WEIGHTS + 192 * lx + 6 * i + 6] = w
        for i in range(len(s.ref_ids[0])):
            for j in range(len(s.ref_ids[1])):
                r[R_IMPLICIT + 32 * i + j] = h264_recon.implicit_weight(s, i, j, poc)
            if s.ref_ids[1]:
                td = max(-128, min(127, s.ref_pocs[1][0] - s.ref_pocs[0][i]))
                if td == 0 or s.ref_long[0][i]:
                    r[R_DSF + i] = NO_DSF
                else:
                    tb = max(-128, min(127, poc - s.ref_pocs[0][i]))
                    tx = h264_recon.cdiv(16384 + abs(h264_recon.cdiv(td, 2)), td)
                    r[R_DSF + i] = max(-1024, min(1023, (tb * tx + 32) >> 6))
        r[R_LS4:R_LS4 + 576] = h264_recon.level_scale4(s.lists4).ravel()
        r[R_LS8:R_LS8 + 768] = h264_recon.level_scale8(s.lists8).ravel()
    return out


# ------------------------------------------------------------------ the stages


def parse_ref(jobs: List[Tuple[SliceJob, N.Syntax]], n_pictures: int, device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The plain parse of every slice of a batch -> per picture (table
    (n_mb, N_FIELDS) int32, levels (n_mb, 408) int16)."""
    plain_calls["h264_parse"] += 1
    pics: Dict[int, h264_parse.Picture] = {}
    for job, sps in jobs:
        pic = pics.setdefault(job.picture, h264_parse.Picture(sps.mb_width, sps.mb_height))
        h264_parse.parse_slice(job.rbsp, job.pos, job.h, pic, job.index)
    out = []
    for k in range(n_pictures):
        pic = pics[k]
        missing = [i for i, s in enumerate(pic.slice_of) if s < 0]
        if missing:
            raise N.H264Error(f"picture {k} of the batch: {len(missing)} macroblocks no slice codes (first "
                              f"{missing[0]}): FFmpeg conceals them")
        out.append((torch.from_numpy(pic.table).to(device), torch.from_numpy(pic.levels).to(device)))
    return out


def parse_launches(jobs, n_pictures: int, device, steps: Optional[torch.Tensor] = None):
    """The outputs of a batch's parse on a CUDA device and its kernel's
    launch: ((table (n_pictures, n_mb, N_FIELDS) int32, levels int16,
    scratch (n_pictures, n_mb, N_SCRATCH) uint8, status (slices, 2) int32),
    [(kernel name, launch)]). Nothing runs until the launch is called
    (:func:`parse` calls it; ``chip_smoke.py`` also times it). ``steps``, an
    int32 a slice, takes each slice's chain steps (CABAC bins, or CAVLC
    codes)."""
    device = torch.device(device)
    bits, table = stage(jobs, device)
    n = max(s.mb_width * s.mb_height for _, s in jobs)
    tab = torch.zeros(n_pictures, n, h264_parse.N_FIELDS, dtype=torch.int32, device=device)
    lev = torch.zeros(n_pictures, n, h264_parse.N_LEVELS, dtype=torch.int16, device=device)
    scratch = torch.zeros(n_pictures, n, N_SCRATCH, dtype=torch.uint8, device=device)
    status = torch.zeros(len(jobs), 2, dtype=torch.int32, device=device)
    lib = load_library()
    args = (bits.data_ptr(), table.data_ptr(), len(jobs), _tables(device).data_ptr(), len(vlc_tables()),
            max(s.mb_width for _, s in jobs), tab.data_ptr(), lev.data_ptr(), scratch.data_ptr(), n,
            status.data_ptr(), None if steps is None else steps.data_ptr(), _stream(device))

    def launch(kept=(bits, table)):
        err = lib.dspnet_h264_parse(*args)
        kernel_launches["h264_parse_kernel"] += 1
        _build.check(lib, err, "h264_parse_kernel")

    return (tab, lev, scratch, status), [("h264_parse_kernel", launch)]


def parse(jobs, n_pictures: int, device):
    """``h264_parse_kernel`` on a CUDA device (one launch, a warp per slice),
    :func:`parse_ref` on the CPU. Raises when a slice fails to parse, naming
    it and the bit, and when the launch is refused (a picture too wide for
    the kernel's shared memory)."""
    device = torch.device(device)
    if not _on_card(torch.empty(0, device=device)):
        return parse_ref(jobs, n_pictures, device)
    (tab, lev, scratch, status), kernels = parse_launches(jobs, n_pictures, device)
    for _, launch in kernels:
        launch()
    launches["h264_parse"] += 1
    st = status.cpu().numpy()
    for (job, _), (code, bit) in zip(jobs, st.tolist()):
        if code:
            raise N.H264Error(f"picture {job.picture} of the batch, slice {job.index} (first_mb {job.h.first_mb}): "
                              f"{PARSE_ERRORS.get(code, code)} (bit {bit})")
    coded = scratch[:, :, N_SCRATCH - 1].cpu().numpy()
    out = []
    for k in range(n_pictures):
        m = next(s.mb_width * s.mb_height for j, s in jobs if j.picture == k)
        if not coded[k, :m].all():
            missing = np.flatnonzero(coded[k, :m] == 0)
            raise N.H264Error(f"picture {k} of the batch: {len(missing)} macroblocks no slice codes (first "
                              f"{missing[0]}): FFmpeg conceals them")
        out.append((tab[k], lev[k]))
    return out


def recon_ref(table, levels, slices, sps, refs: Dict[int, RefPicture], col, poc: int):
    """The plain reconstruction of one picture -> (Y, U, V, motion field)."""
    plain_calls["h264_recon"] += 1
    host_refs = {pid: RefPicture(r.pid, r.poc, _np(r.y), _np(r.u), _np(r.v), _np(r.mv), _np(r.ref), _np(r.ref_id),
                                 r.long_term) for pid, r in refs.items()}
    host_col = host_refs.get(col.pid) if col is not None and col.pid in host_refs else (
        None if col is None else RefPicture(col.pid, col.poc, None, None, None, _np(col.mv), _np(col.ref),
                                            _np(col.ref_id), col.long_term))
    y, u, v, mf = h264_recon.recon_picture(_np(table), _np(levels), slices, sps.mb_width, sps.mb_height, host_refs,
                                           host_col, poc, sps.chroma_format_idc != 0)
    dev = table.device
    mf.mv, mf.ref, mf.ref_id = (torch.from_numpy(a).to(dev) for a in (mf.mv, mf.ref, mf.ref_id))
    return (torch.from_numpy(y).to(dev), None if u is None else torch.from_numpy(u).to(dev),
            None if v is None else torch.from_numpy(v).to(dev), mf)


class CardMotion:
    """A picture's motion field on the card: (2, H4, W4, 2) vectors, (2, H4,
    W4) reference indices and reference picture ids, int32."""

    def __init__(self, mv, ref, ref_id, records):
        self.mv, self.ref, self.ref_id, self.records = mv, ref, ref_id, records


#: int32 words of residual a macroblock (luma 16x16, then Cb and Cr 8x8)
N_RES = 384
#: bytes a macroblock that h264_bs_kernel hands h264_filter_kernel (bS, the filter's indices)
DB_BYTES = 80


def _kernel(lib, entry, stage: int, name: str, args, tensors):
    """One launch of kernel ``name`` through ``entry(stage, *args)``, counted;
    ``tensors``, whose pointers ``args`` holds, live as long as the launch."""

    def launch(tensors=tensors):
        err = entry(stage, *args)
        kernel_launches[name] += 1
        _build.check(lib, err, name)

    return name, launch


def recon_launches(table, levels, slices, sps, refs, col, poc):
    """The outputs of one picture's reconstruction on a CUDA device and its
    kernels' launches, in order: ((Y, U, V, motion field), [(kernel name,
    launch)]). Nothing runs until each launch is called (:func:`recon` calls
    them; ``chip_smoke.py`` also times each)."""
    dev = table.device
    mbw, mbh = sps.mb_width, sps.mb_height
    chroma = sps.chroma_format_idc != 0
    ids = sorted(refs)
    slot_of = {pid: k for k, pid in enumerate(ids)}
    ptrs = np.array([[refs[p].y.data_ptr(), refs[p].u.data_ptr() if chroma else 0,
                      refs[p].v.data_ptr() if chroma else 0] for p in ids] or [[0, 0, 0]], np.int64)
    rec, refptr = _upload([slice_records(slices, slot_of, poc), ptrs], dev)
    y = torch.empty(16 * mbh, 16 * mbw, dtype=torch.uint8, device=dev)
    u = torch.empty(8 * mbh, 8 * mbw, dtype=torch.uint8, device=dev) if chroma else None
    v = torch.empty(8 * mbh, 8 * mbw, dtype=torch.uint8, device=dev) if chroma else None
    mv = torch.zeros(2, 4 * mbh, 4 * mbw, 2, dtype=torch.int32, device=dev)
    ref = torch.full((2, 4 * mbh, 4 * mbw), -1, dtype=torch.int32, device=dev)
    rid = torch.full((2, 4 * mbh, 4 * mbw), -1, dtype=torch.int32, device=dev)
    n = mbw * mbh
    tab, lev = table[:n].contiguous(), levels[:n].contiguous()
    res = torch.empty(n, N_RES, dtype=torch.int32, device=dev)
    sync = torch.empty(1 + mbh, dtype=torch.int32, device=dev)
    cm = (col.mv.data_ptr(), col.ref.data_ptr(), col.ref_id.data_ptr()) if col is not None else (0, 0, 0)
    lib = load_library()
    args = (tab.data_ptr(), lev.data_ptr(), rec.data_ptr(), refptr.data_ptr(), _tables(dev).data_ptr(), mbw, mbh,
            int(chroma), poc, y.data_ptr(), u.data_ptr() if chroma else 0, v.data_ptr() if chroma else 0, 16 * mbw,
            8 * mbw, mv.data_ptr(), ref.data_ptr(), rid.data_ptr(), *cm, res.data_ptr(), sync.data_ptr(),
            _stream(dev))
    kept = (rec, refptr, refs, tab, lev, res, sync, col, y, u, v, mv, ref, rid)
    kernels = [_kernel(lib, lib.dspnet_h264_recon_stage, k, name, args, kept)
               for k, name in enumerate(KERNELS["h264_recon"])]
    return (y, u, v, CardMotion(mv, ref, rid, (rec, refptr, refs))), kernels


def recon(table, levels, slices, sps, refs, col, poc):
    """The reconstruction of one picture on a CUDA device (its three kernels,
    :data:`KERNELS`), :func:`recon_ref` on the CPU -> (Y, U, V uint8
    planes, motion field)."""
    if not _on_card(table):
        return recon_ref(table, levels, slices, sps, refs, col, poc)
    out, kernels = recon_launches(table, levels, slices, sps, refs, col, poc)
    for _, launch in kernels:
        launch()
    launches["h264_recon"] += 1
    return out


def deblock_ref(y, u, v, table, mf, slices, sps):
    """The plain deblocking filter of one picture, in place."""
    plain_calls["h264_deblock"] += 1
    Y, U, V = _np(y), _np(u), _np(v)
    h264_filters.deblock_picture(Y, U, V, _np(table), _np(mf.mv), _np(mf.ref_id), slices, sps.mb_width,
                                 sps.mb_height)
    for dst, src in ((y, Y), (u, U), (v, V)):
        if dst is not None:
            dst.copy_(torch.from_numpy(src))


def deblock_launches(y, u, v, table, mf, slices, sps):
    """The launches of one picture's deblocking filter on a CUDA device, in
    order: [(kernel name, launch)], in place on the planes; ``mf`` the
    :class:`CardMotion` :func:`recon` returned, whose slice records it reads."""
    dev = y.device
    mbw, mbh = sps.mb_width, sps.mb_height
    chroma = u is not None
    tab = table[:mbw * mbh].contiguous()
    bs = torch.empty(mbw * mbh, DB_BYTES, dtype=torch.uint8, device=dev)
    sync = torch.empty(1 + mbh, dtype=torch.int32, device=dev)
    lib = load_library()
    args = (tab.data_ptr(), mf.records[0].data_ptr(), mf.mv.data_ptr(), mf.ref_id.data_ptr(), _tables(dev).data_ptr(),
            mbw, mbh, int(chroma), y.data_ptr(), u.data_ptr() if chroma else 0, v.data_ptr() if chroma else 0,
            16 * mbw, 8 * mbw, bs.data_ptr(), sync.data_ptr(), _stream(dev))
    kept = (tab, bs, sync, mf, y, u, v)
    return [_kernel(lib, lib.dspnet_h264_deblock_stage, k, name, args, kept)
            for k, name in enumerate(KERNELS["h264_deblock"])]


def deblock(y, u, v, table, mf, slices, sps):
    """The deblocking filter of one picture on a CUDA device (its two
    kernels, :data:`KERNELS`, in place), :func:`deblock_ref` on the CPU."""
    if not _on_card(y):
        return deblock_ref(y, u, v, table, mf, slices, sps)
    for _, launch in deblock_launches(y, u, v, table, mf, slices, sps):
        launch()
    launches["h264_deblock"] += 1


def _np(t):
    if t is None:
        return None
    if isinstance(t, np.ndarray):
        return t
    return t.cpu().numpy()
