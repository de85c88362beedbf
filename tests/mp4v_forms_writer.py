"""A per-symbol MPEG-4 Part 2 writer for the test forms that cv2's writer
cannot make here: 4MV, resync markers and video packets (with
``header_extension_code``), MPEG quantisation with loaded or default
matrices, DQUANT, intra macroblocks with AC prediction inside P-VOPs,
``intra_dc_vlc_thr``, ``vop_coded`` = 0, every TCOEF code and escape, and
the refused tools' headers.

It writes the syntax ``dspnet_torch/data/mpeg4.py`` reads, with the port's
tables and its prediction state (``mpeg4.VopState``): each VOP is planned
per macroblock (mode, DQUANT, motion vectors, AC prediction, or levels
given outright), quantised, predicted and written, then decoded by the
port's plain decoder to give the next VOP's reference. The fixture script
(``tests/make_mp4v_fixtures.py``) writes each form into an MP4 and records
what cv2 decodes of it; that is the reference, whatever this writer meant.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dspnet_torch.data import mpeg4
from dspnet_torch.data.mpeg4 import BitWriter


def vol_bits(width: int, height: int, *, resync: bool = False, mpeg_quant: bool = False, intra_matrix=None,
             inter_matrix=None, ver_id: int = 1, shape: int = 0, interlaced: bool = False, sprite: int = 0,
             not_8_bit: bool = False, quarter: bool = False, complexity: bool = False,
             partitioned: bool = False, rvlc: bool = False, scalability: bool = False,
             user_data: bytes = b"") -> bytes:
    """VOS, VO and VOL headers with every flag the refusals name."""
    w = BitWriter()
    w.put(0x1B0, 32).put(1, 8)
    w.put(0x1B5, 32).put(1, 1).put(ver_id, 4).put(1, 3).put(1, 4).put(0, 1).stuff()
    w.put(0x100, 32)
    w.put(0x120, 32).put(0, 1).put(1, 8).put(1, 1).put(ver_id, 4).put(1, 3).put(1, 4)
    w.put(1, 1).put(1, 2).put(1, 1).put(0, 1)
    w.put(shape, 2)
    if shape:
        return w.put(0x7F, 7).stuff().bytes()
    w.put(1, 1).put(mpeg4.TIME_RESOLUTION, 16).put(1, 1).put(0, 1)
    w.put(1, 1).put(width, 13).put(1, 1).put(height, 13).put(1, 1)
    w.put(int(interlaced), 1).put(1, 1)
    w.put(sprite, 1 if ver_id == 1 else 2)
    w.put(int(not_8_bit), 1)
    if not_8_bit:
        w.put(4, 4).put(12, 4)
    w.put(int(mpeg_quant), 1)
    if mpeg_quant:
        for matrix in (intra_matrix, inter_matrix):
            w.put(int(matrix is not None), 1)
            if matrix is not None:
                for i in range(64):
                    w.put(matrix[mpeg4.ZIGZAG[i]], 8)
    if ver_id != 1:
        w.put(int(quarter), 1)
    w.put(int(not complexity), 1)
    w.put(int(not resync), 1).put(int(partitioned), 1)
    if partitioned:
        w.put(int(rvlc), 1)
    if ver_id != 1:
        w.put(0, 1).put(0, 1)
    w.put(int(scalability), 1).stuff()
    out = w.bytes()
    if user_data:
        out += b"\x00\x00\x01\xb2" + user_data
    return out


@dataclass
class Mb:
    """One macroblock's plan."""

    mode: int = mpeg4.MODE_INTER
    mvs: Sequence[Tuple[int, int]] = ((0, 0),) * 4
    dquant: Optional[int] = None  # DQUANT's 2-bit code
    ac_pred: int = 0
    #: (6, 64) raster levels given outright (quantisation skipped)
    levels: Optional[np.ndarray] = None


def vop_bits(kind: str, frame: int, qp: int, coded: bool = True, rounding: int = 0, fcode: int = 1,
             dc_threshold: int = 0) -> BitWriter:
    """A VOP header with every field the forms set."""
    w = mpeg4.vop_start(kind, frame).put(int(coded), 1)
    if not coded:
        return w
    if kind == "P":
        w.put(rounding, 1)
    w.put(dc_threshold, 3).put(qp, 5)
    if kind == "P":
        w.put(fcode, 3)
    return w


def _put_vlc(w: BitWriter, table, index: int) -> None:
    code, n = table[index]
    w.put(code, n)


def put_tcoef(w: BitWriter, last: int, run: int, level: int, intra: bool) -> None:
    """One TCOEF symbol: its VLC and sign, else escape 1, 2 or 3."""
    vlc = mpeg4.INTRA_VLC if intra else mpeg4.INTER_VLC
    rll = mpeg4.INTRA_RLL if intra else mpeg4.INTER_RLL
    lmax, rmax = (mpeg4.INTRA_LMAX, mpeg4.INTRA_RMAX) if intra else (mpeg4.INTER_LMAX, mpeg4.INTER_RMAX)
    index = {t: k for k, t in enumerate(rll)}
    mag, sign = abs(level), int(level < 0)
    if (last, run, mag) in index:
        _put_vlc(w, vlc, index[(last, run, mag)])
        w.put(sign, 1)
        return
    lm = int(lmax[last, run]) if run < 64 else 0
    if lm and (last, run, mag - lm) in index:
        w.put(3, 7).put(0, 1)
        _put_vlc(w, vlc, index[(last, run, mag - lm)])
        w.put(sign, 1)
        return
    if mag < 64 and lmax[last, 0] >= mag:
        r2 = run - int(rmax[last, mag]) - 1
        if r2 >= 0 and (last, r2, mag) in index:
            w.put(3, 7).put(2, 2)
            _put_vlc(w, vlc, index[(last, r2, mag)])
            w.put(sign, 1)
            return
    w.put(3, 7).put(3, 2).put(last, 1).put(run, 6).put(1, 1).put(level & 0xFFF, 12).put(1, 1)


def put_mv(w: BitWriter, val: int, fcode: int) -> None:
    """A motion vector difference (``ff_h263_encode_motion``)."""
    if val == 0:
        w.put(1, 1)
        return
    bits = fcode - 1
    val = mpeg4._sext(val, 6 + bits)
    sign = int(val < 0)
    val = abs(val) - 1
    code = (val >> bits) + 1
    _put_vlc(w, mpeg4.MVTAB, code)
    w.put(sign, 1)
    if bits:
        w.put(val & ((1 << bits) - 1), bits)


def _quantise(coef: np.ndarray, qp: int, intra: bool, blk: int, vol: mpeg4.Vol) -> np.ndarray:
    """(64,) raster coefficients -> levels the decoder's dequantisation
    inverts (H.263 or MPEG; the intra DC by ``dc_scaler``)."""
    mag = np.abs(coef)
    if vol.mpeg_quant:
        wm = np.array(vol.intra_matrix if intra else vol.inter_matrix)
        lv = (mag * 8 + wm * qp // 2) // (wm * qp) if intra else np.maximum((mag * 8 // (wm * qp) - 1) // 2, 0)
    else:
        lv = (mag + qp // 2) // (2 * qp) if intra else np.maximum(mag - qp, 0) // (2 * qp)
    lv = np.where(coef < 0, -lv, lv).clip(-2047, 2047)
    if intra:
        scale = mpeg4.Y_DC_SCALE[qp] if blk < 4 else mpeg4.C_DC_SCALE[qp]
        lv[0] = (coef[0] + scale // 2) // scale
    return lv


@dataclass
class FormWriter:
    """Writes one stream (see the module's text)."""

    width: int
    height: int
    resync_every: int = 0
    hec: bool = False
    mpeg_quant: bool = False
    intra_matrix: Optional[List[int]] = None
    inter_matrix: Optional[List[int]] = None
    dc_threshold: int = 0
    frames: int = 0
    ref: Optional[tuple] = None
    config: bytes = b""
    vol: mpeg4.Vol = field(default_factory=mpeg4.Vol)

    def __post_init__(self):
        self.config = vol_bits(self.width, self.height, resync=bool(self.resync_every), mpeg_quant=self.mpeg_quant,
                               intra_matrix=self.intra_matrix, inter_matrix=self.inter_matrix)
        self.vol = mpeg4.parse_config(self.config)

    def skipped_vop(self, kind: str = "P") -> bytes:
        """A VOP with ``vop_coded`` 0."""
        w = vop_bits(kind, self.frames, 1, coded=False)
        self.frames += 1
        return w.stuff().bytes()

    def vop(self, frame: np.ndarray, kind: str, qp: int, plan: Optional[Dict[int, Mb]] = None, fcode: int = 1,
            rounding: int = 0, packet_qp: Optional[Dict[int, int]] = None) -> bytes:
        """One coded VOP of ``frame`` ((H, W, 3) uint8 BGR): every
        macroblock intra in an I-VOP; in a P-VOP as ``plan`` says (default:
        inter with zero MVs, skipped where nothing is coded)."""
        vol = self.vol
        mbw, mbh, n = vol.mb_width, vol.mb_height, vol.mb_num
        plan = dict(plan or {})
        if kind == "I":
            plan = {i: Mb(mpeg4.MODE_INTRA, dquant=plan[i].dquant if i in plan else None,
                          ac_pred=plan[i].ac_pred if i in plan else 0,
                          levels=plan[i].levels if i in plan else None) for i in range(n)}
        mbs = [plan.get(i, Mb()) for i in range(n)]
        y, u, v = (p.numpy() for p in mpeg4.bgr_to_yuv420(torch.from_numpy(frame), mbh, mbw))
        cur = mpeg4._mb_blocks(*(torch.from_numpy(p) for p in (y, u, v))).numpy()
        table = np.zeros((n, 12), np.int32)
        for i, m in enumerate(mbs):
            table[i, 0] = m.mode
            table[i, 4:12] = [c for mv in m.mvs for c in mv]
        pred = np.zeros_like(cur)
        if kind == "P":
            pred = mpeg4._mb_blocks(*(torch.from_numpy(p.astype(np.int64))
                                      for p in mpeg4.predict(table, self.ref, vol, rounding))).numpy()
        hdr = mpeg4.VopHeader(kind, True, rounding, mpeg4.DC_THRESHOLD[self.dc_threshold], qp, fcode, 0, 0)
        st = mpeg4.VopState(vol, hdr)
        w = vop_bits(kind, self.frames, qp, rounding=rounding, fcode=fcode, dc_threshold=self.dc_threshold)
        self.frames += 1
        for index, m in enumerate(mbs):
            yy, xx = divmod(index, mbw)
            if index and self.resync_every and index % self.resync_every == 0:
                w.stuff().put(1, mpeg4.resync_zeros(kind, fcode) + 1)
                w.put(index, max(1, (n - 1).bit_length()))
                q = (packet_qp or {}).get(index, 0)
                w.put(q, 5)
                if q:
                    st.qp = q
                w.put(int(self.hec), 1)
                if self.hec:
                    w.put(0, 1).put(1, 1).put(self.frames - 1, vol.time_bits).put(1, 1).put("IP".index(kind), 2)
                    w.put(self.dc_threshold, 3)
                    if kind != "I":
                        w.put(fcode, 3)
                st.start_packet(yy, xx)
            st.begin_mb(yy, xx)
            intra = m.mode == mpeg4.MODE_INTRA
            use_dc_vlc = intra and st.qp < hdr.dc_threshold
            if m.dquant is not None:
                st.set_quant(m.dquant)
            qp_mb = st.qp
            if m.levels is not None:
                levels = np.array(m.levels, np.int64).reshape(6, 64)
            else:
                src = cur[index] if intra else cur[index] - pred[index]
                coef = mpeg4.fdct(torch.from_numpy(src)).numpy().reshape(6, 64)
                levels = np.stack([_quantise(coef[b], qp_mb, intra, b, vol) for b in range(6)])
            # the blocks' coded symbols, the prediction state updated as the
            # decoder will update it
            coded_blocks = []
            if intra:
                st.ac_pred = m.ac_pred
                for blk in range(6):
                    target = [int(t) for t in levels[blk]]
                    predq, direction = st.dc_prediction(yy, xx, blk)
                    diff = target[0] - predq
                    st.pred_dc(yy, xx, blk, diff)
                    coded = list(target)
                    coded[0] = diff
                    if m.ac_pred:
                        for p, val in st.ac_prediction(yy, xx, blk, direction):
                            coded[p] -= val
                    st.store_ac(yy, xx, blk, target)
                    scan = (mpeg4.ALT_VERTICAL if direction == 0 else mpeg4.ALT_HORIZONTAL) if m.ac_pred \
                        else mpeg4.ZIGZAG
                    coded_blocks.append((coded, scan))
                st.set_mvs(yy, xx, [(0, 0)] * 4)
            else:
                st.ac_pred = 0
                st.clear_intra(yy, xx)
                coded_blocks = [([int(t) for t in levels[blk]], mpeg4.ZIGZAG) for blk in range(6)]
            first = 0 if use_dc_vlc else -1
            cbp = 0
            for blk, (coded, scan) in enumerate(coded_blocks):
                start = 1 if use_dc_vlc else 0
                if any(coded[scan[i]] for i in range(start, 64)):
                    cbp |= 32 >> blk
            st.qtab[index] = qp_mb
            if kind == "P" and not intra and m.mode == mpeg4.MODE_INTER and cbp == 0 and m.dquant is None \
                    and tuple(m.mvs[0]) == (0, 0):
                w.put(1, 1)  # not_coded
                st.set_mvs(yy, xx, [(0, 0)] * 4)
                continue
            dq = m.dquant is not None
            if kind == "P":
                w.put(0, 1)
                mode_row = {mpeg4.MODE_INTER: 2 if dq else 0, mpeg4.MODE_INTRA: 3 if dq else 1,
                            mpeg4.MODE_INTER4V: 4}[m.mode]
                if m.mode == mpeg4.MODE_INTER4V and dq:
                    raise ValueError("inter4V with DQUANT is not in Simple Profile's MCBPC table")
                _put_vlc(w, mpeg4.INTER_MCBPC, mode_row * 4 + (cbp & 3))
            else:
                _put_vlc(w, mpeg4.INTRA_MCBPC, (4 if dq else 0) + (cbp & 3))
            if intra:
                w.put(m.ac_pred, 1)
                _put_vlc(w, mpeg4.CBPY, cbp >> 2)
            else:
                _put_vlc(w, mpeg4.CBPY, (cbp >> 2) ^ 15)
            if dq:
                w.put(m.dquant, 2)
            if m.mode == mpeg4.MODE_INTER:
                px, py = st.pred_mv(yy, xx, 0)
                put_mv(w, m.mvs[0][0] - px, fcode)
                put_mv(w, m.mvs[0][1] - py, fcode)
                st.set_mvs(yy, xx, [m.mvs[0]] * 4)
            elif m.mode == mpeg4.MODE_INTER4V:
                for blk in range(4):
                    px, py = st.pred_mv(yy, xx, blk)
                    put_mv(w, m.mvs[blk][0] - px, fcode)
                    put_mv(w, m.mvs[blk][1] - py, fcode)
                    st.mv[st.mv_index(yy, xx, blk)] = list(m.mvs[blk])
            for blk, (coded, scan) in enumerate(coded_blocks):
                if intra and use_dc_vlc:
                    diff = coded[0]
                    size = abs(diff).bit_length()
                    _put_vlc(w, mpeg4.DC_LUM if blk < 4 else mpeg4.DC_CHROM, size)
                    if size:
                        w.put(diff if diff > 0 else diff + (1 << size) - 1, size)
                        if size > 8:
                            w.put(1, 1)
                if not cbp & (32 >> blk):
                    continue
                pos = [i for i in range(first + 1, 64) if coded[scan[i]]]
                prev = first
                for k, i in enumerate(pos):
                    put_tcoef(w, int(k == len(pos) - 1), i - prev - 1, coded[scan[i]], intra)
                    prev = i
        data = w.stuff().bytes()
        # the reference the decoder rebuilds
        h = mpeg4.read_vop_header(data, self.vol)
        mb, lv = mpeg4.parse_vop(data, self.vol, h)
        self.ref = mpeg4.recon_vop(mb, lv, self.vol, h.rounding, self.ref if kind == "P" else None)
        return data
