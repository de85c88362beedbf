"""The plain H.264 slice-data parse (ITU-T H.264 7.3.4-7.3.5, 9.2 CAVLC and
9.3 CABAC): a slice's bits -> the macroblock table and coefficient levels
the reconstruction reads. It needs no pixels and no motion vectors, so the
slices of a batch parse independently (the card's ``h264_parse_kernel`` in
``csrc/h264.cu`` runs one slice a thread and writes the same tables).

Per macroblock, :data:`MB_FIELDS` int32 columns: the slice it belongs to,
its type (:data:`T_I4` ... :data:`T_BDIRECT`), partition shape, prediction
lists, sub-macroblock types, ``transform_size_8x8_flag``, coded block
pattern, QP_Y, the 16x16 and chroma intra modes, a bit per 4x4 luma block
with coefficients (8x8 blocks set four), the reference indices per 8x8
block and list, the sixteen intra 4x4 / 8x8 modes (4 bits each, derived
from the neighbours as 8.3.1.1 says), and each 4x4 block's motion vector
differences per list (values, not predictions). Per macroblock 408 int16
levels, not dequantised, at raster positions: 16 luma 4x4 blocks (or four
8x8 blocks) of 16 (64), the Intra16x16 DC matrix, chroma DC (Cb, Cr) and
chroma AC (Cb then Cr, four blocks of 16).

:class:`SliceWalker` states the syntax once for reading and writing: each
element's routine takes the value to write (None when reading) and returns
the value read or written; the entropy coder (:class:`CabacReader` in this module,
the CABAC and CAVLC writers in ``tests/h264_writer.py``) does the bits.
Writing, a ``chooser`` supplies every macroblock's decisions.

A stream FFmpeg would conceal raises naming the slice, the macroblock and
the bit: a slice's data ending early, an invalid VLC code, a value out of
range, or data after the slice's last macroblock.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from dspnet_torch.data import h264_tables as T
from dspnet_torch.data.h264_nal import I, P, BitReader, H264Error

# ---- the macroblock table
MB_FIELDS = ("slice", "type", "part", "pred", "sub", "t8", "cbp", "qp", "i16", "cpred", "nz", "ref0", "ref1",
             "imode0", "imode1") + tuple(f"mvd{lx}_{b}_{c}" for lx in range(2) for b in range(16) for c in "xy")
F_SLICE, F_TYPE, F_PART, F_PRED, F_SUB, F_T8, F_CBP, F_QP, F_I16, F_CPRED, F_NZ, F_REF0, F_REF1, F_IM0, F_IM1 = \
    range(15)
F_MVD = 15
N_FIELDS = len(MB_FIELDS)
#: macroblock types
T_I4, T_I8, T_I16, T_PCM, T_INTER, T_PSKIP, T_BSKIP, T_BDIRECT = range(8)
#: partition shapes of T_INTER: 16x16, 16x8, 8x16, 8x8
PART_16x16, PART_16x8, PART_8x16, PART_8x8 = range(4)
#: a sub-macroblock code: bits 0-1 shape (8x8, 8x4, 4x8, 4x4), 2-3 lists (1 L0, 2 L1), 4 direct
SUB_DIRECT = 16
#: levels per macroblock and their offsets
N_LEVELS = 408
L_DC, L_CDC, L_CAC = 256, 272, 280

#: 4x4 block index -> position (in 4x4 units) and back
BLK_X = [(b & 1) | ((b >> 1) & 2) for b in range(16)]
BLK_Y = [((b >> 1) & 1) | ((b >> 2) & 2) for b in range(16)]
BLK_AT = [[0] * 4 for _ in range(4)]
for _b in range(16):
    BLK_AT[BLK_Y[_b]][BLK_X[_b]] = _b

# B mb_type 1..21: (partition, list flags of partition 0 and 1)
_B_PAIRS = [(1, 1), (2, 2), (1, 2), (2, 1), (1, 3), (2, 3), (3, 1), (3, 2), (3, 3)]
B_TYPES = {1: (PART_16x16, 1, 0), 2: (PART_16x16, 2, 0), 3: (PART_16x16, 3, 0)}
for _k in range(18):
    B_TYPES[4 + _k] = (PART_16x8 if _k % 2 == 0 else PART_8x16,) + _B_PAIRS[_k // 2]
P_TYPES = {0: (PART_16x16, 1, 0), 1: (PART_16x8, 1, 1), 2: (PART_8x16, 1, 1)}
#: B sub_mb_type -> sub code
B_SUBS = [SUB_DIRECT, 4, 8, 12, 1 | 4, 2 | 4, 1 | 8, 2 | 8, 1 | 12, 2 | 12, 3 | 4, 3 | 8, 3 | 12]
#: sub shape -> number of sub-partitions
SUB_PARTS = [1, 2, 2, 4]


def sub_blocks(k: int, shape: int, j: int) -> List[int]:
    """The 4x4 blocks of sub-partition ``j`` of 8x8 block ``k``."""
    base = 4 * k
    if shape == 0:
        return [base, base + 1, base + 2, base + 3]
    if shape == 1:
        return [base + 2 * j, base + 2 * j + 1]
    if shape == 2:
        return [base + j, base + j + 2]
    return [base + j]


def part_blocks(part: int, j: int) -> List[int]:
    """The 4x4 blocks of partition ``j`` of a 16x16 / 16x8 / 8x16 macroblock."""
    if part == PART_16x16:
        return list(range(16))
    if part == PART_16x8:
        return list(range(8 * j, 8 * j + 8))
    return [b for k in (j, j + 2) for b in range(4 * k, 4 * k + 4)]


class CabacReader:
    """The CABAC arithmetic decoding engine (9.3.1.2, 9.3.3.2) over an RBSP
    from bit ``pos`` (byte-aligned), with its 1024 context states
    (2 * pStateIdx + valMPS)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.end = data, len(data) * 8
        self.state = [0] * 1024
        self.start(pos)

    def start(self, pos: int):
        self.pos = pos
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._bit()

    def _bit(self) -> int:
        pos = self.pos
        self.pos = pos + 1
        if pos >= self.end:
            if pos >= self.end + 16:
                raise H264Error(f"the CABAC data run past the slice's end (bit {self.end})")
            return 0
        return (self.data[pos >> 3] >> (7 - (pos & 7))) & 1

    def init_contexts(self, slice_type: int, idc: int, qp: int):
        table = T.CABAC_INIT[3 if slice_type == I else idc]
        qp = min(max(qp, 0), 51)
        st = self.state
        for i in range(1024):
            m, n = int(table[i][0]), int(table[i][1])
            pre = min(max(((m * qp) >> 4) + n, 1), 126)
            st[i] = ((63 - pre) << 1) if pre <= 63 else (((pre - 64) << 1) | 1)

    def decision(self, ctx: int, b=None) -> int:
        s = self.state[ctx]
        p, mps = s >> 1, s & 1
        lps = int(T.RANGE_LPS[p][(self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:
            b = 1 - mps
            self.offset -= self.range
            self.range = lps
            if p == 0:
                mps = 1 - mps
            self.state[ctx] = (int(T.TRANS_LPS[p]) << 1) | mps
        else:
            b = mps
            self.state[ctx] = (int(T.TRANS_MPS[p]) << 1) | mps
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return b

    def bypass(self, b=None) -> int:
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def terminate(self, b=None) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return 0


class Picture:
    """The parse state of one picture's macroblocks (every slice of it), and
    the tables the parse writes."""

    def __init__(self, mb_width: int, mb_height: int):
        self.w, self.h = mb_width, mb_height
        n = self.n = mb_width * mb_height
        self.slice_of = [-1] * n
        self.type = [0] * n
        self.cbp = [0] * n
        self.t8 = [0] * n
        self.cpred = [0] * n
        self.qp = [0] * n
        self.imode = [[-1] * 16 for _ in range(n)]
        self.ref = [[[-1] * 4, [-1] * 4] for _ in range(n)]
        self.direct = [[0] * 4 for _ in range(n)]
        self.mvd = [[[0] * 32, [0] * 32] for _ in range(n)]
        self.count = [[0] * 16 for _ in range(n)]  # luma total_coeff / coded flags
        self.ccount = [[0] * 8 for _ in range(n)]  # chroma AC, Cb then Cr
        self.dc = [[0, 0, 0] for _ in range(n)]  # coded flags: luma DC, Cb DC, Cr DC
        self.table = np.zeros((n, N_FIELDS), np.int32)
        self.levels = np.zeros((n, N_LEVELS), np.int16)


class SliceWalker:
    """One slice's macroblocks, read (``chooser`` None) or written.

    ``io`` is the slice's bit reader / writer (after the slice header);
    ``h`` its header (``h264_nal.slice_header_syntax``); ``pic`` the
    picture's :class:`Picture`; ``index`` the slice's number in its batch;
    ``cabac_io`` the CABAC engine to use when the PPS says CABAC (a writer
    passes its encoder; reading, one is made at the aligned position)."""

    def __init__(self, io, h, pic: Picture, index: int, chooser=None, cabac_io=None):
        self.io, self.h, self.pic, self.index = io, h, pic, index
        self.chooser = chooser
        self.writing = chooser is not None
        sps, pps = h.sps, h.pps
        self.cabac = bool(pps.entropy_coding_mode_flag)
        self.st = h.slice_type
        self.chroma = sps.chroma_format_idc != 0
        self.t8_mode = bool(pps.transform_8x8_mode_flag)
        self.cip = bool(pps.constrained_intra_pred_flag)
        self.direct8 = bool(sps.direct_8x8_inference_flag)
        self.nref = h.num_ref_idx
        self.ce = cabac_io
        self.mb = -1

    # ------------------------------------------------------------ helpers
    def fail(self, what: str):
        pos = self.ce.pos if self.cabac and self.ce is not None else self.io.pos
        raise H264Error(f"slice {self.index} (first_mb {self.h.first_mb}), macroblock {self.mb}: {what} "
                        f"(bit {pos})")

    def pick(self, name, **info):
        return self.chooser(self, name, **info) if self.writing else None

    def avail(self, mb: int) -> bool:
        return mb >= 0 and self.pic.slice_of[mb] == self.index

    def nb(self, which: str) -> int:
        """mbAddrA / B / C / D of the current macroblock, or -1."""
        pic, mb = self.pic, self.mb
        x, y = mb % pic.w, mb // pic.w
        if which == "A":
            n = mb - 1 if x > 0 else -1
        elif which == "B":
            n = mb - pic.w if y > 0 else -1
        elif which == "C":
            n = mb - pic.w + 1 if y > 0 and x < pic.w - 1 else -1
        else:
            n = mb - pic.w - 1 if y > 0 and x > 0 else -1
        return n if self.avail(n) else -1

    def left4(self, blk: int):
        """(macroblock, 4x4 block) left of ``blk`` (macroblock -1: none)."""
        x, y = BLK_X[blk], BLK_Y[blk]
        if x > 0:
            return self.mb, BLK_AT[y][x - 1]
        return self.mbA, BLK_AT[y][3]

    def top4(self, blk: int):
        x, y = BLK_X[blk], BLK_Y[blk]
        if y > 0:
            return self.mb, BLK_AT[y - 1][x]
        return self.mbB, BLK_AT[3][x]

    def left2(self, c: int):
        return (self.mb, c - 1) if c & 1 else (self.mbA, c + 1)

    def top2(self, c: int):
        return (self.mb, c - 2) if c & 2 else (self.mbB, c + 2)

    def is_intra(self, mb: int) -> bool:
        return self.pic.type[mb] <= T_PCM

    def is_skip(self, mb: int) -> bool:
        return self.pic.type[mb] in (T_PSKIP, T_BSKIP)

    # ------------------------------------------------------------ the slice
    def run(self):
        h, pic = self.h, self.pic
        first = h.first_mb
        if first >= pic.n:
            self.fail(f"first_mb_in_slice {first} past the picture's {pic.n} macroblocks")
        qp = h.slice_qp
        if self.cabac:
            if self.ce is None:
                io = self.io
                while io.pos % 8:
                    if io.u(1) != 1:
                        self.fail("a cabac_alignment_one_bit equal to 0")
                self.ce = CabacReader(io.data, io.pos)
            self.ce.init_contexts(self.st, h.cabac_init_idc, qp)
        self.qp = qp
        self.prev_dqp = 0
        mb = first
        while True:
            if self.st != I and not self.cabac:
                run = self.io.ue(self.pick("mb_skip_run"))
                for _ in range(run):
                    self.enter(mb)
                    self.skip_mb()
                    mb += 1
                if run > 0 and not self.more_rbsp():
                    break
            self.enter(mb)
            if self.st != I and self.cabac and self.mb_skip_flag(self.pick("mb_skip_flag")):
                self.skip_mb()
            else:
                self.macroblock()
            mb += 1
            if not self.cabac:
                if not self.more_rbsp():
                    break
            elif self.ce.terminate(self.pick("end_of_slice")):
                break
        return mb

    def enter(self, mb: int):
        pic = self.pic
        if mb >= pic.n:
            self.fail("the slice runs past the picture's last macroblock")
        if pic.slice_of[mb] != -1:
            self.fail(f"macroblock {mb} is coded twice")
        self.mb = mb
        pic.slice_of[mb] = self.index
        self.mbA, self.mbB = self.nb("A"), self.nb("B")
        pic.ref[mb] = [[-1] * 4, [-1] * 4]
        pic.direct[mb] = [0] * 4
        pic.mvd[mb] = [[0] * 32, [0] * 32]
        pic.count[mb] = [0] * 16
        pic.ccount[mb] = [0] * 8
        pic.dc[mb] = [0, 0, 0]
        pic.t8[mb] = 0
        pic.cpred[mb] = 0
        pic.cbp[mb] = 0
        pic.imode[mb] = [-1] * 16

    def more_rbsp(self) -> bool:
        if self.writing:
            return bool(self.pick("more"))
        return self.io.more_rbsp_data()

    def _done(self, mb_type: int, **fields):
        """Writes the current macroblock's table row."""
        pic, mb = self.pic, self.mb
        row = pic.table[mb]
        row[F_SLICE] = self.index
        row[F_TYPE] = mb_type
        row[F_QP] = pic.qp[mb]
        row[F_CBP] = pic.cbp[mb]
        row[F_T8] = pic.t8[mb]
        row[F_CPRED] = pic.cpred[mb]
        for k, v in fields.items():
            row[{"part": F_PART, "pred": F_PRED, "sub": F_SUB, "i16": F_I16}[k]] = v
        refs = pic.ref[mb]
        row[F_REF0] = _int32(sum((r & 0xFF) << (8 * k) for k, r in enumerate(refs[0])))
        row[F_REF1] = _int32(sum((r & 0xFF) << (8 * k) for k, r in enumerate(refs[1])))
        im = pic.imode[mb]
        if mb_type in (T_I4, T_I8):
            row[F_IM0] = _int32(sum(im[b] << (4 * b) for b in range(8)))
            row[F_IM1] = _int32(sum(im[8 + b] << (4 * b) for b in range(8)))
        mvd = pic.mvd[mb]
        row[F_MVD:F_MVD + 32] = mvd[0]
        row[F_MVD + 32:F_MVD + 64] = mvd[1]
        nz = 0
        lv = pic.levels[mb]
        if mb_type != T_PCM:
            for b in range(16):
                if pic.t8[mb]:
                    k = b >> 2
                    if lv[64 * k:64 * k + 64].any():
                        nz |= 1 << b
                elif lv[16 * b:16 * b + 16].any():
                    nz |= 1 << b
        row[F_NZ] = nz

    def skip_mb(self):
        pic, mb = self.pic, self.mb
        pic.type[mb] = T_PSKIP if self.st == P else T_BSKIP
        pic.qp[mb] = self.qp
        pic.cbp[mb] = 0
        self.prev_dqp = 0
        if self.st == P:
            pic.ref[mb][0] = [0] * 4
        else:
            pic.direct[mb] = [1] * 4
        self._done(pic.type[mb])

    # ------------------------------------------------------------ CABAC elements
    def mb_skip_flag(self, v):
        a, b = self.mbA, self.mbB
        inc = (a >= 0 and not self.is_skip(a)) + (b >= 0 and not self.is_skip(b))
        return self.ce.decision((11 if self.st == P else 24) + inc, v)

    def cabac_intra_type(self, base: int, in_i: bool, v):
        """mb_type of an intra macroblock (0 I_NxN, 1-24 I16x16, 25 PCM)."""
        ce = self.ce
        if in_i:
            a, b = self.mbA, self.mbB
            inc = (a >= 0 and self.pic.type[a] != T_I4 and self.pic.type[a] != T_I8) + \
                  (b >= 0 and self.pic.type[b] != T_I4 and self.pic.type[b] != T_I8)
            if not ce.decision(base + inc, None if v is None else int(v != 0)):
                return 0
            st = base + 3
            luma, c0, c1, p1, p0 = st, st + 1, st + 2, st + 3, st + 4
        else:
            if not ce.decision(base, None if v is None else int(v != 0)):
                return 0
            st = base + 1
            luma, c0, c1, p1, p0 = st, st + 1, st + 1, st + 2, st + 2
        if ce.terminate(None if v is None else int(v == 25)):
            return 25
        k = None if v is None else v - 1
        t = 1 + 12 * ce.decision(luma, None if k is None else int(k >= 12))
        ch = None if k is None else (k % 12) // 4
        if ce.decision(c0, None if ch is None else int(ch != 0)):
            t += 4 + 4 * ce.decision(c1, None if ch is None else int(ch == 2))
        pm = None if k is None else k % 4
        t += 2 * ce.decision(p1, None if pm is None else pm >> 1)
        t += ce.decision(p0, None if pm is None else pm & 1)
        return t

    def cabac_mb_type(self, v):
        """The slice's mb_type value: I 0-25, P 0-4 and 5-30, B 0-22 and 23-48."""
        ce = self.ce
        if self.st == I:
            return self.cabac_intra_type(3, True, v)
        if self.st == P:
            if ce.decision(14, None if v is None else int(v >= 5)) == 0:
                if ce.decision(15, None if v is None else int(v in (1, 2))) == 0:
                    return 3 * ce.decision(16, None if v is None else int(v == 3))
                return 2 - ce.decision(17, None if v is None else int(v == 1))
            return 5 + self.cabac_intra_type(17, False, None if v is None else v - 5)
        a, b = self.mbA, self.mbB
        inc = (a >= 0 and self.pic.type[a] not in (T_BSKIP, T_BDIRECT)) + \
              (b >= 0 and self.pic.type[b] not in (T_BSKIP, T_BDIRECT))
        if not ce.decision(27 + inc, None if v is None else int(v != 0)):
            return 0
        if not ce.decision(30, None if v is None else int(v >= 3)):
            return 1 + ce.decision(32, None if v is None else int(v == 2))
        if v is None:
            bits = None
        elif 3 <= v <= 10:
            bits = v - 3
        elif v >= 23:
            bits = 13
        elif v == 11:
            bits = 14
        elif v == 22:
            bits = 15
        else:
            bits = (v + 4) >> 1  # 12..21 -> 5 bits (v + 4), the first four here
        got = ce.decision(31, None if bits is None else (bits >> 3) & 1) << 3
        got |= ce.decision(32, None if bits is None else (bits >> 2) & 1) << 2
        got |= ce.decision(32, None if bits is None else (bits >> 1) & 1) << 1
        got |= ce.decision(32, None if bits is None else bits & 1)
        if got < 8:
            return got + 3
        if got == 13:
            return 23 + self.cabac_intra_type(32, False, None if v is None else v - 23)
        if got == 14:
            return 11
        if got == 15:
            return 22
        got = (got << 1) | ce.decision(32, None if v is None else (v + 4) & 1)
        return got - 4

    def cabac_sub_type(self, v):
        ce = self.ce
        if self.st == P:
            if ce.decision(21, None if v is None else int(v == 0)):
                return 0
            if not ce.decision(22, None if v is None else int(v != 1)):
                return 1
            return 2 if ce.decision(23, None if v is None else int(v == 2)) else 3
        if not ce.decision(36, None if v is None else int(v != 0)):
            return 0
        if not ce.decision(37, None if v is None else int(v >= 3)):
            return 1 + ce.decision(39, None if v is None else int(v == 2))
        t = 3
        if ce.decision(38, None if v is None else int(v >= 7)):
            if ce.decision(39, None if v is None else int(v >= 11)):
                return 11 + ce.decision(39, None if v is None else int(v == 12))
            t += 4
        k = None if v is None else v - t
        t += 2 * ce.decision(39, None if k is None else k >> 1)
        t += ce.decision(39, None if k is None else k & 1)
        return t

    def cabac_ref(self, lx: int, blk: int, v):
        pic = self.pic

        def cond(mb, b):
            if mb < 0 or self.is_skip(mb) or self.is_intra(mb) or pic.direct[mb][b >> 2]:
                return 0
            return int(pic.ref[mb][lx][b >> 2] > 0)

        inc = cond(*self.left4(blk)) + 2 * cond(*self.top4(blk))
        ref = 0
        while self.ce.decision(54 + inc, None if v is None else int(ref < v)):
            ref += 1
            inc = (inc >> 2) + 4
            if ref >= 32:
                self.fail("ref_idx above 31")
        return ref

    def cabac_mvd(self, lx: int, blk: int, comp: int, v):
        pic = self.pic
        ma, ba = self.left4(blk)
        mb_, bb = self.top4(blk)
        s = (abs(pic.mvd[ma][lx][2 * ba + comp]) if ma >= 0 else 0) + \
            (abs(pic.mvd[mb_][lx][2 * bb + comp]) if mb_ >= 0 else 0)
        base = 40 if comp == 0 else 47
        ce = self.ce
        inc = 0 if s < 3 else (1 if s <= 32 else 2)
        a = None if v is None else abs(v)
        if not ce.decision(base + inc, None if a is None else int(a != 0)):
            return 0
        m = 1
        ctx = base + 3
        while m < 9 and ce.decision(ctx, None if a is None else int(a > m)):
            if m < 4:
                ctx += 1
            m += 1
        if m >= 9:
            k = 3
            rest = None if a is None else a - 9
            while ce.bypass(None if rest is None else int(rest >= (1 << k))):
                if rest is not None:
                    rest -= 1 << k
                m += 1 << k
                k += 1
                if k > 24:
                    self.fail("an mvd suffix of more than 24 bits")
            while k:
                k -= 1
                m += ce.bypass(None if rest is None else (rest >> k) & 1) << k
        return -m if ce.bypass(None if v is None else int(v < 0)) else m

    def cabac_cbp(self, v):
        pic, ce = self.pic, self.ce
        a, b = self.mbA, self.mbB

        def luma_bit(mb, k):
            """CodedBlockPatternLuma bit k of a neighbour, as condTermFlag's
            complement: unavailable or PCM count as coded, skips as not."""
            if mb < 0 or pic.type[mb] == T_PCM:
                return 1
            return (pic.cbp[mb] >> k) & 1

        cbp = 0
        for k in range(4):
            x, y = k & 1, k >> 1
            ba = (cbp >> (k - 1)) & 1 if x else luma_bit(a, k + 1)
            bb = (cbp >> (k - 2)) & 1 if y else luma_bit(b, k + 2)
            inc = (1 - ba) + 2 * (1 - bb)
            cbp |= ce.decision(73 + inc, None if v is None else (v >> k) & 1) << k
        if not self.chroma:
            return cbp

        def chroma_of(mb):
            if mb < 0:
                return 0
            if pic.type[mb] == T_PCM:
                return 2
            return pic.cbp[mb] >> 4

        ca, cb = chroma_of(a), chroma_of(b)
        c = None if v is None else v >> 4
        if not ce.decision(77 + (ca > 0) + 2 * (cb > 0), None if c is None else int(c != 0)):
            return cbp
        return cbp | ((1 + ce.decision(81 + (ca == 2) + 2 * (cb == 2), None if c is None else int(c == 2))) << 4)

    def cabac_dqp(self, v):
        ce = self.ce
        k = None if v is None else (2 * v - 1 if v > 0 else -2 * v)
        inc = int(self.prev_dqp != 0)
        n = 0
        while ce.decision(60 + inc, None if k is None else int(n < k)):
            inc = 2 if inc < 2 else 3
            n += 1
            if n > 102:
                self.fail("mb_qp_delta out of range")
        return (n + 1) >> 1 if n & 1 else -((n + 1) >> 1)

    def cabac_cpred(self, v):
        pic, ce = self.pic, self.ce

        def cond(m):
            return int(m >= 0 and pic.type[m] in (T_I4, T_I8, T_I16) and pic.cpred[m] != 0)

        inc = cond(self.mbA) + cond(self.mbB)
        if not ce.decision(64 + inc, None if v is None else int(v != 0)):
            return 0
        if not ce.decision(67, None if v is None else int(v != 1)):
            return 1
        return 2 if not ce.decision(67, None if v is None else int(v == 3)) else 3

    def cabac_t8(self, v):
        pic = self.pic
        inc = sum(int(m >= 0 and pic.t8[m]) for m in (self.mbA, self.mbB))
        return self.ce.decision(399 + inc, v)

    # ------------------------------------------------------------ the macroblock
    def macroblock(self):
        pic, mb, io = self.pic, self.mb, self.io
        v = self.pick("mb_type")
        t = self.cabac_mb_type(v) if self.cabac else io.ue(v)
        st = self.st
        intra = None
        if st == I:
            intra = t
        elif st == P:
            if t > 30:
                self.fail(f"P mb_type {t}")
            intra = t - 5 if t >= 5 else None
        else:
            if t > 48:
                self.fail(f"B mb_type {t}")
            intra = t - 23 if t >= 23 else None
        if intra is not None:
            if intra > 25:
                self.fail(f"I mb_type {intra}")
            return self.intra_mb(intra)
        if st == P:
            if t >= 3:
                return self.inter_8x8(ref0=t == 4)
            part, p0, p1 = P_TYPES[t]
            return self.inter_mb(part, p0, p1)
        if t == 0:
            return self.b_direct()
        if t == 22:
            return self.inter_8x8(ref0=False)
        part, p0, p1 = B_TYPES[t]
        return self.inter_mb(part, p0, p1)

    def intra_mb(self, t: int):
        pic, mb = self.pic, self.mb
        if t == 25:
            return self.pcm()
        if t == 0:
            t8 = 0
            if self.t8_mode:
                v = self.pick("transform_8x8")
                t8 = self.cabac_t8(v) if self.cabac else self.io.u(1, v)
            pic.t8[mb] = t8
            pic.type[mb] = T_I8 if t8 else T_I4
            self.intra_modes(t8)
            cp = self.chroma_mode()
            cbp = self.coded_block_pattern(True)
            pic.cbp[mb] = cbp
            pic.cpred[mb] = cp
            fields = {}
        else:
            k = t - 1
            pic.type[mb] = T_I16
            cbp = (15 if k >= 12 else 0) | (((k % 12) // 4) << 4)
            pic.cbp[mb] = cbp
            pic.cpred[mb] = self.chroma_mode()
            fields = {"i16": k % 4}
        self.residual_and_qp(intra=True)
        self._done(pic.type[mb], **fields)

    def chroma_mode(self) -> int:
        if not self.chroma:
            return 0
        v = self.pick("intra_chroma_pred_mode")
        m = self.cabac_cpred(v) if self.cabac else self.io.ue(v)
        if m > 3:
            self.fail(f"intra_chroma_pred_mode {m}")
        self.pic.cpred[self.mb] = m
        return m

    def pred_mode(self, blk: int) -> int:
        """predIntra4x4PredMode / predIntra8x8PredMode of 4x4 block ``blk`` (the
        8x8 block's first), from the neighbouring blocks (8.3.1.1)."""
        pic = self.pic
        modes = []
        for mb, b in (self.left4(blk), self.top4(blk)):
            if mb < 0 or (self.cip and not self.is_intra(mb)):
                return 2
            modes.append(pic.imode[mb][b] if pic.type[mb] in (T_I4, T_I8) else 2)
        return min(modes)

    def intra_modes(self, t8: int):
        pic, mb = self.pic, self.mb
        im = pic.imode[mb]
        for blk in range(0, 16, 4 if t8 else 1):
            pred = self.pred_mode(blk)
            want = self.pick("intra_mode", blk=blk, t8=t8)
            prev = None if want is None else int(want == pred)
            rem = None if want is None else (want if want < pred else want - 1)
            if self.cabac:
                flag = self.ce.decision(68, prev)
                if not flag:
                    r = self.ce.decision(69, None if rem is None else rem & 1)
                    r |= self.ce.decision(69, None if rem is None else (rem >> 1) & 1) << 1
                    r |= self.ce.decision(69, None if rem is None else (rem >> 2) & 1) << 2
            else:
                flag = self.io.u(1, prev)
                if not flag:
                    r = self.io.u(3, rem)
            mode = pred if flag else (r if r < pred else r + 1)
            for b in range(blk, blk + (4 if t8 else 1)):
                im[b] = mode

    def coded_block_pattern(self, intra: bool) -> int:
        v = self.pick("cbp", intra=intra)
        if self.cabac:
            return self.cabac_cbp(v)
        table = T.CBP_INTRA if intra else T.CBP_INTER
        if not self.chroma:
            # 4:0:0 maps codeNum to luma only (Table 9-4, chroma_format_idc 0)
            k = self.io.ue(None if v is None else _CBP_400[intra].index(v))
            if k > 15:
                self.fail(f"coded_block_pattern codeNum {k}")
            return _CBP_400[intra][k]
        k = self.io.ue(None if v is None else int(np.flatnonzero(table == v)[0]))
        if k > 47:
            self.fail(f"coded_block_pattern codeNum {k}")
        return int(table[k])

    def pcm(self):
        pic, mb = self.pic, self.mb
        pic.type[mb] = T_PCM
        pic.cbp[mb] = 0x2F
        pic.qp[mb] = self.qp
        self.prev_dqp = 0
        pic.count[mb] = [16] * 16
        pic.ccount[mb] = [16] * 8
        pic.dc[mb] = [1, 1, 1]
        n = 256 + (128 if self.chroma else 0)
        want = self.pick("pcm", n=n)
        io = self.io
        if self.cabac:
            io.pos = self.ce.pos
        while io.pos % 8:
            if io.u(1, 0 if self.writing else None):
                self.fail("a pcm_alignment_zero_bit equal to 1")
        lv = pic.levels[mb]
        for i in range(n):
            lv[i] = io.u(8, None if want is None else int(want[i]))
        if self.cabac:
            if self.writing:
                self.ce.restart(io)
            else:
                self.ce.start(io.pos)
        self._done(T_PCM)

    # ------------------------------------------------------------ inter
    def ref_idx(self, lx: int, blk: int) -> int:
        n = self.nref[lx]
        v = self.pick("ref_idx", lx=lx, blk=blk)
        if n == 1:
            return 0
        if self.cabac:
            r = self.cabac_ref(lx, blk, v)
        else:
            r = (1 - self.io.u(1, None if v is None else 1 - v)) if n == 2 else self.io.ue(v)
        if r >= n:
            self.fail(f"ref_idx_l{lx} {r} with {n} references")
        return r

    def mvd(self, lx: int, blocks: List[int]):
        mvd = self.pic.mvd[self.mb][lx]
        got = []
        for comp in range(2):
            v = self.pick("mvd", lx=lx, blk=blocks[0], comp=comp)
            d = self.cabac_mvd(lx, blocks[0], comp, v) if self.cabac else self.io.se(v)
            if not -8192 <= d <= 8191:
                self.fail(f"mvd {d}")
            for b in blocks:
                mvd[2 * b + comp] = d
            got.append(d)
        return got

    def inter_mb(self, part: int, p0: int, p1: int):
        pic, mb = self.pic, self.mb
        pic.type[mb] = T_INTER
        nparts = 1 if part == PART_16x16 else 2
        preds = (p0, p1)[:nparts]
        for lx in range(2):
            for j in range(nparts):
                if preds[j] >> lx & 1:
                    blocks = part_blocks(part, j)
                    r = self.ref_idx(lx, blocks[0])
                    for b in blocks[::4]:
                        pic.ref[mb][lx][b >> 2] = r
        for lx in range(2):
            for j in range(nparts):
                if preds[j] >> lx & 1:
                    self.mvd(lx, part_blocks(part, j))
        self.inter_residual()
        self._done(T_INTER, part=part, pred=p0 | (p1 << 2))

    def inter_8x8(self, ref0: bool):
        pic, mb = self.pic, self.mb
        pic.type[mb] = T_INTER
        subs = []
        for k in range(4):
            v = self.pick("sub_mb_type", k=k)
            s = self.cabac_sub_type(v) if self.cabac else self.io.ue(v)
            if s > (3 if self.st == P else 12):
                self.fail(f"sub_mb_type {s}")
            code = (s | 4) if self.st == P else B_SUBS[s]
            subs.append(code)
            if code == SUB_DIRECT:
                pic.direct[mb][k] = 1
        for lx in range(2):
            for k in range(4):
                code = subs[k]
                if code != SUB_DIRECT and (code >> 2) >> lx & 1:
                    pic.ref[mb][lx][k] = 0 if ref0 else self.ref_idx(lx, 4 * k)
        for lx in range(2):
            for k in range(4):
                code = subs[k]
                if code == SUB_DIRECT or not (code >> 2) >> lx & 1:
                    continue
                shape = code & 3
                for j in range(SUB_PARTS[shape]):
                    self.mvd(lx, sub_blocks(k, shape, j))
        small = any(c != SUB_DIRECT and (c & 3) != 0 for c in subs) or \
            (not self.direct8 and any(c == SUB_DIRECT for c in subs))
        self.inter_residual(small)
        self._done(T_INTER, part=PART_8x8, sub=_int32(sum(c << (5 * k) for k, c in enumerate(subs))))

    def b_direct(self):
        pic, mb = self.pic, self.mb
        pic.type[mb] = T_BDIRECT
        pic.direct[mb] = [1] * 4
        self.inter_residual(not self.direct8)
        self._done(T_BDIRECT)

    def inter_residual(self, small: bool = False):
        pic, mb = self.pic, self.mb
        cbp = self.coded_block_pattern(False)
        pic.cbp[mb] = cbp
        if cbp & 15 and self.t8_mode and not small:
            v = self.pick("transform_8x8")
            pic.t8[mb] = self.cabac_t8(v) if self.cabac else self.io.u(1, v)
        self.residual_and_qp(intra=False)

    # ------------------------------------------------------------ residual
    def residual_and_qp(self, intra: bool):
        pic, mb = self.pic, self.mb
        cbp = pic.cbp[mb]
        i16 = pic.type[mb] == T_I16
        if cbp or i16:
            v = self.pick("mb_qp_delta")
            d = self.cabac_dqp(v) if self.cabac else self.io.se(v)
            if not -26 <= d <= 25:
                self.fail(f"mb_qp_delta {d}")
            self.qp = (self.qp + d + 52) % 52
            self.prev_dqp = d
        else:
            self.prev_dqp = 0
        pic.qp[mb] = self.qp
        if cbp or i16:
            self.residual(i16, intra)

    def nc(self, counts) -> int:
        """nC (9.2.1) from the total_coeff of blocks A and B (None where the
        block is not available)."""
        got = [c for c in counts if c is not None]
        if len(got) == 2:
            return (got[0] + got[1] + 1) >> 1
        return got[0] if got else 0

    def luma_count(self, mb: int, b: int) -> Optional[int]:
        if mb < 0:
            return None
        if self.pic.type[mb] == T_PCM:
            return 16
        return self.pic.count[mb][b]

    def chroma_count(self, mb: int, c: int, comp: int) -> Optional[int]:
        if mb < 0:
            return None
        if self.pic.type[mb] == T_PCM:
            return 16
        return self.pic.ccount[mb][4 * comp + c]

    def cbf_luma(self, mb: int, b: int) -> int:
        """coded_block_flag condTerm of a neighbouring luma 4x4 block."""
        pic = self.pic
        if mb < 0:
            return int(self.is_intra(self.mb))
        t = pic.type[mb]
        if t == T_PCM:
            return 1
        if t in (T_PSKIP, T_BSKIP) or not (pic.cbp[mb] >> (b >> 2)) & 1:
            return 0
        if pic.t8[mb]:
            return 1
        return int(pic.count[mb][b] > 0)

    def cbf_chroma_ac(self, mb: int, c: int, comp: int) -> int:
        pic = self.pic
        if mb < 0:
            return int(self.is_intra(self.mb))
        t = pic.type[mb]
        if t == T_PCM:
            return 1
        if t in (T_PSKIP, T_BSKIP) or (pic.cbp[mb] >> 4) != 2:
            return 0
        return int(pic.ccount[mb][4 * comp + c] > 0)

    def cbf_dc(self, mb: int, which: int) -> int:
        pic = self.pic
        if mb < 0:
            return int(self.is_intra(self.mb))
        t = pic.type[mb]
        if t == T_PCM:
            return 1
        if which == 0:
            return pic.dc[mb][0] if t == T_I16 else 0
        if t in (T_PSKIP, T_BSKIP) or (pic.cbp[mb] >> 4) == 0:
            return 0
        return pic.dc[mb][which]

    def residual(self, i16: bool, intra: bool):
        pic, mb = self.pic, self.mb
        lv = pic.levels[mb]
        cbp = pic.cbp[mb]
        t8 = pic.t8[mb]
        zz4, zz8 = T.ZIGZAG4, T.ZIGZAG8
        if i16:
            coded = self.block(0, 16, ("dc", 0), 0)
            for i, c in enumerate(coded):
                lv[L_DC + zz4[i]] = c
        for k in range(4):
            if not (cbp >> k) & 1:
                continue
            if t8 and self.cabac:
                coded = self.block(5, 64, ("l8", k), 4 * k)
                for i, c in enumerate(coded):
                    lv[64 * k + zz8[i]] = c
                for b in range(4 * k, 4 * k + 4):
                    pic.count[mb][b] = sum(1 for c in coded if c)
                continue
            for b in range(4 * k, 4 * k + 4):
                if i16:
                    coded = self.block(1, 15, ("l4", b), b)
                    for i, c in enumerate(coded):
                        lv[16 * b + zz4[i + 1]] = c
                elif t8:  # CAVLC: four interleaved 4x4 scans of the 8x8 block
                    coded = self.block(2, 16, ("l4", b), b)
                    for i, c in enumerate(coded):
                        lv[64 * k + zz8[4 * i + (b - 4 * k)]] = c
                else:
                    coded = self.block(2, 16, ("l4", b), b)
                    for i, c in enumerate(coded):
                        lv[16 * b + zz4[i]] = c
        if not self.chroma or not cbp >> 4:
            return
        for comp in range(2):
            coded = self.block(3, 4, ("cdc", comp), comp)
            for i, c in enumerate(coded):
                lv[L_CDC + 4 * comp + i] = c
        if cbp >> 4 != 2:
            return
        for comp in range(2):
            for c in range(4):
                coded = self.block(4, 15, ("cac", comp, c), c)
                for i, x in enumerate(coded):
                    lv[L_CAC + 64 * comp + 16 * c + zz4[i + 1]] = x

    def block(self, cat: int, n: int, where, blk: int) -> List[int]:
        """One residual block of category ``cat`` (0 Intra16x16 DC, 1
        Intra16x16 AC, 2 luma 4x4, 3 chroma DC, 4 chroma AC, 5 luma 8x8) and
        ``n`` coefficients, in scan order; records its count."""
        pic, mb = self.pic, self.mb
        want = self.pick("coeffs", cat=cat, n=n, where=where)
        if self.cabac:
            coded = self.cabac_block(cat, n, where, blk, want)
        else:
            coded = self.cavlc_block(cat, n, where, blk, want)
        count = sum(1 for c in coded if c)
        kind = where[0]
        if kind == "dc":
            pic.dc[mb][0] = int(count > 0)
        elif kind == "l4":
            pic.count[mb][where[1]] = count
        elif kind == "cdc":
            pic.dc[mb][1 + where[1]] = int(count > 0)
        elif kind == "cac":
            pic.ccount[mb][4 * where[1] + where[2]] = count
        return coded

    # ------------------------------------------------------------ CAVLC residual
    def read_vlc(self, table: dict, what: str):
        io = self.io
        code, n = 0, 0
        while n < 16:
            code = (code << 1) | io.bit()
            n += 1
            hit = table.get((n, code))
            if hit is not None:
                return hit
        self.fail(f"an invalid {what} code")

    def cavlc_block(self, cat: int, n: int, where, blk: int, want) -> List[int]:
        io = self.io
        kind = where[0]
        if kind == "cdc":
            table = 4
        else:
            if kind in ("dc", "l4"):
                b = 0 if kind == "dc" else where[1]
                ma, ba = self.left4(b)
                mb_, bb = self.top4(b)
                nc = self.nc([self.luma_count(ma, ba), self.luma_count(mb_, bb)])
            else:
                comp, c = where[1], where[2]
                ma, ca = self.left2(c)
                mb_, cb = self.top2(c)
                nc = self.nc([self.chroma_count(ma, ca, comp), self.chroma_count(mb_, cb, comp)])
            table = 0 if nc < 2 else (1 if nc < 4 else (2 if nc < 8 else 3))
        if self.writing:
            return self.chooser.cavlc_write(self, table, n, want)
        tc, t1 = self.read_vlc(T.COEFF_TOKEN[table], "coeff_token")
        if tc > n:
            self.fail(f"coeff_token: {tc} coefficients in a block of {n}")
        levels = []
        if tc:
            suffix = 1 if tc > 10 and t1 < 3 else 0
            for i in range(tc):
                if i < t1:
                    levels.append(-1 if io.bit() else 1)
                    continue
                prefix = 0
                while io.bit() == 0:
                    prefix += 1
                    if prefix > 32:
                        self.fail("a level_prefix above 32")
                code = min(15, prefix) << suffix
                size = 4 if prefix == 14 and suffix == 0 else (prefix - 3 if prefix >= 15 else suffix)
                if size:
                    code += io.u(size)
                if prefix >= 15 and suffix == 0:
                    code += 15
                if prefix >= 16:
                    code += (1 << (prefix - 3)) - 4096
                if i == t1 and t1 < 3:
                    code += 2
                level = (code + 2) >> 1 if code % 2 == 0 else (-code - 1) >> 1
                levels.append(level)
                if suffix == 0:
                    suffix = 1
                if abs(level) > (3 << (suffix - 1)) and suffix < 6:
                    suffix += 1
            zeros = 0
            if tc < n:
                zeros = self.read_vlc(T.CDC_TOTAL_ZEROS[tc - 1] if table == 4 else T.TOTAL_ZEROS[tc - 1],
                                      "total_zeros")
            if zeros + tc > n:
                self.fail(f"total_zeros {zeros} with {tc} coefficients in a block of {n}")
            runs = []
            for i in range(tc - 1):
                r = self.read_vlc(T.RUN_BEFORE[min(zeros, 7) - 1], "run_before") if zeros > 0 else 0
                if r > zeros:
                    self.fail(f"run_before {r} with {zeros} zeros left")
                runs.append(r)
                zeros -= r
            runs.append(zeros)
        out = [0] * n
        pos = -1
        for i in range(tc - 1, -1, -1):
            pos += runs[i] + 1
            out[pos] = levels[i]
        return out

    # ------------------------------------------------------------ CABAC residual
    def cabac_block(self, cat: int, n: int, where, blk: int, want) -> List[int]:
        ce = self.ce
        kind = where[0]
        if cat != 5:
            if kind == "dc":
                inc = self.cbf_dc(self.mbA, 0) + 2 * self.cbf_dc(self.mbB, 0)
            elif kind == "l4":
                ma, ba = self.left4(where[1])
                mb_, bb = self.top4(where[1])
                inc = self.cbf_luma(ma, ba) + 2 * self.cbf_luma(mb_, bb)
            elif kind == "cdc":
                comp = where[1]
                inc = self.cbf_dc(self.mbA, 1 + comp) + 2 * self.cbf_dc(self.mbB, 1 + comp)
            else:
                comp, c = where[1], where[2]
                ma, ca = self.left2(c)
                mb_, cb = self.top2(c)
                inc = self.cbf_chroma_ac(ma, ca, comp) + 2 * self.cbf_chroma_ac(mb_, cb, comp)
            coded = ce.decision(85 + 4 * cat + inc, None if want is None else int(any(want)))
            if not coded:
                return [0] * n
        if cat == 5:
            sig_base, last_base, abs_base = 402, 417, 426
        else:
            off = (0, 15, 29, 44, 47)[cat]
            sig_base, last_base, abs_base = 105 + off, 166 + off, 227 + (0, 10, 20, 30, 39)[cat]
        sig = [0] * n
        last_at = None if want is None else max(i for i, c in enumerate(want) if c)
        i = 0
        while i < n - 1:
            if cat == 5:
                si, li = sig_base + int(T.SIG8x8[i]), last_base + int(T.LAST8x8[i])
            elif cat == 3:
                si = li = min(i, 2)
                si, li = sig_base + si, last_base + li
            else:
                si, li = sig_base + i, last_base + i
            if ce.decision(si, None if want is None else int(want[i] != 0)):
                sig[i] = 1
                if ce.decision(li, None if want is None else int(i == last_at)):
                    break
            i += 1
        else:
            sig[n - 1] = 1
        out = [0] * n
        eq1 = gt1 = 0
        for i in range(n - 1, -1, -1):
            if not sig[i]:
                continue
            a = None if want is None else abs(want[i]) - 1
            inc = 0 if gt1 else min(4, 1 + eq1)
            if not ce.decision(abs_base + inc, None if a is None else int(a > 0)):
                level = 1
                eq1 += 1
            else:
                ctx = abs_base + 5 + min(4 - (cat == 3), gt1)
                m = 1
                while m < 14 and ce.decision(ctx, None if a is None else int(a > m)):
                    m += 1
                if m >= 14:
                    rest = None if a is None else a - 14
                    k = 0
                    while ce.bypass(None if rest is None else int(rest >= (1 << k))):
                        if rest is not None:
                            rest -= 1 << k
                        m += 1 << k
                        k += 1
                        if k > 24:
                            self.fail("a coefficient suffix of more than 24 bits")
                    while k:
                        k -= 1
                        m += ce.bypass(None if rest is None else (rest >> k) & 1) << k
                level = m + 1
                gt1 += 1
            out[i] = -level if ce.bypass(None if want is None else int(want[i] < 0)) else level
        return out


def _int32(v: int) -> int:
    """A 32-bit pattern as a signed int32 value."""
    return v - (1 << 32) if v >= 1 << 31 else v


#: coded_block_pattern for chroma_format_idc 0 (Table 9-4): codeNum -> cbp, [inter, intra]
_CBP_400 = ([0, 1, 2, 4, 8, 3, 5, 10, 12, 15, 7, 11, 13, 14, 6, 9],
            [15, 0, 7, 11, 13, 14, 3, 5, 10, 12, 1, 2, 4, 8, 6, 9])


def parse_slice(rbsp: bytes, pos: int, h, pic: Picture, index: int) -> None:
    """Parses one slice (its RBSP, the slice data from bit ``pos``) into
    ``pic``'s tables."""
    io = BitReader(rbsp, pos)
    walker = SliceWalker(io, h, pic, index)
    walker.run()
    if not walker.cabac and io.more_rbsp_data():
        walker.fail("data after the slice's last macroblock")
