"""An H.264 stream writer for the port's tests: the syntax inverse of
``dspnet_torch/data/h264_parse.py``. cv2 5.0.0's wheel decodes H.264 but writes none,
so the forms under ``tests/fixtures/h264_forms/`` come from this writer and
are judged only by cv2's decode (``tests/make_h264_fixtures.py``): a writer
bug that the parser mirrors shows as frames unequal to cv2's.

The parameter sets, slice headers and slice data are written through the
port's own syntax functions (``h264_nal.sps_syntax`` and the rest,
``h264_parse.SliceWalker``) with a :class:`BitWriter` / :class:`CabacWriter`
in place of the readers; every macroblock decision comes from a
:class:`Chooser`, seeded, within what the stream allows (intra modes by
neighbour availability, coefficients small enough that no transform value
leaves 16 bits, as FFmpeg's 16-bit transforms need). Containers: MP4
(``avc1`` / ``avc3`` with ``avcC``, ``ctts`` and an edit list) and AVI
(Annex B samples).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np

from dspnet_torch.data import h264_nal as N
from dspnet_torch.data import h264_parse as HP
from dspnet_torch.data import h264_tables as T
from dspnet_torch.data.h264_nal import Syntax


class BitWriter:
    """Writes bits MSB first; the syntax functions' ``io`` when writing."""

    writing = True

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0
        self.pos = 0

    def u(self, n: int, v) -> int:
        v = int(v)
        if n and not 0 <= v < (1 << n):
            raise ValueError(f"{v} does not fit {n} bits")
        for k in range(n - 1, -1, -1):
            self.bit((v >> k) & 1)
        return v

    def bit(self, b: int = 0) -> int:
        self.acc = (self.acc << 1) | (b & 1)
        self.n += 1
        self.pos += 1
        if self.n == 8:
            self.out.append(self.acc)
            self.acc = self.n = 0
        return b

    def ue(self, v) -> int:
        v = int(v)
        if v < 0:
            raise ValueError(f"ue({v})")
        k = (v + 1).bit_length() - 1
        self.u(k, 0)
        self.u(k + 1, v + 1)
        return v

    def se(self, v) -> int:
        v = int(v)
        self.ue(2 * v - 1 if v > 0 else -2 * v)
        return v

    def more_rbsp_data(self, v) -> bool:
        return bool(v)

    def trailing(self):
        self.bit(1)
        while self.n:
            self.bit(0)

    def data(self) -> bytes:
        assert self.n == 0
        return bytes(self.out)


class CabacWriter:
    """The CABAC arithmetic encoder (9.3.4) writing into a BitWriter."""

    def __init__(self, bw: BitWriter):
        self.bw = bw
        self.state = [0] * 1024
        self.restart(bw)

    def restart(self, bw):
        self.low, self.range, self.first, self.outstanding = 0, 510, True, 0

    @property
    def pos(self):
        return self.bw.pos

    def init_contexts(self, slice_type, idc, qp):
        table = T.CABAC_INIT[3 if slice_type == N.I else idc]
        qp = min(max(qp, 0), 51)
        for i in range(1024):
            m, n = int(table[i][0]), int(table[i][1])
            pre = min(max(((m * qp) >> 4) + n, 1), 126)
            self.state[i] = ((63 - pre) << 1) if pre <= 63 else (((pre - 64) << 1) | 1)

    def _put(self, b):
        if self.first:
            self.first = False
        else:
            self.bw.bit(b)
        while self.outstanding:
            self.bw.bit(1 - b)
            self.outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx, b):
        b = int(b)
        s = self.state[ctx]
        p, mps = s >> 1, s & 1
        lps = int(T.RANGE_LPS[p][(self.range >> 6) & 3])
        self.range -= lps
        if b != mps:
            self.low += self.range
            self.range = lps
            if p == 0:
                mps = 1 - mps
            self.state[ctx] = (int(T.TRANS_LPS[p]) << 1) | mps
        else:
            self.state[ctx] = (int(T.TRANS_MPS[p]) << 1) | mps
        self._renorm()
        return b

    def bypass(self, b):
        b = int(b)
        self.low <<= 1
        if b:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1
        return b

    def terminate(self, b):
        b = int(b)
        self.range -= 2
        if b:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            self.bw.u(2, ((self.low >> 7) & 3) | 1)
        else:
            self._renorm()
        return b


# ------------------------------------------------------------------ CAVLC residual


def cavlc_block(bw: BitWriter, table: int, n: int, coeffs: List[int]) -> List[int]:
    """residual_block_cavlc() of ``coeffs`` (scan order, length ``n``) with
    coeff_token table ``table`` (0-3 by nC, 4 chroma DC)."""
    nz = [i for i, c in enumerate(coeffs) if c]
    tc = len(nz)
    levels = [coeffs[i] for i in reversed(nz)]  # highest frequency first
    t1 = 0
    for lv in levels:
        if abs(lv) == 1 and t1 < 3:
            t1 += 1
        else:
            break
    if table == 4:
        ln, bits = T.CDC_TOKEN_LEN[tc][t1], T.CDC_TOKEN_BITS[tc][t1]
    else:
        ln, bits = T.COEFF_TOKEN_LEN[table][tc][t1], T.COEFF_TOKEN_BITS[table][tc][t1]
    if not ln:
        raise ValueError(f"no coeff_token for {tc}, {t1} in table {table}")
    bw.u(int(ln), int(bits))
    if not tc:
        return coeffs
    suffix = 1 if tc > 10 and t1 < 3 else 0
    for i, lv in enumerate(levels):
        if i < t1:
            bw.bit(int(lv < 0))
            continue
        code = 2 * lv - 2 if lv > 0 else -2 * lv - 1
        if i == t1 and t1 < 3:
            code -= 2
        if suffix == 0:
            if code < 14:
                bw.u(code + 1, 1)
            elif code < 30:
                bw.u(15, 1)
                bw.u(4, code - 14)
            else:
                if code - 30 >= 4096:
                    raise ValueError(f"level {lv} needs an escape above level_prefix 15")
                bw.u(16, 1)
                bw.u(12, code - 30)
        else:
            if code < (15 << suffix):
                bw.u((code >> suffix) + 1, 1)
                bw.u(suffix, code & ((1 << suffix) - 1))
            else:
                if code - (15 << suffix) >= 4096:
                    raise ValueError(f"level {lv} needs an escape above level_prefix 15")
                bw.u(16, 1)
                bw.u(12, code - (15 << suffix))
        if suffix == 0:
            suffix = 1
        if abs(lv) > (3 << (suffix - 1)) and suffix < 6:
            suffix += 1
    zeros = (nz[-1] + 1 - tc) if tc else 0
    if tc < n:
        if table == 4:
            bw.u(int(T.CDC_TOTAL_ZEROS_LEN[tc - 1][zeros]), int(T.CDC_TOTAL_ZEROS_BITS[tc - 1][zeros]))
        else:
            bw.u(int(T.TOTAL_ZEROS_LEN[tc - 1][zeros]), int(T.TOTAL_ZEROS_BITS[tc - 1][zeros]))
    pos = list(reversed(nz))  # positions, highest first
    for i in range(tc - 1):
        run = pos[i] - pos[i + 1] - 1
        if zeros > 0:
            k = min(zeros, 7) - 1
            bw.u(int(T.RUN_LEN[k][run]), int(T.RUN_BITS[k][run]))
        zeros -= run
    return coeffs


# ------------------------------------------------------------------ decisions


def _dequant_bound(coeffs_raster: np.ndarray, ls: np.ndarray, qp: int, eight: bool) -> int:
    q6 = qp // 6
    if eight:
        d = np.abs(coeffs_raster * ls) << max(q6 - 6, 0) if qp >= 36 else np.abs(coeffs_raster * ls) >> (6 - q6)
        return int(d.sum()) * 4
    d = np.abs(coeffs_raster * ls) << max(q6 - 4, 0) if qp >= 24 else np.abs(coeffs_raster * ls) >> (4 - q6)
    return int(d.sum())


class Chooser:
    """Seeded decisions for every macroblock of a slice, within ``cfg``:

    ``skip`` probability of a skipped macroblock (P / B); ``intra`` of an
    intra macroblock in P / B; ``i16`` / ``i8`` / ``pcm`` shares of intra
    types; ``t8`` of an 8x8 transform; ``cbp`` of each coded block pattern
    bit; ``density`` of a non-zero coefficient and ``level`` its largest
    magnitude; ``dqp`` the largest mb_qp_delta, ``qp`` the (lo, hi) QP range;
    ``mvd`` the largest motion vector difference (``far`` the share of
    differences up to 400); ``parts`` the inter partition shapes allowed;
    ``direct`` of B_Direct / direct sub-blocks; ``modes`` the intra 4x4 /
    8x8 modes allowed (all by default); and ``force``, a callable(walker, name, info) -> value or None
    taking precedence (the 1024x2048 clip codes its known motion so)."""

    DEFAULT = dict(skip=0.2, intra=0.15, i16=0.3, i8=0.3, pcm=0.02, t8=0.5, cbp=0.5, density=0.15, level=3,
                   dqp=2, qp=(20, 40), mvd=12, far=0.02, parts=(0, 1, 2, 3), direct=0.2, force=None)

    def __init__(self, rng: np.random.Generator, cfg: Optional[dict] = None):
        self.rng = rng
        self.cfg = dict(self.DEFAULT, **(cfg or {}))
        self.last_mb: Optional[int] = None  # the slice's last macroblock
        self.cache = {}

    def r(self):
        return self.rng.random()

    def __call__(self, w, name, **info):
        force = self.cfg["force"]
        if force is not None:
            got = force(w, name, info)
            if got is not None:
                return got
        return getattr(self, "c_" + name)(w, **info)

    # ---- slice flow
    def c_mb_skip_run(self, w):
        # a run never reaches the slice's last macroblock, which CAVLC codes
        run = 0
        while w.mb + run <= self.last_mb and self.r() < self.cfg["skip"] and w.mb + run < self.last_mb:
            run += 1
        return run

    def c_more(self, w):
        return w.mb < self.last_mb

    def c_mb_skip_flag(self, w):
        return int(self.r() < self.cfg["skip"])

    def c_end_of_slice(self, w):
        return int(w.mb >= self.last_mb)

    # ---- macroblock types
    def _avail(self, w):
        """(left, top, top-left) macroblocks available for intra prediction."""
        out = []
        for n in (w.mbA, w.mbB, w.nb("D")):
            out.append(n >= 0 and not (w.cip and not w.is_intra(n)))
        return out

    def c_mb_type(self, w):
        cfg, st = self.cfg, w.st
        self.cache = {}
        intra = st == N.I or self.r() < cfg["intra"]
        if intra:
            u = self.r()
            if u < cfg["pcm"]:
                t = 25
            elif u < cfg["pcm"] + cfg["i16"]:
                a, b, d = self._avail(w)
                modes = [2] + ([0] if b else []) + ([1] if a else []) + ([3] if a and b and d else [])
                mode = int(self.rng.choice(modes))
                cbp_l = int(self.r() < cfg["cbp"])
                cbp_c = int(self.rng.integers(0, 3)) if w.chroma else 0
                t = 1 + mode + 4 * cbp_c + 12 * cbp_l
            else:
                t = 0
            return t if st == N.I else t + (5 if st == N.P else 23)
        parts = cfg["parts"]
        if st == N.P:
            shape = int(self.rng.choice(parts))
            return (0, 1, 2, 3)[shape] if not (shape == 3 and not w.cabac and self.r() < 0.3) else 4
        if self.r() < cfg["direct"]:
            return 0
        shape = int(self.rng.choice(parts))
        if shape == 3:
            return 22
        if shape == 0:
            return int(self.rng.integers(1, 4))
        k = int(self.rng.integers(0, 9))
        return 4 + 2 * k + (0 if shape == 1 else 1)

    def c_sub_mb_type(self, w, k):
        if w.st == N.P:
            return int(self.rng.integers(0, 4))
        if self.r() < self.cfg["direct"]:
            return 0
        return int(self.rng.integers(1, 13))

    def c_transform_8x8(self, w):
        return int(self.r() < self.cfg["t8"])

    def c_intra_mode(self, w, blk, t8):
        a, b, d = self._avail(w)
        bx, by = HP.BLK_X[blk], HP.BLK_Y[blk]
        left = bx > 0 or a
        top = by > 0 or b
        if bx > 0 and by > 0:
            tl = True
        elif by > 0:
            tl = a
        elif bx > 0:
            tl = b
        else:
            tl = d
        ok = [2] + ([0, 3, 7] if top else []) + ([1, 8] if left else []) + ([4, 5, 6] if top and left and tl else [])
        modes = self.cfg.get("modes")
        if modes is not None:
            ok = [m for m in ok if m in modes] or [2]
        return int(self.rng.choice(ok))

    def c_intra_chroma_pred_mode(self, w):
        a, b, d = self._avail(w)
        ok = [0] + ([1] if a else []) + ([2] if b else []) + ([3] if a and b and d else [])
        return int(self.rng.choice(ok))

    def c_cbp(self, w, intra):
        luma = sum(int(self.r() < self.cfg["cbp"]) << k for k in range(4))
        chroma = int(self.rng.integers(0, 3)) if w.chroma else 0
        return luma | (chroma << 4)

    def c_mb_qp_delta(self, w):
        lo, hi = self.cfg["qp"]
        m = self.cfg["dqp"]
        d = int(self.rng.integers(-m, m + 1))
        return int(np.clip(w.qp + d, lo, hi)) - w.qp

    def c_pcm(self, w, n):
        return self.rng.integers(0, 256, n)

    def c_ref_idx(self, w, lx, blk):
        return int(self.rng.integers(0, w.nref[lx]))

    def c_mvd(self, w, lx, blk, comp):
        if self.r() < self.cfg["far"]:
            return int(self.rng.integers(-400, 401))
        m = self.cfg["mvd"]
        return int(self.rng.integers(-m, m + 1))

    # ---- coefficients
    def _scale(self, w, cat):
        """LevelScale of the block's list at the current QP (raster)."""
        pic = w.pic
        intra = w.is_intra(w.mb)
        qp = w.qp
        s4, s8 = self.lists
        if cat == 5 or (cat == 2 and pic.t8[w.mb]):
            ls = np.zeros(64, np.int64)
            ls[T.ZIGZAG8] = s8[0 if intra else 1]
            return ls * T.NORM8[qp % 6], qp, True
        if cat in (3, 4):
            comp = self.comp
            qpc = int(T.CHROMA_QP[min(max(qp + w.h.pps[("chroma_qp_index_offset", "second_chroma_qp_index_offset")[comp]],
                                              0), 51)])
            lst = s4[(1 if intra else 4) + comp]
            qp = qpc
        else:
            lst = s4[0 if intra else 3]
        ls = np.zeros(16, np.int64)
        ls[T.ZIGZAG4] = lst
        return ls * T.NORM4[qp % 6], qp, False

    def _levels(self, n, density):
        cfg = self.cfg
        c = np.zeros(n, np.int64)
        mask = self.rng.random(n) < density
        mags = self.rng.integers(1, cfg["level"] + 1, n)
        mags = np.where(self.rng.random(n) < 0.7, 1, mags)
        c[mask] = (mags * np.where(self.rng.random(n) < 0.5, -1, 1))[mask]
        return c

    def c_coeffs(self, w, cat, n, where):
        kind = where[0]
        if kind in ("cdc", "cac"):
            self.comp = where[1]
        if kind == "l4" and w.pic.t8[w.mb] and not w.cabac:  # CAVLC 8x8: four interleaved scans
            k = where[1] >> 2
            if ("l8", k) not in self.cache:
                self.cache[("l8", k)] = self._block(w, 5, 64)
            full = self.cache[("l8", k)]
            return [int(full[4 * i + (where[1] & 3)]) for i in range(16)]
        return [int(c) for c in self._block(w, cat, n)]

    def _block(self, w, cat, n):
        density = self.cfg["density"] * (2 if cat in (0, 3) else 1)
        for _ in range(8):
            c = self._levels(n, density)
            if not c.any():
                c[int(self.rng.integers(0, n))] = 1 if self.r() < 0.5 else -1
            ls, qp, eight = self._scale(w, cat)
            if cat == 5 or n == 64:
                raster = np.zeros(64, np.int64)
                raster[T.ZIGZAG8] = c
                bound = _dequant_bound(raster, ls, qp, True)
            elif cat in (0, 3):
                bound = int(np.abs(c).sum()) * int(ls[0]) << max(qp // 6, 0)
                bound >>= 4 if cat == 0 else 5
                bound *= 2
            else:
                raster = np.zeros(16, np.int64)
                pos = T.ZIGZAG4[1:] if n == 15 else T.ZIGZAG4
                raster[pos] = c
                bound = _dequant_bound(raster, ls, qp, False)
            if bound < 6000:
                return c
            density = density / 2
        c = np.zeros(n, np.int64)
        c[0] = 1
        return c

    def cavlc_write(self, w, table, n, want):
        return cavlc_block(w.io, table, n, want)


# ------------------------------------------------------------------ NAL units and streams


def escape(rbsp: bytes) -> bytes:
    """Emulation prevention: 00 00 0x (x <= 3) -> 00 00 03 0x."""
    out, zeros = bytearray(), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal(ref_idc: int, kind: int, rbsp: bytes) -> bytes:
    return bytes([(ref_idc << 5) | kind]) + escape(rbsp)


def sps_nal(sps: Syntax) -> bytes:
    bw = BitWriter()
    N.sps_syntax(bw, sps)
    bw.trailing()
    return nal(3, N.NAL_SPS, bw.data())


def pps_nal(pps: Syntax, sps_by_id: dict) -> bytes:
    bw = BitWriter()
    N.pps_syntax(bw, pps, sps_by_id)
    bw.trailing()
    return nal(3, N.NAL_PPS, bw.data())


def slice_nal(h: Syntax, nal_type: int, ref_idc: int, sps_by_id, pps_by_id, pic: HP.Picture, index: int,
              chooser: Chooser, last_mb: int) -> bytes:
    """One slice: header and data through the port's syntax, decided by
    ``chooser``, covering macroblocks h.first_mb .. ``last_mb``."""
    bw = BitWriter()
    N.slice_header_syntax(bw, h, nal_type, ref_idc, sps_by_id, pps_by_id)
    chooser.last_mb = last_mb
    chooser.lists = N.scaling_lists(h.sps, h.pps)
    cabac = None
    if h.pps.entropy_coding_mode_flag:
        while bw.n:
            bw.bit(1)
        cabac = CabacWriter(bw)
    walker = HP.SliceWalker(bw, h, pic, index, chooser=chooser, cabac_io=cabac)
    walker.run()
    if cabac is None:
        bw.trailing()
    else:
        while bw.n:
            bw.bit(0)
    return nal(ref_idc, nal_type, bw.data())


def annexb(nals: List[bytes]) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + n for n in nals)


def length_prefixed(nals: List[bytes], size: int = 4) -> bytes:
    return b"".join(len(n).to_bytes(size, "big") + n for n in nals)


def avcc(sps_list: List[bytes], pps_list: List[bytes], size: int = 4) -> bytes:
    sps0 = sps_list[0] if sps_list else b"\x67\x42\x00\x1e"
    out = bytearray([1, sps0[1], sps0[2], sps0[3], 0xFC | (size - 1), 0xE0 | len(sps_list)])
    for s in sps_list:
        out += len(s).to_bytes(2, "big") + s
    out.append(len(pps_list))
    for p in pps_list:
        out += len(p).to_bytes(2, "big") + p
    return bytes(out)


# ------------------------------------------------------------------ containers


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, body: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags) + body)


def write_mp4(path, samples: List[bytes], width: int, height: int, config: bytes, fourcc: bytes = b"avc1",
              keyframes: Optional[List[int]] = None, cts: Optional[List[int]] = None, edit: Optional[tuple] = None,
              timescale: int = 12800, delta: int = 512):
    """An MP4 of one H.264 track: ``samples`` (length-prefixed) in decode
    order, ``config`` the avcC body, ``cts`` each sample's composition
    offset in ticks (a ``ctts`` box when given), ``edit`` (media_time,
    segment duration in movie ticks) for one ``elst`` entry."""
    n = len(samples)
    mdat = b"".join(samples)
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2avc1mp41")
    mdat_off = len(ftyp) + 8
    stsd_entry = (bytes(6) + struct.pack(">H", 1) + bytes(16) + struct.pack(">HH", width, height)
                  + struct.pack(">II", 0x480000, 0x480000) + bytes(4) + struct.pack(">H", 1) + bytes(32)
                  + struct.pack(">Hh", 24, -1) + _box(b"avcC", config))
    stbl = _full(b"stsd", 0, 0, struct.pack(">I", 1) + _box(fourcc, stsd_entry))
    stbl += _full(b"stts", 0, 0, struct.pack(">III", 1, n, delta))
    if cts is not None:
        runs = []
        for c in cts:
            if runs and runs[-1][1] == c:
                runs[-1][0] += 1
            else:
                runs.append([1, c])
        stbl += _full(b"ctts", 0, 0, struct.pack(">I", len(runs)) + b"".join(struct.pack(">II", a, b) for a, b in runs))
    if keyframes is not None:
        stbl += _full(b"stss", 0, 0, struct.pack(">I", len(keyframes)) + b"".join(struct.pack(">I", k + 1)
                                                                             for k in keyframes))
    stbl += _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stbl += _full(b"stsz", 0, 0, struct.pack(">II", 0, n) + b"".join(struct.pack(">I", len(s)) for s in samples))
    stbl += _full(b"stco", 0, 0, struct.pack(">II", 1, mdat_off))
    duration = n * delta
    minf = _box(b"minf", _full(b"vmhd", 0, 1, bytes(8)) + _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1)
                                                                             + _full(b"url ", 0, 1, b"")))
                + _box(b"stbl", stbl))
    mdia = _box(b"mdia", _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, timescale, duration, 0x55C4, 0))
                + _full(b"hdlr", 0, 0, bytes(4) + b"vide" + bytes(12) + b"VideoHandler\x00") + minf)
    movie_ts = 1000
    mdur = duration * movie_ts // timescale
    tkhd = _full(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, mdur) + bytes(8) + struct.pack(">hhhH", 0, 0, 0, 0)
                 + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
                 + struct.pack(">II", width << 16, height << 16))
    trak_body = tkhd
    if edit is not None:
        media_time, seg = edit
        trak_body += _box(b"edts", _full(b"elst", 0, 0, struct.pack(">IIiHH", 1, seg, media_time, 1, 0)))
    trak = _box(b"trak", trak_body + mdia)
    mvhd = _full(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, movie_ts, mdur) + struct.pack(">IH", 0x10000, 0x100)
                 + bytes(10) + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000) + bytes(24)
                 + struct.pack(">I", 2))
    moov = _box(b"moov", mvhd + trak)
    with open(path, "wb") as f:
        f.write(ftyp + struct.pack(">I", 8 + len(mdat)) + b"mdat" + mdat + moov)


def write_avi(path, samples: List[bytes], width: int, height: int, fourcc: bytes = b"H264", fps: int = 25):
    """An AVI 1.0 of Annex B samples (``00dc`` chunks, ``idx1``)."""
    movi = bytearray()
    idx = bytearray()
    for i, s in enumerate(samples):
        off = len(movi) + 4
        movi += b"00dc" + struct.pack("<I", len(s)) + s + (b"\x00" if len(s) % 2 else b"")
        idx += b"00dc" + struct.pack("<III", 0x10 if i == 0 else 0, off, len(s))
    avih = struct.pack("<IIIIIIIIII", 1000000 // fps, 0, 0, 0x10, len(samples), 0, 1, max(len(s) for s in samples),
                       width, height) + bytes(16)
    strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", fourcc, 0, 0, 0, 0, 1, fps, 0, len(samples),
                       max(len(s) for s in samples), -1, 0, 0, 0, width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, fourcc, width * height * 3, 0, 0, 0, 0)

    def chunk(kind, body):
        return kind + struct.pack("<I", len(body)) + body + (b"\x00" if len(body) % 2 else b"")

    def lst(kind, body):
        return b"LIST" + struct.pack("<I", len(body) + 4) + kind + body

    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    body = b"AVI " + hdrl + lst(b"movi", bytes(movi)) + chunk(b"idx1", bytes(idx))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


# ------------------------------------------------------------------ a simple stream


def make_sps(**kw) -> Syntax:
    s = Syntax(profile_idc=66, constraint_flags=0xC0, level_idc=40, sps_id=0, log2_max_frame_num=8,
               pic_order_cnt_type=2, max_num_ref_frames=1, gaps_in_frame_num_value_allowed_flag=0, mb_width=11,
               mb_height=9, frame_mbs_only_flag=1, direct_8x8_inference_flag=1, frame_cropping_flag=0,
               vui_parameters_present_flag=0, chroma_format_idc=1, bit_depth_luma_minus8=0,
               bit_depth_chroma_minus8=0, qpprime_y_zero_transform_bypass_flag=0, seq_scaling_matrix_present_flag=0)
    s.update(kw)
    return s


def make_pps(**kw) -> Syntax:
    p = Syntax(pps_id=0, sps_id=0, entropy_coding_mode_flag=0, bottom_field_pic_order_in_frame_present_flag=0,
               num_slice_groups_minus1=0, num_ref_idx_default=[1, 1], weighted_pred_flag=0, weighted_bipred_idc=0,
               pic_init_qp=26, pic_init_qs=26, chroma_qp_index_offset=0, deblocking_filter_control_present_flag=1,
               constrained_intra_pred_flag=0, redundant_pic_cnt_present_flag=0)
    p.update(kw)
    return p


class StreamWriter:
    """Writes pictures of one stream: parameter sets held by id, each
    picture's slices through :func:`slice_nal`."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.sps: Dict[int, Syntax] = {}
        self.pps: Dict[int, Syntax] = {}

    def add_sps(self, sps: Syntax) -> bytes:
        self.sps[sps.sps_id] = sps
        return sps_nal(sps)

    def add_pps(self, pps: Syntax) -> bytes:
        self.pps[pps.pps_id] = pps
        return pps_nal(pps, self.sps)

    def picture(self, header: dict, nal_type: int, ref_idc: int, cfg: Optional[dict] = None,
                slices: Optional[List[int]] = None, headers: Optional[List[dict]] = None) -> List[bytes]:
        """The slice NAL units of one picture; ``slices`` the first macroblock
        of each slice; ``headers`` per-slice header overrides."""
        pps = self.pps[header.get("pps_id", 0)]
        sps = self.sps[pps.sps_id]
        pic = HP.Picture(sps.mb_width, sps.mb_height)
        starts = slices or [0]
        out = []
        for k, first in enumerate(starts):
            last = (starts[k + 1] if k + 1 < len(starts) else pic.n) - 1
            h = Syntax(header)
            if headers:
                h.update(headers[k])
            h.first_mb = first
            chooser = Chooser(self.rng, cfg)
            out.append(slice_nal(h, nal_type, ref_idc, self.sps, self.pps, pic, k, chooser, last))
        return out
