"""VP8 lossy decoding without cv2: libwebp's decoder (``vp8_dec.c``,
``tree_dec.c``, ``quant_dec.c``, ``frame_dec.c``, ``dsp/dec.c``) and its
fancy YUV 4:2:0 -> BGR output (``dsp/upsampling.c``, ``dsp/yuv.h``), as cv2
5.0.0 reads a lossy WebP through ``WebPDecodeBGRInto``; bit for bit
(``tests/test_torch_image_formats.py``).

* the boolean decoder; the key-frame header (colour space, clamping,
  segments with their quantiser and filter deltas and tree probabilities,
  the loop-filter header with reference and mode deltas, token
  partitions, quantisers, the token probability updates of RFC 6386's
  ``coeff_update_probs`` over ``default_coef_probs``, the skip probability);
* intra modes: 16x16 (DC, V, H, TM, with libwebp's DC variants at the
  image's top and left edges), 4x4 (ten modes over ``kBModesProba``) and
  chroma; the border samples libwebp assumes (127 above the image, 129 to
  its left), the top-right samples of a 4x4 block taken from the macroblock
  above-right (replicated on the last column and below);
* tokens with their band and context probabilities, dequantised as they
  are read; the inverse WHT of the 16x16 DC block and the 4x4 inverse DCT
  in libwebp's integer arithmetic (``MUL1`` / ``MUL2``);
* the simple and normal loop filters, macroblock after macroblock in
  raster order (intra prediction reads the unfiltered samples); each
  macroblock's edges read pixels the macroblock to its left and the one
  above-right changed, so the filter runs over wavefronts ``x + 2 y`` and
  vectorises within one;
* the fancy upsampler (chroma interpolated 9:3:3:1 between the two nearest
  rows and columns, the edges replicated) and libwebp's 14-bit YUV -> RGB
  constants.

The tables (default and update token probabilities, 4x4 mode
probabilities, quantiser steps) are RFC 6386's.
"""

from __future__ import annotations

import numpy as np


class VP8Error(ValueError):
    pass


_UPDATE_PROBA = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffffdff1fcffffff"
    "fffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffffffffffff"
    "f6feffffffffffffffffeffdfefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffbfffeffffffff"
    "fffffffffffffffffffffffffffffffffdfefffffffffffffffffbfefefffffffffffffffffefffefffffffffffffffffffe"
    "fdfffefffffffffffffafffefffefffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeff"
    "ffffffffffffffffdffefeffffffffffffffffeefdfefefffffffffffffffff8fefffffffffffffffff9feffffffffffffff"
    "fffffffffffffffffffffffffffffdfffffffffffffffffff7fefffffffffffffffffffffffffffffffffffffffffffdfeff"
    "fffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefefffffffffffffffffdffffffffffffffffff"
    "fffffffffffffffffffffffffffefdfffffffffffffffffafffffffffffffffffffffeffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffbafbfaffffffffffffffffeafbf4feffffffffffffff"
    "fbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfefffffffffffffffffbfdfdfefefffffffffffffffefeffffff"
    "fffffffffffefefefffffffffffffffffffffffffffffffffffffffffefffffffffffffffffffefefffffffffffffffffffe"
    "fffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff8ffffffffffffff"
    "fffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdfffffffffffffffff6fdfdfffffffffffffffffcfefb"
    "fefefffffffffffffffefcfffffffffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffffffffffff"
    "fffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdfffffffffffffffffcfdfefffffffffffffffffffeffff"
    "fffffffffffffffffcfffffffffffffffffff9fffefffffffffffffffffffffefffffffffffffffffffffdffffffffffffff"
    "fffafffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffff"
    "ffffffffffff")
_COEFF_PROBA0 = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080bd81f2ffe3d5"
    "ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb80808001"
    "b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa8bf1fcecd1ff"
    "ff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3ab80808080800198"
    "fcfff0ff8080808080b187f3ffeae180808080805081d3ffc2e080808080800101ff8080808080808080f601ff8080808080"
    "808080ff80808080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1"
    "ffdde0ffff808080b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca80"
    "8080175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff8080800184effb"
    "dbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9ffe8eb80808080807c8ff1ffe3ea80808080"
    "80234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe08080800101fbffd5"
    "ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff80"
    "4911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadb"
    "ffcd808080c933dbffc4ba8080808080452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080808d"
    "7cf8ffff8080808080800110f8ffff808080808080be24e6ffecff80808080809501ff808080808080808001e2ff80808080"
    "80808080f7c0ff8080808080808080f080ff80808080808080800186fcffff808080808080d53efaffff808080808080375d"
    "ff8080808080808080808080808080808080808080808080808080808080808080808080808080808080ca18d5ebbabfdca0"
    "f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80a66de4fcd3d7ffae808080274da2"
    "e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9dbf0ffe080"
    "80809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3"
    "a4adffcb80808001def8ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080"
    "808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080"
    "808080808080")
_BMODES_PROBA = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150aad791850c31a"
    "3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d102486b7598962656aa59448"
    "bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380684f0c1bd9ff"
    "5711075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b775552623b33d2735"
    "c8571a152be8ab3822336872661d5d4d271c55ab3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24"
    "e1722213156684bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01"
    "c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401"
    "dd333211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af2f0f10b7"
    "22df312db72e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206df572509733b4d40152f"
    "68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a2086271335dd1a722049ff1f0941ea02"
    "0f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd2d25c03726467c49660122627d622a58685575af525f"
    "543559806471652d4b4f7b2f338051ab0139110547663935293126210d7939491a0155290a438a4d6e5a2f727315020a66ff"
    "a61706651d100a558065c41a39120a6666d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25442d"
    "8022012f0bf5ab3e1113469255373e46252b259a64a355a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19"
    "f8013808118489ff3774803a0f145287391a7928a4321f899a851923da33672c83837b1f069e5628408794e02db780161a11"
    "83f09a0e01d12d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404"
    "f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b769274805538290fb0ec5525093e471e1177"
    "76ff11128a65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418")
_DC_TABLE = bytes.fromhex(
    "0405060708090a0a0b0c0d0e0f101111121314141515161617171819191a1b1c1d1e1f20212223242525262728292a2b2c2d"
    "2e2e2f303132333435363738393a3b3c3d3e3f404142434445464748494a4b4c4c4d4e4f505152535455565758595b5d5f60"
    "62646566686a6c6e707274767a7c7e80828486888a8c8f9194979a9d")
_AC_TABLE = bytes.fromhex(
    "0400050006000700080009000a000b000c000d000e000f0010001100120013001400150016001700180019001a001b001c00"
    "1d001e001f0020002100220023002400250026002700280029002a002b002c002d002e002f00300031003200330034003500"
    "36003700380039003a003c003e00400042004400460048004a004c004e00500052005400560058005a005c005e0060006200"
    "6400660068006a006c006e0070007200740077007a007d0080008300860089008c008f009200950098009b009e00a100a400"
    "a700aa00ad00b100b500b900bd00c100c500c900cd00d100d500d900dd00e100e500ea00ef00f500f900fe00030108010d01"
    "120117011c01")

_COEFF_PROBA0 = np.frombuffer(_COEFF_PROBA0, np.uint8).reshape(4, 8, 3, 11)
_UPDATE_PROBA = np.frombuffer(_UPDATE_PROBA, np.uint8).reshape(4, 8, 3, 11)
_BMODES_PROBA = np.frombuffer(_BMODES_PROBA, np.uint8).reshape(10, 10, 9).tolist()
_DC_TABLE = np.frombuffer(_DC_TABLE, np.uint8).astype(np.int32)
_AC_TABLE = np.frombuffer(_AC_TABLE, "<u2").astype(np.int32)

_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# 4x4 modes; 16x16 and chroma modes share the first four numbers
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
_NORM = [0] + [7 - (r.bit_length() - 1) for r in range(1, 256)]


class _Bool:
    """The boolean entropy decoder (RFC 6386 section 7); zeros past the
    end, as libwebp feeds them."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end
        self.value, self.bits = 0, 0
        self.range = 255
        self._fill()

    def _fill(self):
        k = min(4, self.end - self.pos)
        chunk = self.data[self.pos:self.pos + k] if k > 0 else b""
        self.pos += max(k, 0)
        self.value = (self.value << 32) | int.from_bytes(chunk.ljust(4, b"\0"), "big")
        self.bits += 32

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.bits < 16:
            self._fill()
        big = split << (self.bits - 8)
        if self.value >= big:
            self.range -= split
            self.value -= big
            b = 1
        else:
            self.range = split
            b = 0
        shift = _NORM[self.range]
        self.range <<= shift
        self.bits -= shift
        return b

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(128) else v


class _Frame:
    pass


def _headers(data: bytes) -> _Frame:
    if len(data) < 10:
        raise VP8Error("VP8 frame too short")
    tag = data[0] | (data[1] << 8) | (data[2] << 16)
    if tag & 1:
        raise VP8Error("VP8 interframe in a WebP (key frames only)")
    if (tag >> 1) & 7 > 3:
        raise VP8Error(f"VP8 profile {(tag >> 1) & 7}")
    part0 = tag >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise VP8Error("VP8 key frame without its start code")
    f = _Frame()
    f.width = (data[6] | (data[7] << 8)) & 0x3FFF
    f.height = (data[8] | (data[9] << 8)) & 0x3FFF
    if f.width == 0 or f.height == 0:
        raise VP8Error("VP8 frame of size 0")
    f.mbw, f.mbh = (f.width + 15) >> 4, (f.height + 15) >> 4
    if 10 + part0 > len(data):
        raise VP8Error("VP8 first partition past the data")
    br = _Bool(data, 10, 10 + part0)
    br.bit(128)  # colour space
    br.bit(128)  # clamping type
    f.use_segment = br.bit(128)
    f.update_map = 0
    f.seg_quant, f.seg_filter, f.absolute = [0] * 4, [0] * 4, 0
    f.seg_proba = [255, 255, 255]
    if f.use_segment:
        f.update_map = br.bit(128)
        if br.bit(128):  # update data
            f.absolute = br.bit(128)
            f.seg_quant = [br.signed(7) if br.bit(128) else 0 for _ in range(4)]
            f.seg_filter = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        if f.update_map:
            f.seg_proba = [br.value_bits(8) if br.bit(128) else 255 for _ in range(3)]
    f.simple = br.bit(128)
    f.level = br.value_bits(6)
    f.sharpness = br.value_bits(3)
    f.use_lf_delta = br.bit(128)
    f.ref_delta, f.mode_delta = [0] * 4, [0] * 4
    if f.use_lf_delta and br.bit(128):
        for i in range(4):
            if br.bit(128):
                f.ref_delta[i] = br.signed(6)
        for i in range(4):
            if br.bit(128):
                f.mode_delta[i] = br.signed(6)
    f.filter_type = 0 if f.level == 0 else (1 if f.simple else 2)
    nparts = 1 << br.value_bits(2)
    pos = 10 + part0
    sizes_end = pos + 3 * (nparts - 1)
    if sizes_end > len(data):
        raise VP8Error("VP8 partition sizes past the data")
    f.parts = []
    p = sizes_end
    for i in range(nparts):
        if i < nparts - 1:
            n = data[pos + 3 * i] | (data[pos + 3 * i + 1] << 8) | (data[pos + 3 * i + 2] << 16)
        else:
            n = len(data) - p
        end = min(p + n, len(data))
        f.parts.append(_Bool(data, p, end))
        p = end
    # quantisers
    base = br.value_bits(7)
    dq = [br.signed(4) if br.bit(128) else 0 for _ in range(5)]  # y1_dc, y2_dc, y2_ac, uv_dc, uv_ac
    f.quant = []
    for s in range(4):
        if f.use_segment:
            q = f.seg_quant[s] + (0 if f.absolute else base)
        else:
            q = base
        c = lambda v, m=127: min(max(v, 0), m)  # noqa: E731
        y2ac = (int(_AC_TABLE[c(q + dq[2])]) * 101581) >> 16
        f.quant.append({"y1": (int(_DC_TABLE[c(q + dq[0])]), int(_AC_TABLE[c(q)])),
                        "y2": (int(_DC_TABLE[c(q + dq[1])]) * 2, max(y2ac, 8)),
                        "uv": (int(_DC_TABLE[c(q + dq[3], 117)]), int(_AC_TABLE[c(q + dq[4])]))})
    br.bit(128)  # refresh entropy probabilities (ignored on a key frame)
    upd = _UPDATE_PROBA.reshape(-1).tolist()
    proba = _COEFF_PROBA0.reshape(-1).tolist()
    for i in range(len(proba)):
        if br.bit(upd[i]):
            proba[i] = br.value_bits(8)
    bands = np.array(proba, np.int64).reshape(4, 8, 3, 11)
    # per type, per coefficient position n (0..16): the band's 3 contexts of 11 probabilities
    f.proba = [[bands[t, _BANDS[n]].tolist() for n in range(17)] for t in range(4)]
    f.use_skip = br.bit(128)
    f.skip_p = br.value_bits(8) if f.use_skip else 0
    f.br = br
    return f


def _modes(f: _Frame):
    """Per macroblock (raster order): segment, skip, is_i4x4, 16 luma modes
    (4x4 raster order; one repeated for 16x16), chroma mode."""
    br = f.br
    out = []
    top = [B_DC] * (4 * f.mbw)
    for mby in range(f.mbh):
        left = [B_DC] * 4
        for mbx in range(f.mbw):
            seg = 0
            if f.update_map:
                p = f.seg_proba
                seg = br.bit(p[1]) if not br.bit(p[0]) else br.bit(p[2]) + 2
            skip = br.bit(f.skip_p) if f.use_skip else 0
            i4 = not br.bit(145)
            t = top[4 * mbx:4 * mbx + 4]
            if not i4:
                if br.bit(156):
                    ym = B_TM if br.bit(128) else B_HE
                else:
                    ym = B_VE if br.bit(163) else B_DC
                modes = [ym] * 16
                t[:] = [ym] * 4
                left = [ym] * 4
            else:
                modes = [0] * 16
                for y in range(4):
                    ym = left[y]
                    for x in range(4):
                        prob = _BMODES_PROBA[t[x]][ym]
                        if not br.bit(prob[0]):
                            ym = B_DC
                        elif not br.bit(prob[1]):
                            ym = B_TM
                        elif not br.bit(prob[2]):
                            ym = B_VE
                        elif not br.bit(prob[3]):
                            if not br.bit(prob[4]):
                                ym = B_HE
                            else:
                                ym = B_VR if br.bit(prob[5]) else B_RD
                        elif not br.bit(prob[6]):
                            ym = B_LD
                        elif not br.bit(prob[7]):
                            ym = B_VL
                        else:
                            ym = B_HU if br.bit(prob[8]) else B_HD
                        t[x] = ym
                        modes[4 * y + x] = ym
                    left[y] = ym
            top[4 * mbx:4 * mbx + 4] = t
            if not br.bit(142):
                uvm = B_DC
            elif not br.bit(114):
                uvm = B_VE
            else:
                uvm = B_TM if br.bit(183) else B_HE
            out.append((seg, skip, i4, modes, uvm))
    return out


def _large(br: _Bool, p) -> int:
    if not br.bit(p[3]):
        if not br.bit(p[4]):
            return 2
        return 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        return 7 + 2 * br.bit(165) + br.bit(145)
    bit1 = br.bit(p[8])
    bit0 = br.bit(p[9 + bit1])
    cat = 2 * bit1 + bit0
    v = 0
    for prob in _CAT[cat]:
        v += v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _Bool, prob, ctx: int, dq, n: int, out, base: int) -> int:
    """GetCoeffs: tokens of one block into ``out[base:base + 16]``
    (dequantised, natural order); the position after the last non-zero."""
    p = prob[n][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = prob[n][0]
        if not br.bit(p[2]):
            v = 1
            p = prob[n + 1][1]
        else:
            v = _large(br, p)
            p = prob[n + 1][2]
        if br.bit(128):
            v = -v
        out[base + _ZIGZAG[n]] = v * dq[1 if n > 0 else 0]
        n += 1
    return 16


def _wht(dc):
    """The inverse Walsh-Hadamard transform of the 16 second-order DCs ->
    the DC of each 4x4 block (raster order)."""
    tmp = [0] * 16
    for i in range(4):
        a0 = dc[i] + dc[12 + i]
        a1 = dc[4 + i] + dc[8 + i]
        a2 = dc[4 + i] - dc[8 + i]
        a3 = dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0 = d + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = d - tmp[4 * i + 3]
        out[4 * i], out[4 * i + 1], out[4 * i + 2], out[4 * i + 3] = (a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, \
            (a3 - a2) >> 3
    return out


def _residuals(f: _Frame, modes):
    """Tokens of every macroblock -> (coefficients (n_mb, 24, 16) int32,
    whether libwebp counts the macroblock's residual non-zero: a block
    whose tokens end past position 1, or whose DC is not 0)."""
    n_mb = f.mbw * f.mbh
    coeffs = np.zeros((n_mb, 384), np.int32)
    nonzero = np.zeros(n_mb, bool)
    top_nz = [0] * f.mbw  # bits 0-3 luma columns, 4-5 U, 6-7 V
    top_dc = [0] * f.mbw
    proba = f.proba
    for mby in range(f.mbh):
        br = f.parts[mby & (len(f.parts) - 1)]
        left_nz, left_dc = 0, 0
        for mbx in range(f.mbw):
            k = mby * f.mbw + mbx
            seg, skip, i4, _, _ = modes[k]
            if f.use_skip and skip:
                left_nz = top_nz[mbx] = 0
                if not i4:
                    left_dc = top_dc[mbx] = 0
                continue
            q = f.quant[seg]
            out = [0] * 384
            any_nz = False
            if not i4:
                dc = [0] * 16
                nz = _coeffs(br, proba[1], top_dc[mbx] + left_dc, q["y2"], 0, dc, 0)
                top_dc[mbx] = left_dc = int(nz > 0)
                if nz > 1:
                    dcs = _wht(dc)
                else:
                    dcs = [(dc[0] + 3) >> 3] * 16
                for b in range(16):
                    out[16 * b] = dcs[b]
                first, ac = 1, proba[0]
            else:
                first, ac = 0, proba[3]
            tnz, lnz = top_nz[mbx] & 15, left_nz & 15
            new_t, new_l = 0, 0
            for y in range(4):
                lb = (lnz >> y) & 1
                for x in range(4):
                    tb = (tnz >> x) & 1 if y == 0 else (new_t >> x) & 1
                    base = 16 * (4 * y + x)
                    nz = _coeffs(br, ac, lb + tb, q["y1"], first, out, base)
                    lb = int(nz > first)
                    new_t = (new_t & ~(1 << x)) | (lb << x)
                    any_nz = any_nz or nz > 1 or out[base] != 0
                new_l |= lb << y
            t_out, l_out = new_t, new_l
            for ch in (0, 2):
                tnz_c, lnz_c = (top_nz[mbx] >> (4 + ch)) & 3, (left_nz >> (4 + ch)) & 3
                new_tc, new_lc = 0, 0
                for y in range(2):
                    lb = (lnz_c >> y) & 1
                    for x in range(2):
                        tb = (tnz_c >> x) & 1 if y == 0 else (new_tc >> x) & 1
                        blk = 16 + 2 * ch + 2 * y + x
                        nz = _coeffs(br, proba[2], lb + tb, q["uv"], 0, out, 16 * blk)
                        lb = int(nz > 0)
                        new_tc = (new_tc & ~(1 << x)) | (lb << x)
                        any_nz = any_nz or nz > 1 or out[16 * blk] != 0
                    new_lc |= lb << y
                t_out |= new_tc << (4 + ch)
                l_out |= new_lc << (4 + ch)
            top_nz[mbx], left_nz = t_out, l_out
            coeffs[k] = out
            nonzero[k] = any_nz
    return coeffs.reshape(n_mb, 24, 16), nonzero


def _idct(c: np.ndarray) -> np.ndarray:
    """(..., 16) dequantised coefficients (raster) -> (..., 4, 4) residuals
    (``TransformOne``'s value before the ``>> 3`` store, shifted)."""
    c = c.astype(np.int64).reshape(c.shape[:-1] + (4, 4))

    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    # vertical pass: along each column
    i0, i1, i2, i3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    a, b = i0 + i2, i0 - i2
    cc, d = mul2(i1) - mul1(i3), mul1(i1) + mul2(i3)
    t = np.stack([a + d, b + cc, b - cc, a - d], -2)  # t[..., row k, column]
    # horizontal pass: along each row
    j0, j1, j2, j3 = t[..., :, 0], t[..., :, 1], t[..., :, 2], t[..., :, 3]
    dc = j0 + 4
    a, b = dc + j2, dc - j2
    cc, d = mul2(j1) - mul1(j3), mul1(j1) + mul2(j3)
    return (np.stack([a + d, b + cc, b - cc, a - d], -1) >> 3).astype(np.int32)


# ------------------------------------------------------------------ prediction


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, top, left, tl):
    """One 4x4 prediction: ``top`` the 8 samples above (4 above-right
    included), ``left`` the 4 to the left, ``tl`` the corner; Python ints
    -> 4 rows of 4."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    if mode == B_DC:
        v = (A + B + C + D + I + J + K + L + 4) >> 3
        return [[v] * 4] * 4
    if mode == B_TM:
        return [[min(max(t + l - X, 0), 255) for t in (A, B, C, D)] for l in (I, J, K, L)]
    if mode == B_VE:
        r = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [r] * 4
    if mode == B_HE:
        return [[_avg3(X, I, J)] * 4, [_avg3(I, J, K)] * 4, [_avg3(J, K, L)] * 4, [_avg3(K, L, L)] * 4]
    d = [[0] * 4 for _ in range(4)]
    if mode == B_RD:
        vals = {0: _avg3(A, X, I), 1: _avg3(B, A, X), 2: _avg3(C, B, A), 3: _avg3(D, C, B), -1: _avg3(X, I, J),
                -2: _avg3(I, J, K), -3: _avg3(J, K, L)}
        for y in range(4):
            for x in range(4):
                d[y][x] = vals[x - y]
        return d
    if mode == B_LD:
        seq = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F), _avg3(E, F, G), _avg3(F, G, H),
               _avg3(G, H, H)]
        return [[seq[x + y] for x in range(4)] for y in range(4)]
    if mode == B_VR:
        d[0] = [_avg2(X, A), _avg2(A, B), _avg2(B, C), _avg2(C, D)]
        d[1] = [_avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D)]
        d[2] = [_avg3(J, I, X), d[0][0], d[0][1], d[0][2]]
        d[3] = [_avg3(K, J, I), d[1][0], d[1][1], d[1][2]]
        return d
    if mode == B_VL:
        d[0] = [_avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E)]
        d[1] = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F)]
        d[2] = [d[0][1], d[0][2], d[0][3], _avg3(E, F, G)]
        d[3] = [d[1][1], d[1][2], d[1][3], _avg3(F, G, H)]
        return d
    if mode == B_HD:
        d[0] = [_avg2(I, X), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)]
        d[1] = [_avg2(J, I), _avg3(J, I, X), d[0][0], d[0][1]]
        d[2] = [_avg2(K, J), _avg3(K, J, I), d[1][0], d[1][1]]
        d[3] = [_avg2(L, K), _avg3(L, K, J), d[2][0], d[2][1]]
        return d
    if mode == B_HU:
        d[0] = [_avg2(I, J), _avg3(I, J, K), _avg2(J, K), _avg3(J, K, L)]
        d[1] = [_avg2(J, K), _avg3(J, K, L), _avg2(K, L), _avg3(K, L, L)]
        d[2] = [_avg2(K, L), _avg3(K, L, L), L, L]
        d[3] = [L, L, L, L]
        return d
    raise VP8Error(f"VP8 4x4 mode {mode}")


def _pred_block(mode: int, n: int, top: np.ndarray, left: np.ndarray, tl: int, mbx: int, mby: int) -> np.ndarray:
    """A 16x16 luma (n 16) or 8x8 chroma (n 8) prediction, DC by libwebp's
    edge variants."""
    if mode == B_DC:
        if mbx == 0 and mby == 0:
            v = 128
        elif mby == 0:
            v = (int(left.sum()) + n // 2) >> (4 if n == 16 else 3)
        elif mbx == 0:
            v = (int(top.sum()) + n // 2) >> (4 if n == 16 else 3)
        else:
            v = (int(top.sum()) + int(left.sum()) + n) >> (5 if n == 16 else 4)
        return np.full((n, n), v, np.int32)
    if mode == B_TM:
        return np.clip(top[None, :].astype(np.int32) + left[:, None] - tl, 0, 255)
    if mode == B_VE:
        return np.broadcast_to(top[None, :].astype(np.int32), (n, n))
    if mode == B_HE:
        return np.broadcast_to(left[:, None].astype(np.int32), (n, n))
    raise VP8Error(f"VP8 macroblock mode {mode}")


def _reconstruct(f: _Frame, modes, resid: np.ndarray):
    """Intra prediction plus residual, macroblock by macroblock (unfiltered
    neighbours) -> (Y, U, V) planes of whole macroblocks."""
    mbw, mbh = f.mbw, f.mbh
    Y = np.zeros((16 * mbh, 16 * mbw), np.int32)
    U = np.zeros((8 * mbh, 8 * mbw), np.int32)
    V = np.zeros((8 * mbh, 8 * mbw), np.int32)
    for mby in range(mbh):
        for mbx in range(mbw):
            k = mby * mbw + mbx
            _, _, i4, ymodes, uvm = modes[k]
            y0, x0 = 16 * mby, 16 * mbx
            # the borders libwebp gives a macroblock
            top = Y[y0 - 1, x0:x0 + 16] if mby else np.full(16, 127, np.int32)
            left = Y[y0:y0 + 16, x0 - 1] if mbx else np.full(16, 129, np.int32)
            if mby == 0:
                tl = 127
            else:
                tl = int(Y[y0 - 1, x0 - 1]) if mbx else 129
            r = resid[k]
            if not i4:
                pred = _pred_block(ymodes[0], 16, top, left, tl, mbx, mby)
                res = r[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + res, 0, 255)
            else:
                if mby == 0:
                    tr = [127] * 4
                elif mbx == mbw - 1:
                    tr = [int(Y[y0 - 1, x0 + 15])] * 4
                else:
                    tr = Y[y0 - 1, x0 + 16:x0 + 20].tolist()
                blk = np.zeros((20, 21), np.int64)  # rows -1..15 (+pad), columns -1..19
                blk[0, 1:17] = top
                blk[0, 17:21] = tr
                blk[0, 0] = tl
                blk[1:17, 0] = left
                for rr in (4, 8, 12):  # top-right replicated for the last column's lower blocks
                    blk[rr, 17:21] = tr
                rl = r[:16].tolist()
                for n in range(16):
                    by, bx = n >> 2, n & 3
                    ry, rx = 4 * by + 1, 4 * bx + 1
                    topv = blk[ry - 1, rx:rx + 8].tolist()
                    leftv = blk[ry:ry + 4, rx - 1].tolist()
                    p = _pred4(ymodes[n], topv, leftv, int(blk[ry - 1, rx - 1]))
                    res = rl[n]
                    for yy in range(4):
                        row = p[yy]
                        rrow = res[yy]
                        blk[ry + yy, rx:rx + 4] = [min(max(row[i] + rrow[i], 0), 255) for i in range(4)]
                Y[y0:y0 + 16, x0:x0 + 16] = blk[1:17, 1:17]
            c0, cx = 8 * mby, 8 * mbx
            for plane, off in ((U, 16), (V, 20)):
                ctop = plane[c0 - 1, cx:cx + 8] if mby else np.full(8, 127, np.int32)
                cleft = plane[c0:c0 + 8, cx - 1] if mbx else np.full(8, 129, np.int32)
                if mby == 0:
                    ctl = 127
                else:
                    ctl = int(plane[c0 - 1, cx - 1]) if mbx else 129
                pred = _pred_block(uvm, 8, ctop, cleft, ctl, mbx, mby)
                res = r[off:off + 4].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
                plane[c0:c0 + 8, cx:cx + 8] = np.clip(pred + res, 0, 255)
    return Y, U, V


# ------------------------------------------------------------------ loop filter


def _strengths(f: _Frame):
    """libwebp's ``PrecomputeFilterStrengths``: per (segment, is_i4x4)
    (limit, interior limit, hev threshold)."""
    out = {}
    for s in range(4):
        if f.use_segment:
            base = f.seg_filter[s] + (0 if f.absolute else f.level)
        else:
            base = f.level
        for i4 in (0, 1):
            level = base
            if f.use_lf_delta:
                level += f.ref_delta[0]
                if i4:
                    level += f.mode_delta[0]
            level = min(max(level, 0), 63)
            if level > 0:
                ilevel = level
                if f.sharpness > 0:
                    ilevel >>= 2 if f.sharpness > 4 else 1
                    ilevel = min(ilevel, 9 - f.sharpness)
                ilevel = max(ilevel, 1)
                out[s, i4] = (2 * level + ilevel, ilevel, 2 if level >= 40 else 1 if level >= 15 else 0)
            else:
                out[s, i4] = (0, 0, 0)
    return out


def _sclip1(x):
    return np.clip(x, -128, 127)


def _sclip2(x):
    return np.clip(x, -16, 15)


def _filter(px: np.ndarray, thresh2, ithresh, hev_t, kind: str):
    """px: (n, 8) int32 samples p3 p2 p1 p0 q0 q1 q2 q3 across an edge;
    per-line thresholds (n,). kind: "simple", "edge" (FilterLoop26) or
    "inner" (FilterLoop24). Returns the filtered samples."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (px[:, i] for i in range(8))
    out = px.copy()
    need = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= thresh2
    if kind == "simple":
        f2 = need
    else:
        need &= ((np.abs(p3 - p2) <= ithresh) & (np.abs(p2 - p1) <= ithresh) & (np.abs(p1 - p0) <= ithresh)
                 & (np.abs(q3 - q2) <= ithresh) & (np.abs(q2 - q1) <= ithresh) & (np.abs(q1 - q0) <= ithresh))
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
        f2 = need & hev
        rest = need & ~hev
        if kind == "edge":
            a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
            a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
            for i, v in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1), (4, q0 - a1), (5, q1 - a2), (6, q2 - a3)):
                out[:, i] = np.where(rest, np.clip(v, 0, 255), out[:, i])
        else:
            a = 3 * (q0 - p0)
            a1 = _sclip2((a + 4) >> 3)
            a2 = _sclip2((a + 3) >> 3)
            a3 = (a1 + 1) >> 1
            for i, v in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1), (5, q1 - a3)):
                out[:, i] = np.where(rest, np.clip(v, 0, 255), out[:, i])
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    out[:, 3] = np.where(f2, np.clip(p0 + a2, 0, 255), out[:, 3])
    out[:, 4] = np.where(f2, np.clip(q0 - a1, 0, 255), out[:, 4])
    return out


def _apply(plane: np.ndarray, rows: np.ndarray, cols: np.ndarray, vertical: bool, th, it, hv, kind):
    """Filter the edges at (rows, cols): for a vertical edge (``vertical``
    False: pixels left and right of ``cols``) or a horizontal one."""
    off = np.arange(-4, 4)
    if vertical:  # across a horizontal edge: samples above and below
        r = rows[:, None] + off[None, :]
        c = np.broadcast_to(cols[:, None], r.shape)
    else:
        c = cols[:, None] + off[None, :]
        r = np.broadcast_to(rows[:, None], c.shape)
    plane[r, c] = _filter(plane[r, c], th, it, hv, kind)


def _loop_filter(f: _Frame, modes, nonzero, Y, U, V):
    """libwebp's ``DoFilter`` over every macroblock in raster order, run as
    wavefronts t = x + 2 y (a macroblock's edges read what its left and
    above-right neighbours wrote, and nothing later writes)."""
    if f.filter_type == 0:
        return
    st = _strengths(f)
    mbw, mbh = f.mbw, f.mbh
    n = mbw * mbh
    limit = np.zeros(n, np.int64)
    ilev = np.zeros(n, np.int64)
    hevt = np.zeros(n, np.int64)
    inner = np.zeros(n, bool)
    for k, (seg, _, i4, _, _) in enumerate(modes):
        limit[k], ilev[k], hevt[k] = st[seg, int(i4)]
        inner[k] = bool(i4) or bool(nonzero[k])
    mx = np.arange(n) % mbw
    my = np.arange(n) // mbw
    wave = mx + 2 * my
    lines16, lines8 = np.arange(16), np.arange(8)
    for t in range(int(wave.max()) + 1):
        sel = np.nonzero((wave == t) & (limit > 0))[0]
        if len(sel) == 0:
            continue
        planes = [(Y, 16, lines16)] if f.filter_type == 1 else [(Y, 16, lines16), (U, 8, lines8), (V, 8, lines8)]
        for plane, size, lines in planes:
            x0, y0 = mx[sel] * size, my[sel] * size

            def per_line(v):
                return np.repeat(v, size)

            for vertical in (False, True):
                # the macroblock edge, if any, then the inner edges
                has_edge = (my[sel] > 0) if vertical else (mx[sel] > 0)
                for step, which in [(0, has_edge)] + [(s, inner[sel]) for s in range(4, size, 4)]:
                    m = which
                    if not m.any():
                        continue
                    k_sel = sel[m]
                    lim = limit[k_sel] + (4 if step == 0 else 0)
                    th = per_line(2 * lim + 1)
                    it, hv = per_line(ilev[k_sel]), per_line(hevt[k_sel])
                    if vertical:
                        rows = per_line(y0[m] + step)
                        cols = (x0[m][:, None] + lines[None, :]).reshape(-1)
                    else:
                        cols = per_line(x0[m] + step)
                        rows = (y0[m][:, None] + lines[None, :]).reshape(-1)
                    kind = "simple" if f.filter_type == 1 else ("edge" if step == 0 else "inner")
                    _apply(plane, rows, cols, vertical, th, it, hv, kind)


# ------------------------------------------------------------------ output


def _fancy_rows(c: np.ndarray, h: int) -> tuple:
    """For each output row: (near chroma row, far chroma row) as libwebp's
    ``EmitFancyRGB`` pairs them (weights 3 and 1)."""
    r = np.arange(h)
    k = (r + 1) // 2  # odd rows: top chroma k-1 (near), bottom k; even rows >= 2: near k, far k-1
    near = np.where(r % 2 == 1, k - 1, k)
    far = np.where(r % 2 == 1, k, k - 1)
    far = np.where(r == 0, 0, far)
    near = np.where(r == 0, 0, near)
    last = c.shape[0] - 1
    return np.minimum(near, last), np.minimum(far, last)


def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """(ceil(h/2), ceil(w/2)) chroma -> (h, w), libwebp's fancy upsampler."""
    c = c.astype(np.int32)
    near, far = _fancy_rows(c, h)
    t = c[far]   # the other row of the pair (weight 1)
    n = c[near]  # the near row (weight 3)
    # columns: pixel 0 and (for even w) the last from their own column; the
    # pairs (2x-1, 2x) between columns x-1 and x
    out = np.empty((h, w), np.int32)
    out[:, 0] = (3 * n[:, 0] + t[:, 0] + 2) >> 2
    last_pair = (w - 1) >> 1
    if last_pair >= 1:
        tl, tt = t[:, :last_pair], t[:, 1:last_pair + 1]  # far row: columns x-1, x
        ll, uu = n[:, :last_pair], n[:, 1:last_pair + 1]  # near row: columns x-1, x
        avg = tl + tt + ll + uu + 8
        diag_12 = (avg + 2 * (tt + ll)) >> 3
        diag_03 = (avg + 2 * (tl + uu)) >> 3
        out[:, 1:2 * last_pair:2] = (diag_03 + ll) >> 1
        out[:, 2:2 * last_pair + 1:2] = (diag_12 + uu) >> 1
    if w % 2 == 0:
        j = c.shape[1] - 1
        out[:, w - 1] = (3 * n[:, j] + t[:, j] + 2) >> 2
    return out


def _yuv_to_bgr(y, u, v) -> np.ndarray:
    def mult_hi(a, coef):
        return (a * coef) >> 8

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))

    y = y.astype(np.int32)
    r = clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234)
    g = clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708)
    b = clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685)
    return np.stack([b, g, r], -1).astype(np.uint8)


def decode_yuv(data: bytes):
    """A VP8 key frame -> (Y, U, V) planes cropped to the picture."""
    f = _headers(data)
    modes = _modes(f)
    coeffs, nonzero = _residuals(f, modes)
    resid = _idct(coeffs)
    Y, U, V = _reconstruct(f, modes, resid)
    _loop_filter(f, modes, nonzero, Y, U, V)
    cw, ch = (f.width + 1) // 2, (f.height + 1) // 2
    return Y[:f.height, :f.width], U[:ch, :cw], V[:ch, :cw]


def decode(data: bytes) -> np.ndarray:
    """A VP8 key frame -> (H, W, 3) uint8 BGR, as ``WebPDecodeBGRInto``."""
    y, u, v = decode_yuv(data)
    h, w = y.shape
    return _yuv_to_bgr(y, _upsample(u, h, w), _upsample(v, h, w))
