"""CCITT bilevel decoding for TIFF (``tif_fax3.c``): Modified Huffman
(TIFF compression 2, each row byte-aligned, no EOL), Group 3 (compression
3: EOL codes, one-dimensional rows or, with T4Options bit 0, rows tagged
1D / 2D; T4Options bit 2 pads each EOL to a byte boundary) and Group 4
(compression 4: two-dimensional rows against the previous one, the first
against an all-white line). Rows come out as (H, W) uint8,
1 for black and 0 for white, the way the bits are stored (0 = white) before
the photometric interpretation is applied."""

from __future__ import annotations

import numpy as np


class CcittError(ValueError):
    pass


# (code bits as a string, run length): T.4 terminating and make-up codes
_WHITE = """00110101 0;000111 1;0111 2;1000 3;1011 4;1100 5;1110 6;1111 7;10011 8;10100 9;00111 10;01000 11;
001000 12;000011 13;110100 14;110101 15;101010 16;101011 17;0100111 18;0001100 19;0001000 20;0010111 21;
0000011 22;0000100 23;0101000 24;0101011 25;0010011 26;0100100 27;0011000 28;00000010 29;00000011 30;
00011010 31;00011011 32;00010010 33;00010011 34;00010100 35;00010101 36;00010110 37;00010111 38;00101000 39;
00101001 40;00101010 41;00101011 42;00101100 43;00101101 44;00000100 45;00000101 46;00001010 47;00001011 48;
01010010 49;01010011 50;01010100 51;01010101 52;00100100 53;00100101 54;01011000 55;01011001 56;01011010 57;
01011011 58;01001010 59;01001011 60;00110010 61;00110011 62;00110100 63;11011 64;10010 128;010111 192;
0110111 256;00110110 320;00110111 384;01100100 448;01100101 512;01101000 576;01100111 640;011001100 704;
011001101 768;011010010 832;011010011 896;011010100 960;011010101 1024;011010110 1088;011010111 1152;
011011000 1216;011011001 1280;011011010 1344;011011011 1408;010011000 1472;010011001 1536;010011010 1600;
011000 1664;010011011 1728"""
_BLACK = """0000110111 0;010 1;11 2;10 3;011 4;0011 5;0010 6;00011 7;000101 8;000100 9;0000100 10;0000101 11;
0000111 12;00000100 13;00000111 14;000011000 15;0000010111 16;0000011000 17;0000001000 18;00001100111 19;
00001101000 20;00001101100 21;00000110111 22;00000101000 23;00000010111 24;00000011000 25;000011001010 26;
000011001011 27;000011001100 28;000011001101 29;000001101000 30;000001101001 31;000001101010 32;
000001101011 33;000011010010 34;000011010011 35;000011010100 36;000011010101 37;000011010110 38;
000011010111 39;000001101100 40;000001101101 41;000011011010 42;000011011011 43;000001010100 44;
000001010101 45;000001010110 46;000001010111 47;000001100100 48;000001100101 49;000001010010 50;
000001010011 51;000000100100 52;000000110111 53;000000111000 54;000000100111 55;000000101000 56;
000001011000 57;000001011001 58;000000101011 59;000000101100 60;000001011010 61;000001100110 62;
000001100111 63;0000001111 64;000011001000 128;000011001001 192;000001011011 256;000000110011 320;
000000110100 384;000000110101 448;0000001101100 512;0000001101101 576;0000001001010 640;0000001001011 704;
0000001001100 768;0000001001101 832;0000001110010 896;0000001110011 960;0000001110100 1024;
0000001110101 1088;0000001110110 1152;0000001110111 1216;0000001010010 1280;0000001010011 1344;
0000001010100 1408;0000001010101 1472;0000001011010 1536;0000001011011 1600;0000001100100 1664;
0000001100101 1728"""
# extended make-up codes, shared by both colours
_EXT = """00000001000 1792;00000001100 1856;00000001101 1920;000000010010 1984;000000010011 2048;
000000010100 2112;000000010101 2176;000000010110 2240;000000010111 2304;000000011100 2368;
000000011101 2432;000000011110 2496;000000011111 2560"""


def _table(text: str) -> dict:
    out = {}
    for item in (text + ";" + _EXT).replace("\n", "").split(";"):
        code, run = item.split()
        out[(len(code), int(code, 2))] = int(run)
    return out


_TABLES = (_table(_WHITE), _table(_BLACK))

# 2D mode codes: (length, value) -> mode
_PASS, _HORIZ = "P", "H"
_MODES = {(4, 0b0001): _PASS, (3, 0b001): _HORIZ, (1, 0b1): 0, (3, 0b011): 1, (6, 0b000011): 2,
          (7, 0b0000011): 3, (3, 0b010): -1, (6, 0b000010): -2, (7, 0b0000010): -3}


class _Bits:
    def __init__(self, data: bytes, reverse: bool):
        if reverse:  # FillOrder 2: least significant bit first
            data = bytes(_REVERSED[b] for b in data)
        self.buf = bytes(data) + b"\0\0\0\0"
        self.n = len(data) * 8
        self.pos = 0

    def peek(self, k: int) -> int:
        """The next ``k`` (at most 24) bits, zeros past the end."""
        p = self.pos
        window = int.from_bytes(self.buf[p >> 3:(p >> 3) + 4], "big")
        return (window >> (32 - (p & 7) - k)) & ((1 << k) - 1)

    def read(self, k: int) -> int:
        x = self.peek(k)
        self.pos += k
        return x

    def align(self):
        self.pos = (self.pos + 7) & ~7


_REVERSED = [int(f"{b:08b}"[::-1], 2) for b in range(256)]


def _code(bits: _Bits, table: dict, max_len: int = 13) -> int:
    for length in range(1, max_len + 1):
        run = table.get((length, bits.peek(length)))
        if run is not None:
            bits.pos += length
            return run
    raise CcittError(f"no CCITT code at bit {bits.pos}")


def _run(bits: _Bits, color: int) -> int:
    """A run of ``color`` (0 white, 1 black): make-up codes then a
    terminating code."""
    total = 0
    while True:
        r = _code(bits, _TABLES[color])
        total += r
        if r < 64:
            return total


def _row_1d(bits: _Bits, width: int) -> list:
    """Changing elements of one one-dimensional row."""
    changes, a0, color = [], 0, 0
    while a0 < width:
        a0 += _run(bits, color)
        changes.append(a0)
        color ^= 1
    return changes


def _b1b2(ref: list, a0: int, color: int, width: int):
    """b1: the first changing element of the reference row right of a0 and
    of the colour opposite to a0's; b2 the next one."""
    # ref holds positions where the colour changes; change i turns to colour (i + 1) & 1
    i = 0
    while i < len(ref) and (ref[i] <= a0 if a0 >= 0 else ref[i] < 0):
        i += 1
    if i < len(ref) and (i & 1) != color:  # wrong colour: skip one
        i += 1
    b1 = ref[i] if i < len(ref) else width
    b2 = ref[i + 1] if i + 1 < len(ref) else width
    return b1, b2


def _row_2d(bits: _Bits, ref: list, width: int) -> list:
    changes, a0, color = [], -1, 0
    while True:
        mode = None
        for length in (1, 3, 4, 6, 7):
            mode = _MODES.get((length, bits.peek(length)))
            if mode is not None:
                bits.pos += length
                break
        if mode is None:
            raise CcittError(f"no CCITT 2D mode code at bit {bits.pos}")
        b1, b2 = _b1b2(ref, a0, color, width)
        if mode == _PASS:
            a0 = b2
        elif mode == _HORIZ:
            start = max(a0, 0)
            r1 = _run(bits, color)
            r2 = _run(bits, color ^ 1)
            a1 = start + r1
            changes.append(a1)
            a0 = a1 + r2
            changes.append(a0)
        else:
            a1 = b1 + mode
            changes.append(a1)
            a0 = a1
            color ^= 1
        if a0 >= width:
            return changes


def _fill(changes: list, width: int) -> np.ndarray:
    row = np.zeros(width + 1, np.int8)
    pos = [min(max(c, 0), width) for c in changes]
    for i, c in enumerate(pos):
        row[c] += 1 if i % 2 == 0 else -1
    return (np.cumsum(row[:width]) > 0).astype(np.uint8)


def _skip_eol(bits: _Bits):
    """Skip an EOL (eleven or more zeros, fill bits included, then a one)
    if one is next."""
    start = bits.pos
    zeros = 0
    while bits.pos < bits.n and bits.peek(1) == 0:
        bits.pos += 1
        zeros += 1
    if zeros >= 11 and bits.peek(1) == 1:
        bits.pos += 1
    else:
        bits.pos = start


def decode(data: bytes, width: int, height: int, compression: int, options: int = 0,
           reverse: bool = False) -> np.ndarray:
    """One strip or tile -> (height, width) uint8 of stored bits (1 black)."""
    bits = _Bits(data, reverse)
    out = np.zeros((height, width), np.uint8)
    ref = []  # the row above, as changing elements; none for an all-white line
    two_d = compression == 3 and options & 1
    for y in range(height):
        if compression == 2:
            changes = _row_1d(bits, width)
            bits.align()
        elif compression == 3:
            _skip_eol(bits)
            if two_d:
                tag = bits.read(1)
                changes = _row_1d(bits, width) if tag else _row_2d(bits, ref, width)
            else:
                changes = _row_1d(bits, width)
        elif compression == 4:
            changes = _row_2d(bits, ref, width)
        else:
            raise CcittError(f"CCITT compression {compression}")
        out[y] = _fill(changes, width)
        ref = changes
    return out
