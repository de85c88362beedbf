"""AV1's entropy decoding (section 8.2 of the AV1 specification): the range
decoder over one tile's bytes, CDF adaptation, and the literal, ``NS(n)``,
``su`` and Golomb readers built on it.

CDFs are Python lists in libaom's layout: ``N - 1`` inverse values
``32768 - cdf``, a 0, and the adaptation counter (``aom_cdf_prob
[CDF_SIZE(N)]``). Lists, not arrays: the parse reads one symbol at a time.
"""

from __future__ import annotations

_SPEED = (0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2)


class SymbolError(ValueError):
    """A tile whose symbols run past its end or do not close as AV1 requires."""


class SymbolDecoder:
    """``init_symbol`` .. ``exit_symbol`` over ``data`` (one tile)."""

    __slots__ = ("data", "pos", "end", "value", "rng", "max_bits", "allow_update", "_bitpos")

    def __init__(self, data: bytes, disable_cdf_update: bool = False):
        self.data = data
        self.end = len(data)
        if self.end < 1:
            raise SymbolError("AV1 tile of 0 bytes")
        self._bitpos = 0
        num_bits = min(self.end * 8, 15)
        buf = self._bits(num_bits)
        padded = buf << (15 - num_bits)
        self.value = ((1 << 15) - 1) ^ padded
        self.rng = 1 << 15
        self.max_bits = 8 * self.end - 15
        self.allow_update = not disable_cdf_update

    def _bits(self, n: int) -> int:
        """``f(n)`` of the tile's bytes, most significant first (0 past the end)."""
        out = 0
        p = self._bitpos
        data, end = self.data, self.end
        for _ in range(n):
            byte = data[p >> 3] if (p >> 3) < end else 0
            out = (out << 1) | ((byte >> (7 - (p & 7))) & 1)
            p += 1
        self._bitpos = p
        return out

    def _renorm(self, bits: int) -> None:
        self.rng <<= bits
        num_bits = min(bits, max(0, self.max_bits))
        new = self._bits(num_bits) if num_bits > 0 else 0
        padded = new << (bits - num_bits)
        self.value = padded ^ (((self.value + 1) << bits) - 1)
        self.max_bits -= bits

    def symbol(self, cdf: list, n: int) -> int:
        """``read_symbol``: decode against ``cdf`` (``n`` symbols) and adapt it."""
        rng, value = self.rng, self.value
        cur = rng
        r8 = rng >> 8
        s = -1
        while True:
            s += 1
            prev = cur
            cur = ((r8 * (cdf[s] >> 6)) >> 1) + 4 * (n - s - 1)
            if value >= cur:
                break
        rng = prev - cur
        self.value = value - cur
        bits = 15 - (rng.bit_length() - 1)
        self.rng = rng
        if bits:
            self._renorm(bits)
        if self.allow_update:
            cnt = cdf[n]
            rate = 3 + (cnt > 15) + (cnt > 31) + _SPEED[n]
            for i in range(n - 1):
                c = cdf[i]
                if i < s:
                    cdf[i] = c + ((32768 - c) >> rate)
                else:
                    cdf[i] = c - (c >> rate)
            cdf[n] = cnt + (cnt < 32)
        return s

    def bool(self) -> int:
        """``read_bool``: one equiprobable bit, no adaptation."""
        rng, value = self.rng, self.value
        cur = (((rng >> 8) * (16384 >> 6)) >> 1) + 4
        if value >= cur:
            rng, s = rng - cur, 0
            value -= cur
        else:
            rng, s = cur, 1
        # the specification's form: symbol 0 below the split from the top
        self.value = value
        bits = 15 - (rng.bit_length() - 1)
        self.rng = rng
        if bits:
            self._renorm(bits)
        return s

    def literal(self, n: int) -> int:
        x = 0
        for _ in range(n):
            x = (x << 1) | self.bool()
        return x

    def ns(self, n: int) -> int:
        """``NS(n)`` through ``L(1)`` bits."""
        w = n.bit_length()
        m = (1 << w) - n
        v = self.literal(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.literal(1)

    def golomb(self) -> int:
        """``read_golomb`` of the coefficients' tail."""
        length = 0
        while True:
            length += 1
            if self.bool():
                break
            if length > 32:
                raise SymbolError("AV1 Golomb code longer than 32 bits")
        x = 1
        for _ in range(length - 1):
            x = (x << 1) | self.bool()
        return x - 1

    def padding_ok(self) -> bool:
        """``exit_symbol``'s trailing check: the bits left are 1 then 0s."""
        return self.max_bits >= -14
