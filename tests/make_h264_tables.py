"""Writes ``dspnet_torch/data/h264_tables.npz``, the constant tables of the
port's H.264 decoder (``data/h264_tables.py`` loads it).

The tables the decoder cannot compute are read from the FFmpeg build in
cv2's wheel (``opencv_python.libs/libavcodec-*.so.62.28.101``), which is
stripped: each table is found by its known first values and then checked by
structure:

* the four CABAC (m, n) initialisation tables, int8 pairs 0x800 bytes apart
  from the first hit of 20, -15, 2, 54, 3, 74: ``cabac_init_idc`` 0, 1, 2
  (P and B slices) and then the I table, whose ctxIdx 11-59 are zero;
* FFmpeg's packed CABAC engine table: ``rangeTabLPS`` (each value twice, a
  row of 128 bytes per ``qCodIRangeIdx``), the state transitions (``mlps``,
  2 * pStateIdx + valMPS after an MPS at 128 + s and after an LPS at
  127 - s) and the 8x8 frame ``last_significant_coeff_flag`` increments;
* the 8x8 frame ``significant_coeff_flag`` increments;
* CAVLC's ``coeff_token`` lengths and codes (four nC ranges of 17 x 4, and
  chroma DC), ``total_zeros`` (4x4 and chroma DC) and ``run_before``; each
  checked to be a prefix code whose Kraft sum is 1 (``coeff_token`` for
  nC 0-1, 2-3, 4-7 and >= 8 leave codes unused, as the standard's tables
  do);
* the ``coded_block_pattern`` mappings of me(v), intra and inter;
* the deblocking filter's alpha, beta and tC0 rows for indexA / indexB 0-51,
  and the 8-bit chroma QP table;
* ``normAdjust`` for 4x4 and 8x8 and the default scaling lists.

Computed from their closed forms and checked against the above: the 4x4 and
8x8 frame zig-zag scans. Run it where cv2 is installed:
``python tests/make_h264_tables.py``.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "dspnet_torch" / "data" / "h264_tables.npz"


def libavcodec() -> bytes:
    import cv2

    libs = Path(cv2.__file__).resolve().parent.parent / "opencv_python.libs"
    found = sorted(libs.glob("libavcodec-*.so.62.28.101"))
    if not found:
        raise SystemExit(f"no libavcodec 62.28.101 under {libs}")
    return found[0].read_bytes()


def find(so: bytes, first, what: str) -> int:
    """The one offset of ``first`` (int8 / uint8 values) in the library."""
    pat = bytes((int(v) + 256) % 256 for v in first)
    at = so.find(pat)
    if at < 0:
        raise SystemExit(f"{what}: first values {first} not found")
    return at


def u8(so: bytes, at: int, n: int) -> np.ndarray:
    return np.frombuffer(so, np.uint8, n, at).copy()


def zigzag(n: int) -> np.ndarray:
    """The frame zig-zag of an n x n block: raster positions in scan order
    (anti-diagonals, alternating direction, starting to the right)."""
    order = []
    for s in range(2 * n - 1):
        cells = [(y, s - y) for y in range(n) if 0 <= s - y < n]
        order += cells if s % 2 else cells[::-1]
    return np.array([y * n + x for y, x in order], np.int32)


def kraft(lens, bits, complete=True):
    """Checks (len, code) pairs of non-zero length form a prefix code."""
    codes = [(int(l), int(b)) for l, b in zip(lens, bits) if l]
    total = sum(2.0 ** -l for l, _ in codes)
    if total > 1 or (complete and abs(total - 1) > 1e-12):
        raise SystemExit(f"Kraft sum {total} != 1 for {codes}")
    for i, (l1, b1) in enumerate(codes):
        for l2, b2 in codes[i + 1:]:
            lo, hi = ((l1, b1), (l2, b2)) if l1 <= l2 else ((l2, b2), (l1, b1))
            if hi[1] >> (hi[0] - lo[0]) == lo[1]:
                raise SystemExit(f"not a prefix code: {lo} prefixes {hi}")
    return total


def extract(so: bytes) -> dict:
    """Every table, by name, from the library's bytes (and computed)."""
    t = {}
    # ---- CABAC context initialisation: m, n for ctxIdx 0-1023
    at = find(so, [20, -15, 2, 54, 3, 74, 20, -15], "CABAC init")
    cabac = np.stack([np.frombuffer(so, np.int8, 2048, at + k * 0x800).reshape(1024, 2) for k in range(4)])
    assert (cabac[3, 11:60] == 0).all() and (cabac[:3, 11:60] != 0).any(axis=1).all(), "I table / P-B tables"
    assert tuple(cabac[0, 11]) == (23, 33) and tuple(cabac[1, 11]) == (22, 25) and tuple(cabac[2, 11]) == (29, 16)
    t["cabac_init_pb"] = cabac[:3]
    t["cabac_init_i"] = cabac[3]
    # ---- the CABAC engine: rangeTabLPS, transitions, last-8x8 increments
    at = find(so, [128, 128, 128, 128, 128, 128, 123, 123, 116, 116, 111, 111], "rangeTabLPS")
    lps = u8(so, at, 512).reshape(4, 64, 2)
    assert (lps[..., 0] == lps[..., 1]).all()
    t["range_lps"] = np.ascontiguousarray(lps[..., 0].T)  # [pStateIdx][qCodIRangeIdx]
    assert tuple(t["range_lps"][63]) == (2, 2, 2, 2) and (np.diff(t["range_lps"][:63].astype(int), axis=0) <= 0).all()
    mlps = u8(so, at + 512, 256)
    mps = np.array([mlps[128 + 2 * s] >> 1 for s in range(64)], np.uint8)
    lps_next = np.array([mlps[127 - 2 * s] >> 1 for s in range(64)], np.uint8)
    assert all(mlps[128 + 2 * s] & 1 == 0 and mlps[129 + 2 * s] & 1 == 1 for s in range(64)), "MPS keeps valMPS"
    assert mlps[127] & 1 == 1 and all(mlps[127 - 2 * s] & 1 == 0 for s in range(1, 64)), "LPS at 0 flips valMPS"
    assert list(mps[:62]) == list(range(1, 63)) and mps[62] == 62 and mps[63] == 63
    t["trans_mps"], t["trans_lps"] = mps, lps_next
    t["last8x8"] = u8(so, at + 512 + 256, 63)
    assert list(t["last8x8"][:17]) == [0] + [1] * 15 + [2] and t["last8x8"][62] == 8
    at = find(so, [0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5, 4, 4, 4, 4, 3, 3, 6, 7], "significant 8x8")
    t["sig8x8"] = u8(so, at, 63)
    assert t["sig8x8"].max() == 14
    # ---- CAVLC
    at = find(so, [1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5], "coeff_token lengths")
    t["coeff_token_len"] = u8(so, at, 4 * 68).reshape(4, 17, 4)
    at = find(so, [1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3], "coeff_token codes")
    t["coeff_token_bits"] = u8(so, at, 4 * 68).reshape(4, 17, 4)
    at = find(so, [2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6], "chroma DC coeff_token lengths")
    t["cdc_token_len"] = u8(so, at, 20).reshape(5, 4)
    at = find(so, [1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5], "chroma DC coeff_token codes")
    t["cdc_token_bits"] = u8(so, at, 20).reshape(5, 4)
    at = find(so, [1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9], "total_zeros lengths")
    t["total_zeros_len"] = u8(so, at, 240).reshape(15, 16)
    at = find(so, [1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1], "total_zeros codes")
    t["total_zeros_bits"] = u8(so, at, 240).reshape(15, 16)
    at = find(so, [1, 2, 3, 3, 1, 2, 2, 0, 1, 1, 0, 0], "chroma DC total_zeros lengths")
    t["cdc_total_zeros_len"] = u8(so, at, 12).reshape(3, 4)
    at = find(so, [1, 1, 1, 0, 1, 1, 0, 0, 1, 0, 0, 0], "chroma DC total_zeros codes")
    t["cdc_total_zeros_bits"] = u8(so, at, 12).reshape(3, 4)
    at = find(so, [3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11], "run_before lengths (row 7)") - 96
    t["run_len"] = u8(so, at, 112).reshape(7, 16)
    assert list(t["run_len"][0][:3]) == [1, 1, 0]
    at = find(so, [1, 0] + [0] * 14 + [1, 1, 0] + [0] * 13 + [3, 2, 1, 0], "run_before codes")
    t["run_bits"] = u8(so, at, 112).reshape(7, 16)
    # coeff_token leaves codes unused, as the standard's tables do (nC 0-1
    # one of 15 bits, nC 2-3 one of 13, nC 4-7 one of 10, nC >= 8 (a 6-bit
    # FLC) two of its 64; chroma DC none): prefix codes with these Kraft sums
    sums = [kraft(t["coeff_token_len"][nc].ravel(), t["coeff_token_bits"][nc].ravel(), False) for nc in range(4)]
    sums.append(kraft(t["cdc_token_len"].ravel(), t["cdc_token_bits"].ravel(), False))
    assert sums == [1 - 2.0 ** -15, 1 - 2.0 ** -13, 1 - 2.0 ** -10, 1 - 2.0 ** -5, 1.0], sums
    # total_zeros for one coefficient leaves the 9-bit 0000 0000 0 unused
    assert kraft(t["total_zeros_len"][0], t["total_zeros_bits"][0], False) == 1 - 2.0 ** -9
    for k in range(1, 15):
        kraft(t["total_zeros_len"][k][:16 - k], t["total_zeros_bits"][k][:16 - k])
    for k in range(3):
        kraft(t["cdc_total_zeros_len"][k][:4 - k], t["cdc_total_zeros_bits"][k][:4 - k])
    for k in range(6):
        kraft(t["run_len"][k][:k + 2], t["run_bits"][k][:k + 2])
    # run_before with more than 6 zeros left leaves the 11-bit 0000 0000 000
    assert kraft(t["run_len"][6][:15], t["run_bits"][6][:15], False) == 1 - 2.0 ** -11
    at = find(so, [0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13], "inter cbp")
    t["cbp_inter"] = u8(so, at, 48)
    at = find(so, [47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46], "intra cbp")
    t["cbp_intra"] = u8(so, at, 48)
    assert sorted(t["cbp_inter"]) == sorted(t["cbp_intra"]) == list(range(48))
    # ---- deblocking
    at = find(so, [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28], "alpha") - 16
    t["alpha"] = u8(so, at, 52)
    at = find(so, [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8], "beta") - 16
    t["beta"] = u8(so, at, 52)
    at = find(so, [-1, 0, 0, 1, -1, 0, 0, 1, -1, 0, 0, 1, -1, 0, 0, 1, -1, 0, 1, 1], "tC0") - 4 * 17
    tc0 = np.frombuffer(so, np.int8, 52 * 4, at).reshape(52, 4)
    assert (tc0[:, 0] == -1).all() and (tc0[:17, 1:] == 0).all() and tuple(tc0[51, 1:]) == (13, 17, 25)
    t["tc0"] = np.ascontiguousarray(tc0[:, 1:]).astype(np.uint8)
    assert (t["alpha"][:16] == 0).all() and t["alpha"][51] == 255 and t["beta"][51] == 18
    at = find(so, list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39,
                                      39, 39], "chroma QP")
    t["chroma_qp"] = u8(so, at, 52)
    # ---- dequantisation
    at = find(so, [10, 13, 16, 11, 14, 18, 13, 16, 20, 14, 18, 23, 16, 20, 25, 18, 23, 29], "normAdjust 4x4")
    t["norm4"] = u8(so, at, 18).reshape(6, 3)
    at = find(so, [20, 18, 32, 19, 25, 24, 22, 19, 35, 21, 28, 26], "normAdjust 8x8")
    t["norm8"] = u8(so, at, 36).reshape(6, 6)
    t["zigzag4"] = zigzag(4)
    t["zigzag8"] = zigzag(8)
    at = find(so, [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15], "4x4 zig-zag")
    assert (u8(so, at, 16) == t["zigzag4"]).all()
    d4 = {"intra": [6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42],
          "inter": [10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34]}
    for k, zz in d4.items():  # FFmpeg keeps them raster
        raster = np.zeros(16, np.uint8)
        raster[t["zigzag4"]] = zz
        find(so, list(raster), f"default 4x4 {k} scaling list")
        t[f"default4_{k}"] = np.array(zz, np.uint8)
    at = find(so, [6, 10, 13, 16, 18, 23, 25, 27, 10, 11, 16, 18, 23, 25, 27, 29], "default 8x8 scaling lists")
    lists8 = u8(so, at, 128).reshape(2, 64)
    t["default8_intra"] = lists8[0][t["zigzag8"]]
    t["default8_inter"] = lists8[1][t["zigzag8"]]
    assert t["default8_intra"][63] == 42 and t["default8_inter"][63] == 35
    return t


def main():
    t = extract(libavcodec())
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **t)
    print(f"{len(t)} tables -> {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
