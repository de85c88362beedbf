"""The constant tables of the port's H.264 decoder (ITU-T H.264, 8-bit
4:2:0 progressive), from ``h264_tables.npz`` (``tests/make_h264_tables.py``
reads them from FFmpeg's ``libavcodec`` in cv2's wheel and checks each by
structure), with the lookups built from them:

* CABAC: ``CABAC_INIT`` (4, 1024, 2) int8 (m, n): ``cabac_init_idc`` 0-2
  for P and B slices, then index 3 for I slices; ``RANGE_LPS`` (64, 4);
  ``TRANS_MPS`` / ``TRANS_LPS``; the 8x8 frame increments ``SIG8x8`` and
  ``LAST8x8`` of significant / last coefficient flags;
* CAVLC: ``coeff_token`` (four nC tables, chroma DC), ``total_zeros`` and
  ``run_before`` as (length, code) arrays and as decoding dicts
  ``{(length, code): symbol}``; ``CBP_INTRA`` / ``CBP_INTER`` (me(v));
* dequantisation: ``LEVEL_SCALE4`` (6, 16) and ``LEVEL_SCALE8`` (6, 64),
  ``normAdjust`` in raster order (a flat weight of 16 applied by the
  caller's scaling list), the default scaling lists in zig-zag order, the
  scans ``ZIGZAG4`` / ``ZIGZAG8`` (raster position of each scan index);
* deblocking: ``ALPHA``, ``BETA`` (52), ``TC0`` (52, 3) by bS 1-3;
  ``CHROMA_QP`` (52).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_T = np.load(Path(__file__).with_name("h264_tables.npz"))

CABAC_INIT = np.concatenate([_T["cabac_init_pb"], _T["cabac_init_i"][None]]).astype(np.int32)
RANGE_LPS = _T["range_lps"].astype(np.int32)
TRANS_MPS = _T["trans_mps"].astype(np.int32)
TRANS_LPS = _T["trans_lps"].astype(np.int32)
SIG8x8 = _T["sig8x8"].astype(np.int32)
LAST8x8 = _T["last8x8"].astype(np.int32)

COEFF_TOKEN_LEN = _T["coeff_token_len"].astype(np.int32)  # [nC table][TotalCoeff][TrailingOnes]
COEFF_TOKEN_BITS = _T["coeff_token_bits"].astype(np.int32)
CDC_TOKEN_LEN = _T["cdc_token_len"].astype(np.int32)  # [TotalCoeff][TrailingOnes]
CDC_TOKEN_BITS = _T["cdc_token_bits"].astype(np.int32)
TOTAL_ZEROS_LEN = _T["total_zeros_len"].astype(np.int32)  # [TotalCoeff - 1][total_zeros]
TOTAL_ZEROS_BITS = _T["total_zeros_bits"].astype(np.int32)
CDC_TOTAL_ZEROS_LEN = _T["cdc_total_zeros_len"].astype(np.int32)
CDC_TOTAL_ZEROS_BITS = _T["cdc_total_zeros_bits"].astype(np.int32)
RUN_LEN = _T["run_len"].astype(np.int32)  # [min(zerosLeft, 7) - 1][run_before]
RUN_BITS = _T["run_bits"].astype(np.int32)
CBP_INTRA = _T["cbp_intra"].astype(np.int32)  # codeNum -> coded_block_pattern
CBP_INTER = _T["cbp_inter"].astype(np.int32)

ALPHA = _T["alpha"].astype(np.int32)
BETA = _T["beta"].astype(np.int32)
TC0 = _T["tc0"].astype(np.int32)
CHROMA_QP = _T["chroma_qp"].astype(np.int32)

ZIGZAG4 = _T["zigzag4"].astype(np.int32)
ZIGZAG8 = _T["zigzag8"].astype(np.int32)
DEFAULT4 = (_T["default4_intra"].astype(np.int32), _T["default4_inter"].astype(np.int32))  # zig-zag order
DEFAULT8 = (_T["default8_intra"].astype(np.int32), _T["default8_inter"].astype(np.int32))


def _norm4() -> np.ndarray:
    v = _T["norm4"].astype(np.int32)  # [m][both even, one odd, both odd]
    out = np.zeros((6, 16), np.int32)
    for i in range(4):
        for j in range(4):
            out[:, i * 4 + j] = v[:, (i & 1) + (j & 1)]
    return out


def _norm8() -> np.ndarray:
    v = _T["norm8"].astype(np.int32)
    out = np.zeros((6, 64), np.int32)
    for i in range(8):
        for j in range(8):
            if i % 4 == 0 and j % 4 == 0:
                k = 0
            elif i % 2 == 1 and j % 2 == 1:
                k = 1
            elif i % 4 == 2 and j % 4 == 2:
                k = 2
            elif (i % 4 == 0 and j % 2 == 1) or (i % 2 == 1 and j % 4 == 0):
                k = 3
            elif (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
                k = 4
            else:
                k = 5
            out[:, i * 8 + j] = v[:, k]
    return out


#: normAdjust4x4(m, i, j) / normAdjust8x8(m, i, j) in raster order
NORM4 = _norm4()
NORM8 = _norm8()


def vlc_dict(lens, bits, symbols) -> dict:
    """{(length, code): symbol} of the non-zero lengths."""
    return {(int(l), int(b)): s for l, b, s in zip(lens, bits, symbols) if l}


#: coeff_token decoding, by nC table 0-3 and chroma DC (4):
#: {(length, code): (TotalCoeff, TrailingOnes)}
COEFF_TOKEN = [vlc_dict(COEFF_TOKEN_LEN[t].ravel(), COEFF_TOKEN_BITS[t].ravel(),
                        [(tc, t1) for tc in range(17) for t1 in range(4)]) for t in range(4)]
COEFF_TOKEN.append(vlc_dict(CDC_TOKEN_LEN.ravel(), CDC_TOKEN_BITS.ravel(),
                            [(tc, t1) for tc in range(5) for t1 in range(4)]))
TOTAL_ZEROS = [vlc_dict(TOTAL_ZEROS_LEN[k], TOTAL_ZEROS_BITS[k], range(16)) for k in range(15)]
CDC_TOTAL_ZEROS = [vlc_dict(CDC_TOTAL_ZEROS_LEN[k], CDC_TOTAL_ZEROS_BITS[k], range(4)) for k in range(3)]
RUN_BEFORE = [vlc_dict(RUN_LEN[k], RUN_BITS[k], range(16)) for k in range(7)]
