"""The AV1 tables the intra decoder reads (``data/av1_*.py``).

What has a closed form is computed here: ``Div_Lut``, the self-guided
filter's ``x_by_xplus1`` and ``one_by_x``, the inverse transforms' ``cospi``
integers, and the small syntax tables of the specification.
The rest comes from ``av1_tables.npz`` beside this file, taken once from
libaom 3.14.1 (the codec cv2 5.0.0 reads AVIF with) by
``tests/make_av1_tables.py``, which also checks the closed forms against the
library's copies: the default CDFs of every key-frame syntax element
(libaom's layout, as inverse CDFs ``32768 - cdf`` with a counter word), the
coefficient CDFs over the four q contexts, the Dc / Ac quantizer lookups at
8, 10 and 12 bits, the quantizer matrices, the filter-intra taps, the smooth
weights, ``dr_intra_derivative``, ``Sgr_Params``, the CDEF directions, the
film grain Gaussian sequence, the transform-set maps and every scan order.

Each CDF array here is read-only; a decoder copies what it adapts
(:func:`default_cdfs`).
"""

from __future__ import annotations

import functools
from fractions import Fraction
from math import cos, pi
from pathlib import Path

import numpy as np

_NPZ = Path(__file__).with_name("av1_tables.npz")


@functools.cache
def _npz() -> dict:
    with np.load(_NPZ) as z:
        out = {k: z[k] for k in z.files}
    for a in out.values():
        a.setflags(write=False)
    return out


def table(name: str) -> np.ndarray:
    return _npz()[name]


#: CDF keys of the frame context a key frame starts from (mode syntax)
MODE_CDF_KEYS = (
    "palette_y_size", "palette_uv_size", "palette_y_color_index", "palette_uv_color_index", "palette_y_mode",
    "palette_uv_mode", "txfm_partition", "skip", "intrabc", "seg_pred", "seg_spatial", "filter_intra",
    "filter_intra_mode", "switchable_restore", "wiener_restore", "sgrproj_restore", "uv_mode", "partition",
    "kf_y_mode", "angle_delta", "tx_size", "delta_q", "delta_lf_multi", "delta_lf", "intra_ext_tx", "inter_ext_tx", "cfl_sign",
    "cfl_alpha", "mv_joints", "mv0_classes", "mv0_class0_fp", "mv0_fp", "mv0_sign", "mv0_class0_hp", "mv0_hp",
    "mv0_class0", "mv0_bits", "mv1_classes", "mv1_class0_fp", "mv1_fp", "mv1_sign", "mv1_class0_hp", "mv1_hp",
    "mv1_class0", "mv1_bits")
COEF_CDF_KEYS = ("coef_txb_skip", "coef_eob_extra", "coef_dc_sign", "coef_eob16", "coef_eob32", "coef_eob64",
                 "coef_eob128", "coef_eob256", "coef_eob512", "coef_eob1024", "coef_base_eob", "coef_base", "coef_br")


def default_cdfs(base_q_idx: int) -> dict:
    """A fresh frame context: int32 copies of every CDF a key frame reads,
    the coefficient CDFs for ``base_q_idx``'s q context."""
    qctx = 0 if base_q_idx <= 20 else 1 if base_q_idx <= 60 else 2 if base_q_idx <= 120 else 3
    out = {k: table(k).astype(np.int32) for k in MODE_CDF_KEYS}
    for k in COEF_CDF_KEYS:
        out[k] = table(k)[qctx].astype(np.int32)
    return out


# -- closed forms ------------------------------------------------------------

def _round(fr: Fraction) -> int:
    return int(fr + Fraction(1, 2)) if fr >= 0 else -int(-fr + Fraction(1, 2))


@functools.cache
def div_lut() -> np.ndarray:
    """``Div_Lut[i] = round(2^14 * 256 / (256 + i))``, i = 0..256."""
    return np.array([_round(Fraction(1 << 22, 256 + i)) for i in range(257)], np.int16)


@functools.cache
def x_by_xplus1() -> np.ndarray:
    """The self-guided filter's ``round(256 z / (z + 1))``, 1 at z = 0 and
    256 at z = 255 as the specification fixes them."""
    v = [_round(Fraction(256 * z, z + 1)) for z in range(256)]
    v[0], v[255] = 1, 256
    return np.array(v, np.int32)


@functools.cache
def one_by_x() -> np.ndarray:
    """``round(4096 / n)``, n = 1..25."""
    return np.array([_round(Fraction(4096, n)) for n in range(1, 26)], np.int32)


@functools.cache
def cospi(bit: int = 12) -> np.ndarray:
    """``round(cos(j pi / 128) 2^bit)``, j = 0..63."""
    return np.array([int(np.floor(cos(j * pi / 128) * (1 << bit) + 0.5)) for j in range(64)], np.int32)


def sinpi(bit: int = 12) -> np.ndarray:
    """libaom's ``sinpi`` integers (near ``2 sqrt(2) / 3 sin(j pi / 9)
    2^bit``, two of them a unit lower), j = 0..4."""
    return table("sinpi")[bit - 10]


#: libaom's copies of the closed forms, for ``tests/make_av1_tables.py``
LIBAOM_VIEWS = {
    "div_lut": div_lut,
    "av1_x_by_xplus1": x_by_xplus1,
    "av1_one_by_x": one_by_x,
    "av1_cospi_arr_data": lambda: np.stack([cospi(b) for b in range(10, 14)]),
}


# -- the specification's small tables ----------------------------------------

# block sizes (libaom order)
BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, \
    BLOCK_32X32, BLOCK_32X64, BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64, BLOCK_128X128, BLOCK_4X16, \
    BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64, BLOCK_64X16 = range(22)
BLOCK_INVALID = 22
#: log2 of each block size's width / height in 4-sample units
MI_WIDTH_LOG2 = (0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4)
MI_HEIGHT_LOG2 = (0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4, 3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2)
BLOCK_W = tuple(4 << v for v in MI_WIDTH_LOG2)
BLOCK_H = tuple(4 << v for v in MI_HEIGHT_LOG2)
SIZE_GROUP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 0, 0, 1, 1, 2, 2)

# partitions
PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT, PARTITION_HORZ_A, PARTITION_HORZ_B, \
    PARTITION_VERT_A, PARTITION_VERT_B, PARTITION_HORZ_4, PARTITION_VERT_4 = range(10)


def block_size(w: int, h: int) -> int:
    for b in range(22):
        if BLOCK_W[b] == w and BLOCK_H[b] == h:
            return b
    return BLOCK_INVALID


def subsize(partition: int, bsize: int) -> int:
    """``Partition_Subsize``."""
    n = BLOCK_W[bsize]
    h2 = n // 2
    if partition == PARTITION_NONE:
        return bsize
    if partition in (PARTITION_HORZ, PARTITION_HORZ_A, PARTITION_HORZ_B):
        return block_size(n, h2)
    if partition in (PARTITION_VERT, PARTITION_VERT_A, PARTITION_VERT_B):
        return block_size(h2, n)
    if partition == PARTITION_SPLIT:
        return block_size(h2, h2)
    if partition == PARTITION_HORZ_4:
        return block_size(n, n // 4)
    return block_size(n // 4, n)


# intra modes
DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED, SMOOTH_PRED, \
    SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED = range(14)
#: ``Intra_Mode_Context`` (kf y mode contexts of the above / left modes)
INTRA_MODE_CONTEXT = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)
#: filter intra mode -> the intra mode its transform type follows
FILTER_INTRA_MODE_TO_INTRA_DIR = (DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED)

# transform sizes (libaom order)
TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32, TX_32X16, TX_32X64, \
    TX_64X32, TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16 = range(19)
TX_W = (4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64)
TX_H = (4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16)
TX_W_LOG2 = tuple(int(w).bit_length() - 1 for w in TX_W)
TX_H_LOG2 = tuple(int(h).bit_length() - 1 for h in TX_H)
#: ``Split_Tx_Size``
SPLIT_TX_SIZE = (TX_4X4, TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_4X4, TX_4X4, TX_8X8, TX_8X8, TX_16X16, TX_16X16,
                 TX_32X32, TX_32X32, TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32, TX_32X16)
#: ``Tx_Size_Sqr`` / ``Tx_Size_Sqr_Up``
TX_SQR = tuple(min(range(5), key=lambda t: abs(TX_W[t] - min(TX_W[s], TX_H[s]))) for s in range(19))
TX_SQR_UP = tuple(min(range(5), key=lambda t: abs(TX_W[t] - max(TX_W[s], TX_H[s]))) for s in range(19))
#: ``Max_Tx_Size_Rect`` by block size
MAX_TX_SIZE_RECT = (TX_4X4, TX_4X8, TX_8X4, TX_8X8, TX_8X16, TX_16X8, TX_16X16, TX_16X32, TX_32X16, TX_32X32,
                    TX_32X64, TX_64X32, TX_64X64, TX_64X64, TX_64X64, TX_64X64, TX_4X16, TX_16X4, TX_8X32,
                    TX_32X8, TX_16X64, TX_64X16)
#: ``Max_Tx_Depth`` by block size
MAX_TX_DEPTH = (0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 4, 2, 2, 3, 3, 4, 4)


def tx_size_of(w: int, h: int) -> int:
    for t in range(19):
        if TX_W[t] == w and TX_H[t] == h:
            return t
    raise ValueError(f"no transform size {w}x{h}")


# transform types
DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST, ADST_FLIPADST, \
    FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST = range(16)
#: (vertical 1-D type, horizontal 1-D type): 0 DCT, 1 ADST, 2 FLIPADST, 3 identity
TX_TYPE_1D = ((0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2), (2, 2), (1, 2), (2, 1), (3, 3), (0, 3), (3, 0),
              (1, 3), (3, 1), (2, 3), (3, 2))
#: ``Mode_To_Txfm`` for intra modes (UV_CFL_PRED last)
MODE_TO_TXFM = (DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST, DCT_ADST, ADST_DCT,
                ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT)
#: tx set types (libaom ``TxSetType``)
EXT_TX_SET_DCTONLY, EXT_TX_SET_DCT_IDTX, EXT_TX_SET_DTT4_IDTX, EXT_TX_SET_DTT4_IDTX_1DDCT, \
    EXT_TX_SET_DTT9_IDTX_1DDCT, EXT_TX_SET_ALL16 = range(6)


# film grain and the rest keep their tables in the npz; restoration types
RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = range(4)
#: frame restoration type from the 2-bit ``lr_type`` (``Remap_Lr_Type``)
REMAP_LR_TYPE = (RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ)
#: ``Wiener_Taps_Min`` / ``Max`` / ``K`` and the self-guided limits
WIENER_TAPS_MIN = (-5, -23, -17)
WIENER_TAPS_MAX = (10, 8, 46)
WIENER_TAPS_K = (1, 2, 3)
WIENER_TAPS_MID = (3, -7, 15)
SGRPROJ_XQD_MIN = (-96, -32)
SGRPROJ_XQD_MAX = (31, 95)
SGRPROJ_XQD_MID = (-32, 31)
SGRPROJ_PARAMS_BITS = 4
SGRPROJ_PRJ_SUBEXP_K = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_RST_BITS = 4
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_RECIP_BITS = 12
SGRPROJ_SGR_BITS = 8

#: the intra edge filter's kernels (``Intra_Edge_Kernel``)
INTRA_EDGE_KERNEL = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))
#: ``Quantizer_Matrix`` offset of each transform size's matrix (64-point
#: sizes use their 32-point matrix)
_QM_ORDER = (TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32, TX_32X16, TX_4X16,
             TX_16X4, TX_8X32, TX_32X8)


def qm_offset(tx_size: int) -> int:
    t = {TX_64X64: TX_32X32, TX_32X64: TX_32X32, TX_64X32: TX_32X32, TX_16X64: TX_16X32,
         TX_64X16: TX_32X16}.get(tx_size, tx_size)
    off = 0
    for s in _QM_ORDER:
        if s == t:
            return off
        off += TX_W[s] * TX_H[s]
    raise AssertionError(tx_size)


@functools.cache
def scan(tx_size: int, tx_type: int) -> tuple:
    """libaom's scan order for a transform size and type: positions ``row *
    w + col`` in the coded block of ``w = min(width, 32)`` columns."""
    k = int(table("scan_index")[tx_size, tx_type])
    start = int(table("scan_len")[:k].sum())
    return tuple(table("scans")[start:start + int(table("scan_len")[k])].tolist())


@functools.cache
def nz_map_offset(tx_size: int) -> tuple:
    """``Coeff_Base_Ctx_Offset`` of every position (row-major) of a
    transform size's coded block."""
    sizes = [min(TX_W[t], 32) * min(TX_H[t], 32) for t in range(19)]
    start = sum(sizes[:tx_size])
    return tuple(table("nz_map_offset")[start:start + sizes[tx_size]].tolist())
