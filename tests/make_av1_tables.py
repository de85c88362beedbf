"""Write ``dspnet_torch/data/av1_tables.npz``: the AV1 tables that have no
closed form, taken from libaom 3.14.1 as cv2 5.0.0's wheel carries it
(``opencv_python.libs/libaom-*.so.3.14.1``), for ``data/av1_tables.py``.

    python tests/make_av1_tables.py

Needs cv2's wheel (only for the library file). The library keeps its symbol
table, so each table is read from ``.rodata`` by its name and size. The
default CDFs of the mode syntax have no symbols of their own (the compiler
folded the small ones into ``av1_init_mode_probs``), so that function is
called once through ctypes on a buffer of ``sizeof(FRAME_CONTEXT)`` words
filled with 0xffff, and the buffer is cut into the frame context's fields in
their declared order; every word of it must be written, and every row must
be a CDF (strictly decreasing inverse values, 0, a 0 counter) or all zero.
The closed-form tables of ``data/av1_tables.py`` (``Div_Lut``, the
self-guided ``x_by_xplus1`` / ``one_by_x``, ``cospi``) are checked
against the library's copies here too. The scan orders are read through
``av1_scan_orders``' relocated pointers, so each transform size and type
gets the very scan libaom's decoder uses.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "dspnet_torch" / "data" / "av1_tables.npz"

#: FRAME_CONTEXT of libaom 3.14.1 after the coefficient CDFs, in declared
#: order: (name, shape, cdf size); nmvc / ndvc are 286 bytes of mv CDFs each;
#: ``inter_refs`` are the reference-frame CDFs (comp_inter .. comp_bwdref),
#: which an intra frame never reads. Each named field was found at its
#: offset by its known first values (skip 31671, txfm_partition 28581,
#: intrabc 30531, kf_y_mode 15588, cfl_sign 1418, ...).
MODE_FIELDS = [
    ("newmv", (6,), 3), ("zeromv", (2,), 3), ("refmv", (6,), 3), ("drl", (3,), 3),
    ("inter_compound_mode", (8,), 9), ("compound_type", (22,), 3), ("wedge_idx", (22,), 17),
    ("interintra", (4,), 3), ("wedge_interintra", (22,), 3), ("interintra_mode", (4,), 5),
    ("motion_mode", (22,), 4), ("obmc", (22,), 3), ("palette_y_size", (7,), 8), ("palette_uv_size", (7,), 8),
    ("palette_y_color_index", (7, 5), 9), ("palette_uv_color_index", (7, 5), 9), ("palette_y_mode", (7, 3), 3),
    ("palette_uv_mode", (2,), 3), ("inter_refs", (52,), 3), ("txfm_partition", (21,), 3),
    ("compound_index", (6,), 3), ("comp_group_idx", (6,), 3), ("skip_mode", (3,), 3), ("skip", (3,), 3),
    ("intra_inter", (4,), 3), ("nmvc", None, 143), ("ndvc", None, 143), ("intrabc", (), 3),
    ("seg_pred", (3,), 3), ("seg_spatial", (3,), 9), ("filter_intra", (22,), 3),
    ("filter_intra_mode", (), 6), ("switchable_restore", (), 4), ("wiener_restore", (), 3),
    ("sgrproj_restore", (), 3), ("y_mode", (4,), 14), ("uv_mode", (2, 13), 15), ("partition", (20,), 11),
    ("switchable_interp", (16,), 4), ("kf_y_mode", (5, 5), 14), ("angle_delta", (8,), 8), ("tx_size", (4, 3), 4),
    ("delta_q", (), 5), ("delta_lf_multi", (4,), 5), ("delta_lf", (), 5), ("intra_ext_tx", (3, 4, 13), 17),
    ("inter_ext_tx", (4, 4), 17), ("cfl_sign", (), 9), ("cfl_alpha", (6,), 17),
]
COEF_WORDS = 4045  # txb_skip .. coeff_br of one q context
FRAME_CONTEXT_WORDS = 0x52F8 // 2  # then the int ``initialized``

#: nmv_context: joints, then two nmv_components of these fields
MV_FIELDS = [("classes", (), 12), ("class0_fp", (2,), 5), ("fp", (), 5), ("sign", (), 3), ("class0_hp", (), 3),
             ("hp", (), 3), ("class0", (), 3), ("bits", (10,), 3)]

#: tables read by symbol: (symbol, dtype, shape, key)
SYMBOLS = [
    ("av1_default_txb_skip_cdfs", "<u2", (4, 5, 13, 3), "coef_txb_skip"),
    ("av1_default_eob_extra_cdfs", "<u2", (4, 5, 2, 9, 3), "coef_eob_extra"),
    ("av1_default_dc_sign_cdfs", "<u2", (4, 2, 3, 3), "coef_dc_sign"),
    ("av1_default_eob_multi16_cdfs", "<u2", (4, 2, 2, 6), "coef_eob16"),
    ("av1_default_eob_multi32_cdfs", "<u2", (4, 2, 2, 7), "coef_eob32"),
    ("av1_default_eob_multi64_cdfs", "<u2", (4, 2, 2, 8), "coef_eob64"),
    ("av1_default_eob_multi128_cdfs", "<u2", (4, 2, 2, 9), "coef_eob128"),
    ("av1_default_eob_multi256_cdfs", "<u2", (4, 2, 2, 10), "coef_eob256"),
    ("av1_default_eob_multi512_cdfs", "<u2", (4, 2, 2, 11), "coef_eob512"),
    ("av1_default_eob_multi1024_cdfs", "<u2", (4, 2, 2, 12), "coef_eob1024"),
    ("av1_default_coeff_base_eob_multi_cdfs", "<u2", (4, 5, 2, 4, 4), "coef_base_eob"),
    ("av1_default_coeff_base_multi_cdfs", "<u2", (4, 5, 2, 42, 5), "coef_base"),
    ("av1_default_coeff_lps_multi_cdfs", "<u2", (4, 5, 2, 21, 5), "coef_br"),
    ("dc_qlookup_QTX", "<i2", (256,), "dc_q8"), ("dc_qlookup_10_QTX", "<i2", (256,), "dc_q10"),
    ("dc_qlookup_12_QTX", "<i2", (256,), "dc_q12"), ("ac_qlookup_QTX", "<i2", (256,), "ac_q8"),
    ("ac_qlookup_10_QTX", "<i2", (256,), "ac_q10"), ("ac_qlookup_12_QTX", "<i2", (256,), "ac_q12"),
    ("iwt_matrix_ref", "u1", (15, 2, 3344), "qm"),
    ("av1_filter_intra_taps", "i1", (5, 8, 8), "filter_intra_taps"),
    ("av1_sgr_params", "<i4", (16, 4), "sgr_params"),
    ("gaussian_sequence", "<i4", (2048,), "gaussian_sequence"),
    ("av1_ext_tx_inv", "<i4", (6, 16), "ext_tx_inv"),
    ("av1_ext_tx_used", "<i4", (6, 16), "ext_tx_used"),
    ("av1_num_ext_tx_set", "<i4", (6,), "num_ext_tx_set"),
    ("dr_intra_derivative", "<i2", (90,), "dr_intra_derivative"),
    ("mode_to_angle_map", "u1", (13,), "mode_to_angle"),
    ("cdef_directions_padded", "<i4", (12, 2), "cdef_directions_padded"),
    ("smooth_weights", "u1", (124,), "smooth_weights"),
    ("av1_sinpi_arr_data", "<i4", (4, 5), "sinpi"),  # cos_bit 10..13; not a rounded closed form
]
#: tables that are only checked against ``data/av1_tables.py``'s closed forms
CHECKED = [("div_lut", "<i2", (257,)), ("av1_x_by_xplus1", "<i4", (256,)), ("av1_one_by_x", "<i4", (25,)),
           ("av1_cospi_arr_data", "<i4", (4, 64))]


def libaom_path() -> Path:
    import cv2

    libs = Path(cv2.__file__).resolve().parents[1] / "opencv_python.libs"
    found = sorted(libs.glob("libaom-*.so.3.14.1"))
    if not found:
        raise SystemExit(f"no libaom 3.14.1 under {libs}")
    return found[0]


def symbols(path: Path) -> dict:
    out = {}
    for line in subprocess.run(["readelf", "-sW", str(path)], capture_output=True, text=True, check=True).stdout.splitlines():
        f = line.split()
        if len(f) >= 8 and f[3] in ("FUNC", "OBJECT"):
            size = int(f[2], 16) if f[2].startswith("0x") else int(f[2])
            out.setdefault(f[7], (int(f[1], 16), size))
    return out


def rodata_offset(path: Path) -> int:
    """File offset minus address of the section that holds .rodata."""
    for line in subprocess.run(["readelf", "-SW", str(path)], capture_output=True, text=True, check=True).stdout.splitlines():
        f = line.replace("[", " ").replace("]", " ").split()
        if len(f) > 5 and f[1] == ".rodata":
            return int(f[4], 16) - int(f[3], 16)
    raise SystemExit("no .rodata")


def check_cdf_rows(name: str, a: np.ndarray, n: int) -> None:
    """Each row of ``a`` (last axis ``n``): strictly decreasing inverse CDF
    values, a 0, a 0 counter, then 0 padding; or all zero."""
    for row in a.reshape(-1, n):
        if not row.any():
            continue
        k = int(np.argmax(row == 0))
        vals = row[:k].astype(np.int64)
        ok = k >= 1 and (vals < 32768).all() and (np.diff(vals) < 0).all() and not row[k:].any()
        if not ok:
            raise SystemExit(f"{name}: not a CDF row: {row.tolist()}")


def mode_cdfs(lib_path: Path, syms: dict) -> dict:
    lib = ctypes.CDLL(str(lib_path))
    base = ctypes.cast(lib.aom_codec_version, ctypes.c_void_p).value - syms["aom_codec_version"][0]
    buf = (ctypes.c_uint16 * (FRAME_CONTEXT_WORDS + 8))(*([0xFFFF] * (FRAME_CONTEXT_WORDS + 8)))
    ctypes.CFUNCTYPE(None, ctypes.c_void_p)(base + syms["av1_init_mode_probs"][0])(ctypes.addressof(buf))
    words = np.array(buf, np.uint16)
    if (words[:COEF_WORDS] != 0xFFFF).any() or (words[FRAME_CONTEXT_WORDS:] != 0xFFFF).any():
        raise SystemExit("av1_init_mode_probs wrote outside the mode fields")
    out, pos = {}, COEF_WORDS
    for name, shape, n in MODE_FIELDS:
        if shape is None:  # an nmv_context, written by av1_init_mv_probs
            if name == "ndvc":
                nmv = np.frombuffer(raw_symbol(lib_path, syms, "default_nmv_context"), "<u2")
                check_cdf_rows("mv_joints", nmv[:5], 5)
                out["mv_joints"] = nmv[:5].copy()
                q = 5
                for comp in range(2):
                    for fname, fshape, fn in MV_FIELDS:
                        cnt = int(np.prod(fshape, dtype=int)) * fn
                        a = nmv[q:q + cnt].reshape(*fshape, fn)
                        check_cdf_rows(f"mv_{fname}", a, fn)
                        out[f"mv{comp}_{fname}"] = a.copy()
                        q += cnt
                if q != len(nmv):
                    raise SystemExit("nmv_context layout")
            pos += n
            continue
        cnt = int(np.prod(shape, dtype=int)) * n
        a = words[pos:pos + cnt].reshape(*shape, n)
        if (a == 0xFFFF).any():
            raise SystemExit(f"{name}: not written by av1_init_mode_probs")
        check_cdf_rows(name, a, n)
        out[name] = a.copy()
        pos += cnt
    if pos != FRAME_CONTEXT_WORDS:
        raise SystemExit(f"frame context layout: {pos} words, expected {FRAME_CONTEXT_WORDS}")
    return out


_DATA = {}


def raw_symbol(path: Path, syms: dict, name: str) -> bytes:
    if path not in _DATA:
        _DATA[path] = (path.read_bytes(), rodata_offset(path))
    data, delta = _DATA[path]
    addr, size = syms[name]
    return data[addr + delta:addr + delta + size]


def pointer_table(path: Path, syms: dict, table: str) -> np.ndarray:
    """The symbols an array of pointers points at (read through its
    relocations), one per 8 bytes."""
    addr, size = syms[table]
    relocs = {}
    out = subprocess.run(["readelf", "-rW", str(path)], capture_output=True, text=True, check=True).stdout
    for line in out.splitlines():
        f = line.split()
        if len(f) >= 4 and f[2] == "R_X86_64_RELATIVE":
            relocs[int(f[0], 16)] = int(f[3], 16)
    by_addr = {}
    for n, (a, s) in syms.items():
        if s > 0 and (a not in by_addr or "iscan" in by_addr[a]):
            by_addr[a] = n
    return np.array([by_addr.get(relocs.get(addr + 8 * k), "?") for k in range(size // 8)])


def main() -> None:
    path = libaom_path()
    syms = symbols(path)
    tables = mode_cdfs(path, syms)
    for name, dtype, shape, key in SYMBOLS:
        if dtype is None:
            continue
        raw = raw_symbol(path, syms, name)
        a = np.frombuffer(raw, dtype)
        if a.size != int(np.prod(shape)):
            raise SystemExit(f"{name}: {a.size} values, expected {shape}")
        a = a.reshape(shape)
        if key.startswith("coef_"):
            check_cdf_rows(key, a, shape[-1])
        tables[key] = a.copy()
    sys.path.insert(0, str(ROOT))
    from dspnet_torch.data import av1_tables as closed

    for name, dtype, shape in CHECKED:
        lib_table = np.frombuffer(raw_symbol(path, syms, name), dtype).reshape(shape)
        mine = closed.LIBAOM_VIEWS[name]()
        if not np.array_equal(lib_table, mine):
            raise SystemExit(f"{name}: the closed form differs from libaom's\n{lib_table}\n{mine}")
    # libaom 3.14 keeps coefficients column by column (index col * h + row);
    # the port keeps the specification's rows (row * w + col)
    names = pointer_table(path, syms, "av1_scan_orders")[::2].reshape(19, 16)  # {scan, iscan}
    unique = sorted(set(names.reshape(-1).tolist()))
    if "?" in unique:
        raise SystemExit("av1_scan_orders: a pointer without a symbol")
    tables["scan_index"] = np.array([[unique.index(n) for n in row] for row in names], np.int16)
    scans = []
    for n in unique:
        tx = int(np.argwhere(names == n)[0][0])
        w, h = min(closed.TX_W[tx], 32), min(closed.TX_H[tx], 32)
        sc = np.frombuffer(raw_symbol(path, syms, n), "<i2").astype(np.int64)
        if sorted(sc.tolist()) != list(range(w * h)):
            raise SystemExit(f"{n}: not a permutation of {w}x{h}")
        scans.append((sc % h) * w + sc // h)
    tables["scan_len"] = np.array([len(sc) for sc in scans], np.int32)
    tables["scans"] = np.concatenate(scans).astype(np.int16)
    offs = []
    for tx, n in enumerate(pointer_table(path, syms, "av1_nz_map_ctx_offset")):
        w, h = min(closed.TX_W[tx], 32), min(closed.TX_H[tx], 32)
        raw = np.frombuffer(raw_symbol(path, syms, n), "i1")[:w * h].astype(np.int64)
        rm = np.empty(w * h, np.int8)
        rm[(np.arange(w * h) % h) * w + np.arange(w * h) // h] = raw
        offs.append(rm)
    tables["nz_map_offset"] = np.concatenate(offs)
    tables["inv_shift"] = np.stack([np.frombuffer(raw_symbol(path, syms, n), "i1")
                                    for n in pointer_table(path, syms, "av1_inv_txfm_shift_ls")])
    # the quantizer matrices, column-major in libaom 3.14 as its coefficients
    qm = tables["qm"].copy()
    off = 0
    for tx in closed._QM_ORDER:
        w, h = closed.TX_W[tx], closed.TX_H[tx]
        k = np.arange(w * h)
        block = tables["qm"][:, :, off:off + w * h]
        qm[:, :, off + (k % h) * w + k // h] = block
        off += w * h
    tables["qm"] = qm
    np.savez_compressed(OUT, **{k: np.ascontiguousarray(v) for k, v in sorted(tables.items())})
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes, {len(tables)} tables)")


if __name__ == "__main__":
    main()
