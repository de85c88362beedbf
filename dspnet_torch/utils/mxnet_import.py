"""MXNet checkpoint import for the port — read `.params` files without MXNet
(a numpy copy of ``dspnet_tpu/utils/mxnet_import.py``, which the port may
not import; ``tests/test_torch_mxnet_import.py`` pins the two together).

The reference trains/saves MXNet checkpoints (`prefix-epoch.params`,
multi_train.py:370) and starts training from a pretrained MXNet ResNet
(multi_init.py:50-169). This module reads the dmlc NDArray-list binary
format and maps the reference's parameter names (multi_init.py:74-158 /
symbol names) onto the flax-layout nested trees the JAX package uses;
``utils/convert.py::flax_to_state_dict`` then names them as the port's
tensors, and :func:`load_mxnet` merges them into a module.

Format (mxnet src/ndarray/ndarray.cc NDArray::Save / MXNDArrayLoad):

    uint64 kMXAPINDArrayListMagic = 0x112
    uint64 reserved = 0
    uint64 ndarray_count
    per array:
        uint32 magic —
          0xF993fac8 (V1, "with int64_t TShape"): uint32 ndim + int64 dims
          0xF993fac9 (V2, "with storage type"):   int32 stype (0 = dense;
              sparse records carry aux payloads and are rejected), then
              uint32 ndim + int64 dims
          0xF993faca (V3, numpy shape semantics): same layout as V2
          anything else = legacy, where that word IS the ndim and the dims
              are uint32
        int32 dev_type, int32 dev_id
        int32 type_flag (0 f32, 1 f64, 2 f16, 3 u8, 4 i32, 5 i8, 6 i64)
        raw data bytes
    uint64 name_count
    per name: uint64 length + bytes (keys like "arg:conv0_weight",
              "aux:bn0_moving_mean")

A writer for the same format is included so the reader is round-trip tested
in CI; real-checkpoint validation needs an actual MXNet file.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

_LIST_MAGIC = 0x112
_V1_MAGIC = 0xF993FAC8
_V2_MAGIC = 0xF993FAC9
_V3_MAGIC = 0xF993FACA

_DTYPES = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
           4: np.int32, 5: np.int8, 6: np.int64}
_DTYPE_FLAGS = {np.dtype(v): k for k, v in _DTYPES.items()}


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, fmt: str):
        size = struct.calcsize(fmt)
        out = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += size
        return out if len(out) > 1 else out[0]

    def read_bytes(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out


def _read_ndarray(r: _Reader) -> np.ndarray:
    magic = r.read("<I")
    dims64 = False
    if magic in (_V2_MAGIC, _V3_MAGIC):
        # V2+ carries an int32 storage type right after the magic;
        # kDefaultStorage == 0, sparse types carry aux payloads we can't
        # parse as dense
        stype = r.read("<i")
        if stype != 0:
            raise ValueError(f"sparse NDArray (stype {stype}) unsupported")
        dims64 = True
        ndim = r.read("<I")
    elif magic == _V1_MAGIC:
        dims64 = True  # V1 = "with int64_t TShape"
        ndim = r.read("<I")
    else:
        ndim = magic  # legacy: first word was the ndim, dims are uint32
    fmt = ("q" if dims64 else "I") * ndim
    if ndim == 0:
        shape = ()
    else:
        dims = r.read("<" + fmt)
        shape = (dims,) if ndim == 1 else tuple(dims)
    r.read("<ii")  # dev_type, dev_id
    type_flag = r.read("<i")
    dtype = _DTYPES[type_flag]
    count = int(np.prod(shape)) if shape else 0
    raw = r.read_bytes(count * np.dtype(dtype).itemsize)
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def load_params(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Read a .params file -> (arg_params, aux_params) name->array dicts."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    magic = r.read("<Q")
    if magic != _LIST_MAGIC:
        raise ValueError(f"not an MXNet NDArray list (magic {magic:#x})")
    r.read("<Q")  # reserved
    n = r.read("<Q")
    arrays = [_read_ndarray(r) for _ in range(n)]
    n_names = r.read("<Q")
    names = []
    for _ in range(n_names):
        ln = r.read("<Q")
        names.append(r.read_bytes(ln).decode())
    if len(names) != len(arrays):
        raise ValueError(f"{len(names)} names for {len(arrays)} arrays")
    args, auxs = {}, {}
    for name, arr in zip(names, arrays):
        if name.startswith("arg:"):
            args[name[4:]] = arr
        elif name.startswith("aux:"):
            auxs[name[4:]] = arr
        else:
            args[name] = arr
    return args, auxs


def save_params(path: str, args: Dict[str, np.ndarray], auxs: Dict[str, np.ndarray] = None):
    """Write the same format (V2 dense records) — used for round-trip tests
    and for exporting weights back toward MXNet tooling."""
    auxs = auxs or {}
    items = [("arg:" + k, v) for k, v in args.items()] + [
        ("aux:" + k, v) for k, v in auxs.items()
    ]
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(items)))
        for _, arr in items:
            arr = np.ascontiguousarray(arr)
            f.write(struct.pack("<I", _V2_MAGIC))
            f.write(struct.pack("<i", 0))  # stype: kDefaultStorage
            f.write(struct.pack("<I", arr.ndim))
            f.write(struct.pack("<" + "q" * arr.ndim, *arr.shape))
            f.write(struct.pack("<ii", 1, 0))  # cpu(0)
            f.write(struct.pack("<i", _DTYPE_FLAGS[arr.dtype]))
            f.write(arr.tobytes())
        f.write(struct.pack("<Q", len(items)))
        for name, _ in items:
            b = name.encode()
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


# ------------------------------------------------------------- name mapping


def _conv_kernel(arr: np.ndarray) -> np.ndarray:
    """MXNet OIHW conv weight -> flax HWIO."""
    return np.transpose(arr, (2, 3, 1, 0))


def _deconv_kernel(arr: np.ndarray) -> np.ndarray:
    """MXNet Deconvolution weight -> flax ConvTranspose kernel.

    mx.sym.Deconvolution stores (in_channels, num_filter, kh, kw) and
    computes the adjoint of correlation — equivalent to a fractionally
    strided correlation with the SPATIALLY FLIPPED kernel. flax
    ConvTranspose (transpose_kernel=False) is a fractionally strided
    correlation with the kernel as-is, (kh, kw, in, out) layout — so the
    import is transpose + spatial flip (models/layers.py Deconv2x note).
    """
    return np.ascontiguousarray(np.transpose(arr, (2, 3, 0, 1))[::-1, ::-1])


def _deconv_kernel_inv(arr: np.ndarray) -> np.ndarray:
    """flax ConvTranspose kernel -> MXNet Deconvolution weight."""
    return np.ascontiguousarray(np.transpose(arr[::-1, ::-1], (2, 3, 0, 1)))


def _conv_kernel_inv(arr: np.ndarray) -> np.ndarray:
    """flax HWIO conv kernel -> MXNet OIHW weight."""
    return np.ascontiguousarray(np.transpose(arr, (3, 2, 0, 1)))


#: backbone name patterns (symbol/resnet.py contract) — shared between
#: map_resnet_backbone (consumption) and map_multitask (unused accounting)
_BB_BN_RX = re.compile(
    r"^(?P<mod>bn_data|bn0|(stage\d+_unit\d+)_(bn\d))_(?P<p>gamma|beta)$")
_BB_BNAUX_RX = re.compile(
    r"^(?P<mod>bn_data|bn0|(stage\d+_unit\d+)_(bn\d))_moving_(?P<p>mean|var)$")
_BB_CONV_RX = re.compile(
    r"^(?P<mod>conv0|(stage\d+_unit\d+)_(conv\d|sc))_weight$")


def map_resnet_backbone(args: Dict[str, np.ndarray], auxs: Dict[str, np.ndarray]):
    """Reference resnet param names -> (params, batch_stats) trees for
    models/resnet.ResNet (subtree contents for 'backbone').

    Name contract (symbol/resnet.py): conv0, bn_data, bn0,
    stage{i}_unit{j}_{bn1,bn2,bn3,conv1,conv2,conv3,sc}.
    """
    params: Dict = {}
    stats: Dict = {}

    def put(tree, path, leaf):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    bn_rx, bnaux_rx, conv_rx = _BB_BN_RX, _BB_BNAUX_RX, _BB_CONV_RX

    def module_path(mod: str):
        if "_" in mod and mod.startswith("stage"):
            unit, sub = mod.rsplit("_", 1)
            return (unit, sub)
        return (mod,)

    for name, arr in args.items():
        m = bn_rx.match(name)
        if m:
            mod = module_path(m.group("mod"))
            p = m.group("p")
            # fix_gamma BNs (bn_data) have no scale param in our modules
            if p == "gamma" and m.group("mod") == "bn_data":
                continue
            put(params, mod + ("BatchNorm_0", "scale" if p == "gamma" else "bias"), arr)
            continue
        m = conv_rx.match(name)
        if m:
            put(params, module_path(m.group("mod")) + ("kernel",), _conv_kernel(arr))
            continue
    for name, arr in auxs.items():
        m = bnaux_rx.match(name)
        if m:
            mod = module_path(m.group("mod"))
            p = "mean" if m.group("p") == "mean" else "var"
            put(stats, mod + ("BatchNorm_0", p), arr)
    return params, stats


# ------------------------------------------------- full multitask inventory


#: seg-head modules with a plain conv ``<name>_weight`` (OIHW) — reference
#: multitask_symbol_builder.py:272-317.  NOTE ``res5_reduced`` is absent by
#: design: the reference declares that conv but its BN reads ``conv_feat``
#: directly (the documented dead-conv quirk), so the weight never reaches a
#: trained symbol's argument list.
_SEG_CONVS = (
    "res3_reduced", "res3_reduced2", "res4_reduced", "res4_reduced2",
    "score2_pool1", "score2_pool2", "score2_pool4", "score3_conv",
)
#: seg-head BatchNorms — ALL fix_gamma=True in the reference (gamma saved as
#: a frozen 1-vector in checkpoints; only beta + moving stats carry state).
_SEG_BNS = (
    "res3_reduced_bn", "res3_reduced2_bn", "res4_reduced_bn",
    "res4_reduced2_bn", "res5_reduced_bn", "score2_pool1_bn",
    "score2_pool2_bn", "score2_pool4_bn", "score3_conv_bn",
)


def det_tap_names(network: str, data_shape: int = 512):
    """Ordered reference layer names feeding the multibox heads.

    The reference derives head param names from the tap layer's symbol name
    (common.py:244-259 ``{from_name}_loc_pred_conv``); named taps come from
    the factory preset (multitask_symbol_factory.py:17-95), '' entries spawn
    ``multi_feat_{k}_conv_3x3_relu`` layers (common.py:129-131). det/multi
    tasks drop the finest tap from the SSD head (multitask_symbol_builder
    .py:502-508); plain-ssd keeps all taps.
    """
    from dspnet_torch.api import parse_network_name
    from dspnet_torch.models import factory

    base, task = parse_network_name(network)
    cfg = factory.get_config(base, data_shape)
    if task in ("det", "multi"):
        cfg = cfg.drop_first_tap()
    return tuple(
        nm if nm else "multi_feat_%d_conv_3x3_relu" % k
        for k, nm in enumerate(cfg.from_layers)
    )


def map_multitask(args: Dict[str, np.ndarray], auxs: Dict[str, np.ndarray],
                  network: str = "resnet-50_multi", data_shape: int = 512):
    """Map a reference-TRAINED multitask checkpoint's full name inventory.

    Extends :func:`map_resnet_backbone` (pretrained-backbone-only files) to
    every head the reference trains (multi_train.py:370 saves the complete
    symbol): multibox loc/cls preds (common.py:244-259), the multi_feat
    extra layers (common.py:129-131), and the PSP seg head
    (multitask_symbol_builder.py:272-317).

    Returns ``(params, stats, unused)`` — params/stats are top-level trees
    matching models/dspnet.DSPNet ({backbone, multi_feat, multibox, seg}),
    ``unused`` the reference names nothing consumed (softmax/loss heads have
    none; a non-empty list on a real checkpoint is a parity red flag).
    """
    taps = {nm: i for i, nm in enumerate(det_tap_names(network, data_shape))}

    params: Dict = {}
    stats: Dict = {}
    consumed = set()

    def put(tree, path, leaf):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    tap_alt = "|".join(re.escape(t) for t in sorted(taps, key=len, reverse=True))
    pred_rx = re.compile(
        r"^(?P<tap>%s)_(?P<kind>loc|cls)_pred_conv_(?P<p>weight|bias)$" % tap_alt)
    feat_rx = re.compile(
        r"^(?P<mod>multi_feat_\d+_conv_(1x1|3x3))_conv_(?P<p>weight|bias)$")

    for name, arr in args.items():
        m = pred_rx.match(name)
        if m:
            i = taps[m.group("tap")]
            leaf = _conv_kernel(arr) if m.group("p") == "weight" else arr
            put(params, ("multibox", "%s_pred_%d" % (m.group("kind"), i),
                         "kernel" if m.group("p") == "weight" else "bias"), leaf)
            consumed.add(name)
            continue
        m = feat_rx.match(name)
        if m:
            leaf = _conv_kernel(arr) if m.group("p") == "weight" else arr
            put(params, ("multi_feat", m.group("mod"), "conv",
                         "kernel" if m.group("p") == "weight" else "bias"), leaf)
            consumed.add(name)
            continue
        base = name[:-len("_weight")] if name.endswith("_weight") else None
        if base in _SEG_CONVS:
            put(params, ("seg", base, "kernel"), _conv_kernel(arr))
            consumed.add(name)
            continue
        if name == "score4_conv_weight":
            put(params, ("seg", "score4_conv", "ConvTranspose_0", "kernel"),
                _deconv_kernel(arr))
            consumed.add(name)
            continue
        for suffix, leaf_name in (("_beta", "bias"), ("_gamma", None)):
            if name.endswith(suffix) and name[:-len(suffix)] in _SEG_BNS:
                # gamma is the frozen fix_gamma 1-vector — consumed, dropped
                if leaf_name:
                    put(params, ("seg", name[:-len(suffix)], "BatchNorm_0",
                                 leaf_name), arr)
                consumed.add(name)
                break

    for name, arr in auxs.items():
        for suffix, leaf_name in (("_moving_mean", "mean"), ("_moving_var", "var")):
            if name.endswith(suffix) and name[:-len(suffix)] in _SEG_BNS:
                put(stats, ("seg", name[:-len(suffix)], "BatchNorm_0",
                            leaf_name), arr)
                consumed.add("aux:" + name)
                break

    bb_args = {k: v for k, v in args.items() if k not in consumed}
    bb_params, bb_stats = map_resnet_backbone(bb_args, auxs)
    if bb_params:
        params["backbone"] = bb_params
    if bb_stats:
        stats["backbone"] = bb_stats

    # unused accounting uses the SAME patterns the backbone mapper consumes
    unused = [n for n in args if n not in consumed
              and not _BB_BN_RX.match(n) and not _BB_CONV_RX.match(n)]
    unused += ["aux:" + n for n in auxs
               if "aux:" + n not in consumed and not _BB_BNAUX_RX.match(n)]
    return params, stats, unused


def export_multitask(params: Dict, batch_stats: Dict,
                     network: str = "resnet-50_multi", data_shape: int = 512):
    """Inverse of :func:`map_multitask`: flax trees -> (args, auxs) dicts
    keyed by the reference's exact saved-checkpoint name inventory,
    including the frozen ``gamma`` 1-vectors fix_gamma BNs persist.

    Used to synthesize reference-layout ``.params`` fixtures for the
    import→eval parity test, and to hand weights back to MXNet tooling.
    """
    taps = det_tap_names(network, data_shape)
    args: Dict[str, np.ndarray] = {}
    auxs: Dict[str, np.ndarray] = {}

    def ref_name(path):
        top = path[0]
        if top == "backbone":
            mod = "_".join(path[1:-1]).replace("_BatchNorm_0", "")
            leaf = path[-1]
            if leaf == "kernel":
                return "arg", mod + "_weight", _conv_kernel_inv
            if leaf in ("scale", "bias"):
                return "arg", mod + ("_gamma" if leaf == "scale" else "_beta"), None
            return "aux", mod + "_moving_" + leaf, None
        if top == "multi_feat":
            return "arg", "%s_conv_%s" % (
                path[1], "weight" if path[-1] == "kernel" else "bias"), (
                _conv_kernel_inv if path[-1] == "kernel" else None)
        if top == "multibox":
            kind, i = path[1].rsplit("_", 1)
            return "arg", "%s_%s_conv_%s" % (
                taps[int(i)], kind, "weight" if path[-1] == "kernel" else "bias"), (
                _conv_kernel_inv if path[-1] == "kernel" else None)
        if top == "seg":
            if path[1] == "score4_conv":
                return "arg", "score4_conv_weight", _deconv_kernel_inv
            leaf = path[-1]
            if leaf == "kernel":
                return "arg", path[1] + "_weight", _conv_kernel_inv
            if leaf == "bias":
                return "arg", path[1] + "_beta", None
            return "aux", path[1] + "_moving_" + leaf, None
        raise KeyError("unmapped tree path %r" % (path,))

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        where, name, tf = ref_name(path)
        arr = np.asarray(tree, np.float32)
        (args if where == "arg" else auxs)[name] = tf(arr) if tf else arr

    walk(params, ())
    walk(batch_stats or {}, ())

    # frozen fix_gamma gammas: every BN beta without a matching gamma
    for name in list(args):
        if name.endswith("_beta") and name[:-5] + "_gamma" not in args:
            args[name[:-5] + "_gamma"] = np.ones_like(args[name])
    return args, auxs


# ------------------------------------------------------------- the port


def count_leaves(tree) -> int:
    return sum(count_leaves(v) for v in tree.values()) if isinstance(tree, dict) else 1


@torch.no_grad()
def load_mxnet(model: torch.nn.Module, path: str, network: str = "resnet-50_multi",
               data_shape: int = 512) -> List[str]:
    """Merge a reference ``.params`` file into ``model`` (a port ``DSPNet``):
    :func:`map_multitask`'s flax-layout trees, merged subtree by subtree
    into the module's own (``utils/transfer.py::merge_mapped``: parameter
    shapes must match; a subtree the network lacks is skipped), then
    ``flax_to_state_dict`` and ``load_state_dict``. Heads absent from the
    file keep the module's weights. Returns the reference names nothing
    consumed (non-empty on a real checkpoint is a parity red flag)."""
    from dspnet_torch.utils.convert import flax_to_state_dict, to_flax_variables
    from dspnet_torch.utils.transfer import merge_mapped

    args, auxs = load_params(path)
    mapped_params, mapped_stats, unused = map_multitask(args, auxs, network, data_shape)
    variables = merge_mapped(to_flax_variables(model), mapped_params, mapped_stats)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return unused
