"""Move weights between a flax variable tree of the JAX package and a port
module.

The port's submodules carry the flax module names (``backbone/stage1_unit1/
bn1`` -> ``backbone.stage1_unit1.bn1``), so each flax leaf has one torch
tensor:

* ``…/kernel`` of a conv (HWIO)              -> ``….weight`` (OIHW)
* ``…/ConvTranspose_0/kernel`` (kh, kw, in, out) -> ``….weight`` (in, out, kh, kw)
  with a spatial flip: flax's ConvTranspose correlates with the kernel as it
  is, torch's ``conv_transpose2d`` is the adjoint of correlation (the kernel
  flipped) — the same relation as MXNet's Deconvolution
  (``dspnet_tpu/utils/mxnet_import.py::_deconv_kernel_inv``);
* ``…/BatchNorm_0/{scale,bias}``             -> ``….{weight,bias}``
* ``batch_stats …/BatchNorm_0/{mean,var}``   -> ``….{running_mean,running_var}``
* ``…/bias`` of a conv                      -> ``….bias``
* ``multibox/norm_{k}/scale`` (L2Normalize)   -> ``multibox.norm_{k}.scale``

``to_flax_variables`` is the exact inverse, and ``flax_path`` names the flax
leaf of one torch tensor. Both read the module kind from the port's naming
contract: a BatchNorm's module name is ``bn_data``, ``bn<N>``, ``bn`` (an
inception ``ConvBN``'s) or ends in ``_bn``; the one transposed conv is ``score4_conv``; an L2Normalize is
``norm_<k>``; every other module with a ``weight`` is a conv (VGG16's
``conv1_1`` … ``fc7``, the dilated ``fc6`` included).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def flax_to_state_dict(variables_np: Mapping) -> dict:
    """``{"params", "batch_stats"}`` nested dicts of numpy arrays -> a torch
    state dict. Raises on a leaf it has no rule for and on two leaves that
    map to one tensor."""
    state = {}
    for collection in variables_np:
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unexpected variable collection {collection!r}")
        for path, arr in _leaves(variables_np[collection]):
            leaf = _LEAF.get((collection, path[-1]))
            if leaf is None:
                raise KeyError(f"no conversion for flax leaf {collection}/{'/'.join(path)}")
            modules = list(path[:-1])
            if path[-1] == "scale" and modules and _NORM_MODULE.match(modules[-1]):
                leaf = "scale"
            if modules and modules[-1] == "BatchNorm_0":
                modules.pop()
            if path[-1] == "kernel" and modules and modules[-1] == "ConvTranspose_0":
                modules.pop()
                arr = np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
            elif path[-1] == "kernel":
                if arr.ndim != 4:
                    raise ValueError(f"conv kernel {'/'.join(path)} has shape {arr.shape}")
                arr = np.transpose(arr, (3, 2, 0, 1))
            key = ".".join(modules + [leaf])
            if key in state:
                raise KeyError(f"two flax leaves map to {key}")
            state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


@torch.no_grad()
def load_flax_variables(model: nn.Module, variables_np: Mapping) -> nn.Module:
    """Copy a flax variable tree into ``model`` (strict: every torch tensor
    must be filled and every flax leaf consumed exactly once). Values are
    cast to each tensor's dtype and device."""
    state = flax_to_state_dict(variables_np)
    model.load_state_dict(state, strict=True)
    return model


_BN_MODULE = re.compile(r"^(bn_data|bn\d*)$|_bn$")
_DECONV_MODULE = "score4_conv"
_NORM_MODULE = re.compile(r"^norm_\d+$")
_NORM_LEAF = {"scale": ("params", "scale")}
_BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}
_CONV_LEAF = {"weight": ("params", "kernel"), "bias": ("params", "bias")}


def _flax_leaf(name: str) -> Tuple[str, Tuple[str, ...]]:
    """torch tensor name -> (collection, flax path)."""
    *modules, leaf = name.split(".")
    if not modules:
        raise KeyError(f"no flax leaf for top-level tensor {name!r}")
    if _BN_MODULE.search(modules[-1]):
        table, extra = _BN_LEAF, ("BatchNorm_0",)
    elif _NORM_MODULE.match(modules[-1]):
        table, extra = _NORM_LEAF, ()
    elif modules[-1] == _DECONV_MODULE:
        table, extra = _CONV_LEAF, ("ConvTranspose_0",)
    else:
        table, extra = _CONV_LEAF, ()
    if leaf not in table:
        raise KeyError(f"no flax leaf for torch tensor {name!r}")
    collection, flax_leaf = table[leaf]
    return collection, tuple(modules) + extra + (flax_leaf,)


def flax_path(name: str) -> str:
    """The '/'-joined flax path (within its collection) of a torch tensor:
    ``backbone.stage1_unit1.bn1.weight`` ->
    ``backbone/stage1_unit1/bn1/BatchNorm_0/scale``. The JAX solver's freeze
    regex matches against this path."""
    return "/".join(_flax_leaf(name)[1])


def to_flax_variables(tensors: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, dict]:
    """A port module (or a name -> tensor map such as a state dict) ->
    ``{"params", "batch_stats"}`` nested dicts of float32 numpy arrays in the
    flax layout; the exact inverse of ``flax_to_state_dict``. A collection
    with no tensor is left out."""
    if isinstance(tensors, nn.Module):
        tensors = tensors.state_dict()
    out: Dict[str, dict] = {}
    for name, t in tensors.items():
        collection, path = _flax_leaf(name)
        arr = t.detach().float().cpu().numpy()
        if path[-1] == "kernel" and path[-2] == "ConvTranspose_0":
            arr = np.transpose(arr, (2, 3, 0, 1))[::-1, ::-1]
        elif path[-1] == "kernel":
            arr = np.transpose(arr, (2, 3, 1, 0))
        node = out.setdefault(collection, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return out
