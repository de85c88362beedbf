"""Load a flax variable tree of the JAX package into a port module.

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
"""

from __future__ import annotations

from typing import Iterator, Mapping, Tuple

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
