"""Per-module output shapes (counterpart of ``dspnet_tpu/utils/shapes.py``).

The reference checks its networks against golden tables of intermediate
shapes (utils.py:35-37, internal_out_shapes_{320,512}). :func:`intermediate_shapes`
runs the forward on ``torch.device("meta")``, so no weights are made and no
arithmetic is done, records every module's output through forward hooks and
names it as the JAX function names flax's captured intermediates:
``<flax module path>/__call__/0``, then ``/<i>`` or ``/<key>`` into a tuple or
dict output. A module's flax path comes from ``utils/convert.py``'s map
from torch names to flax leaves (a BatchNorm ``…/bn1`` is flax's
``…/bn1/BatchNorm_0``, the seg head's transposed conv ``…/ConvTranspose_0``);
a module without parameters of its own keeps its torch name with ``/``.
Shapes are NHWC as in flax: a module's 4-D output (NCHW inside the port) is
reported as (N, H, W, C); the network's own outputs are NHWC already.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from dspnet_torch.utils.convert import flax_path


def module_path(name: str, module: nn.Module) -> str:
    """The flax module path of a port module (see the module docstring)."""
    own = next((n for n, _ in module.named_parameters(recurse=False)), None)
    if own is None:
        return name.replace(".", "/")
    return flax_path(f"{name}.{own}").rsplit("/", 1)[0]


def intermediate_shapes(model: nn.Module, data_shape, batch: int = 1, train: bool = False) -> Dict[str, tuple]:
    """{flax module path/__call__/0[/i]: NHWC output shape} of one forward of
    ``model`` at ``data_shape`` (H, W) on the meta device. The model must be
    built there (``create_model(..., device="meta")``): it then holds no
    weights, and the forward computes nothing."""
    if any(t.device.type != "meta" for t in model.state_dict().values()):
        raise ValueError('intermediate_shapes runs on a model built on torch.device("meta")')
    H, W = data_shape
    out: Dict[str, tuple] = {}

    def record(key, value, nchw):
        if isinstance(value, torch.Tensor):
            shape = tuple(value.shape)
            out[key] = (shape[0], shape[2], shape[3], shape[1]) if nchw and len(shape) == 4 else shape
        elif isinstance(value, dict):
            for k, v in value.items():
                record(f"{key}/{k}", v, nchw)
        elif isinstance(value, (list, tuple)):
            for i, v in enumerate(value):
                record(f"{key}/{i}", v, nchw)

    def hook(name, module):
        path = module_path(name, module)
        prefix = f"{path}/__call__/0" if path else "__call__/0"
        return lambda _m, _args, output: record(prefix, output, nchw=bool(name))

    handles = [m.register_forward_hook(hook(n, m)) for n, m in model.named_modules()]
    was_training = model.training
    try:
        model.train(train)
        with torch.no_grad():
            model(torch.zeros((batch, H, W, 3), device="meta"))
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return dict(sorted(out.items()))


def print_summary(model: nn.Module, data_shape, batch: int = 1, train: bool = False, log_fn=print):
    """Log one ``path shape`` line per recorded output; returns the shapes."""
    shapes = intermediate_shapes(model, data_shape, batch, train)
    for name, shape in shapes.items():
        log_fn(f"{name:<70s} {shape}")
    return shapes
