"""Shared NCHW building blocks (counterparts of ``dspnet_tpu/models/layers.py``).

The public model API keeps the JAX package's NHWC layout; inside, modules run
PyTorch's NCHW. BatchNorm follows the MXNet conventions of the reference
(eps 2e-5, ``fix_gamma`` -> no learned scale). The space-to-depth stem and
its custom gradients in the JAX package are XLA workarounds for the same
7x7/2 convolution, so the stem here is a plain ``conv``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 2e-5
BN_MOMENTUM = 0.9


class _RematContext(threading.local):
    #: inside a rematerialised unit: ("record" | "replay", {id(BatchNorm): (stats, stats_reduce)})
    remat = None


_CTX = _RematContext()


@contextlib.contextmanager
def _remat_mode(mode, store):
    prev = _CTX.remat
    _CTX.remat = (mode, store)
    try:
        yield
    finally:
        _CTX.remat = prev


def _remat_contexts():
    store = {}
    return _remat_mode("record", store), _remat_mode("replay", store)


class _Replayed(torch.autograd.Function):
    """In a recompute: the reduced statistics as the first pass computed
    them (no collective runs out of order). Its gradient is that of the
    reduction, a sum over the ranks, whose adjoint is the same sum."""

    @staticmethod
    def forward(ctx, local, reduced, reduce):
        ctx.reduce = reduce
        return reduced.clone()

    @staticmethod
    def backward(ctx, grad):
        return ctx.reduce(grad.clone()), None, None


def checkpoint_module(module: nn.Module, x):
    """``module(x)`` rematerialised in the backward pass
    (``torch.utils.checkpoint``, non-reentrant: the solver differentiates
    with ``torch.autograd.grad``), the counterpart of the JAX package's
    ``nn.remat`` of a residual unit. The recompute runs after the caller's
    ``functional_call`` and train/eval flag are gone, so the unit's current
    tensors and flag are captured here and restored for it. BatchNorms
    update their running statistics in the first pass only, and a
    BatchNorm with a ``stats_reduce`` reuses the first pass's reduced
    statistics."""
    from torch.utils.checkpoint import checkpoint

    params = list(module.named_parameters())
    # the running statistics are closed over, not inputs: the first pass
    # updates them in place, which the checkpoint's saved inputs forbid
    buffers = dict(module.named_buffers())
    training = module.training

    def run(inp, *tensors):
        was = module.training
        module.train(training)
        try:
            return torch.func.functional_call(module, {**dict(zip((n for n, _ in params), tensors)), **buffers},
                                              (inp,))
        finally:
            module.train(was)

    return checkpoint(run, x, *(t for _, t in params), use_reentrant=False, context_fn=_remat_contexts,
                      preserve_rng_state=False)


class BatchNorm(nn.Module):
    """MXNet-convention BatchNorm (momentum 0.9, eps 2e-5).

    ``fix_gamma=True`` mirrors mx.sym.BatchNorm(fix_gamma=True): no scale
    parameter, only the bias.

    Training mode is the JAX BatchNorm's formula (``dspnet_tpu/models/
    layers.py::_BatchNormImpl``), differentiated by autograd through plain
    ops: batch statistics accumulated in float32 with the fast-variance
    formula ``var = max(mean(x^2) - mean^2, 0)`` (the biased variance), the
    normalize folded into ``mul = rsqrt(var + eps) * scale`` and
    ``add = bias - mean * mul`` in float32 and applied as
    ``x * mul + add`` in the activation dtype. The running statistics update
    in place, outside autograd, as ``0.9 * old + 0.1 * batch``. (Not
    ``F.batch_norm(training=True)``: its momentum weighs the batch, not the
    old value, and it updates the running variance with the unbiased
    estimate.)

    ``stats_reduce`` (None: the local batch's statistics) is set by the
    solver's data-parallel step: a differentiable sum over the ranks, applied
    to the stacked (mean, mean square, 1) of each channel, so the mean and
    mean square are those of the global batch (the sums over the world
    size), as a JAX step over a sharded batch computes them. Inside
    :func:`checkpoint_module` the running statistics update in the first
    pass only (``running_updates`` counts the updates, for the tests), and
    the recompute reuses the first pass's reduced statistics.

    Eval mode is one ``F.batch_norm`` pass, which works in float32 and
    rounds once to the activation dtype; a weight cast to another dtype than
    the running statistics (the solver's bf16 compute over float32 stats)
    is brought to the statistics' dtype first.
    """

    def __init__(self, num_features: int, fix_gamma: bool = False, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        if fix_gamma:
            self.register_parameter("weight", None)
        else:
            self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.running_updates = 0
        self.stats_reduce = None

    def forward(self, x):
        if not self.training:
            stats_dtype = self.running_mean.dtype
            weight = None if self.weight is None else self.weight.to(stats_dtype)
            return F.batch_norm(x, self.running_mean, self.running_var, weight,
                                self.bias.to(stats_dtype), training=False, eps=self.eps)
        xf = x.float()
        dims = (0, 2, 3)
        mean = xf.mean(dims)
        mean2 = (xf * xf).mean(dims)
        mode, store = _CTX.remat or (None, None)
        recorded = store.get(id(self)) if mode == "replay" else None
        reduce = recorded[1] if recorded is not None else self.stats_reduce
        if reduce is not None:
            # the third row sums to the world size
            stats = torch.stack([mean, mean2, torch.ones_like(mean)])
            if recorded is not None:
                stats = _Replayed.apply(stats, recorded[0], reduce)
            else:
                stats = reduce(stats)
                if mode == "record":
                    store[id(self)] = (stats.detach(), reduce)
            mean, mean2 = (stats[:2] / stats[2]).unbind(0)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        if mode != "replay":
            with torch.no_grad():
                m = BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
            self.running_updates += 1
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight.float()
        add = self.bias.float() - mean * mul
        return x * mul.to(x.dtype)[:, None, None] + add.to(x.dtype)[:, None, None]


def conv(in_channels, features, kernel, stride=1, pad="same_explicit", use_bias=True, dilation=1):
    """MXNet-style Convolution with explicit symmetric padding (VGG16's
    ``fc6`` is the dilated one: 3x3, dilation 6, pad 6)."""
    if isinstance(kernel, int):
        kernel = (kernel, kernel)
    if isinstance(stride, int):
        stride = (stride, stride)
    if pad == "same_explicit":
        pad = ((kernel[0] - 1) // 2, (kernel[1] - 1) // 2)
    if isinstance(pad, int):
        pad = (pad, pad)
    return nn.Conv2d(in_channels, features, tuple(kernel), tuple(stride), tuple(pad), dilation=dilation,
                     bias=use_bias)


class ConvAct(nn.Module):
    """conv + relu — reference symbol/common.py:4-38 (its optional BatchNorm
    is off in every preset)."""

    def __init__(self, in_channels, features, kernel=(1, 1), stride=(1, 1), pad=(0, 0)):
        super().__init__()
        self.conv = conv(in_channels, features, kernel, stride, pad)

    def forward(self, x):
        return F.relu(self.conv(x))


def max_pool(x, kernel, stride, pad=0):
    """MXNet 'valid'-convention max pool: floor output size, -inf padding."""
    return F.max_pool2d(x, kernel, stride, pad)


def _full_out(size: int, k: int, s: int, p: int) -> int:
    return -(-(size + 2 * p - k) // s) + 1  # ceil


def max_pool_full(x, kernel: int, stride: int, pad: int = 0):
    """MXNet 'full'-convention max pool (ceil output size, the extra cells
    padded with -inf on the right/bottom): VGG16-reduced's pool3.

    ``ceil_mode=True`` gives the same windows as long as no window starts
    in the padding (torch drops such a window, MXNet keeps it); the output
    size is checked against MXNet's."""
    out = F.max_pool2d(x, kernel, stride, pad, ceil_mode=True)
    want = tuple(_full_out(n, kernel, stride, pad) for n in x.shape[-2:])
    if tuple(out.shape[-2:]) != want:
        raise ValueError(f"max_pool_full on {tuple(x.shape[-2:])}: a window starts in the padding "
                         f"(torch {tuple(out.shape[-2:])}, MXNet {want})")
    return out


class L2Normalize(nn.Module):
    """Channel L2 normalization with a learned per-channel ``scale``
    (reference symbol/common.py:366-373; ``dspnet_tpu/models/layers.py::
    L2Normalize``): ``x / sqrt(sum_c x^2 + 1e-10) * scale``, NCHW. The sum
    of squares and the division run in float32 whatever the input dtype."""

    def __init__(self, channels: int, init_scale: float = 20.0):
        super().__init__()
        self.init_scale = float(init_scale)
        self.scale = nn.Parameter(torch.full((channels,), self.init_scale))

    def forward(self, x):
        xf = x.float()
        norm = torch.sqrt((xf * xf).sum(dim=1, keepdim=True) + 1e-10)
        return (xf / norm * self.scale.float()[:, None, None]).to(x.dtype)


def avg_pool(x, kernel, stride, pad=0):
    """Average pool, padding counted in the divisor (flax's default)."""
    return F.avg_pool2d(x, kernel, stride, pad, count_include_pad=True)


def resize_bilinear_align_corners(x, target_hw: Sequence[int]):
    """Bilinear resize with align_corners=True on NCHW.

    The reference's GridGenerator(identity affine) + BilinearSampler pair
    (multitask_symbol_builder.py:574-581): source coordinate
    ``x_src = x_dst * (W_src - 1) / (W_dst - 1)``; a size-1 source or target
    axis reads source index 0.
    """
    th, tw = int(target_hw[0]), int(target_hw[1])
    if tuple(x.shape[2:]) == (th, tw):
        return x
    # fractional weights truncate to zero in integer dtypes
    if not x.is_floating_point():
        raise TypeError(f"bilinear resize needs a floating dtype, got {x.dtype}")
    return F.interpolate(x, size=(th, tw), mode="bilinear", align_corners=True)


def bilinear_upsample_kernel(size: int, dtype=np.float32) -> np.ndarray:
    """Bilinear upsampling filter for deconv init
    (reference multi_init.py:13-21, upsample_filt)."""
    factor = (size + 1) // 2
    center = factor - 1 if size % 2 == 1 else factor - 0.5
    og = np.ogrid[:size, :size]
    return ((1 - abs(og[0] - center) / factor) * (1 - abs(og[1] - center) / factor)).astype(dtype)


class Deconv2x(nn.ConvTranspose2d):
    """4x4 stride-2 pad-1 transposed conv (exact 2x upsample), no bias —
    mx.sym.Deconvolution(kernel=4, stride=2, pad=1, no_bias).

    The weight is torch's ``(in, out, kh, kw)``. ``conv_transpose2d`` is the
    true adjoint of correlation (it flips the kernel), like MXNet's and unlike
    flax's ConvTranspose, so a flax kernel loads with a spatial flip plus a
    transpose (utils/convert.py). ``reset_bilinear`` is the reference init
    (multi_init.py:160-168): the bilinear filter on the channel diagonal.
    """

    def __init__(self, in_channels: int, features: int):
        super().__init__(in_channels, features, 4, stride=2, padding=1, bias=False)

    @torch.no_grad()
    def reset_bilinear(self):
        self.weight.zero_()
        filt = torch.from_numpy(bilinear_upsample_kernel(4))
        for i in range(min(self.in_channels, self.out_channels)):
            self.weight[i, i].copy_(filt)
