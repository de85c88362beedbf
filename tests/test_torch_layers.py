"""Each layer of the PyTorch port vs its flax counterpart, float32 on the CPU.

Weights are seeded numpy arrays loaded into both sides (torch through
``utils/convert.load_flax_variables``). Tolerance rtol = atol = 1e-5: the
same math in f32, with other summation orders inside the convolutions."""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from flax import linen as fnn

from dspnet_tpu.models import layers as jl
from dspnet_torch.models import layers as tl
from dspnet_torch.utils.convert import load_flax_variables
from tests.torch_parity import random_flax_variables

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


class _Holder(nn.Module):
    """A torch container whose one child carries the flax name ``m``."""

    def __init__(self, m):
        super().__init__()
        self.m = m


def _parity(flax_module, torch_module, x, seed):
    variables = random_flax_variables(flax_module, x.shape, seed)
    want = np.asarray(flax_module.apply(variables, jnp.asarray(x)))
    holder = load_flax_variables(_Holder(torch_module).eval(), variables)
    got = _nhwc(holder.m(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


class _FlaxBN(fnn.Module):
    fix_gamma: bool

    @fnn.compact
    def __call__(self, x):
        return jl.BatchNorm(fix_gamma=self.fix_gamma, name="m")(x, train=False)


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batchnorm_eval(rng, fix_gamma):
    x = rng.normal(0, 2, (2, 5, 6, 16)).astype(np.float32)
    _parity(_FlaxBN(fix_gamma), tl.BatchNorm(16, fix_gamma=fix_gamma), x, seed=1)


def test_batchnorm_training_mode_raises():
    """Training mode raised until it was ported; it now normalizes with the
    batch statistics (biased variance) and raises nothing. Its parity with
    the JAX BatchNorm is in test_torch_train.py."""
    bn = tl.BatchNorm(4).train()
    x = torch.arange(32, dtype=torch.float32).reshape(2, 4, 2, 2)
    y = bn(x)
    xd = x.double()
    want = (xd - xd.mean((0, 2, 3), keepdim=True)) / torch.sqrt(
        xd.var((0, 2, 3), unbiased=False, keepdim=True) + tl.BN_EPS)
    np.testing.assert_allclose(y.detach().numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


class _FlaxConv(fnn.Module):
    features: int
    kernel: int
    stride: int
    pad: int
    use_bias: bool

    @fnn.compact
    def __call__(self, x):
        return jl.conv(x, self.features, self.kernel, self.stride, self.pad,
                       use_bias=self.use_bias, name="m")


@pytest.mark.parametrize("kernel,stride,pad,use_bias", [
    (7, 2, 3, False),  # the stem
    (3, 2, 1, False),  # a downsampling unit
    (3, 1, 1, True),   # the heads
    (1, 2, 0, False),  # a projection shortcut
])
def test_padded_conv(rng, kernel, stride, pad, use_bias):
    x = rng.normal(0, 1, (2, 13, 18, 6)).astype(np.float32)
    _parity(_FlaxConv(8, kernel, stride, pad, use_bias),
            tl.conv(6, 8, kernel, stride, pad, use_bias=use_bias), x, seed=2)


@pytest.mark.parametrize("hw", [(13, 18), (16, 32)])
def test_max_pool(rng, hw):
    # all-negative input: the -inf padding must never win
    x = -np.abs(rng.normal(0, 1, (2,) + hw + (4,))).astype(np.float32) - 1.0
    want = np.asarray(jl.max_pool(jnp.asarray(x), 3, 2, 1))
    got = _nhwc(tl.max_pool(_nchw(x), 3, 2, 1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_avg_pool(rng, k):
    x = rng.normal(0, 1, (2, 9, 17, 4)).astype(np.float32)  # ragged: floor size
    want = np.asarray(jl.avg_pool(jnp.asarray(x), k, k))
    got = _nhwc(tl.avg_pool(_nchw(x), k, k))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("src,dst", [((4, 8), (16, 32)), ((1, 2), (16, 32)), ((16, 32), (16, 32)),
                                     ((5, 7), (16, 32))])
def test_resize_bilinear_align_corners(rng, src, dst):
    x = rng.normal(0, 1, (2,) + src + (3,)).astype(np.float32)
    want = np.asarray(jl.resize_bilinear_align_corners(jnp.asarray(x), dst))
    got = _nhwc(tl.resize_bilinear_align_corners(_nchw(x), dst))
    np.testing.assert_allclose(got, want, **TOL)


class _FlaxDeconv(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return jl.Deconv2x(5, name="m")(x)


def test_deconv2x_random_weights_pin_the_flip(rng):
    """Random, non-symmetric kernels: a missing spatial flip or in/out swap
    in the converter fails here (the bilinear init is symmetric and would
    hide both)."""
    x = rng.normal(0, 1, (2, 6, 9, 5)).astype(np.float32)
    _parity(_FlaxDeconv(), tl.Deconv2x(5, 5), x, seed=3)


def test_deconv2x_bilinear_init_matches_flax_init():
    flax_init = _FlaxDeconv().init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 5)))
    holder = load_flax_variables(_Holder(tl.Deconv2x(5, 5)), flax_init)
    want = tl.Deconv2x(5, 5)
    want.reset_bilinear()
    torch.testing.assert_close(holder.m.weight, want.weight, rtol=0, atol=0)


class _FlaxConvAct(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return jl.ConvAct(8, (3, 3), (2, 2), (1, 1), name="m")(x)


def test_conv_act(rng):
    x = rng.normal(0, 1, (2, 9, 12, 6)).astype(np.float32)
    _parity(_FlaxConvAct(), tl.ConvAct(6, 8, (3, 3), (2, 2), (1, 1)), x, seed=4)


def test_converter_rejects_leftover_leaf(rng):
    x = rng.normal(0, 1, (1, 5, 5, 4)).astype(np.float32)
    variables = random_flax_variables(_FlaxBN(False), x.shape, seed=5)
    variables["params"]["extra"] = {"kernel": np.zeros((1, 1, 4, 4), np.float32)}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_flax_variables(_Holder(tl.BatchNorm(4)), variables)
    variables["params"]["m"]["BatchNorm_0"]["gamma"] = np.ones(4, np.float32)
    with pytest.raises(KeyError, match="no conversion"):
        load_flax_variables(_Holder(tl.BatchNorm(4)), variables)
