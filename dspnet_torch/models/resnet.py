"""Pre-activation ResNet backbone (identity-mappings variant), NCHW.

Architecture contract (reference symbol/resnet.py:11-169, as in
``dspnet_tpu/models/resnet.py``):
* a leading fix_gamma BatchNorm on the raw data (``bn_data``), then a 7x7/2
  pad-3 conv -> BN -> relu -> 3x3/2 pad-1 maxpool;
* 4 stages; stage i > 1 downsamples in its first unit; bottleneck units for
  depth >= 50 (filters [64,256,512,1024,2048]) else basic
  (filters [64,64,128,256,512]);
* pre-act residual units: BN-relu-conv chains, projection shortcut from the
  first activation when dims change.

The SSD factory taps the residual-add outputs, which the reference names
``_plusN`` with N counting adds across the network; ``forward`` returns every
add output in order so callers index the same way. Submodule names follow the
flax parameter tree (``stage1_unit1/bn1`` ...), which utils/convert.py relies on.
"""

from __future__ import annotations

import numpy as np
import torch.nn.functional as F
from torch import nn

from dspnet_torch.models.layers import BatchNorm, conv, max_pool

UNITS = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
    200: [3, 24, 36, 3],
    269: [3, 30, 48, 8],
}


def filters_for(num_layers: int) -> list[int]:
    if num_layers >= 50:
        return [64, 256, 512, 1024, 2048]
    return [64, 64, 128, 256, 512]


def tap_index(name: str) -> int:
    """'_plus7' -> 7 (reference internal-symbol naming)."""
    assert name.startswith("_plus"), name
    return int(name[len("_plus"):])


def tap_stage(num_layers: int, name: str) -> int:
    """0-based stage whose residual adds include ``name``."""
    bounds = np.cumsum(UNITS[num_layers])
    return int(np.searchsorted(bounds, tap_index(name) + 1))


def tap_channels(num_layers: int, name: str) -> int:
    return filters_for(num_layers)[tap_stage(num_layers, name) + 1]


class ResidualUnit(nn.Module):
    """Pre-act residual unit (reference symbol/resnet.py:11-68)."""

    def __init__(self, in_channels, num_filter, stride, dim_match, bottle_neck=True):
        super().__init__()
        self.dim_match = dim_match
        self.bottle_neck = bottle_neck
        self.bn1 = BatchNorm(in_channels)
        if bottle_neck:
            mid = num_filter // 4
            self.conv1 = conv(in_channels, mid, 1, 1, 0, use_bias=False)
            self.bn2 = BatchNorm(mid)
            self.conv2 = conv(mid, mid, 3, stride, 1, use_bias=False)
            self.bn3 = BatchNorm(mid)
            self.conv3 = conv(mid, num_filter, 1, 1, 0, use_bias=False)
        else:
            self.conv1 = conv(in_channels, num_filter, 3, stride, 1, use_bias=False)
            self.bn2 = BatchNorm(num_filter)
            self.conv2 = conv(num_filter, num_filter, 3, 1, 1, use_bias=False)
        if not dim_match:
            self.sc = conv(in_channels, num_filter, 1, stride, 0, use_bias=False)

    def forward(self, x):
        act1 = F.relu(self.bn1(x))
        c = self.conv1(act1)
        c = self.conv2(F.relu(self.bn2(c)))
        if self.bottle_neck:
            c = self.conv3(F.relu(self.bn3(c)))
        shortcut = x if self.dim_match else self.sc(act1)
        return c + shortcut


class ResNet(nn.Module):
    """Backbone; ``forward`` returns the list of residual-add outputs
    (``plus_outputs[N]`` == the reference's ``_plusN`` internal)."""

    def __init__(self, num_layers: int = 50):
        super().__init__()
        self.num_layers = num_layers
        filter_list = filters_for(num_layers)
        bottle_neck = num_layers >= 50
        self.bn_data = BatchNorm(3, fix_gamma=True)
        self.conv0 = conv(3, filter_list[0], 7, 2, 3, use_bias=False)
        self.bn0 = BatchNorm(filter_list[0])
        self.unit_names = []
        in_ch = filter_list[0]
        for i, n_units in enumerate(UNITS[num_layers]):
            for j in range(n_units):
                name = f"stage{i + 1}_unit{j + 1}"
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(name, ResidualUnit(
                    in_ch, filter_list[i + 1], stride, j > 0, bottle_neck))
                self.unit_names.append(name)
                in_ch = filter_list[i + 1]

    def forward(self, x):
        x = self.conv0(self.bn_data(x))
        x = max_pool(F.relu(self.bn0(x)), 3, 2, 1)
        plus_outputs = []
        for name in self.unit_names:
            x = getattr(self, name)(x)
            plus_outputs.append(x)
        return plus_outputs
