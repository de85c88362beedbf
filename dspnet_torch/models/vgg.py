"""VGG16-reduced backbone (the SSD variant), NCHW (counterpart of
``dspnet_tpu/models/vgg.py``).

Reference symbol/vgg16_reduced.py:3-86: the VGG16 conv trunk, pool3 with
the 'full' (ceil) convention, pool5 3x3 stride 1 pad 1, ``fc6`` a 3x3 conv
with dilation 6 and pad 6, ``fc7`` a 1x1 conv. The SSD presets tap
``relu4_3`` (stride 8, 512 channels) and ``relu7`` (stride 16, 1024).
Submodules carry the flax names (``conv1_1`` … ``conv5_3``, ``fc6``,
``fc7``), which utils/convert.py relies on.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from dspnet_torch.models.layers import conv, max_pool, max_pool_full

#: (block, convs, filters)
_BLOCKS = ((1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512))

TAP_CHANNELS = {"relu4_3": 512, "relu7": 1024}


class VGG16Reduced(nn.Module):
    def __init__(self):
        super().__init__()
        c = 3
        for blk, n, f in _BLOCKS:
            for i in range(n):
                self.add_module(f"conv{blk}_{i + 1}", conv(c, f, 3, 1, 1))
                c = f
        self.fc6 = conv(512, 1024, 3, 1, 6, dilation=6)
        self.fc7 = conv(1024, 1024, 1, 1, 0)

    def _block(self, x, blk, n):
        for i in range(n):
            x = F.relu(getattr(self, f"conv{blk}_{i + 1}")(x))
        return x

    def forward(self, x) -> Dict[str, torch.Tensor]:
        taps = {}
        x = max_pool(self._block(x, 1, 2), 2, 2)
        x = max_pool(self._block(x, 2, 2), 2, 2)
        x = max_pool_full(self._block(x, 3, 3), 2, 2)  # pooling_convention="full"
        x = self._block(x, 4, 3)
        taps["relu4_3"] = x
        x = max_pool(x, 2, 2)
        x = max_pool(self._block(x, 5, 3), 3, 1, 1)  # pool5: stride 1 keeps the size
        x = F.relu(self.fc7(F.relu(self.fc6(x))))
        taps["relu7"] = x
        return taps
