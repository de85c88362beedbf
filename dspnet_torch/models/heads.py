"""Multi-scale feature extraction + SSD/multitask prediction heads.

Contracts (as ``dspnet_tpu/models/heads.py``):
* extra pyramid layers: 1x1 conv (max(min_filter, f/2)) + relu, then 3x3
  stride-s pad-p conv (f) + relu — reference symbol/common.py:79-134;
* per-scale heads: 3x3 pad-1 convs emitting ``K * loc_channels`` location
  regressors and ``K * num_classes`` class logits, flattened in
  (h, w, anchor, channel) order — the reference's NCHW->NHWC transpose +
  Flatten (symbol/common.py:393-412). The anchor table is built in that
  order, so the permute to NHWC must come before the reshape;
* optional channel-L2 normalization with a learned scale (``norm_{k}``)
  before the k-th layer's convs (common.py:366-373; vgg16_reduced's
  relu4_3).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from dspnet_torch.models.layers import ConvAct, L2Normalize, conv


def num_anchors_per_cell(sizes: Sequence[float], ratios: Sequence[float]) -> int:
    return len(sizes) - 1 + len(ratios)


class MultiLayerFeature(nn.Module):
    """Append extra stride-2 pyramid layers after the backbone taps.

    ``tap_channels``: channel count of each backbone tap, in order.
    """

    def __init__(self, tap_channels: Sequence[int], num_filters, strides, pads,
                 min_filter: int = 128, kernels=()):
        super().__init__()
        # the reference asserts the preset lists line up (common.py:113);
        # a short num_filters would otherwise silently drop pyramid scales
        assert len(num_filters) == len(strides) == len(pads), (num_filters, strides, pads)
        self.extra = []  # indices k of the appended layers
        self.out_channels = list(tap_channels)
        c = tap_channels[-1]
        for k in range(len(tap_channels), len(num_filters)):
            f, s, p = num_filters[k], strides[k], pads[k]
            ksz = kernels[k] if kernels else 3
            assert f > 0
            num_1x1 = max(min_filter, f // 2)
            self.add_module(f"multi_feat_{k}_conv_1x1", ConvAct(c, num_1x1, (1, 1), (1, 1), (0, 0)))
            self.add_module(f"multi_feat_{k}_conv_3x3", ConvAct(num_1x1, f, (ksz, ksz), (s, s), (p, p)))
            self.extra.append(k)
            self.out_channels.append(f)
            c = f

    def forward(self, tap_layers):
        layers = list(tap_layers)
        for k in self.extra:
            x = getattr(self, f"multi_feat_{k}_conv_1x1")(layers[-1])
            layers.append(getattr(self, f"multi_feat_{k}_conv_3x3")(x))
        return layers


class MultiBoxHead(nn.Module):
    """Per-scale loc/cls conv heads -> concatenated (B, A, *) predictions."""

    def __init__(self, in_channels: Sequence[int], num_classes: int, sizes, ratios,
                 loc_channels: int = 5, normalizations=()):
        super().__init__()
        self.num_classes = num_classes  # including background
        self.loc_channels = loc_channels
        self.normalized = [k for k, n in enumerate(normalizations) if n > 0]
        for k in self.normalized:
            self.add_module(f"norm_{k}", L2Normalize(in_channels[k], float(normalizations[k])))
        for k, c in enumerate(in_channels):
            K = num_anchors_per_cell(sizes[k], ratios[k])
            self.add_module(f"loc_pred_{k}", conv(c, K * loc_channels, 3, 1, 1))
            self.add_module(f"cls_pred_{k}", conv(c, K * num_classes, 3, 1, 1))

    def forward(self, layers):
        loc_parts, cls_parts = [], []
        for k, x in enumerate(layers):
            if k in self.normalized:
                x = getattr(self, f"norm_{k}")(x)
            b = x.shape[0]
            loc = getattr(self, f"loc_pred_{k}")(x).permute(0, 2, 3, 1)
            cls = getattr(self, f"cls_pred_{k}")(x).permute(0, 2, 3, 1)
            loc_parts.append(loc.reshape(b, -1, self.loc_channels))
            cls_parts.append(cls.reshape(b, -1, self.num_classes))
        return torch.cat(loc_parts, dim=1), torch.cat(cls_parts, dim=1)
