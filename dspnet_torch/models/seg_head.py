"""Pyramid-pooling semantic-segmentation head, reference-exact form.

Contract (reference symbol/multitask_symbol_builder.py:541-589, as
``dspnet_tpu/models/seg_head.py``):
* res3 / res4 taps are gradient-blocked, then 1x1-reduce -> BN -> 3x3 -> BN
  (128 / 256 channels);
* the top backbone feature goes through BatchNorm directly (the reference's
  ``res5_reduced`` conv is dead code);
* three avg-pool branches (k1/s1 identity, k2/s2, k4/s4) of the BN'd top
  feature, each 1x1-conv (128/256/512) + BN;
* all six streams bilinear-resized (align corners) to (H/8, W/8) and
  concatenated in the order [s4, s2, s1, r5, r4, r3] (builder.py:582);
* one 3x3 conv -> seg_classes -> BN -> 4x4/2 transposed conv to
  (H/4, W/4, seg_classes) logits.

The JAX head computes the same linear map through a tap-split (1x1
contractions at native resolution, resize, 9 shifted adds) to keep the
concat out of HBM on the TPU; here the concat is materialized, so the two
agree to float32 reassociation.

``fast=True`` is the JAX package's opt-in ``seg_fast`` head
(``dspnet_tpu/models/seg_head.py``, ``_ConcatConv3x3.fast``): the one
``score3_conv`` kernel is sliced per stream in the concat order, each slice
runs as a 3x3 pad-1 conv at its stream's native resolution, each partial
result is resized (align corners) to H/8 x W/8 unless it is already there,
and the partial results are summed in float32 (FCN-style score then
upsample). Conv and resize do not commute, so its numbers differ from the
exact head's; train and evaluate with the same setting. The parameters are
the exact head's, so a checkpoint loads into either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dspnet_torch.models.layers import (
    BatchNorm,
    Deconv2x,
    avg_pool,
    conv,
    resize_bilinear_align_corners,
)


class SegHead(nn.Module):
    def __init__(self, res3_channels: int, res4_channels: int, feat_channels: int,
                 seg_classes: int = 19, fast: bool = False):
        super().__init__()
        self.fast = fast
        self.res3_reduced = conv(res3_channels, 128, 1, 1, 0, use_bias=False)
        self.res3_reduced_bn = BatchNorm(128, fix_gamma=True)
        self.res3_reduced2 = conv(128, 128, 3, 1, 1, use_bias=False)
        self.res3_reduced2_bn = BatchNorm(128, fix_gamma=True)
        self.res4_reduced = conv(res4_channels, 256, 1, 1, 0, use_bias=False)
        self.res4_reduced_bn = BatchNorm(256, fix_gamma=True)
        self.res4_reduced2 = conv(256, 256, 3, 1, 1, use_bias=False)
        self.res4_reduced2_bn = BatchNorm(256, fix_gamma=True)
        self.res5_reduced_bn = BatchNorm(feat_channels, fix_gamma=True)
        self.score2_pool4 = conv(feat_channels, 128, 1, 1, 0, use_bias=False)
        self.score2_pool4_bn = BatchNorm(128, fix_gamma=True)
        self.score2_pool2 = conv(feat_channels, 256, 1, 1, 0, use_bias=False)
        self.score2_pool2_bn = BatchNorm(256, fix_gamma=True)
        self.score2_pool1 = conv(feat_channels, 512, 1, 1, 0, use_bias=False)
        self.score2_pool1_bn = BatchNorm(512, fix_gamma=True)
        concat_channels = 128 + 256 + 512 + feat_channels + 256 + 128
        self.score3_conv = conv(concat_channels, seg_classes, 3, 1, 1, use_bias=False)
        self.score3_conv_bn = BatchNorm(seg_classes, fix_gamma=True)
        self.score4_conv = Deconv2x(seg_classes, seg_classes)

    def forward(self, res3, res4, conv_feat, grid_hw):
        r3 = self.res3_reduced_bn(self.res3_reduced(res3.detach()))  # BlockGrad
        r3 = self.res3_reduced2_bn(self.res3_reduced2(r3))
        r4 = self.res4_reduced_bn(self.res4_reduced(res4.detach()))
        r4 = self.res4_reduced2_bn(self.res4_reduced2(r4))
        r5 = self.res5_reduced_bn(conv_feat)

        s4 = self.score2_pool4_bn(self.score2_pool4(avg_pool(r5, 4, 4)))
        s2 = self.score2_pool2_bn(self.score2_pool2(avg_pool(r5, 2, 2)))
        s1 = self.score2_pool1_bn(self.score2_pool1(avg_pool(r5, 1, 1)))

        streams = [s4, s2, s1, r5, r4, r3]  # concat order: builder.py:582
        if self.fast:
            x = self._score_then_upsample(streams, grid_hw)
        else:
            x = torch.cat([resize_bilinear_align_corners(s, grid_hw) for s in streams], dim=1)
            x = self.score3_conv(x)
        return self.score4_conv(self.score3_conv_bn(x))

    def _score_then_upsample(self, streams, grid_hw):
        weight = self.score3_conv.weight
        out = None
        off = 0
        for s in streams:
            c = s.shape[1]
            y = F.conv2d(s, weight[:, off:off + c].to(s.dtype), padding=1)
            off += c
            y = resize_bilinear_align_corners(y, grid_hw).float()
            out = y if out is None else out + y
        return out.to(streams[0].dtype)
