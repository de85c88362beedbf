"""InceptionV3 backbone, NCHW (counterpart of ``dspnet_tpu/models/inception.py``).

Reference symbol/inceptionv3.py:10-168: the standard InceptionV3 with a
fix_gamma BatchNorm after every conv. Its BatchNorm takes MXNet's default
eps 1e-3 (the reference passes none), not the 2e-5 that the resnet and
seg symbols pass. The SSD presets tap ``ch_concat_mixed_7_chconcat`` (the end of
the 17x17 stage, 768 channels) and ``ch_concat_mixed_10_chconcat`` (the
end of the 8x8 stage, 2048 channels). Submodules carry the flax names
(``mixed_7/tdb/conv``, ``mixed_7/tdb/bn``), which utils/convert.py relies on.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from dspnet_torch.models.layers import BatchNorm, avg_pool, conv, max_pool

INCEPTION_BN_EPS = 1e-3

TAP_CHANNELS = {"ch_concat_mixed_7_chconcat": 768, "ch_concat_mixed_10_chconcat": 2048}


class ConvBN(nn.Module):
    """conv (no bias) -> fix_gamma BatchNorm (eps 1e-3) -> relu."""

    def __init__(self, in_channels, features, kernel=(1, 1), stride=(1, 1), pad=(0, 0)):
        super().__init__()
        self.out_channels = features
        self.conv = conv(in_channels, features, kernel, stride, pad, use_bias=False)
        self.bn = BatchNorm(features, fix_gamma=True, eps=INCEPTION_BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _pool(x, kind):
    return avg_pool(x, 3, 1, 1) if kind == "avg" else max_pool(x, 3, 1, 1)


class InceptionA(nn.Module):  # Inception7A
    def __init__(self, c, p, pool="avg"):
        super().__init__()
        n1, n3r, n3a, n3b, n5r, n5, proj = p
        self.pool = pool
        self.t1 = ConvBN(c, n1)
        self.t5a = ConvBN(c, n5r)
        self.t5b = ConvBN(n5r, n5, (5, 5), pad=(2, 2))
        self.t3a = ConvBN(c, n3r)
        self.t3b = ConvBN(n3r, n3a, (3, 3), pad=(1, 1))
        self.t3c = ConvBN(n3a, n3b, (3, 3), pad=(1, 1))
        self.tp = ConvBN(c, proj)
        self.out_channels = n1 + n5 + n3b + proj

    def forward(self, x):
        return torch.cat([self.t1(x), self.t5b(self.t5a(x)), self.t3c(self.t3b(self.t3a(x))),
                          self.tp(_pool(x, self.pool))], dim=1)


class InceptionB(nn.Module):  # Inception7B (downsample)
    def __init__(self, c, p):
        super().__init__()
        n3, dr, d1, d2 = p
        self.t3 = ConvBN(c, n3, (3, 3), (2, 2))
        self.tda = ConvBN(c, dr)
        self.tdb = ConvBN(dr, d1, (3, 3), pad=(1, 1))
        self.tdc = ConvBN(d1, d2, (3, 3), (2, 2))
        self.out_channels = n3 + d2 + c

    def forward(self, x):
        return torch.cat([self.t3(x), self.tdc(self.tdb(self.tda(x))), max_pool(x, 3, 2, 0)], dim=1)


class InceptionC(nn.Module):  # Inception7C (7x1 / 1x7 factorised)
    def __init__(self, c, p):
        super().__init__()
        n1, dr, d1, d2, qr, q1, q2, q3, q4, proj = p
        self.t1 = ConvBN(c, n1)
        self.tda = ConvBN(c, dr)
        self.tdb = ConvBN(dr, d1, (1, 7), pad=(0, 3))
        self.tdc = ConvBN(d1, d2, (7, 1), pad=(3, 0))
        self.tqa = ConvBN(c, qr)
        self.tqb = ConvBN(qr, q1, (7, 1), pad=(3, 0))
        self.tqc = ConvBN(q1, q2, (1, 7), pad=(0, 3))
        self.tqd = ConvBN(q2, q3, (7, 1), pad=(3, 0))
        self.tqe = ConvBN(q3, q4, (1, 7), pad=(0, 3))
        self.tp = ConvBN(c, proj)
        self.out_channels = n1 + d2 + q4 + proj

    def forward(self, x):
        td = self.tdc(self.tdb(self.tda(x)))
        tq = self.tqe(self.tqd(self.tqc(self.tqb(self.tqa(x)))))
        return torch.cat([self.t1(x), td, tq, self.tp(avg_pool(x, 3, 1, 1))], dim=1)


class InceptionD(nn.Module):  # Inception7D (downsample)
    def __init__(self, c, p):
        super().__init__()
        n3r, n3, dr, d1, d2, d3 = p
        self.t3a = ConvBN(c, n3r)
        self.t3b = ConvBN(n3r, n3, (3, 3), (2, 2))
        self.tda = ConvBN(c, dr)
        self.tdb = ConvBN(dr, d1, (1, 7), pad=(0, 3))
        self.tdc = ConvBN(d1, d2, (7, 1), pad=(3, 0))
        self.tdd = ConvBN(d2, d3, (3, 3), (2, 2))
        self.out_channels = n3 + d3 + c

    def forward(self, x):
        td = self.tdd(self.tdc(self.tdb(self.tda(x))))
        return torch.cat([self.t3b(self.t3a(x)), td, max_pool(x, 3, 2, 0)], dim=1)


class InceptionE(nn.Module):  # Inception7E (expanded)
    def __init__(self, c, p, pool="avg"):
        super().__init__()
        n1, dr, d1, d2, tr, t33, t1a, t1b, proj = p
        self.pool = pool
        self.t1 = ConvBN(c, n1)
        self.tda = ConvBN(c, dr)
        self.tdb = ConvBN(dr, d1, (1, 3), pad=(0, 1))
        self.tdc = ConvBN(dr, d2, (3, 1), pad=(1, 0))
        self.tta = ConvBN(c, tr)
        self.ttb = ConvBN(tr, t33, (3, 3), pad=(1, 1))
        self.ttc = ConvBN(t33, t1a, (1, 3), pad=(0, 1))
        self.ttd = ConvBN(t33, t1b, (3, 1), pad=(1, 0))
        self.tp = ConvBN(c, proj)
        self.out_channels = n1 + d1 + d2 + t1a + t1b + proj

    def forward(self, x):
        td = self.tda(x)
        tt = self.ttb(self.tta(x))
        return torch.cat([self.t1(x), self.tdb(td), self.tdc(td), self.ttc(tt), self.ttd(tt),
                          self.tp(_pool(x, self.pool))], dim=1)


class InceptionV3(nn.Module):
    """``forward`` returns {'ch_concat_mixed_7_chconcat': (B, 768, ...),
    'ch_concat_mixed_10_chconcat': (B, 2048, ...)}."""

    def __init__(self):
        super().__init__()
        self.conv = ConvBN(3, 32, (3, 3), (2, 2))
        self.conv_1 = ConvBN(32, 32, (3, 3))
        self.conv_2 = ConvBN(32, 64, (3, 3), pad=(1, 1))
        self.conv_3 = ConvBN(64, 80)
        self.conv_4 = ConvBN(80, 192, (3, 3))
        blocks = (
            ("mixed", InceptionA, (64, 64, 96, 96, 48, 64, 32), {"pool": "avg"}),
            ("mixed_1", InceptionA, (64, 64, 96, 96, 48, 64, 64), {"pool": "avg"}),
            ("mixed_2", InceptionA, (64, 64, 96, 96, 48, 64, 64), {"pool": "avg"}),
            ("mixed_3", InceptionB, (384, 64, 96, 96), {}),
            ("mixed_4", InceptionC, (192, 128, 128, 192, 128, 128, 128, 128, 192, 192), {}),
            ("mixed_5", InceptionC, (192, 160, 160, 192, 160, 160, 160, 160, 192, 192), {}),
            ("mixed_6", InceptionC, (192, 160, 160, 192, 160, 160, 160, 160, 192, 192), {}),
            ("mixed_7", InceptionC, (192, 192, 192, 192, 192, 192, 192, 192, 192, 192), {}),
            ("mixed_8", InceptionD, (192, 320, 192, 192, 192, 192), {}),
            ("mixed_9", InceptionE, (320, 384, 384, 384, 448, 384, 384, 384, 192), {"pool": "avg"}),
            ("mixed_10", InceptionE, (320, 384, 384, 384, 448, 384, 384, 384, 192), {"pool": "max"}),
        )
        c = 192
        self.block_names = []
        for name, cls, p, kw in blocks:
            block = cls(c, p, **kw)
            self.add_module(name, block)
            self.block_names.append(name)
            c = block.out_channels

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = self.conv_2(self.conv_1(self.conv(x)))
        x = max_pool(x, 3, 2, 0)
        x = max_pool(self.conv_4(self.conv_3(x)), 3, 2, 0)
        taps = {}
        for name in self.block_names:
            x = getattr(self, name)(x)
            if name == "mixed_7":
                taps["ch_concat_mixed_7_chconcat"] = x
        taps["ch_concat_mixed_10_chconcat"] = x
        return taps
