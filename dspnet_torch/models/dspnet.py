"""DSPNet — the single-shot multitask network (det + distance + seg).

Counterpart of ``dspnet_tpu/models/dspnet.py::DSPNet``. NHWC images in, a
dict out, in the JAX package's layouts:
  * ``loc_preds``  (B, A, 5)   — 4 box offsets + 1 distance (task det/multi)
  * ``cls_logits`` (B, A, C+1) — raw class scores incl. background
  * ``seg_logits`` (B, H/4, W/4, 19) (task seg/multi)

Inside, the network runs NCHW. Losses, target assignment and NMS live
outside the module, so the same forward serves every caller. The plain
4-coordinate SSD (reference symbol/symbol_builder.py, legacy_vgg16_ssd_*) is
:class:`SSDNet`.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from dspnet_torch.models.factory import NetConfig
from dspnet_torch.models.heads import MultiBoxHead, MultiLayerFeature
from dspnet_torch.models.inception import TAP_CHANNELS as INCEPTION_TAP_CHANNELS
from dspnet_torch.models.inception import InceptionV3
from dspnet_torch.models.resnet import ResNet, tap_channels, tap_index
from dspnet_torch.models.seg_head import SegHead
from dspnet_torch.models.vgg import TAP_CHANNELS as VGG_TAP_CHANNELS
from dspnet_torch.models.vgg import VGG16Reduced

TASKS = ("det", "seg", "multi")


class DSPNet(nn.Module):
    """Multitask net. ``task`` in {'det', 'seg', 'multi'} mirrors the
    reference's network-name suffix dispatch (multi_train.py:309-317)."""

    def __init__(self, cfg: NetConfig, num_classes: int = 8, seg_classes: int = 19,
                 task: str = "multi", loc_channels: int = 5, remat: bool = False,
                 seg_fast: bool = False):
        super().__init__()
        if cfg.network != "resnet":
            raise NotImplementedError(
                "multitask heads require the 3-tap resnet presets (the "
                "reference's seg/multi builders index from_layers[0:3], "
                "multitask_symbol_builder.py:498-500)")
        if task not in TASKS:
            raise ValueError(f"task must be one of {TASKS}, got {task!r}")
        self.task = task
        self.taps = [tap_index(n) for n in cfg.from_layers[:3]]
        ch = [tap_channels(cfg.num_layers, n) for n in cfg.from_layers[:3]]
        self.backbone = ResNet(cfg.num_layers, remat=remat)
        if task in ("det", "multi"):
            det_cfg = cfg.drop_first_tap()
            self.multi_feat = MultiLayerFeature(
                ch[1:], det_cfg.num_filters, det_cfg.strides, det_cfg.pads,
                det_cfg.min_filter, det_cfg.kernels)
            self.multibox = MultiBoxHead(
                self.multi_feat.out_channels, num_classes + 1, det_cfg.sizes,
                det_cfg.ratios, loc_channels, det_cfg.normalizations)
        if task in ("seg", "multi"):
            self.seg = SegHead(ch[0], ch[1], ch[2], seg_classes, fast=seg_fast)

    def forward(self, images) -> Dict[str, torch.Tensor]:
        """images: (B, H, W, 3) NHWC, mean-subtracted RGB."""
        h, w = images.shape[1], images.shape[2]
        plus = self.backbone(images.permute(0, 3, 1, 2))
        res3, res4, conv_feat = (plus[i] for i in self.taps)
        out: Dict[str, torch.Tensor] = {}
        if self.task in ("det", "multi"):
            layers = self.multi_feat([res4, conv_feat])
            out["loc_preds"], out["cls_logits"] = self.multibox(layers)
        if self.task in ("seg", "multi"):
            seg = self.seg(res3, res4, conv_feat, (h // 8, w // 8))
            out["seg_logits"] = seg.permute(0, 2, 3, 1)
        return out


class SSDNet(nn.Module):
    """Classic 4-coordinate SSD (reference symbol/symbol_builder.py:20-99;
    ``dspnet_tpu/models/dspnet.py::SSDNet``): every tap of the preset feeds
    the heads (no tap is dropped), no seg head, ``loc_channels=4``. The
    backbones are resnet, vgg16_reduced and inceptionv3; ``remat`` reaches a
    resnet backbone only, as in the JAX package. Outputs ``loc_preds``
    (B, A, 4) and ``cls_logits`` (B, A, C+1)."""

    def __init__(self, cfg: NetConfig, num_classes: int = 20, loc_channels: int = 4,
                 remat: bool = False):
        super().__init__()
        taps = [n for n in cfg.from_layers if n]
        self.network = cfg.network
        if cfg.network == "resnet":
            self.backbone = ResNet(cfg.num_layers, remat=remat)
            self.taps = [tap_index(n) for n in taps]
            ch = [tap_channels(cfg.num_layers, n) for n in taps]
        elif cfg.network == "vgg16_reduced":
            self.backbone = VGG16Reduced()
            self.taps = taps
            ch = [VGG_TAP_CHANNELS[n] for n in taps]
        elif cfg.network == "inceptionv3":
            self.backbone = InceptionV3()
            self.taps = taps
            ch = [INCEPTION_TAP_CHANNELS[n] for n in taps]
        else:
            raise NotImplementedError(cfg.network)
        self.multi_feat = MultiLayerFeature(ch, cfg.num_filters, cfg.strides, cfg.pads,
                                            cfg.min_filter, cfg.kernels)
        self.multibox = MultiBoxHead(self.multi_feat.out_channels, num_classes + 1, cfg.sizes,
                                     cfg.ratios, loc_channels, cfg.normalizations)

    def forward(self, images) -> Dict[str, torch.Tensor]:
        """images: (B, H, W, 3) NHWC, mean-subtracted RGB."""
        feats = self.backbone(images.permute(0, 3, 1, 2))
        layers = self.multi_feat([feats[t] for t in self.taps])
        loc, cls = self.multibox(layers)
        return {"loc_preds": loc, "cls_logits": cls}
