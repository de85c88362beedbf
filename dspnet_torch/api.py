"""High-level construction API (counterpart of ``dspnet_tpu/api.py``).

``create_model`` resolves a network name like 'resnet-50_multi' (the suffix
dispatch of the reference's multi_train.py:309-317) into a bundle of an
initialized module, its config and its anchor table. A name without a task
suffix ('vgg16_reduced', 'legacy_vgg16_ssd_512', 'resnet-18') is the plain
4-coordinate SSD (:class:`~dspnet_torch.models.dspnet.SSDNet`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from dspnet_torch.models import factory
from dspnet_torch.models.dspnet import DSPNet, SSDNet
from dspnet_torch.models.layers import BatchNorm, Deconv2x, L2Normalize

# flax's lecun_normal draws from a normal truncated at +-2 standard units and
# divides by that distribution's std so the variance is exactly 1/fan_in.
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass
class ModelBundle:
    name: str
    task: str  # det | seg | multi | ssd
    model: nn.Module
    cfg: factory.NetConfig
    anchors: Optional[np.ndarray]  # (A, 4) or None for seg-only
    data_shape: Tuple[int, int]
    num_classes: int

    @property
    def num_anchors(self) -> int:
        return 0 if self.anchors is None else self.anchors.shape[0]


def parse_network_name(name: str) -> Tuple[str, str]:
    """'resnet-50_multi' -> ('resnet-50', 'multi'); no suffix -> 'ssd'.

    The legacy names (reference symbol/legacy_vgg16_ssd_{300,512}.py, the
    factory's ``legacy*`` bypass, multitask_symbol_factory.py:116-118) all
    map to the 'legacy_vgg16_ssd' preset, which the data shape specializes."""
    if name.startswith("legacy_vgg16_ssd"):
        return "legacy_vgg16_ssd", "ssd"
    for suffix in ("_det", "_seg", "_multi"):
        if name.endswith(suffix):
            return name[: -len(suffix)], suffix[1:]
    return name, "ssd"


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initializers, in distribution (not in bits):
    lecun-normal conv kernels and zero biases, BatchNorm scale 1 / bias 0 /
    running stats 0 and 1, the bilinear filter for the seg deconv, and the
    preset's scale (20) for every L2Normalize.
    Values are drawn on the generator's device and copied, so one seed gives
    the same weights on every target device."""
    for m in model.modules():
        if isinstance(m, Deconv2x):
            m.reset_bilinear()
        elif isinstance(m, nn.Conv2d):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w = torch.empty(m.weight.shape, device=generator.device)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            if m.weight is not None:
                m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, L2Normalize):
            m.scale.fill_(m.init_scale)


def create_model(
    network: str,
    data_shape,
    num_classes: int = 8,
    seg_classes: int = 19,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    remat: bool = False,
    seg_fast: bool = False,
) -> ModelBundle:
    """Build an initialized model bundle on ``device``, in eval mode.

    ``device`` is the card unless the caller asks for the CPU
    (``device="cpu"``); without a card the default raises.

    Args:
      network: 'resnet-{18,50}_{multi,det,seg}', 'resnet101_{...}', or a
        plain SSD: 'vgg16_reduced', 'legacy_vgg16_ssd_{300,512}', 'resnet-18',
        'inceptionv3'.
      data_shape: (H, W) input resolution (int means square).
      generator: source of the initial weights; a CPU generator seeded with 0
        when None.
      remat: rematerialise each residual unit of a resnet backbone in the
        backward pass (no effect on the other backbones, as in JAX).
      seg_fast: the score-then-upsample seg head (``SegHead(fast=True)``);
        the parameters are the exact head's.
    """
    if isinstance(data_shape, int):
        data_shape = (data_shape, data_shape)
    data_shape = (int(data_shape[0]), int(data_shape[1]))
    base, task = parse_network_name(network)
    if task in ("seg", "multi") and (data_shape[0] % 8 or data_shape[1] % 8):
        # the seg head emits 2*(H//8) logits vs H//4 labels; they only agree
        # when both dims divide by 8 (multitask_symbol_builder.py:574-575)
        raise ValueError(f"seg/multi tasks need data shapes divisible by 8, got {data_shape}")
    cfg = factory.get_config(base, data_shape[0])
    with torch.device("meta"):
        if task == "ssd":
            model = SSDNet(cfg, num_classes=num_classes, remat=remat)
        else:
            model = DSPNet(cfg, num_classes=num_classes, seg_classes=seg_classes, task=task, remat=remat,
                           seg_fast=seg_fast)
    model.to_empty(device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    if task == "ssd":
        anchors = factory.build_anchors(cfg, data_shape)
    else:
        anchors = factory.build_anchors(cfg.drop_first_tap(), data_shape) if task != "seg" else None
    return ModelBundle(
        name=network,
        task=task,
        model=model.eval(),
        cfg=cfg,
        anchors=anchors,
        data_shape=data_shape,
        num_classes=num_classes,
    )
