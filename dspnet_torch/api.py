"""High-level construction API (counterpart of ``dspnet_tpu/api.py``).

``create_model`` resolves a network name like 'resnet-50_multi' (the suffix
dispatch of the reference's multi_train.py:309-317) into a bundle of an
initialized module, its config and its anchor table.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from dspnet_torch.models import factory
from dspnet_torch.models.dspnet import DSPNet
from dspnet_torch.models.layers import BatchNorm, Deconv2x

# flax's lecun_normal draws from a normal truncated at +-2 standard units and
# divides by that distribution's std so the variance is exactly 1/fan_in.
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass
class ModelBundle:
    name: str
    task: str  # det | seg | multi
    model: nn.Module
    cfg: factory.NetConfig
    anchors: Optional[np.ndarray]  # (A, 4) or None for seg-only
    data_shape: Tuple[int, int]
    num_classes: int


def parse_network_name(name: str) -> Tuple[str, str]:
    """'resnet-50_multi' -> ('resnet-50', 'multi'); no suffix -> 'ssd'."""
    for suffix in ("_det", "_seg", "_multi"):
        if name.endswith(suffix):
            return name[: -len(suffix)], suffix[1:]
    return name, "ssd"


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initializers, in distribution (not in bits):
    lecun-normal conv kernels and zero biases, BatchNorm scale 1 / bias 0 /
    running stats 0 and 1, and the bilinear filter for the seg deconv.
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


def create_model(
    network: str,
    data_shape,
    num_classes: int = 8,
    seg_classes: int = 19,
    device="cuda",
    generator: Optional[torch.Generator] = None,
) -> ModelBundle:
    """Build an initialized model bundle on ``device``, in eval mode.

    ``device`` is the card unless the caller asks for the CPU
    (``device="cpu"``); without a card the default raises.

    Args:
      network: 'resnet-{18,50}_{multi,det,seg}' or 'resnet101_{...}'.
      data_shape: (H, W) input resolution (int means square).
      generator: source of the initial weights; a CPU generator seeded with 0
        when None.
    """
    if isinstance(data_shape, int):
        data_shape = (data_shape, data_shape)
    data_shape = (int(data_shape[0]), int(data_shape[1]))
    base, task = parse_network_name(network)
    if task == "ssd" or not base.startswith("resnet"):
        raise NotImplementedError(
            f"{network!r}: only the resnet *_multi/_det/_seg presets are ported; "
            "SSDNet and the vgg16_reduced/inceptionv3 presets are ROADMAP "
            "Queue A item 16 (Other presets)")
    if task in ("seg", "multi") and (data_shape[0] % 8 or data_shape[1] % 8):
        # the seg head emits 2*(H//8) logits vs H//4 labels; they only agree
        # when both dims divide by 8 (multitask_symbol_builder.py:574-575)
        raise ValueError(f"seg/multi tasks need data shapes divisible by 8, got {data_shape}")
    cfg = factory.get_config(base, data_shape[0])
    with torch.device("meta"):
        model = DSPNet(cfg, num_classes=num_classes, seg_classes=seg_classes, task=task)
    model.to_empty(device=device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
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
