"""Network presets + anchor-table construction (numpy, no framework).

A copy of the resnet rows of ``dspnet_tpu/models/factory.py`` (the reference
preset table, symbol/multitask_symbol_factory.py:5-98). The vgg16_reduced,
inceptionv3 and legacy presets come with their backbones (ROADMAP Queue A,
"Other presets").

``feature_shapes`` computes each detection feature map's (h, w) from the
backbone's conv/pool arithmetic, so the anchor table can be built without
running the network.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from dspnet_torch.models import resnet as resnet_mod
from dspnet_torch.ops.anchors import anchors_for_config


def _t(x):  # nested tuple-ify so configs are hashable
    if isinstance(x, (list, tuple)):
        return tuple(_t(v) for v in x)
    return x


@dataclasses.dataclass(frozen=True)
class NetConfig:
    network: str  # 'resnet' (the only backbone ported so far)
    num_layers: int  # resnet depth
    from_layers: tuple
    num_filters: tuple
    strides: tuple
    pads: tuple
    sizes: tuple
    ratios: tuple
    normalizations: tuple
    steps: tuple
    min_filter: int = 128
    #: per-extra-layer conv kernel size; () = all 3x3 (common.py:131-132).
    kernels: tuple = ()

    def drop_first_tap(self) -> "NetConfig":
        """The multitask builder removes the finest tap from the SSD head and
        keeps it only for segmentation (multitask_symbol_builder.py:502-508)."""
        return dataclasses.replace(
            self,
            from_layers=self.from_layers[1:],
            num_filters=self.num_filters[1:],
            strides=self.strides[1:],
            pads=self.pads[1:],
            sizes=self.sizes[1:],
            ratios=self.ratios[1:],
            normalizations=self.normalizations[1:] if self.normalizations else (),
            kernels=self.kernels[1:] if self.kernels else (),
        )


def get_config(network: str, data_shape: int) -> NetConfig:
    """Preset table (multitask_symbol_factory.py:17-95). ``data_shape`` is the
    input height (the reference keys presets off height only; the resnet
    rows do not depend on it)."""
    del data_shape
    if network == "resnet-18":
        return NetConfig(
            "resnet", 18,
            _t(["_plus3", "_plus5", "_plus7", "", "", "", ""]),
            _t([-1, -1, -1, 512, 256, 256, 128]),
            _t([-1, -1, -1, 2, 2, 2, 2]),
            _t([-1, -1, -1, 1, 1, 1, 1]),
            _t([[.5, .7], [.1, .141], [.2, .272], [.37, .447], [.54, .619], [.71, .79], [.88, .961]]),
            _t([[1, 2, .5], [1, 2, .5], [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3],
                [1, 2, .5, 3, 1. / 3], [1, 2, .5], [1, 2, .5]]),
            (), (),
        )
    if network == "resnet-50":
        return NetConfig(
            "resnet", 50,
            _t(["_plus6", "_plus12", "_plus15", "", "", "", ""]),
            _t([-1, -1, -1, 512, 256, 256, 128]),
            _t([-1, -1, -1, 2, 2, 2, 2]),
            _t([-1, -1, -1, 1, 1, 1, 1]),
            _t([[.5, .705], [.1, .141], [.2, .272], [.37, .447], [.54, .619], [.71, .79], [.88, .961]]),
            _t([[1, 2, .5], [1, 2, .5], [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3],
                [1, 2, .5, 3, 1. / 3], [1, 2, .5], [1, 2, .5]]),
            (), (),
        )
    if network == "resnet101":
        return NetConfig(
            "resnet", 101,
            _t(["_plus12", "_plus15", "", "", "", ""]),
            _t([-1, -1, 512, 256, 256, 128]),
            _t([-1, -1, 2, 2, 2, 2]),
            _t([-1, -1, 1, 1, 1, 1]),
            _t([[.1, .141], [.2, .272], [.37, .447], [.54, .619], [.71, .79], [.88, .961]]),
            _t([[1, 2, .5], [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3],
                [1, 2, .5, 3, 1. / 3], [1, 2, .5], [1, 2, .5]]),
            (), (),
        )
    raise NotImplementedError(
        f"no ported preset for {network!r}; the vgg16_reduced, inceptionv3 and "
        "legacy presets are ROADMAP Queue A item 16 (Other presets)")


# ------------------------------------------------------------ shape math


def _floor_out(i, k, s, p):
    return (i + 2 * p - k) // s + 1


def _resnet_tap_shape(num_layers: int, tap: str, h: int, w: int):
    stage = resnet_mod.tap_stage(num_layers, tap)
    # stem: conv0 7x7/2 p3, maxpool 3x3/2 p1  -> stride 4 at stage 0
    h = _floor_out(h, 7, 2, 3)
    w = _floor_out(w, 7, 2, 3)
    h = _floor_out(h, 3, 2, 1)
    w = _floor_out(w, 3, 2, 1)
    for _ in range(stage):
        h = _floor_out(h, 3, 2, 1)
        w = _floor_out(w, 3, 2, 1)
    return h, w


def feature_shapes(cfg: NetConfig, data_shape: Sequence[int]) -> list[tuple[int, int]]:
    """(h, w) of every detection feature map for input (H, W)."""
    H, W = int(data_shape[0]), int(data_shape[1])
    if cfg.network != "resnet":
        raise NotImplementedError(cfg.network)
    shapes = []
    for k, name in enumerate(cfg.from_layers):
        if name:
            shapes.append(_resnet_tap_shape(cfg.num_layers, name, H, W))
        else:
            ph, pw = shapes[-1]
            s, p = cfg.strides[k], cfg.pads[k]
            ksz = cfg.kernels[k] if cfg.kernels else 3
            shapes.append((_floor_out(ph, ksz, s, p), _floor_out(pw, ksz, s, p)))
    return shapes


def build_anchors(cfg: NetConfig, data_shape: Sequence[int]) -> np.ndarray:
    """(A, 4) network anchor table for this config + input resolution."""
    return anchors_for_config(
        feature_shapes(cfg, data_shape), cfg.sizes, cfg.ratios, cfg.steps, clip=False
    )
