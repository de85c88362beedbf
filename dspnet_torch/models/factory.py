"""Network presets + anchor-table construction (numpy, no framework).

A copy of ``dspnet_tpu/models/factory.py`` (the reference preset table,
symbol/multitask_symbol_factory.py:5-98): the resnet rows, the
vgg16_reduced 300/512 rows, the legacy VGG16-SSD graphs and the
inceptionv3 row.

``feature_shapes`` computes each detection feature map's (h, w) from the
backbone's conv/pool arithmetic, so the anchor table can be built without
running the network.
"""

from __future__ import annotations

import dataclasses
import math
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
    network: str  # 'resnet' | 'vgg16_reduced' | 'inceptionv3'
    num_layers: int  # resnet depth, 0 otherwise
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
    #: Only the legacy 512 graph deviates: its last extra layer is a 4x4
    #: conv (legacy_vgg16_ssd_512.py:117-118), shrinking the 2x2 stream to
    #: a 1x1 anchor grid.
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
    input height (the reference keys presets off height only)."""
    if network == "legacy_vgg16_ssd":
        # the hand-written legacy graphs (legacy_vgg16_ssd_{300,512}.py): at
        # 300 the vgg16_reduced preset layer for layer; at 512 the last
        # extra layer is a 4x4 pad-1 stride-1 conv (legacy_vgg16_ssd_512.py:
        # 117-118), so the last anchor grid is 1x1, not the preset's 2x2
        cfg = get_config("vgg16_reduced", data_shape)
        if data_shape >= 448:
            cfg = dataclasses.replace(cfg, kernels=(-1, -1, 3, 3, 3, 3, 4))
        return cfg
    if network == "vgg16_reduced":
        if data_shape >= 448:
            return NetConfig(
                "vgg16_reduced", 0,
                _t(["relu4_3", "relu7", "", "", "", "", ""]),
                _t([512, -1, 512, 256, 256, 256, 256]),
                _t([-1, -1, 2, 2, 2, 2, 1]),
                _t([-1, -1, 1, 1, 1, 1, 1]),
                _t([[.07, .1025], [.15, .2121], [.3, .3674], [.45, .5196],
                    [.6, .6708], [.75, .8216], [.9, .9721]]),
                _t([[1, 2, .5], [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3],
                    [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3], [1, 2, .5], [1, 2, .5]]),
                _t([20, -1, -1, -1, -1, -1, -1]),
                _t([x / 512.0 for x in [8, 16, 32, 64, 128, 256, 512]]) if data_shape == 512 else (),
            )
        return NetConfig(
            "vgg16_reduced", 0,
            _t(["relu4_3", "relu7", "", "", "", ""]),
            _t([512, -1, 512, 256, 256, 256]),
            _t([-1, -1, 2, 2, 1, 1]),
            _t([-1, -1, 1, 1, 0, 0]),
            _t([[.1, .141], [.2, .272], [.37, .447], [.54, .619], [.71, .79], [.88, .961]]),
            _t([[1, 2, .5], [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3],
                [1, 2, .5, 3, 1. / 3], [1, 2, .5], [1, 2, .5]]),
            _t([20, -1, -1, -1, -1, -1]),
            _t([x / 300.0 for x in [8, 16, 32, 64, 100, 300]]) if data_shape == 300 else (),
        )
    if network == "inceptionv3":
        return NetConfig(
            "inceptionv3", 0,
            _t(["ch_concat_mixed_7_chconcat", "ch_concat_mixed_10_chconcat", "", "", "", ""]),
            _t([-1, -1, 512, 256, 256, 128]),
            _t([-1, -1, 2, 2, 2, 2]),
            _t([-1, -1, 1, 1, 1, 1]),
            _t([[.1, .141], [.2, .272], [.37, .447], [.54, .619], [.71, .79], [.88, .961]]),
            _t([[1, 2, .5], [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3],
                [1, 2, .5, 3, 1. / 3], [1, 2, .5], [1, 2, .5]]),
            (), (),
        )
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
    raise NotImplementedError(f"No configuration found for {network} / {data_shape}")


# ------------------------------------------------------------ shape math


def _floor_out(i, k, s, p):
    return (i + 2 * p - k) // s + 1


def _ceil_out(i, k, s, p):
    return int(math.ceil((i + 2 * p - k) / s)) + 1


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


def _vgg_tap_shape(tap: str, h: int, w: int):
    h1, w1 = _floor_out(h, 2, 2, 0), _floor_out(w, 2, 2, 0)  # pool1
    h2, w2 = _floor_out(h1, 2, 2, 0), _floor_out(w1, 2, 2, 0)  # pool2
    h3, w3 = _ceil_out(h2, 2, 2, 0), _ceil_out(w2, 2, 2, 0)  # pool3 (full)
    if tap == "relu4_3":
        return h3, w3
    h4, w4 = _floor_out(h3, 2, 2, 0), _floor_out(w3, 2, 2, 0)  # pool4
    if tap == "relu7":
        return h4, w4  # pool5 is stride 1
    raise KeyError(tap)


def _inception_tap_shape(tap: str, h: int, w: int):
    h, w = _floor_out(h, 3, 2, 0), _floor_out(w, 3, 2, 0)  # conv 3x3/2
    h, w = h - 2, w - 2  # conv_1 3x3 pad 0 (conv_2 pads 1 and keeps the size)
    h, w = _floor_out(h, 3, 2, 0), _floor_out(w, 3, 2, 0)  # pool
    h, w = h - 2, w - 2  # conv_4 3x3 pad 0
    h, w = _floor_out(h, 3, 2, 0), _floor_out(w, 3, 2, 0)  # pool1
    h, w = _floor_out(h, 3, 2, 0), _floor_out(w, 3, 2, 0)  # mixed_3 downsample
    if tap == "ch_concat_mixed_7_chconcat":
        return h, w
    h, w = _floor_out(h, 3, 2, 0), _floor_out(w, 3, 2, 0)  # mixed_8 downsample
    if tap == "ch_concat_mixed_10_chconcat":
        return h, w
    raise KeyError(tap)


_TAP_SHAPE = {
    "resnet": lambda cfg, tap, h, w: _resnet_tap_shape(cfg.num_layers, tap, h, w),
    "vgg16_reduced": lambda cfg, tap, h, w: _vgg_tap_shape(tap, h, w),
    "inceptionv3": lambda cfg, tap, h, w: _inception_tap_shape(tap, h, w),
}


def feature_shapes(cfg: NetConfig, data_shape: Sequence[int]) -> list[tuple[int, int]]:
    """(h, w) of every detection feature map for input (H, W)."""
    H, W = int(data_shape[0]), int(data_shape[1])
    if cfg.network not in _TAP_SHAPE:
        raise NotImplementedError(cfg.network)
    shapes = []
    for k, name in enumerate(cfg.from_layers):
        if name:
            shapes.append(_TAP_SHAPE[cfg.network](cfg, name, H, W))
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
