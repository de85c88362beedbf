"""Config tree — a numpy copy of ``dspnet_tpu/utils/config.py`` (reference
config/config.py:1-68 + config/utils.py), pinned by
``tests/test_torch_det_iterator.py``.

``cfg.train`` / ``cfg.valid`` hold the augmentation presets consumed by the
plain-SSD DetIter path (rand samplers, color jitter, mirror) with the same
defaults, including the reference's canonical seed 233 and host-thread count.
"""

from __future__ import annotations

from dspnet_torch.data.rand_sampler import RandCropper, RandPadder


class DotDict(dict):
    """Attribute-style dict (reference config/utils.py DotDict)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


def config_as_dict(cfg) -> dict:
    """Flatten a nested DotDict to 'a_b_c' keys (config/utils.py:75-91)."""
    out = {}

    def walk(prefix, node):
        for k, v in node.items():
            key = f"{prefix}_{k}" if prefix else k
            if isinstance(v, dict):
                walk(key, v)
            else:
                out[key] = v

    walk("", cfg)
    return out


cfg = DotDict()
cfg.train = DotDict()
cfg.train.rand_crop_samplers = [
    RandCropper(min_scale=0.3, min_aspect_ratio=0.5, max_aspect_ratio=2.0, min_overlap=0.1),
    RandCropper(min_scale=0.3, min_aspect_ratio=0.5, max_aspect_ratio=2.0, min_overlap=0.3),
    RandCropper(min_scale=0.3, min_aspect_ratio=0.5, max_aspect_ratio=2.0, min_overlap=0.5),
    RandCropper(min_scale=0.3, min_aspect_ratio=0.5, max_aspect_ratio=2.0, min_overlap=0.7),
    RandCropper(min_scale=0.3, min_aspect_ratio=0.5, max_aspect_ratio=2.0, min_overlap=0.9),
]
cfg.train.rand_pad = RandPadder(max_scale=4.0, min_aspect_ratio=0.5, max_aspect_ratio=2.0,
                                min_gt_scale=0.01)
cfg.train.rand_pad_prob = 0.5
cfg.train.rand_mirror_prob = 0.5
cfg.train.shuffle = True
cfg.train.seed = 233
cfg.train.inter_method = 10  # random interpolation
cfg.train.preprocess_threads = 48
# reference config/config.py:50-51 training preset over the :22-29 defaults;
# consumed by data.det_iterator.DetIterator (data.augment.color_jitter)
cfg.train.color_jitter = DotDict(
    random_hue_prob=0.5, max_random_hue=18,
    random_saturation_prob=0.5, max_random_saturation=32,
    random_illumination_prob=0.5, max_random_illumination=32,
    random_contrast_prob=0.5, max_random_contrast=0.5,
)

cfg.valid = DotDict()
cfg.valid.rand_crop_samplers = []
cfg.valid.rand_pad = None
cfg.valid.rand_mirror_prob = 0.0
# reference config/config.py:63 — all-zero probabilities (no jitter at eval)
cfg.valid.color_jitter = DotDict(
    random_hue_prob=0.0, max_random_hue=18,
    random_saturation_prob=0.0, max_random_saturation=32,
    random_illumination_prob=0.0, max_random_illumination=32,
    random_contrast_prob=0.0, max_random_contrast=0.5,
)
cfg.valid.shuffle = False
cfg.valid.seed = 0
cfg.valid.preprocess_threads = 32
