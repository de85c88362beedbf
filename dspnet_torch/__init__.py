"""dspnet_torch — DSPNet on PyTorch and CUDA (NVIDIA Hopper).

A port of ``dspnet_tpu`` (the JAX/TPU package, kept beside it as the
reference): single-shot multitask network for 2-D detection, per-box
distance and semantic segmentation. Plain tensor code is PyTorch; the TPU's
Pallas kernels become kernels written by hand for sm_90a under ``csrc/``.
This package imports neither jax nor the JAX package.
"""

__version__ = "0.1.0"

# lazy top-level API: importing the package builds nothing and loads no model
_LAZY = {
    "create_model": ("dspnet_torch.api", "create_model"),
    "ModelBundle": ("dspnet_torch.api", "ModelBundle"),
    "Detector": ("dspnet_torch.detect.detector", "Detector"),
    "ServingPipeline": ("dspnet_torch.detect.pipeline", "ServingPipeline"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'dspnet_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
