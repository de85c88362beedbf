"""Mixed-precision helpers (counterpart of ``dspnet_tpu/utils/precision.py``).

Inference (``detect/detector.py``) runs a bf16 copy of the network and
decodes boxes, NMS and the class softmax in float32. As in the JAX
package's ``cast_floating``, which casts ``batch_stats`` too, that cast
covers the floating buffers (BatchNorm running statistics) as well as the
parameters.

Training (``train/solver.py``) keeps float32 master weights and, for a bf16
``compute_dtype``, casts every floating parameter and the images inside the
loss, as the JAX solver does (``solver.py:159-180``): the BatchNorm running
statistics, the targets and the losses stay float32, and the outputs are
cast back to float32. The casts are differentiable, so autograd carries the
gradients back to the float32 masters. This is not ``torch.autocast``, which
casts per operator and keeps BatchNorm and softmax in float32.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(dtype) -> torch.dtype:
    """'float32' | 'bfloat16' | a torch dtype -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {dtype!r}")
    return DTYPES[dtype]


def cast_floating(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter and buffer of ``module`` in place."""
    return module.to(dtype=dtype)


def cast_tensors(tensors: Mapping[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Differentiable casts of the floating tensors of a name -> tensor map."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tensors.items()}
