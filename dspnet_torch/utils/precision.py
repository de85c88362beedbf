"""Mixed-precision helpers (counterpart of ``dspnet_tpu/utils/precision.py``).

The inference path runs the network in bfloat16 and decodes boxes, NMS and
the class softmax in float32 (``detect/detector.py``). As in the JAX
package's ``cast_floating``, which casts ``batch_stats`` too, the cast covers
the floating buffers (BatchNorm running statistics) as well as parameters;
integer buffers keep their dtype.
"""

from __future__ import annotations

import torch
from torch import nn


def cast_floating(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating parameter and buffer of ``module`` in place."""
    return module.to(dtype=dtype)
