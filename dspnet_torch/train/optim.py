"""MXNet-convention SGD (counterpart of ``dspnet_tpu/train/optim.py``).

The reference trains with mx.optimizer.SGD, momentum 0.9, wd 5e-4 and
``rescale_grad = 1/batch_size`` (multi_solver.py:221-222). Its rule keeps lr
inside the momentum buffer and applies weight decay to every parameter,
BatchNorm biases included:

    mom    = momentum * mom - lr * (rescale * grad + wd * weight)
    weight = weight + mom

``torch.optim.SGD`` computes another rule (lr outside the buffer), so the
update is written out here, on lists of tensors, in place.
"""

from __future__ import annotations

from typing import Callable, List, Union

import torch


class MXNetSGD:
    """``step(params, grads, momenta, count)`` updates ``params`` and
    ``momenta`` in place. ``learning_rate`` is a float or a schedule called
    with the update count before this update (0 on the first)."""

    def __init__(self, learning_rate: Union[float, Callable], momentum: float = 0.9,
                 weight_decay: float = 5e-4, rescale_grad: float = 1.0):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.rescale_grad = rescale_grad

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             momenta: List[torch.Tensor], count: int) -> None:
        if not params:
            return
        lr = self.lr_at(count)
        delta = torch._foreach_mul(grads, self.rescale_grad)
        torch._foreach_add_(delta, params, alpha=self.weight_decay)
        torch._foreach_mul_(delta, lr)
        torch._foreach_mul_(momenta, self.momentum)
        torch._foreach_sub_(momenta, delta)
        torch._foreach_add_(params, momenta)
