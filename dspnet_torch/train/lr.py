"""Learning-rate schedules (counterpart of ``dspnet_tpu/train/lr.py``;
reference multi_train.py:146-186)."""

from __future__ import annotations

from typing import Sequence


def multifactor_schedule(base_lr: float, steps: Sequence[int], factor: float):
    """lr *= factor at each iteration in ``steps`` (MultiFactorScheduler).
    Returns ``schedule(count) -> float``."""
    steps = tuple(int(s) for s in steps)

    def schedule(count):
        return base_lr * factor ** sum(int(count) >= s for s in steps)

    return schedule


def lr_scheduler_from_epochs(
    learning_rate: float,
    lr_refactor_step: str,
    lr_refactor_ratio: float,
    num_example: int,
    batch_size: int,
    begin_epoch: int = 0,
):
    """Epoch-denominated refactor steps converted to iterations, with the
    catch-up scaling of a resumed run (multi_train.get_lr_scheduler).
    Returns (adjusted_base_lr, schedule_fn)."""
    assert lr_refactor_ratio > 0
    iter_refactor = [int(r) for r in str(lr_refactor_step).split(",") if r.strip()]
    if lr_refactor_ratio >= 1:
        return learning_rate, multifactor_schedule(learning_rate, (), 1.0)
    lr = learning_rate
    # >= 1: a batch larger than the dataset would otherwise put every
    # refactor boundary at iteration 0
    epoch_size = max(1, num_example // batch_size)
    for s in iter_refactor:
        if begin_epoch >= s:
            lr *= lr_refactor_ratio
    steps = [epoch_size * (x - begin_epoch) for x in iter_refactor if x > begin_epoch]
    return lr, multifactor_schedule(lr, steps, lr_refactor_ratio)
