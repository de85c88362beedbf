"""Checkpoints with the reference naming (counterpart of
``dspnet_tpu/utils/checkpoint.py``).

The reference writes ``{prefix}-{epoch:04d}.params`` per epoch with prefix
``{dir}/multitask_{net}_{height}`` (multi_train.py:287, 370); the JAX
package writes one Orbax step per epoch under ``{prefix}``. Here each epoch
is one ``torch.save`` file ``{prefix}/{epoch:04d}.pt`` holding the float32
parameters, the BatchNorm buffers, the SGD momentum and the step, as plain
tensors and an int: ``torch.load(weights_only=True)`` reads it.

:func:`save_params_only` / :func:`load_params_only` write and read the
inference weights alone (a detector deployment): one ``torch.save`` file of
the parameters and buffers, loaded strictly into a module of the same
architecture.

:func:`state_from_flax` turns a JAX package checkpoint (the numpy tree
``CheckpointManagerWrapper.restore_raw`` returns) into a port
``TrainState``, so the port scores a JAX-trained network; the port itself
never imports Orbax.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from dspnet_torch.train.solver import TrainState
from dspnet_torch.utils.convert import flax_to_state_dict

_FILE = re.compile(r"^(\d+)\.pt$")
_GROUPS = ("params", "buffers", "momentum")


def checkpoint_prefix(model_dir: str, net_name: str, data_height: int) -> str:
    """`{dir}/multitask_{net}_{height}` (multi_train.py:287)."""
    return os.path.join(os.path.abspath(model_dir), f"multitask_{net_name}_{data_height}")


class CheckpointManager:
    """Per-epoch checkpoint files under one prefix directory.

    ``save(block=False)`` returns after a snapshot on the device: the solver
    updates its state in place at the next step (``train/solver.py``), so
    the background thread copies from clones, not from the live tensors.
    The copy to the host and the write run on that thread; the next call
    (save, restore, latest_epoch, close) joins it and raises again a failure
    it met, so a lost checkpoint cannot pass unnoticed. Files appear whole:
    each is written to a temporary name and renamed."""

    def __init__(self, prefix: str):
        self.prefix = os.path.abspath(prefix)
        os.makedirs(self.prefix, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def path(self, epoch: int) -> str:
        return os.path.join(self.prefix, f"{epoch:04d}.pt")

    def _join(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError("async checkpoint save failed") from exc

    def _write(self, epoch: int, payload: dict):
        host = {g: {k: v.detach().to("cpu", copy=True) for k, v in payload[g].items()} for g in _GROUPS}
        host["step"] = int(payload["step"])
        tmp = f"{self.path(epoch)}.tmp{os.getpid()}"
        torch.save(host, tmp)
        os.replace(tmp, self.path(epoch))

    def save(self, epoch: int, state: TrainState, block: bool = True):
        """Write ``state`` as epoch ``epoch``; see the class docstring for
        ``block=False``."""
        self._join()
        payload = {g: getattr(state, g) for g in _GROUPS}
        payload["step"] = state.step
        if block:
            self._write(epoch, payload)
            return
        with torch.no_grad():
            snap = {g: {k: v.detach().clone() for k, v in payload[g].items()} for g in _GROUPS}
        snap["step"] = state.step

        def run():
            try:
                self._write(epoch, snap)
            except BaseException as e:  # raised again by the next _join
                self._exc = e

        self._thread = threading.Thread(target=run, name=f"ckpt-save-{epoch}", daemon=True)
        self._thread.start()

    def epochs(self):
        self._join()
        return sorted(int(m.group(1)) for m in map(_FILE.match, os.listdir(self.prefix)) if m)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    @torch.no_grad()
    def restore(self, epoch: Optional[int], template: TrainState) -> Tuple[TrainState, int]:
        """Copy epoch ``epoch`` (the latest when None) into ``template``'s
        tensors (their device, dtype and ``requires_grad`` stay); returns
        (state, epoch). The names must match exactly."""
        if epoch is None:
            epoch = self.latest_epoch()
        else:
            self._join()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {self.prefix}")
        payload = torch.load(self.path(epoch), map_location="cpu", weights_only=True)
        for g in _GROUPS:
            want, got = getattr(template, g), payload[g]
            if set(want) != set(got):
                raise KeyError(f"checkpoint {self.path(epoch)} {g}: missing "
                               f"{sorted(set(want) - set(got))[:5]}, unexpected {sorted(set(got) - set(want))[:5]}")
            for k, t in want.items():
                t.copy_(got[k])
        template.step = int(payload["step"])
        return template, epoch

    def close(self):
        self._join()


def state_from_flax(tree: Mapping) -> TrainState:
    """A JAX package checkpoint tree (``{"params", "batch_stats", "opt_state",
    "step"}`` of numpy arrays, as ``CheckpointManagerWrapper.restore_raw``
    returns it) -> a float32 ``TrainState`` on the CPU: the params and the
    batch stats through ``utils/convert.py``, the optax momentum trace as
    ``momentum`` (the same layout as the params), every parameter
    trainable."""
    params = flax_to_state_dict({"params": tree["params"]})
    buffers = flax_to_state_dict({"batch_stats": tree["batch_stats"]}) if tree.get("batch_stats") else {}
    # MXSGDState(count, momentum), restored as a dict
    momentum = flax_to_state_dict({"params": tree["opt_state"]["momentum"]})
    if set(momentum) != set(params):
        raise KeyError("the momentum trace does not have the layout of the params")
    f32 = {k: v.float().requires_grad_(True) for k, v in params.items()}
    return TrainState(int(np.asarray(tree["step"])), f32,
                      {k: v.float() for k, v in buffers.items()},
                      {k: v.float() for k, v in momentum.items()})


def save_params_only(path: str, params: Mapping[str, torch.Tensor],
                     buffers: Optional[Mapping[str, torch.Tensor]] = None) -> str:
    """One file of inference weights (the JAX ``save_params_only``'s params
    and batch_stats): ``{"params": ..., "buffers": ...}`` as host tensors,
    written to a temporary name and renamed. ``params`` may be a module, whose
    state dict is taken, split into parameters and buffers; returns ``path``."""
    if isinstance(params, torch.nn.Module):
        state = params.state_dict()
        names = {k for k, _ in params.named_parameters()}
        params, buffers = ({k: v for k, v in state.items() if (k in names) == want} for want in (True, False))
    payload = {"params": {k: v.detach().cpu().clone() for k, v in params.items()},
               "buffers": {k: v.detach().cpu().clone() for k, v in (buffers or {}).items()}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_params_only(path: str, template: torch.nn.Module) -> torch.nn.Module:
    """Load a :func:`save_params_only` file into ``template`` (a module of the
    same architecture) strictly, on the template's device and dtypes;
    returns the template."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    template.load_state_dict({**payload["params"], **payload["buffers"]}, strict=True)
    return template
