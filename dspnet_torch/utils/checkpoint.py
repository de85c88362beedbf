"""Checkpoints with the reference naming (counterpart of
``dspnet_tpu/utils/checkpoint.py``).

The reference writes ``{prefix}-{epoch:04d}.params`` per epoch with prefix
``{dir}/multitask_{net}_{height}`` (multi_train.py:287, 370); the JAX
package writes one Orbax step per epoch under ``{prefix}``. Here each epoch
is one ``torch.save`` file ``{prefix}/{epoch:04d}.pt`` holding the float32
parameters, the BatchNorm buffers, the SGD momentum and the step, as plain
tensors and an int: ``torch.load(weights_only=True)`` reads it.

``CheckpointManager`` also reads the JAX package's Orbax steps under the
same prefix (``{prefix}/{epoch}/``, through ``utils/orbax_read.py``, with
no JAX, Orbax or tensorstore): ``epochs()`` lists both forms, and
``restore`` turns a JAX epoch into the port's state through
:func:`state_from_flax`, with the JAX step. So every entry point that
takes ``--model-dir`` takes a JAX run's model dir, and a resumed JAX run
writes its next epochs as ``.pt`` beside the Orbax steps. The port never
writes Orbax; an epoch present in both forms is refused.

:func:`save_params_only` / :func:`load_params_only` write and read the
inference weights alone (a detector deployment): one ``torch.save`` file of
the parameters and buffers, loaded strictly into a module of the same
architecture; ``load_params_only`` also reads a JAX ``save_params_only``
directory.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from dspnet_torch.train.solver import TrainState
from dspnet_torch.utils import orbax_read
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

    def orbax_path(self, epoch: int) -> str:
        """Where the JAX package keeps epoch ``epoch``: its Orbax step directory."""
        return orbax_read.step_dir(self.prefix, epoch)

    def epochs(self):
        """The epochs under the prefix: the port's ``.pt`` files and the JAX
        package's committed Orbax steps."""
        self._join()
        pt = {int(m.group(1)) for m in map(_FILE.match, os.listdir(self.prefix)) if m}
        return sorted(pt | set(orbax_read.orbax_epochs(self.prefix)))

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def read(self, epoch: Optional[int] = None) -> Tuple[dict, int]:
        """Epoch ``epoch`` (the latest when None) as ``({"params", "buffers",
        "momentum": {name: tensor on the CPU}, "step": int}, epoch)``, from
        its ``.pt`` file or from its Orbax step (``state_from_flax``)."""
        if epoch is None:
            epoch = self.latest_epoch()
        else:
            self._join()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {self.prefix}")
        pt, jax_step = self.path(epoch), self.orbax_path(epoch)
        in_pt, in_jax = os.path.exists(pt), os.path.isdir(jax_step)
        if in_pt and in_jax:
            raise ValueError(f"epoch {epoch} exists twice under {self.prefix}: {pt} and the JAX package's "
                             f"Orbax step {jax_step}; move one of them away")
        if in_jax:
            state = state_from_flax(orbax_read.restore_raw(self.prefix, epoch)[0])
            return {**{g: getattr(state, g) for g in _GROUPS}, "step": state.step}, epoch
        if not in_pt:
            raise FileNotFoundError(f"no checkpoint for epoch {epoch} under {self.prefix} "
                                    f"(neither {pt} nor {jax_step})")
        return torch.load(pt, map_location="cpu", weights_only=True), epoch

    @torch.no_grad()
    def restore(self, epoch: Optional[int], template: TrainState) -> Tuple[TrainState, int]:
        """Copy epoch ``epoch`` (the latest when None; a ``.pt`` file or a
        JAX Orbax step) into ``template``'s tensors (their device, dtype and
        ``requires_grad`` stay); returns (state, epoch). The names and the
        shapes must match exactly; the step is the checkpoint's."""
        payload, epoch = self.read(epoch)
        where = f"checkpoint {self.prefix} epoch {epoch}"
        for g in _GROUPS:
            want, got = getattr(template, g), payload[g]
            if set(want) != set(got):
                raise KeyError(f"{where} {g}: missing "
                               f"{sorted(set(want) - set(got))[:5]}, unexpected {sorted(set(got) - set(want))[:5]}")
            for k, t in want.items():
                if tuple(got[k].shape) != tuple(t.shape):
                    raise ValueError(f"{where} {g}: {k} has shape {tuple(got[k].shape)}, the model's is "
                                     f"{tuple(t.shape)}")
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
    """Load a :func:`save_params_only` file, or a directory the JAX
    package's ``save_params_only`` wrote, into ``template`` (a module of the
    same architecture) strictly, on the template's device and dtypes;
    returns the template."""
    if os.path.isdir(path):
        tree = orbax_read.read_item(path)
        variables = {c: _float_leaves(tree[c]) for c in ("params", "batch_stats") if tree.get(c)}
        template.load_state_dict(flax_to_state_dict(variables), strict=True)
        return template
    payload = torch.load(path, map_location="cpu", weights_only=True)
    template.load_state_dict({**payload["params"], **payload["buffers"]}, strict=True)
    return template


def _float_leaves(tree):
    """``tree`` with its bfloat16 leaves (``torch.bfloat16`` tensors from
    ``orbax_read``) as float32 numpy arrays, which hold them exactly."""
    if isinstance(tree, dict):
        return {k: _float_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree
