"""MultiTaskSolver — the training step and loop (counterpart of
``dspnet_tpu/train/solver.py``).

One step is forward in train mode (the BatchNorm running statistics update
as a side effect) -> ``multibox_target`` on the detached class logits (the
matcher kernel on a CUDA batch) -> ``multitask_loss`` -> backward through
autograd -> MXNet-convention SGD. With ``compute_dtype="bfloat16"`` the
network runs on bf16 copies of the float32 master parameters
(``utils/precision.py``); targets, losses, statistics and the update stay
float32.

The state is updated in place: ``train_step`` writes the new parameters,
momentum and running statistics into the state's own tensors and returns
the same ``TrainState`` (the JAX solver donates its state buffers to the
same end), so a step holds one copy of the weights and of the momentum.
Clone a state's tensors to keep an earlier one.

The solver's module is a template: the weights live in the state and are
swapped in with ``torch.func.functional_call``; the module's own tensors and
its train/eval flag are left as they were. ``fit`` takes its batches as the
iterator gives them (``DeviceAugIterator`` decodes ahead and puts them on
the device; host arrays are copied at the step) and validates with
``evaluate/loop.py``.

Data parallelism: when a default process group is initialised
(``parallel/dist.py::distributed_init``; a group of one rank takes the same
path, each collective the identity), each rank runs the
step on its rows of the global batch and the step is the global one, as a
JAX step over a sharded batch: BatchNorm normalises with the global batch
statistics (each ``BatchNorm.stats_reduce`` set to the differentiable
sum over the ranks for the step), every loss normaliser is the
global count (``losses.multitask_loss(count_reduce=...)``), the gradients
are summed over the ranks in a few bucketed all-reduces before the MXNet
SGD (``rescale_grad`` 1/(global batch x grad_accum); a mean, as
``DistributedDataParallel`` takes, would be wrong here), and the metrics
are summed into the global batch's. The ranks then apply the same update
and their parameters stay equal. ``batch_size`` is the global batch.
Spatial sharding over the JAX mesh's ``model`` axis is not ported (ROADMAP
Queue A item 17).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dspnet_torch.models.layers import BatchNorm
from dspnet_torch.ops.target import multibox_target
from dspnet_torch.parallel import dist as pdist
from dspnet_torch.train import losses as loss_mod
from dspnet_torch.train.optim import MXNetSGD
from dspnet_torch.utils.convert import flax_path
from dspnet_torch.utils.precision import cast_tensors, resolve_dtype


class TrainingDiverged(RuntimeError):
    """Raised by :meth:`MultiTaskSolver.fit` when a logged metric is NaN or
    inf. With SGD and momentum a non-finite loss never recovers (the
    gradients, and after the next update the weights, are non-finite), so
    the run stops instead of training and checkpointing garbage. The check
    reads only metrics the loop has already brought to the host."""


@dataclasses.dataclass
class TrainState:
    """step: optimizer updates so far; params: float32 master parameters by
    torch name (``requires_grad`` where they train); buffers: float32
    BatchNorm running statistics; momentum: the SGD buffers, zero for frozen
    parameters."""

    step: int
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    momentum: Dict[str, torch.Tensor]


def freeze_mask(params: Mapping[str, Any], pattern: Optional[str]) -> Dict[str, bool]:
    """True where a parameter trains. ``pattern`` is a regex matched from the
    start (``re.match``, as the reference's fixed-param filter,
    multi_train.py:327-331) against each parameter's '/'-joined flax path
    (``utils/convert.py::flax_path``), so one pattern freezes the same
    tensors here and in the JAX package."""
    if not pattern:
        return {name: True for name in params}
    rx = re.compile(pattern)
    return {name: not rx.match(flax_path(name)) for name in params}


def _global_count(count: torch.Tensor) -> torch.Tensor:
    """A rank's count summed over the ranks (a loss normaliser)."""
    return pdist.all_reduce_(count.clone())


@contextlib.contextmanager
def _without_onednn():
    was = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = was


@contextlib.contextmanager
def _mode(module: nn.Module, train: bool):
    was = module.training
    module.train(train)
    try:
        yield
    finally:
        module.train(was)


@contextlib.contextmanager
def _stats_reduce(bns: List[BatchNorm], reduce):
    """The BatchNorms normalise with ``reduce`` of their batch statistics
    inside the block."""
    for m in bns:
        m.stats_reduce = reduce
    try:
        yield
    finally:
        for m in bns:
            m.stats_reduce = None


class MultiTaskSolver:
    """Owns the model template, anchors, optimizer and the train/eval steps.

    Args:
      model: a ``DSPNet`` module (its weights seed ``init_state``).
      anchors: (A, 4) anchor table (numpy or tensor).
      learning_rate: float or schedule ``count -> lr``.
      momentum / weight_decay / batch_size: MXNet SGD conventions
        (multi_solver.py:221-222); ``rescale_grad = 1/(batch_size *
        grad_accum)``.
      freeze_pattern: regex of flax parameter paths that do not train.
      seg_grad_scale / seg_normalize: see ``train/losses.py``.
      compute_dtype: 'float32' or 'bfloat16' (float32 master weights).
      target_backend: matcher for ``multibox_target``: 'auto' (the CUDA
        kernel for a CUDA batch, the plain rounds on the CPU), 'kernel' or
        'plain'.
      grad_accum: microbatches summed before one update (``fit`` only).
      device: where the state and the batches live: the card unless the
        caller asks for ``"cpu"``.

    The solver is data-parallel over the default process group when one is
    initialised at construction (``distributed``); each rank then passes its
    own rows and ``batch_size`` stays the global batch.
    """

    def __init__(
        self,
        model: nn.Module,
        anchors,
        learning_rate=1e-3,
        momentum: float = 0.9,
        weight_decay: float = 5e-4,
        batch_size: int = 1,
        freeze_pattern: Optional[str] = None,
        seg_grad_scale: float = 4.0,
        seg_normalize: str = "null",
        overlap_threshold: float = 0.5,
        negative_mining_ratio: float = 3.0,
        negative_mining_thresh: float = 0.5,
        compute_dtype="float32",
        target_backend: str = "auto",
        grad_accum: int = 1,
        device="cuda",
    ):
        self.model = model
        self.device = torch.device(device)
        self.anchors_np = np.asarray(torch.as_tensor(anchors).cpu(), np.float32)
        self.anchors = torch.as_tensor(self.anchors_np, device=self.device)
        self.freeze_pattern = freeze_pattern
        self.seg_grad_scale = seg_grad_scale
        self.seg_normalize = seg_normalize
        self.overlap_threshold = overlap_threshold
        self.negative_mining_ratio = negative_mining_ratio
        self.negative_mining_thresh = negative_mining_thresh
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.target_backend = target_backend
        self.grad_accum = int(grad_accum)
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.tx = MXNetSGD(learning_rate, momentum, weight_decay,
                           rescale_grad=1.0 / (batch_size * self.grad_accum))
        self.distributed = pdist.active()
        self._bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
        self._val_detector = None  # built by the first validation pass of fit()

    # ---------------------------------------------------------------- init

    def init_state(self) -> TrainState:
        """A state holding float32 copies of the model's weights on the
        solver's device, zero momentum, step 0."""
        params = {n: p.detach().to(self.device, torch.float32, copy=True)
                  for n, p in self.model.named_parameters()}
        for name, trains in freeze_mask(params, self.freeze_pattern).items():
            params[name].requires_grad_(trains)
        buffers = {n: b.detach().to(self.device, torch.float32 if b.is_floating_point() else None,
                                    copy=True)
                   for n, b in self.model.named_buffers()}
        momentum = {n: torch.zeros_like(p) for n, p in params.items()}
        return TrainState(0, params, buffers, momentum)

    # ---------------------------------------------------------------- step

    def _to_device(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """numpy or tensors -> tensors on the solver's device (floats as f32);
        a batch already there is returned as it is."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            out[k] = t.to(self.device, torch.float32) if t.is_floating_point() else t.to(self.device)
        return out

    def forward(self, state: TrainState, batch: Mapping, train: bool = False) -> Dict[str, torch.Tensor]:
        """The network on the state's weights in ``compute_dtype``, outputs in
        float32. In train mode the running statistics update in place."""
        batch = self._to_device(batch)
        tensors = dict(state.params)
        images = batch["images"]
        if self.compute_dtype != torch.float32:
            tensors = cast_tensors(tensors, self.compute_dtype)
            images = images.to(self.compute_dtype)
        tensors.update(state.buffers)
        reduce = pdist.all_reduce_sum if train and self.distributed else None
        with _mode(self.model, train), _stats_reduce(self._bns, reduce):
            outputs = torch.func.functional_call(self.model, tensors, (images,), strict=True)
        return {k: v.float() for k, v in outputs.items()}

    def _loss_fn(self, state: TrainState, batch: Dict[str, torch.Tensor], train: bool):
        outputs = self.forward(state, batch, train)
        loc_t = loc_m = cls_t = None
        if "cls_logits" in outputs and "label_det" in batch:
            # target assignment reads (B, C, A) logits, as the reference op
            loc_t, loc_m, cls_t = multibox_target(
                self.anchors,
                batch["label_det"],
                outputs["cls_logits"].detach().transpose(1, 2),
                overlap_threshold=self.overlap_threshold,
                negative_mining_ratio=self.negative_mining_ratio,
                negative_mining_thresh=self.negative_mining_thresh,
                bipartite_backend=self.target_backend,
            )
            lc = outputs["loc_preds"].shape[-1]  # 4-channel SSD heads drop the distance
            loc_t, loc_m = loc_t[..., :lc], loc_m[..., :lc]
        count_reduce = _global_count if train and self.distributed else None
        return loss_mod.multitask_loss(
            outputs, loc_t, loc_m, cls_t, batch.get("seg_label"),
            seg_grad_scale=self.seg_grad_scale, seg_normalize=self.seg_normalize,
            count_reduce=count_reduce)

    def _grads(self, state: TrainState, batch) -> Tuple[List[str], List[torch.Tensor], Dict]:
        """Gradients of the trainable parameters and the step's metrics; the
        running statistics update on the way. Under data parallelism both
        are summed over the ranks (the global batch's)."""
        names = [n for n, p in state.params.items() if p.requires_grad]
        with torch.enable_grad(), self._convolution_backend():
            loss, metrics = self._loss_fn(state, batch, train=True)
            grads = torch.autograd.grad(loss, [state.params[n] for n in names],
                                        allow_unused=True, materialize_grads=True)
        metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
        if self.distributed:
            grads = pdist.all_reduce_tensors_(grads)
            keys = list(metrics)
            summed = pdist.all_reduce_(torch.stack([metrics[k].double() for k in keys]))
            metrics = dict(zip(keys, summed.unbind(0)))
        return names, list(grads), metrics

    def _convolution_backend(self):
        """PyTorch's own convolution for a bfloat16 step on the CPU: oneDNN's
        bfloat16 weight gradient there (PyTorch 2.13, an AMX CPU) now and then
        leaves a kernel tap that reads only padding unwritten (a 3x3 stride-2
        convolution of a 1x1 map: NaN or garbage at that tap, more often on a
        loaded host). Other dtypes and the card keep the default backend."""
        if self.device.type == "cpu" and self.compute_dtype == torch.bfloat16:
            return _without_onednn()
        return contextlib.nullcontext()

    def _apply_updates(self, state: TrainState, names: List[str], grads: List[torch.Tensor]):
        """One SGD update of the trainable parameters, in place. Frozen
        parameters take no update and keep zero momentum, as the JAX solver
        zeroes both (``solver.py:212-234``)."""
        self.tx.step([state.params[n] for n in names], grads,
                     [state.momentum[n] for n in names], state.step)
        state.step += 1
        return state

    def train_step(self, state: TrainState, batch: Mapping):
        """One update on one batch: returns ``(state, metrics)``, the state
        updated in place, the metrics as 0-dim tensors on the device."""
        if self.grad_accum != 1:
            raise ValueError("grad_accum > 1 trains through fit() (microbatch accumulation)")
        names, grads, metrics = self._grads(state, self._to_device(batch))
        return self._apply_updates(state, names, grads), metrics

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Mapping) -> Dict[str, torch.Tensor]:
        """The losses and metrics in eval mode (running statistics), no update."""
        return self._loss_fn(state, self._to_device(batch), train=False)[1]

    def _micro_step(self, state: TrainState, acc: Optional[Dict[str, torch.Tensor]], batch):
        """Add one microbatch's gradients into ``acc`` (in place); the
        running statistics update per microbatch."""
        names, grads, metrics = self._grads(state, self._to_device(batch))
        if acc is None:
            acc = dict(zip(names, grads))
        else:
            torch._foreach_add_([acc[n] for n in names], grads)
        return acc, metrics

    def _apply_accumulated(self, state: TrainState, acc: Dict[str, torch.Tensor]):
        names = list(acc)
        return self._apply_updates(state, names, [acc[n] for n in names])

    # ---------------------------------------------------------- detectors

    @staticmethod
    def detector_variables(state: TrainState) -> Dict[str, torch.Tensor]:
        """The state's weights as one state dict (parameters and buffers)."""
        return {k: v.detach() for k, v in {**state.params, **state.buffers}.items()}

    def make_detector(self, state: TrainState, data_shape, **kwargs):
        """A ``Detector`` serving the state's current weights; refresh it with
        ``detector.update_weights(solver.detector_variables(state))``.
        ``kwargs`` go to the Detector (``devices=[...]`` serves over several
        devices, as the JAX solver passes ``mesh``)."""
        from dspnet_torch.detect.detector import Detector

        kwargs.setdefault("device", self.device)
        det = Detector(self.model, self.anchors_np, data_shape, **kwargs)
        det.update_weights(self.detector_variables(state))
        return det

    # ---------------------------------------------------------------- loop

    @staticmethod
    def _check_finite(metrics: Dict[str, float], epoch: int, batch: int):
        """Raise :class:`TrainingDiverged` on a NaN or inf metric (host floats)."""
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            raise TrainingDiverged(
                f"non-finite training metrics {bad} at epoch {epoch} batch "
                f"{batch}: {metrics}. The run has diverged (params are "
                "already non-finite); lower --lr, or with the reference's "
                "unnormalized seg loss (--seg-normalize null, a per-pixel "
                "SUM calibrated to lr 5e-4) use --seg-normalize valid for "
                "larger learning rates.")

    def fit(
        self,
        state: TrainState,
        train_iter: Iterable,
        num_epochs: int = 1,
        eval_iter=None,
        eval_every: int = 1,
        data_shape=None,
        log_fn=print,
        epoch_end_callback=None,
        log_every: int = 20,
        batch_end_callback=None,
        epoch_offset: int = 0,
        metrics_sink=None,
    ) -> TrainState:
        """Reference-style loop (multi_solver.py:182-353): a train step per
        batch, metrics logged every ``log_every`` batches and averaged per
        epoch, ``epoch_end_callback(epoch, state)`` after each epoch.

        ``epoch_offset`` shifts the epoch numbers in log lines and in
        ``metrics_sink(absolute_epoch, split, metrics)``; callbacks receive
        the 0-based loop epoch. Under ``grad_accum > 1`` the chunks count
        microbatches and carry across epoch boundaries, and a partial chunk
        left at the end is applied as one last, smaller update.

        The iterator owns decode-ahead and the copy to the device
        (``DeviceAugIterator`` does both); host arrays are copied at the step.
        With ``eval_iter``, a validation pass (``evaluate_model``) runs after
        the epoch callback whenever ``(absolute epoch + 1) % eval_every ==
        0``, on one float32 ``Detector`` (NMS 0.5, as the JAX one) built at
        the first pass and refreshed with the state's weights before each;
        it logs ``epoch {ep} validation: …`` and sends the finite numbers to
        ``metrics_sink(ep, "val", …)``. ``data_shape`` is the detector's
        input shape. Under data parallelism the ranks meet at a barrier after
        each epoch's callback and validation pass, which the caller gives to
        rank 0 alone (the JAX CLI evaluates on process 0).
        """
        if eval_iter is not None and data_shape is None and self._val_detector is None:
            raise ValueError("fit(eval_iter=...) needs data_shape")  # before an epoch is spent
        accum = self.grad_accum
        acc = None
        micro_n = 0
        for epoch in range(num_epochs):
            ep = epoch + epoch_offset
            agg: Dict[str, torch.Tensor] = {}
            counts: Dict[str, int] = {}
            n = 0
            for batch in train_iter:
                if accum == 1:
                    state, metrics = self.train_step(state, batch)
                else:
                    acc, metrics = self._micro_step(state, acc, batch)
                    micro_n += 1
                    if micro_n % accum == 0:
                        state = self._apply_accumulated(state, acc)
                        acc = None
                n += 1
                # summed on the device: a float() here would sync every step
                for k, v in metrics.items():
                    agg[k] = agg[k] + v if k in agg else v.double()
                    counts[k] = counts.get(k, 0) + 1
                if n % log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    log_fn(f"epoch {ep} batch {n}: " + ", ".join(f"{k}={v:.4f}" for k, v in m.items()))
                    self._check_finite(m, ep, n)
                if batch_end_callback is not None:
                    batch_end_callback(state, n)
            if n:
                means = {k: float(v) / counts[k] for k, v in agg.items()}
                log_fn(f"epoch {ep} done: " + ", ".join(f"{k}={v:.4f}" for k, v in means.items()))
                self._check_finite(means, ep, n)
                if metrics_sink is not None:
                    metrics_sink(ep, "train", means)
            if epoch_end_callback is not None:
                epoch_end_callback(epoch, state)
            if eval_iter is not None and eval_every > 0 and (ep + 1) % eval_every == 0:
                self._validate(state, eval_iter, data_shape, ep, log_fn, metrics_sink)
            if self.distributed:
                pdist.barrier()  # the other ranks wait while rank 0 validates and checkpoints
        if acc is not None:
            state = self._apply_accumulated(state, acc)
        return state

    def _validate(self, state: TrainState, eval_iter, data_shape, ep: int, log_fn, metrics_sink):
        """The per-epoch validation pass (reference multi_solver.py:355-517)."""
        from dspnet_torch.evaluate.loop import evaluate_model

        if self._val_detector is None:
            self._val_detector = self.make_detector(state, data_shape)
        else:
            self._val_detector.update_weights(self.detector_variables(state))
        results = evaluate_model(self._val_detector, eval_iter, log_fn=log_fn)
        log_fn(f"epoch {ep} validation: " + ", ".join(
            f"{k}={v:.4f}" for k, v in results.items()
            if isinstance(v, float) and k in ("mAP", "mIoU", "accuracy", "derror")))
        if metrics_sink is not None:
            metrics_sink(ep, "val", {k: float(v) for k, v in results.items()
                                     if isinstance(v, (int, float)) and np.isfinite(v)})
