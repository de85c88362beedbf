"""Multi-process data parallelism (counterpart of the data-parallel part of
``dspnet_tpu/parallel/mesh.py``).

A JAX step over a batch sharded on the mesh's ``data`` axis is one global
program: its BatchNorm statistics, loss normalisers and gradients are those
of the global batch. Here each rank is a process that runs the step on its
``rank::world`` rows (``data/iterator.py::shard_positions``), and the solver
makes the step global with explicit collectives over the default process
group: BatchNorm sums each channel's statistics over the ranks
(``models/layers.py``), the losses divide by the global counts
(``train/losses.py``), and the gradients are summed across ranks before the
MXNet SGD, whose ``rescale_grad`` is 1/(global batch x grad_accum)
(``train/solver.py``). Spatial sharding over the JAX mesh's ``model`` axis
is not ported.

Backend rule: NCCL when every rank on a host has a card of its own; gloo on
the CPU and where more ranks than cards share a host (NCCL refuses two ranks
on one device). The rule decides once; a failing NCCL init fails the run,
it does not switch to gloo. Every collective carries the process group's
timeout, so a rank that dies does not leave the others waiting forever.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import socket
from typing import Iterable, List

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0
#: gradient bucket for the all-reduce (elements of one dtype per call)
BUCKET_ELEMENTS = 1 << 24


@dataclasses.dataclass(frozen=True)
class DistInfo:
    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str


def choose_backend(device: torch.device, local_world: int) -> str:
    """'nccl' when each local rank has a card of its own, else 'gloo'."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def distributed_init(coordinator: str, num_processes: int, process_id: int, device="cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> DistInfo:
    """Join the process group at ``tcp://{coordinator}`` (host:port) as rank
    ``process_id`` of ``num_processes``.

    On ``cuda`` the rank takes the card ``local_rank % device_count``, where
    ``local_rank = process_id % local_world_size`` and the ranks on this
    host, ``local_world_size``, are ``$LOCAL_WORLD_SIZE``, else
    ``num_processes`` (every rank on one host). ``timeout_s`` bounds every
    collective. Returns the rank's :class:`DistInfo`; its ``device`` is
    where the rank computes."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} outside 0..{num_processes - 1}")
    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised in this process")
    device = torch.device(device)
    local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    local_rank = process_id % local_world_size
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("distributed_init on cuda: no CUDA device here")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = choose_backend(device, local_world_size)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    info = DistInfo(process_id, num_processes, local_rank, device, backend)
    logging.getLogger(__name__).info(
        "distributed: rank %d of %d (local rank %d), device %s, backend %s, coordinator %s, timeout %g s",
        info.rank, info.world, info.local_rank, device, backend, coordinator, timeout_s)
    return info


def active() -> bool:
    """True when a default process group is initialised (of any size: a
    group of one rank runs every collective, each the identity)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The default process group's size; 1 when there is none."""
    return dist.get_world_size() if active() else 1


def barrier() -> None:
    if active():
        dist.barrier()


def destroy() -> None:
    if active():
        dist.destroy_process_group()


def _sum_(t: torch.Tensor) -> torch.Tensor:
    """``dist.all_reduce`` (sum) in place; under gloo a card's tensor goes
    through host memory (gloo reduces host buffers)."""
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (outside autograd); returns it."""
    if active():
        _sum_(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its gradient is the sum of the ranks'
    gradients (every rank's loss depends on the sum)."""

    @staticmethod
    def forward(ctx, x):
        return _sum_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad):
        return _sum_(grad.clone(memory_format=torch.contiguous_format))


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks."""
    return _AllReduceSum.apply(x) if active() else x


def all_reduce_tensors_(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    """Sum each tensor over the ranks in place, a few large all-reduces
    instead of one per tensor: consecutive tensors of one dtype and device
    are packed into flat buckets of at most ``BUCKET_ELEMENTS``."""
    tensors = list(tensors)
    if not active() or not tensors:
        return tensors
    bucket: List[torch.Tensor] = []

    def flush():
        if not bucket:
            return
        flat = _sum_(torch.cat([t.reshape(-1) for t in bucket]))
        off = 0
        for t in bucket:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n
        bucket.clear()

    size = 0
    for t in tensors:
        if bucket and (t.dtype != bucket[0].dtype or t.device != bucket[0].device
                       or size + t.numel() > BUCKET_ELEMENTS):
            flush()
            size = 0
        bucket.append(t)
        size += t.numel()
    flush()
    return tensors


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
