"""Tracing, parameter statistics and throughput logging (counterpart of
``dspnet_tpu/utils/profiler.py``):

* the reference's per-op stat monitor (``stat_helper`` executor callbacks,
  multi_solver.py:262-280; ``mx.mon.Monitor``, multi_train.py:76-79,379) ->
  :func:`tensor_stats` + :class:`StatMonitor`, which name each tensor by its
  flax path (``utils/convert.py::flax_path``), so a ``--pattern`` written for
  the JAX CLI selects the same tensors here;
* wall-clock throughput (``mx.callback.Speedometer``) -> :class:`Speedometer`;
* per-step timing -> :class:`StepTimer`;
* device traces -> :func:`trace`, on ``torch.profiler`` (a Chrome trace).
"""

from __future__ import annotations

import contextlib
import logging
import os
import re
import time
from typing import Dict, Mapping, Optional

import torch

from dspnet_torch.utils.convert import flax_path


@contextlib.contextmanager
def trace(log_dir: str = "log/trace"):
    """``torch.profiler`` over the block (the CPU, and the card when there is
    one); the Chrome trace lands in ``log_dir/trace.json``. Yields the
    profiler (``key_averages()`` for sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _flax_shape(name: str, shape) -> tuple:
    """A tensor's shape in the flax layout its path names (conv kernels HWIO,
    the transposed conv's (kh, kw, in, out))."""
    shape = tuple(shape)
    if len(shape) == 4 and name.endswith("weight"):
        path = flax_path(name)
        if path.endswith("ConvTranspose_0/kernel"):
            return shape[2], shape[3], shape[0], shape[1]
        if path.endswith("kernel"):
            return shape[2], shape[3], shape[1], shape[0]
    return shape


def tensor_stats(tensors: Mapping[str, torch.Tensor], prefix: str = "", name_filter=None) -> Dict[str, str]:
    """Shape / mean / std of named port tensors (a state's ``params``), keyed
    by ``prefix`` + flax path. ``name_filter(name) -> bool`` is applied
    before anything of a tensor is read: a tensor it rejects costs no
    device work and no copy; each one it keeps costs two numbers copied to
    the host."""
    out = {}
    for key, t in tensors.items():
        name = prefix + flax_path(key)
        if name_filter is not None and not name_filter(name):
            continue
        x = t.detach().double()
        mean, std = torch.stack([x.mean(), x.std(correction=0)]).tolist()
        out[name] = f"shape={_flax_shape(key, t.shape)} mean={mean:.5f} std={std:.5f}"
    return out


class StatMonitor:
    """Logs the stats of the tensors whose flax path matches ``pattern``
    (``re.search``) every ``interval`` calls (``mx.mon.Monitor``,
    multi_train.py:76-79,379)."""

    def __init__(self, interval: int = 100, pattern: str = ".*", logger=None):
        self.interval = interval
        self.rx = re.compile(pattern)
        self.log = (logger or logging.getLogger()).info
        self._step = 0

    def tic_toc(self, tensors: Mapping[str, torch.Tensor]):
        self._step += 1
        if self._step % self.interval:
            return
        for name, stat in tensor_stats(tensors, name_filter=self.rx.search).items():
            self.log("monitor %s %s", name, stat)


class Speedometer:
    """Throughput callback: logs samples/sec every ``frequent`` batches."""

    def __init__(self, batch_size: int, frequent: int = 20, logger=None):
        self.batch_size = batch_size
        self.frequent = frequent
        self.log = (logger or logging.getLogger()).info
        self.count = 0
        self.tic = time.time()

    def __call__(self, epoch: int, metrics: Optional[Dict] = None):
        self.count += 1
        if self.count % self.frequent == 0:
            speed = self.frequent * self.batch_size / (time.time() - self.tic)
            extra = ""
            if metrics:
                extra = " " + " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
            self.log("Epoch[%d] Batch [%d] Speed: %.2f samples/sec%s", epoch, self.count, speed, extra)
            self.tic = time.time()


class StepTimer:
    """Per-step wall-clock timing with aggregation (the eval loop's
    ms/batch, multi_eval.py:311-318)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1

    @property
    def ms_per_step(self) -> float:
        return 1000.0 * self.total / max(self.count, 1)
