"""Throughput-oriented serving pipeline (counterpart of
``dspnet_tpu/detect/pipeline.py``).

The synchronous path, ``predict_raw`` then copying the results to the host,
leaves the card idle while the host copies a frame in, launches the next
frame's kernels and copies results out. At b1 the host's launches are most
of a frame: eager PyTorch issues some hundreds of kernels one by one, which
takes the host several times the card's busy time. So on the card each slot
of the window replays a CUDA graph of ``predict_raw`` (or ``predict``),
captured at the first frame of each input shape: a frame then costs the host
one H2D copy into the slot's static input, one graph launch and the result
copies. Each ``submit`` does that on its slot's own stream, starts the
results' copies to pinned host memory without blocking and records a CUDA
event; a result is materialised only when the window is full, by waiting on
its own event. Slots run on separate streams, so up to ``depth + 1`` frames
run on the card at once (a b1 frame leaves most of its SMs idle). Nothing on
``predict_raw``'s path synchronises the host (the NMS wrapper does not), so
the host stays up to ``depth`` frames ahead of the card.

A replayed graph runs the kernels it captured without calling their
wrappers: the wrappers' launch counters (``ops/nms_cuda.launches``) count
each slot's warm-up and capture, not its replays; ``torch.profiler`` sees
every replayed kernel. A CPU detector runs ``predict_raw`` eagerly (no
streams, no graphs). Each replay waits for the caller's current stream
first, so a frame already on the card may come from work still queued
there. The captured graphs read the served weights in place: swap them with
:meth:`ServingPipeline.update_weights`, which orders the copy after the
replays in flight and before the next; ``Detector.update_weights`` alone
copies on the current stream and would race with the slots' streams.

Usage (stream serving):

    pipe = ServingPipeline(detector, depth=2)
    for frame in frames:
        out = pipe.submit(frame)          # returns an OLDER frame's result
        if out is not None:               # (None while the window fills)
            tag, res = out
            ...
    for tag, res in pipe.drain():         # flush the tail
        ...

Results come back strictly in submission order, paired with the caller's
tag, as numpy arrays equal to the synchronous path's (the same kernels).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Iterator, Optional, Tuple

import torch


def _start_d2h(res: dict) -> dict:
    """Start a non-blocking copy of every (CUDA) result into pinned host
    memory, complete once the stream passes an event recorded after it."""
    return {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v, non_blocking=True)
            for k, v in res.items()}


class _Slot:
    """One place in the window on the card: a stream, and per input (shape,
    dtype) a captured graph with its static input and outputs."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.graphs = {}


class ServingPipeline:
    """Bounded-depth asynchronous wrapper over a :class:`Detector`.

    ``depth``: frames in flight besides the one being submitted (2 hides one
    frame's copies and launches behind the next; more lets several b1 frames
    share the card). ``raw=True`` feeds ``predict_raw`` (uint8 BGR at the
    data shape, 4x less H2D than float); ``raw=False`` feeds preprocessed
    floats to ``predict``. On a CUDA detector each slot replays a CUDA graph;
    on a CPU detector the calls are eager. ``wait_s`` sums the host seconds
    spent waiting for results (in their events)."""

    def __init__(self, detector, depth: int = 2, raw: bool = True):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        cuda = detector.device.type == "cuda"
        if cuda and len(detector.devices) > 1:
            # a slot's graph is captured on one stream of one device
            raise ValueError("ServingPipeline serves a one-device Detector on a card; "
                             f"this one has devices {detector.devices}")
        self.detector = detector
        self.depth = depth
        self.raw = raw
        self.wait_s = 0.0
        self._inflight: deque = deque()
        self._seq = 0
        self._slots = [_Slot(detector.device) for _ in range(depth + 1)] if cuda else []

    def __len__(self) -> int:
        return len(self._inflight)

    def submit(self, frame, tag: Any = None) -> Optional[Tuple[Any, dict]]:
        """Dispatch one frame (H, W, 3) or batch (B, H, W, 3), numpy or
        tensor; returns the OLDEST (tag, results) once the window is full,
        else None. ``tag`` defaults to a running submission index."""
        if frame.ndim == 3:
            frame = frame[None]
        if tag is None:
            tag = self._seq
        fn = self.detector.predict_raw if self.raw else self.detector.predict
        if self._slots:
            # the slot's last frame was materialised before the window let
            # this one in (depth + 1 slots, at most depth frames in flight)
            host, event = self._replay(self._slots[self._seq % len(self._slots)], fn, torch.as_tensor(frame))
        else:
            host, event = fn(frame), None
        self._seq += 1
        self._inflight.append((tag, host, event))
        if len(self._inflight) > self.depth:
            return self._materialize(self._inflight.popleft())
        return None

    def update_weights(self, weights) -> None:
        """``Detector.update_weights`` ordered against the slots: the copy
        waits for the replays in flight (their frames keep the old weights),
        and every later replay waits for the copy."""
        for slot in self._slots:
            torch.cuda.current_stream().wait_stream(slot.stream)
        self.detector.update_weights(weights)

    def _replay(self, slot: _Slot, fn, frame: torch.Tensor):
        key = (tuple(frame.shape), frame.dtype)
        if key not in slot.graphs:
            slot.graphs[key] = self._capture(slot, fn, frame)
        graph, static_in, static_out = slot.graphs[key]
        if frame.device.type == "cpu":
            frame = frame.pin_memory()
        else:
            # the frame may still be written on the caller's stream, and
            # must outlive the slot stream's read of it
            frame.record_stream(slot.stream)
        slot.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(slot.stream):
            static_in.copy_(frame, non_blocking=True)
            graph.replay()
            host = _start_d2h(static_out)
            event = torch.cuda.Event()
            event.record(slot.stream)
        return host, event

    def _capture(self, slot: _Slot, fn, frame: torch.Tensor):
        """Warm ``fn`` up on the slot's stream (builds the kernels, picks the
        cuDNN plans), then capture it on that stream from a static input."""
        static_in = torch.empty(frame.shape, dtype=frame.dtype, device=self.detector.device)
        static_in.copy_(frame)
        slot.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(slot.stream):
            fn(static_in)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=slot.stream, capture_error_mode="thread_local"):
            static_out = fn(static_in)
        return graph, static_in, static_out

    def drain(self) -> Iterator[Tuple[Any, dict]]:
        """Yield the remaining (tag, results) in order."""
        while self._inflight:
            yield self._materialize(self._inflight.popleft())

    def _materialize(self, item):
        tag, host, event = item
        if event is not None:
            t0 = time.perf_counter()
            event.synchronize()  # this frame's copies alone, not the device
            self.wait_s += time.perf_counter() - t0
        return tag, {k: v.numpy() for k, v in host.items()}
