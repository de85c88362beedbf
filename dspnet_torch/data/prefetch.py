"""Device prefetch: a background thread keeps ``size`` batches in flight
(counterpart of ``dspnet_tpu/data/prefetch.py``).

On a CUDA device the host-to-device copies of host arrays go from pinned
memory on a side ``torch.cuda.Stream``; the consumer's stream waits on that
copy's event before it uses the batch, and each copied tensor is recorded
on the consumer's stream so the allocator keeps its memory until the
consumer's work on it is done. Tensors already on the device pass through.
A leaf with a ``place_on(device)`` method makes its own tensor there, on
the same side stream and under the same event (the loader's JPEG batches
decode on the card this way, ``data/device_pipeline.py``). On the CPU it is
the thread alone.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List

import numpy as np
import torch


def _place(item, device: torch.device, moved: List[torch.Tensor]):
    """numpy arrays and CPU tensors in nested dicts / lists / tuples -> tensors
    on ``device`` (copies appended to ``moved``); other leaves as they are."""
    if isinstance(item, dict):
        return {k: _place(v, device, moved) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_place(v, device, moved) for v in item)
    if hasattr(item, "place_on"):
        out = item.place_on(device)
        if device.type == "cuda":
            moved.append(out)
        return out
    if isinstance(item, np.ndarray):
        item = torch.from_numpy(item)
    if isinstance(item, torch.Tensor) and item.device != device:
        if device.type == "cuda":
            out = item.pin_memory().to(device, non_blocking=True)
            moved.append(out)
            return out
        return item.to(device)
    return item


def prefetch_to_device(iterable, size: int = 2, device="cuda") -> Iterator:
    """Yield the items of ``iterable`` with their arrays on ``device``,
    ``size`` items ahead; ``device`` is the card unless the caller asks
    for ``"cpu"``. If the consumer abandons the generator, the
    producer thread is released instead of blocking on the full queue; an
    exception in the producer is raised in the consumer."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:  # 'cuda' means the current card: name it
        device = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()
    stop = threading.Event()

    def put(item):
        moved: List[torch.Tensor] = []
        if not cuda:
            return _place(item, device, moved), None, moved
        with torch.cuda.stream(stream):
            item = _place(item, device, moved)
            event = torch.cuda.Event()
            event.record(stream)
        return item, event, moved

    def offer(entry) -> bool:
        # bounded put that gives up once the consumer is gone
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        it = iter(iterable)
        try:
            for item in it:
                if not offer(put(item)):
                    return
            offer(_END)
        except BaseException as e:  # surfaced to the consumer below
            offer(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:  # an abandoned generator runs its cleanup now
                close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            entry = q.get()
            if entry is _END:
                break
            if isinstance(entry, BaseException):
                raise entry
            item, event, moved = entry
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for x in moved:
                    x.record_stream(current)
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)
