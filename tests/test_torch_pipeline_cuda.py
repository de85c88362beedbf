"""``ServingPipeline`` on the card, where each slot replays a CUDA graph of
``predict_raw``: results equal to the synchronous path bit for bit and in
order at depths 1 and 3, a second capture when the batch size changes,
frames that are already on the card, and ``update_weights`` between
submits; over a device list (one card named twice), one graph per replica
per slot, equal to the synchronous device-list path at b1, b3 and b8.

Skips without a CUDA device (CUDA graphs and the NMS kernel exist only
there). The file imports no jax, so it also runs on a machine with the card
and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pipeline_cuda.py
"""

import numpy as np
import pytest
import torch

from dspnet_torch.api import create_model
from dspnet_torch.detect.detector import Detector
from dspnet_torch.detect.pipeline import ServingPipeline
from dspnet_torch.ops import nms_cuda

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

H, W = 128, 256


@pytest.fixture
def detector():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pipeline replays CUDA graphs of the NMS kernel's path")
    bundle = create_model("resnet-18_multi", (H, W), device="cuda", generator=torch.Generator().manual_seed(4))
    return Detector(bundle.model, bundle.anchors, (H, W), device="cuda")


def _frames(n, seed, batch=1):
    return np.random.RandomState(seed).randint(0, 256, (n, batch, H, W, 3), np.uint8)


def _sync(detector, frame):
    return {k: v.cpu().numpy() for k, v in detector.predict_raw(frame).items()}


def _run(pipe, frames, tags=None):
    out = []
    for i, f in enumerate(frames):
        got = pipe.submit(f, tag=None if tags is None else tags[i])
        if got is not None:
            out.append(got)
    return out + list(pipe.drain())


def _assert_equal(got, want):
    assert set(got) == set(want) == {"det", "seg"}
    for k in want:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 3])
def test_graph_pipeline_equals_sync_and_keeps_order(detector, depth):
    """Each slot warms up and captures once (two wrapper calls), then every
    frame replays a graph and calls no wrapper; results come back in
    submission order with their tags, equal to ``predict_raw``'s."""
    frames = _frames(2 * (depth + 1) + 1, depth)
    want = [_sync(detector, f) for f in frames]
    pipe = ServingPipeline(detector, depth=depth)
    assert len(pipe._slots) == depth + 1
    before = nms_cuda.launches
    out = _run(pipe, frames, [f"frame{i}" for i in range(len(frames))])
    assert nms_cuda.launches - before == 2 * (depth + 1)
    assert [t for t, _ in out] == [f"frame{i}" for i in range(len(frames))]
    for (_, got), w in zip(out, want):
        _assert_equal(got, w)
    before = nms_cuda.launches
    again = _run(pipe, frames)  # every slot's graph captured: replays only
    assert nms_cuda.launches == before
    assert [t for t, _ in again] == list(range(len(frames), 2 * len(frames)))
    for (_, got), w in zip(again, want):
        _assert_equal(got, w)


@pytest.mark.cuda
def test_graph_pipeline_captures_again_for_a_new_batch_size(detector):
    """A b2 batch after b1 frames gets its own graph in the slot it lands
    in, and both shapes keep giving the synchronous results."""
    ones, twos = _frames(2, 11), _frames(2, 12, batch=2)
    frames = [ones[0], twos[0], ones[1], twos[1]]
    want = [_sync(detector, f) for f in frames]
    pipe = ServingPipeline(detector, depth=1)  # two slots: frames 0, 2 in one, 1, 3 in the other
    out = _run(pipe, frames)
    assert [len(s.graphs) for s in pipe._slots] == [1, 1]
    out += _run(pipe, frames[1::-1])  # now slot 0 gets b2 and slot 1 b1
    assert [sorted(k[0][0] for k in s.graphs) for s in pipe._slots] == [[1, 2], [1, 2]]
    for (_, got), w in zip(out, want + want[1::-1]):
        _assert_equal(got, w)


@pytest.mark.cuda
def test_graph_pipeline_takes_frames_on_the_card(detector):
    """Frames made on the card by work still queued on the caller's stream,
    and dropped by the caller right after ``submit``, give the synchronous
    results (the slot waits for that stream and holds the frame)."""
    frames = _frames(6, 13)
    want = [_sync(detector, f) for f in frames]
    pipe = ServingPipeline(detector, depth=2)
    out = []
    for f in frames:
        on_card = torch.from_numpy(f[..., ::-1].copy()).cuda().flip(-1).contiguous()
        got = pipe.submit(on_card)
        del on_card
        if got is not None:
            out.append(got)
    out += list(pipe.drain())
    for (_, got), w in zip(out, want):
        _assert_equal(got, w)


@pytest.mark.cuda
def test_graph_pipeline_update_weights_between_submits(detector):
    """Frames submitted before ``update_weights`` keep the old weights,
    frames after it get the new ones, with earlier frames still in flight
    when the weights change."""
    frames = _frames(6, 14)
    old = [_sync(detector, f) for f in frames]
    pipe = ServingPipeline(detector, depth=3)
    _run(pipe, frames)  # every slot captured on the old weights
    other = create_model("resnet-18_multi", (H, W), device="cuda", generator=torch.Generator().manual_seed(5))
    out = []
    for f in frames[:3]:
        assert pipe.submit(f) is None
    pipe.update_weights(other.model)
    for f in frames[3:]:
        out.append(pipe.submit(f))
    out += list(pipe.drain())
    new = [_sync(detector, f) for f in frames]
    assert not all(np.array_equal(a["seg"], b["seg"]) for a, b in zip(old, new))
    for (_, got), w in zip(out, old[:3] + new[3:]):
        _assert_equal(got, w)


@pytest.fixture
def pair(detector):
    return Detector(detector.model, detector.anchors.cpu().numpy(), (H, W), devices=["cuda:0", "cuda:0"])


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_graph_pipeline_over_a_device_list(pair, depth, batch):
    """Two replicas on one card: each slot captures one graph per replica on
    that replica's stream (two wrapper calls each), results equal to the
    synchronous device-list ``predict_raw`` bit for bit and in order, also
    after ``update_weights`` with frames in flight."""
    frames = _frames(2 * (depth + 1) + 1, 20 + depth, batch=batch)
    want = [_sync(pair, f) for f in frames]
    pipe = ServingPipeline(pair, depth=depth)
    assert all(len(s.rep_streams) == 2 for s in pipe._slots)
    before = nms_cuda.launches
    out = _run(pipe, frames)
    assert nms_cuda.launches - before == 2 * 2 * (depth + 1)
    assert [t for t, _ in out] == list(range(len(frames)))
    for (_, got), w in zip(out, want):
        _assert_equal(got, w)
    other = create_model("resnet-18_multi", (H, W), device="cuda", generator=torch.Generator().manual_seed(5))
    first = [pipe.submit(f) for f in frames[:depth]]
    assert first == [None] * depth
    pipe.update_weights(other.model)
    out = _run(pipe, frames[depth:])
    new = [_sync(pair, f) for f in frames]
    for (_, got), w in zip(out, want[:depth] + new[depth:]):
        _assert_equal(got, w)
