"""``ServingPipeline`` and the monitor (``utils/profiler.py``) of the port,
on the CPU: results in submission order with their tags and equal to the
synchronous path at depths 1 and 3; ``StatMonitor`` filters by flax path
before it reads a tensor, and logs the names the JAX CLI's monitor logs for
the same pattern."""

import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dspnet_torch
from dspnet_tpu.api import create_model as jax_create_model
from dspnet_tpu.train.solver import MultiTaskSolver as JaxSolver
from dspnet_tpu.utils.profiler import StatMonitor as JaxStatMonitor
from dspnet_torch.api import create_model
from dspnet_torch.detect.detector import Detector
from dspnet_torch.detect.pipeline import ServingPipeline
from dspnet_torch.train.solver import MultiTaskSolver
from dspnet_torch.utils import profiler

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

H, W = 128, 256


@pytest.fixture(scope="module")
def detector():
    bundle = create_model("resnet-18_multi", (H, W), device="cpu", generator=torch.Generator().manual_seed(4))
    return Detector(bundle.model, bundle.anchors, (H, W), device="cpu")


@pytest.mark.parametrize("depth", [1, 3])
def test_pipeline_order_tags_and_equality(detector, depth):
    frames = np.random.RandomState(depth).randint(0, 256, (7, H, W, 3), np.uint8)
    pipe = ServingPipeline(detector, depth=depth)
    out = []
    for i, f in enumerate(frames):
        got = pipe.submit(f, tag=f"frame{i}")
        assert (got is None) == (i < depth)
        assert len(pipe) == min(i + 1, depth)
        if got is not None:
            out.append(got)
    out += list(pipe.drain())
    assert len(pipe) == 0 and list(pipe.drain()) == []
    assert pipe.wait_s == 0.0  # CPU results: nothing to wait for
    assert [t for t, _ in out] == [f"frame{i}" for i in range(7)]
    for (tag, res), f in zip(out, frames):
        sync = detector.predict_raw(f[None])
        assert set(res) == set(sync) == {"det", "seg"}
        for k in sync:
            assert isinstance(res[k], np.ndarray)
            np.testing.assert_array_equal(res[k], sync[k].numpy())


def test_pipeline_default_tags_batches_and_floats(detector):
    frames = np.random.RandomState(9).randint(0, 256, (2, H, W, 3), np.uint8)
    pipe = ServingPipeline(detector, depth=2)
    assert pipe.submit(frames) is None and pipe.submit(frames[0]) is None
    (t0, r0), (t1, r1) = list(pipe.drain())
    assert (t0, t1) == (0, 1) and r0["det"].shape[0] == 2 and r1["det"].shape[0] == 1
    floats = frames[..., ::-1].astype(np.float32) - np.float32(detector.mean_pixels)
    fpipe = ServingPipeline(detector, depth=1, raw=False)
    assert fpipe.submit(floats) is None
    (_, res), = list(fpipe.drain())
    np.testing.assert_array_equal(res["seg"], detector.predict(floats)["seg"].numpy())
    with pytest.raises(ValueError, match="depth"):
        ServingPipeline(detector, depth=0)
    assert dspnet_torch.ServingPipeline is ServingPipeline


def test_pipeline_graphs_only_on_the_card(detector):
    """A CUDA detector's pipeline replays graphs (``test_torch_pipeline_cuda.py``);
    a CPU one holds no slots and no streams, and ``update_weights`` reaches
    its eager calls."""
    pipe = ServingPipeline(detector, depth=3)
    assert pipe._slots == []
    frame = np.random.RandomState(5).randint(0, 256, (1, H, W, 3), np.uint8)
    old = {k: v.clone() for k, v in detector.model.state_dict().items()}
    other = create_model("resnet-18_multi", (H, W), device="cpu", generator=torch.Generator().manual_seed(5))
    try:
        pipe.update_weights(other.model)
        pipe.submit(frame)
        (_, res), = list(pipe.drain())
        np.testing.assert_array_equal(res["seg"], detector.predict_raw(frame)["seg"].numpy())
        assert all(torch.equal(v, other.model.state_dict()[k]) for k, v in detector.model.state_dict().items())
    finally:
        detector.update_weights(old)


class _Untouchable(torch.Tensor):
    """A tensor whose every operation fails: the monitor must not touch a
    tensor its pattern rejects."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} read a tensor the pattern rejects")


def test_stat_monitor_filters_before_reading_and_matches_jax_names():
    """Every 2nd call logs the tensors whose flax path matches the pattern;
    tensors it rejects are never operated on; the names are those the JAX
    CLI's monitor logs for the same pattern on the JAX params tree, and the
    stats agree with numpy's on the flax-layout arrays."""
    pattern = "backbone/stage1"
    net = create_model("resnet-18_multi", (H, W), device="cpu")
    state = MultiTaskSolver(net.model, net.anchors, device="cpu").init_state()
    params = {k: (v if "stage1" in k else v.detach().as_subclass(_Untouchable)) for k, v in state.params.items()}
    lines = []
    log = logging.getLogger("test_monitor")
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        mon = profiler.StatMonitor(interval=2, pattern=pattern, logger=log)
        mon.tic_toc(params)
        assert lines == []
        mon.tic_toc(params)
        got = {line.split()[1]: line for line in lines}

        jbundle = jax_create_model("resnet-18_multi", (H, W))
        js = JaxSolver(jbundle.model, jbundle.anchors)
        jst = js.init_state(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
        lines.clear()
        jmon = JaxStatMonitor(interval=1, pattern=pattern, logger=log)
        jmon.tic_toc(jst.params)
        want = {line.split()[1] for line in lines}
    finally:
        log.removeHandler(handler)
    assert set(got) == want and len(want) > 10
    from dspnet_torch.utils.convert import to_flax_variables

    flax = to_flax_variables({k: v for k, v in state.params.items() if "stage1" in k})["params"]
    name = "backbone/stage1_unit1/conv1/kernel"
    arr = flax["backbone"]["stage1_unit1"]["conv1"]["kernel"]
    assert f"shape={arr.shape} mean={arr.mean():.5f} std={arr.std():.5f}" in got[name]


def test_trace_speedometer_and_step_timer(tmp_path, detector):
    with profiler.trace(str(tmp_path / "trace")) as prof:
        detector.predict_raw(np.zeros((1, H, W, 3), np.uint8))
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    assert any("conv" in e.key for e in prof.key_averages())
    lines = []
    log = logging.getLogger("test_speed")
    log.addHandler(type("H", (logging.Handler,), {"emit": lambda self, r: lines.append(r.getMessage())})())
    log.setLevel(logging.INFO)
    speed = profiler.Speedometer(batch_size=4, frequent=2, logger=log)
    for _ in range(4):
        speed(0, {"loss": torch.tensor(1.5)})
    assert len(lines) == 2 and "samples/sec" in lines[0] and "loss=1.5000" in lines[0]
    timer = profiler.StepTimer()
    for _ in range(3):
        with timer:
            pass
    assert timer.count == 3 and timer.ms_per_step >= 0.0


def test_multi_train_monitor_lines(tmp_path, monkeypatch, caplog):
    """``multi_train --monitor 2 --pattern RX`` logs the matching parameters
    every second batch through fit's batch callback, and nothing else."""
    from dspnet_torch.cli import multi_train

    monkeypatch.chdir(tmp_path)
    with caplog.at_level(logging.INFO):
        multi_train.main(["--network", "resnet-18_multi", "--data-shape", f"3,{H},{W}", "--batch-size", "1",
                          "--device", "cpu", "--synthetic", "4", "--synthetic-dir", str(tmp_path / "s"),
                          "--model-dir", str(tmp_path / "m"), "--end-epoch", "1", "--eval-every", "0",
                          "--seg-normalize", "valid", "--monitor", "2", "--pattern", "multibox/cls_pred_0"])
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("monitor ")]
    assert len(lines) == 2 * 2  # batches 2 and 4, kernel and bias each
    assert {line.split()[1] for line in lines} == {"multibox/cls_pred_0/kernel", "multibox/cls_pred_0/bias"}
