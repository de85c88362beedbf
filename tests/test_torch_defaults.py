"""The port's entry points run on the card unless the caller asks for the CPU.

``create_model``, ``Detector``, ``MultiTaskSolver``, ``prefetch_to_device``
and ``DetIterator`` default to ``device="cuda"``. Without a card a default call raises torch's
own error; it never runs on the CPU silently. Whether a card is present is
decided inside the test, never at import.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from dspnet_torch.api import create_model
from dspnet_torch.data.det_iterator import DetIterator
from dspnet_torch.data.iterator import SampleIndex
from dspnet_torch.data.prefetch import prefetch_to_device
from dspnet_torch.detect.detector import Detector
from dspnet_torch.train.solver import MultiTaskSolver

torch.set_num_threads(2)

H, W = 64, 128


def _bundle():
    return create_model("resnet-18_multi", (H, W), device="cpu")


def _create_model():
    return next(create_model("resnet-18_multi", (H, W)).model.parameters()).device


def _detector():
    bundle = _bundle()
    return Detector(bundle.model, bundle.anchors, (H, W)).anchors.device


def _solver():
    bundle = _bundle()
    return MultiTaskSolver(bundle.model, bundle.anchors).anchors.device


def _prefetch():
    return next(prefetch_to_device(iter([np.zeros(2, np.float32)]))).device


def _det_iterator():
    return DetIterator(SampleIndex([]), 2, (H, W)).mean_pixels.device


ENTRY_POINTS = {
    "create_model": (create_model, _create_model),
    "DetIterator": (DetIterator.__init__, _det_iterator),
    "Detector": (Detector.__init__, _detector),
    "MultiTaskSolver": (MultiTaskSolver.__init__, _solver),
    "prefetch_to_device": (prefetch_to_device, _prefetch),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_cuda(name):
    fn, _ = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_call_runs_on_the_card_or_raises(name):
    _, call = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert call().type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


def test_cpu_on_request():
    """Asked for the CPU, every entry point stays there."""
    bundle = _bundle()
    assert next(bundle.model.parameters()).device.type == "cpu"
    assert Detector(bundle.model, bundle.anchors, (H, W), device="cpu").anchors.device.type == "cpu"
    assert MultiTaskSolver(bundle.model, bundle.anchors, device="cpu").anchors.device.type == "cpu"
    out = next(prefetch_to_device(iter([np.zeros(2, np.float32)]), device="cpu"))
    assert out.device.type == "cpu"
    assert DetIterator(SampleIndex([]), 2, (H, W), device="cpu").mean_pixels.device.type == "cpu"


def _pipeline():
    from dspnet_torch.detect.pipeline import ServingPipeline

    bundle = _bundle()
    return ServingPipeline(Detector(bundle.model, bundle.anchors, (H, W)), depth=1).detector.device


@pytest.mark.parametrize("tool", ["multi_demo", "import_mxnet", "eval_voc"])
def test_demo_and_import_tool_default_to_the_card(tool, tmp_path):
    """The demo CLI, the MXNet import tool and the VOC eval CLI take
    ``--device cuda`` unless told otherwise, and without a card they stop
    with a clear message."""
    import importlib

    mod = importlib.import_module(
        f"dspnet_torch.tools.{tool}" if tool == "import_mxnet" else f"dspnet_torch.cli.{tool}")
    argv = ["--params", str(tmp_path / "none.params")] if tool == "import_mxnet" else []
    argv += ["--voc-root", str(tmp_path)] if tool == "eval_voc" else []
    argv += ["--network", "resnet-18_multi" if tool != "eval_voc" else "resnet-18", "--data-shape", f"3,{H},{W}"]
    assert mod.parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            mod.main(argv + ["--model-dir", str(tmp_path)])


def test_serving_pipeline_serves_on_the_card_or_raises():
    """ServingPipeline serves on its detector's device, the card by default."""
    if torch.cuda.is_available():
        assert _pipeline().type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            _pipeline()
