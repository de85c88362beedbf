"""``Detector(devices=[...])`` of the PyTorch port vs the JAX
``Detector(mesh=...)`` on the CPU: the batch padded to a multiple of the
device count with copies of its last row, a block of rows per replica, the
results gathered with the padding sliced off; equal to the one-device
``Detector`` bit for bit, and ``update_weights`` reaching every replica."""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (tests/conftest.py gives the process 8 CPU devices)

from dspnet_tpu.api import create_model as jax_create_model
from dspnet_tpu.detect.detector import Detector as JaxDetector
from dspnet_tpu.parallel.mesh import make_mesh
from dspnet_torch.api import create_model
from dspnet_torch.detect.detector import MEAN_PIXELS, Detector
from dspnet_torch.detect.pipeline import ServingPipeline
from dspnet_torch.utils.convert import load_flax_variables
from tests.torch_parity import random_flax_variables

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

H, W = 128, 256


@pytest.fixture(scope="module")
def pair():
    jbundle = jax_create_model("resnet-18_multi", (H, W), num_classes=8)
    variables = random_flax_variables(jbundle.model, (1, H, W, 3), seed=17, train=False)
    port = create_model("resnet-18_multi", (H, W), device="cpu")
    load_flax_variables(port.model, variables)
    jdet = JaxDetector(jbundle.model, variables, jbundle.anchors, (H, W), mesh=make_mesh(n_data=2))
    one = Detector(port.model, port.anchors, (H, W), device="cpu")
    two = Detector(port.model, port.anchors, (H, W), devices=["cpu", "cpu"])
    return jdet, one, two, port


@pytest.mark.parametrize("B", [1, 3, 4])
def test_devices_match_one_device_and_jax_mesh(pair, B):
    """At B = 1 and 3 (padded to 2 and 4) and 4: the rows come back in
    order with the padding sliced off, bit for bit the one-device
    ``Detector``'s, and against the JAX mesh ``Detector`` the same shapes
    and dtypes with seg equal on >= 0.999 of the pixels
    (``test_predict_raw_matches_jax``'s tolerance)."""
    jdet, one, two, _ = pair
    frames = np.random.RandomState(B).randint(0, 256, (B, H, W, 3), np.uint8)
    got, want = two.predict_raw(frames), one.predict_raw(frames)
    assert set(got) == set(want) == {"det", "seg"}
    for k in want:
        assert got[k].shape[0] == B and torch.equal(got[k], want[k]), k
    jax_res = {k: np.asarray(v) for k, v in jdet.predict_raw(frames).items()}
    for k, v in jax_res.items():
        assert got[k].numpy().shape == v.shape and got[k].numpy().dtype == v.dtype, k
    assert (got["seg"].numpy() == jax_res["seg"]).mean() >= 0.999
    images = frames[..., ::-1].astype(np.float32) - np.float32(MEAN_PIXELS)
    got_f, want_f = two.predict(images), one.predict(images)
    assert all(torch.equal(got_f[k], want_f[k]) for k in want_f)


def test_padding_rows_are_copies_of_the_last(pair):
    """The replicas see the batch padded with copies of its last row: a b3
    batch is served as rows 0-1 and rows 2, 2, whose results agree."""
    _, one, two, _ = pair
    seen = []
    for rep in two._replicas:
        rep.model.register_forward_pre_hook(lambda m, args: seen.append(args[0].clone()))
    try:
        frames = np.random.RandomState(9).randint(0, 256, (3, H, W, 3), np.uint8)
        two.predict_raw(frames)
    finally:
        for rep in two._replicas:
            rep.model._forward_pre_hooks.clear()
    assert [x.shape[0] for x in seen] == [2, 2]
    assert torch.equal(seen[1][0], seen[1][1])
    assert len(two._replicas) == 2 and two._replicas[0].model is two.model
    assert two._replicas[1].model is not two.model


def test_update_weights_reaches_every_replica(pair):
    """``update_weights`` copies new weights into both replicas; the served
    results then equal a fresh one-device Detector's on those weights; the
    solver's ``make_detector`` passes ``devices`` through."""
    from dspnet_torch.train.solver import MultiTaskSolver

    _, _, _, port = pair
    two = Detector(port.model, port.anchors, (H, W), devices=["cpu", "cpu"])
    fresh = create_model("resnet-18_multi", (H, W), device="cpu", generator=torch.Generator().manual_seed(4))
    two.update_weights(fresh.model)
    want_state = fresh.model.state_dict()
    for rep in two._replicas:
        state = rep.model.state_dict()
        assert all(torch.equal(state[k], want_state[k]) for k in want_state)
    frames = np.random.RandomState(2).randint(0, 256, (3, H, W, 3), np.uint8)
    want = Detector(fresh.model, port.anchors, (H, W), device="cpu").predict_raw(frames)
    got = two.predict_raw(frames)
    assert all(torch.equal(got[k], want[k]) for k in want)
    solver = MultiTaskSolver(fresh.model, port.anchors, learning_rate=1e-3, batch_size=2,
                             seg_normalize="valid", device="cpu")
    det = solver.make_detector(solver.init_state(), (H, W), devices=["cpu", "cpu"])
    assert det.devices == [torch.device("cpu")] * 2
    assert all(torch.equal(got[k], det.predict_raw(frames)[k]) for k in got)


def test_devices_argument_checks(pair):
    _, _, _, port = pair
    with pytest.raises(ValueError, match="at least one"):
        Detector(port.model, port.anchors, (H, W), devices=[])
    with pytest.raises(ValueError, match="one type"):
        Detector(port.model, port.anchors, (H, W), devices=["cpu", "meta"])
    one = Detector(port.model, port.anchors, (H, W), device="cpu")
    assert one.devices == [torch.device("cpu")] and one._replicas[0].stream is None


def test_pipeline_over_device_list_on_the_cpu(pair):
    """On the CPU ``ServingPipeline`` runs a device-list Detector eagerly,
    with the one-device results in order."""
    _, one, two, _ = pair
    frames = np.random.RandomState(6).randint(0, 256, (3, H, W, 3), np.uint8)
    pipe = ServingPipeline(two, depth=1)
    out = [pipe.submit(f) for f in frames]
    out = [o for o in out if o is not None] + list(pipe.drain())
    assert [tag for tag, _ in out] == [0, 1, 2]
    for (tag, res), f in zip(out, frames):
        want = one.predict_raw(f[None])
        assert all(np.array_equal(res[k], want[k].numpy()) for k in want)
