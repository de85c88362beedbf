"""Data parallelism in the PyTorch port on the CPU: gloo ranks in processes
of their own against the JAX solver and against one port process, on the
same weights and global batches.

* two ranks of ``MultiTaskSolver`` over 2 steps reproduce the JAX
  ``MultiTaskSolver``'s steps on the global batch (the global program a JAX
  step over a sharded batch is; ``tests/test_distributed.py`` holds the JAX
  package's own data parallelism to it) at the tolerances of
  ``torch_parity.assert_steps_match_jax``, and one port process's steps to
  a bound 4 times tighter; the ranks' states equal each other bit for bit.
  Once with unequal positives per rank, once with a rank that holds no
  ground truth at all (its local counts are 0), where per-rank normalisers
  or averaged gradients would differ from the global step; ``remat`` ranks
  equal the plain ranks bit for bit;
* ``shard_positions`` covers each rank's ``rank::world`` slice, as the JAX
  one, and two sharded ``DeviceAugIterator`` s give the one-process batches
  row for row;
* ``multi_train --device cpu --num-devices 2`` (two gloo ranks started by
  the CLI through ``--coordinator``, ``--num-processes`` and
  ``--process-id``) against the JAX solver on the CLI's own weights and
  batches, and against ``multi_train`` in one process;
* ``--num-devices 0`` on a host with several cards, the backend rule and
  the refusals.

Every multi-process run has a timeout of its own (the processes' and the
process group's)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dspnet_tpu.api import create_model as jax_create_model
from dspnet_tpu.data.iterator import shard_positions as jax_shard_positions
from dspnet_tpu.train.solver import MultiTaskSolver as JaxSolver
from dspnet_torch.api import create_model
from dspnet_torch.cli import multi_train
from dspnet_torch.data import synthetic
from dspnet_torch.data.device_pipeline import DeviceAugIterator
from dspnet_torch.data.iterator import shard_positions
from dspnet_torch.models.layers import BatchNorm
from dspnet_torch.parallel import dist as pdist
from dspnet_torch.train.solver import MultiTaskSolver
from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix
from dspnet_torch.utils.convert import load_flax_variables, to_flax_variables
from tests.torch_parity import assert_steps_match_jax, jax_solver_state, random_flax_variables

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 128, 256
GLOBAL_B = 4
LR = 1e-3
TIMEOUT_S = 240  # each multi-process run; the process group's collectives time out at 120 s
#: two ranks against one port process: each tensor's change within this
#: share of the largest change of its kind over the model. The ranks only
#: change the order of the sums, yet on these weights two steps amplify
#: that: one process's own steps move by 2.9e-3 and 4.6e-3 of the largest
#: change when only the order of a batch's rows changes. A wiring fault (a
#: dropped or doubled shard, a mean for a sum, a local normaliser) moves
#: the changes by their own size.
PORT_SHARE = 1e-2


def _global_batches(case):
    """Two global batches of ``GLOBAL_B`` rows; rank r of 2 takes rows
    [2r, 2r + 2). 'uneven': rank 0's rows hold 3 and 2 GTs, rank 1's 1 and
    1. 'empty': rank 1's rows hold no GT (no positive, no valid anchor) and
    more ignored seg pixels."""
    out = []
    for step in range(2):
        rng = np.random.RandomState(10 * step + (case == "empty"))
        labels = np.full((GLOBAL_B, 16, 6), -1.0, np.float32)
        n_gt = (3, 2, 1, 1) if case == "uneven" else (3, 2, 0, 0)
        for i, n in enumerate(n_gt):
            for j in range(n):
                x0, y0 = rng.uniform(0.0, 0.6, 2)
                w, h = rng.uniform(0.1, 0.4, 2)
                labels[i, j] = [rng.randint(0, 8), x0, y0, x0 + w, y0 + h, rng.uniform(0, 1)]
        seg = rng.randint(0, 19, (GLOBAL_B, H // 4, W // 4)).astype(np.int32)
        seg[:, :2] = 255
        if case == "empty":
            seg[2:, :12] = 255
        images = (rng.randn(GLOBAL_B, H, W, 3) * 50).astype(np.float32)
        out.append({"images": images, "label_det": labels, "seg_label": seg})
    return out


def _run_steps(case, init, rank=0, world=1, remat=False):
    """Two solver steps from the weights saved at ``init`` on this rank's
    rows: (state, [metrics per step], each BatchNorm's running_updates)."""
    bundle = create_model("resnet-18_multi", (H, W), device="cpu", remat=remat)
    bundle.model.load_state_dict(torch.load(init, weights_only=True))
    bns = [m for m in bundle.model.modules() if isinstance(m, BatchNorm)]
    solver = MultiTaskSolver(bundle.model, bundle.anchors, learning_rate=LR, batch_size=GLOBAL_B,
                             seg_normalize="valid", device="cpu")
    st = solver.init_state()
    local = GLOBAL_B // world
    history = []
    for batch in _global_batches(case):
        rows = {k: v[rank * local:(rank + 1) * local] for k, v in batch.items()}
        st, m = solver.train_step(st, rows)
        history.append({k: float(v) for k, v in m.items()})
    return st, history, [m.running_updates for m in bns]


def rank_main(rank, world, port, out_dir):
    """One rank of the multi-process solver test (run in a process of its
    own): both cases, and 'uneven' with ``remat``, each rank's states,
    metrics and BatchNorm update counts saved under out_dir."""
    torch.set_num_threads(1)
    info = pdist.distributed_init(f"127.0.0.1:{port}", world, rank, "cpu", timeout_s=120)
    assert info.backend == "gloo" and info.world == world
    try:
        for name, case, remat in (("uneven", "uneven", False), ("empty", "empty", False), ("remat", "uneven", True)):
            st, history, updates = _run_steps(case, os.path.join(out_dir, "init.pt"), rank, world, remat)
            torch.save({"params": st.params, "buffers": st.buffers, "momentum": st.momentum, "metrics": history,
                        "updates": updates}, os.path.join(out_dir, f"{name}_rank{rank}.pt"))
    finally:
        pdist.destroy()


def _spawn_ranks(world, out_dir):
    port = pdist.free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
    code = "import sys; from tests.test_torch_dist import rank_main; rank_main(*map(int, sys.argv[1:4]), sys.argv[4])"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(port), str(out_dir)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), [o[-3000:] for o in outs]


@pytest.fixture(scope="module")
def reference():
    """resnet-18_multi in the JAX package and seeded numpy weights for it."""
    bundle = jax_create_model("resnet-18_multi", (H, W))
    return bundle, random_flax_variables(bundle.model, (1, H, W, 3), seed=8, train=False)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, reference):
    out = tmp_path_factory.mktemp("dist_steps")
    port = create_model("resnet-18_multi", (H, W), device="cpu")
    load_flax_variables(port.model, reference[1])
    torch.save(port.model.state_dict(), out / "init.pt")
    _spawn_ranks(2, out)
    return out


def _assert_changes_close(got, want, init, share, what):
    """Each tensor's change from ``init`` within ``share`` of the largest
    change of its kind (parameters, running means, running variances,
    momentum) over the model: a bound on the step, not on the weights."""
    for part in got:
        assert got[part].keys() == want[part].keys() == init[part].keys(), part
        d_want = {k: (want[part][k] - init[part][k]).detach().double() for k in want[part]}
        kind = (lambda k: k.rsplit(".", 1)[-1]) if part == "buffers" else (lambda k: part)
        biggest = {}
        for k, d in d_want.items():
            biggest[kind(k)] = max(biggest.get(kind(k), 0.0), float(d.abs().max()))
        assert all(b > 0 for b in biggest.values()), (part, biggest)
        for k, d in d_want.items():
            np.testing.assert_allclose((got[part][k] - init[part][k]).detach().double().numpy(), d.numpy(), rtol=0,
                                       atol=share * biggest[kind(k)], err_msg=f"{what} {part} {k}")


@pytest.mark.parametrize("case", ["uneven", "empty"])
def test_two_ranks_match_one_process(reference, two_ranks, case):
    """Two gloo ranks on 2 rows each against the JAX solver on the 4 rows,
    over 2 steps, at ``assert_steps_match_jax``'s tolerances (the metrics,
    the global batch's, summed over the ranks; each parameter's change;
    the running statistics), and against one port process on the 4 rows
    within ``PORT_SHARE`` (parameters, running means and variances,
    momentum) and
    the metrics within rtol 1e-5 (the seg accuracy within one pixel); the
    two ranks' states equal bit for bit.
    In 'empty' rank 1 holds no ground truth: its local valid-anchor count
    is 0, so a local normaliser (or a mean of the ranks' gradients) would
    halve or drop terms the global step keeps."""
    bundle, variables = reference
    ranks = [torch.load(two_ranks / f"{case}_rank{r}.pt", weights_only=True) for r in range(2)]
    parts = ("params", "buffers", "momentum")
    for part in parts:
        for k in ranks[0][part]:
            assert torch.equal(ranks[0][part][k], ranks[1][part][k]), (part, k)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]

    js = JaxSolver(bundle.model, bundle.anchors, learning_rate=LR, batch_size=GLOBAL_B, seg_normalize="valid")
    jst, want_m = jax_solver_state(js, variables, (H, W)), []
    for batch in _global_batches(case):
        jst, m = js.train_step(jst, batch)
        want_m.append(m)
    assert_steps_match_jax(variables["params"], jst, want_m,
                           to_flax_variables({**ranks[0]["params"], **ranks[0]["buffers"]}), ranks[0]["metrics"])

    st, history, _ = _run_steps(case, two_ranks / "init.pt")
    init = {"params": {}, "buffers": {}, "momentum": {k: torch.zeros_like(v) for k, v in st.momentum.items()}}
    for k, v in torch.load(two_ranks / "init.pt", weights_only=True).items():
        (init["buffers"] if k in st.buffers else init["params"])[k] = v
    _assert_changes_close({p: ranks[0][p] for p in parts}, {p: getattr(st, p) for p in parts}, init, PORT_SHARE,
                          case)
    for got_m, want_m, batch in zip(ranks[0]["metrics"], history, _global_batches(case)):
        assert got_m.keys() == want_m.keys()
        for k in want_m:
            # the accuracy counts argmax hits: one pixel may flip
            atol = 1.0 / (batch["seg_label"] != 255).sum() if k == "seg_accuracy" else 0.0
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-5, atol=atol, err_msg=(case, k))
    if case == "empty":
        assert all((b["label_det"][2:, :, 0] < 0).all() for b in _global_batches(case))
        assert history[0]["valid_anchors"] > 0


def test_two_ranks_remat_equal_plain_bit_for_bit(two_ranks):
    """Two ranks with every residual unit rematerialised equal the two
    plain ranks bit for bit (parameters, running statistics, momentum,
    metrics): the recompute reuses the first pass's summed BatchNorm
    statistics, runs no collective out of order, and sends the gradient
    back through the same sum; each BatchNorm moved its running statistics
    once a step."""
    for r in range(2):
        plain, remat = (torch.load(two_ranks / f"{c}_rank{r}.pt", weights_only=True) for c in ("uneven", "remat"))
        for part in ("params", "buffers", "momentum"):
            for k in plain[part]:
                assert torch.equal(remat[part][k], plain[part][k]), (r, part, k)
        assert remat["metrics"] == plain["metrics"]
        assert remat["updates"] == plain["updates"] == [2] * len(plain["updates"])


# ------------------------------------------------------------- input sharding


@pytest.mark.parametrize("n,world", [(8, 1), (8, 2), (9, 2), (10, 3), (7, 4), (3, 4)])
def test_shard_positions_cover_each_rank_slice(n, world):
    """Every rank owns ``rank::world`` of the epoch truncated to n // world
    positions (equal counts, so no rank waits in a collective for a step
    the others never run), no position twice, as the JAX function."""
    parts = [shard_positions(n, (r, world)) for r in range(world)]
    for r, p in enumerate(parts):
        np.testing.assert_array_equal(p, jax_shard_positions(n, (r, world)))
        np.testing.assert_array_equal(p, np.arange(n)[r::world][: n // world])
        assert len(p) == n // world
    allpos = np.concatenate(parts)
    assert len(set(allpos.tolist())) == len(allpos) == (n // world) * world
    with pytest.raises(ValueError):
        shard_positions(n, (world, world))


def test_sharded_iterators_give_the_global_batches(tmp_path):
    """Two ``DeviceAugIterator`` s with shard (0, 2) and (1, 2) at batch 1
    give, step for step, the rows of one iterator at batch 2: the same
    images, labels and masks bit for bit (the same shuffle and augmentation
    table, indexed by epoch position)."""
    index = synthetic.build_dataset(str(tmp_path / "s"), num_samples=5, hw=(H, W), seed=233)
    kw = dict(device="cpu", seed=233, enable_aug=True, num_threads=1)
    one = list(DeviceAugIterator(index, 2, (H, W), **kw))
    ranks = [list(DeviceAugIterator(index, 1, (H, W), shard=(r, 2), **kw)) for r in range(2)]
    assert len(one) == len(ranks[0]) == len(ranks[1]) == 2
    for step, batch in enumerate(one):
        for k, v in batch.items():
            assert torch.equal(v, torch.cat([ranks[0][step][k], ranks[1][step][k]])), (step, k)


# ------------------------------------------------------------- the CLI


def test_multi_train_num_devices_2_matches_one_process(reference, tmp_path, monkeypatch):
    """``multi_train --device cpu --num-devices 2`` starts a second gloo rank
    (``--coordinator``, ``--num-processes``, ``--process-id``) and trains 2
    epochs of the global b4 batches (``tests/test_distributed.py``'s run: 4
    images, one step an epoch). Its checkpoint (rank 0's) and per-epoch
    metrics are held against the JAX solver from the CLI's own seeded
    weights on the CLI's batches (a one-process ``DeviceAugIterator``'s, at
    ``assert_steps_match_jax``'s tolerances; the first batch holds a seg
    near-tie, so the accuracy may differ by one pixel, and the running
    statistics start fresh, so their changes are held), and against
    ``multi_train`` in one process (each change within 4% of the largest of
    its kind, the first loss within rtol 1e-5, the validation pass, rank
    0's, within ``tests/test_distributed.py``'s tolerance)."""
    monkeypatch.chdir(tmp_path)  # the CLIs log under ./log
    net = ["--network", "resnet-18_multi", "--data-shape", f"3,{H},{W}", "--batch-size", "4", "--device", "cpu",
           "--synthetic", "4", "--synthetic-dir", str(tmp_path / "synth"), "--end-epoch", "2",
           "--seg-normalize", "valid", "--lr", str(LR), "--eval-every", "2", "--log-every", "1",
           "--loader-threads", "1"]
    one = multi_train.main(net + ["--model-dir", str(tmp_path / "m1"), "--metrics-jsonl", str(tmp_path / "one.jsonl")])
    two = multi_train.main(net + ["--model-dir", str(tmp_path / "m2"), "--num-devices", "2",
                                  "--metrics-jsonl", str(tmp_path / "two.jsonl")])
    assert not pdist.active()  # the CLI's rank 0 left the process group
    assert one.step == two.step == 2
    ckpts = [torch.load(CheckpointManager(checkpoint_prefix(str(tmp_path / m), "resnet-18_multi", H)).path(1),
                        weights_only=True) for m in ("m1", "m2")]
    rows = [[json.loads(line) for line in open(tmp_path / f)] for f in ("one.jsonl", "two.jsonl")]
    assert [(r["epoch"], r["split"]) for r in rows[1]] == [(0, "train"), (1, "train"), (1, "val")]

    # the JAX solver from the CLI's weights, on the CLI's two global batches
    init = create_model("resnet-18_multi", (H, W), device="cpu",
                        generator=torch.Generator().manual_seed(multi_train.SEED)).model
    variables = to_flax_variables(init)
    index = multi_train.resolve_dataset(multi_train.parse_args(net), "train")
    it = DeviceAugIterator(index, 4, (H, W), device="cpu", seed=multi_train.SEED, enable_aug=True, num_threads=1)
    batches = [b for _ in range(2) for b in it]
    assert len(batches) == 2
    bundle = reference[0]
    js = JaxSolver(bundle.model, bundle.anchors, learning_rate=LR, batch_size=4, seg_normalize="valid")
    jst, want_m = jax_solver_state(js, variables, (H, W)), []
    for batch in batches:
        jst, m = js.train_step(jst, {k: v.numpy() for k, v in batch.items()})
        want_m.append(m)
    got_m = [{k: v for k, v in r.items() if k not in ("epoch", "split", "time")} for r in rows[1][:2]]
    assert_steps_match_jax(variables["params"], jst, want_m,
                           to_flax_variables({**ckpts[1]["params"], **ckpts[1]["buffers"]}), got_m,
                           valid_px=[int((b["seg_label"] != 255).sum()) for b in batches],
                           init_stats=variables["batch_stats"])

    start = {"params": {}, "buffers": {}, "momentum": {k: torch.zeros_like(v) for k, v in ckpts[0]["momentum"].items()}}
    for k, v in init.state_dict().items():
        (start["buffers"] if k in ckpts[0]["buffers"] else start["params"])[k] = v
    parts = ("params", "buffers", "momentum")
    # from the CLI's weights one process's own step moves 1.6% of the largest change when only the order
    # of a batch's rows changes (a near-tie that the sums' order decides), so the JAX comparison's 4% holds here
    _assert_changes_close({p: ckpts[1][p] for p in parts}, {p: ckpts[0][p] for p in parts}, start, 0.04,
                          "num-devices 2")
    np.testing.assert_allclose(rows[1][0]["loss"], rows[0][0]["loss"], rtol=1e-5)
    for k in ("mIoU", "accuracy"):
        np.testing.assert_allclose(rows[1][2][k], rows[0][2][k], rtol=5e-2, atol=5e-3)


def test_num_devices_0_on_several_cards(tmp_path, monkeypatch):
    """``--num-devices 0`` on a host with two cards: the ``device`` loader
    starts one rank per card; ``--loader det``, which does not shard, runs
    in one process, as the JAX CLI runs it in one; an explicit
    ``--num-devices 2`` with ``--loader det`` is refused before any rank
    starts."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(multi_train, "resolve_device", lambda d: torch.device("cuda"))
    runs = []
    monkeypatch.setattr(multi_train, "_train", lambda args, device, log, info: runs.append(("train", info)))
    monkeypatch.setattr(multi_train, "_launch_local_ranks", lambda argv, world, log: runs.append(("launch", world)))
    net = ["--network", "resnet-18", "--data-shape", "3,96,96", "--model-dir", str(tmp_path / "m"),
           "--synthetic", "2", "--synthetic-dir", str(tmp_path / "s")]
    multi_train.main(net + ["--loader", "det"])
    multi_train.main(net)
    assert runs == [("train", None), ("launch", 2)]
    with pytest.raises(ValueError, match="does not shard"):
        multi_train.main(net + ["--loader", "det", "--num-devices", "2"])
    assert len(runs) == 2


def test_backend_rule_and_refusals(tmp_path):
    """gloo on the CPU and where more local ranks than cards share a host,
    NCCL with a card per rank; ``--num-devices`` against ``--num-processes``,
    a bad rank, a global batch that does not divide by the world and
    ``--loader det`` across ranks are refused before any collective."""
    assert pdist.choose_backend(torch.device("cpu"), 4) == "gloo"
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert pdist.choose_backend(torch.device("cuda", 0), n) == "nccl"
        assert pdist.choose_backend(torch.device("cuda", 0), n + 1) == "gloo"
    net = ["--network", "resnet-18_multi", "--data-shape", f"3,{H},{W}", "--device", "cpu", "--synthetic", "2",
           "--synthetic-dir", str(tmp_path / "s"), "--model-dir", str(tmp_path / "m")]
    with pytest.raises(ValueError, match="--num-devices 3 with --coordinator"):
        multi_train.main(net + ["--coordinator", "127.0.0.1:1", "--num-processes", "2", "--num-devices", "3"])
    with pytest.raises(ValueError, match="outside"):
        pdist.distributed_init("127.0.0.1:1", 2, 2, "cpu")
    info = pdist.DistInfo(0, 2, 0, torch.device("cpu"), "gloo")  # rank 0 of 2, no process group needed
    log = multi_train.setup_logging(log_dir=str(tmp_path / "log"))
    for extra, match in ((["--batch-size", "3"], "global batch"),
                         (["--batch-size", "2", "--loader", "det", "--network", "resnet-18"], "does not shard")):
        with pytest.raises(ValueError, match=match):
            multi_train._train(multi_train.parse_args(net + extra), torch.device("cpu"), log, info)
    assert not pdist.active()
