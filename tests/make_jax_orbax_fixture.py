"""Write the committed JAX checkpoint fixture under
``tests/fixtures/jax_orbax/``: a resnet-50_multi 512x1024 training state
(params, batch stats, the MXNet-SGD momentum and count, the step; 540
leaves, 247.3 MiB) saved as epoch 3 by the JAX package's own
``CheckpointManagerWrapper.save``, and beside it ``leaves.json``, each
leaf's shape, dtype and sha256 as the JAX package's ``restore_raw`` reads
them back.

    JAX_PLATFORMS=cpu python tests/make_jax_orbax_fixture.py

Every leaf follows a short periodic pattern, so the checkpoint stays small
(zstd finds the period): leaf ``i`` (in sorted path order) is
``((arange(n) * 7 + i) % 251 - 125) * 2**-10``, times a further 2**-8 in
the momentum (an SGD trace is far smaller than the weights, and a resumed
run's first steps stay where a trained one's would); the running variances
are ``((arange(n) * 7 + i) % 251 + 1) * 2**-8`` (positive). A few momentum
leaves, at least 256 KiB in all, hold seeded normal values instead, so
that zstd's Huffman-coded literals are read as well as its matches. The
shapes come from ``jax.eval_shape`` of the solver's init (no weights are
computed); the script checks that the JAX forward on the written weights
is finite at 128x256.

The fixture's path holds no directory named ``model`` or ``log``: both are
listed in ``.gitignore``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "jax_orbax"
NETWORK, HW, EPOCH, STEP = "resnet-50_multi", (512, 1024), 3, 1234
RANDOM_BYTES = 256 * 1024


def leaf_name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)


def pattern(n: int, i: int, positive: bool) -> np.ndarray:
    r = (np.arange(n, dtype=np.int64) * 7 + i) % 251
    return ((r + 1) * 2.0 ** -8 if positive else (r - 125) * 2.0 ** -10).astype(np.float32)


def build_state():
    import jax
    import jax.numpy as jnp

    from dspnet_tpu.api import create_model
    from dspnet_tpu.train.solver import MultiTaskSolver

    bundle = create_model(NETWORK, HW)
    solver = MultiTaskSolver(bundle.model, bundle.anchors)
    shapes = jax.eval_shape(lambda: solver.init_state(jax.random.PRNGKey(0), jnp.zeros((1, 128, 256, 3))))
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    order = sorted(range(len(flat)), key=lambda j: leaf_name(flat[j][0]))
    rng = np.random.RandomState(12)
    values, n_random = [None] * len(flat), 0
    for i, j in enumerate(order):
        path, s = flat[j]
        name = leaf_name(path)
        n = int(np.prod(s.shape))
        if s.dtype == np.int32:  # the step and the optimizer's count
            v = np.full(s.shape, STEP, np.int32)
        elif (name.startswith("opt_state.") and n_random < RANDOM_BYTES
              and 16 * 1024 <= 4 * n <= 64 * 1024):
            v = rng.normal(0, 1e-3, s.shape).astype(np.float32)
            n_random += v.nbytes
        else:
            v = pattern(n, i, positive=name.startswith("batch_stats.") and name.endswith(".var")).reshape(s.shape)
            if name.startswith("opt_state.momentum."):
                v *= np.float32(2.0 ** -8)
        values[j] = jnp.asarray(v)
    assert n_random >= RANDOM_BYTES, n_random
    return bundle, solver, jax.tree_util.tree_unflatten(treedef, values)


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import jax
    import jax.numpy as jnp

    from dspnet_tpu.utils.checkpoint import CheckpointManagerWrapper, checkpoint_prefix

    bundle, solver, state = build_state()
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    out = bundle.model.apply(variables, jnp.asarray(np.random.RandomState(0).normal(0, 50, (1, 128, 256, 3)),
                                                    jnp.float32), train=False)
    assert all(bool(jnp.isfinite(v).all()) for v in jax.tree.leaves(out)), "the forward is not finite"

    shutil.rmtree(FIXTURE / "models", ignore_errors=True)
    prefix = checkpoint_prefix(str(FIXTURE / "models"), NETWORK, HW[0])
    mgr = CheckpointManagerWrapper(prefix)
    mgr.save(EPOCH, state)
    tree, epoch = mgr.restore_raw(EPOCH)
    mgr.close()
    assert epoch == EPOCH
    leaves = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        a = np.asarray(leaf)
        leaves[leaf_name(path)] = {"shape": list(a.shape), "dtype": a.dtype.name,
                                   "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()}
    record = {"network": NETWORK, "data_shape": list(HW), "epoch": EPOCH, "step": STEP,
              "prefix": os.path.relpath(prefix, FIXTURE), "leaves": dict(sorted(leaves.items()))}
    (FIXTURE / "leaves.json").write_text(json.dumps(record, indent=1) + "\n")
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    print(f"{len(leaves)} leaves, {sum(np.prod(v['shape']) * 4 for v in leaves.values()) / 2**20:.1f} MiB "
          f"of values; the fixture takes {size} bytes")


if __name__ == "__main__":
    main()
