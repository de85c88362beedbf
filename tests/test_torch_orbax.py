"""The port's reader of the JAX package's Orbax checkpoints, on the CPU,
against orbax and tensorstore themselves: zstd frames through libzstd
(``utils/zstd.py``), the OCDBT store (``utils/ocdbt.py``) key for key and
byte for byte against tensorstore's own ``ocdbt`` kvstore, the trees
(``utils/orbax_read.py``) leaf for leaf and bit for bit against
``CheckpointManagerWrapper.restore_raw`` and ``load_params_only``, the
committed full-width fixture through ``CheckpointManager`` into a port
state, the refusals, and the JAX CLIs' model dir through the port's
``multi_eval``, ``multi_train --resume`` and ``init_from_checkpoint``.
Every comparison is exact unless its test states a tolerance."""

import ctypes
import hashlib
import json
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes
import orbax.checkpoint as ocp
import tensorstore as ts

from dspnet_tpu.utils.checkpoint import CheckpointManagerWrapper
from dspnet_tpu.utils.checkpoint import save_params_only as jax_save_params_only
from dspnet_torch.utils import ocdbt, orbax_read, zstd
from dspnet_torch.utils.checkpoint import CheckpointManager, load_params_only, state_from_flax

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "jax_orbax"
RECORD = json.loads((FIXTURE / "leaves.json").read_text())
PREFIX = FIXTURE / RECORD["prefix"]


def _flat(tree, path=()):
    """(path, leaf) pairs of a nested dict / list tree, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _flat(v, path + (i,))]
    return [(path, tree)]


def _bits(leaf):
    """A leaf's dtype name, shape and bytes; a torch bfloat16 tensor and an
    ml_dtypes bfloat16 array read alike."""
    if isinstance(leaf, torch.Tensor):
        assert leaf.dtype == torch.bfloat16
        return "bfloat16", tuple(leaf.shape), leaf.view(torch.int16).numpy().tobytes()
    if leaf is None:
        return None
    a = np.asarray(leaf)
    return a.dtype.name, a.shape, np.ascontiguousarray(a).tobytes()


def assert_trees_equal(got, want):
    """The same structure (dict keys, list lengths) and every leaf's dtype,
    shape and bytes."""
    g, w = _flat(got), _flat(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        if isinstance(b, (dict, list)):  # an empty node
            assert a == b, path
            continue
        assert _bits(a) == _bits(b), path


# ------------------------------------------------------------------ zstd

def _compress(data: bytes, with_size: bool = True) -> bytes:
    """One zstd frame made by libzstd's own compressor (the port binds no
    compressor); without ``with_size`` the frame states no content size."""
    lib = zstd.library()
    lib.ZSTD_compressBound.restype, lib.ZSTD_compressBound.argtypes = ctypes.c_size_t, [ctypes.c_size_t]
    bound = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(bound)
    if with_size:
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
        n = lib.ZSTD_compress(out, bound, data, len(data), 3)
    else:  # a streamed frame: ZSTD_compressStream2 with ZSTD_e_end, no pledged size
        lib.ZSTD_createCCtx.restype = ctypes.c_void_p
        lib.ZSTD_compressStream2.restype = ctypes.c_size_t
        lib.ZSTD_compressStream2.argtypes = [ctypes.c_void_p, ctypes.POINTER(zstd._Buffer),
                                             ctypes.POINTER(zstd._Buffer), ctypes.c_int]
        lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
        cctx = lib.ZSTD_createCCtx()
        src = ctypes.create_string_buffer(data, len(data))
        inb = zstd._Buffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        outb = zstd._Buffer(ctypes.cast(out, ctypes.c_void_p), bound, 0)
        assert lib.ZSTD_compressStream2(cctx, ctypes.byref(outb), ctypes.byref(inb), 2) == 0
        lib.ZSTD_freeCCtx(cctx)
        n = outb.pos
    assert not lib.ZSTD_isError(n)
    return out.raw[:n]


def test_zstd_frames():
    """Frames with and without a content size, several frames back to back,
    an empty frame and outputs around the streaming buffer's size decode to
    their content; a truncated or corrupt frame raises."""
    rng = np.random.RandomState(0)
    step = zstd.library().ZSTD_DStreamOutSize()
    pieces = [b"", b"abc" * 1000, rng.bytes(step), rng.bytes(step - 1) + b"x" * (step + 1),
              bytes(rng.randint(0, 4, 3 * step + 17).astype(np.uint8))]
    for p in pieces:
        for with_size in (True, False):
            frame = _compress(p, with_size)
            assert zstd.decompress(frame) == p
    both = _compress(pieces[1]) + _compress(pieces[3], with_size=False) + _compress(pieces[4])
    assert zstd.decompress(both) == pieces[1] + pieces[3] + pieces[4]
    frame = _compress(pieces[4], with_size=False)
    with pytest.raises(zstd.ZstdError, match="ends inside a frame"):
        zstd.decompress(frame[:-10])
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(_compress(pieces[4])[:-10])
    with pytest.raises(zstd.ZstdError, match="no frame magic"):
        zstd.decompress(b"\x00" * 16)
    assert zstd.version().startswith("1.")


def test_missing_libzstd_raises(monkeypatch):
    """Without the library there is no fallback: the error names it and
    every path tried."""
    monkeypatch.setattr(zstd, "_candidates", lambda: ["/nonexistent/libzstd.so.1", "libzstd-missing.so.9"])
    zstd.library.cache_clear()
    try:
        with pytest.raises(OSError, match="libzstd.so.1.*nonexistent/libzstd.so.1.*libzstd-missing.so.9"):
            zstd.decompress(b"\x28\xb5\x2f\xfd")
        with pytest.raises(OSError, match="libzstd"):
            orbax_read.restore_raw(str(PREFIX))
    finally:
        monkeypatch.undo()
        zstd.library.cache_clear()
    assert zstd.library() is not None


# ----------------------------------------------------------------- OCDBT

def _ts_store(path, config=None):
    spec = {"driver": "ocdbt", "base": f"file://{path}"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


@pytest.fixture(scope="module")
def tall_store(tmp_path_factory):
    """A tensorstore OCDBT store with 400-byte nodes and values over 8 bytes
    out of line: 150 keys in 40 commits (so the manifest also refers to
    version-tree nodes), an empty value, a value over 1 MB, a key deleted
    and one overwritten."""
    path = str(tmp_path_factory.mktemp("ocdbt") / "tall")
    kv = _ts_store(path, {"max_decoded_node_bytes": 400, "max_inline_value_bytes": 8})
    rng = np.random.RandomState(1)
    for commit in range(40):
        with ts.Transaction() as txn:
            for i in range(commit * 4, commit * 4 + 4):
                key = f"params.block{i % 9}.conv{i:03d}/" + ("0.0" if i % 3 else ".zarray")
                kv.with_transaction(txn).write(key, rng.bytes(rng.randint(0, 40))).result()
    kv.write("empty", b"").result()
    kv.write("big/0", rng.bytes(1_100_000)).result()
    kv.delete_range(ts.KvStore.KeyRange("params.block0.conv000/", "params.block0.conv000/~")).result()
    kv.write("params.block1.conv001/0.0", b"over written").result()
    return path


def test_ocdbt_equals_tensorstore(tall_store):
    """``list`` and ``read`` equal tensorstore's on a b-tree of height >= 2
    with inline and out-of-line values, an empty one and one over 1 MB."""
    kv = _ts_store(tall_store)
    want = sorted(k.decode() for k in kv.list().result())
    store = ocdbt.OcdbtStore(tall_store)
    assert store.list() == want
    assert len(want) == 161
    for key in want:
        assert store.read(key) == kv.read(key).result().value, key
    assert store.versions[-1].root_height >= 2
    assert len(store.versions) < 42  # the older ones sit behind version-tree nodes
    kinds = {type(v).__name__ for v in store._entries().values()}
    assert kinds == {"bytes", "_Ref"}
    assert store.read("empty") == b"" and len(store.read("big/0")) == 1_100_000
    assert store.read("params.block1.conv001/0.0") == b"over written"
    assert "params.block0.conv000/.zarray" not in store
    with pytest.raises(KeyError, match="not in the OCDBT store"):
        store.read("params.block0.conv000/.zarray")


def test_ocdbt_empty_store(tmp_path):
    """A store whose every key was deleted lists nothing, as tensorstore's."""
    kv = _ts_store(str(tmp_path / "e"))
    kv.write("a/0", b"x" * 100).result()
    kv.delete_range(ts.KvStore.KeyRange()).result()
    assert kv.list().result() == []
    store = ocdbt.OcdbtStore(str(tmp_path / "e"))
    assert store.list() == [] and store.versions[-1].root is None


def test_ocdbt_equals_tensorstore_on_the_fixture():
    """The fixture's two stores (the step's and process 0's, whose values
    the step's b-tree refers to by a relative path) equal tensorstore's."""
    for root in (PREFIX / str(RECORD["epoch"]) / "default", PREFIX / str(RECORD["epoch"]) / "default" / "ocdbt.process_0"):
        kv = _ts_store(str(root))
        want = sorted(k.decode() for k in kv.list().result())
        store = ocdbt.OcdbtStore(str(root))
        assert store.list() == want and len(want) == 2 * len(RECORD["leaves"])
        for key in want:
            assert store.read(key) == kv.read(key).result().value, key


def test_ocdbt_refuses_damaged_files(tall_store, tmp_path):
    """A flipped byte fails the checksum, a truncated node or value file is
    named with its key, a wrong magic and a missing store are reported, and
    a data file outside the store's directory is refused."""
    root = tmp_path / "copy"
    shutil.copytree(tall_store, root)
    store = ocdbt.OcdbtStore(str(root))
    big = store._entries()[b"big/0"]
    data = root / big.path
    data.write_bytes(data.read_bytes()[:big.offset + 1000])
    with pytest.raises(ocdbt.OcdbtError, match=f"{big.path}.*'big/0'.*truncated"):
        ocdbt.OcdbtStore(str(root)).read("big/0")
    manifest = root / "manifest.ocdbt"
    good = manifest.read_bytes()
    manifest.write_bytes(good[:40] + bytes([good[40] ^ 1]) + good[41:])
    with pytest.raises(ocdbt.OcdbtError, match="manifest.ocdbt: CRC-32C mismatch"):
        ocdbt.OcdbtStore(str(root))
    manifest.write_bytes(good[:-3])
    with pytest.raises(ocdbt.OcdbtError, match="truncated"):
        ocdbt.OcdbtStore(str(root))
    manifest.write_bytes(b"\x0c\xdb\x20\xde" + good[4:])
    with pytest.raises(ocdbt.OcdbtError, match="magic"):
        ocdbt.OcdbtStore(str(root))
    root_node = store.versions[-1].root
    manifest.write_bytes(good)
    node = root / root_node.path
    raw = bytearray(node.read_bytes())
    raw[root_node.offset + 20] ^= 0xFF
    node.write_bytes(bytes(raw))
    with pytest.raises(ocdbt.OcdbtError, match=f"{root_node.path} @ {root_node.offset}: CRC-32C"):
        ocdbt.OcdbtStore(str(root)).list()
    with pytest.raises(FileNotFoundError, match="no OCDBT store"):
        ocdbt.OcdbtStore(str(tmp_path / "nothing"))
    # a well-framed manifest whose first data file climbs out of the store
    body = ocdbt.unframe(good, ocdbt.MANIFEST_MAGIC, "manifest")
    at = body.index(b"d/")
    frame = b"\x00\x01" + _compress(body[:at] + b"../" + body[at + 3:])
    head = struct.pack(">I", ocdbt.MANIFEST_MAGIC) + struct.pack("<Q", 12 + len(frame) + 4) + frame
    manifest.write_bytes(head + struct.pack("<I", ocdbt.crc32c(head)))
    with pytest.raises(ocdbt.OcdbtError, match="lies outside the store"):
        ocdbt.OcdbtStore(str(root))


def test_crc32c():
    assert ocdbt.crc32c(b"123456789") == 0xE3069283
    assert ocdbt.crc32c(b"") == 0


# ------------------------------------------------------------- the trees

def test_fixture_equals_orbax_restore_raw():
    """The committed resnet-50_multi 512x1024 checkpoint: the port's
    ``restore_raw`` equals orbax's leaf for leaf, bit for bit, and every
    leaf's sha256 is the one recorded beside it."""
    got, epoch = orbax_read.restore_raw(str(PREFIX))
    mgr = CheckpointManagerWrapper(str(PREFIX))
    want, want_epoch = mgr.restore_raw(None)
    mgr.close()
    assert epoch == want_epoch == RECORD["epoch"] and orbax_read.orbax_epochs(str(PREFIX)) == [epoch]
    assert_trees_equal(got, want)
    leaves = {".".join(map(str, p)): a for p, a in _flat(got)}
    assert len(leaves) == 540 == len(RECORD["leaves"])
    for name, rec in RECORD["leaves"].items():
        a = leaves[name]
        assert [a.dtype.name, list(a.shape)] == [rec["dtype"], rec["shape"]], name
        assert hashlib.sha256(a.tobytes()).hexdigest() == rec["sha256"], name
    assert sum(a.nbytes for a in leaves.values()) / 2**20 == pytest.approx(247.287, abs=1e-3)


def test_fixture_restores_into_a_port_state():
    """``CheckpointManager`` lists the fixture's Orbax epoch and restores it
    into the port's resnet-50_multi 512x1024 state: every tensor equals
    ``state_from_flax`` of orbax's tree, the template's tensors, dtypes and
    ``requires_grad`` stay, the step is the JAX step."""
    from dspnet_torch.api import create_model
    from dspnet_torch.train.solver import MultiTaskSolver

    bundle = create_model(RECORD["network"], tuple(RECORD["data_shape"]), device="cpu")
    template = MultiTaskSolver(bundle.model, bundle.anchors, device="cpu").init_state()
    keep = dict(template.params)
    mgr = CheckpointManager(str(PREFIX))
    assert mgr.epochs() == [RECORD["epoch"]] and mgr.latest_epoch() == RECORD["epoch"]
    state, epoch = mgr.restore(None, template)
    assert epoch == RECORD["epoch"] and state.step == RECORD["step"]
    jmgr = CheckpointManagerWrapper(str(PREFIX))
    want = state_from_flax(jmgr.restore_raw(epoch)[0])
    jmgr.close()
    for g in ("params", "buffers", "momentum"):
        assert set(getattr(state, g)) == set(getattr(want, g))
        for k, t in getattr(state, g).items():
            assert t.dtype == torch.float32 and torch.equal(t.detach(), getattr(want, g)[k].detach()), (g, k)
    assert all(state.params[k] is t and t.requires_grad for k, t in keep.items())
    assert all(float(state.buffers[k].min()) > 0 for k in state.buffers if k.endswith("running_var"))


def test_params_only_mixed_dtypes_equal_orbax(tmp_path):
    """A JAX ``save_params_only`` tree of float32, float16, bfloat16,
    int32, uint8, bool and 0-d leaves reads back as orbax reads it (the
    bfloat16 leaf as a torch tensor of the same bits)."""
    rng = np.random.RandomState(2)
    params = {"f32": rng.normal(size=(3, 5, 7)).astype(np.float32),
              "f16": rng.normal(size=(33,)).astype(np.float16),
              "bf16": rng.normal(size=(4, 6)).astype(ml_dtypes.bfloat16),
              "i32": rng.randint(-9, 9, (2, 3)).astype(np.int32),
              "u8": rng.randint(0, 256, (5, 4)).astype(np.uint8),
              "mask": rng.rand(9) > 0.5,
              "nested": {"scalar": np.float32(2.5), "count": np.int32(7)}}
    stats = {"bn": {"mean": rng.normal(size=(8,)).astype(np.float32)}}
    path = str(tmp_path / "params")
    jax_save_params_only(path, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats))
    got = orbax_read.read_item(path)
    want = ocp.StandardCheckpointer().restore(path)
    want = jax.tree.map(np.asarray, want)
    assert_trees_equal(got, want)
    assert_trees_equal(got, {"params": params, "batch_stats": stats})
    assert isinstance(got["params"]["bf16"], torch.Tensor) and got["params"]["bf16"].dtype == torch.bfloat16


#: name, zarr dtype, shape, chunks, order, fill_value, dimension separator
ZARR_CASES = [("c_order", "<f4", (7, 10), (3, 4), "C", 1.5, "."),
              ("f_order", "<f4", (7, 10), (3, 4), "F", "NaN", "."),
              ("slash", "<i4", (5, 6), (2, 5), "C", -7, "/"),
              ("half", "<f2", (9,), (4,), "C", None, "."),
              ("bf16", "bfloat16", (6, 3), (4, 2), "F", 0.5, "."),
              ("bytes", "|u1", (4, 4, 3), (3, 3, 3), "C", 255, "."),
              ("mask", "|b1", (11,), (4,), "C", True, "."),
              ("wide", "<f4", (3, 5), (2, 2), "F", "-Infinity", "."),
              ("uint", "<u4", (8,), (8,), "C", 0, "."),
              ("scalar", "<i4", (), (), "C", None, ".")]


def test_zarr_layouts_equal_tensorstore(tmp_path):
    """``read_array`` against tensorstore's own zarr v2 reader over an OCDBT
    store: C and F order, several chunks with partial ones at the edges,
    chunks never written (the fill value: a number, NaN, -inf, true, null),
    both dimension separators, every dtype the reader knows (bfloat16 as a
    torch tensor of the same bits) and a 0-d array."""
    base = f"file://{tmp_path / 'item'}"
    ctx = ts.Context()
    rng = np.random.RandomState(5)
    specs = {}
    for name, dtype, shape, chunks, order, fill, sep in ZARR_CASES:
        spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": base}, "path": name,
                "metadata": {"dtype": dtype, "shape": list(shape), "chunks": list(chunks), "order": order,
                             "fill_value": fill, "compressor": {"id": "zstd", "level": 1},
                             "dimension_separator": sep}}
        arr = ts.open(spec, create=True, context=ctx).result()
        region = tuple(slice(0, max(1, (n * 2) // 3)) for n in shape)  # the far chunks stay unwritten
        part = arr[region] if shape else arr
        values = rng.normal(0, 100, part.shape) if dtype[-2] == "f" or dtype == "bfloat16" else \
            rng.randint(0, 2 if dtype == "|b1" else 200, part.shape)
        part.write(values.astype(part.dtype.numpy_dtype)).result()
        specs[name] = spec
    store = ocdbt.OcdbtStore(str(tmp_path / "item"))
    assert any(k.startswith("slash/") and k.count("/") == 2 for k in store.list())
    assert len([k for k in store.list() if k.startswith("c_order/") and not k.endswith(".zarray")]) == 4  # of 9
    for name, *_ in ZARR_CASES:
        want = ts.open(specs[name], context=ctx).result().read().result()
        got = orbax_read.read_array(store, name)
        a, b = _bits(got), _bits(want)
        assert a == b, name
    with pytest.raises(orbax_read.OrbaxError, match="no array 'missing'"):
        orbax_read.read_array(store, "missing")
    spec = dict(specs["uint"], path="double", metadata=dict(specs["uint"]["metadata"], dtype="<f8"))
    ts.open(spec, create=True, context=ctx).result()
    with pytest.raises(orbax_read.OrbaxError, match="dtype '<f8'"):
        orbax_read.read_array(ocdbt.OcdbtStore(str(tmp_path / "item")), "double")


def test_port_params_only_reads_a_jax_directory(tmp_path):
    """``load_params_only`` takes a JAX ``save_params_only`` directory of a
    port model's weights into a module of that architecture, equal to the
    weights; another architecture is refused."""
    from dspnet_torch.api import create_model
    from dspnet_torch.utils.convert import to_flax_variables

    src = create_model("resnet-18_multi", (128, 256), device="cpu", generator=torch.Generator().manual_seed(4)).model
    flax = to_flax_variables(src)
    path = str(tmp_path / "deploy")
    jax_save_params_only(path, jax.tree.map(jnp.asarray, flax["params"]),
                         jax.tree.map(jnp.asarray, flax["batch_stats"]))
    dst = create_model("resnet-18_multi", (128, 256), device="cpu", generator=torch.Generator().manual_seed(5)).model
    assert load_params_only(path, dst) is dst
    for (k, a), (_, b) in zip(src.state_dict().items(), dst.state_dict().items()):
        assert torch.equal(a, b), k
    other = create_model("resnet-18_det", (128, 256), device="cpu").model
    with pytest.raises(RuntimeError):
        load_params_only(path, other)


def test_refusals(tmp_path):
    """``use_zarr3: true`` and a store without OCDBT name ROADMAP Queue C;
    an epoch present both as ``.pt`` and as an Orbax step names both; a
    missing epoch and a directory that is no checkpoint raise."""
    prefix = tmp_path / PREFIX.name
    shutil.copytree(PREFIX, prefix)
    epoch = RECORD["epoch"]
    meta_path = prefix / str(epoch) / "default" / "_METADATA"
    meta = json.loads(meta_path.read_text())
    for key in ("use_zarr3", "use_ocdbt"):
        bad = dict(meta, **{key: key == "use_zarr3"})
        meta_path.write_text(json.dumps(bad))
        with pytest.raises(orbax_read.OrbaxError, match=f"{key} .*ROADMAP Queue C"):
            orbax_read.restore_raw(str(prefix))
    meta_path.write_text(json.dumps(meta))
    mgr = CheckpointManager(str(prefix))
    torch.save({"params": {}, "buffers": {}, "momentum": {}, "step": 0}, mgr.path(epoch))
    assert mgr.epochs() == [epoch]
    with pytest.raises(ValueError, match=f"epoch {epoch} exists twice.*{epoch:04d}.pt.*Orbax step .*/{epoch}"):
        mgr.read(epoch)
    with pytest.raises(FileNotFoundError, match="no checkpoint for epoch 9"):
        mgr.read(9)
    with pytest.raises(FileNotFoundError, match="not an Orbax checkpoint item"):
        orbax_read.read_item(str(tmp_path))
    (prefix / f"{epoch + 1}.orbax-checkpoint-tmp-17").mkdir()  # an unfinished save
    assert orbax_read.orbax_epochs(str(prefix)) == [epoch]
