"""Read the JAX package's Orbax checkpoints without JAX, Orbax or
tensorstore (counterpart of ``CheckpointManagerWrapper.restore_raw``,
``dspnet_tpu/utils/checkpoint.py:134-168``, and of its
``save_params_only`` directories).

A JAX checkpoint prefix (``checkpoint_prefix``, ``{dir}/multitask_{net}_
{height}``) holds one step directory per epoch, named by the plain integer
(``3``, not ``0003``); orbax writes it under a temporary name
(``3.orbax-checkpoint-tmp-<n>``) and renames it when the save commits. A
step directory holds the item ``default/``; ``save_params_only`` writes the
item's files straight into its directory. An item is

* ``_METADATA``: JSON; ``tree_metadata`` maps each leaf's path to its keys
  (``key_type`` 2 a dict key, 1 a sequence index) and its value type;
  ``use_ocdbt`` and ``use_zarr3`` say how the values are stored;
* an OCDBT store (``utils/ocdbt.py``) holding one zarr v2 array per leaf,
  named by the leaf's keys joined with ``.``: ``<name>/.zarray`` (JSON:
  shape, chunks, dtype, order, fill_value, the zstd compressor) and the
  chunks ``<name>/<i>.<j>...`` (``<name>/0`` for a 0-d leaf), each one zstd
  frame; an absent chunk holds the fill value.

:func:`restore_raw` returns the nested dict of numpy arrays the JAX call
returns: the same keys, shapes, dtypes and bytes (a sequence node as a
list, an empty dict as ``{}``, ``None`` as ``None``; another value orbax
did not store raises). numpy has no bfloat16: a bfloat16 leaf comes back
as a ``torch.bfloat16`` tensor with the same bits. zarr v3 (``use_zarr3``) and checkpoints without OCDBT are
refused: the JAX package writes neither (ROADMAP Queue C).
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dspnet_torch.utils import zstd
from dspnet_torch.utils.ocdbt import OcdbtStore

_STEP = re.compile(r"^\d+$")
ITEM = "default"  # the item name CheckpointManagerWrapper saves under

#: the zarr v2 dtypes this reader knows (tensorstore's names): those the
#: JAX package's trees hold
DTYPES = ("<f4", "<f2", "bfloat16", "<i4", "<u4", "|u1", "|b1")


class OrbaxError(ValueError):
    """A checkpoint this reader refuses or cannot make sense of."""


def orbax_epochs(prefix: str) -> List[int]:
    """The committed epochs under a JAX checkpoint prefix: the integer step
    directories (``*.orbax-checkpoint-tmp-*``, an unfinished save, is not
    one)."""
    if not os.path.isdir(prefix):
        return []
    return sorted(int(n) for n in os.listdir(prefix)
                  if _STEP.match(n) and os.path.isdir(os.path.join(prefix, n)))


def step_dir(prefix: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(prefix), str(int(epoch)))


def restore_raw(prefix: str, epoch: Optional[int] = None) -> Tuple[Dict[str, Any], int]:
    """``(tree, epoch)`` of epoch ``epoch`` (the latest when None) under the
    JAX checkpoint prefix ``prefix``."""
    if epoch is None:
        epochs = orbax_epochs(prefix)
        if not epochs:
            raise FileNotFoundError(f"no Orbax checkpoints under {prefix}")
        epoch = epochs[-1]
    path = step_dir(prefix, epoch)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no Orbax checkpoint for epoch {epoch}: {path} does not exist")
    return read_item(os.path.join(path, ITEM)), int(epoch)


def read_item(path: str) -> Dict[str, Any]:
    """The tree stored in the Orbax item directory ``path``."""
    meta_path = os.path.join(path, "_METADATA")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(f"{path} is not an Orbax checkpoint item: {meta_path} is missing") from None
    if meta.get("use_zarr3"):
        raise OrbaxError(f"{meta_path}: use_zarr3 is true; this reader reads zarr v2 only, the format the "
                         "JAX package writes (ROADMAP Queue C)")
    if not meta.get("use_ocdbt", False):
        raise OrbaxError(f"{meta_path}: use_ocdbt is not true; this reader reads OCDBT checkpoints only, "
                         "the format the JAX package writes (ROADMAP Queue C)")
    store = OcdbtStore(path)
    flat = []
    for entry_key, entry in meta["tree_metadata"].items():
        keys = [(k["key"], int(k["key_type"])) for k in entry["key_metadata"]]
        if any(t not in (1, 2) for _, t in keys):
            raise OrbaxError(f"{meta_path}: {entry_key}: key types {[t for _, t in keys]}; 1 and 2 are known")
        value = entry["value_metadata"]
        if value.get("skip_deserialize"):
            empty = {"Dict": dict, "None": lambda: None}.get(value.get("value_type"))
            if empty is None:
                raise OrbaxError(f"{meta_path}: {entry_key}: a {value.get('value_type')!r} leaf not stored")
            flat.append((keys, empty()))
        else:
            flat.append((keys, read_array(store, ".".join(str(k) for k, _ in keys))))
    return _nest(flat)


def _nest(flat: List[Tuple[List[Tuple[str, int]], Any]]) -> Dict[str, Any]:
    """Nested dicts from (keys, leaf) pairs; a node whose keys are sequence
    indices becomes a list, in index order."""
    root: Dict[Any, Any] = {}
    seqs = set()
    for keys, leaf in flat:
        node = root
        for depth, (k, t) in enumerate(keys):
            key = int(k) if t == 1 else k
            if t == 1:
                seqs.add(id(node))
            if depth == len(keys) - 1:
                node[key] = leaf
            else:
                node = node.setdefault(key, {})

    def fix(node):
        if not isinstance(node, dict):
            return node
        if id(node) in seqs:
            if sorted(node) != list(range(len(node))):
                raise OrbaxError(f"sequence indices {sorted(node)} are not 0..{len(node) - 1}")
            return [fix(node[i]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _fill(value, dtype: np.dtype, bf16: bool):
    if value is None:
        return 0
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        value = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}[value]
    if bf16:
        import torch

        return int(torch.tensor(float(value), dtype=torch.bfloat16).view(torch.int16).item()) & 0xFFFF
    return np.array(value).astype(dtype)


def read_array(store: OcdbtStore, name: str):
    """The zarr v2 array ``name`` in ``store`` as a numpy array (a bfloat16
    one as a ``torch.bfloat16`` tensor)."""
    zkey = f"{name}/.zarray"
    try:
        meta = json.loads(store.read(zkey))
    except KeyError:
        raise OrbaxError(f"{store.root}: no array {name!r} ({zkey} is not in the store)") from None
    where = f"{store.root}: {zkey}"
    if meta.get("zarr_format") != 2:
        raise OrbaxError(f"{where}: zarr_format {meta.get('zarr_format')}, only 2 is read")
    if meta.get("filters"):
        raise OrbaxError(f"{where}: filters {meta['filters']} are not supported")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxError(f"{where}: compressor {compressor}; only zstd (or none) is read")
    if meta["dtype"] not in DTYPES:
        raise OrbaxError(f"{where}: dtype {meta['dtype']!r}; known: {', '.join(DTYPES)}")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype("<u2" if bf16 else meta["dtype"])
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise OrbaxError(f"{where}: order {order!r}")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise OrbaxError(f"{where}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    out = np.full(shape, _fill(meta.get("fill_value"), dtype, bf16), dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks)) * dtype.itemsize
    for idx in np.ndindex(*grid):
        key = f"{name}/" + (sep.join(map(str, idx)) if shape else "0")
        if key not in store:
            continue  # never written: the fill value
        raw = store.read(key)
        if compressor is not None:
            raw = zstd.decompress(raw)
        if len(raw) != chunk_bytes:
            raise OrbaxError(f"{store.root}: chunk {key} holds {len(raw)} bytes, {chunk_bytes} expected")
        chunk = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if bf16:
        import torch

        return torch.from_numpy(out.view(np.int16).copy()).view(torch.bfloat16)
    return out.astype(dtype.newbyteorder("="), copy=False)
