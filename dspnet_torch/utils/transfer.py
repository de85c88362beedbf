"""Transfer / fine-tune initialisation (counterpart of
``dspnet_tpu/utils/transfer.py``; reference multi_init.py:50-169): start a
model from another checkpoint's subtree, every other leaf left at its fresh
initialisation.

The trees are the flax-layout nested dicts of numpy arrays that
``utils/convert.py::to_flax_variables`` makes of a port module or state
(``{"params": ..., "batch_stats": ...}``), so a subtree is named as in the
JAX package (``backbone``, ``multibox``, ``seg``, ``multi_feat``) and the
merge is the JAX package's, leaf for leaf.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Optional

import torch

from dspnet_torch.train.solver import TrainState
from dspnet_torch.utils.convert import flax_to_state_dict, to_flax_variables


def merge_param_subtree(params: Dict[str, Any], pretrained: Dict[str, Any],
                        subtree: str = "backbone", strict_shapes: bool = True):
    """Return ``params`` with ``params[subtree]`` leaves replaced by matching
    leaves from ``pretrained[subtree]`` (or from ``pretrained`` itself when
    it has no such key). A leaf whose shape differs raises with
    ``strict_shapes``, else keeps its fresh value; a leaf missing upstream
    keeps its fresh value."""
    if subtree not in params:
        raise KeyError(f"model has no '{subtree}' params")
    src = pretrained[subtree] if subtree in pretrained else pretrained

    def merge(dst_node, src_node, path):
        if isinstance(dst_node, dict):
            return {k: merge(v, src_node[k], path + "/" + k) if isinstance(src_node, dict) and k in src_node else v
                    for k, v in dst_node.items()}
        if hasattr(src_node, "shape") and tuple(src_node.shape) != tuple(dst_node.shape):
            if strict_shapes:
                raise ValueError(f"shape mismatch at {path}: {src_node.shape} vs {dst_node.shape}")
            return dst_node
        return src_node

    new = dict(params)
    new[subtree] = merge(params[subtree], src, subtree)
    return new


def merge_mapped(variables: Mapping[str, dict], mapped_params: Mapping[str, dict],
                 mapped_stats: Mapping[str, dict], log=None) -> Dict[str, dict]:
    """Merge mapped trees (``mxnet_import.map_multitask``'s) into
    ``variables`` top subtree by top subtree, as the JAX import tool does
    (``dspnet_tpu/tools/import_mxnet.py:65-80``): parameters with strict
    shapes, batch statistics without; a subtree the network lacks (a
    multitask file's seg head imported into a det network) is skipped."""
    log = log or logging.getLogger(__name__).info
    params = dict(variables["params"])
    for top, sub in mapped_params.items():
        if top not in params:
            log(f"skipping '{top}' subtree: target network has no such params")
            continue
        params = merge_param_subtree(params, {top: sub}, subtree=top)
    out = {"params": params}
    if variables.get("batch_stats"):
        stats = dict(variables["batch_stats"])
        for top, sub in mapped_stats.items():
            if top in stats:
                stats = merge_param_subtree(stats, {top: sub}, subtree=top, strict_shapes=False)
        out["batch_stats"] = stats
    return out


@torch.no_grad()
def assign(state: TrainState, variables: Mapping[str, dict]) -> TrainState:
    """Copy flax-layout trees into the state's parameter and buffer tensors
    in place (their device, dtype and ``requires_grad`` stay); every tensor
    of the state must be filled."""
    tensors = flax_to_state_dict(variables)
    for group in (state.params, state.buffers):
        for name, t in group.items():
            if name not in tensors:
                raise KeyError(f"no value for {name}")
            t.copy_(tensors[name])
    return state


def state_variables(state: TrainState) -> Dict[str, dict]:
    """A state's parameters and buffers as flax-layout float32 numpy trees."""
    return to_flax_variables({**state.params, **state.buffers})


def init_from_checkpoint(state: TrainState, checkpoint_dir: str, subtree: str = "backbone",
                         epoch: Optional[int] = None) -> TrainState:
    """Load ``subtree``'s parameters (and matching batch statistics) from a
    port checkpoint (``CheckpointManager`` directory) into ``state``, in
    place. The read takes no template: the source may come from another
    architecture (other head widths, class counts), which is the cross-model
    transfer this exists for (multi_init.py:50-169)."""
    from dspnet_torch.utils.checkpoint import CheckpointManager

    mgr = CheckpointManager(checkpoint_dir)
    if epoch is None:
        epoch = mgr.latest_epoch()
    if epoch is None:
        raise FileNotFoundError(f"no checkpoints under {checkpoint_dir}")
    payload = torch.load(mgr.path(epoch), map_location="cpu", weights_only=True)
    source = to_flax_variables({**payload["params"], **payload["buffers"]})
    variables = state_variables(state)
    variables["params"] = merge_param_subtree(variables["params"], source.get("params", {}), subtree)
    if variables.get("batch_stats") and source.get("batch_stats"):
        variables["batch_stats"] = merge_param_subtree(variables["batch_stats"], source["batch_stats"], subtree)
    return assign(state, variables)
