"""import_mxnet — convert a reference MXNet ``.params`` checkpoint into a port
checkpoint (counterpart of ``dspnet_tpu/tools/import_mxnet.py``).

The reference saves ``prefix-epoch.params`` (multi_train.py:370); this tool
reads that binary without MXNet (``utils/mxnet_import.py``), maps the full
trained-checkpoint inventory (backbone, multi_feat, multibox, seg head; a
pretrained-backbone file maps its backbone), merges it into a freshly
initialised model's state, and writes a ``CheckpointManager`` epoch that
``multi_train --resume``, ``multi_eval`` and ``multi_demo`` read as it is.
Heads absent from the file keep their fresh init (the reference's
init_from_resnet, multi_init.py:50-169).

    python -m dspnet_torch.tools.import_mxnet \\
        --params resnet-50-0000.params --network resnet-50_multi \\
        --data-shape 3,512,1024 --model-dir model --epoch 0

``--device`` defaults to ``cuda`` (the state is built there) and fails
without a card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="MXNet .params -> port checkpoint.")
    p.add_argument("--params", required=True, help="MXNet .params file")
    p.add_argument("--network", default="resnet-50_multi")
    p.add_argument("--data-shape", default="3,512,1024")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--model-dir", default="model")
    p.add_argument("--epoch", type=int, default=0, help="epoch number to write the checkpoint as")
    p.add_argument("--device", default="cuda", help="torch device; 'cuda' fails without a CUDA device")
    return p.parse_args(argv)


def main(argv=None):
    from dspnet_torch.api import create_model
    from dspnet_torch.cli.common import parse_data_shape, resolve_device
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix
    from dspnet_torch.utils.mxnet_import import count_leaves, load_params, map_multitask
    from dspnet_torch.utils.transfer import assign, merge_mapped, state_variables

    args = parse_args(argv)
    device = resolve_device(args.device)
    H, W = parse_data_shape(args.data_shape)
    bundle = create_model(args.network, (H, W), args.num_classes, device=device,
                          generator=torch.Generator().manual_seed(233))
    solver = MultiTaskSolver(bundle.model, bundle.anchors if bundle.anchors is not None
                             else np.zeros((1, 4), np.float32), device=device)
    state = solver.init_state()

    mx_args, mx_auxs = load_params(args.params)
    mapped_params, mapped_stats, unused = map_multitask(mx_args, mx_auxs, args.network, H)
    print(f"mapped {count_leaves(mapped_params) + count_leaves(mapped_stats)} arrays from {args.params}")
    if unused:
        print(f"WARNING: {len(unused)} reference arrays not consumed: " + ", ".join(sorted(unused)[:20]))
    assign(state, merge_mapped(state_variables(state), mapped_params, mapped_stats, log=print))

    prefix = checkpoint_prefix(args.model_dir, args.network, H)
    mgr = CheckpointManager(prefix)
    mgr.save(args.epoch, state)
    mgr.close()
    print(f"wrote {prefix} epoch {args.epoch}")
    return state


if __name__ == "__main__":
    main()
