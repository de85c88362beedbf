"""visualize_net — a network's module outputs and its anchor count
(counterpart of ``dspnet_tpu/tools/visualize_net.py``).

The reference plots its MXNet symbol with graphviz (reference
tools/visualize_net.py:19-25); the JAX tool prints flax's ``tabulate`` table.
This one prints every module's output shape under its flax module path
(``utils/shapes.py::intermediate_shapes``, the forward run on the meta
device, so no weights are made), the parameter count, and the JAX tool's
last line, ``task=… anchors=… input=HxW``. The table's layout is not flax's.
It runs on the host and needs no card. The JAX tool's ``--hlo`` (the
lowered StableHLO) is an XLA artefact: argparse refuses it here.

    python -m dspnet_torch.tools.visualize_net --network resnet-50_multi --data-shape 3,512,1024
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Print a network summary.")
    p.add_argument("--network", default="vgg16_reduced")
    p.add_argument("--num-classes", type=int, default=20)
    p.add_argument("--data-shape", default="300")
    p.add_argument("--train", action="store_true", help="summarize the train-mode graph")
    args = p.parse_args(argv)

    from dspnet_torch.api import create_model
    from dspnet_torch.cli.common import parse_data_shape
    from dspnet_torch.utils.shapes import print_summary

    H, W = parse_data_shape(args.data_shape)
    bundle = create_model(args.network, (H, W), args.num_classes, device="meta")
    print_summary(bundle.model, (H, W), train=args.train)
    n_params = sum(t.numel() for t in bundle.model.parameters())
    print(f"parameters: {n_params}")
    print(f"task={bundle.task} anchors={bundle.num_anchors} input={H}x{W}")


if __name__ == "__main__":
    main()
