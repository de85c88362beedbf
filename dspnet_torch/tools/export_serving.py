"""export_serving — export the serving pipeline as one artifact
(counterpart of ``dspnet_tpu/tools/export_serving.py``).

Writes a self-contained serving bundle: the whole pipeline (uint8 BGR ->
normalize -> network -> softmax -> decode -> NMS -> seg argmax) captured by
``torch.export`` at one static input shape, with the weights baked in,
saved by ``torch.export.save`` as ``.pt2``, and a small JSON manifest beside
it (``<out>.json``, the JAX manifest's keys and values). ``load_bundle``
runs it without the model code, a config or a checkpoint: the counterpart of
shipping the reference's ``prefix-symbol.json + prefix-epoch.params`` pair
to a deployment host (``mx.model.load_checkpoint``,
detect/multitask_detector.py:105).

The NMS inside the bundle is a call of the registered operator
``dspnet::nms_keep_mask`` (``ops/nms_cuda.py``): a bundle exported on the
card launches the hand-written kernel (``csrc/nms.cu``) wherever it is
loaded on a card, and a bundle exported on the CPU runs the plain version.
So the one deliberate difference from the JAX bundle, which needs only
``jax`` to load: ``load_bundle`` imports ``dspnet_torch.ops`` (the operator's
registration, with no model code), and on a card that builds ``csrc/nms.cu``
at its first call. The JAX tool's ``--pallas-nms`` (a TPU-only artifact) is
refused by argparse; a bundle exported on the card always runs the kernel.

Usage::

    python -m dspnet_torch.tools.export_serving --network resnet-50_multi \\
        --data-shape 3,512,1024 --batch-size 8 --model-dir model \\
        --out serving/dspnet.pt2 [--bf16] [--device cpu]

``--model-dir`` takes the port's checkpoints or a JAX run's model dir as
it is (its Orbax steps, read through ``utils/orbax_read.py``).

    # at the deployment site
    from dspnet_torch.tools.export_serving import load_bundle
    serve = load_bundle("serving/dspnet.pt2")
    det, seg = serve(raw_bgr_uint8_batch)   # (B, H, W, 3) uint8 on the bundle's device

Outputs keep the JAX bundle's types: ``det`` (B, K, 7) float32 rows
``[id, score, x1, y1, x2, y2, dist]`` and ``seg`` (B, H/4, W/4) int32, as
``jnp.argmax`` gives (the ``Detector`` returns its seg map as uint8); a
det-only or seg-only network returns the one it has.
"""

from __future__ import annotations

import argparse
import copy
import json
import os

import torch


class _ServeModule(torch.nn.Module):
    """The exported computation: raw uint8 BGR batch -> (det rows, seg map).

    Holds its own copy of the network cast to ``dtype``; the class softmax,
    decode and NMS run in float32 whatever that dtype is."""

    def __init__(self, model, anchors, dtype, nms_thresh=0.45, score_threshold=0.01, nms_topk=400):
        from dspnet_torch.detect.detector import MEAN_PIXELS

        super().__init__()
        device = next(model.parameters()).device
        self.model = copy.deepcopy(model).to(dtype=dtype).eval().requires_grad_(False)
        self.dtype = dtype
        self.register_buffer("mean", torch.tensor(MEAN_PIXELS, dtype=torch.float32, device=device))
        self.register_buffer("anchors", None if anchors is None
                             else torch.as_tensor(anchors, dtype=torch.float32).to(device))
        self.nms_thresh = nms_thresh
        self.score_threshold = score_threshold
        self.nms_topk = nms_topk

    def forward(self, raw_bgr):
        from dspnet_torch.ops.detection import multibox_detection

        x = raw_bgr.flip(-1).float() - self.mean
        out = self.model(x.to(self.dtype))
        det = seg = None
        if "cls_logits" in out:
            cls_prob = torch.softmax(out["cls_logits"].float(), dim=-1)
            det = multibox_detection(
                cls_prob.transpose(1, 2), out["loc_preds"], self.anchors,
                threshold=self.score_threshold, nms_threshold=self.nms_thresh, nms_topk=self.nms_topk)
        if "seg_logits" in out:
            seg = out["seg_logits"].argmax(dim=-1).to(torch.int32)
        if det is None:
            return seg
        if seg is None:
            return det
        return det, seg


def build_serve_fn(model, anchors, dtype=torch.float32, nms_thresh=0.45, score_threshold=0.01,
                   nms_topk=400) -> torch.nn.Module:
    """The serving module over a copy of ``model`` cast to ``dtype``, on the
    model's device (``model`` itself is left as it was)."""
    return _ServeModule(model, anchors, dtype, nms_thresh=nms_thresh,
                        score_threshold=score_threshold, nms_topk=nms_topk)


def export_bundle(bundle, out_path: str, batch_size: int, data_shape, bf16: bool = False,
                  nms_thresh: float = 0.45, score_threshold: float = 0.01, nms_topk: int = 400) -> str:
    """Export ``bundle.model`` (a ``ModelBundle``'s weights, on its device)
    at the static input (batch_size, H, W, 3) uint8 to ``out_path`` (.pt2),
    and the manifest to ``out_path + ".json"``; returns ``out_path``."""
    H, W = data_shape
    serve = build_serve_fn(bundle.model, bundle.anchors, torch.bfloat16 if bf16 else torch.float32,
                           nms_thresh=nms_thresh, score_threshold=score_threshold, nms_topk=nms_topk)
    example = torch.zeros((batch_size, H, W, 3), dtype=torch.uint8, device=serve.mean.device)
    with torch.no_grad():
        program = torch.export.export(serve, (example,))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(program, out_path)
    manifest = {
        "network": bundle.name,
        "task": bundle.task,
        "data_shape": [H, W],
        "batch_size": batch_size,
        "num_anchors": bundle.num_anchors,
        "dtype": "bfloat16" if bf16 else "float32",
        "input": f"uint8 BGR (B={batch_size}, {H}, {W}, 3)",
        "output": "det rows (B, A, 7) [id, score, x1, y1, x2, y2, dist] "
                  "and/or seg argmax (B, H/4, W/4)",
    }
    with open(out_path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    return out_path


def load_bundle(path: str):
    """Load an exported bundle; returns a module over uint8 batches on the
    device it was exported on. Needs ``torch`` and the operator's
    registration (``dspnet_torch.ops``), no model code."""
    import dspnet_torch.ops  # noqa: F401  (registers dspnet::nms_keep_mask)

    return torch.export.load(path).module()


def main(argv=None):
    from dspnet_torch.cli.common import MODEL_DIR_HELP

    p = argparse.ArgumentParser(description="Export the serving pipeline (torch.export).")
    p.add_argument("--network", default="resnet-50_multi")
    p.add_argument("--data-shape", default="3,512,1024")
    p.add_argument("--num-classes", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--model-dir", default="model", help=MODEL_DIR_HELP)
    p.add_argument("--epoch", type=int, default=-1)
    p.add_argument("--out", required=True)
    p.add_argument("--bf16", action="store_true", help="serve in bfloat16")
    p.add_argument("--seg-fast", action="store_true", help="model was trained with --seg-fast")
    p.add_argument("--nms-thresh", type=float, default=0.45)
    p.add_argument("--score-threshold", type=float, default=0.01)
    p.add_argument("--nms-topk", type=int, default=400)
    p.add_argument("--random-init", action="store_true", help="skip checkpoint load (testing)")
    p.add_argument("--device", default="cuda",
                   help="torch device the bundle runs on; 'cuda' fails without a CUDA device")
    args = p.parse_args(argv)

    import numpy as np

    from dspnet_torch.api import create_model
    from dspnet_torch.cli.common import parse_data_shape, resolve_device
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix

    device = resolve_device(args.device)
    H, W = parse_data_shape(args.data_shape)
    bundle = create_model(args.network, (H, W), args.num_classes, device=device, seg_fast=args.seg_fast)
    if not args.random_init:
        solver = MultiTaskSolver(bundle.model, bundle.anchors if bundle.anchors is not None
                                 else np.zeros((1, 4), np.float32), device=device)
        ckpt = CheckpointManager(checkpoint_prefix(args.model_dir, args.network, H))
        state, epoch = ckpt.restore(None if args.epoch < 0 else args.epoch, solver.init_state())
        bundle.model.load_state_dict(solver.detector_variables(state))
        print(f"loaded checkpoint epoch {epoch}")

    out = export_bundle(bundle, args.out, args.batch_size, (H, W), bf16=args.bf16,
                        nms_thresh=args.nms_thresh, score_threshold=args.score_threshold,
                        nms_topk=args.nms_topk)
    size_mb = os.path.getsize(out) / 1e6
    print(f"exported {out} ({size_mb:.1f} MB)")
    return out


if __name__ == "__main__":
    main()
