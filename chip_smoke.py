#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one CUDA card, and check it.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases (any failure ends the run with a non-zero exit):
  1. card: its name and power limit; TF32 off for the float32 comparisons;
  2. build: compile the NMS kernel from dspnet_torch/csrc/ into build/;
  3. kernel vs plain: the CUDA NMS keep mask against the plain PyTorch
     version on the card, bit for bit, over random, duplicate, IoU-boundary,
     zero-area and all-invalid rows; then both timed with CUDA events;
  4. the slice: resnet-50_multi at 512x1024 (random weights from a seed),
     bf16 ``Detector.predict_raw`` at b1 and b8 with the NMS launch counter
     reset just before; output checks; the detection stage recomputed through
     the kernel and through the plain NMS (must be equal); float32 heads on
     the card against the CPU on a small input; serving timings;
  5. one JSON line of kernel results, then the result line, last.
Prints nothing on standard output and exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H, W = 512, 1024
NUM_CLASSES = 8


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_label():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def random_rows(rng, B, K):
    """Random top-K rows as the NMS tests draw them, plus rows whose IoUs sit
    exactly on the thresholds: duplicates (IoU 1), a half-width box (IoU 0.5
    with the unit box) and zero-area boxes."""
    cx, cy = rng.uniform(0.1, 0.9, (2, B, K))
    w, h = rng.uniform(0.05, 0.4, (2, B, K))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)
    ids = rng.randint(0, 3, (B, K)).astype(np.float32)
    valid = rng.rand(B, K) > 0.2
    special = np.array([[0, 0, 1, 1], [0, 0, 0.5, 1], [0, 0, 1, 1], [0.5, 0.5, 0.5, 0.5],
                        [0.5, 0.5, 0.5, 0.5], [0, 0.5, 1, 1]], np.float32)
    n = min(len(special), K)
    boxes[:, :n], ids[:, :n], valid[:, :n] = special[:n], 0.0, True
    return boxes, np.where(valid, ids, -1.0).astype(np.float32), valid


def cuda_ms(fn, n):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check runs on a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import dspnet_torch
    check(Path(dspnet_torch.__file__).resolve().parent == ROOT / "dspnet_torch",
          f"dspnet_torch imported from {dspnet_torch.__file__}, not from this checkout")
    from dspnet_torch.api import create_model
    from dspnet_torch.detect.detector import Detector
    from dspnet_torch.models import factory
    from dspnet_torch.ops import nms_cuda
    from dspnet_torch.ops.detection import multibox_detection

    # ---- 1. card
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    label = card_label()
    print(f"card: {kind} | nvidia-smi name, power.limit: {label}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off (cudnn.allow_tf32 and cuda.matmul.allow_tf32 False): float32 work below "
          "is full float32", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    nms_cuda.load_library()
    lib = nms_cuda.build_library()
    print(f"build: {lib.relative_to(ROOT)} ready in {time.perf_counter() - t0:.2f} s")
    print(lib.with_suffix(".log").read_text().strip(), flush=True)

    # ---- 3. kernel vs plain, bit for bit
    rng = np.random.RandomState(233)
    errs = []

    def compare(arrays, thr, force, label):
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
        got = nms_cuda.nms_keep_mask(*args, thr, force)
        want = nms_cuda.nms_keep_mask_reference(*args, thr, force)
        torch.cuda.synchronize()
        errs.append(int((got.int() - want.int()).abs().max()))
        check(torch.equal(got, want), f"kernel != plain at {label} thr={thr} force={force}: "
                                      f"{int((got != want).sum())} rows differ")

    for B in (1, 8):
        for K in (37, 400, 1000):
            boxes, ids, valid = random_rows(rng, B, K)
            if B > 1:
                valid[-1], ids[-1] = False, -1.0  # an all-invalid image
            dup = boxes[:, rng.randint(0, min(K, 10), K)]  # many exact duplicates
            for bx in (boxes, dup):
                for thr in (0.45, 0.5):
                    for force in (False, True):
                        compare((bx, ids, valid), thr, force, f"B={B} K={K}")
    # nms_topk <= 0 runs NMS over every anchor: K = A = 12,264, many staged chunks
    rows = random_rows(rng, 1, 12264)
    for force in (False, True):
        compare(rows, 0.45, force, "B=1 K=12264")
    boxes, ids, valid = random_rows(rng, 1, 400)
    compare((boxes, ids, np.zeros_like(valid)), 0.5, False, "an all-invalid image")
    max_err = max(errs)
    print(f"kernel vs plain: {len(errs)} cases equal bit for bit (torch.equal on keep masks)")

    nms_times = {}
    for B in (1, 128):
        args = [torch.from_numpy(a).to(dev) for a in random_rows(rng, B, 400)]
        k_ms = cuda_ms(lambda: nms_cuda.nms_keep_mask(*args, 0.45), 200)
        p_ms = cuda_ms(lambda: nms_cuda.nms_keep_mask_reference(*args, 0.45), 20)
        nms_times[B] = (k_ms, p_ms)
        print(f"nms_keep_mask B={B} K=400: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"(CUDA events) [{label}]", flush=True)

    # ---- 4. the slice: resnet-50_multi 512x1024, bf16
    gen = torch.Generator().manual_seed(0)
    bundle = create_model("resnet-50_multi", (H, W), num_classes=NUM_CLASSES, device=dev,
                          generator=gen)
    check(bundle.anchors.shape == (12264, 4), f"anchors {bundle.anchors.shape}")
    det = Detector(bundle.model, bundle.anchors, (H, W), device=dev, dtype=torch.bfloat16)
    frng = np.random.RandomState(0)
    frames = {b: frng.randint(0, 256, (b, H, W, 3), np.uint8) for b in (1, 8)}
    for b in (1, 8):  # warm-up: cudnn plans, allocator
        det.predict_raw(frames[b])
    torch.cuda.synchronize()

    nms_cuda.launches = 0
    results = {}
    for calls, b in enumerate((1, 8), start=1):
        results[b] = det.predict_raw(frames[b])
        check(nms_cuda.launches == calls,
              f"NMS kernel launched {nms_cuda.launches} times for {calls} predict_raw calls")
    torch.cuda.synchronize()
    launches = nms_cuda.launches
    print(f"main path: 2 predict_raw calls (b1, b8) launched the NMS kernel {launches} times")

    for b, res in results.items():
        d, s = res["det"], res["seg"]
        check(d.shape == (b, 400, 7) and d.dtype == torch.float32, f"det {tuple(d.shape)} {d.dtype}")
        check(bool(torch.isfinite(d).all()), "non-finite det")
        ids = d[..., 0]
        check(bool(((ids == ids.round()) & (ids >= -1) & (ids <= NUM_CLASSES - 1)).all()),
              "class ids outside {-1..7}")
        scored = d[..., 1] >= 0
        bx = d[..., 2:6]
        check(bool(((bx >= 0) & (bx <= 1)).all(-1)[scored].all()), "boxes outside [0, 1]")
        check(bool((d[~scored] == -1).all()), "sentinel rows not all -1")
        check(s.shape == (b, H // 4, W // 4) and s.dtype == torch.uint8, f"seg {tuple(s.shape)} {s.dtype}")
        check(bool((s < 19).all()), "seg class >= 19")
        print(f"b{b}: det {tuple(d.shape)} f32 with {int((ids >= 0).sum())} kept rows, "
              f"seg {tuple(s.shape)} uint8 with {int(s.unique().numel())} classes")

    # the detection stage from the same head outputs, kernel NMS vs plain NMS
    with torch.inference_mode():
        images = torch.from_numpy(frames[8]).to(dev).flip(-1).float() - det.mean
        out = det.model(images.to(torch.bfloat16))
        cls_prob = torch.softmax(out["cls_logits"].float(), dim=-1).transpose(1, 2)
        dets = {backend: multibox_detection(cls_prob, out["loc_preds"], det.anchors,
                                            nms_threshold=det.nms_thresh, nms_backend=backend)
                for backend in ("kernel", "plain")}
    torch.cuda.synchronize()
    check(torch.equal(dets["kernel"], dets["plain"]), "kernel-path det != plain-path det")
    print("b8 det through the kernel == det through the plain NMS (torch.equal); equal to "
          f"predict_raw's det: {torch.equal(dets['kernel'], results[8]['det'])}")

    # float32 heads on the card vs on the CPU, small input, same seeded weights
    small = np.random.RandomState(1).normal(0, 50, (1, 128, 256, 3)).astype(np.float32)
    heads = {}
    for device in ("cpu", dev):
        m = create_model("resnet-50_multi", (128, 256), device=device,
                         generator=torch.Generator().manual_seed(1)).model
        with torch.inference_mode():
            heads[str(device)] = {k: v.float().cpu() for k, v in m(torch.from_numpy(small).to(device)).items()}
    for k, ref in heads["cpu"].items():
        err = float((heads[str(dev)][k] - ref).abs().max())
        tol = 1e-4 * float(ref.abs().max())
        print(f"f32 {k}: card vs cpu max abs err {err:.3e} (tolerance {tol:.3e})")
        check(err <= tol, f"f32 {k} card vs cpu error {err} > {tol}")

    # timings
    def serve(b):
        res = det.predict_raw(frames[b])
        return res["det"].cpu(), res["seg"].cpu()  # D2H ends the call

    for _ in range(3):
        serve(1)
    torch.cuda.reset_peak_memory_stats()
    n = 30
    t0 = time.perf_counter()
    for _ in range(n):
        serve(1)
    lat_ms = (time.perf_counter() - t0) / n * 1e3
    mem1 = torch.cuda.max_memory_allocated() / 2**30
    print(f"b1 512x1024 predict_raw incl. H2D + D2H: {lat_ms:.3f} ms/call, peak "
          f"{mem1:.3f} GiB [{label}]")

    for _ in range(2):
        serve(8)
    torch.cuda.reset_peak_memory_stats()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        serve(8)
    b8_ips = 8 * n / (time.perf_counter() - t0)
    mem8 = torch.cuda.max_memory_allocated() / 2**30
    print(f"b8 512x1024 predict_raw incl. H2D + D2H: {b8_ips:.2f} img/s, peak {mem8:.3f} GiB [{label}]")

    anchors512 = factory.build_anchors(bundle.cfg.drop_first_tap(), (512, 512))
    det512 = Detector(bundle.model, anchors512, (512, 512), device=dev, dtype=torch.bfloat16,
                      nms_thresh=0.45)
    batch = torch.randn(128, 512, 512, 3, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    for _ in range(2):
        det512.predict(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        res = det512.predict(batch)
    torch.cuda.synchronize()
    b128_ips = 128 * n / (time.perf_counter() - t0)
    mem128 = torch.cuda.max_memory_allocated() / 2**30
    check(res["det"].shape == (128, 400, 7) and res["seg"].shape == (128, 128, 128), "b128 shapes")
    print(f"b128 512x512 bf16 predict (reference-exact head, device-resident input): "
          f"{b128_ips:.2f} img/s, peak {mem128:.3f} GiB [{label}]")

    # ---- 5. results
    k_ms, p_ms = nms_times[1]
    print(json.dumps({"kernels": [{
        "name": "nms_keep_mask",
        "route": "cuda",
        "source": "dspnet_torch/csrc/nms.cu",
        "replaces": "dspnet_tpu/ops/nms_pallas.py:30",
        "launches": launches,
        "max_abs_err": float(max_err),
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
