#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card,
and check them.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases (any failure ends the run with a non-zero exit):
  1. card: its name and power limit; TF32 off for the float32 comparisons;
  2. build: compile every kernel under dspnet_torch/csrc/ into build/ (one
     nvcc each, started together) and print their resource reports;
  3. NMS kernel vs plain: the CUDA keep mask against the plain PyTorch
     version on the card, bit for bit, over random, duplicate, IoU-boundary,
     zero-area and all-invalid rows; then both timed with CUDA events;
  4. serving: resnet-50_multi at 512x1024 (random weights from a seed),
     bf16 ``Detector.predict_raw`` at b1 and b8 with the NMS launch counter
     reset just before; output checks; the detection stage recomputed through
     the kernel and through the plain NMS (must be equal); float32 heads on
     the card against the CPU on a small input; serving timings;
  5. matcher kernel vs plain: the CUDA bipartite matcher against the plain
     rounds, bit for bit, on the 512x1024 anchors (A = 12,264, L = 200) and
     at A = 24,576, over random GTs, GTs equal to anchors, duplicated GTs,
     IoUs on a 1/64 grid and invalid columns in the middle; both timed;
  6. training: the resnet-50_multi 512x1024 bf16 ``MultiTaskSolver`` step
     (float32 masters, the JAX defaults) on the canonical batch at b4 and b8,
     device-resident, with the matcher launch counter reset just before the
     timed steps; the first step's targets through the kernel and through
     the plain matcher (must be equal); a finite first step (and a report of
     where the loss diverges); a profile of one step; the loss falling over 6
     steps with ``seg_normalize="valid"``; a float32 resnet-18_multi step on
     the card against the same step on the CPU;
  7. one JSON line of kernel results, then the result line, last.
Prints nothing on standard output and exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
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


def corners(rng, *shape, lo=0.05, hi=0.3):
    cx, cy = rng.uniform(0.1, 0.9, (2, *shape))
    w, h = rng.uniform(lo, hi, (2, *shape))
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


def matcher_phase(dev, anchors_np, label):
    """Phase 5: the matcher kernel against the plain rounds, bit for bit, and
    both timed. Returns (max abs difference over every case, {B: (kernel ms,
    plain ms)})."""
    from dspnet_torch.ops import matching_cuda
    from dspnet_torch.ops.boxes import iou_matrix

    rng = np.random.RandomState(17)
    anchors = torch.from_numpy(anchors_np).to(dev)
    errs = []

    def compare(iou, col_valid, what):
        iou = iou.contiguous()
        got = matching_cuda.bipartite_match(iou, col_valid)
        want = matching_cuda.bipartite_match_reference(iou, col_valid)
        torch.cuda.synchronize()
        errs.append(max(float((got[1] - want[1]).abs().max()), float((got[2] - want[2]).abs().max()),
                        float((got[0].int() - want[0].int()).abs().max())))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"matcher kernel != plain at {what}: {int((got[1] != want[1]).sum())} anchors differ")
        return got

    def gts(B, L):
        return torch.from_numpy(corners(rng, B, L, lo=0.1, hi=0.4)).to(dev)

    L = 200
    for B in (1, 8):
        boxes = gts(B, L)
        iou = iou_matrix(anchors, boxes)
        for n in (0, 1, 8, 50, 200):
            col_valid = torch.zeros(B, L, dtype=torch.bool, device=dev)
            col_valid[:, :n] = True
            got = compare(iou, col_valid, f"B={B} A=12264 L=200 num_gt={n}")
            check(int(got[0].sum()) == B * n, f"{int(got[0].sum())} matches for {B}x{n} GTs")
        # IoUs on a 1/64 grid: exact ties everywhere
        compare(torch.round(iou * 64) / 64, torch.ones(B, L, dtype=torch.bool, device=dev),
                f"B={B} quantised IoUs")
        # invalid columns in the middle of the valid ones
        col_valid = torch.from_numpy(rng.rand(B, L) > 0.2).to(dev)
        col_valid[:, 40:120] = False
        compare(iou, col_valid, f"B={B} invalid middle columns")
    # GTs equal to anchors, each one twice: IoU 1 ties between duplicate columns
    idx = torch.from_numpy(rng.randint(0, anchors.shape[0], (2, L // 2))).to(dev)
    boxes = anchors[idx].repeat(1, 2, 1)
    compare(iou_matrix(anchors, boxes), torch.ones(2, L, dtype=torch.bool, device=dev),
            "GTs equal to anchors, duplicated")
    big = torch.from_numpy(corners(rng, 24576)).to(dev)
    for n in (9, 200):
        col_valid = torch.zeros(1, L, dtype=torch.bool, device=dev)
        col_valid[:, :n] = True
        compare(iou_matrix(big, gts(1, L)), col_valid, f"B=1 A=24576 num_gt={n}")
    print(f"matcher kernel vs plain: {len(errs)} cases equal bit for bit (torch.equal on matched, "
          f"match_gt and match_iou), A = 12,264 and 24,576")

    times = {}
    for B in (4, 8):
        iou = iou_matrix(anchors, gts(B, L)).contiguous()
        col_valid = torch.zeros(B, L, dtype=torch.bool, device=dev)
        col_valid[:, :8] = True
        k_ms = cuda_ms(lambda: matching_cuda.bipartite_match(iou, col_valid), 100)
        p_ms = cuda_ms(lambda: matching_cuda.bipartite_match_reference(iou, col_valid), 10)
        times[B] = (k_ms, p_ms)
        print(f"bipartite_match B={B} A=12264 L=200 num_gt=8: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms (CUDA events) [{label}]", flush=True)
    return max(errs), times


def training_phase(dev, label):
    """Phase 6: the resnet-50_multi training step. Returns the matcher
    launches counted over the timed steps (one per step)."""
    from dspnet_torch.api import create_model
    from dspnet_torch.ops import matching_cuda
    from dspnet_torch.ops.target import multibox_target
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils.benchmark import batch_to_device, canonical_train_batch

    # JAX defaults (dspnet_tpu/train/solver.py:81-100)
    defaults = dict(learning_rate=1e-3, momentum=0.9, weight_decay=5e-4, seg_grad_scale=4.0,
                    seg_normalize="null", overlap_threshold=0.5, negative_mining_ratio=3.0,
                    negative_mining_thresh=0.5)
    bundle = create_model("resnet-50_multi", (H, W), num_classes=NUM_CLASSES, device=dev,
                          generator=torch.Generator().manual_seed(0))
    n_warm, n_timed = 3, 20
    launches = 0
    for b in (4, 8):
        solver = MultiTaskSolver(bundle.model, bundle.anchors, batch_size=b, compute_dtype="bfloat16",
                                 device=dev, **defaults)
        state = solver.init_state()
        batch = batch_to_device(canonical_train_batch(b, H, W), dev)

        # the first step's targets through the kernel and through the plain
        # rounds (on a copy of the statistics: the forward updates them)
        with torch.no_grad():
            probe = dataclasses.replace(state, buffers={k: v.clone() for k, v in state.buffers.items()})
            cls_preds = solver.forward(probe, batch, train=True)["cls_logits"].transpose(1, 2)
            targets = [multibox_target(solver.anchors, batch["label_det"], cls_preds,
                                       overlap_threshold=0.5, negative_mining_ratio=3.0,
                                       negative_mining_thresh=0.5, bipartite_backend=backend)
                       for backend in ("kernel", "plain")]
        torch.cuda.synchronize()
        check(bool(torch.isfinite(cls_preds).all()), f"b{b}: non-finite logits")
        check(all(torch.equal(a, c) for a, c in zip(*targets)), f"b{b}: kernel-path targets != plain")
        print(f"b{b} first step's targets through the kernel == through the plain matcher "
              f"(torch.equal on loc_target, loc_mask, cls_target); "
              f"{int((targets[0][2] > 0).sum())} positives, {int((targets[0][2] == 0).sum())} negatives")
        del probe, cls_preds, targets

        losses = []
        for i in range(n_warm):
            state, m = solver.train_step(state, batch)
            losses.append(m["loss"])
            if i == 0:
                first = m
        profile, m = profile_step(solver, state, batch)  # a fourth step, off the timed window
        losses.append(m["loss"])
        torch.cuda.reset_peak_memory_stats()
        matching_cuda.launches = 0
        t0 = time.perf_counter()
        for _ in range(n_timed):
            state, m = solver.train_step(state, batch)
            losses.append(m["loss"])
        float(m["loss"])  # ends the timed window
        dt = (time.perf_counter() - t0) / n_timed
        counted = matching_cuda.launches
        check(counted == n_timed, f"b{b}: matcher launched {counted} times in {n_timed} steps")
        launches += counted
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"train b{b} 512x1024 resnet-50_multi bf16 (f32 masters), device-resident batch: "
              f"{dt * 1e3:.3f} ms/step, {b / dt:.2f} img/s, peak {peak:.3f} GiB [{label}]")
        traj = [float(x) for x in losses]
        print(f"  loss over {len(traj)} steps (seg_normalize null, lr 1e-3): "
              + ", ".join(f"{x:.6g}" for x in traj))
        print("  first step metrics: " + ", ".join(f"{k}={float(v):.6g}" for k, v in first.items()))
        check(all(np.isfinite(float(v)) for v in first.values()), f"b{b}: non-finite first step")
        bad = next((i for i, x in enumerate(traj) if not np.isfinite(x)), None)
        if bad is not None:
            print(f"  DIVERGED: the loss is non-finite from step {bad + 1} of {len(traj)}. The "
                  f"reference's unnormalized seg loss (4 x the per-pixel sum) diverges at lr 1e-3 "
                  f"from this random init; the times above hold, the trajectory is no training "
                  f"result (the loss check below uses seg_normalize valid)")
        print_profile(b, profile, dt * 1e3, label)
        del solver, state, batch
        torch.cuda.empty_cache()

    # the loss falls on a fixed batch with the normalized seg loss
    solver = MultiTaskSolver(bundle.model, bundle.anchors, batch_size=4, compute_dtype="bfloat16",
                             device=dev, **dict(defaults, seg_normalize="valid"))
    state = solver.init_state()
    batch = batch_to_device(canonical_train_batch(4, H, W, seed=1), dev)
    traj = []
    for _ in range(6):
        state, m = solver.train_step(state, batch)
        traj.append(float(m["loss"]))
    print("6 steps, b4, seg_normalize valid: loss " + ", ".join(f"{x:.6f}" for x in traj))
    check(all(np.isfinite(traj)) and traj[-1] < traj[0], f"loss did not fall: {traj}")
    del solver, state, batch
    torch.cuda.empty_cache()

    # float32 resnet-18_multi step, card vs CPU, same weights and batch
    small = canonical_train_batch(2, 128, 256, seed=2)
    states, metrics = {}, {}
    for device in ("cpu", dev):
        net = create_model("resnet-18_multi", (128, 256), num_classes=NUM_CLASSES,
                           generator=torch.Generator().manual_seed(5))
        solver = MultiTaskSolver(net.model.to(device), net.anchors, batch_size=2,
                                 device=device, **dict(defaults, seg_normalize="valid"))
        init = {k: v.detach().cpu().clone() for k, v in solver.init_state().params.items()}
        st, m = solver.train_step(solver.init_state(), small)
        states[str(device)] = {k: v.detach().cpu() for k, v in st.params.items()}
        metrics[str(device)] = {k: float(v) for k, v in m.items()}
    cpu, card = states["cpu"], states[str(dev)]
    loss_err = abs(metrics[str(dev)]["loss"] - metrics["cpu"]["loss"]) / abs(metrics["cpu"]["loss"])
    biggest = max(float((cpu[k] - init[k]).abs().max()) for k in init)
    upd_err = max(float(((card[k] - init[k]) - (cpu[k] - init[k])).abs().max()) for k in init)
    print(f"f32 resnet-18_multi train step, card vs cpu: loss {metrics[str(dev)]['loss']:.6f} vs "
          f"{metrics['cpu']['loss']:.6f} (rel err {loss_err:.2e}, tolerance 1e-4); largest update "
          f"difference {upd_err:.3e} = {upd_err / biggest:.2%} of the largest update (tolerance 5%)")
    check(loss_err <= 1e-4 and upd_err <= 0.05 * biggest, "f32 card step disagrees with the cpu step")
    return launches


KERNEL_KINDS = (  # first match wins, on the lower-cased kernel name
    ("matcher", ("match_kernel",)),
    ("nms", ("nms_mask_kernel", "nms_scan_kernel")),
    ("conv/gemm", ("conv", "gemm", "xmma", "cutlass", "cudnn", "winograd", "dgrad", "wgrad")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("reduce (BN statistics, losses)", ("reduce_kernel",)),
    ("resize/pool", ("upsample", "interp", "pool", "bilinear")),
    ("sort/gather/scatter/index", ("sort", "radix", "scan", "gather", "scatter", "index")),
    ("memcpy/memset", ("memcpy", "memset")),
    ("cat/copy", ("cat", "copy")),
    ("elementwise", ("elementwise",)),
)


def profile_step(solver, state, batch):
    """One train step under torch.profiler: ({kernel name: (device us,
    count)}, the step's metrics)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, m = solver.train_step(state, batch)
        float(m["loss"])
    names = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us, n = names.get(evt.name, (0.0, 0))
            names[evt.name] = (us + evt.device_time, n + 1)
    return names, m


def print_profile(b, names, step_ms, label):
    """Device time by kernel kind, the idle share against the unprofiled
    step time, and the ten longest kernels."""
    kinds = {}
    for name, (us, _) in names.items():
        low = name.lower()
        kind = next((k for k, keys in KERNEL_KINDS if any(x in low for x in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + us
    busy = sum(kinds.values()) / 1e3
    count = sum(n for _, n in names.values())
    share = ", ".join(f"{k} {v / 1e3:.3f} ms ({v / 1e3 / busy:.1%})"
                      for k, v in sorted(kinds.items(), key=lambda x: -x[1]))
    print(f"  profile of one b{b} step: {count} kernels, device busy {busy:.3f} ms against "
          f"{step_ms:.3f} ms/step unprofiled (idle share {max(0.0, 1 - busy / step_ms):.1%}); "
          f"by kind: {share} [{label}]")
    for name, (us, n) in sorted(names.items(), key=lambda x: -x[1][0])[:10]:
        print(f"    {us / 1e3:8.3f} ms x{n:<5d} {name[:120]}")
    sys.stdout.flush()


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
    from dspnet_torch.ops import _build, matching_cuda, nms_cuda
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
    libs = _build.build_libraries(["nms", "match"])
    print(f"build: {', '.join(str(x.relative_to(ROOT)) for x in libs)} ready in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)")
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip())
    nms_cuda.load_library()
    matching_cuda.load_library()
    sys.stdout.flush()

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

    del det, det512, batch, res, results, out, images
    torch.cuda.empty_cache()

    match_err, match_times = matcher_phase(dev, bundle.anchors, label)
    match_launches = training_phase(dev, label)

    # ---- 7. results
    k_ms, p_ms = nms_times[1]
    mk_ms, mp_ms = match_times[8]
    print(json.dumps({"kernels": [{
        "name": "nms_keep_mask",
        "route": "cuda",
        "source": "dspnet_torch/csrc/nms.cu",
        "replaces": "dspnet_tpu/ops/nms_pallas.py:30",
        "launches": launches,
        "max_abs_err": float(max_err),
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "bipartite_match",
        "route": "cuda",
        "source": "dspnet_torch/csrc/match.cu",
        "replaces": "dspnet_tpu/ops/matching_pallas.py:42",
        "launches": match_launches,
        "max_abs_err": float(match_err),
        "ms": mk_ms,
        "plain_ms": mp_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
