#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths and its CLIs on one
CUDA card, and check them.

    python3 chip_smoke.py        # from the repository root, one GPU

Phases (any failure ends the run with a non-zero exit):
  1. card: its name and power limit; TF32 off for the float32 comparisons;
     one line on which of the Video Codec SDK's headers and libraries
     (nvcuvid.h, cuviddec.h, nvEncodeAPI.h, libnvcuvid, libnvidia-encode)
     and libjpeg / libpng this machine has (a report, never a failure);
  2. build: compile every kernel under dspnet_torch/csrc/ into build/ (one
     nvcc each, started together) and print their resource reports;
  3. NMS kernel vs plain: the CUDA keep mask against the plain PyTorch
     version on the card, bit for bit, over random, duplicate, IoU-boundary,
     near-threshold, zero-area and all-invalid rows, on both sides of the
     shared-memory limit and at more images than SMs; then timed at K = 400,
     B = 1 and 128: device us per call (torch.profiler, the kernels by
     name), the wrapper's host us, back-to-back CUDA events, the bound from
     the shapes; B = 1 also on one block per image (no cluster); each shape
     also through the kernel before its redesign for Hopper
     (baselines/nms_two_launch.cu, same inputs, same keep mask);
  4. serving: resnet-50_multi at 512x1024 (random weights from a seed),
     bf16 ``Detector.predict_raw`` at b1 and b8 with the NMS launch counter
     reset just before; output checks; the detection stage recomputed through
     the kernel and through the plain NMS (must be equal); float32 heads on
     the card against the CPU on a small input; serving timings;
  5. matcher kernel vs plain: the CUDA bipartite matcher against the plain
     rounds, bit for bit, on the 512x1024 anchors (A = 12,264, L = 200) and
     at A = 24,576, over random GTs, GTs equal to anchors, duplicated GTs,
     one GT repeated 200 times, crowded GTs (50 and 200 jittered around one
     centre), IoUs on a 1/64 grid and invalid columns in the middle, with
     the columns each image refilled from device memory; timed as phase 3
     at B = 4 and 8 with 8 GTs, B = 8 with 200, and on the crowded cases
     (one GT x200 at B = 1, 50 crowded GTs at B = 8), each beside the
     baseline kernel (baselines/match_one_block.cu, same result);
  6. training: the resnet-50_multi 512x1024 bf16 ``MultiTaskSolver`` step
     (float32 masters, the JAX defaults) on the canonical batch at b4 and b8,
     device-resident, with the matcher launch counter reset just before the
     timed steps; the first step's targets through the kernel and through
     the plain matcher (must be equal); a finite first step (and a report of
     where the loss diverges); a profile of one step; the loss falling over 6
     steps with ``seg_normalize="valid"``; a float32 resnet-18_multi step on
     the card against the same step on the CPU;
  7. the CLIs at full width (resnet-50_multi 512x1024, b4, bf16, synthetic
     data written by the port: 16 train and 8 val images): one
     ``DeviceAugIterator`` batch on the card against the same batch on the
     CPU; ``multi_train.main`` for 2 epochs with a validation pass and a
     checkpoint after each (the matcher launch counter must rise by the
     train steps, the NMS counter by the eval batches); a resume from the
     latest checkpoint (restored tensors bit for bit, step 8, epoch 2);
     ``multi_eval.main`` on the latest checkpoint, its device confusion
     matrix against a host ``np.bincount`` of the same seg maps; then
     timings on 64 train and 64 val images (16-batch epochs): the
     loader-fed, the decoded-ahead and the resident-batch ``fit``,
     ``evaluate_model``'s ms/batch loader-fed and on batches held on the
     card beside the detector's predict alone, checkpoint save and size,
     dataset write;
  8. real data: a prepared Cityscapes layout at raw 1024x2048 (16 train, 8
     val JPEGs at q95 4:2:0 from the port's encoder, XML with <distance>,
     ImageSets, trainId, instanceIds and disparity PNGs) and its .drec copy;
     the decoder at 4:2:0, 4:2:2, 4:4:4 and gray at 1024x2048, 256x512,
     64x128 and 37x53: the colour kernel (csrc/jpeg.cu) on nvJPEG's planes
     against its plain PyTorch version bit for bit, and the card's pixels
     against the plain decoder's within ``jpeg_cuda.GATES``; a progressive
     file (nvJPEG's single-image route) and an Exif orientation; the colour
     kernel's device us beside its bound; nvJPEG per image on the planar
     route against its own interleaved output (before the repair), in turns,
     and per backend it offers on this card; the per-route counts;
     ``multi_train --dataset-root`` for 2 epochs on the directory, on the
     .drec and with --predownscale, ``multi_eval --dataset-root`` with
     --write-results --instance-eval (8 result PNGs of 1024x2048), without,
     and on the .drec; each run's counts checked (matcher launches = steps,
     NMS = eval batches, nvJPEG images = colour launches = images read, plain
     JPEG decodes and plain colour calls 0) and its time and peak memory
     printed; the loader alone on the JPEGs against a PNG copy of the same
     scenes; loader-fed against resident ``fit``;
  9. reference weights at resnet-50_multi 512x1024: a reference-layout
     .params (220 args, 118 auxs) written from seeded weights,
     ``tools.import_mxnet`` (the checkpoint equal to them bit for bit),
     ``multi_demo`` (bf16) on 4 of phase 8's JPEGs and 2 images of other
     sizes (NMS launches = nvJPEG images = colour launches = images; each
     _out.jpg the input's size), the demo timed by stage per image,
     ``ServingPipeline`` (a CUDA graph per slot) over 64 b1 frames at depths
     1, 2 and 4 against the synchronous path (results equal and in order in
     every run; frames/s of each, the card's busy share; depth 4 faster per
     frame than depth 1; under the profiler one NMS kernel per replayed frame
     and no wrapper call; ``update_weights`` between submits reaching the
     frames after it and not those before), ``multi_train --resume`` from the imported epoch with
     ``--monitor 2`` (matcher launches = steps, the monitor lines, the
     monitor's cost per step);
 10. the plain-SSD VOC path at full width (vgg16_reduced, 21 classes, seeded
     weights, bf16 over float32 masters): ``Detector.predict`` at 300x300 b1
     and b32 and at 512x512 b8 (NMS 0.45 across classes; det rows checked;
     kernel-NMS det == plain-NMS det), float32 heads card vs CPU; the two
     kernels at this path's shapes against their plain versions bit for bit
     and timed (NMS at B = 1 and 32, K = 400, 20 foreground classes, with
     and without force_suppress; the matcher at A = 8,732 (B = 8, 32) and
     24,576 (B = 8), L = 100, random and crowded GTs); a synthetic VOC
     devkit (32 + 32 JPEGs of 375x500), one ``DetIterator`` batch on the
     card against the same draws on the CPU; ``train_step`` at b8 and b32
     300x300 and b8 512x512 (ms/step, img/s, peak memory, a profiled step
     with the idle share, first-step targets through kernel and plain
     matcher), the loss falling over 8 steps; ``multi_train --loader det``
     for 2 epochs, a ``--resume``, ``eval_voc --voc07`` with the devkit
     files; the DetIterator alone beside loader-fed and resident ``fit``.
     Every run's counts are checked: matcher launches = train steps, NMS =
     eval batches, nvJPEG images = images read, plain JPEG decodes and
     plain NMS / matcher calls 0;
 11. the last backbone and the model and training options: the inceptionv3
     SSD at full width (20 classes, seeded weights, bf16 over float32
     masters) at 512x512 (A = 5,186) and 300x300 (A = 1,668): ``Detector``
     at b1 and b32 (det == the plain-NMS path bit for bit), a float32
     forward card vs CPU, the two kernels at its shapes bit for bit and
     timed (NMS K = 400, 20 classes, B = 1 and 32; the matcher at A = 5,186,
     L = 100, 12 and 60 crowded GTs at B = 8 and 32), ``train_step`` on
     ``DetIterator`` batches at b8 and b32 @300 and @512 (ms/step, idle
     share, peak memory), ``multi_train --network inceptionv3 --loader det``
     for 2 epochs on a synthetic VOC devkit (phase 10's), ``--resume``,
     ``eval_voc --voc07``; ``seg_fast`` at resnet-50_multi 512x1024 with and
     without (b1 ``predict_raw``, the b8 bf16 step, the seg head's device
     time forward and backward on the step's taps, a float32 forward card vs
     CPU, one parameter tree); ``remat`` with and without (the b8 and b32
     steps: ms/step and ``max_memory_allocated``; a float32 step equal to
     the plain one bit for bit, each BatchNorm's running statistics moved
     once); data parallelism on the one card: world 1 through the distributed path over
     NCCL (a step equal to the plain step bit for bit, both timed), and
     ``multi_train --coordinator --num-processes 2`` as two processes
     sharing the card over gloo at resnet-18_multi 512x1024 (the depth cut
     for time), against the one-process run on the same global batches:
     each tensor's change from the seeded weights within 10% of the largest
     change of its kind, the step losses within rtol 1e-3 (the first within
     1e-4). Every run's counts are checked (NMS launches = predict
     calls + eval batches, matcher = steps, plain calls 0);
 12. the data-preparation chain (the reference's Cityscapes configuration,
     resnet-50_multi at 512x1024, bf16 over float32 masters; only the
     number of scenes is cut, to 16 train and 8 val): a raw Cityscapes tree
     at 2048x1024 (gtFine polygon JSONs of 100 polygons a scene: concave,
     self-intersecting, degenerate, past the border, '...group' labels,
     deleted objects; 16-bit disparity; the half-size q95 4:2:0 JPEGs of
     convert_cityscapes.sh) -> ``tools.prepare_cityscapes --disparity
     --instance-ids`` -> ``tools.prepare_dataset --pack``; the same samples
     as a reference-format MXNet .rec (label vector ``2 6 <objects>``) ->
     ``tools.im2rec --from-rec`` (both stores the same SampleIndex); the
     matcher kernel and the NMS kernel against their plain versions on this
     data; ``multi_train --dataset-root`` on the .rec-derived store for 2
     epochs at b4, ``multi_eval --write-results --instance-eval`` on the
     prepared directory (every count checked); the official scores of the
     full-resolution result PNGs against the instanceIds' labelIds
     (``evaluate_pairs``; each ground truth against itself scores 1.0);
     ``tools.visualize_net`` (12,264 anchors at 512x1024, 4,822 at
     320x640) and ``tools.voc_palette`` both ways; the seconds of each stage;
 13. the serving deployment path (resnet-50_multi 512x1024, seeded
     weights): ``tools.export_serving`` bundles (``torch.export``, the NMS
     through the registered operator ``dspnet::nms_keep_mask``) at b1 and b8
     in float32 and bf16, export seconds and MB; each loaded in a fresh
     process that imports torch and ``dspnet_torch.ops`` only (load
     seconds, NMS launches = calls, plain calls 0) and compared with
     ``Detector.predict_raw`` on the same weights and frames (float32 under
     deterministic cuDNN bit for bit; bf16 det ids and seg pixels equal on
     >= 0.999, the shares printed); the loaded program's b1 ms and b8 img/s
     beside ``predict_raw``'s, in turns; the operator's host us per call
     against the direct ctypes launch it wraps (B = 1 and 128, K = 400);
     ``Detector(devices=[cuda:0, cuda:0])`` at b1, b3 and b8 equal to the
     one-device Detector (float32, bit for bit) and its b8 ms;
 14. the JAX CLIs' host loaders, the run scripts and the bench port
     (resnet-50_multi 512x1024, seeded weights): ``ServingPipeline`` over
     ``Detector(devices=[cuda:0, cuda:0])`` (a graph per replica per slot)
     at b1, b3 and b8, depths 1 and 3, equal to the synchronous
     device-list path bit for bit, and its b1 ms/frame beside the
     one-device pipeline's; ``multi_train`` (2 b4 steps) and ``multi_eval``
     with ``--loader python`` and ``--loader native --native-u8`` on 8 + 4
     synthetic JPEGs (matcher, NMS, nvJPEG, colour kernel and plain-decode
     counts per loader); ``dspnet_torch/scripts/run_multi.sh`` train, then
     eval and demo side by side, with ``LOADER`` unset, in fresh processes
     beside those runs; each loader's img/s alone and a native batch against a python
     batch on the same samples within the JAX package's native-vs-python
     bounds; ``dspnet_torch.bench``'s three modes (``bench.main``, in this
     process), each JSON line printed; ``ops/nms.py``'s ``nms_keep`` on the
     card against ``nms``;
 15. the JAX package's Orbax checkpoints without JAX: libzstd's path and
     version; the committed resnet-50_multi 512x1024 checkpoint written by
     the JAX package (tests/fixtures/jax_orbax/, epoch 3, step 1234) read
     leaf for leaf (540 leaves, every sha256 equal to the JAX
     ``restore_raw``'s), timed; restored into the card's ``TrainState`` (bit
     for bit, the JAX step), timed; on a copy of its model dir
     ``multi_eval`` (NMS launches = eval batches), ``multi_train --resume
     0`` for 2 b4 bf16 steps (matcher launches = steps, the step going on
     from the JAX step, epoch 4 written as 0004.pt beside the Orbax step)
     and ``multi_eval`` on the latest (.pt) and with ``--epoch 3`` (Orbax);
     nvJPEG and the colour kernel once an image, plain calls 0;
 16. video through ``multi_demo`` (resnet-50_multi 512x1024 bf16, seeded
     weights, seed 16): a Motion-JPEG AVI of 64 textured 1024x2048 frames
     encoded by nvJPEG and written by ``data/avi.py``; ``multi_demo --images
     clip.avi`` under the profiler (frames in = frames out in
     ``detection_out.mp4``, read back at 25 fps and 1024x2048; nvJPEG images,
     colour launches and mp4v encodes = 64, NMS wrapper launches = the
     pipeline's warm-ups and captures and NMS kernels run = 64 + warm-ups,
     plain decodes, JPEG encodes 0) and again timed; the pipeline's rendered
     frames equal a synchronous ``predict_raw`` replay with the same drawing
     bit for bit, the overlay on the card equals numpy's, the output's PSNR
     against its rendered frames, and nvJPEG's encoder (called directly) on
     sampled rendered frames within its gate of the plain encoder; the committed clips of cv2's two writers and a
     DHT-less copy through ``detect_and_visualize``; the JPEG forms
     (progressive, DHT-less, RGB-coded, CMYK, YCCK) on the card within the
     gates or refused by name, the colour kernel equal to its plain version
     in each mode; each stage's ms per frame and the mp4v writer's host and
     device us;
 17. every JPEG form cv2 reads, on the card (the committed forms of
     tests/fixtures/jpeg_forms/, written by python tests/make_jpeg_fixtures.py):
     each decoded alone, its route chosen from the header and checked
     (arithmetic-coded and progressive-with-restart files transcoded to
     baseline for nvJPEG, lossless ones reconstructed on the host, plain
     decodes 0), lossless pixels equal to cv2's sha256 in forms.json, DCT
     forms within ``jpeg_cuda.GATES`` of the plain decoder, the colour
     kernel equal to its plain version in every geometry, the forms cv2
     returns None for refused by name; ``multi_demo --images`` at
     resnet-50_multi 512x1024 bf16 (seed 17) over an arithmetic, a lossless,
     a 4:1:1 and a progressive-with-restart file (NMS launches = images =
     colour launches, the routes, plain decodes 0); one ``DeviceAugIterator``
     batch of six forms at 37x53 against the per-image decodes; the host ms
     of ``transcode_baseline`` and ``lossless_planes``; the colour kernel's
     device us at 1024x2048 4:1:1 and 4:4:0, and at 4:2:0 in turns with its
     baseline (baselines/jpeg_colour_per_sample.cu, the kernel before it
     took every geometry);
 18. the still-image formats beside JPEG and PNG (the committed forms of
     tests/fixtures/image_forms/, written by python tests/make_image_fixtures.py):
     every form under IMREAD_COLOR / GRAYSCALE / UNCHANGED equal to the
     sha256 of cv2's array in forms.json, the forms cv2 returns None for
     refused by name; a 1024x2048 scene written by the port's BMP, PPM, PAM,
     PFM, TIFF (LZW), Sun raster, WebP (VP8L) and GIF (its seg map) writers
     and read back equal, each format's host encode and decode ms beside
     its bound, and the committed 1024x2048 lossy WebP's and GIF's decode
     ms; ``multi_demo --images`` at resnet-50_multi 512x1024 bf16 (seed 18)
     over a BMP, an LZW TIFF, a PPM, a lossy WebP and a GIF at 1024x2048
     (NMS launches = images; nvJPEG images, colour launches and plain JPEG
     decodes 0); one ``DeviceAugIterator`` batch over a ``YoloFormat``
     index of TIFF images and one of BMP images, each equal to the per-image
     host decodes and fed to one ``train_step`` (one matcher launch each);
     ``voc_palette`` into BMP, TIFF, PGM, PPM, WebP and GIF read back equal;
 19. JPEG 2000 through the three kernels of csrc/jpeg2000.cu: every committed
     form of tests/fixtures/jpeg2000_forms/ (python tests/make_jpeg2000_fixtures.py)
     under each flag equal to cv2's sha256 on the card, the refusals by name,
     each kernel (t1_decode, idwt, mct_store) == its plain version bit for
     bit on every form and on a 1024x2048 textured scene as the port's
     lossless 5/3 file (equal to the scene) and the committed 9/7 file, with
     host tier-2 ms, each kernel's device us, launches, host us, bound and
     plain ms, one read end to end on each; ``multi_demo --images`` on both
     and one ``DeviceAugIterator`` batch over ``YoloFormat(image_ext=".jp2")``
     into one ``train_step`` (kernel launches counted; plain decodes 0);
 20. MPEG-4 Part 2 (mp4v) through the three kernels of csrc/mpeg4.cu: every
     committed form of tests/fixtures/mp4v_forms/ (python
     tests/make_mp4v_fixtures.py) decoded on the card to cv2's sha256, the
     refused tools raising by name, each kernel (mp4v_parse, mp4v_recon,
     yuv420_to_bgr) == its plain version bit for bit on every form (cv2's
     2048x1024 clip among them) and on a 1024x2048 textured clip of 24
     frames (two GOPs) written by the port on the card, its largest
     difference measured; host ms of the container and VOP headers, each
     kernel's device us, launches, host us, bound and plain ms;
     ``multi_demo --images clip.mp4`` at resnet-50_multi 512x1024 bf16 (seed 20) writing
     ``detection_out.mp4``, read back by the port's decoder (NMS and the
     three kernels launched, plain calls 0); each stage's ms per frame; the
     writer's bytes and PSNR per frame;
 21. the demo's text as cv2 5.0.0 draws it (``utils/text.py``, no cv2 on the
     card's machine): the font's sha256, every committed form of
     tests/fixtures/text_forms/ (python tests/make_text_fixtures.py) drawn
     on its seeded background equal to cv2's sha256 and its getTextSize to
     cv2's, each refusal by name, host ms per form and per 1024x2048 frame
     of 40 labels with the glyph and layout caches cold and warm (phases 16
     and 20 print the draw stage's ms per frame and the cache's hits and
     misses);
 22. AVIF through the four kernels of csrc/av1.cu: every committed form of
     tests/fixtures/avif_forms/ (python tests/make_avif_fixtures.py) under
     each flag equal to cv2's sha256 on the card, each AV1 item parsed once
     and read under the three flags; each kernel (av1_recon, av1_deblock,
     av1_cdef, av1_lr) == its plain version bit for bit on every item, the
     plain stages over a process pool, two 1024x2048 textured scenes (cv2's
     defaults, and speed 0 with loop restoration) among them; host parse
     ms, each kernel's device us, launches, host us, bound and plain ms,
     one read end to end; ``multi_demo --images`` on both scenes and one
     ``DeviceAugIterator`` batch over ``YoloFormat(image_ext=".avif")``
     into one ``train_step`` (kernel launches counted; plain calls 0);
 23. H.264 through the six kernels of csrc/h264.cu (the parse; the
     reconstruction's h264_mv_kernel, h264_inter_kernel, h264_intra_kernel;
     the deblocking filter's h264_bs_kernel, h264_filter_kernel): every
     committed form of tests/fixtures/h264_forms/ (python
     tests/make_h264_fixtures.py) equal to cv2's sha256 per frame on the
     card (count and order too), the refusals by name; each stage
     (h264_parse, h264_recon, h264_deblock) == its plain version bit for
     bit on every picture of eight small forms and on the 1024x2048 clip's
     first two (an I and a P picture); on those two, the stages' kernels
     before their redesign (baselines/h264_wave_per_thread.cu) == the new
     ones and both timed in turns, old, new, new, old, each kernel's device
     us beside its bound (h264_work); ``multi_demo --images`` on the
     13-frame 1024x2048 High CABAC clip (launches of each kernel counted,
     plain calls 0) and its ms per frame by stage;
 24. JSON lines with nvJPEG's record, phase 9's numbers, phase 11's, phase
     12's, phase 13's, phase 14's, phase 15's, phase 16's, phase 17's, phase 18's, phase 19's, phase 20's,
     phase 22's and 23's, the kernel results (the two TPU kernels' ports, the colour kernel, the three
     JPEG 2000 kernels, the three MPEG-4 kernels, the four AV1 kernels and the six H.264 kernels; each
     kernel's device, host, event and bound times at the main path's shapes, beside the baseline kernels'
     times from this run, and at phases 10, 11, 17, 19, 20, 22 and 23's shapes) and each phase's seconds
     with the script's total, then the result line, last.
Prints nothing on standard output and exits non-zero without a CUDA device.

    python3 chip_smoke.py --real-data-only   # phases 1, 2, 8 and 9 alone, no result line
    python3 chip_smoke.py --ssd-only         # phases 1, 2 and 10 alone, no result line
    python3 chip_smoke.py --options-only     # phases 1, 2 and 11 alone, no result line
    python3 chip_smoke.py --prepare-only     # phases 1, 2 and 12 alone, no result line
    python3 chip_smoke.py --export-only      # phases 1, 2 and 13 alone, no result line
    python3 chip_smoke.py --host-loaders-only   # phases 1, 2 and 14 alone, no result line
    python3 chip_smoke.py --jax-checkpoints-only   # phases 1, 2 and 15 alone, no result line
    python3 chip_smoke.py --video-only       # phases 1, 2 and 16 alone, no result line
    python3 chip_smoke.py --jpeg-forms-only  # phases 1, 2 and 17 alone, no result line
    python3 chip_smoke.py --image-formats-only  # phases 1, 2 and 18 alone, no result line
    python3 chip_smoke.py --jpeg2000-only    # phases 1, 2 and 19 alone, no result line
    python3 chip_smoke.py --mp4v-only        # phases 1, 2 and 20 alone, no result line
    python3 chip_smoke.py --text-only        # phases 1, 2 and 21 alone, no result line
    python3 chip_smoke.py --avif-only        # phases 1, 2 and 22 alone, no result line
    python3 chip_smoke.py --h264-only        # phases 1, 2 and 23 alone, no result line

"""

from __future__ import annotations

import dataclasses
import json
import logging
import shutil
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


def near_threshold_rows(rng, B, K, thr):
    """The unit box, then boxes [0, 0, w, h] with w * h within a few ulps of
    ``thr``: their IoU with the unit box is w * h / ((1 + w * h) - w * h),
    whose rounding decides ``iou >= thr``. One class, all valid."""
    w = rng.uniform(thr, 1.0, (B, K)).astype(np.float32)
    h = (np.float32(thr) / w).astype(np.float32)
    h = np.nextafter(h, np.float32(2.0) * rng.randint(0, 2, (B, K))).astype(np.float32)  # +- 1 ulp
    z = np.zeros_like(w)
    boxes = np.stack([z, z, w, h], -1)
    boxes[:, 0] = (0.0, 0.0, 1.0, 1.0)
    return boxes, np.zeros((B, K), np.float32), np.ones((B, K), bool)


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


# the CUDA kernels each wrapper launches, by (a part of) their names
NMS_KERNELS = ("nms_mask_kernel", "nms_scan_kernel", "nms_image_kernel")
MATCH_KERNELS = ("match_kernel", "match_topk_kernel", "match_greedy_kernel")
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s,
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the two kernels as they stood before their redesign for Hopper, built and
# timed beside the current ones on the same inputs (not on any path)
BASELINE_SOURCES = (ROOT / "baselines" / "nms_two_launch.cu", ROOT / "baselines" / "match_one_block.cu")
# the colour kernel before it took every sampling geometry, timed
# beside the current one on the same 4:2:0 planes
COLOUR_BASELINE = ROOT / "baselines" / "jpeg_colour_per_sample.cu"
# the H.264 reconstruction and deblocking kernels before their redesign (one
# block, a thread a macroblock), timed beside the current ones in phase 23
H264_BASELINE = ROOT / "baselines" / "h264_wave_per_thread.cu"
# the H.264 and MPEG-4 Part 2 parse kernels before their redesign (one
# thread a slice / a VOP), held equal to and timed beside the current ones
# in phases 23 and 20
H264_PARSE_BASELINE = ROOT / "baselines" / "h264_parse_per_thread.cu"
MP4V_PARSE_BASELINE = ROOT / "baselines" / "mp4v_parse_per_thread.cu"


def baseline_kernels(dev):
    """Bind the baseline kernels (``baselines/*.cu``) with ctypes, allocating
    as their wrappers did: returns (nms(boxes, ids, valid, thr) -> keep,
    match(iou, col_valid) -> (matched, match_gt, match_iou))."""
    import ctypes

    from dspnet_torch.ops import _build

    nms_lib, match_lib = (_build.load_library(src) for src in BASELINE_SOURCES)
    nms_lib.dspnet_nms_keep_mask.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                             ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    match_lib.dspnet_bipartite_match.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

    def nms(boxes, ids, valid, thr):
        B, K = valid.shape
        keep = torch.empty((B, K), dtype=torch.bool, device=dev)
        mask = torch.empty((B, K, -(-K // 64)), dtype=torch.int64, device=dev)  # u64 bits
        err = nms_lib.dspnet_nms_keep_mask(boxes.data_ptr(), ids.data_ptr(), valid.data_ptr(),
                                           mask.data_ptr(), keep.data_ptr(), B, K, thr, 0,
                                           torch.cuda.current_stream(dev).cuda_stream)
        _build.check(nms_lib, err, "baseline NMS kernel launch")
        return keep

    def match(iou, col_valid):
        B, A, L = iou.shape
        out = (torch.empty((B, A), dtype=torch.bool, device=dev),
               torch.empty((B, A), dtype=torch.int32, device=dev),
               torch.empty((B, A), dtype=torch.float32, device=dev))
        err = match_lib.dspnet_bipartite_match(iou.data_ptr(), col_valid.data_ptr(),
                                               *(t.data_ptr() for t in out), B, A, L,
                                               torch.cuda.current_stream(dev).cuda_stream)
        _build.check(match_lib, err, "baseline matcher kernel launch")
        return out

    return nms, match


def colour_baseline(dev):
    """Bind the colour kernel's baseline (``baselines/jpeg_colour_per_sample.cu``):
    returns colour(y, cb, cr, out), 4:2:0 YCbCr planes to BGR."""
    import ctypes

    from dspnet_torch.ops import _build

    lib = _build.load_library(COLOUR_BASELINE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dspnet_jpeg_ycc_to_bgr.argtypes = [vp, i, vp, vp, i, vp, i, i, i, i, i, i, i, i, i, vp, vp]

    def colour(y, cb, cr, out):
        H, W = y.shape
        err = lib.dspnet_jpeg_ycc_to_bgr(y.data_ptr(), y.stride(0), cb.data_ptr(), cr.data_ptr(), cb.stride(0),
                                         y.data_ptr(), y.stride(0), 1, H, W, cb.shape[0], cb.shape[1], 2, 2, 0,
                                         out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, err, "baseline colour kernel launch")
        return out

    return colour


def h264_baseline(dev):
    """Bind the H.264 kernels before their redesign
    (``baselines/h264_wave_per_thread.cu``), with the inputs and outputs the
    wrapper of the time gave them: returns (recon_launches, deblock_launches)
    with the arguments of ``h264_cuda.recon_launches`` / ``deblock_launches``
    and their results (the outputs and [(kernel, launch)]; one launch a
    stage)."""
    import ctypes

    from dspnet_torch.data import h264_cuda
    from dspnet_torch.ops import _build

    lib = _build.load_library(H264_BASELINE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dspnet_h264_recon.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp, vp, vp, i, i, vp, vp, vp, vp, vp, vp, vp]
    lib.dspnet_h264_deblock.argtypes = [vp, vp, vp, vp, vp, i, i, i, vp, vp, vp, i, i, vp]

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def recon_launches(table, levels, slices, sps, refs, col, poc):
        mbw, mbh = sps.mb_width, sps.mb_height
        ids = sorted(refs)
        ptrs = np.array([[refs[p].y.data_ptr(), refs[p].u.data_ptr(), refs[p].v.data_ptr()] for p in ids]
                        or [[0, 0, 0]], np.int64)
        rec, refptr = h264_cuda._upload([h264_cuda.slice_records(slices, {p: k for k, p in enumerate(ids)}, poc),
                                         ptrs], dev)
        y = torch.empty(16 * mbh, 16 * mbw, dtype=torch.uint8, device=dev)
        u, v = (torch.empty(8 * mbh, 8 * mbw, dtype=torch.uint8, device=dev) for _ in range(2))
        mv = torch.zeros(2, 4 * mbh, 4 * mbw, 2, dtype=torch.int32, device=dev)
        ref = torch.full((2, 4 * mbh, 4 * mbw), -1, dtype=torch.int32, device=dev)
        rid = torch.full((2, 4 * mbh, 4 * mbw), -1, dtype=torch.int32, device=dev)
        tab, lev = table[:mbw * mbh].contiguous(), levels[:mbw * mbh].contiguous()
        cm = (col.mv.data_ptr(), col.ref.data_ptr(), col.ref_id.data_ptr()) if col is not None else (0, 0, 0)

        def launch():
            err = lib.dspnet_h264_recon(tab.data_ptr(), lev.data_ptr(), rec.data_ptr(), refptr.data_ptr(),
                                        h264_cuda._tables(dev).data_ptr(), mbw, mbh, 1, poc, y.data_ptr(),
                                        u.data_ptr(), v.data_ptr(), 16 * mbw, 8 * mbw, mv.data_ptr(), ref.data_ptr(),
                                        rid.data_ptr(), *cm, stream())
            _build.check(lib, err, "baseline h264_recon_kernel")

        return (y, u, v, h264_cuda.CardMotion(mv, ref, rid, (rec, refptr, refs))), [("h264_recon_kernel", launch)]

    def deblock_launches(y, u, v, table, mf, slices, sps):
        mbw, mbh = sps.mb_width, sps.mb_height
        tab = table[:mbw * mbh].contiguous()

        def launch():
            err = lib.dspnet_h264_deblock(tab.data_ptr(), mf.records[0].data_ptr(), mf.mv.data_ptr(),
                                          mf.ref_id.data_ptr(), h264_cuda._tables(dev).data_ptr(), mbw, mbh, 1,
                                          y.data_ptr(), u.data_ptr(), v.data_ptr(), 16 * mbw, 8 * mbw, stream())
            _build.check(lib, err, "baseline h264_deblock_kernel")

        return [("h264_deblock_kernel", launch)]

    return recon_launches, deblock_launches


def h264_parse_baseline(dev):
    """Bind the H.264 parse kernel before its redesign
    (``baselines/h264_parse_per_thread.cu``) with the inputs and outputs its
    wrapper gave it: returns parse_launches(jobs, n_pictures) with the
    results of ``h264_cuda.parse_launches`` ((table, levels, scratch,
    status), [(kernel, launch)])."""
    import ctypes

    from dspnet_torch.data import h264_cuda
    from dspnet_torch.data import h264_parse as HP
    from dspnet_torch.ops import _build

    lib = _build.load_library(H264_PARSE_BASELINE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dspnet_h264_parse.argtypes = [vp, vp, i, vp, vp, vp, vp, i, vp, vp]

    def parse_launches(jobs, n_pictures):
        bits, table = h264_cuda.stage(jobs, dev)
        n = max(s.mb_width * s.mb_height for _, s in jobs)
        tab = torch.zeros(n_pictures, n, HP.N_FIELDS, dtype=torch.int32, device=dev)
        lev = torch.zeros(n_pictures, n, HP.N_LEVELS, dtype=torch.int16, device=dev)
        scratch = torch.zeros(n_pictures, n, h264_cuda.N_SCRATCH, dtype=torch.uint8, device=dev)
        status = torch.zeros(len(jobs), 2, dtype=torch.int32, device=dev)

        def launch(kept=(bits, table)):
            err = lib.dspnet_h264_parse(bits.data_ptr(), table.data_ptr(), len(jobs),
                                        h264_cuda._tables(dev).data_ptr(), tab.data_ptr(), lev.data_ptr(),
                                        scratch.data_ptr(), n, status.data_ptr(),
                                        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
            _build.check(lib, err, "baseline h264_parse_kernel")

        return (tab, lev, scratch, status), [("h264_parse_kernel", launch)]

    return parse_launches


def mp4v_parse_baseline(dev):
    """Bind the MPEG-4 parse kernel before its redesign
    (``baselines/mp4v_parse_per_thread.cu``) with the inputs its wrapper gave
    it (int32 lookup tables; a per-VOP scratch region of the whole VOP's
    prediction state, DC 1024 and the rest 0): returns
    parse_launches(bits, vops, vol) -> ((mb, levels, status), [(kernel,
    launch)], prepare), ``prepare`` refilling the scratch before a launch."""
    import ctypes

    from dspnet_torch.data import mpeg4, mpeg4_cuda
    from dspnet_torch.ops import _build

    lib = _build.load_library(MP4V_PARSE_BASELINE)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dspnet_mp4v_parse.argtypes = [vp, vp, i, vp, vp, vp, i, i, i, i, vp, i, vp, vp, vp, vp]
    lut = torch.from_numpy(mpeg4.luts().ravel().astype(np.int32)).to(dev)
    rll = torch.tensor([(last << 16) | (run << 8) | level for table in (mpeg4.INTRA_RLL, mpeg4.INTER_RLL)
                        for last, run, level in table], dtype=torch.int32, device=dev)

    def parse_launches(bits, vops, vol):
        maxes = mpeg4_cuda._tables(dev)[2]
        nvop, n = len(vops), vol.mb_num
        luma = (2 * vol.mb_width + 1) * (2 * vol.mb_height + 1)
        chroma = (vol.mb_width + 1) * (vol.mb_height + 1)
        words = luma + 2 * chroma + 8 * (luma + 2 * chroma) + 2 * (luma + 1) + n
        scratch = torch.empty(nvop, words, dtype=torch.int32, device=dev)
        mb = torch.zeros(nvop, n, 12, dtype=torch.int32, device=dev)
        levels = torch.zeros(nvop, n * 6, 64, dtype=torch.int16, device=dev)
        status = torch.zeros(nvop, 2, dtype=torch.int32, device=dev)

        def prepare():
            scratch.zero_()
            scratch[:, :luma + 2 * chroma] = 1024

        def launch(kept=(bits, vops)):
            err = lib.dspnet_mp4v_parse(bits.data_ptr(), vops.data_ptr(), nvop, lut.data_ptr(), rll.data_ptr(),
                                        maxes.data_ptr(), vol.mb_width, vol.mb_height, vol.time_bits,
                                        int(vol.resync), scratch.data_ptr(), words, mb.data_ptr(), levels.data_ptr(),
                                        status.data_ptr(), ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
            _build.check(lib, err, "baseline mp4v_parse_kernel")

        prepare()
        return (mb, levels, status), [("mp4v_parse_kernel", launch)], prepare

    return parse_launches


def parse_turns(new, old, old_prepare=None, rounds=2):
    """Device us of the new and the old parse launch on the same inputs in
    turns (old, new, new, old), CUDA events around each launch, the mean of
    ``rounds`` after one to warm up -> (new [us, us], old [us, us])."""
    out = {"new": [], "old": []}
    for which in ("old", "new", "new", "old"):
        launches, prepare = (new, None) if which == "new" else (old, old_prepare)
        out[which].append(sum(h264_launch_us(launches, prepare, n=rounds).values()))
    return out["new"], out["old"]


def bound_us(nbytes, ops):
    """The least time the card could take: (us, the limiting term)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e6, ops / F32_OPS_PER_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_times(fn, names, n=200, n_prof=100):
    """A wrapper's time per call, device and host apart:
    device_us -- the device time of the kernels named ``names`` under
      torch.profiler over ``n_prof`` calls after warm-up, per call: each
      kernel's mean over the launches the profiler recorded, summed (events
      around single launches queued behind a sleep kernel, so the host is
      ahead, where the profiler shows no device time);
    host_us  -- the wrapper's host time per call, host clock over ``n`` calls
      with no synchronize inside;
    event_ms -- CUDA events around ``n`` back-to-back calls, per call (device
      or host time, whichever is longer)."""
    from torch.profiler import ProfilerActivity, profile

    event_ms = cuda_ms(fn, n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            fn()
        torch.cuda.synchronize()
    seen = {}
    for evt in prof.events():
        key = next((k for k in names if k in evt.name), None)
        if evt.device_type == torch.autograd.DeviceType.CUDA and key is not None:
            us, c = seen.get(key, (0.0, 0))
            seen[key] = (us + evt.device_time, c + 1)
    # each named kernel runs once per call: its mean over the launches the
    # profiler kept (it can drop events from a long window)
    device_us = sum(us / c for us, c in seen.values())
    how = "torch.profiler"
    if device_us <= 0.0:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        total = 0.0
        for _ in range(n_prof):
            torch.cuda._sleep(200_000)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        device_us, how = total / n_prof * 1e3, "events around one launch behind a sleep"
    per_kernel = ", ".join(f"{k} x{c / n_prof:g} recorded per call: {us / c:.3f} us" for k, (us, c) in seen.items())
    return {"device_us": device_us, "host_us": host_us, "event_ms": event_ms, "how": how,
            "per_kernel": per_kernel}


def print_times(what, t, plain_ms, bound, label):
    print(f"{what}: device {t['device_us']:.3f} us/call ({t['how']}; {t['per_kernel']}), host "
          f"{t['host_us']:.3f} us/call (wrapper, no synchronize), events {t['event_ms']:.4f} ms/call "
          f"(back to back), bound {bound[0]:.4f} us ({bound[1]}), plain {plain_ms:.4f} ms [{label}]",
          flush=True)


def with_baseline(t, t_old):
    """A kernel's times with its baseline's beside them (same inputs, same run)."""
    return dict(t, before_device_us=t_old["device_us"], before_host_us=t_old["host_us"],
                before_event_ms=t_old["event_ms"])


def corners(rng, *shape, lo=0.05, hi=0.3):
    cx, cy = rng.uniform(0.1, 0.9, (2, *shape))
    w, h = rng.uniform(lo, hi, (2, *shape))
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


def matcher_phase(dev, anchors_np, label, base_match):
    """Phase 5: the matcher kernel against the plain rounds, bit for bit, and
    both timed, with the baseline kernel ``base_match`` on the same inputs.
    Returns (max abs difference over every case, {shape: times})."""
    from dspnet_torch.ops import matching_cuda
    from dspnet_torch.ops.boxes import iou_matrix

    rng = np.random.RandomState(17)
    anchors = torch.from_numpy(anchors_np).to(dev)
    errs = []

    refilled = {}

    def compare(iou, col_valid, what):
        iou = iou.contiguous()
        refills = torch.zeros(iou.shape[0], dtype=torch.int32, device=dev)
        got = matching_cuda.bipartite_match(iou, col_valid, refills=refills)
        want = matching_cuda.bipartite_match_reference(iou, col_valid)
        torch.cuda.synchronize()
        errs.append(max(float((got[1] - want[1]).abs().max()), float((got[2] - want[2]).abs().max()),
                        float((got[0].int() - want[0].int()).abs().max())))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"matcher kernel != plain at {what}: {int((got[1] != want[1]).sum())} anchors differ")
        refilled[what] = refills.tolist()
        return got

    def gts(B, L):
        return torch.from_numpy(corners(rng, B, L, lo=0.1, hi=0.4)).to(dev)

    def crowded(B, L):
        """GT boxes jittered around one centre per image: their columns share
        their best anchors, so the columns' top-T lists run out."""
        c = rng.uniform(0.35, 0.65, (B, 1, 2)) + rng.normal(0.0, 0.02, (B, L, 2))
        wh = rng.uniform(0.15, 0.3, (B, L, 2))
        return torch.from_numpy(np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)).to(dev)

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
        # crowded GTs: heavy overlap, the columns' lists run out
        for n in (50, 200):
            col_valid = torch.zeros(B, L, dtype=torch.bool, device=dev)
            col_valid[:, :n] = True
            compare(iou_matrix(anchors, crowded(B, L)), col_valid, f"B={B} {n} crowded GTs")
    # GTs equal to anchors, each one twice: IoU 1 ties between duplicate columns
    idx = torch.from_numpy(rng.randint(0, anchors.shape[0], (2, L // 2))).to(dev)
    boxes = anchors[idx].repeat(1, 2, 1)
    compare(iou_matrix(anchors, boxes), torch.ones(2, L, dtype=torch.bool, device=dev),
            "GTs equal to anchors, duplicated")
    # one GT box 200 times over: every column's top-T list runs out
    boxes = gts(1, 1).repeat(1, L, 1)
    compare(iou_matrix(anchors, boxes), torch.ones(1, L, dtype=torch.bool, device=dev),
            "one GT repeated 200 times")
    big = torch.from_numpy(corners(rng, 24576)).to(dev)
    for n in (9, 200):
        col_valid = torch.zeros(1, L, dtype=torch.bool, device=dev)
        col_valid[:, :n] = True
        compare(iou_matrix(big, gts(1, L)), col_valid, f"B=1 A=24576 num_gt={n}")
    print(f"matcher kernel vs plain: {len(errs)} cases equal bit for bit (torch.equal on matched, "
          f"match_gt and match_iou), A = 12,264 and 24,576; plan at B=8 A=12264 L=200: "
          f"{matching_cuda.launch_plan(8, 12264, L)}")
    print("matcher columns refilled from device memory (their top-T list ran out), per image: "
          + "; ".join(f"{k}: {v}" for k, v in refilled.items()))

    # the train step's shapes (8 valid GTs of 200), every column valid, and
    # the crowded cases where lists run out; each beside the baseline kernel
    times = {}
    for what, B, boxes, n_gt, n in (("num_gt=8", 4, gts(4, L), 8, 100), ("num_gt=8", 8, gts(8, L), 8, 100),
                                    ("num_gt=200", 8, gts(8, L), L, 100),
                                    ("one GT x200", 1, gts(1, 1).repeat(1, L, 1), L, 20),
                                    ("50 crowded GTs", 8, crowded(8, L), 50, 20)):
        iou = iou_matrix(anchors, boxes).contiguous()
        col_valid = torch.zeros(B, L, dtype=torch.bool, device=dev)
        col_valid[:, :n_gt] = True
        A = iou.shape[1]
        key = f"B={B} A={A} {what}"
        refills = torch.zeros(B, dtype=torch.int32, device=dev)
        got = matching_cuda.bipartite_match(iou, col_valid, refills=refills)
        check(all(torch.equal(g, o) for g, o in zip(got, base_match(iou, col_valid))),
              f"matcher kernel != baseline kernel at {key}")
        t = kernel_times(lambda: matching_cuda.bipartite_match(iou, col_valid), MATCH_KERNELS, n=n, n_prof=n)
        t_old = kernel_times(lambda: base_match(iou, col_valid), MATCH_KERNELS, n=n, n_prof=n)
        p_ms = cuda_ms(lambda: matching_cuda.bipartite_match_reference(iou, col_valid), 10)
        # the valid columns of iou read once, col_valid, the three outputs written once
        bound = bound_us(B * A * n_gt * 4 + B * L + B * A * (1 + 4 + 4), 0)
        times[key] = dict(with_baseline(t, t_old), plain_ms=p_ms, bound_us=bound[0], bound_by=bound[1],
                          refills=refills.tolist())
        print_times(f"bipartite_match {key} (refills per image {refills.tolist()})", t, p_ms, bound, label)
        print_times(f"bipartite_match {key}, baseline kernel", t_old, p_ms, bound, label)
    return max(errs), times


def training_phase(dev, label):
    """Phase 6: the resnet-50_multi training step. Returns the matcher
    launches counted over the timed steps (one per step) and the img/s of
    the timed steps by batch size."""
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
    ips = {}
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
        ips[b] = b / dt
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
        net = create_model("resnet-18_multi", (128, 256), num_classes=NUM_CLASSES, device=device,
                           generator=torch.Generator().manual_seed(5))
        solver = MultiTaskSolver(net.model, net.anchors, batch_size=2,
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
    return launches, ips


def cli_phase(dev, label, resident_ips):
    """Phase 7: the training and eval CLIs at full width. Returns
    {kernel: launches} over the three CLI runs."""
    import logging
    import shutil
    import tempfile

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import multi_eval, multi_train
    from dspnet_torch.data import jpeg_cuda, synthetic
    from dspnet_torch.data.device_pipeline import DeviceAugIterator, device_augment_batch
    from dspnet_torch.evaluate import cityscapes_eval
    from dspnet_torch.evaluate.loop import evaluate_model
    from dspnet_torch.ops import matching_cuda, nms_cuda
    from dspnet_torch.train.solver import MultiTaskSolver, TrainState
    from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix

    B, n_train, n_val, n_time = 4, 16, 8, 64
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=ROOT / "build"))
    synth, model, jsonl = work / "synth", work / "model", work / "metrics.jsonl"
    net = ["--network", "resnet-50_multi", "--data-shape", f"3,{H},{W}", "--num-classes", str(NUM_CLASSES),
           "--batch-size", str(B), "--device", "cuda"]
    train_args = net + ["--synthetic", str(n_train), "--synthetic-val", str(n_val), "--synthetic-dir",
                        str(synth), "--model-dir", str(model), "--compute-dtype", "bfloat16",
                        "--seg-normalize", "valid", "--lr", "5e-4", "--eval-every", "1",
                        "--checkpoint-every", "1", "--metrics-jsonl", str(jsonl), "--log-every", "1"]
    launches = {"nms_keep_mask": 0, "bipartite_match": 0}

    def counted(run, steps, eval_batches, what):
        nms_cuda.launches = matching_cuda.launches = 0
        out = run()
        torch.cuda.synchronize()
        got = {"bipartite_match": matching_cuda.launches, "nms_keep_mask": nms_cuda.launches}
        check(got == {"bipartite_match": steps, "nms_keep_mask": eval_batches},
              f"{what}: launches {got}, expected {steps} matcher (train steps) and {eval_batches} NMS "
              "(eval batches)")
        print(f"{what}: matcher launched {got['bipartite_match']} times in {steps} train steps, NMS "
              f"{got['nms_keep_mask']} times in {eval_batches} eval batches")
        for k, v in got.items():
            launches[k] += v
        return out

    try:
        # the CLI's dataset (it writes the same files again from the same seeds)
        t0 = time.perf_counter()
        train_index = synthetic.build_dataset(str(synth / "train"), n_train, (H, W), seed=233)
        synthetic.build_dataset(str(synth / "val"), n_val, (H, W), seed=91)
        write_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in synth.rglob("*") if f.is_file())
        print(f"dataset write: {n_train}+{n_val} images {H}x{W} (JPEG image, PNG seg and disparity) in "
              f"{write_s:.3f} s, {size / 2**20:.1f} MiB [{label}]")

        # one augmented batch on the card against the same batch on the CPU:
        # the augmentation on the same raw batch (nvJPEG's decode, copied to
        # the host), then the loaders end to end (nvJPEG against the plain
        # decoder, within the decode gate)
        loader = DeviceAugIterator(train_index, B, (H, W), device=dev, seed=233, enable_aug=True)
        loader.reset()
        gen = loader._raw_batches()
        raw = next(gen)
        gen.close()
        card_raw = raw["raw"].place_on(dev)
        torch.cuda.synchronize()
        args = [raw["segs"], raw["labels"], raw["params"]]
        card = device_augment_batch(card_raw, *[torch.from_numpy(a).to(dev) for a in args], loader.lut, (H, W))
        cpu = device_augment_batch(card_raw.cpu(), *[torch.from_numpy(a) for a in args], loader.lut.cpu(), (H, W))
        check(card["images"].device.type == "cuda", "the pipeline's batch is not on the card")
        box_err = float((card["label_det"].cpu() - cpu["label_det"]).abs().max())
        img_err = float((card["images"].cpu() - cpu["images"]).abs().max())
        seg_diff = int((card["seg_label"].cpu() != cpu["seg_label"]).sum())
        print(f"device_augment_batch b{B} {H}x{W} with augmentation on the same raw batch, card vs cpu: boxes "
              f"max abs err {box_err:.3e} (tolerance 1e-5), seg maps {seg_diff} differing pixels of "
              f"{cpu['seg_label'].numel()} (bound 0), images max abs err {img_err:.3e} (tolerance 1e-3)")
        check(box_err <= 1e-5 and seg_diff == 0 and img_err <= 1e-3, "pipeline card batch != cpu batch")
        batches = {}
        for d in (dev, "cpu"):
            it = DeviceAugIterator(train_index, B, (H, W), device=d, seed=233, enable_aug=True)
            batches[str(d)], _ = next(it.epoch())
        gap = float((batches[str(dev)]["images"].cpu() - batches["cpu"]["images"]).abs().mean())
        print(f"DeviceAugIterator b{B} end to end, card (nvJPEG) vs cpu (plain decoder): images mean abs "
              f"difference {gap:.4f} (gate {jpeg_cuda.GATES['420']})")
        check(gap <= jpeg_cuda.GATES["420"], "card loader batch differs from the cpu loader's beyond the gate")
        del batches, card, cpu, card_raw, loader

        # train 2 epochs with a validation pass and a checkpoint after each
        steps = n_train // B
        val_batches = -(-n_val // B)
        state = counted(lambda: multi_train.main(train_args + ["--end-epoch", "2"]), 2 * steps,
                        2 * val_batches, "multi_train --end-epoch 2")
        rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
        val = [r for r in rows if r["split"] == "val"]
        check([r["epoch"] for r in val] == [0, 1], f"val lines {[(r['epoch'], r['split']) for r in rows]}")
        for r in val:
            for k in ("mAP", "mIoU", "accuracy"):
                check(k in r and np.isfinite(r[k]) and 0.0 <= r[k] <= 1.0, f"val epoch {r['epoch']} {k}")
            print(f"epoch {r['epoch']} val: mAP {r['mAP']:.6f}, mIoU {r['mIoU']:.6f}, accuracy "
                  f"{r['accuracy']:.6f}, derror {r.get('derror', float('nan')):.6f}, ms_per_batch "
                  f"{r['ms_per_batch']:.3f}")
        mgr = CheckpointManager(checkpoint_prefix(str(model), "resnet-50_multi", H))
        check(mgr.epochs() == [0, 1] and state.step == 2 * steps, f"checkpoints {mgr.epochs()}, step {state.step}")

        # resume: the restored tensors equal the state saved at epoch 1
        template = TrainState(0, *({k: torch.empty_like(v) for k, v in getattr(state, g).items()}
                                   for g in ("params", "buffers", "momentum")))
        restored, ep = mgr.restore(None, template)
        check(ep == 1 and restored.step == 2 * steps, f"restored epoch {ep} step {restored.step}")
        for g in ("params", "buffers", "momentum"):
            for k, v in getattr(state, g).items():
                check(torch.equal(getattr(restored, g)[k], v.detach()), f"restored {g} {k} != saved")
        print(f"restore of epoch 1: {sum(len(getattr(state, g)) for g in ('params', 'buffers', 'momentum'))} "
              f"tensors equal to the trained state bit for bit, step {restored.step}")
        del template, restored
        seen = []
        handler = logging.Handler()
        handler.emit = lambda record: seen.append(record.getMessage())
        logging.getLogger().addHandler(handler)
        try:
            state = counted(lambda: multi_train.main(train_args + ["--end-epoch", "3", "--resume", "0"]),
                            steps, val_batches, "multi_train --resume 0 --end-epoch 3")
        finally:
            logging.getLogger().removeHandler(handler)
        check(f"resumed from epoch 1 (step {2 * steps})" in seen, "the resumed run did not start from epoch 1")
        new = [json.loads(line) for line in jsonl.read_text().splitlines()][len(rows):]
        check([(r["epoch"], r["split"]) for r in new] == [(2, "train"), (2, "val")],
              f"resumed run rows {[(r['epoch'], r['split']) for r in new]}")
        check(state.step == 3 * steps and mgr.epochs() == [0, 1, 2], f"step {state.step}, {mgr.epochs()}")
        print(f"resumed at epoch 2 from step {2 * steps}; ended at step {state.step}; checkpoints {mgr.epochs()}")
        del state

        # eval CLI on the latest checkpoint; its device confusion matrix
        # against a host bincount of the same seg maps
        add = cityscapes_eval.add_to_confusion_matrix_torch
        pairs, confs = [], []

        def recording(pred, gt, conf):
            pairs.append((pred.cpu().numpy(), gt.cpu().numpy()))
            confs.append(add(pred, gt, conf))
            return confs[-1]

        cityscapes_eval.add_to_confusion_matrix_torch = recording
        try:
            res = counted(lambda: multi_eval.main(net + ["--synthetic", str(n_val), "--synthetic-dir", str(synth),
                                                         "--model-dir", str(model)]),
                          0, val_batches, "multi_eval (latest checkpoint)")
        finally:
            cityscapes_eval.add_to_confusion_matrix_torch = add
        host = np.zeros((256, 256), np.int64)
        for pred, gt in pairs:
            cityscapes_eval.add_to_confusion_matrix(pred, gt, host)
        conf = confs[-1].cpu().numpy()
        check(len(pairs) == val_batches and np.array_equal(conf, host),
              "device confusion matrix != host np.bincount")
        print(f"multi_eval: device confusion matrix == host np.bincount of the same {int(host.sum())} seg "
              f"pixels (exact); mAP {res['mAP']:.6f}, mIoU {res['mIoU']:.6f}, accuracy {res['accuracy']:.6f}, "
              f"ms_per_batch {res['ms_per_batch']:.3f} [{label}]")
        check(all(np.isfinite(res[k]) for k in ("mAP", "mIoU", "accuracy", "ms_per_batch")), "eval results")

        # Timings, at a depth that amortises an epoch's start: 64 train images
        # (16 steps an epoch) and 64 val images (16 eval batches, 15 timed);
        # the 16 / 8 images above only drive the functional checks.
        t0 = time.perf_counter()
        time_train = synthetic.build_dataset(str(work / "time_train"), n_time, (H, W), seed=233)
        time_val = synthetic.build_dataset(str(work / "time_val"), n_time, (H, W), seed=91)
        print(f"dataset write: {n_time}+{n_time} images {H}x{W} in {time.perf_counter() - t0:.3f} s [{label}]")

        # loader-fed vs resident-batch training through the same fit loop; each
        # turn starts from the same weights (fit updates the state in place)
        bundle = create_model("resnet-50_multi", (H, W), num_classes=NUM_CLASSES, device=dev,
                              generator=torch.Generator().manual_seed(233))
        solver = MultiTaskSolver(bundle.model, bundle.anchors, learning_rate=5e-4, batch_size=B,
                                 seg_normalize="valid", compute_dtype="bfloat16", device=dev)
        st = solver.init_state()
        init = TrainState(0, *({k: v.detach().clone() for k, v in getattr(st, g).items()}
                               for g in ("params", "buffers", "momentum")))

        def fit_ips(batches, epochs):
            """img/s of ``solver.fit`` from the initial weights, host clock
            ending in a synchronize."""
            st.step = 0
            with torch.no_grad():
                for g in ("params", "buffers", "momentum"):
                    for k, v in getattr(st, g).items():
                        v.copy_(getattr(init, g)[k])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.fit(st, batches, num_epochs=epochs, eval_every=0, log_every=10**9, log_fn=lambda *_: None)
            torch.cuda.synchronize()
            return n_time * epochs / (time.perf_counter() - t0)

        loader = DeviceAugIterator(time_train, B, (H, W), device=dev, seed=233, enable_aug=True, num_threads=8)
        resident = [b for b, _ in loader.epoch()]
        # the loader's raw batches decoded once, held pinned on the host: each
        # pass copies and augments them on the consumer's thread, with no
        # decode thread (splits decode from the copy + augmentation)
        loader.reset()
        pinned = [{k: (r[k].place_on(dev).cpu() if k == "raw" else torch.from_numpy(r[k])).pin_memory()
                   for k in ("raw", "segs", "labels", "params")} for r in loader._raw_batches()]

        class Decoded:
            def __iter__(self):
                for r in pinned:
                    x = {k: v.to(dev, non_blocking=True) for k, v in r.items()}
                    yield device_augment_batch(x["raw"], x["segs"], x["labels"], x["params"], loader.lut,
                                               (H, W), mean_pixels=loader.mean_pixels)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            for b in loader:
                pass
        torch.cuda.synchronize()
        alone = 2 * n_time / (time.perf_counter() - t0)
        fit_ips(resident, 1)  # warm-up
        r1, l1, d1, d2, l2, r2 = (fit_ips(x, 2) for x in (resident, loader, Decoded(), Decoded(), loader, resident))
        steps_t = n_time // B
        print(f"train b{B} {H}x{W} bf16 through fit, 2 epochs of {steps_t} steps from the same weights: "
              f"loader-fed (DeviceAugIterator: decode + prefetch + on-device augmentation) {l1:.2f} / "
              f"{l2:.2f} img/s, decoded ahead (copy + on-device augmentation, no decode thread) "
              f"{d1:.2f} / {d2:.2f} img/s, resident batches {r1:.2f} / {r2:.2f} img/s (order resident, "
              f"loader, decoded, decoded, loader, resident); loader-fed / resident "
              f"{(l1 + l2) / (r1 + r2):.3f}, decoded ahead / resident {(d1 + d2) / (r1 + r2):.3f}; the "
              f"loader alone (2 epochs, no step) {alone:.2f} img/s; phase 6 resident canonical batch "
              f"{resident_ips:.2f} img/s [{label}]")
        del resident, loader, pinned

        # eval: evaluate_model with fit's validation detector (float32, NMS
        # 0.5) fed by the loader, then over the same batches held on the card
        # (the difference is the loader), then the detector's predict alone
        # on them (the rest is the host's metric math and the copies)
        detector = solver.make_detector(st, (H, W))
        val_it = DeviceAugIterator(time_val, B, (H, W), device=dev, seed=233, enable_aug=False,
                                   shuffle=False, pad_last=True, num_threads=8)
        eval_ms = [evaluate_model(detector, val_it)["ms_per_batch"] for _ in range(2)]
        held = list(val_it.epoch())

        class Held:
            def epoch(self):
                return iter(held)

        held_ms = [evaluate_model(detector, Held())["ms_per_batch"] for _ in range(2)]
        with torch.inference_mode():
            detector.predict(held[0][0]["images"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for batch, _ in held[1:]:
                detector.predict(batch["images"])
            torch.cuda.synchronize()
        predict_ms = (time.perf_counter() - t0) * 1e3 / (len(held) - 1)
        print(f"eval b{B} {H}x{W} float32 detector, {n_time} images ({len(held)} batches, the first "
              f"excluded): evaluate_model ms_per_batch loader-fed {eval_ms[0]:.3f} / {eval_ms[1]:.3f}, "
              f"on the same batches held on the card {held_ms[0]:.3f} / {held_ms[1]:.3f}; "
              f"detector.predict alone on the held batches {predict_ms:.3f} ms per batch [{label}]")
        del detector, held, val_it

        # checkpoint save: async snapshot, background write, blocking write
        ck = CheckpointManager(str(work / "ckbench"))
        t0 = time.perf_counter()
        ck.save(0, st, block=False)
        snap_ms = (time.perf_counter() - t0) * 1e3
        ck.latest_epoch()  # joins the background write
        async_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ck.save(1, st, block=True)
        block_ms = (time.perf_counter() - t0) * 1e3
        mib = Path(ck.path(1)).stat().st_size / 2**20
        print(f"checkpoint save resnet-50_multi (params + buffers + momentum, f32): async snapshot "
              f"{snap_ms:.1f} ms, snapshot + background write {async_ms:.1f} ms, blocking write "
              f"{block_ms:.1f} ms, {mib:.1f} MiB per file [{label}]")
        del solver, st, bundle
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    sys.stdout.flush()
    return launches


def decode_times(fn, n=20):
    """A decode call: host ms per call (the wrapper returns once the decode
    has finished), and device us per call by torch.profiler (every kernel
    and copy on the card in the window)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return host_ms, sum(e.device_time for e in cuda) / 5


GATE_SIZES = ((1024, 2048), (256, 512), (64, 128), (37, 53))
COLOR_KERNELS = ("ycc_to_bgr_kernel",)


def exif_app1(orientation):
    """An APP1 Exif segment whose IFD0 holds one Orientation entry."""
    tiff = (b"MM\x00\x2a" + (8).to_bytes(4, "big") + (1).to_bytes(2, "big") + bytes.fromhex("0112000300000001")
            + orientation.to_bytes(2, "big") + bytes(6))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + (len(body) + 2).to_bytes(2, "big") + body


def decode_checks(jpeg_cuda, jpeg, data, dev, raw_hw, B, label):
    """Phase 8's decoder checks on every gate case (4:2:0, 4:2:2, 4:4:4 and
    gray at each of GATE_SIZES): the colour kernel on nvJPEG's planes
    against its plain version, bit for bit, and the card's pixels against
    the plain decoder's within ``jpeg_cuda.GATES``; a progressive file and
    an Exif orientation; the kernel's device us beside its bound; nvJPEG's
    planar route against its interleaved output (before the repair), timed
    in turns; the per-route counts. Returns the decoder's record."""
    from dspnet_torch.data import synthetic

    record = {"gates": {}, "colour_max_abs_err": 0}
    t0 = time.perf_counter()
    plain = [jpeg.decode(d) for d in data[:2]]
    record["plain_ms"] = (time.perf_counter() - t0) / 2 * 1e3
    rng = np.random.RandomState(8)
    cases = 0
    for hw in GATE_SIZES:
        scenes = plain[:1] if hw == raw_hw else [synthetic.make_example(rng, hw, 4)[0] for _ in range(2)]
        for sub in ("420", "422", "444", "gray"):
            if hw == raw_hw and sub == "420":
                batch, want = data[:2], plain
            else:
                batch = [jpeg.encode(im[..., 1] if sub == "gray" else im, 95, "444" if sub == "gray" else sub)
                         for im in scenes]
                want = [jpeg.decode(x) for x in batch]
            want = np.stack([np.repeat(w[..., None], 3, -1) if w.ndim == 2 else w for w in want])
            for planes, info in jpeg_cuda.decode_planes(batch, dev):
                got = jpeg_cuda.ycc_to_bgr(*planes, factors=info.factors)
                ref = jpeg_cuda.ycc_to_bgr_reference(*planes, factors=info.factors)
                torch.cuda.synchronize()
                err = (got.int() - ref.int()).abs().max().item()
                record["colour_max_abs_err"] = max(record["colour_max_abs_err"], err)
                check(err == 0, f"colour kernel != its plain version at {sub} {hw}: max |difference| {err}")
                cases += 1
            diff = jpeg_cuda.difference(jpeg_cuda.decode_batch(batch, dev).cpu().numpy(), want)
            record["gates"][f"{sub} {hw[0]}x{hw[1]}"] = diff
            print(f"card (nvJPEG planes + colour kernel) vs plain decoder, {len(batch)} q95 {sub} {hw[0]}x{hw[1]}: "
                  f"mean abs {diff['mean']:.4f} (gate {jpeg_cuda.GATES[sub]}), max {diff['max']}, "
                  f"{diff['over2']:.4%} of values more than 2 levels apart")
            check(diff["mean"] <= jpeg_cuda.GATES[sub], f"card decode {sub} {hw} outside its gate")
    print(f"colour kernel vs plain colour function on nvJPEG's planes: {cases} images, max |difference| "
          f"{record['colour_max_abs_err']}, 4:2:0 / 4:2:2 / 4:4:4 / gray at {', '.join(f'{h}x{w}' for h, w in GATE_SIZES)}")

    # a progressive file (the single-image route) with the same coefficients
    # as a baseline one; an Exif orientation turns the card's image
    same, prog = jpeg.encode(plain[0], 95), jpeg.encode(plain[0], 95, progressive=True)
    before = dict(jpeg_cuda.routes)
    got_base, got_prog = jpeg_cuda.decode_images([same, prog], dev)
    check(jpeg_cuda.routes["single_progressive"] == before["single_progressive"] + 1, "progressive route count")
    diff = jpeg_cuda.difference(got_prog.cpu().numpy(), jpeg.decode(same))
    print(f"progressive {raw_hw[0]}x{raw_hw[1]} 4:2:0 (nvjpegDecode, one image): equal to the baseline file's "
          f"card decode: {torch.equal(got_base, got_prog)}; vs plain decoder of the baseline file mean "
          f"{diff['mean']:.4f} max {diff['max']}")
    check(diff["mean"] <= jpeg_cuda.GATES["420"], "progressive decode outside the 4:2:0 gate")
    turned = jpeg_cuda.decode_images([data[0][:2] + exif_app1(6) + data[0][2:]], dev)[0]
    check(turned.shape == (raw_hw[1], raw_hw[0], 3), f"Exif 6: shape {tuple(turned.shape)}")
    upright = jpeg_cuda.decode_images([data[0]], dev)[0]
    check(torch.equal(turned, jpeg.orient(upright, 6)), "Exif 6 on the card != the upright image turned")
    print(f"Exif orientation 6 on the card: {tuple(turned.shape)}, equal to the upright decode transposed and "
          "flipped left-right (cv2's rule)")
    record["progressive_equal_baseline"] = bool(torch.equal(got_base, got_prog))

    # the colour kernel alone at 1024x2048 4:2:0, beside its bound
    (planes, info), = jpeg_cuda.decode_planes(data[:1], dev)
    out = torch.empty((*raw_hw, 3), dtype=torch.uint8, device=dev)
    t = kernel_times(lambda: jpeg_cuda.ycc_to_bgr(*planes, factors=info.factors, out=out), COLOR_KERNELS)
    p_ms = cuda_ms(lambda: jpeg_cuda.ycc_to_bgr_reference(*planes, factors=info.factors), 10)
    Hh, Ww = raw_hw
    # Y and the two chroma planes read once, BGR written once; about 20
    # int32 operations a pixel, at half the float32 rate
    bound = bound_us(Hh * Ww + 2 * planes[1].numel() + 3 * Hh * Ww, 2 * 20 * Hh * Ww)
    print_times(f"ycc_to_bgr (colour kernel) {Hh}x{Ww} 4:2:0", t, p_ms, bound, label)
    record["colour_kernel"] = dict(t, plain_ms=p_ms, bound_us=bound[0], bound_by=bound[1], cases=cases)

    # nvJPEG per image: the planar route + colour kernel (the path) against
    # nvJPEG's interleaved output (before the repair; on no path), in turns
    planar = lambda: jpeg_cuda.decode_batch(data, dev)  # noqa: E731
    interleaved = lambda: jpeg_cuda.decode_batch_interleaved(data, dev)  # noqa: E731
    (a1, d1), (b1, e1), (b2, e2), (a2, d2) = (decode_times(f) for f in (planar, interleaved, interleaved, planar))
    print(f"decode b{B} {Hh}x{Ww} q95 4:2:0 per image: planar + colour kernel host {a1 * 1e3 / B:.1f} / "
          f"{a2 * 1e3 / B:.1f} us, device {d1 / B:.1f} / {d2 / B:.1f} us; nvJPEG interleaved (before) host "
          f"{b1 * 1e3 / B:.1f} / {b2 * 1e3 / B:.1f} us, device {e1 / B:.1f} / {e2 / B:.1f} us (order planar, "
          f"interleaved, interleaved, planar); plain decoder {record['plain_ms']:.1f} ms per image on the host "
          f"[{label}]")
    record["per_image"] = {"after_host_us": [a1 * 1e3 / B, a2 * 1e3 / B], "after_device_us": [d1 / B, d2 / B],
                           "before_host_us": [b1 * 1e3 / B, b2 * 1e3 / B], "before_device_us": [e1 / B, e2 / B]}
    record["backends"] = {}
    for name, backend in (("default", jpeg_cuda.BACKEND_DEFAULT), ("hardware", jpeg_cuda.BACKEND_HARDWARE)):
        if not jpeg_cuda.backend_available(backend, dev):
            record["backends"][name] = "not available (nvjpegCreateEx: architecture mismatch)"
            print(f"nvJPEG {name} backend: not available on this card (architecture mismatch)")
            continue
        host_ms, dev_us = decode_times(lambda: jpeg_cuda.decode_batch(data, dev, backend=backend))
        record["backends"][name] = {"host_ms_per_batch": host_ms, "device_us_per_batch": dev_us}
        print(f"nvJPEG {name} backend, b{B} {Hh}x{Ww} q95 4:2:0 (planar + colour kernel): wrapper host "
              f"{host_ms * 1e3 / B:.1f} us per image, device {dev_us / B:.1f} us per image [{label}]")
    record["routes"] = dict(jpeg_cuda.routes)
    print(f"nvJPEG routes so far (images): {record['routes']}; batched call refusing planar output: "
          f"{jpeg_cuda._refuses_planar or 'never'}")
    sys.stdout.flush()
    return record


def reference_weights_phase(dev, label, root, work, jpegs):
    """Phase 9: the reference's own weights in, served and fine-tuned, at
    resnet-50_multi 512x1024, full width: a reference-layout .params from
    seeded weights -> ``tools.import_mxnet`` (the state equal bit for bit) ->
    ``multi_demo`` (bf16) on 4 of phase 8's 1024x2048 JPEGs (the 2x area
    resize) and 2 images of other sizes (the fixed-point bilinear resize),
    timed by stage -> ``ServingPipeline`` (a CUDA graph per slot) at depths
    1, 2 and 4 against the synchronous ``predict_raw`` over 64 b1 frames,
    and ``update_weights`` between submits -> ``multi_train --resume``
    from the imported epoch with ``--monitor 2``. Returns {kernel: {path:
    launches}}."""
    import logging

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import multi_demo, multi_train
    from dspnet_torch.data import jpeg, jpeg_cuda, synthetic
    from dspnet_torch.data.device_pipeline import resize_linear
    from dspnet_torch.detect.pipeline import ServingPipeline
    from dspnet_torch.ops import matching_cuda, nms_cuda
    from dspnet_torch.tools import import_mxnet
    from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix
    from dspnet_torch.utils.convert import to_flax_variables
    from dspnet_torch.utils.mxnet_import import export_multitask, save_params
    from dspnet_torch.utils.profiler import StatMonitor

    net = "resnet-50_multi"
    ref = work / "reference"
    ref.mkdir()
    launches = {"nms_keep_mask": {}, "bipartite_match": {}, "jpeg_ycc_to_bgr": {}}

    def reset():
        nms_cuda.launches = matching_cuda.launches = jpeg_cuda.images = jpeg.decodes = 0
        jpeg_cuda.color_launches = jpeg_cuda.color_plain_calls = 0

    # 1. the reference's full inventory from seeded weights, as MXNet writes it
    t0 = time.perf_counter()
    src = create_model(net, (H, W), num_classes=NUM_CLASSES, device=dev, generator=torch.Generator().manual_seed(9))
    variables = to_flax_variables(src.model)
    args, auxs = export_multitask(variables["params"], variables["batch_stats"], net, H)
    check(len(args) == 220 and len(auxs) == 118, f"{len(args)} args, {len(auxs)} auxs (220 and 118 expected)")
    params_file = ref / "dspnet-0000.params"
    save_params(str(params_file), args, auxs)
    export_s = time.perf_counter() - t0

    # 2. the import tool; the checkpoint holds the source weights bit for bit
    model_dir = ref / "model"
    t0 = time.perf_counter()
    import_mxnet.main(["--params", str(params_file), "--network", net, "--data-shape", f"3,{H},{W}",
                       "--model-dir", str(model_dir), "--epoch", "0", "--device", "cuda"])
    import_s = time.perf_counter() - t0
    payload = torch.load(CheckpointManager(checkpoint_prefix(str(model_dir), net, H)).path(0), map_location="cpu",
                         weights_only=True)
    got = {**payload["params"], **payload["buffers"]}
    want = {k: v.detach().cpu() for k, v in src.model.state_dict().items()}
    check(set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want),
          "the imported checkpoint differs from the weights the .params was written from")
    print(f"reference weights: {len(args)} args + {len(auxs)} auxs ({params_file.stat().st_size / 2**20:.1f} MiB) "
          f"written in {export_s:.2f} s; import_mxnet --device cuda {import_s:.2f} s; the checkpoint's "
          f"{len(want)} tensors equal the source weights bit for bit [{label}]")
    del src, variables, args, auxs, payload, got, want

    # 3. multi_demo on 4 phase-8 JPEGs (2x: area) and 2 other sizes (bilinear)
    demo_in = ref / "demo_in"
    demo_in.mkdir()
    paths = []
    for i, d in enumerate(jpegs[:4]):
        paths.append(demo_in / f"cityscapes_{i}.jpg")
        paths[-1].write_bytes(d)
    rng = np.random.RandomState(19)
    for name, hw, sub in (("street_720x1280.jpg", (720, 1280), "422"), ("street_600x900.jpg", (600, 900), "420")):
        paths.append(demo_in / name)
        paths[-1].write_bytes(jpeg.encode(synthetic.make_example(rng, hw, 4)[0], 95, sub))
    demo_args = ["--network", net, "--data-shape", f"3,{H},{W}", "--model-dir", str(model_dir), "--epoch", "0",
                 "--dtype", "bfloat16", "--device", "cuda", "--vis-thresh", "0.3", "--out-dir", str(ref / "out"),
                 "--images", ",".join(str(x) for x in paths)]
    reset()
    t0 = time.perf_counter()
    written = multi_demo.main(demo_args)
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    n = len(paths)
    counts = {"nms": nms_cuda.launches, "nvjpeg_images": jpeg_cuda.images, "colour": jpeg_cuda.color_launches,
              "plain_decodes": jpeg.decodes, "plain_colour": jpeg_cuda.color_plain_calls}
    check(counts == {"nms": n, "nvjpeg_images": n, "colour": n, "plain_decodes": 0, "plain_colour": 0},
          f"multi_demo counts {counts}, expected {n} NMS launches, nvJPEG images and colour launches, 0 plain")
    launches["nms_keep_mask"]["reference_demo"] = counts["nms"]
    launches["jpeg_ycc_to_bgr"]["reference_demo"] = counts["colour"]
    check([Path(w).name for w in written] == [x.stem + "_out.jpg" for x in paths], f"written {written}")
    for w, x in zip(written, paths):
        check(jpeg.read_header(Path(w).read_bytes())[:2] == jpeg.read_header(x.read_bytes())[:2],
              f"{w}: not the input's size")
    print(f"multi_demo {net} {H}x{W} bf16 on {n} images (4 of 1024x2048, 720x1280, 600x900): {demo_s:.2f} s "
          f"including the model build and checkpoint restore; counts {counts}; each _out.jpg the input's size "
          f"[{label}]")

    # 4. the demo by stage, per image (synchronised between stages)
    detector = multi_demo.get_detector(multi_demo.parse_args(demo_args))
    stage_ms = {"area": [], "bilinear": []}
    for rep, todo in enumerate((paths[3:5], paths)):  # a warm-up of each resize, then every image
        for x in todo:
            t = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = detector.read_image(str(x))
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            raw = resize_linear(img, (H, W))
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            res = detector.predict_raw(raw[None])
            dets = detector._filter_rows(res["det"][0].cpu().numpy(), 0.0)
            seg = res["seg"][0].cpu().numpy()
            t.append(time.perf_counter())
            vis = detector.visualize_detection(img.cpu().numpy(), dets, seg, 0.3)
            t.append(time.perf_counter())
            jpeg.encode(vis, 95)
            t.append(time.perf_counter())
            check(np.isfinite(dets).all() and seg.shape == (H // 4, W // 4), f"{x.name}: dets or seg")
            if rep:
                kind = "area" if tuple(img.shape[:2]) == (2 * H, 2 * W) else "bilinear"
                stage_ms[kind].append(np.diff([t0] + t) * 1e3)
    names = ("read+decode", "resize", "predict", "draw", "encode")
    demo_split = {}
    for kind, rows in stage_ms.items():
        mean = np.mean(rows, axis=0)
        demo_split[kind] = dict(zip(names, mean.tolist()), total=float(mean.sum()))
        print(f"demo per image ({kind} resize, {len(rows)} images, after a warm-up): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in zip(names, mean)) + f"; total {mean.sum():.3f} ms "
              f"[{label}]")

    # 5. ServingPipeline against the synchronous path, 64 b1 frames
    bases = [resize_linear(detector.read_image(str(x)), (H, W)).cpu().numpy() for x in paths]
    frames = [np.roll(bases[i % n], 7 * i, axis=1) for i in range(64)]

    def sync_run(waits):
        out = []
        for f in frames:
            res = detector.predict_raw(f[None])
            t0 = time.perf_counter()
            out.append({k: v.cpu().numpy() for k, v in res.items()})  # blocks until the card is done
            waits.append(time.perf_counter() - t0)
        return out

    def pipe_run(pipe, waits):
        out, pipe.wait_s = [], 0.0
        for i, f in enumerate(frames):
            done = pipe.submit(f, tag=i)
            if done is not None:
                out.append(done)
        out += list(pipe.drain())
        waits.append(pipe.wait_s)
        return out

    def check_equal(what, out):
        check([t for t, _ in out] == list(range(len(frames))), f"pipeline {what}: results out of order")
        check(all(np.array_equal(r[k], w[k]) for (_, r), w in zip(out, want) for k in w),
              f"pipeline {what}: results differ from the synchronous predict_raw")

    want = sync_run([])
    # each slot replays its CUDA graph (the eager window lost to the
    # synchronous path at every depth: PERF.md, PR 6)
    pipes = {d: ServingPipeline(detector, depth=d) for d in (1, 2, 4)}
    reset()
    for what, pipe in pipes.items():  # first pass: each slot warms up and captures its graph
        check_equal(what, pipe_run(pipe, []))
    slots = sum(len(p._slots) for p in pipes.values())
    check(nms_cuda.launches == 2 * slots,
          f"{nms_cuda.launches} NMS wrapper launches in the first pass, expected 2 per graph slot ({slots} "
          f"slots: warm-up and capture)")
    first_pass = nms_cuda.launches
    timed, waited = {}, {}
    order = ("sync", *pipes) * 3
    for what in order:
        waits = waited.setdefault(what, [])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sync_run(waits) if what == "sync" else pipe_run(pipes[what], waits)
        timed.setdefault(what, []).append((time.perf_counter() - t0) * 1e3 / len(frames))
        if what != "sync":
            check_equal(what, out)
    sync_frames = order.count("sync") * len(frames)
    check(nms_cuda.launches - first_pass == sync_frames,
          f"{nms_cuda.launches - first_pass} NMS wrapper launches for {sync_frames} synchronous frames")
    name = {"sync": "sync", **{k: f"depth {k}" for k in pipes}}
    ms = {name[k]: float(np.mean(v)) for k, v in timed.items()}
    wait_ms = {name[k]: float(np.sum(v)) * 1e3 / (len(v) * len(frames)) for k, v in waited.items()}
    from torch.profiler import ProfilerActivity, profile

    # the card's busy time per frame on the synchronous path
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in frames[:10]:
            {k: v.cpu() for k, v in detector.predict_raw(f[None]).items()}
    busy_ms = sum(e.device_time for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA) / 10e3
    # a replayed graph calls no wrapper: the profiler counts its NMS kernels
    before = nms_cuda.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe_run(pipes[4], [])
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    replayed_nms = sum(any(n in k for n in NMS_KERNELS) for k in kernels)
    graph_kernels_per_frame = len(kernels) / len(frames)
    check(replayed_nms == len(frames) and nms_cuda.launches == before,
          f"graph depth 4: {replayed_nms} NMS kernels ran for {len(frames)} frames, "
          f"{nms_cuda.launches - before} wrapper calls")
    print(f"ServingPipeline b1 {H}x{W} bf16, {len(frames)} frames (host uint8 in, numpy out), results equal to "
          f"the synchronous predict_raw and in order in every run: " + ", ".join(
              f"{k} {v:.3f} ms/frame ({1e3 / v:.2f} frames/s)" for k, v in ms.items())
          + " (means of 3 runs in turns " + ", ".join(ms) + "; runs " + "; ".join(
              f"{name[k]}: " + ", ".join(f"{x:.3f}" for x in v) for k, v in timed.items())
          + "); host blocked waiting for results " + ", ".join(f"{k} {v:.3f}" for k, v in wait_ms.items())
          + f" ms/frame; card busy {busy_ms:.3f} ms per frame on the sync path (torch.profiler, 10 frames; idle "
          f"share {max(0.0, 1 - busy_ms / ms['sync']):.1%}); depth 4 under the profiler: {len(kernels)} "
          f"kernels for {len(frames)} frames, {replayed_nms} of them NMS, no wrapper call [{label}]")
    check(ms["depth 4"] < ms["depth 1"],
          f"depth 4 does not overlap: {ms['depth 4']:.3f} ms/frame against {ms['depth 1']:.3f} at depth 1")

    # new weights while frames are in flight: those before keep the old
    # weights, those after get the new ones
    other = create_model(net, (H, W), num_classes=NUM_CLASSES, device=dev,
                         generator=torch.Generator().manual_seed(10)).model
    pipe, swap = pipes[4], frames[:8]
    old = want[:8]
    for f in swap[:4]:
        check(pipe.submit(f) is None, "depth 4 returned a result before its window filled")
    pipe.update_weights(other)
    out = [pipe.submit(f) for f in swap[4:]] + list(pipe.drain())
    new = [{k: v.cpu().numpy() for k, v in detector.predict_raw(f[None]).items()} for f in swap]
    check(not all(np.array_equal(a["seg"], b["seg"]) for a, b in zip(old, new)), "the new weights change nothing")
    check(all(np.array_equal(r[k], w[k]) for (_, r), w in zip(out, old[:4] + new[4:]) for k in w),
          "update_weights in flight: results differ from the synchronous path on the old / new weights")
    print("ServingPipeline depth 4 update_weights with 4 frames in flight: those 4 equal the synchronous path on "
          "the old weights, the next 4 on the new ones")
    launches["nms_keep_mask"]["reference_pipeline"] = nms_cuda.launches
    del detector, bases, frames, want, pipes, pipe, other

    # 6. fine-tune from the imported epoch with the monitor on
    resume_dir = ref / "resume"
    shutil.copytree(model_dir, resume_dir)
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logging.getLogger().addHandler(handler)
    train_args = ["--network", net, "--data-shape", f"3,{H},{W}", "--num-classes", str(NUM_CLASSES),
                  "--batch-size", "4", "--device", "cuda", "--dataset-root", str(root), "--model-dir",
                  str(resume_dir), "--resume", "0", "--end-epoch", "2", "--eval-every", "0", "--compute-dtype",
                  "bfloat16", "--seg-normalize", "valid", "--lr", "5e-4", "--log-every", "1", "--monitor", "2",
                  "--pattern", "backbone/stage1"]
    reset()
    try:
        t0 = time.perf_counter()
        state = multi_train.main(train_args)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        logging.getLogger().removeHandler(handler)
    steps = 16 // 4
    check(matching_cuda.launches == steps and state.step == steps,
          f"resume: {matching_cuda.launches} matcher launches, step {state.step}, expected {steps}")
    check(jpeg_cuda.images == 16 and jpeg_cuda.color_launches == 16 and jpeg.decodes == 0,
          f"resume: nvJPEG {jpeg_cuda.images}, colour {jpeg_cuda.color_launches}, plain {jpeg.decodes}")
    check(any(m.startswith("resumed from epoch 0 (step 0)") for m in seen), "did not resume from the imported epoch")
    mon = [m for m in seen if m.startswith("monitor ")]
    names = {m.split()[1] for m in mon}
    check(mon and all(x.startswith("backbone/stage1") for x in names) and len(mon) == 2 * len(names),
          f"monitor lines: {len(mon)} for {len(names)} names")
    launches["bipartite_match"]["reference_resume"] = matching_cuda.launches
    launches["jpeg_ycc_to_bgr"]["reference_resume"] = jpeg_cuda.color_launches
    probe = StatMonitor(interval=1, pattern="backbone/stage1", logger=logging.getLogger("chip_smoke_monitor"))
    probe.tic_toc(state.params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        probe.tic_toc(state.params)
    call_ms = (time.perf_counter() - t0) / 10 * 1e3
    print(f"multi_train --resume 0 (the imported epoch) --monitor 2 --pattern backbone/stage1, 1 epoch of "
          f"{steps} b4 steps on phase 8's 1024x2048 JPEGs: {train_s:.2f} s including the build; matcher "
          f"{steps} launches; {len(mon)} monitor lines ({len(names)} tensors x 2); one monitor pass "
          f"{call_ms:.3f} ms, so {call_ms / 2:.3f} ms added per step at --monitor 2 [{label}]")
    del state
    torch.cuda.empty_cache()
    sys.stdout.flush()
    return launches, {"demo_split_ms": demo_split, "pipeline_ms_per_frame": ms, "pipeline_wait_ms": wait_ms,
                      "pipeline_graph_kernels_per_frame": graph_kernels_per_frame,
                      "serving_busy_ms": busy_ms, "monitor_call_ms": call_ms, "import_s": import_s}


def real_data_phase(dev, label):
    """Phase 8: a prepared Cityscapes dataset at raw 1024x2048 (JPEG) through
    the CLIs, then phase 9 on it. Returns ({kernel: launches}, the decoder's
    record, phase 9's ({kernel: {path: launches}}, record))."""
    import tempfile

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import multi_eval, multi_train
    from dspnet_torch.data import image_io, imdb, iterator, jpeg, jpeg_cuda, record
    from dspnet_torch.data.device_pipeline import DeviceAugIterator
    from dspnet_torch.ops import matching_cuda, nms_cuda
    from dspnet_torch.train.solver import MultiTaskSolver
    from tests.torch_parity import write_cityscapes_layout

    raw_hw, B, n_train, n_val = (1024, 2048), 4, 16, 8
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_real_", dir=ROOT / "build"))
    root, drec = work / "cityscapes", work / "drec"
    launches = {"nms_keep_mask": 0, "bipartite_match": 0, "jpeg_ycc_to_bgr": 0}
    decoder = {}

    def counted(run, steps, eval_batches, images, what):
        nms_cuda.launches = matching_cuda.launches = jpeg_cuda.images = jpeg.decodes = 0
        jpeg_cuda.color_launches = jpeg_cuda.color_plain_calls = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {"bipartite_match": matching_cuda.launches, "nms_keep_mask": nms_cuda.launches,
               "nvjpeg_images": jpeg_cuda.images, "plain_jpeg_decodes": jpeg.decodes,
               "jpeg_ycc_to_bgr": jpeg_cuda.color_launches, "plain_colour_calls": jpeg_cuda.color_plain_calls}
        want = {"bipartite_match": steps, "nms_keep_mask": eval_batches, "nvjpeg_images": images,
                "plain_jpeg_decodes": 0, "jpeg_ycc_to_bgr": images, "plain_colour_calls": 0}
        check(got == want, f"{what}: counts {got}, expected {want}")
        print(f"{what}: {secs:.2f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; matcher "
              f"{got['bipartite_match']} launches in {steps} train steps, NMS {got['nms_keep_mask']} in "
              f"{eval_batches} eval batches, nvJPEG {got['nvjpeg_images']} images of {images} read, colour "
              f"kernel {got['jpeg_ycc_to_bgr']} launches, plain JPEG decodes {got['plain_jpeg_decodes']}, plain "
              f"colour calls {got['plain_colour_calls']} [{label}]")
        for k in launches:
            launches[k] += got[k]
        return out

    try:
        t0 = time.perf_counter()
        write_cityscapes_layout(str(root), {"train": n_train, "val": n_val}, hw=raw_hw, seed=5, workers=8)
        for split in ("train", "val"):
            record.pack_records(imdb.load_index(str(root), split), str(drec / split), quiet=True)
        size = sum(f.stat().st_size for f in root.rglob("*.jpg"))
        print(f"prepared Cityscapes layout: {n_train} train + {n_val} val images {raw_hw[0]}x{raw_hw[1]} "
              f"(JPEG q95 4:2:0 from the port's encoder, XML with <distance>, ImageSets, trainId, "
              f"instanceIds and disparity PNGs; {size / (n_train + n_val) / 2**10:.1f} KiB per JPEG) and "
              f"its .drec copy written in {time.perf_counter() - t0:.3f} s [{label}]")

        train = imdb.load_index(str(root), "train")
        data = [iterator.load_sample_bytes(s, with_seg=False)[0] for s in train.samples[:B]]
        decoder.update(decode_checks(jpeg_cuda, jpeg, data, dev, raw_hw, B, label))
        demo_jpegs = data  # phase 9's demo inputs: 1024x2048 q95 4:2:0 from the layout

        # the CLIs on the directory, on the .drec store, with --predownscale
        net = ["--network", "resnet-50_multi", "--data-shape", f"3,{H},{W}", "--num-classes", str(NUM_CLASSES),
               "--batch-size", str(B), "--device", "cuda"]
        train_args = net + ["--compute-dtype", "bfloat16", "--seg-normalize", "valid", "--lr", "5e-4",
                            "--end-epoch", "2", "--eval-every", "1", "--checkpoint-every", "2", "--log-every", "1"]
        steps, val_batches = 2 * n_train // B, 2 * -(-n_val // B)
        images = 2 * (n_train + n_val)
        for what, data_root, extra in (("dir", root, []), ("drec", drec / "train.drec", []),
                                       ("predownscale", root, ["--predownscale"])):
            jsonl = work / f"{what}.jsonl"
            state = counted(lambda: multi_train.main(train_args + [
                "--dataset-root", str(data_root), "--model-dir", str(work / f"model_{what}"),
                "--metrics-jsonl", str(jsonl)] + extra), steps, val_batches, images,
                f"multi_train --dataset-root ({what}) b{B} bf16 {H}x{W}, 2 epochs")
            check(state.step == steps, f"{what}: step {state.step}")
            val = [json.loads(line) for line in jsonl.read_text().splitlines()]
            val = [r for r in val if r["split"] == "val"]
            check([r["epoch"] for r in val] == [0, 1], f"{what}: val rows {val}")
            for r in val:
                for k in ("mAP", "mIoU", "accuracy"):
                    check(np.isfinite(r[k]) and 0.0 <= r[k] <= 1.0, f"{what} val epoch {r['epoch']} {k}")
            print(f"  val epoch 1: mAP {val[-1]['mAP']:.6f}, mIoU {val[-1]['mIoU']:.6f}, accuracy "
                  f"{val[-1]['accuracy']:.6f}, ms_per_batch {val[-1]['ms_per_batch']:.3f}")
            del state

        results = work / "results"
        eval_ms = {}
        for what, data_root, extra in (
                ("dir --write-results --instance-eval", root, ["--write-results", str(results), "--instance-eval"]),
                ("dir --write-results", root, ["--write-results", str(work / "results2")]),
                ("dir --instance-eval", root, ["--instance-eval"]),
                ("dir", root, []), ("drec", drec / "val.drec", [])):
            res = counted(lambda: multi_eval.main(net + ["--dataset-root", str(data_root), "--model-dir",
                                                         str(work / "model_dir")] + extra),
                          0, -(-n_val // B), n_val, f"multi_eval --dataset-root ({what})")
            for k in ("mAP", "mIoU", "accuracy"):
                check(np.isfinite(res[k]) and 0.0 <= res[k] <= 1.0, f"multi_eval ({what}) {k} = {res[k]}")
            eval_ms[what] = res["ms_per_batch"]
            print(f"  mAP {res['mAP']:.6f}, mIoU {res['mIoU']:.6f}, accuracy {res['accuracy']:.6f}"
                  + (f", instAP {res['instAP']:.6f}, instAP50 {res['instAP50']:.6f}" if "instAP" in res else "")
                  + f", ms_per_batch {res['ms_per_batch']:.3f} [{label}]")
            if "--instance-eval" in extra:
                check(np.isfinite(res.get("instAP", np.nan)), "instance AP missing or not finite")
        pngs = sorted(results.iterdir())
        check(len(pngs) == n_val, f"{len(pngs)} result PNGs, expected {n_val}")
        for p in pngs:
            img = image_io.imread(str(p), image_io.IMREAD_UNCHANGED)
            check(img.shape == raw_hw and img.dtype == np.uint8, f"{p.name}: {img.shape} {img.dtype}")
        print(f"multi_eval ms per b{B} batch (the second of two): {eval_ms['dir']:.3f} plain, "
              f"{eval_ms['dir --write-results']:.3f} with --write-results ({B} result PNGs of "
              f"{raw_hw[0]}x{raw_hw[1]} a batch), {eval_ms['dir --instance-eval']:.3f} with --instance-eval, "
              f"{eval_ms['dir --write-results --instance-eval']:.3f} with both [{label}]")

        # the loader alone: nvJPEG on the JPEG set against the host PNG decode
        # of the same scenes (nvJPEG's pixels written losslessly)
        png_root = work / "png"
        png_root.mkdir()
        png_samples = []
        for s in train.samples:
            path = str(png_root / (Path(s.image_path).stem + ".png"))
            image_io.imwrite(path, jpeg_cuda.decode_batch([iterator.load_sample_bytes(s, False)[0]], dev)[0]
                             .cpu().numpy())
            png_samples.append(iterator.Sample(path, s.label, s.seg_path))
        png = iterator.SampleIndex(png_samples)

        def loader_ips(index):
            it = DeviceAugIterator(index, B, (H, W), device=dev, seed=233, enable_aug=True, num_threads=8)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(4):
                for _ in it:
                    pass
            torch.cuda.synchronize()
            return 4 * len(index) / (time.perf_counter() - t0)

        loader_ips(train)  # warm-up
        j1, p1, p2, j2 = (loader_ips(x) for x in (train, png, png, train))
        print(f"the loader alone, b{B} {raw_hw[0]}x{raw_hw[1]} -> {H}x{W} with augmentation, 4 epochs of "
              f"{n_train}: JPEG decoded by nvJPEG {j1:.2f} / {j2:.2f} img/s, PNG decoded on the host "
              f"{p1:.2f} / {p2:.2f} img/s (order JPEG, PNG, PNG, JPEG) [{label}]")

        # loader-fed against resident fit from the same weights
        bundle = create_model("resnet-50_multi", (H, W), num_classes=NUM_CLASSES, device=dev,
                              generator=torch.Generator().manual_seed(233))
        solver = MultiTaskSolver(bundle.model, bundle.anchors, learning_rate=5e-4, batch_size=B,
                                 seg_normalize="valid", compute_dtype="bfloat16", device=dev)
        st = solver.init_state()
        init = {g: {k: v.detach().clone() for k, v in getattr(st, g).items()}
                for g in ("params", "buffers", "momentum")}
        loader = DeviceAugIterator(train, B, (H, W), device=dev, seed=233, enable_aug=True, num_threads=8)
        resident = [b for b, _ in loader.epoch()]
        epochs = 4

        def fit_ips(batches):
            st.step = 0
            with torch.no_grad():
                for g, vals in init.items():
                    for k, v in getattr(st, g).items():
                        v.copy_(vals[k])
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.fit(st, batches, num_epochs=epochs, eval_every=0, log_every=10**9, log_fn=lambda *_: None)
            torch.cuda.synchronize()
            return n_train * epochs / (time.perf_counter() - t0), torch.cuda.max_memory_allocated() / 2**30

        png_loader = DeviceAugIterator(png, B, (H, W), device=dev, seed=233, enable_aug=True, num_threads=8)
        fit_ips(resident)  # warm-up
        (r1, m1), (l1, m2), (q1, _), (q2, _), (l2, _), (r2, _) = (
            fit_ips(x) for x in (resident, loader, png_loader, png_loader, loader, resident))
        print(f"train b{B} bf16 {H}x{W} through fit from {raw_hw[0]}x{raw_hw[1]} images, {epochs} epochs of "
              f"{n_train // B} steps from the same weights: loader-fed on the JPEGs (nvJPEG + on-device "
              f"augmentation) {l1:.2f} / {l2:.2f} img/s, on the PNG copy (host decode) {q1:.2f} / {q2:.2f} "
              f"img/s, resident batches {r1:.2f} / {r2:.2f} img/s (order resident, JPEG, PNG, PNG, JPEG, "
              f"resident); JPEG-fed / resident {(l1 + l2) / (r1 + r2):.3f}, PNG-fed / resident "
              f"{(q1 + q2) / (r1 + r2):.3f}; peak {m1:.3f} GiB resident, {m2:.3f} GiB loader-fed [{label}]")
        decoder.update(loader_jpeg_ips=[j1, j2], loader_png_ips=[p1, p2], fit_ratio=(l1 + l2) / (r1 + r2),
                       fit_png_ratio=(q1 + q2) / (r1 + r2), eval_ms=eval_ms)
        del solver, st, bundle, resident, loader, png_loader, init
        torch.cuda.empty_cache()
        reference = reference_weights_phase(dev, label, root, work, demo_jpegs)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    sys.stdout.flush()
    return launches, decoder, reference


SSD_CLASSES = 20  # VOC: 21 with the background


class PathCounts:
    """Phase 11's counters: each path is counted from 0 (``zero``) and read
    just after (``expect``), which also sums the kernel launches."""

    def __init__(self):
        self.launches = {"nms_keep_mask": 0, "bipartite_match": 0}

    @staticmethod
    def zero():
        from dspnet_torch.data import jpeg, jpeg_cuda
        from dspnet_torch.ops import matching_cuda, nms_cuda

        nms_cuda.launches = matching_cuda.launches = nms_cuda.plain_calls = matching_cuda.plain_calls = 0
        jpeg_cuda.images = jpeg.decodes = 0

    @staticmethod
    def read():
        from dspnet_torch.data import jpeg, jpeg_cuda
        from dspnet_torch.ops import matching_cuda, nms_cuda

        torch.cuda.synchronize()
        return {"bipartite_match": matching_cuda.launches, "nms_keep_mask": nms_cuda.launches,
                "nvjpeg_images": jpeg_cuda.images, "plain_jpeg_decodes": jpeg.decodes,
                "plain_nms_calls": nms_cuda.plain_calls, "plain_match_calls": matching_cuda.plain_calls}

    def expect(self, what, steps=0, eval_batches=0, images=0):
        got = self.read()
        want = {"bipartite_match": steps, "nms_keep_mask": eval_batches, "nvjpeg_images": images,
                "plain_jpeg_decodes": 0, "plain_nms_calls": 0, "plain_match_calls": 0}
        check(got == want, f"{what}: counts {got}, expected {want}")
        print(f"{what}: matcher {steps} launches = train steps, NMS {eval_batches} = predict calls + eval "
              f"batches, nvJPEG {images} images, plain decodes / plain NMS / plain matcher calls 0")
        for k in self.launches:
            self.launches[k] += got[k]


def ssd_rows(rng, B, K):
    """Top-K rows as the SSD detector emits them: 20 foreground classes."""
    cx, cy = rng.uniform(0.1, 0.9, (2, B, K))
    w, h = rng.uniform(0.05, 0.4, (2, B, K))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)
    valid = rng.rand(B, K) > 0.2
    ids = np.where(valid, rng.randint(0, SSD_CLASSES, (B, K)), -1).astype(np.float32)
    return boxes, ids, valid


def ssd_phase(dev, label):
    """Phase 10: the plain-SSD VOC path at full width (vgg16_reduced, 21
    classes, seeded weights, bf16 over float32 masters). Returns ({kernel:
    launches on the path}, {kernel: {shape: times}}, {kernel: max abs
    difference against the plain version})."""
    import tempfile

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import eval_voc, multi_train
    from dspnet_torch.data import augment, jpeg, synthetic
    from dspnet_torch.data.det_iterator import DetIterator, PlannedImages
    from dspnet_torch.data.imdb import PascalVoc
    from dspnet_torch.detect.detector import Detector
    from dspnet_torch.models import factory
    from dspnet_torch.ops import matching_cuda, nms_cuda
    from dspnet_torch.ops.boxes import iou_matrix
    from dspnet_torch.ops.detection import multibox_detection
    from dspnet_torch.ops.target import multibox_target
    from dspnet_torch.train.solver import MultiTaskSolver

    counts = PathCounts()
    times = {"nms_keep_mask": {}, "bipartite_match": {}}
    errs = {"nms_keep_mask": 0.0, "bipartite_match": 0.0}

    def det_checks(d, b, what):
        check(d.shape == (b, 400, 7) and d.dtype == torch.float32, f"{what}: det {tuple(d.shape)} {d.dtype}")
        check(bool(torch.isfinite(d).all()), f"{what}: non-finite det")
        ids = d[..., 0]
        check(bool(((ids == ids.round()) & (ids >= -1) & (ids <= SSD_CLASSES - 1)).all()),
              f"{what}: class ids outside -1..{SSD_CLASSES - 1}")
        scored = d[..., 1] >= 0
        check(bool(((d[..., 2:6] >= 0) & (d[..., 2:6] <= 1)).all(-1)[scored].all()), f"{what}: boxes outside [0, 1]")
        check(bool((d[..., 6][scored] == 0).all()), f"{what}: 4-channel head with a non-zero distance")
        check(bool((d[~scored] == -1).all()), f"{what}: sentinel rows not all -1")

    # ---- 10a. serving: vgg16_reduced@300 b1 and b32, @512 b8; NMS 0.45 across classes
    gen = torch.Generator(device=dev).manual_seed(0)
    bundle = create_model("vgg16_reduced", 300, SSD_CLASSES, device=dev, generator=torch.Generator().manual_seed(0))
    check(bundle.num_anchors == 8732, f"vgg16_reduced@300 anchors {bundle.num_anchors}")
    det = Detector(bundle.model, bundle.anchors, (300, 300), device=dev, dtype=torch.bfloat16, nms_thresh=0.45,
                   force_suppress=True)
    imgs = {b: torch.randn(b, 300, 300, 3, device=dev, generator=gen) * 50 for b in (1, 32)}
    for b in (1, 32):
        det.predict(imgs[b])
    counts.zero()
    res = {b: det.predict(imgs[b])["det"] for b in (1, 32)}
    counts.expect("serving vgg16_reduced@300 (b1, b32 predict)", eval_batches=2)
    for b, d in res.items():
        det_checks(d, b, f"b{b} 300x300")
    with torch.inference_mode():  # the detection stage: kernel NMS vs plain, same heads
        out = det.model(imgs[32].bfloat16())
        cls_prob = torch.softmax(out["cls_logits"].float(), dim=-1).transpose(1, 2)
        for force in (False, True):
            pair = [multibox_detection(cls_prob, out["loc_preds"], det.anchors, nms_threshold=0.45,
                                       force_suppress=force, nms_backend=be) for be in ("kernel", "plain")]
            check(torch.equal(*pair), f"b32 SSD det through the kernel != plain (force_suppress={force})")
    print(f"b32 SSD det through the kernel NMS == through the plain NMS, with and without force_suppress; "
          f"{int((res[32][..., 0] >= 0).sum())} kept rows at b32")

    def serve_ms(d, x, n):
        for _ in range(2):
            d.predict(x)["det"].cpu()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n):
            d.predict(x)["det"].cpu()  # the D2H ends the call
        return (time.perf_counter() - t0) / n * 1e3, torch.cuda.max_memory_allocated() / 2**30

    ms1, mem1 = serve_ms(det, imgs[1], 30)
    ms32, mem32 = serve_ms(det, imgs[32], 10)
    print(f"vgg16_reduced@300 bf16 predict (device-resident input, det to the host): b1 {ms1:.3f} ms/call "
          f"(peak {mem1:.3f} GiB), b32 {32e3 / ms32:.2f} img/s ({ms32:.3f} ms/call, peak {mem32:.3f} GiB) [{label}]")

    # float32 heads on the card against the CPU (L2Normalize, fc6, pool3 on both)
    x = np.random.RandomState(2).normal(0, 50, (1, 300, 300, 3)).astype(np.float32)
    heads = {}
    for device in ("cpu", dev):
        m = create_model("vgg16_reduced", 300, SSD_CLASSES, device=device,
                         generator=torch.Generator().manual_seed(3)).model
        with torch.inference_mode():
            heads[str(device)] = {k: v.float().cpu() for k, v in m(torch.from_numpy(x).to(device)).items()}
    for k, ref in heads["cpu"].items():
        err = float((heads[str(dev)][k] - ref).abs().max())
        tol = 1e-4 * float(ref.abs().max())
        print(f"f32 vgg16_reduced@300 {k}: card vs cpu max abs err {err:.3e} (tolerance {tol:.3e})")
        check(err <= tol, f"f32 SSD {k} card vs cpu error {err} > {tol}")

    bundle512 = create_model("vgg16_reduced", 512, SSD_CLASSES, device=dev, generator=torch.Generator().manual_seed(0))
    check(bundle512.num_anchors == 24576, f"vgg16_reduced@512 anchors {bundle512.num_anchors}")
    det512 = Detector(bundle512.model, bundle512.anchors, (512, 512), device=dev, dtype=torch.bfloat16,
                      nms_thresh=0.45, force_suppress=True)
    x512 = torch.randn(8, 512, 512, 3, device=dev, generator=gen) * 50
    det512.predict(x512)
    counts.zero()
    det_checks(det512.predict(x512)["det"], 8, "b8 512x512")
    counts.expect("serving vgg16_reduced@512 (b8 predict)", eval_batches=1)
    ms8, mem8 = serve_ms(det512, x512, 10)
    print(f"vgg16_reduced@512 bf16 predict b8: {8e3 / ms8:.2f} img/s ({ms8:.3f} ms/call, peak {mem8:.3f} GiB) "
          f"[{label}]")
    del det, det512, out, cls_prob, x512, imgs
    torch.cuda.empty_cache()

    # ---- 10b. the kernels at this path's shapes against their plain versions
    rng = np.random.RandomState(10)
    for B in (1, 32):
        rows = [torch.from_numpy(a).to(dev) for a in ssd_rows(rng, B, 400)]
        for force in (False, True):
            got = nms_cuda.nms_keep_mask(*rows, 0.45, force)
            want = nms_cuda.nms_keep_mask_reference(*rows, 0.45, force)
            torch.cuda.synchronize()
            errs["nms_keep_mask"] = max(errs["nms_keep_mask"], float((got.int() - want.int()).abs().max()))
            check(torch.equal(got, want), f"NMS kernel != plain at B={B} K=400 21 classes force={force}")
        for force in (False, True):
            t = kernel_times(lambda: nms_cuda.nms_keep_mask(*rows, 0.45, force), NMS_KERNELS)
            p_ms = cuda_ms(lambda: nms_cuda.nms_keep_mask_reference(*rows, 0.45, force), 20)
            v = rows[2].sum(dim=1).cpu().numpy().astype(np.int64)
            bound = bound_us(B * 400 * (16 + 4 + 1 + 1), 13 * int((v * (v - 1) // 2).sum()))
            key = f"SSD B={B} K=400 21 classes{' force' if force else ''}"
            times["nms_keep_mask"][key] = dict(t, plain_ms=p_ms, bound_us=bound[0], bound_by=bound[1])
            print_times(f"nms_keep_mask {key}", t, p_ms, bound, label)
    L = 100  # DetIterator.max_objects label rows
    for network, size, B in (("vgg16_reduced", 300, 8), ("vgg16_reduced", 300, 32), ("vgg16_reduced", 512, 8)):
        anchors = torch.from_numpy(factory.build_anchors(factory.get_config(network, size), (size, size))).to(dev)
        A = anchors.shape[0]
        for what, n_gt in (("random", 12), ("crowded", 60)):
            if what == "random":
                boxes = torch.from_numpy(corners(rng, B, L, lo=0.1, hi=0.4)).to(dev)
            else:
                c = rng.uniform(0.35, 0.65, (B, 1, 2)) + rng.normal(0.0, 0.02, (B, L, 2))
                wh = rng.uniform(0.15, 0.3, (B, L, 2))
                boxes = torch.from_numpy(np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)).to(dev)
            iou = iou_matrix(anchors[None].expand(B, -1, -1), boxes).contiguous()
            col_valid = torch.zeros(B, L, dtype=torch.bool, device=dev)
            col_valid[:, :n_gt] = True
            refills = torch.zeros(B, dtype=torch.int32, device=dev)
            got = matching_cuda.bipartite_match(iou, col_valid, refills=refills)
            want = matching_cuda.bipartite_match_reference(iou, col_valid)
            torch.cuda.synchronize()
            errs["bipartite_match"] = max(errs["bipartite_match"], max(
                float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)))
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"matcher kernel != plain at B={B} A={A} L={L} {what}")
            check(int(got[0].sum()) == B * n_gt, f"{int(got[0].sum())} matches for {B}x{n_gt} GTs")
            key = f"SSD B={B} A={A} L={L} {what} num_gt={n_gt}"
            n = 100 if what == "random" else 20
            t = kernel_times(lambda: matching_cuda.bipartite_match(iou, col_valid), MATCH_KERNELS, n=n, n_prof=n)
            p_ms = cuda_ms(lambda: matching_cuda.bipartite_match_reference(iou, col_valid), 5)
            bound = bound_us(B * A * n_gt * 4 + B * L + B * A * (1 + 4 + 4), 0)
            times["bipartite_match"][key] = dict(t, plain_ms=p_ms, bound_us=bound[0], bound_by=bound[1],
                                                 refills=refills.tolist())
            all_cols = bound_us(B * A * L * 4 + B * L + B * A * 9, 0)[0]
            print_times(f"bipartite_match {key} (refills {refills.tolist()}; bound over all {L} columns "
                        f"{all_cols:.3f} us)", t, p_ms, bound, label)
        del anchors, iou
    torch.cuda.empty_cache()
    print(f"SSD shapes: NMS {2 * 2} cases and the matcher {3 * 2} cases equal bit for bit (torch.equal); "
          f"plans {nms_cuda.launch_plan(32, 400)} at NMS B=32 K=400, "
          f"{matching_cuda.launch_plan(32, 8732, L)} at matcher B=32 A=8732 L={L}")

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ssd_", dir=ROOT / "build"))
    try:
        # ---- 10c. a synthetic VOC devkit of VOC-sized JPEGs (375x500)
        n_img = 32
        t0 = time.perf_counter()
        root = synthetic.build_voc_dataset(str(work / "voc"), num_samples=n_img, hw=(375, 500), seed=233)
        names = synthetic.class_names()
        print(f"VOC devkit write: {n_img} train + {n_img} val JPEGs 375x500 (q95 4:2:0) in "
              f"{time.perf_counter() - t0:.3f} s [{label}]")
        train_index = PascalVoc("train", "", root, classes=names).index()

        # one DetIterator batch on the card against the same draws on the CPU
        cpu_it = DetIterator(train_index, 8, (300, 300), device="cpu")
        planned = cpu_it.plan_batch()["images"]
        arrays = [jpeg.decode(b) for b in planned.items]
        want = PlannedImages(arrays, planned.plans, (300, 300), augment.MEAN_PIXELS).place_on("cpu")
        got = PlannedImages(arrays, planned.plans, (300, 300),
                            torch.tensor(augment.MEAN_PIXELS, device=dev)).place_on(dev).cpu()
        check(torch.equal(got, want), "DetIterator's device work on the card != on the CPU (same pixels, same draws)")
        card_it = DetIterator(train_index, 8, (300, 300), device=dev)
        cpu_it = DetIterator(train_index, 8, (300, 300), device="cpu")
        a, b = card_it.next_batch(), cpu_it.next_batch()
        check(torch.equal(a["label_det"].cpu(), b["label_det"]), "DetIterator labels card != cpu")
        d = (a["images"].cpu() - b["images"]).abs()
        check(float(d.mean()) < 1.0, f"DetIterator images card vs cpu mean |diff| {float(d.mean())}")
        interps = sorted({p.interp for p in planned.plans})
        print(f"DetIterator batch (b8, 300x300, interpolations {interps}, "
              f"{sum(p.pad for p in planned.plans)} pad canvases): the device work on the card == on the CPU "
              f"bit for bit on the same decoded pixels; whole batch nvJPEG vs the plain decoder: labels equal, "
              f"images mean |diff| {float(d.mean()):.4f}, max {float(d.max()):.1f} levels")

        # ---- 10d. training steps at b8 and b32 300x300, b8 512x512
        defaults = dict(learning_rate=1e-3, momentum=0.9, weight_decay=5e-4, overlap_threshold=0.5,
                        negative_mining_ratio=3.0, negative_mining_thresh=0.5)
        for b, size, net in ((8, 300, bundle), (32, 300, bundle), (8, 512, bundle512)):
            solver = MultiTaskSolver(net.model, net.anchors, batch_size=b, compute_dtype="bfloat16", device=dev,
                                     **defaults)
            state = solver.init_state()
            batch = DetIterator(train_index, b, (size, size), device=dev).next_batch()
            with torch.no_grad():
                probe = dataclasses.replace(state, buffers=dict(state.buffers))
                cls_preds = solver.forward(probe, batch, train=True)["cls_logits"].transpose(1, 2)
                targets = [multibox_target(solver.anchors, batch["label_det"], cls_preds, overlap_threshold=0.5,
                                           negative_mining_ratio=3.0, negative_mining_thresh=0.5,
                                           bipartite_backend=be) for be in ("kernel", "plain")]
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(*targets)), f"SSD b{b} {size}: kernel-path targets != plain")
            n_warm, n_timed = 3, 10
            losses = []
            for _ in range(n_warm):
                state, m = solver.train_step(state, batch)
                losses.append(float(m["loss"]))
            prof, m = profile_step(solver, state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.reset_peak_memory_stats()
            counts.zero()
            t0 = time.perf_counter()
            for _ in range(n_timed):
                state, m = solver.train_step(state, batch)
            losses.append(float(m["loss"]))
            dt = (time.perf_counter() - t0) / n_timed
            counts.expect(f"SSD train b{b} {size}x{size} ({n_timed} steps)", steps=n_timed)
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"train vgg16_reduced@{size} b{b} bf16 (f32 masters), device-resident DetIterator batch: "
                  f"{dt * 1e3:.3f} ms/step, {b / dt:.2f} img/s, peak {peak:.3f} GiB; first-step targets kernel == "
                  f"plain ({int((targets[0][2] > 0).sum())} positives); losses "
                  + ", ".join(f"{x:.5g}" for x in losses) + f" [{label}]")
            check(all(np.isfinite(losses)), f"SSD b{b} {size}: non-finite loss {losses}")
            print_profile(b, prof, dt * 1e3, label)
            del solver, state, batch, probe, cls_preds, targets
            torch.cuda.empty_cache()
        solver = MultiTaskSolver(bundle.model, bundle.anchors, batch_size=8, compute_dtype="bfloat16", device=dev,
                                 **defaults)
        state = solver.init_state()
        batch = DetIterator(train_index, 8, (300, 300), device=dev, seed=1).next_batch()
        traj = []
        for _ in range(8):
            state, m = solver.train_step(state, batch)
            traj.append(float(m["loss"]))
        print("8 SSD steps on one b8 batch, lr 1e-3: loss " + ", ".join(f"{x:.5f}" for x in traj))
        check(all(np.isfinite(traj)) and traj[-1] < traj[0], f"SSD loss did not fall: {traj}")
        del solver, state, batch
        torch.cuda.empty_cache()

        # ---- 10e. the CLIs: multi_train --loader det, --resume, eval_voc
        B = 8
        md = str(work / "model")
        flags = ["--network", "vgg16_reduced", "--data-shape", "3,300,300", "--num-classes", str(len(names)),
                 "--class-names", ",".join(names), "--batch-size", str(B)]
        train_flags = flags + ["--dataset-root", root, "--loader", "det", "--model-dir", md, "--lr", "0.0005",
                               "--compute-dtype", "bfloat16", "--log-every", "2"]
        steps, val_batches = n_img // B, -(-n_img // B)
        for what, extra, epochs in (("multi_train --loader det, 2 epochs", ["--end-epoch", "2"], 2),
                                    ("multi_train --loader det --resume 0, 1 epoch", ["--end-epoch", "3", "--resume", "0"], 1)):
            counts.zero()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = multi_train.main(train_flags + extra)
            secs = time.perf_counter() - t0
            counts.expect(what, steps=epochs * steps, eval_batches=epochs * val_batches,
                   images=epochs * 2 * n_img)
            print(f"  {secs:.3f} s, step {state.step}, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                  f"[{label}]")
        check(state.step == 3 * steps, f"resumed run ended at step {state.step}")
        del state
        torch.cuda.empty_cache()
        counts.zero()
        res = eval_voc.main(flags + ["--voc-root", root, "--year", "", "--image-set", "val", "--voc07",
                                     "--model-dir", md, "--result-dir", str(work / "results")])
        counts.expect("eval_voc --voc07", eval_batches=val_batches, images=n_img)
        for k in ("mAP", "devkit_mAP"):
            check(np.isfinite(res[k]) and 0.0 <= res[k] <= 1.0, f"eval_voc {k} = {res[k]}")
        files = sorted(p.name for p in (work / "results").iterdir())
        check(files == sorted(f"comp4_det_val_{c}.txt" for c in names), f"comp4 files {files}")
        print(f"  eval_voc: mAP {res['mAP']:.6f}, devkit_mAP {res['devkit_mAP']:.6f}, ms_per_batch "
              f"{res['ms_per_batch']:.3f} (b{B}), {len(files)} comp4 files [{label}]")

        # ---- 10f. the loader alone against loader-fed and resident fit
        loader = DetIterator(train_index, B, (300, 300), device=dev)
        for _ in loader:  # warm-up epoch
            pass
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for _ in range(2):
            for batch in loader:
                n += batch["images"].shape[0]
        torch.cuda.synchronize()
        alone = n / (time.perf_counter() - t0)
        # its two halves apart: the host's draws (plan_batch), then decode +
        # device work on batches planned ahead (place_on)
        planner = DetIterator(train_index, B, (300, 300), device=dev)
        t0 = time.perf_counter()
        planned = []
        for _ in range(2):
            planner.reset()
            while planner.cursor < len(train_index):
                planned.append(planner.plan_batch())
        plan_ms = (time.perf_counter() - t0) / (len(planned) * B) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in planned:
            p["images"].place_on(dev)
        torch.cuda.synchronize()
        place_ms = (time.perf_counter() - t0) / (len(planned) * B) * 1e3
        print(f"DetIterator per image: host draws {plan_ms:.3f} ms, decode + device work {place_ms:.3f} ms "
              f"(one thread each, serial) [{label}]")
        del planned
        solver = MultiTaskSolver(bundle.model, bundle.anchors, batch_size=B, compute_dtype="bfloat16", device=dev,
                                 **defaults)
        st = solver.init_state()
        solver.fit(st, loader, num_epochs=1, log_fn=lambda *a: None)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = solver.fit(st, loader, num_epochs=2, log_fn=lambda *a: None)
        torch.cuda.synchronize()
        fed = 2 * steps * B / (time.perf_counter() - t0)
        resident = [batch for batch in loader]
        t0 = time.perf_counter()
        st = solver.fit(st, resident * 2, num_epochs=1, log_fn=lambda *a: None)
        torch.cuda.synchronize()
        res_ips = 2 * steps * B / (time.perf_counter() - t0)
        print(f"DetIterator alone (b{B} 300x300 from 375x500 JPEGs, nvJPEG + crop/pad/mirror/resize/jitter on the "
              f"card): {alone:.2f} img/s; fit loader-fed {fed:.2f} img/s, on resident batches {res_ips:.2f} img/s "
              f"(loader-fed / resident {fed / res_ips:.3f}) [{label}]")
        del solver, st, resident, loader
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    sys.stdout.flush()
    return counts.launches, times, errs


def timed_steps(solver, state, batch, n_warm=3, n_timed=10, profile=True):
    """(state, ms/step, peak GiB, {kernel: (us, n)} of one profiled step or
    None, losses): warm-up steps, one profiled step, then ``n_timed`` steps
    on the host clock ending in a synchronize."""
    losses = []
    for _ in range(n_warm):
        state, m = solver.train_step(state, batch)
        losses.append(float(m["loss"]))
    prof = None
    if profile:
        prof, m = profile_step(solver, state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, m = solver.train_step(state, batch)
    losses.append(float(m["loss"]))
    dt = (time.perf_counter() - t0) / n_timed
    return state, dt * 1e3, torch.cuda.max_memory_allocated() / 2**30, prof, losses


def busy_ms(prof):
    return sum(us for us, _ in prof.values()) / 1e3


def seg_head_ms(solver, state, batch, n=5):
    """Device ms of the seg head's forward and backward in train mode (bf16)
    on the step's own taps: the backbone runs once outside the window, then
    ``n`` passes of the head alone under torch.profiler, every CUDA kernel
    summed."""
    from torch.profiler import ProfilerActivity, profile

    model = solver.model
    params = {k: v.detach().to(solver.compute_dtype) for k, v in state.params.items()}
    bufs = {k: v.clone() for k, v in state.buffers.items()}

    def sub(prefix, d):
        return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}

    images = batch["images"].to(solver.compute_dtype).permute(0, 3, 1, 2)
    with torch.no_grad():
        plus = torch.func.functional_call(model.backbone, {**sub("backbone.", params), **sub("backbone.", bufs)},
                                          (images,))
    res3, res4, feat = (plus[i].detach() for i in model.taps)
    feat.requires_grad_(True)
    head = {k: v.requires_grad_(True) for k, v in sub("seg.", params).items()}
    head_bufs = sub("seg.", bufs)
    grid = (images.shape[2] // 8, images.shape[3] // 8)
    was = model.seg.training
    model.seg.train(True)

    def run():
        out = torch.func.functional_call(model.seg, {**head, **head_bufs}, (res3, res4, feat, grid))
        torch.autograd.grad(out.float().square().mean(), [feat, *head.values()])

    try:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                run()
            torch.cuda.synchronize()
    finally:
        model.seg.train(was)
    us = sum(e.device_time for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / n / 1e3


def deterministic_det_step(dev, remat, distributed_ok=False):
    """One float32 resnet-50_det 256x512 b2 step from seeded weights, with
    cuDNN's deterministic algorithms (a det network: no bilinear backward,
    whose atomics would make even two plain steps differ): (state, metrics,
    every BatchNorm's running_updates)."""
    from dspnet_torch.api import create_model
    from dspnet_torch.models.layers import BatchNorm
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils.benchmark import batch_to_device, canonical_train_batch

    batch = canonical_train_batch(2, 256, 512, seed=3)
    batch.pop("seg_label")
    batch["images"] = batch["images"] * 100.0
    bundle = create_model("resnet-50_det", (256, 512), NUM_CLASSES, device=dev,
                          generator=torch.Generator().manual_seed(5), remat=remat)
    bns = [m for m in bundle.model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.running_updates = 0
    solver = MultiTaskSolver(bundle.model, bundle.anchors, batch_size=2, device=dev, learning_rate=1e-3)
    check(solver.distributed == distributed_ok, f"solver.distributed is {solver.distributed}")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        st, m = solver.train_step(solver.init_state(), batch_to_device(batch, dev))
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = prev
    return st, {k: float(v) for k, v in m.items()}, [m.running_updates for m in bns]


def max_state_diff(a, b, parts=("params", "buffers", "momentum")):
    return max(float((getattr(a, p)[k] - getattr(b, p)[k]).abs().max()) for p in parts for k in getattr(a, p))


class _LogTimes(logging.Handler):
    """Keeps (time, message) of every log record: the CLI's step lines."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, rec):
        self.lines.append((rec.created, rec.getMessage()))


def _step_ms(lines, epoch, steps):
    """ms per step from the CLI's per-batch log lines of one epoch (``--log-
    every 1``: each line ends in a host sync): batch 1 to batch ``steps``."""
    at = {m.split(":")[0]: t for t, m in lines if m.startswith(f"epoch {epoch} batch ")}
    return (at[f"epoch {epoch} batch {steps}"] - at[f"epoch {epoch} batch 1"]) / (steps - 1) * 1e3


def _stderr_lines(text):
    """(time, message) of the CLI's log lines in a child's output."""
    import datetime as _dt

    out = []
    for line in text.splitlines():
        parts = line.split(" ", 3)
        if len(parts) == 4 and parts[2] == "INFO":
            try:
                stamp = _dt.datetime.strptime(f"{parts[0]} {parts[1]}", "%Y-%m-%d %H:%M:%S,%f")
            except ValueError:
                continue
            out.append((stamp.timestamp(), parts[3]))
    return out


#: 2 ranks against one process: each change within this share of the
#: largest change of its kind. The ranks change only the order of the sums,
#: but a step amplifies that (a near-tie in the hard-negative mining flips):
#: one process moves 1.6% of its largest change on the CPU after 2 steps
#: when only the order of a batch's rows changes, and these 4 steps on the
#: card differ by 3.2%; a mean of the ranks' gradients for their sum moves
#: every change by half
DP_SHARE = 0.1


def _step_losses(lines):
    """The total loss of every step, in order, from the CLI's per-batch log
    lines (``--log-every 1``; 4 decimals)."""
    return [float(m.rsplit("loss=", 1)[1].split(",")[0]) for _, m in lines
            if m.startswith("epoch ") and " batch " in m and "loss=" in m]


def data_parallel_checks(dev, label, work, counts, record):
    """Phase 11g: world 1 through the distributed path over NCCL (one step
    equal to the plain step bit for bit, both timed), then ``multi_train
    --coordinator --num-processes 2`` as two processes sharing the card over
    gloo (rank 0 in this process, rank 1 a child) against the one-process
    run on the same global batches: each tensor's change from the seeded
    weights (the checkpoint's) against the largest change of its kind, and
    every step's loss."""
    import logging as _logging
    import os

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import multi_train
    from dspnet_torch.parallel import dist as pdist
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils.benchmark import batch_to_device, canonical_train_batch
    from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix

    plain, plain_m, _ = deterministic_det_step(dev, remat=False)
    bundle = create_model("resnet-50_multi", (H, W), NUM_CLASSES, device=dev,
                          generator=torch.Generator().manual_seed(0))
    batch = batch_to_device(canonical_train_batch(8, H, W), dev)
    kw = dict(batch_size=8, compute_dtype="bfloat16", device=dev, seg_normalize="valid", learning_rate=5e-4)
    solver = MultiTaskSolver(bundle.model, bundle.anchors, **kw)
    _, plain_ms, _, _, _ = timed_steps(solver, solver.init_state(), batch, n_warm=2, n_timed=8, profile=False)
    del solver
    info = pdist.distributed_init(f"127.0.0.1:{pdist.free_port()}", 1, 0, "cuda", timeout_s=120)
    try:
        check(info.backend == "nccl", f"world 1 on one card: backend {info.backend}, expected nccl")
        dist_st, dist_m, _ = deterministic_det_step(dev, remat=False, distributed_ok=True)
        diff = max_state_diff(plain, dist_st)
        check(diff == 0.0 and dist_m == plain_m, f"world-1 NCCL step != the plain step (max diff {diff})")
        solver = MultiTaskSolver(bundle.model, bundle.anchors, **kw)
        counts.zero()
        _, nccl_ms, _, _, _ = timed_steps(solver, solver.init_state(), batch, n_warm=2, n_timed=8, profile=False)
        counts.expect("world 1 over NCCL: b8 train (10 steps)", steps=10)
    finally:
        pdist.destroy()
    record["world 1 nccl"] = {"b8_step_ms": nccl_ms, "plain_b8_step_ms": plain_ms}
    print(f"data parallel world 1 over NCCL (rank {info.rank}, {info.device}): the float32 resnet-50_det step equals "
          f"the plain step bit for bit (parameters, running statistics, momentum, metrics); resnet-50_multi b8 bf16 "
          f"step {nccl_ms:.3f} ms through the distributed path (BatchNorm statistics, counts, metrics and a bucketed "
          f"gradient all-reduce) vs {plain_ms:.3f} ms plain [{label}]")
    del solver, batch, bundle
    torch.cuda.empty_cache()

    # two processes sharing the card over gloo: resnet-18_multi 512x1024 (the depth cut for time),
    # global b4 (2 rows a rank), 8 train and 4 val images, 2 epochs
    flags = ["--network", "resnet-18_multi", "--data-shape", f"3,{H},{W}", "--num-classes", str(NUM_CLASSES),
             "--batch-size", "4", "--synthetic", "8", "--synthetic-val", "4", "--synthetic-dir", str(work / "dp_synth"),
             "--end-epoch", "2", "--seg-normalize", "valid", "--eval-every", "1", "--log-every", "1"]
    root_logger = _logging.getLogger()
    runs, losses = {}, {}
    for what in ("one process", "rank 0 of 2"):
        md = str(work / ("dp_m1" if what == "one process" else "dp_m2"))
        extra = ["--model-dir", md]
        child = None
        if what != "one process":
            port = pdist.free_port()
            extra += ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")])))
            child = subprocess.Popen([sys.executable, "-m", "dspnet_torch.cli.multi_train", *flags, *extra,
                                      "--process-id", "1"], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
            extra += ["--process-id", "0"]
        handler = _LogTimes()
        counts.zero()
        t0 = time.perf_counter()
        try:
            root_logger.addHandler(handler)
            multi_train.main(flags + extra)
        except BaseException:
            if child is not None:
                child.kill()
            raise
        finally:
            root_logger.removeHandler(handler)
            child_out = child.communicate(timeout=300)[0] if child is not None else ""
        secs = time.perf_counter() - t0
        if child is None:
            counts.expect(f"multi_train one process (b4, 2 epochs)", steps=4, eval_batches=2, images=2 * (8 + 4))
        else:
            check(child.returncode == 0, f"rank 1 exited with {child.returncode}: {child_out[-3000:]}")
            counts.expect("multi_train rank 0 of 2 (2 of the 4 rows, 2 epochs; its validation pass over the whole "
                          "val split at its local batch 2)", steps=4, eval_batches=4, images=2 * 4 + 2 * 4)
            backends = [m for _, m in handler.lines + _stderr_lines(child_out) if m.startswith("data parallel:")]
            check(len(backends) == 2 and all("backend gloo" in m for m in backends), f"backends {backends}")
        ms = [_step_ms(handler.lines, 1, 2)]
        if child is not None:
            ms.append(_step_ms(_stderr_lines(child_out), 1, 2))
        runs[what] = CheckpointManager(checkpoint_prefix(md, "resnet-18_multi", H))
        losses[what] = _step_losses(handler.lines)
        record[f"multi_train {what}"] = {"seconds": secs, "step_ms": ms, "step_loss": losses[what]}
        print(f"multi_train resnet-18_multi {H}x{W} {what}: {secs:.3f} s for 2 epochs; epoch-1 step "
              + " / ".join(f"{x:.3f}" for x in ms) + " ms" + (" (rank 0 / rank 1), backend gloo, the card shared"
                                                              if child is not None else "") + f" [{label}]")
    a, b = (torch.load(runs[k].path(1), weights_only=True) for k in ("one process", "rank 0 of 2"))
    init = create_model("resnet-18_multi", (H, W), NUM_CLASSES, device="cpu",
                        generator=torch.Generator().manual_seed(multi_train.SEED)).model.state_dict()
    start = {"params": init, "buffers": init, "momentum": {k: torch.zeros_like(v) for k, v in a["momentum"].items()}}
    shares = {}
    for part in ("params", "buffers", "momentum"):
        # each kind (parameters, running means, running variances, momentum) against its largest change
        kind = (lambda k: k.rsplit(".", 1)[-1]) if part == "buffers" else (lambda k: part)
        d_one = {k: a[part][k].cpu().double() - start[part][k].double() for k in a[part]}
        d_two = {k: b[part][k].cpu().double() - start[part][k].double() for k in a[part]}
        largest, worst = {}, {}
        for k, d in d_one.items():
            largest[kind(k)] = max(largest.get(kind(k), 0.0), float(d.abs().max()))
            worst[kind(k)] = max(worst.get(kind(k), 0.0), float((d_two[k] - d).abs().max()))
        check(all(v > 0 for v in largest.values()), f"2 ranks vs one process: {part} did not move {largest}")
        shares.update({k: worst[k] / largest[k] for k in largest})
    check(all(v <= DP_SHARE for v in shares.values()),
          f"2 ranks vs one process: a change differs by more than {DP_SHARE} of the largest of its kind: {shares}")
    one, two = losses["one process"], losses["rank 0 of 2"]
    check(len(one) == len(two) == 4, f"step losses {one} / {two}")
    rel = [abs(x - y) / abs(x) for x, y in zip(one, two)]
    check(rel[0] <= 1e-4 and max(rel) <= 1e-3, f"2 ranks vs one process: step losses {two} vs {one}")
    record["2 ranks vs one process"] = {"change_share": shares, "loss_rel": rel}
    print(f"2 ranks over gloo == one process on the same global batches: each tensor's change (checkpoint - seeded "
          f"init) within {DP_SHARE} of the largest change of its kind, worst "
          + ", ".join(f"{k} {v:.3e}" for k, v in shares.items()) + "; the 4 step losses "
          + " / ".join(f"{y:.4f} vs {x:.4f}" for x, y in zip(one, two))
          + f" (relative {max(rel):.2e}; the first within 1e-4, all within 1e-3)")


def options_phase(dev, label):
    """Phase 11: the last backbone and the model and training options:
    the inceptionv3 SSD (serving, steps, the CLIs, the kernels at its
    shapes), ``seg_fast`` and ``remat`` with and without, and data
    parallelism on the one card (world 1 over NCCL; two processes sharing
    the card over gloo). Returns ({kernel: launches on the path}, {kernel:
    {shape: times}}, {kernel: max abs difference against the plain
    version})."""
    import tempfile

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import eval_voc, multi_train
    from dspnet_torch.data import synthetic
    from dspnet_torch.data.det_iterator import DetIterator
    from dspnet_torch.data.imdb import PascalVoc
    from dspnet_torch.detect.detector import Detector
    from dspnet_torch.ops import matching_cuda, nms_cuda
    from dspnet_torch.ops.boxes import iou_matrix
    from dspnet_torch.ops.detection import multibox_detection
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils.benchmark import batch_to_device, canonical_train_batch

    counts = PathCounts()
    times = {"nms_keep_mask": {}, "bipartite_match": {}}
    errs = {"nms_keep_mask": 0.0, "bipartite_match": 0.0}
    record = {}

    # ---- 11a. inceptionv3 SSD serving at 512 (A = 5,186) and 300 (A = 1,668), b1 and b32
    gen = torch.Generator(device=dev).manual_seed(0)
    nets = {}
    for size, A in ((512, 5186), (300, 1668)):
        bundle = create_model("inceptionv3", size, SSD_CLASSES, device=dev, generator=torch.Generator().manual_seed(0))
        check(bundle.num_anchors == A, f"inceptionv3@{size} anchors {bundle.num_anchors} != {A}")
        nets[size] = bundle
        det = Detector(bundle.model, bundle.anchors, (size, size), device=dev, dtype=torch.bfloat16,
                       nms_thresh=0.45, force_suppress=True)
        imgs = {b: torch.randn(b, size, size, 3, device=dev, generator=gen) * 50 for b in (1, 32)}
        for b in (1, 32):
            det.predict(imgs[b])
        counts.zero()
        res = {b: det.predict(imgs[b])["det"] for b in (1, 32)}
        counts.expect(f"serving inceptionv3@{size} (b1, b32 predict)", eval_batches=2)
        for b, d in res.items():
            check(d.shape == (b, 400, 7) and bool(torch.isfinite(d).all()),
                  f"inceptionv3@{size} b{b} det {tuple(d.shape)}")
            ids = d[..., 0]
            check(bool(((ids == ids.round()) & (ids >= -1) & (ids <= SSD_CLASSES - 1)).all()), "class ids")
            scored = d[..., 1] >= 0
            check(bool((d[~scored] == -1).all()), "sentinel rows not all -1")
        with torch.inference_mode():
            out = det.model(imgs[32].bfloat16())
            cls_prob = torch.softmax(out["cls_logits"].float(), dim=-1).transpose(1, 2)
            pair = [multibox_detection(cls_prob, out["loc_preds"], det.anchors, nms_threshold=0.45,
                                       force_suppress=True, nms_backend=be) for be in ("kernel", "plain")]
        check(torch.equal(*pair), f"inceptionv3@{size} b32 det through the kernel != plain")
        check(torch.equal(pair[0], res[32]), f"inceptionv3@{size} b32 predict det != the kernel-path det")
        ms = {}
        for b, n in ((1, 30), (32, 10)):
            for _ in range(2):
                det.predict(imgs[b])["det"].cpu()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(n):
                det.predict(imgs[b])["det"].cpu()
            ms[b] = ((time.perf_counter() - t0) / n * 1e3, torch.cuda.max_memory_allocated() / 2**30)
        record[f"inceptionv3@{size} serving"] = {"b1_ms": ms[1][0], "b32_img_s": 32e3 / ms[32][0]}
        print(f"inceptionv3@{size} bf16 predict: det equal bit for bit to the plain-NMS path at b32 "
              f"({int((res[32][..., 0] >= 0).sum())} kept rows); b1 {ms[1][0]:.3f} ms/call (peak {ms[1][1]:.3f} "
              f"GiB), b32 {32e3 / ms[32][0]:.2f} img/s ({ms[32][0]:.3f} ms/call, peak {ms[32][1]:.3f} GiB) [{label}]")
        del det, imgs, res, out, cls_prob, pair
        torch.cuda.empty_cache()

    # float32 forward, card vs CPU (BatchNorm eps 1e-3, the pools, the factorised convs)
    x = np.random.RandomState(2).normal(0, 50, (1, 300, 300, 3)).astype(np.float32)
    heads = {}
    for device in ("cpu", dev):
        m = create_model("inceptionv3", 300, SSD_CLASSES, device=device,
                         generator=torch.Generator().manual_seed(3)).model
        with torch.inference_mode():
            heads[str(device)] = {k: v.float().cpu() for k, v in m(torch.from_numpy(x).to(device)).items()}
    for k, ref in heads["cpu"].items():
        err = float((heads[str(dev)][k] - ref).abs().max())
        tol = 1e-4 * float(ref.abs().max())
        print(f"f32 inceptionv3@300 {k}: card vs cpu max abs err {err:.3e} (tolerance {tol:.3e})")
        check(err <= tol, f"f32 inceptionv3 {k} card vs cpu error {err} > {tol}")

    # ---- 11b. the kernels at the inceptionv3 shapes against their plain versions
    rng = np.random.RandomState(11)
    for B in (1, 32):
        rows = [torch.from_numpy(a).to(dev) for a in ssd_rows(rng, B, 400)]
        got = nms_cuda.nms_keep_mask(*rows, 0.45, True)
        want = nms_cuda.nms_keep_mask_reference(*rows, 0.45, True)
        torch.cuda.synchronize()
        errs["nms_keep_mask"] = max(errs["nms_keep_mask"], float((got.int() - want.int()).abs().max()))
        check(torch.equal(got, want), f"NMS kernel != plain at inceptionv3 B={B} K=400")
        t = kernel_times(lambda: nms_cuda.nms_keep_mask(*rows, 0.45, True), NMS_KERNELS)
        p_ms = cuda_ms(lambda: nms_cuda.nms_keep_mask_reference(*rows, 0.45, True), 20)
        v = rows[2].sum(dim=1).cpu().numpy().astype(np.int64)
        bound = bound_us(B * 400 * (16 + 4 + 1 + 1), 13 * int((v * (v - 1) // 2).sum()))
        key = f"inceptionv3 B={B} K=400 21 classes force"
        times["nms_keep_mask"][key] = dict(t, plain_ms=p_ms, bound_us=bound[0], bound_by=bound[1])
        print_times(f"nms_keep_mask {key}", t, p_ms, bound, label)
    L = 100
    anchors = torch.from_numpy(nets[512].anchors).to(dev)
    A = anchors.shape[0]
    for B in (8, 32):
        for what, n_gt in (("random", 12), ("crowded", 60)):
            if what == "random":
                boxes = torch.from_numpy(corners(rng, B, L, lo=0.1, hi=0.4)).to(dev)
            else:
                c = rng.uniform(0.35, 0.65, (B, 1, 2)) + rng.normal(0.0, 0.02, (B, L, 2))
                wh = rng.uniform(0.15, 0.3, (B, L, 2))
                boxes = torch.from_numpy(np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)).to(dev)
            iou = iou_matrix(anchors[None].expand(B, -1, -1), boxes).contiguous()
            col_valid = torch.zeros(B, L, dtype=torch.bool, device=dev)
            col_valid[:, :n_gt] = True
            refills = torch.zeros(B, dtype=torch.int32, device=dev)
            got = matching_cuda.bipartite_match(iou, col_valid, refills=refills)
            want = matching_cuda.bipartite_match_reference(iou, col_valid)
            torch.cuda.synchronize()
            errs["bipartite_match"] = max(errs["bipartite_match"], max(
                float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)))
            check(all(torch.equal(g, w) for g, w in zip(got, want)), f"matcher kernel != plain at B={B} A={A} {what}")
            key = f"inceptionv3 B={B} A={A} L={L} {what} num_gt={n_gt}"
            n = 100 if what == "random" else 20
            t = kernel_times(lambda: matching_cuda.bipartite_match(iou, col_valid), MATCH_KERNELS, n=n, n_prof=n)
            p_ms = cuda_ms(lambda: matching_cuda.bipartite_match_reference(iou, col_valid), 5)
            bound = bound_us(B * A * n_gt * 4 + B * L + B * A * (1 + 4 + 4), 0)
            times["bipartite_match"][key] = dict(t, plain_ms=p_ms, bound_us=bound[0], bound_by=bound[1],
                                                 refills=refills.tolist())
            print_times(f"bipartite_match {key} (refills {refills.tolist()})", t, p_ms, bound, label)
    del anchors, iou
    torch.cuda.empty_cache()
    print("inceptionv3 shapes: NMS 2 cases and the matcher 4 cases equal bit for bit (torch.equal)")

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_options_", dir=ROOT / "build"))
    try:
        # ---- 11c. inceptionv3 steps on DetIterator batches: b8 and b32 @300 and @512
        n_img = 32
        root = synthetic.build_voc_dataset(str(work / "voc"), num_samples=n_img, hw=(375, 500), seed=233)
        names = synthetic.class_names()
        train_index = PascalVoc("train", "", root, classes=names).index()
        defaults = dict(learning_rate=1e-3, momentum=0.9, weight_decay=5e-4, overlap_threshold=0.5,
                        negative_mining_ratio=3.0, negative_mining_thresh=0.5)
        for b, size in ((8, 300), (32, 300), (8, 512), (32, 512)):
            net = nets[size]
            solver = MultiTaskSolver(net.model, net.anchors, batch_size=b, compute_dtype="bfloat16", device=dev,
                                     **defaults)
            state = solver.init_state()
            batch = DetIterator(train_index, b, (size, size), device=dev).next_batch()
            counts.zero()
            state, ms, peak, prof, losses = timed_steps(solver, state, batch)
            counts.expect(f"inceptionv3 train b{b} {size}x{size} (14 steps)", steps=14)
            # the JAX defaults from random weights on one repeated batch: the first step must be
            # finite; a later divergence is reported, as phase 6 does, and the times hold
            check(np.isfinite(losses[0]), f"inceptionv3 b{b} {size}: non-finite first step {losses}")
            idle = max(0.0, 1 - busy_ms(prof) / ms)
            record[f"inceptionv3@{size} b{b} step"] = {"ms": ms, "peak_gib": peak, "idle": idle}
            print(f"train inceptionv3@{size} b{b} bf16 (f32 masters), device-resident DetIterator batch: "
                  f"{ms:.3f} ms/step, {b / ms * 1e3:.2f} img/s, peak {peak:.3f} GiB, idle share {idle:.1%}; losses "
                  + ", ".join(f"{x:.5g}" for x in losses) + f" [{label}]"
                  + ("" if all(np.isfinite(losses)) else " (DIVERGED after the first step at lr 1e-3: no "
                                                         "training result; the times hold)"))
            print_profile(b, prof, ms, label)
            del solver, state, batch
            torch.cuda.empty_cache()

        # ---- 11d. multi_train --network inceptionv3 --loader det, --resume, eval_voc --voc07
        B = 8
        md = str(work / "model")
        flags = ["--network", "inceptionv3", "--data-shape", "3,300,300", "--num-classes", str(len(names)),
                 "--class-names", ",".join(names), "--batch-size", str(B)]
        train_flags = flags + ["--dataset-root", root, "--loader", "det", "--model-dir", md, "--lr", "0.0005",
                               "--compute-dtype", "bfloat16", "--log-every", "2"]
        steps, val_batches = n_img // B, -(-n_img // B)
        for what, extra, epochs in (("multi_train --network inceptionv3 --loader det, 2 epochs",
                                     ["--end-epoch", "2"], 2),
                                    ("  --resume 0, 1 epoch", ["--end-epoch", "3", "--resume", "0"], 1)):
            counts.zero()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = multi_train.main(train_flags + extra)
            secs = time.perf_counter() - t0
            counts.expect(what, steps=epochs * steps, eval_batches=epochs * val_batches,
                   images=epochs * 2 * n_img)
            print(f"  {secs:.3f} s, step {state.step}, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                  f"[{label}]")
        check(state.step == 3 * steps, f"resumed inceptionv3 run ended at step {state.step}")
        del state
        torch.cuda.empty_cache()
        counts.zero()
        res = eval_voc.main(flags + ["--voc-root", root, "--year", "", "--image-set", "val", "--voc07",
                                     "--model-dir", md, "--result-dir", str(work / "results")])
        counts.expect("eval_voc --network inceptionv3 --voc07", eval_batches=val_batches, images=n_img)
        for k in ("mAP", "devkit_mAP"):
            check(np.isfinite(res[k]) and 0.0 <= res[k] <= 1.0, f"eval_voc {k} = {res[k]}")
        print(f"  eval_voc: mAP {res['mAP']:.6f}, devkit_mAP {res['devkit_mAP']:.6f}, ms_per_batch "
              f"{res['ms_per_batch']:.3f} (b{B}) [{label}]")
        del nets
        torch.cuda.empty_cache()

        # ---- 11e. seg_fast: resnet-50_multi 512x1024, b1 predict_raw and the b8 bf16 step, with and without
        frame = np.random.RandomState(0).randint(0, 256, (1, H, W, 3), np.uint8)
        batch8 = batch_to_device(canonical_train_batch(8, H, W), dev)
        for fast in (False, True):
            tag = "seg_fast" if fast else "exact head"
            bundle = create_model("resnet-50_multi", (H, W), NUM_CLASSES, device=dev,
                                  generator=torch.Generator().manual_seed(0), seg_fast=fast)
            det = Detector(bundle.model, bundle.anchors, (H, W), device=dev, dtype=torch.bfloat16)
            for _ in range(3):
                det.predict_raw(frame)["det"].cpu()
            counts.zero()
            t0 = time.perf_counter()
            for _ in range(30):
                out = det.predict_raw(frame)
                out["det"].cpu(), out["seg"].cpu()
            serve = (time.perf_counter() - t0) / 30 * 1e3
            counts.expect(f"{tag}: 30 b1 predict_raw", eval_batches=30)
            del det
            solver = MultiTaskSolver(bundle.model, bundle.anchors, batch_size=8, compute_dtype="bfloat16",
                                     device=dev, seg_normalize="valid", learning_rate=5e-4)
            counts.zero()
            state, ms, peak, prof, losses = timed_steps(solver, solver.init_state(), batch8)
            counts.expect(f"{tag}: b8 train (14 steps)", steps=14)
            check(all(np.isfinite(losses)), f"{tag}: non-finite loss {losses}")
            # the seg head alone, forward and backward on the step's taps, under the profiler
            seg_ms = seg_head_ms(solver, state, batch8)
            record[f"resnet-50_multi {tag}"] = {"b1_predict_raw_ms": serve, "b8_step_ms": ms, "b8_peak_gib": peak,
                                               "b8_busy_ms": busy_ms(prof), "seg_head_fwd_bwd_ms": seg_ms}
            print(f"resnet-50_multi 512x1024 {tag}: b1 predict_raw {serve:.3f} ms/call; b8 bf16 step {ms:.3f} ms "
                  f"(device busy {busy_ms(prof):.3f} ms in the profiled step), peak {peak:.3f} GiB; the seg head "
                  f"alone on the step's taps, forward + backward: {seg_ms:.3f} ms of device time [{label}]")
            del solver, state, bundle
            torch.cuda.empty_cache()
        # float32 forward on the card against the CPU; one parameter tree for both heads
        small = np.random.RandomState(1).normal(0, 50, (1, 128, 256, 3)).astype(np.float32)
        outs, trees = {}, {}
        for device in ("cpu", dev):
            for fast in (False, True):
                m = create_model("resnet-50_multi", (128, 256), device=device,
                                 generator=torch.Generator().manual_seed(1), seg_fast=fast).model
                trees[(str(device), fast)] = [(k, tuple(v.shape)) for k, v in m.state_dict().items()]
                with torch.inference_mode():
                    outs[(str(device), fast)] = m(torch.from_numpy(small).to(device))["seg_logits"].float().cpu()
        check(len({tuple(t) for t in trees.values()}) == 1, "seg_fast parameter tree != the exact head's")
        ref = outs[("cpu", True)]
        err = float((outs[(str(dev), True)] - ref).abs().max())
        tol = 1e-4 * float(ref.abs().max())
        gap = float((outs[("cpu", True)] - outs[("cpu", False)]).abs().max())
        check(err <= tol and gap > 1e-3, f"f32 seg_fast card vs cpu error {err} > {tol} or no gap ({gap})")
        print(f"f32 seg_fast seg_logits: card vs cpu max abs err {err:.3e} (tolerance {tol:.3e}); the parameter "
              f"trees equal; the fast and exact heads differ by {gap:.3e} (other numerics by design)")

        # ---- 11f. remat: the resnet-50_multi b8 and b32 steps with and without
        for b in (8, 32):
            batch = batch_to_device(canonical_train_batch(b, H, W), dev)
            for remat in (False, True):
                bundle = create_model("resnet-50_multi", (H, W), NUM_CLASSES, device=dev,
                                      generator=torch.Generator().manual_seed(0), remat=remat)
                solver = MultiTaskSolver(bundle.model, bundle.anchors, batch_size=b, compute_dtype="bfloat16",
                                         device=dev, seg_normalize="valid", learning_rate=5e-4)
                counts.zero()
                state, ms, peak, _, losses = timed_steps(solver, solver.init_state(), batch, n_warm=2, n_timed=8,
                                                       profile=False)
                counts.expect(f"b{b} {'remat' if remat else 'plain'} train (10 steps)", steps=10)
                check(all(np.isfinite(losses)), f"remat={remat} b{b}: non-finite loss {losses}")
                record[f"resnet-50_multi b{b} {'remat' if remat else 'plain'}"] = {"ms": ms, "peak_gib": peak}
                print(f"resnet-50_multi 512x1024 b{b} bf16 step {'with' if remat else 'without'} --remat: "
                      f"{ms:.3f} ms/step, {b / ms * 1e3:.2f} img/s, max_memory_allocated {peak:.3f} GiB [{label}]")
                del solver, state, bundle
                torch.cuda.empty_cache()
            del batch
        # float32: the remat step against the plain step, which is run twice for its own spread
        runs = [deterministic_det_step(dev, remat) for remat in (False, False, True)]
        spread = max_state_diff(runs[0][0], runs[1][0])
        diff = max_state_diff(runs[0][0], runs[2][0])
        stats = max_state_diff(runs[0][0], runs[2][0], parts=("buffers",))
        check(all(u == [1] * len(u) for _, _, u in runs), "a BatchNorm updated its running statistics twice")
        check(spread == 0.0, f"the deterministic f32 plain step differs from itself by {spread}")
        check(runs[2][1] == runs[0][1] and stats == 0.0 and diff == 0.0,
              f"f32 remat step vs plain: metrics {runs[2][1]} vs {runs[0][1]}, running statistics {stats}, "
              f"state {diff}")
        print(f"f32 resnet-50_det 256x512 b2 (deterministic cuDNN): the remat step == the plain step bit for bit "
              f"(metrics, parameters, running statistics, momentum: max difference {diff:.3e}; the plain step "
              f"against itself {spread:.3e}); each of {len(runs[2][2])} BatchNorms updated its running statistics "
              f"once")

        # ---- 11g. data parallelism on the one card
        data_parallel_checks(dev, label, work, counts, record)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    print(json.dumps({"options_phase": record}))
    sys.stdout.flush()
    return counts.launches, times, errs


def prepare_phase(dev, label, raw_hw=(1024, 2048), scenes=(16, 8)):
    """Phase 12: the data-preparation chain from the raw Cityscapes release
    (``scenes`` train and val scenes at ``raw_hw``) and from a
    reference-format MXNet .rec, through the CLIs on the card, to the
    official scores. Returns ({kernel: launches}, {kernel: max abs err},
    the phase's record)."""
    import contextlib
    import io
    import tempfile

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import multi_eval, multi_train
    from dspnet_torch.data import image_io, imdb, iterator, jpeg, jpeg_cuda, rec_import, record
    from dspnet_torch.data.cs_labels import name2label
    from dspnet_torch.data.device_pipeline import DeviceAugIterator
    from dspnet_torch.detect.detector import Detector
    from dspnet_torch.evaluate import cityscapes_eval
    from dspnet_torch.ops import boxes, matching_cuda, nms_cuda
    from dspnet_torch.ops.detection import multibox_detection
    from dspnet_torch.ops.target import _valid_columns
    from dspnet_torch.tools import im2rec, prepare_cityscapes, prepare_dataset, visualize_net, voc_palette
    from tests.torch_parity import make_png, write_gtfine_tree

    (n_train, n_val), B, n_objects = scenes, 4, 100
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_prepare_", dir=ROOT / "build"))
    raw, prep, packed, recs, from_rec = (work / d for d in ("raw", "cityscapes", "packed", "rec", "from_rec"))
    launches = {"nms_keep_mask": 0, "bipartite_match": 0, "jpeg_ycc_to_bgr": 0}
    errs = {"nms_keep_mask": 0, "bipartite_match": 0}
    secs = {}
    record_ = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    def counted(run, steps, eval_batches, images, what):
        nms_cuda.launches = matching_cuda.launches = nms_cuda.plain_calls = matching_cuda.plain_calls = 0
        jpeg_cuda.images = jpeg.decodes = jpeg_cuda.color_launches = jpeg_cuda.color_plain_calls = 0
        out = run()
        torch.cuda.synchronize()
        got = {"bipartite_match": matching_cuda.launches, "nms_keep_mask": nms_cuda.launches,
               "nvjpeg_images": jpeg_cuda.images, "jpeg_ycc_to_bgr": jpeg_cuda.color_launches,
               "plain_jpeg_decodes": jpeg.decodes, "plain_colour_calls": jpeg_cuda.color_plain_calls,
               "plain_nms_calls": nms_cuda.plain_calls, "plain_match_calls": matching_cuda.plain_calls}
        want = {"bipartite_match": steps, "nms_keep_mask": eval_batches, "nvjpeg_images": images,
                "jpeg_ycc_to_bgr": images, "plain_jpeg_decodes": 0, "plain_colour_calls": 0,
                "plain_nms_calls": 0, "plain_match_calls": 0}
        check(got == want, f"{what}: counts {got}, expected {want}")
        print(f"{what}: matcher {steps} launches = train steps, NMS {eval_batches} = eval batches, nvJPEG and "
              f"the colour kernel {images} images, plain JPEG decodes / colour / NMS / matcher calls 0")
        for k in launches:
            launches[k] += got[k]
        return out

    try:
        # 1. the raw release: gtFine polygons, 16-bit disparity, the half-size JPEGs
        splits = {"train": n_train, "val": n_val}
        stems = stage("raw tree", lambda: write_gtfine_tree(str(raw), str(prep / "JPEGImages"), splits,
                                                            hw=raw_hw, seed=12, n_objects=n_objects, workers=8))
        scenes = [json.loads(p.read_text()) for p in sorted((raw / "gtFine").rglob("*_polygons.json"))]
        objs = [o for s in scenes for o in s["objects"]]
        past = sum(any(not (0 <= x < raw_hw[1] and 0 <= y < raw_hw[0]) for x, y in o["polygon"]) for o in objs)
        print(f"raw Cityscapes tree: {n_train} train + {n_val} val scenes at {raw_hw[0]}x{raw_hw[1]}, "
              f"{len(objs)} polygons ({sum(o['label'].endswith('group') for o in objs)} '...group', "
              f"{sum(bool(o.get('deleted')) for o in objs)} deleted, {past} past the border, "
              f"{sum(len(o['polygon']) < 3 for o in objs)} of one or two points), 16-bit disparity, half-size "
              f"JPEGs (q95 4:2:0) in {secs['raw tree']:.3f} s [{label}]")

        # 2. prepare_cityscapes (scale 0.5) and prepare_dataset --pack
        def prepare():
            for split in splits:
                prepare_cityscapes.main(["--gtfine", str(raw / "gtFine"), "--disparity", str(raw / "disparity"),
                                         "--out", str(prep), "--split", split, "--instance-ids"])

        stage("prepare_cityscapes", prepare)
        half = (raw_hw[0] // 2, raw_hw[1] // 2)
        for split, ss in stems.items():
            ids = (prep / "ImageSets" / "Main" / f"{split}.txt").read_text().split()
            check(sorted(ids) == sorted(s + "_leftImg8bit" for s in ss), f"{split}.txt lists {ids}")
            for s in ss:
                tid = image_io.imread(str(prep / "SegmentationClass" / f"{s}_gtFine_labelTrainIds.png"),
                                      image_io.IMREAD_UNCHANGED)
                inst = image_io.imread(str(prep / "SegmentationInstance" / f"{s}_gtFine_instanceIds.png"),
                                       image_io.IMREAD_UNCHANGED)
                disp = image_io.imread(str(prep / "Disparity" / f"{s}_disparity.png"), image_io.IMREAD_UNCHANGED)
                check(tid.shape == inst.shape == disp.shape == half and tid.dtype == np.uint8
                      and inst.dtype == disp.dtype == np.uint16, f"{s}: {tid.shape} {inst.dtype} {disp.dtype}")
                check("<distance>" in (prep / "Annotations" / f"{s}_leftImg8bit.xml").read_text(),
                      f"{s}: no <distance> in the XML")
        print(f"prepare_cityscapes --disparity --instance-ids (scale 0.5): {n_train + n_val} scenes in "
              f"{secs['prepare_cityscapes']:.3f} s, {secs['prepare_cityscapes'] / (n_train + n_val):.4f} s a scene "
              f"(XML with <distance>, trainIds, 16-bit instanceIds and disparity at {half[0]}x{half[1]}) [{label}]")

        def pack():
            for split in splits:
                prepare_dataset.main(["--dataset", "cityscapes", "--set", split, "--root", str(prep),
                                      "--target", str(packed / f"{split}.lst"), "--pack"])

        stage("prepare_dataset --pack", pack)

        # 3. the same samples as a reference-format .rec, converted by im2rec --from-rec
        def write_recs():
            for split in splits:
                payloads = []
                for i, s in enumerate(imdb.CityscapesDetSeg(split, str(prep)).samples()):
                    rows = s.label[s.label[:, 0] >= 0]
                    vec = np.concatenate([[2.0, rows.shape[1]], rows.reshape(-1)]).astype(np.float32)
                    payloads.append(rec_import.pack_payload(i, vec, Path(s.image_path).read_bytes()))
                recs.mkdir(exist_ok=True)
                rec_import.write_records(str(recs / f"{split}.rec"), payloads)

        stage(".rec write", write_recs)

        def convert():
            for split in splits:
                im2rec.main(["--from-rec", str(recs / f"{split}.rec"), "--lst", str(packed / f"{split}.lst"),
                             "--out", str(from_rec / split)])

        stage("im2rec --from-rec", convert)
        n_rows = 0
        for split in splits:
            a = record.load_record_index(str(packed / split))
            b = record.load_record_index(str(from_rec / split))
            check(len(a) == len(b) == splits[split], f"{split}: {len(a)} and {len(b)} samples")
            for x, y in zip(a.samples, b.samples):
                check(x.image_path == y.image_path and np.array_equal(x.label, y.label)
                      and iterator.read_encoded(x.image_path, x.image_span)
                      == iterator.read_encoded(y.image_path, y.image_span)
                      and iterator.read_encoded(x.seg_path, x.seg_span) == iterator.read_encoded(y.seg_path, y.seg_span),
                      f"{split}: the .rec-derived store differs from prepare_dataset's at {x.image_path}")
                n_rows += int((x.label[:, 0] >= 0).sum())
        print(f"prepare_dataset --pack {secs['prepare_dataset --pack']:.3f} s; reference .rec (label vector "
              f"2 6 <objects>) written in {secs['.rec write']:.3f} s; im2rec --from-rec {secs['im2rec --from-rec']:.3f}"
              f" s; the two .drec stores give the same SampleIndex ({n_train + n_val} samples, {n_rows} labelled "
              f"objects, labels, image and seg bytes equal) [{label}]")

        # the two kernels against their plain versions on this data (not counted)
        anchors = create_model("resnet-50_multi", (H, W), NUM_CLASSES, device="meta").anchors
        train_index = record.load_record_index(str(from_rec / "train"))
        loader = DeviceAugIterator(train_index, B, (H, W), device=dev, seed=233, enable_aug=True, num_threads=8)
        batch, _ = next(iter(loader.epoch()))
        labels = torch.as_tensor(batch["label_det"], device=dev).float()
        iou = boxes.iou_matrix(torch.as_tensor(anchors, device=dev), labels[..., 1:5]).contiguous()
        col_valid = _valid_columns(labels)
        got = matching_cuda.bipartite_match(iou, col_valid)
        want = matching_cuda.bipartite_match_reference(iou, col_valid)
        check(all(torch.equal(a, b) for a, b in zip(got, want)), "matcher kernel != plain on the .rec-derived batch")
        errs["bipartite_match"] = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
        val_loader = DeviceAugIterator(record.load_record_index(str(from_rec / "val")), B, (H, W), device=dev,
                                       seed=0, enable_aug=False, shuffle=False, num_threads=8)
        vbatch, _ = next(iter(val_loader.epoch()))
        bundle = create_model("resnet-50_multi", (H, W), NUM_CLASSES, device=dev,
                              generator=torch.Generator().manual_seed(12))
        det = Detector(bundle.model, bundle.anchors, (H, W), device=dev, dtype=torch.bfloat16)
        with torch.inference_mode():
            out = det.model(torch.as_tensor(vbatch["images"], device=dev).to(torch.bfloat16))
            cls_prob = torch.softmax(out["cls_logits"].float(), dim=-1).transpose(1, 2)
            dets = [multibox_detection(cls_prob, out["loc_preds"], det.anchors, nms_threshold=det.nms_thresh,
                                       nms_backend=b) for b in ("kernel", "plain")]
        check(torch.equal(*dets), "det through the NMS kernel != through the plain NMS on the prepared val batch")
        errs["nms_keep_mask"] = float((dets[0] - dets[1]).abs().max())
        print(f"on this data: the matcher kernel == plain (b{B}, A = {iou.shape[1]}, "
              f"{int(col_valid.sum())} GT columns), the det through the NMS kernel == through the plain NMS "
              f"(b{B}, {int((dets[0][..., 0] >= 0).sum())} kept rows)")
        del bundle, det, out, cls_prob, dets, loader, val_loader, batch, vbatch, iou
        torch.cuda.empty_cache()

        # 4. multi_train on the .rec-derived store; 5. multi_eval on the prepared directory
        net = ["--network", "resnet-50_multi", "--data-shape", f"3,{H},{W}", "--num-classes", str(NUM_CLASSES),
               "--batch-size", str(B), "--device", dev.type]
        steps, val_batches = 2 * n_train // B, -(-n_val // B)
        jsonl = work / "train.jsonl"
        state = stage("multi_train", lambda: counted(lambda: multi_train.main(net + [
            "--compute-dtype", "bfloat16", "--seg-normalize", "valid", "--lr", "5e-4", "--end-epoch", "2",
            "--eval-every", "1", "--checkpoint-every", "2", "--log-every", "1",
            "--dataset-root", str(from_rec / "train.drec"), "--model-dir", str(work / "model"),
            "--metrics-jsonl", str(jsonl)]), steps, 2 * val_batches, 2 * (n_train + n_val),
            f"multi_train --dataset-root (the .rec-derived .drec) b{B} bf16 {H}x{W}, 2 epochs"))
        check(state.step == steps, f"multi_train: step {state.step}")
        rows = [json.loads(line) for line in jsonl.read_text().splitlines()]
        for r in (r for r in rows if r["split"] == "val"):
            for k in ("mAP", "mIoU", "accuracy"):
                check(np.isfinite(r[k]) and 0.0 <= r[k] <= 1.0, f"multi_train val epoch {r['epoch']} {k}")
        del state
        results = work / "results"
        res = stage("multi_eval", lambda: counted(lambda: multi_eval.main(net + [
            "--dataset-root", str(prep), "--model-dir", str(work / "model"), "--write-results", str(results),
            "--instance-eval"]), 0, val_batches, n_val, "multi_eval --dataset-root (the prepared directory) "
                                                        "--write-results --instance-eval"))
        for k in ("mAP", "mIoU", "accuracy", "instAP", "instAP50"):
            check(np.isfinite(res[k]) and 0.0 <= res[k] <= 1.0, f"multi_eval {k} = {res.get(k)}")
        print(f"multi_train {secs['multi_train']:.3f} s ({steps} steps, {2 * val_batches} eval batches, checkpoint), "
              f"multi_eval {secs['multi_eval']:.3f} s: mAP {res['mAP']:.6f}, mIoU {res['mIoU']:.6f}, instAP "
              f"{res['instAP']:.6f}, instAP50 {res['instAP50']:.6f} [{label}]")

        # 6. the official scores of the full-resolution result PNGs
        def score():
            pairs = []
            for s in stems["val"]:
                pred = image_io.imread(str(results / f"{s}_leftImg8bit_pred.png"), image_io.IMREAD_UNCHANGED)
                inst = image_io.imread(str(prep / "SegmentationInstance" / f"{s}_gtFine_instanceIds.png"),
                                       image_io.IMREAD_UNCHANGED).astype(np.int64)
                check(pred.shape == raw_hw and pred.dtype == np.uint8, f"{s}: result PNG {pred.shape} {pred.dtype}")
                gt = image_io.resize_nearest(np.where(inst >= 1000, inst // 1000, inst).astype(np.uint8), pred.shape)
                pairs.append((pred, gt))
            return pairs, cityscapes_eval.evaluate_pairs(pairs)

        pairs, scores = stage("score", score)
        cls = {k: v for k, v in scores["classScores"].items() if not np.isnan(v)}
        check(cls and all(0.0 <= v <= 1.0 for v in cls.values()), f"class scores {scores['classScores']}")
        for k in ("averageScoreClasses", "averageScoreCategories"):
            check(np.isfinite(scores[k]) and 0.0 <= scores[k] <= 1.0, f"{k} = {scores[k]}")
        self_scores = cityscapes_eval.evaluate_pairs([(gt, gt) for _, gt in pairs])
        present = {int(v) for _, gt in pairs for v in np.unique(gt)}
        want_names = {n for n in self_scores["classScores"] if name2label[n].id in present}
        check(want_names and all(self_scores["classScores"][n] == 1.0 for n in want_names)
              and self_scores["averageScoreClasses"] == 1.0, f"GT against itself: {self_scores['classScores']}")
        print(f"official scores of {len(pairs)} full-resolution result PNGs ({raw_hw[0]}x{raw_hw[1]}) against the "
              f"instanceIds' labelIds: averageScoreClasses {scores['averageScoreClasses']:.6f} over {len(cls)} "
              f"classes, averageScoreCategories {scores['averageScoreCategories']:.6f}; each GT against itself 1.0 "
              f"on its {len(want_names)} classes; {secs['score']:.3f} s [{label}]")

        # 7. visualize_net at the two golden shapes; voc_palette both ways
        def visualize():
            lasts = {}
            for shape in ((512, 1024), (320, 640)):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    visualize_net.main(["--network", "resnet-50_multi", "--data-shape", f"3,{shape[0]},{shape[1]}",
                                        "--num-classes", str(NUM_CLASSES)])
                lasts[shape] = buf.getvalue().splitlines()[-1]
            return lasts

        lasts = stage("visualize_net", visualize)
        for shape, n in (((512, 1024), 12264), ((320, 640), 4822)):
            check(lasts[shape] == f"task=multi anchors={n} input={shape[0]}x{shape[1]}", f"visualize_net: {lasts[shape]}")
        rng = np.random.RandomState(12)
        idx = rng.randint(0, 21, (H // 2, W // 2))
        idx[:4] = 255
        (work / "mask.png").write_bytes(make_png(idx, 3, 8, voc_palette.voc_palette()))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            voc_palette.main([str(work / "mask.png"), str(work / "index.png")])
            voc_palette.main(["--colorize", str(work / "index.png"), str(work / "colour.png")])
        check(np.array_equal(image_io.imread(str(work / "index.png"), image_io.IMREAD_UNCHANGED), idx),
              "voc_palette: palette -> index lost the indices")
        check(np.array_equal(image_io.imread(str(work / "colour.png")), image_io.imread(str(work / "mask.png"))),
              "voc_palette: index -> palette is not the mask's colours")
        print(f"visualize_net resnet-50_multi: '{lasts[(512, 1024)]}', '{lasts[(320, 640)]}' (meta device, "
              f"{secs['visualize_net']:.3f} s for both); voc_palette palette -> index -> palette round trip equal")
        record_ = {"seconds": {k: round(v, 3) for k, v in secs.items()},
                   "seconds_per_scene_prepare": secs["prepare_cityscapes"] / (n_train + n_val),
                   "polygons": len(objs), "scores": {k: scores[k] for k in ("averageScoreClasses",
                                                                           "averageScoreCategories")},
                   "eval": {k: res[k] for k in ("mAP", "mIoU", "accuracy", "instAP", "instAP50")}}
        print(f"phase 12 stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()) + f" [{label}]")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    print(json.dumps({"prepare_phase": record_}))
    sys.stdout.flush()
    return launches, errs, record_


KERNEL_KINDS = (  # first match wins, on the lower-cased kernel name
    ("matcher", MATCH_KERNELS),
    ("nms", NMS_KERNELS),
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


# the program a fresh process runs on each bundle (phase 13): torch and the
# operator's registration only, no model code
_LOAD_BUNDLE = r'''
import json, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from dspnet_torch.tools.export_serving import load_bundle
from dspnet_torch.ops import nms_cuda
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
import_s = time.perf_counter() - t0
rec = {}
for path, frames, out in json.loads(sys.argv[2]):
    t0 = time.perf_counter()
    serve = load_bundle(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    raw = torch.from_numpy(np.load(frames)).cuda()
    nms_cuda.launches = nms_cuda.plain_calls = 0
    t0 = time.perf_counter()
    det, seg = serve(raw)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    calls = 1
    for _ in range(2):
        det2, seg2 = serve(raw)
        calls += 1
        assert torch.equal(det2, det) and torch.equal(seg2, seg), "a loaded program differs between calls"
    torch.save({"det": det.cpu(), "seg": seg.cpu()}, out)
    rec[path] = {"load_s": load_s, "first_call_ms": first_ms, "calls": calls,
                 "nms_launches": nms_cuda.launches, "plain_calls": nms_cuda.plain_calls}
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2", "PIL", "dspnet_tpu")
             or m.startswith(("dspnet_torch.models", "dspnet_torch.api", "dspnet_torch.detect",
                              "dspnet_torch.train", "dspnet_torch.data", "dspnet_torch.cli")))
print(json.dumps({"import_s": import_s, "bundles": rec,
                  "dspnet_modules": sorted(m for m in sys.modules if m.startswith("dspnet_torch")),
                  "model_code_imported": bad}))
'''


def host_us_in_turns(fns, n=500, rounds=5):
    """Host microseconds per call of each of ``fns`` (name -> fn), no
    synchronize inside a window, ``rounds`` windows each in turns; the
    card drains between windows."""
    out = {k: [] for k in fns}
    for fn in fns.values():
        for _ in range(20):
            fn()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            out[k].append((time.perf_counter() - t0) / n * 1e6)
            torch.cuda.synchronize()
    return out


def deployment_phase(dev, label):
    """Phase 13, the serving deployment path at resnet-50_multi 512x1024
    (seeded weights): ``tools.export_serving`` bundles at b1 and b8 in
    float32 and bf16, each loaded in a fresh process that imports torch and
    ``dspnet_torch.ops`` only and compared with ``Detector.predict_raw`` on
    the same weights and frames (float32 under deterministic cuDNN: bit for
    bit; bf16: the shares of equal det ids and seg pixels, >= 0.999); the
    NMS launches inside the loaded program (one a call, no plain call); the
    loaded program's b1 ms and b8 img/s beside ``predict_raw``'s in turns;
    the registered operator's host us against the direct ctypes launch it
    wraps; ``Detector(devices=[cuda:0, cuda:0])`` at b1, b3 and b8 against
    the one-device Detector. Returns ({"nms_keep_mask": launches}, record)."""
    from dspnet_torch.api import create_model
    from dspnet_torch.detect.detector import Detector
    from dspnet_torch.ops import nms_cuda
    from dspnet_torch.tools import export_serving

    work = ROOT / "build" / "chip_smoke_export"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    record = {}
    bundle = create_model("resnet-50_multi", (H, W), num_classes=NUM_CLASSES, device=dev,
                          generator=torch.Generator().manual_seed(13))
    frng = np.random.RandomState(13)
    frames = {b: frng.randint(0, 256, (b, H, W, 3), np.uint8) for b in (1, 3, 8)}
    for b in (1, 8):
        np.save(work / f"frames_b{b}.npy", frames[b])
    nms_cuda.launches = nms_cuda.plain_calls = 0
    parent_launches = 0

    # 1. export: b1 and b8, float32 and bf16
    paths = {}
    for dtype in ("float32", "bfloat16"):
        for b in (1, 8):
            t0 = time.perf_counter()
            path = export_serving.export_bundle(bundle, str(work / f"serve_{dtype}_b{b}.pt2"), b, (H, W),
                                                bf16=dtype == "bfloat16")
            secs = time.perf_counter() - t0
            mb = Path(path).stat().st_size / 1e6
            manifest = json.loads(Path(path + ".json").read_text())
            check(manifest["num_anchors"] == 12264 and manifest["dtype"] == dtype and manifest["batch_size"] == b,
                  f"manifest {manifest}")
            paths[dtype, b] = path
            record[f"export {dtype} b{b}"] = {"export_s": secs, "bundle_mb": mb}
            print(f"export_bundle resnet-50_multi 512x1024 {dtype} b{b}: {secs:.3f} s, {mb:.3f} MB [{label}]",
                  flush=True)
    check(nms_cuda.launches == 0 and nms_cuda.plain_calls == 0,
          f"export ran the NMS ({nms_cuda.launches} launches, {nms_cuda.plain_calls} plain calls)")

    # 2. the reference: Detector.predict_raw on the same weights, float32
    # under deterministic cuDNN (the fresh process sets the same)
    det_backends = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dets = {dtype: Detector(bundle.model, bundle.anchors, (H, W), device=dev, dtype=getattr(torch, dtype),
                            nms_thresh=0.45) for dtype in ("float32", "bfloat16")}
    want = {(dtype, b): {k: v.cpu() for k, v in dets[dtype].predict_raw(frames[b]).items()}
            for dtype in dets for b in (1, 8)}
    parent_launches += nms_cuda.launches

    # 3. a fresh process loads each bundle and runs it
    jobs = [(paths[k], str(work / f"frames_b{k[1]}.npy"), str(work / f"out_{k[0]}_b{k[1]}.pt")) for k in paths]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _LOAD_BUNDLE, str(ROOT), json.dumps(jobs)], capture_output=True,
                          text=True, timeout=600, cwd=str(work))
    check(proc.returncode == 0, f"loading the bundles in a fresh process failed:\n{proc.stdout}\n{proc.stderr[-6000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"fresh process ({time.perf_counter() - t0:.3f} s in all; import torch + the loader "
          f"{child['import_s']:.3f} s): dspnet_torch modules {child['dspnet_modules']} [{label}]")
    check(not child["model_code_imported"], f"the loader imported model code: {child['model_code_imported']}")
    child_launches = 0
    for (dtype, b), path in paths.items():
        c = child["bundles"][path]
        check(c["nms_launches"] == c["calls"] and c["plain_calls"] == 0,
              f"{dtype} b{b} bundle: {c['nms_launches']} NMS launches and {c['plain_calls']} plain calls "
              f"in {c['calls']} calls")
        child_launches += c["nms_launches"]
        got = torch.load(work / f"out_{dtype}_b{b}.pt")
        ref = want[dtype, b]
        check(got["det"].shape == ref["det"].shape == (b, 400, 7) and got["det"].dtype == torch.float32,
              f"det {tuple(got['det'].shape)} {got['det'].dtype}")
        check(got["seg"].shape == ref["seg"].shape and got["seg"].dtype == torch.int32,
              f"seg {tuple(got['seg'].shape)} {got['seg'].dtype}")
        ids_equal = float((got["det"][..., 0] == ref["det"][..., 0]).float().mean())
        seg_equal = float((got["seg"] == ref["seg"].int()).float().mean())
        exact = torch.equal(got["det"], ref["det"]) and torch.equal(got["seg"], ref["seg"].int())
        rec = record[f"export {dtype} b{b}"]
        rec.update(load_s=c["load_s"], first_call_ms=c["first_call_ms"], det_ids_equal=ids_equal,
                   seg_equal=seg_equal, bit_for_bit=exact, nms_launches_per_call=c["nms_launches"] / c["calls"])
        print(f"loaded {dtype} b{b} bundle in a fresh process: load {c['load_s']:.3f} s, first call "
              f"{c['first_call_ms']:.3f} ms; vs predict_raw: bit for bit {exact}, det ids equal on "
              f"{ids_equal:.6f} of rows, seg on {seg_equal:.6f} of pixels; NMS {c['nms_launches']} launches in "
              f"{c['calls']} calls, plain 0 [{label}]", flush=True)
        if dtype == "float32":
            check(exact, f"float32 b{b} bundle != predict_raw")
        else:
            check(ids_equal >= 0.999 and seg_equal >= 0.999, f"bf16 b{b} bundle: ids {ids_equal}, seg {seg_equal}")

    # 4. the loaded program against predict_raw, in turns, bf16 (as served)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det_backends
    nms_cuda.launches = 0
    serve = {b: export_serving.load_bundle(paths["bfloat16", b]) for b in (1, 8)}
    detector = dets["bfloat16"]

    def run_bundle(b):
        det, seg = serve[b](torch.from_numpy(frames[b]).pin_memory().to(dev, non_blocking=True))
        return det.cpu(), seg.cpu()  # D2H ends the call, as phase 4's serve

    def run_detector(b):
        res = detector.predict_raw(frames[b])
        return res["det"].cpu(), res["seg"].cpu()

    times = {"bundle": {1: [], 8: []}, "predict_raw": {1: [], 8: []}}
    for fn in (run_bundle, run_detector):
        for b in (1, 8):
            for _ in range(3):
                fn(b)
    for _ in range(3):
        for name, fn in (("predict_raw", run_detector), ("bundle", run_bundle)):
            for b, n in ((1, 30), (8, 10)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn(b)
                dt = (time.perf_counter() - t0) / n
                times[name][b].append(dt * 1e3 if b == 1 else b / dt)
    parent_launches += nms_cuda.launches
    for name, t in times.items():
        print(f"{name} resnet-50_multi 512x1024 bf16 incl. H2D + D2H, 3 runs in turns: b1 "
              + ", ".join(f"{x:.3f}" for x in t[1]) + " ms/call; b8 " + ", ".join(f"{x:.2f}" for x in t[8])
              + f" img/s [{label}]")
    record["b1_ms"] = {k: v[1] for k, v in times.items()}
    record["b8_img_s"] = {k: v[8] for k, v in times.items()}

    # 5. the dispatcher's cost: the operator against the ctypes launch it wraps
    nms_cuda.launches = 0
    rng = np.random.RandomState(233)
    host = {}
    for B in (1, 128):
        args = [torch.from_numpy(a).to(dev) for a in random_rows(rng, B, 400)]
        check(torch.equal(torch.ops.dspnet.nms_keep_mask(*args, 0.45, False), nms_cuda._launch(*args, 0.45, False)),
              f"operator != direct launch at B={B}")
        t = host_us_in_turns({"direct ctypes launch": lambda: nms_cuda._launch(*args, 0.45, False),
                              "operator": lambda: torch.ops.dspnet.nms_keep_mask(*args, 0.45, False),
                              "nms_keep_mask": lambda: nms_cuda.nms_keep_mask(*args, 0.45, False)})
        host[f"B={B} K=400"] = t
        print(f"NMS host us per call at B={B} K=400, 5 windows of 500 calls in turns: "
              + "; ".join(f"{k} " + ", ".join(f"{x:.3f}" for x in v) for k, v in t.items()) + f" [{label}]")
    record["nms_host_us"] = host
    nms_cuda.launches = 0  # these launches time the wrapper; they are not a path

    # 6. two replicas sharing the card against one device, float32, deterministic
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    one = dets["float32"]
    two = Detector(bundle.model, bundle.anchors, (H, W), devices=[dev, dev], nms_thresh=0.45)
    for b in (1, 3, 8):
        got, ref = two.predict_raw(frames[b]), one.predict_raw(frames[b])
        blocks = [one.predict_raw(x) for x in np.array_split(
            np.concatenate([frames[b], np.repeat(frames[b][-1:], (-b) % 2, 0)]), 2)]
        by_block = all(torch.equal(got[k], torch.cat([x[k] for x in blocks])[:b]) for k in ref)
        exact = all(torch.equal(got[k], ref[k]) for k in ref)
        print(f"Detector(devices=[cuda:0, cuda:0]) float32 b{b}: == one-device Detector {exact}; == the "
              f"one-device Detector on each replica's block {by_block}", flush=True)
        record[f"two replicas b{b} equal"] = exact
        check(exact, f"two replicas != one device at b{b}")
    ms = {}
    for name, d in (("one device", one), ("two replicas", two)):
        for _ in range(3):
            d.predict_raw(frames[8])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            res = d.predict_raw(frames[8])
            res["det"].cpu(), res["seg"].cpu()
        ms[name] = (time.perf_counter() - t0) / 10 * 1e3
    print(f"float32 b8 predict_raw incl. H2D + D2H: one device {ms['one device']:.3f} ms, two replicas on "
          f"the card {ms['two replicas']:.3f} ms [{label}]")
    record["b8_ms_float32"] = ms
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det_backends
    parent_launches += nms_cuda.launches
    check(nms_cuda.plain_calls == 0, f"{nms_cuda.plain_calls} plain NMS calls on the deployment path")
    del serve, dets, one, two, detector
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"serving_deployment": record}), flush=True)
    return {"nms_keep_mask": parent_launches + child_launches}, record


def host_loaders_phase(dev, label):
    """Phase 14: the JAX CLIs' host loaders, the reference's run scripts, the
    bench port and the standalone NMS at resnet-50_multi 512x1024 (seeded
    weights, full width and depth), and first the device-list
    ``ServingPipeline``. Returns ({kernel: {path: launches}}, record)."""
    import os
    import tempfile

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import multi_eval, multi_train
    from dspnet_torch.data import jpeg, jpeg_cuda, synthetic
    from dspnet_torch.data.iterator import MultiTaskIterator
    from dspnet_torch.data.native_loader import NativeMultiTaskIterator, native_available
    from dspnet_torch.detect.detector import Detector
    from dspnet_torch.detect.pipeline import ServingPipeline
    from dspnet_torch.ops import matching_cuda, nms_cuda
    from dspnet_torch.ops.nms import nms, nms_keep

    record, secs = {}, {}
    by_path = {"nms_keep_mask": {}, "bipartite_match": {}, "jpeg_ycc_to_bgr": {}}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_host_", dir=ROOT / "build"))
    rng = np.random.RandomState(14)

    def run(pipe, frames):
        out = [x for x in (pipe.submit(f, tag=i) for i, f in enumerate(frames)) if x is not None]
        return out + list(pipe.drain())

    try:
        # ---- 14a. ServingPipeline over Detector(devices=[cuda:0, cuda:0]): one graph
        # per replica per slot, against the synchronous device-list path, bf16
        t0 = time.perf_counter()
        bundle = create_model("resnet-50_multi", (H, W), NUM_CLASSES, device=dev,
                              generator=torch.Generator().manual_seed(14))
        backends = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        two = Detector(bundle.model, bundle.anchors, (H, W), devices=[dev, dev], dtype=torch.bfloat16)
        one = Detector(bundle.model, bundle.anchors, (H, W), device=dev, dtype=torch.bfloat16)
        nms_cuda.launches = nms_cuda.plain_calls = 0
        sync_calls = graphs = 0
        for depth in (1, 3):
            pipe = ServingPipeline(two, depth=depth)
            for b in (1, 3, 8):
                frames = rng.randint(0, 256, (2 * (depth + 1) + 1, b, H, W, 3), np.uint8)
                want = [{k: v.cpu().numpy() for k, v in two.predict_raw(f).items()} for f in frames]
                sync_calls += len(frames)
                got = run(pipe, frames)
                graphs += 2 * (depth + 1)
                ok = [t for t, _ in got] == list(range(len(frames))) and all(
                    np.array_equal(r[k], w[k]) for (_, r), w in zip(got, want) for k in w)
                record[f"device-list pipeline depth {depth} b{b} == sync"] = ok
                check(ok, f"device-list ServingPipeline depth {depth} b{b} != the synchronous device-list path")
            del pipe
        expect = 2 * sync_calls + 2 * graphs  # a launch per replica a call; warm-up + capture a graph
        check(nms_cuda.launches == expect and nms_cuda.plain_calls == 0,
              f"device-list pipeline: {nms_cuda.launches} NMS launches (expected {expect}), "
              f"{nms_cuda.plain_calls} plain")
        print(f"ServingPipeline over Detector(devices=[cuda:0, cuda:0]) bf16 {H}x{W}: b1, b3, b8 at depths 1 and "
              f"3 equal the synchronous device-list predict_raw bit for bit and in order; NMS launches "
              f"{nms_cuda.launches} = 2 x {sync_calls} synchronous calls + 2 x {graphs} graph captures "
              f"(one graph per replica per slot per shape), plain 0", flush=True)
        pipes = {"one device": ServingPipeline(one, depth=3), "two replicas": ServingPipeline(two, depth=3)}
        frames = rng.randint(0, 256, (40, 1, H, W, 3), np.uint8)
        for p in pipes.values():
            run(p, frames[:8])  # each slot captures
        ms = {k: [] for k in pipes}
        for _ in range(3):
            for name, p in pipes.items():
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                run(p, frames[8:])
                ms[name].append((time.perf_counter() - t1) / 32 * 1e3)
        by_path["nms_keep_mask"]["device_list_pipeline"] = nms_cuda.launches
        print("ServingPipeline depth 3, b1 frames (host uint8 in, numpy out), ms/frame in 3 turns: "
              + "; ".join(f"{k} {', '.join(f'{v:.3f}' for v in vs)}" for k, vs in ms.items()) + f" [{label}]")
        record["pipeline_depth3_b1_ms_per_frame"] = ms
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = backends
        del pipes, two, one, bundle
        torch.cuda.empty_cache()
        secs["device-list pipeline"] = time.perf_counter() - t0

        # ---- 14b. multi_train / multi_eval --loader python and --loader native, with
        # 14c, dspnet_torch/scripts/run_multi.sh train -> eval -> demo (LOADER unset: native),
        # in fresh processes on a thread of its own meanwhile (the counters are this process's)
        t0 = time.perf_counter()
        B, n_train, n_val = 4, 8, 4
        synth = work / "synth"
        train_index = synthetic.build_dataset(str(synth / "train"), n_train, (H, W), seed=233)
        env = dict(os.environ, PYTHON=sys.executable, MODEL_DIR=str(work / "run_multi"))
        env.pop("LOADER", None)
        script = str(ROOT / "dspnet_torch" / "scripts" / "run_multi.sh")
        rdata = ["--synthetic", "4", "--synthetic-dir", str(work / "run_multi_data")]
        runs = {"train": ["--end-epoch", "1", *rdata], "eval": rdata,
                "demo": ["--images", ",".join(s_.image_path for s_ in train_index.samples[:2]),
                         "--out-dir", str(work / "demo")]}
        script_s, chain_err = {}, []

        def run_chain():
            # train, then eval and demo side by side (both read train's checkpoint)
            for modes in (("train",), ("eval", "demo")):
                t1 = time.perf_counter()
                procs = {m: subprocess.Popen([script, m, "multi", *runs[m]], cwd=str(work), env=env, text=True,
                                             stdout=subprocess.PIPE, stderr=subprocess.PIPE) for m in modes}
                for m, proc in procs.items():
                    _, err = proc.communicate(timeout=400)
                    script_s[m] = time.perf_counter() - t1
                    if proc.returncode != 0:
                        chain_err.append(f"{m} exited {proc.returncode}: {err[-2000:]}")
                    elif m == "train" and "using the native loader" not in err:
                        chain_err.append("train did not use the native loader")
                if chain_err:
                    return

        import threading

        chain = threading.Thread(target=run_chain)
        chain.start()
        # meanwhile, on the host: a layout with a photograph's texture over the
        # same kind of scenes, for the loaders alone and the native-vs-python gap
        n_tex, textured = 16, {}

        def build_textured():
            t1 = time.perf_counter()
            textured["index"] = synthetic.build_dataset(str(work / "textured"), n_tex, (H, W), seed=233,
                                                        texture=True)
            textured["s"] = time.perf_counter() - t1

        tex_thread = threading.Thread(target=build_textured)
        tex_thread.start()
        check(native_available(dev), "native_available() is false on the card")
        net = ["--network", "resnet-50_multi", "--data-shape", f"3,{H},{W}", "--num-classes", str(NUM_CLASSES),
               "--batch-size", str(B), "--device", "cuda"]
        train_data = ["--synthetic", str(n_train), "--synthetic-val", str(n_val), "--synthetic-dir", str(synth)]
        val_data = ["--synthetic", str(n_val), "--synthetic-dir", str(synth)]
        loaders = {}

        def counted(fn, loader, what, steps, eval_batches, images):
            nms_cuda.launches = matching_cuda.launches = nms_cuda.plain_calls = matching_cuda.plain_calls = 0
            jpeg_cuda.images = jpeg.decodes = jpeg_cuda.color_launches = jpeg_cuda.color_plain_calls = 0
            t1 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            s = time.perf_counter() - t1
            got = {"bipartite_match": matching_cuda.launches, "nms_keep_mask": nms_cuda.launches,
                   "plain_match": matching_cuda.plain_calls, "plain_nms": nms_cuda.plain_calls,
                   "nvjpeg_images": jpeg_cuda.images, "plain_jpeg_decodes": jpeg.decodes,
                   "jpeg_ycc_to_bgr": jpeg_cuda.color_launches, "plain_colour": jpeg_cuda.color_plain_calls}
            python = loader == "python"
            want = {"bipartite_match": steps, "nms_keep_mask": eval_batches, "plain_match": 0, "plain_nms": 0,
                    "nvjpeg_images": 0 if python else images, "plain_jpeg_decodes": images if python else 0,
                    "jpeg_ycc_to_bgr": 0 if python else images, "plain_colour": 0}
            check(got == want, f"{what}: counts {got}, expected {want}")
            print(f"{what}: {s:.2f} s; matcher {got['bipartite_match']} launches in {steps} train steps, NMS "
                  f"{got['nms_keep_mask']} in {eval_batches} eval batches, plain 0 and 0; nvJPEG images "
                  f"{got['nvjpeg_images']}, colour kernel {got['jpeg_ycc_to_bgr']}, plain JPEG decodes "
                  f"{got['plain_jpeg_decodes']} (of {images} images read) [{label}]", flush=True)
            for k in by_path:
                path = f"{loader}_loader"
                by_path[k][path] = by_path[k].get(path, 0) + got[k]
            return out, s

        for loader, extra in (("python", []), ("native", ["--native-u8"])):
            md = str(work / f"model_{loader}")
            st, _ = counted(lambda: multi_train.main(
                net + train_data + ["--compute-dtype", "bfloat16", "--seg-normalize", "valid", "--lr", "5e-4",
                                    "--end-epoch", "1", "--eval-every", "1", "--log-every", "1", "--model-dir", md,
                                    "--loader", loader] + extra),
                loader, f"multi_train --loader {loader} {' '.join(extra)}".strip(), n_train // B, 1, n_train + n_val)
            check(st.step == n_train // B, f"--loader {loader}: step {st.step}")
            res, _ = counted(lambda: multi_eval.main(net + val_data + ["--model-dir", md, "--loader", loader] + extra),
                             loader, f"multi_eval --loader {loader} {' '.join(extra)}".strip(), 0, 1, n_val)
            check(all(np.isfinite(res[k]) for k in ("mAP", "mIoU", "accuracy")), f"multi_eval {loader}: {res}")
            loaders[loader] = {k: res[k] for k in ("mAP", "mIoU", "accuracy", "ms_per_batch")}

        # still beside run_multi.sh (no timing here): a native batch against a
        # python batch on the same samples, on the flat scenes and on the
        # textured ones, with planted faults (the native batch moved by one
        # pixel, and bilinear by half a pixel): flat colours hide such a shift
        # from the JAX bounds, the texture does not
        tex_thread.join()
        check("index" in textured, "the textured layout was not written")
        print(f"textured layout: {n_tex} images {H}x{W} (synthetic.texture_offsets over the scenes) written in "
              f"{textured['s']:.2f} s on the host, beside 14b [{label}]", flush=True)
        gaps = {}

        def shifted(images, pixels):
            one = np.concatenate([images[:, :, :1], images[:, :, :-1]], axis=2)
            return one if pixels == 1 else 0.5 * (images + one)

        for data, index in (("flat", train_index), ("textured", textured["index"])):
            py = MultiTaskIterator(index, B, (H, W), enable_aug=True)
            pb, pnames = py.next_batch()
            nat = NativeMultiTaskIterator(index, B, (H, W), enable_aug=True, num_threads=8,
                                          device_normalize=True, device=dev)
            nb = nat.next_batch()
            check(all(v.device.type == "cuda" for v in nb.values()) and nat.last_names == pnames,
                  "native batch not on the card or not the python batch's samples")
            nb = {k: v.cpu().numpy() for k, v in nb.items()}
            nat.close()
            gap = {}
            for name, images in (("native", nb["images"]), ("native moved 1 px", shifted(nb["images"], 1)),
                                 ("native moved 0.5 px", shifted(nb["images"], 0.5))):
                diff = np.abs(images - pb["images"])
                gap[name] = {"images_mean_abs": float(diff.mean()), "images_p99_abs": float(np.percentile(diff, 99))}
            gap["native"].update(seg_mismatch=float(np.mean(nb["seg_label"] != pb["seg_label"])),
                                 labels_max_abs=float(np.abs(nb["label_det"] - pb["label_det"]).max()))
            gaps[data] = gap
            g = gap["native"]
            print(f"native (nvJPEG + the card's warp) vs python (plain decoder + cv2's warp in numpy), {data} "
                  f"images, b{B} on the same samples and tables: images mean abs {g['images_mean_abs']:.4f} "
                  f"(bound < 1.0), p99 {g['images_p99_abs']:.4f} (bound <= 16), seg mismatch "
                  f"{g['seg_mismatch']:.5f} (bound < 0.02), labels max abs {g['labels_max_abs']:.3e} (bound "
                  f"2e-4), the JAX package's native-vs-python bounds; planted faults: moved 1 px mean "
                  f"{gap['native moved 1 px']['images_mean_abs']:.4f}, moved 0.5 px mean "
                  f"{gap['native moved 0.5 px']['images_mean_abs']:.4f}", flush=True)
            check(g["images_mean_abs"] < 1.0 and g["images_p99_abs"] <= 16.0 and g["seg_mismatch"] < 0.02
                  and g["labels_max_abs"] <= 2e-4, f"native vs python outside the JAX bounds on {data}: {g}")
        check(all(gaps["textured"][f]["images_mean_abs"] >= 1.0 for f in ("native moved 1 px", "native moved 0.5 px")),
              f"a planted shift passes the JAX bounds on the textured images: {gaps['textured']}")

        # ---- 14c. (joined) run_multi.sh train -> eval -> demo
        chain.join()
        check(not chain_err, f"run_multi.sh: {chain_err}")
        check(len(os.listdir(work / "demo")) == 2, "run_multi.sh demo wrote no pictures")
        print("dspnet_torch/scripts/run_multi.sh (LOADER unset: native) train -> eval and demo at resnet-50_multi "
              f"{H}x{W}, exit 0 each: " + ", ".join(f"{k} {v:.1f} s" for k, v in script_s.items())
              + f" (each a fresh process; eval and demo side by side after train, all beside 14b's CLI runs) "
              f"[{label}]", flush=True)
        record["run_multi_s"] = script_s
        secs["CLIs and loader comparisons, run_multi.sh beside"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # each loader alone on the textured layout, after run_multi.sh:
        # python two batches (nothing to warm up; the plain decoder and the
        # numpy warp take about a second an image), native four epochs after a
        # warm-up epoch
        py = MultiTaskIterator(textured["index"], B, (H, W), enable_aug=True)
        t1 = time.perf_counter()
        n_py = sum(len(py.next_batch()[1]) for _ in range(2))
        py_s = time.perf_counter() - t1
        nat = NativeMultiTaskIterator(textured["index"], B, (H, W), enable_aug=True, num_threads=8, device=dev)
        list(nat.epoch())  # warm: the first epoch's threads and buffers
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n_nat = sum(len(names) for _ in range(4) for batch, names in nat.epoch())
        torch.cuda.synchronize()
        nat_s = time.perf_counter() - t1
        ips = {"python": n_py / py_s, "native": n_nat / nat_s}
        print(f"loader alone at {H}x{W} with augmentation, textured JPEGs: python {ips['python']:.3f} img/s "
              f"({n_py} images in {py_s:.3f} s, host decode + numpy warp, one thread), native "
              f"{ips['native']:.3f} img/s ({n_nat} images in {nat_s:.3f} s, 4 epochs of {n_tex}, nvJPEG + warp on "
              f"the card, 8 read threads) [{label}]", flush=True)
        record["loaders"] = {"img_per_s_alone": ips, "images_timed": {"python": n_py, "native": n_nat},
                             "native_vs_python": gaps, "eval": loaders}
        secs["loaders alone"] = time.perf_counter() - t0

        # ---- 14d. dspnet_torch.bench in its three modes: the default one as
        # `python -m dspnet_torch.bench` in a fresh process (its launches are
        # that process's, not counted here), then BENCH_TRAIN and BENCH_SERVE
        # through bench.main, what that command runs, in this process (two
        # process starts saved; their launches counted)
        from dspnet_torch import bench

        t0 = time.perf_counter()
        bench_rows = {}
        modes = ("BENCH_TRAIN", "BENCH_SERVE", "BENCH_SEG_FAST")
        benv = {k: v for k, v in os.environ.items() if k not in modes}
        proc = subprocess.run([sys.executable, "-m", "dspnet_torch.bench"], cwd=str(ROOT), env=benv,
                              capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0, f"python -m dspnet_torch.bench exited {proc.returncode}: {proc.stderr[-2000:]}")
        lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
        check(len(lines) == 1, f"python -m dspnet_torch.bench printed {len(lines)} JSON lines")
        print(lines[0], flush=True)
        bench_rows["default"] = json.loads(lines[0])
        secs["bench default, a fresh process"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        saved = {k: os.environ.pop(k) for k in modes if k in os.environ}
        nms_cuda.launches = matching_cuda.launches = nms_cuda.plain_calls = matching_cuda.plain_calls = 0
        try:
            for mode in ("BENCH_TRAIN", "BENCH_SERVE"):
                os.environ[mode] = "1"
                try:
                    bench_rows[mode] = bench.main([])  # prints its JSON line
                finally:
                    os.environ.pop(mode, None)
                torch.cuda.empty_cache()
        finally:
            os.environ.update(saved)
        check(bench_rows["default"]["metric"] == "multitask_inference_throughput_512x512"
              and bench_rows["BENCH_TRAIN"]["metric"] == "multitask_train_step_512x1024_b8_bf16"
              and bench_rows["BENCH_SERVE"]["metric"] == "serving_latency_512x1024_b1", "bench metric names")
        check(nms_cuda.plain_calls == 0 and matching_cuda.plain_calls == 0, "plain calls in the bench")
        by_path["nms_keep_mask"]["bench"] = nms_cuda.launches
        by_path["bipartite_match"]["bench"] = matching_cuda.launches
        secs["bench train and serve, in this process"] = time.perf_counter() - t1
        print(f"bench: default as `python -m dspnet_torch.bench` in a fresh process "
              f"({secs['bench default, a fresh process']:.1f} s); BENCH_TRAIN and BENCH_SERVE through bench.main in "
              f"this process ({secs['bench train and serve, in this process']:.1f} s): NMS {nms_cuda.launches} "
              f"launches, matcher {matching_cuda.launches}, plain 0 [{label}]", flush=True)
        record["bench"] = bench_rows
        secs["bench"] = time.perf_counter() - t0

        # ---- 14e. the standalone NMS: nms (host) against nms_keep on the card
        t0 = time.perf_counter()
        cases = 0
        for seed in (233, 1, 2):
            r_ = np.random.RandomState(seed)
            for n in (40, 400):
                c = np.stack([r_.uniform(0.05, 0.95, n), r_.uniform(0.05, 0.95, n)], -1)
                wh = np.stack([r_.uniform(0.02, 0.5, n), r_.uniform(0.02, 0.5, n)], -1)
                dets = np.concatenate([np.concatenate([c - wh / 2, c + wh / 2], -1) * 100,
                                       (r_.permutation(n) / n)[:, None]], -1).astype(np.float32)
                for thresh in (0.3, 0.5, 0.7):
                    keep = nms_keep(torch.from_numpy(dets).to(dev), thresh)
                    check(keep.device.type == "cuda", "nms_keep left the card")
                    want = np.zeros(n, bool)
                    want[nms(dets, thresh)] = True
                    check(np.array_equal(keep.cpu().numpy(), want), f"nms_keep != nms (seed {seed}, n {n}, {thresh})")
                    cases += 1
        print(f"ops/nms.py: nms_keep on the card == nms on the host in {cases} cases (N = 40 and 400, "
              f"thresholds 0.3 / 0.5 / 0.7, tests/test_ops.py's boxes)", flush=True)
        secs["nms"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    record["stage_seconds"] = {k: round(v, 3) for k, v in secs.items()}
    print(f"phase 14 stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()) + f" [{label}]")
    print(json.dumps({"host_loaders_phase": record}), flush=True)
    return by_path, record


def jax_checkpoints_phase(dev, label):
    """Phase 15: the JAX package's Orbax checkpoints on the card, without
    JAX: the committed resnet-50_multi 512x1024 fixture (written by the JAX
    package's ``CheckpointManagerWrapper.save``, ``tests/fixtures/
    jax_orbax/``) read leaf for leaf against its recorded sha256s, restored
    into the card's state, then its model dir through ``multi_eval``,
    ``multi_train --resume 0`` and ``multi_eval`` on each epoch. Returns
    ({kernel: {path: launches}}, record)."""
    import hashlib
    import logging
    import re
    import tempfile

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import multi_eval, multi_train
    from dspnet_torch.data import jpeg, jpeg_cuda, synthetic
    from dspnet_torch.ops import matching_cuda, nms_cuda
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils import orbax_read, zstd
    from dspnet_torch.utils.checkpoint import CheckpointManager, state_from_flax

    fixture = ROOT / "tests" / "fixtures" / "jax_orbax"
    meta = json.loads((fixture / "leaves.json").read_text())
    prefix, epoch, step = fixture / meta["prefix"], meta["epoch"], meta["step"]
    record, secs = {}, {}
    by_path = {"nms_keep_mask": {}, "bipartite_match": {}, "jpeg_ycc_to_bgr": {}}
    B, n_train, n_val = 4, 8, 8
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_jax_ckpt_", dir=ROOT / "build"))
    try:
        # ---- 15a. libzstd, then every leaf read on the host, bit for bit
        zstd.library()
        with open("/proc/self/maps") as f:  # the file the loader resolved
            path = sorted({line.split()[-1] for line in f if "libzstd" in line})
        record["libzstd"] = {"path": path, "version": zstd.version()}
        print(f"libzstd {zstd.version()} loaded from {', '.join(path)} (ctypes; no Python zstd module)", flush=True)
        on_disk = sum(f.stat().st_size for f in (prefix / str(epoch)).rglob("*") if f.is_file())
        t0 = time.perf_counter()
        tree, got_epoch = orbax_read.restore_raw(str(prefix))
        read_s = time.perf_counter() - t0
        leaves = {}

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    leaves[".".join(path + (k,))] = v

        walk(tree, ())
        check(got_epoch == epoch and sorted(leaves) == sorted(meta["leaves"]),
              f"read epoch {got_epoch}, {len(leaves)} leaves against {len(meta['leaves'])}")
        bad = [k for k, rec in meta["leaves"].items()
               if [leaves[k].dtype.name, list(leaves[k].shape)] != [rec["dtype"], rec["shape"]]
               or hashlib.sha256(leaves[k].tobytes()).hexdigest() != rec["sha256"]]
        check(not bad, f"{len(bad)} leaves differ from the JAX package's sha256s: {bad[:3]}")
        mib = sum(v.nbytes for v in leaves.values()) / 2**20
        record.update(leaves=len(leaves), values_mib=round(mib, 3), on_disk_bytes=on_disk, read_s=read_s,
                      read_mib_per_s=mib / read_s)
        print(f"{meta['network']} {meta['data_shape'][0]}x{meta['data_shape'][1]} JAX checkpoint (epoch {epoch}, "
              f"{on_disk} bytes on disk): {len(leaves)} leaves, {mib:.3f} MiB, every sha256 equal to the JAX "
              f"package's restore_raw; read in {read_s:.3f} s ({mib / read_s:.1f} MiB/s of values) [{label}]",
              flush=True)
        secs["read"] = read_s

        # ---- 15b. restored into the card's state: names, shapes, values, the step
        bundle = create_model(meta["network"], tuple(meta["data_shape"]), NUM_CLASSES, device=dev,
                              generator=torch.Generator().manual_seed(15))
        template = MultiTaskSolver(bundle.model, bundle.anchors, device=dev).init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, got_epoch = CheckpointManager(str(prefix)).restore(None, template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        want = state_from_flax(tree)
        check(got_epoch == epoch and state.step == step, f"restored epoch {got_epoch} step {state.step}")
        n = 0
        for g in ("params", "buffers", "momentum"):
            for k, t in getattr(state, g).items():
                check(t.device.type == "cuda" and torch.equal(t.detach().cpu(), getattr(want, g)[k].detach()),
                      f"restored {g} {k} != the checkpoint")
                n += 1
        record.update(restore_s=restore_s, tensors=n)
        print(f"CheckpointManager.restore of the JAX epoch into the card's TrainState: {n} tensors equal bit "
              f"for bit, step {state.step} (the JAX step), in {restore_s:.3f} s (the read, state_from_flax, the "
              f"copies to the card) [{label}]", flush=True)
        secs["restore"] = restore_s
        del state, template, want, tree, leaves, bundle
        torch.cuda.empty_cache()

        # ---- 15c. the model dir through the CLIs, counted
        model = work / "models"
        shutil.copytree(fixture / "models", model)
        synth = work / "synth"
        t0 = time.perf_counter()
        synthetic.build_dataset(str(synth / "train"), n_train, (H, W), seed=233)
        synthetic.build_dataset(str(synth / "val"), n_val, (H, W), seed=91)
        secs["dataset write"] = time.perf_counter() - t0
        net = ["--network", meta["network"], "--data-shape", f"3,{H},{W}", "--num-classes", str(NUM_CLASSES),
               "--batch-size", str(B), "--synthetic", str(n_val), "--synthetic-dir", str(synth),
               "--model-dir", str(model)]
        eval_batches, steps = -(-n_val // B), n_train // B

        def counted(name, run, want_steps, want_batches, images):
            nms_cuda.launches = matching_cuda.launches = nms_cuda.plain_calls = matching_cuda.plain_calls = 0
            jpeg_cuda.images = jpeg.decodes = jpeg_cuda.color_launches = jpeg_cuda.color_plain_calls = 0
            seen = []
            handler = logging.Handler()
            handler.emit = lambda r: seen.append(r.getMessage())
            logging.getLogger().addHandler(handler)
            t1 = time.perf_counter()
            try:
                out = run()
            finally:
                logging.getLogger().removeHandler(handler)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t1
            got = {"bipartite_match": matching_cuda.launches, "nms_keep_mask": nms_cuda.launches,
                   "jpeg_ycc_to_bgr": jpeg_cuda.color_launches, "nvjpeg_images": jpeg_cuda.images,
                   "plain": nms_cuda.plain_calls + matching_cuda.plain_calls + jpeg.decodes
                   + jpeg_cuda.color_plain_calls}
            expect = {"bipartite_match": want_steps, "nms_keep_mask": want_batches, "jpeg_ycc_to_bgr": images,
                      "nvjpeg_images": images, "plain": 0}
            check(got == expect, f"{name}: counts {got}, expected {expect}")
            for k in by_path:
                by_path[k][name] = got[k]
            print(f"{name}: matcher {got['bipartite_match']} launches in {want_steps} steps, NMS "
                  f"{got['nms_keep_mask']} in {want_batches} eval batches, nvJPEG and the colour kernel "
                  f"{images} images, plain calls 0; {secs[name]:.1f} s [{label}]", flush=True)
            return out, seen

        def finite(res, name):
            check(all(np.isfinite(res[k]) for k in ("mAP", "mIoU", "accuracy", "derror")), f"{name}: {res}")
            return {k: float(res[k]) for k in ("mAP", "mIoU", "accuracy", "derror", "ms_per_batch")}

        res, seen = counted("multi_eval on the JAX model dir", lambda: multi_eval.main(net), 0, eval_batches, n_val)
        check(f"loaded checkpoint epoch {epoch} (step {step})" in seen, "multi_eval did not load the JAX epoch")
        record["eval_jax_epoch"] = finite(res, "multi_eval")
        print(f"multi_eval on the JAX epoch {epoch}: {record['eval_jax_epoch']}", flush=True)

        train = (net[:-4] + ["--synthetic", str(n_train), "--synthetic-val", str(n_val)] + net[-4:]
                 + ["--compute-dtype", "bfloat16", "--seg-normalize", "valid", "--lr", "5e-4", "--eval-every", "0",
                    "--log-every", "1", "--resume", "0", "--end-epoch", str(epoch + 2)])
        st, seen = counted("multi_train --resume 0 on the JAX model dir", lambda: multi_train.main(train), steps, 0,
                           n_train)
        ckpt = CheckpointManager(str(model / Path(meta["prefix"]).name))
        written = sorted(p.name for p in Path(ckpt.prefix).iterdir())
        check(f"resumed from epoch {epoch} (step {step})" in seen and st.step == step + steps
              and ckpt.epochs() == [epoch, epoch + 1] and written == sorted([str(epoch), f"{epoch + 1:04d}.pt"]),
              f"resume: step {st.step}, epochs {ckpt.epochs()}, files {written}")
        losses = [float(re.search(r"[:,] loss=([^,]+)", m).group(1)) for m in seen if " batch " in m]
        check(len(losses) == steps and all(np.isfinite(losses)), f"resumed steps' losses {losses}")
        record["resume"] = {"from_step": step, "to_step": st.step, "files": written, "loss_lines": losses}
        print(f"multi_train --resume 0: resumed at epoch {epoch} from the JAX step {step}, ended at step {st.step}, "
              f"epoch {epoch + 1} written as {epoch + 1:04d}.pt beside the Orbax step {epoch}/ ({written})", flush=True)
        del st

        res, seen = counted("multi_eval on the .pt epoch", lambda: multi_eval.main(net), 0, eval_batches, n_val)
        check(f"loaded checkpoint epoch {epoch + 1} (step {step + steps})" in seen, "multi_eval did not pick the .pt")
        record["eval_pt_epoch"] = finite(res, "multi_eval latest")
        res, seen = counted("multi_eval --epoch on the Orbax epoch",
                            lambda: multi_eval.main(net + ["--epoch", str(epoch)]), 0, eval_batches, n_val)
        check(f"loaded checkpoint epoch {epoch} (step {step})" in seen, "multi_eval --epoch did not read Orbax")
        record["eval_jax_epoch_again"] = finite(res, "multi_eval --epoch")
        print(f"multi_eval on the latest (.pt, epoch {epoch + 1}): {record['eval_pt_epoch']}; with --epoch {epoch} "
              f"(Orbax): {record['eval_jax_epoch_again']}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    record["stage_seconds"] = {k: round(v, 3) for k, v in secs.items()}
    print("phase 15 stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()) + f" [{label}]")
    print(json.dumps({"jax_checkpoints_phase": record}), flush=True)
    return by_path, record


def video_phase(dev, label):
    """Phase 16: video through ``multi_demo`` at resnet-50_multi 512x1024
    bf16 on seeded weights (seed 16): a Motion-JPEG AVI of 64 textured
    1024x2048 frames written by the port (nvJPEG's encoder, ``data/avi.py``),
    ``multi_demo --images clip.avi`` under the profiler and again timed, the
    rendered frames against a synchronous replay, the output file against
    the rendered frames, the overlay against numpy, the committed clips of
    cv2's two writers and a DHT-less copy, the JPEG forms the decoders
    learned, and the time of each stage per frame. Returns ({kernel: {path:
    launches}}, record)."""
    import hashlib
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import multi_demo
    from dspnet_torch.data import avi, jpeg, jpeg_cuda, mp4, mpeg4, mpeg4_cuda, synthetic
    from dspnet_torch.data.device_pipeline import resize_linear
    from dspnet_torch.detect import video
    from dspnet_torch.detect.pipeline import ServingPipeline
    from dspnet_torch.ops import nms_cuda
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils import draw, text
    from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix

    net, n_frames, FH, FW, thresh = "resnet-50_multi", 64, 1024, 2048, 0.3
    fixture = ROOT / "tests" / "fixtures" / "video"
    meta = json.loads((fixture / "frames.json").read_text())
    launches = {"nms_keep_mask": {}, "jpeg_ycc_to_bgr": {}}
    record, secs = {}, {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_video_", dir=ROOT / "build"))

    def reset():
        nms_cuda.launches = jpeg_cuda.launches = jpeg_cuda.images = jpeg_cuda.encodes = 0
        jpeg_cuda.color_launches = jpeg_cuda.color_plain_calls = jpeg.decodes = jpeg.encodes = mpeg4.encodes = 0
        jpeg_cuda.routes.update(dict.fromkeys(jpeg_cuda.routes, 0))

    def counts():
        return {"nms": nms_cuda.launches, "nvjpeg_images": jpeg_cuda.images, "colour": jpeg_cuda.color_launches,
                "card_encodes": jpeg_cuda.encodes, "mp4v_encodes": mpeg4.encodes, "plain_decodes": jpeg.decodes,
                "plain_encodes": jpeg.encodes, "plain_colour": jpeg_cuda.color_plain_calls}

    def psnr(a, b):
        mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
        return 10 * np.log10(255.0 ** 2 / mse)

    try:
        # ---- 16a. seeded weights as epoch 0; 64 textured frames to a clip by the card's encoder
        t0 = time.perf_counter()
        src = create_model(net, (H, W), num_classes=NUM_CLASSES, device=dev,
                           generator=torch.Generator().manual_seed(16))
        model_dir = work / "model"
        CheckpointManager(checkpoint_prefix(str(model_dir), net, H)).save(
            0, MultiTaskSolver(src.model, src.anchors, device=dev).init_state())
        del src
        rng = np.random.RandomState(16)
        scene = synthetic.make_example(rng, (FH, FW + 4 * n_frames), 6)[0].astype(np.float32)
        scene += synthetic.texture_offsets(rng, scene.shape[:2])
        scene = torch.from_numpy(np.clip(np.rint(scene), 0, 255).astype(np.uint8)).to(dev)
        clip = work / "clip.avi"
        jpeg_cuda.encodes = 0
        with avi.AviWriter(clip, FW, FH, 25) as writer:
            for i in range(n_frames):
                writer.write(jpeg_cuda.encode(scene[:, 4 * i:4 * i + FW].contiguous()))
        check(jpeg_cuda.encodes == n_frames, f"{jpeg_cuda.encodes} card encodes for {n_frames} clip frames")
        del scene
        secs["clip written"] = time.perf_counter() - t0
        print(f"phase 16 input: {n_frames} textured {FH}x{FW} frames encoded by nvJPEG (q95 4:2:0) into "
              f"{clip.stat().st_size / 2**20:.2f} MiB of Motion-JPEG AVI in {secs['clip written']:.2f} s "
              f"(with the seeded checkpoint) [{label}]", flush=True)

        # ---- 16b. multi_demo on the clip under the profiler: the counts
        out_dir = work / "out"
        demo_args = ["--network", net, "--data-shape", f"3,{H},{W}", "--model-dir", str(model_dir), "--epoch", "0",
                     "--dtype", "bfloat16", "--vis-thresh", str(thresh), "--out-dir", str(out_dir),
                     "--device", str(dev), "--images", str(clip)]
        reset()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            written = multi_demo.main(demo_args)
            torch.cuda.synchronize()
        secs["multi_demo profiled"] = time.perf_counter() - t0
        got = counts()
        kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        ran_nms = sum(any(n in k for n in NMS_KERNELS) for k in kernels)
        slots = 3  # ServingPipeline(depth=2): depth + 1 slots, each warmed up once and captured once
        want = {"nms": 2 * slots, "nvjpeg_images": n_frames, "colour": n_frames, "card_encodes": 0,
                "mp4v_encodes": n_frames, "plain_decodes": 0, "plain_encodes": 0, "plain_colour": 0}
        check(got == want, f"multi_demo on the clip: counts {got}, expected {want}")
        check(ran_nms == n_frames + slots,
              f"{ran_nms} NMS kernels ran for {n_frames} frames (+ {slots} warm-ups); expected {n_frames + slots}")
        check(written == [str(out_dir / "detection_out.mp4")], f"multi_demo wrote {written}")
        with avi.open_video(written[0]) as reader:
            out_frames = list(reader)
            stream = reader.stream
        check((len(out_frames), stream.fps, stream.width, stream.height, stream.fourcc) == (n_frames, 25.0, FW, FH,
                                                                                            "mp4v"),
              f"detection_out.mp4: {len(out_frames)} frames, {stream[:5]}")
        launches["nms_keep_mask"]["video_demo"] = got["nms"]
        launches["jpeg_ycc_to_bgr"]["video_demo"] = got["colour"]
        record["counts"] = dict(got, nms_kernels_run=ran_nms, routes=dict(jpeg_cuda.routes))
        print(f"multi_demo --images clip.avi ({n_frames} frames in, {len(out_frames)} out, 25 fps {FW}x{FH} read "
              f"back): counts {got}; under the profiler {ran_nms} NMS kernels ran ({n_frames} replayed frames + "
              f"{slots} warm-ups; the wrapper counts the warm-up and capture of each slot); routes "
              f"{jpeg_cuda.routes} [{label}]", flush=True)

        # ---- 16c. the same run timed, without the profiler
        reset()
        t0 = time.perf_counter()
        multi_demo.main(demo_args)
        torch.cuda.synchronize()
        secs["multi_demo"] = time.perf_counter() - t0
        check(counts() == want, f"timed multi_demo counts {counts()}")

        # ---- 16d. pixels: pipeline == synchronous replay, file ~ rendered, overlay == numpy
        t_sub = time.perf_counter()
        detector = multi_demo.get_detector(multi_demo.parse_args(demo_args))
        with avi.open_video(clip) as reader:
            buffers = list(reader)
        t0 = time.perf_counter()
        rendered = list(video.render(detector, buffers, thresh, 0.95))
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        decoded = [f for i in range(0, n_frames, 8) for f in jpeg_cuda.decode_images(buffers[i:i + 8], dev)]
        overlay_equal = 0
        for i, frame in enumerate(decoded):
            res = detector.predict_raw(resize_linear(frame, (H, W))[None])
            dets = video.second_nms(detector._filter_rows(res["det"][0].cpu().numpy(), 0.0), (H, W), 0.95)
            seg = res["seg"][0]
            over = draw.seg_overlay_tensor(frame, seg, detector.palette).cpu().numpy()
            if i in (0, n_frames - 1):
                check(np.array_equal(over, draw.seg_overlay(frame.cpu().numpy(), seg.cpu().numpy(),
                                                            detector.palette)),
                      f"frame {i}: the overlay on the card != the numpy overlay")
                overlay_equal += 1
            if i == 0:
                n_boxes = int((dets[:, 1] >= thresh).sum())
            replay = detector.draw_boxes(over, dets, thresh)
            check(np.array_equal(replay, rendered[i]), f"frame {i}: pipeline render != synchronous replay")
        # each output frame (mp4v, decoded by the port's kernels) against its
        # rendered frame; every 8th rendered frame through nvJPEG's encoder,
        # called directly, against the plain encoder (q95 4:2:0, both decoded
        # by nvJPEG)
        out_dec = mpeg4_cuda.Decoder(dev, stream.extradata, stream.fourcc)
        back = [f.cpu().numpy() for i in range(0, n_frames, 8) for f in out_dec.decode(out_frames[i:i + 8])]
        out_db = [psnr(b, r) for b, r in zip(back, rendered)]
        sampled = list(range(0, n_frames, 8))
        card_db = {i: psnr(jpeg_cuda.decode_images([jpeg_cuda.encode(torch.from_numpy(rendered[i]).to(dev))], dev)[0]
                           .cpu().numpy(), rendered[i]) for i in sampled}
        plain_db = [psnr(jpeg_cuda.decode_images([jpeg.encode(rendered[i], 95)], dev)[0].cpu().numpy(), rendered[i])
                    for i in sampled]
        gap = max(p - card_db[i] for p, i in zip(plain_db, sampled))
        check(gap <= jpeg_cuda.ENCODE_GATE_DB,
              f"nvJPEG's output lies {gap:.2f} dB below the plain encoder's on a frame (gate "
              f"{jpeg_cuda.ENCODE_GATE_DB} dB)")
        record["pixels"] = {"replay_equal_frames": n_frames, "overlay_equal_frames": overlay_equal,
                            "output_psnr_db": [min(out_db), max(out_db)],
                            "output_bytes": sum(len(f) for f in out_frames),
                            "nvjpeg_psnr_db": [min(card_db.values()), max(card_db.values())],
                            "plain_encoder_psnr_db": [min(plain_db), max(plain_db)],
                            "largest_gap_db": gap, "boxes_drawn_frame0": n_boxes}
        print(f"pixels: {n_frames} pipeline frames == the synchronous predict_raw replay bit for bit; the overlay on "
              f"the card == numpy on frames 0 and {n_frames - 1}; detection_out.mp4 ({sum(len(f) for f in out_frames)} "
              f"bytes of mp4v) decodes (the port's kernels) to {min(out_db):.2f}-{max(out_db):.2f} dB PSNR of the "
              f"rendered frames; nvJPEG's encoder on {len(sampled)} of them {min(card_db.values()):.2f}-"
              f"{max(card_db.values()):.2f} dB, the plain encoder {min(plain_db):.2f}-{max(plain_db):.2f} dB, "
              f"nvJPEG at most {gap:.3f} dB below (gate {jpeg_cuda.ENCODE_GATE_DB} dB); {n_boxes} boxes drawn on "
              f"frame 0 at vis-thresh {thresh} [{label}]", flush=True)
        del rendered, back

        secs["pixels"] = time.perf_counter() - t_sub
        # ---- 16e. the committed clips (cv2's writers, a DHT-less copy) and the JPEG forms
        t_sub = time.perf_counter()
        first = {}
        for name in ("cv2_mjpeg.avi", "ffmpeg_mjpeg.avi", "dht_less.avi"):
            reset()
            out = detector.detect_and_visualize(str(fixture / name), str(work / name))
            with avi.open_video(fixture / name) as reader:
                frames = list(reader)
            check([hashlib.sha256(f).hexdigest() for f in frames] == meta[name]["sha256"], f"{name}: frames")
            with avi.open_video(out[0]) as reader:
                check(len(reader) == len(frames) == 4, f"{name}: {len(reader)} frames out")
            check(counts()["plain_decodes"] == 0 and counts()["plain_encodes"] == 0, f"{name}: {counts()}")
            card = jpeg_cuda.decode_images(frames, dev)
            first[name] = card[0].cpu().numpy()
            diffs = [jpeg_cuda.difference(c.cpu().numpy(), jpeg.decode(f)) for c, f in zip(card, frames)]
            check(all(d["mean"] <= jpeg_cuda.GATES["420"] for d in diffs), f"{name}: {diffs}")
            record[name] = max(d["mean"] for d in diffs)
        check(np.array_equal(first["dht_less.avi"], first["cv2_mjpeg.avi"]),
              "the DHT-less frame (Annex K's tables inserted) decodes otherwise than its original on the card")
        forms = {}
        for path in sorted((fixture / "jpeg_forms").glob("*.jpg")):
            data = path.read_bytes()
            info = jpeg.read_info(data)
            try:
                img = jpeg_cuda.decode_images([data], dev)[0].cpu().numpy()
            except jpeg.JpegError as e:
                check(info.color in str(e), f"{path.name}: the refusal does not name its form: {e}")
                forms[path.name] = f"refused: {e}"
                continue
            want_img = jpeg.decode(data)
            want_img = np.repeat(want_img[..., None], 3, -1) if want_img.ndim == 2 else want_img
            d = jpeg_cuda.difference(img, want_img)
            check(d["mean"] <= jpeg_cuda.GATES["420"], f"{path.name}: card vs plain {d}")
            (planes, pinfo), = jpeg_cuda.decode_planes([data], dev)
            k = planes[3] if len(planes) == 4 else None
            check(torch.equal(
                jpeg_cuda.ycc_to_bgr(*planes[:3], factors=pinfo.factors, color=pinfo.color, k=k),
                jpeg_cuda.ycc_to_bgr_reference(*planes[:3], factors=pinfo.factors, color=pinfo.color, k=k)),
                f"{path.name}: the colour kernel ({pinfo.color}) != its plain version")
            forms[path.name] = f"{info.color}: mean {d['mean']:.4f} max {d['max']}"
        record["forms"] = forms
        record["colour_mode_launches"] = dict(jpeg_cuda.color_mode_launches)
        print("committed clips on the card (4 frames each, written back): card vs plain mean "
              + ", ".join(f"{k} {record[k]:.4f}" for k in ("cv2_mjpeg.avi", "ffmpeg_mjpeg.avi", "dht_less.avi"))
              + "; the DHT-less frame == its original on the card; JPEG forms: "
              + "; ".join(f"{k} {v}" for k, v in forms.items()) + f"; colour launches by mode (whole script so "
              f"far) {jpeg_cuda.color_mode_launches} [{label}]", flush=True)

        secs["committed clips, JPEG forms"] = time.perf_counter() - t_sub
        # ---- 16f. each stage per 1024x2048 frame (synchronised around each)
        t_sub = time.perf_counter()
        stage = dict.fromkeys(("read", "decode", "resize", "serve", "nms 0.95", "overlay", "draw", "encode",
                               "write"), 0.0)

        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stage[name] += time.perf_counter() - t
            return out

        with avi.open_video(clip) as reader:
            buffers = timed("read", lambda: list(reader))
        frames = []
        for i in range(0, n_frames, 8):
            frames += timed("decode", lambda: jpeg_cuda.decode_images(buffers[i:i + 8], dev))
        raws = [timed("resize", lambda: resize_linear(f, (H, W))) for f in frames]
        pipe = ServingPipeline(detector, depth=2, raw=True)
        for r in raws[:3]:  # capture each slot's graph first
            pipe.submit(r)
        list(pipe.drain())

        def serve_all():
            res = [pipe.submit(r) for r in raws]
            return [x for x in res if x is not None] + list(pipe.drain())

        results = [x[1] for x in timed("serve", serve_all)]
        rows = [detector._filter_rows(r["det"][0], 0.0) for r in results]
        kept = [timed("nms 0.95", lambda: video.second_nms(d, (H, W), 0.95)) for d in rows]
        segs = [torch.from_numpy(r["seg"][0]) for r in results]
        overs = [timed("overlay", lambda: draw.seg_overlay_tensor(f, s, detector.palette)) for f, s in zip(frames, segs)]
        text.STATS.update(hits=0, misses=0)
        drawn = [timed("draw", lambda: detector.draw_boxes(o.cpu().numpy(), d, thresh)) for o, d in zip(overs, kept)]
        record["text_cache"] = dict(text.STATS, labels=sum(int((d[:, 1] >= thresh).sum()) for d in kept))
        del overs
        encoder = mpeg4.Encoder(FW, FH)
        encoded = [timed("encode", lambda: encoder.encode(torch.from_numpy(img).to(dev))) for img in drawn]
        with mp4.Mp4Writer(str(work / "stages.mp4"), FW, FH, encoder.config, 25) as writer:
            for e in encoded:
                timed("write", lambda: writer.write(*e))
        per_frame = {k: v * 1e3 / n_frames for k, v in stage.items()}
        t0 = time.perf_counter()
        detector.detect_and_visualize(str(clip), str(work / "again"), thresh)
        total_ms = (time.perf_counter() - t0) * 1e3 / n_frames
        # the mp4v writer alone (an I-VOP): host time per call (its bytes come
        # back to the host, so the call waits for the card), device time
        # under the profiler
        img = torch.from_numpy(drawn[0]).to(dev)
        for _ in range(3):
            mpeg4.encode_vop(img, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            mpeg4.encode_vop(img, 0)
        enc_host_us = (time.perf_counter() - t0) / 20 * 1e6
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                mpeg4.encode_vop(img, 0)
            torch.cuda.synchronize()
        enc_dev_us = sum(e.device_time for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA) / 20
        record["stage_ms"] = per_frame
        record["total_ms_per_frame"] = total_ms
        record["encoder_us"] = {"host": enc_host_us, "device": enc_dev_us}
        record["render_s"] = render_s
        print(f"video per {FH}x{FW} frame ({n_frames} frames, each stage synchronised): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in per_frame.items()) + f"; stages summed {sum(per_frame.values()):.3f} ms; "
            f"detect_and_visualize end to end {total_ms:.3f} ms/frame ({1e3 / total_ms:.2f} frames/s, the graphs "
            f"captured in the call); multi_demo with the model build {secs['multi_demo'] * 1e3 / n_frames:.3f} "
            f"ms/frame; mp4v writer (an I-VOP) {enc_host_us:.1f} us host (a call, its wait included), "
            f"{enc_dev_us:.1f} us device per frame [{label}]", flush=True)
        print(f"phase 16 draw stage {per_frame['draw']:.3f} ms per {FH}x{FW} frame, "
              f"{record['text_cache']['labels']} labels: text layout cache {record['text_cache']['hits']} hits, "
              f"{record['text_cache']['misses']} misses [{label}]", flush=True)
        launches["nms_keep_mask"]["video_checks"] = nms_cuda.launches
        secs["stages, end to end, writer"] = time.perf_counter() - t_sub
    finally:
        shutil.rmtree(work, ignore_errors=True)
    record["seconds"] = secs
    print(json.dumps({"video_phase": record}), flush=True)
    return launches, record


def expected_route(info):
    """The route ``jpeg_cuda`` must choose from a JPEG's header."""
    if info.lossless:
        return "host_lossless"
    if info.coding == "arithmetic" or (info.progressive and info.restart):
        return "transcoded"
    if info.color not in ("ycc", "gray"):
        return "single_unchanged"
    return "single_progressive" if info.progressive else "batched"


def jpeg_forms_phase(dev, label):
    """Phase 17: every JPEG form cv2 reads, on the card. The committed forms
    (``tests/fixtures/jpeg_forms/``: arithmetic-coded, lossless, every
    integral sampling geometry, progressive with restarts, 12-bit and
    fractional refusals) each decoded alone, its route chosen from the
    header; the colour kernel against its plain version in each geometry;
    ``multi_demo --images`` at resnet-50_multi 512x1024 bf16 over an
    arithmetic, a lossless, a 4:1:1 and a progressive-with-restart file;
    one ``DeviceAugIterator`` batch mixing the forms at one raw size against
    the per-image decodes; the host stages' and the kernel's times. Returns
    ({kernel: {path: launches}}, record)."""
    import hashlib
    import tempfile

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import multi_demo
    from dspnet_torch.data import jpeg, jpeg_cuda, synthetic
    from dspnet_torch.data.device_pipeline import DeviceAugIterator, device_augment_batch
    from dspnet_torch.data.iterator import Sample, SampleIndex
    from dspnet_torch.ops import nms_cuda
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix

    net = "resnet-50_multi"
    forms_dir = ROOT / "tests" / "fixtures" / "jpeg_forms"
    meta = json.loads((forms_dir / "forms.json").read_text())["files"]
    launches = {"nms_keep_mask": {}, "jpeg_ycc_to_bgr": {}}
    record, secs = {}, {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_forms_", dir=ROOT / "build"))

    def reset():
        nms_cuda.launches = jpeg_cuda.launches = jpeg_cuda.images = 0
        jpeg_cuda.color_launches = jpeg_cuda.color_plain_calls = jpeg.decodes = 0
        jpeg_cuda.routes.update(dict.fromkeys(jpeg_cuda.routes, 0))

    def sha(img):
        return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()

    try:
        # ---- 17a. every committed form alone on the card
        t0 = time.perf_counter()
        reset()
        cards, refused, routes_seen = {}, {}, {}
        for name in sorted(meta):
            data = (forms_dir / name).read_bytes()
            before = dict(jpeg_cuda.routes)
            if meta[name]["cv2"]["color"] is None:  # cv2 returns None: the card refuses by name
                try:
                    jpeg_cuda.decode_images([data], dev)
                except jpeg.JpegError as e:
                    check(any(w in str(e) for w in ("12-bit", "fractional", "lossless")),
                          f"{name}: the refusal does not name the form: {e}")
                    refused[name] = str(e)
                    continue
                check(False, f"{name}: cv2 returns None for it and the card decoded it")
            info = jpeg.read_info(data)
            route = expected_route(info)
            cards[name] = jpeg_cuda.decode_images([data], dev)[0].cpu().numpy()
            moved = {k: jpeg_cuda.routes[k] - before[k] for k in before if jpeg_cuda.routes[k] != before[k]}
            check(moved == {route: 1}, f"{name}: routes moved {moved}, expected {route}")
            routes_seen[route] = routes_seen.get(route, 0) + 1
        check(jpeg.decodes == 0 and jpeg_cuda.color_plain_calls == 0,
              f"plain decodes {jpeg.decodes}, plain colour calls {jpeg_cuda.color_plain_calls} on the card")
        check(jpeg_cuda.color_launches == len(cards),
              f"{jpeg_cuda.color_launches} colour launches for {len(cards)} images")
        launches["jpeg_ycc_to_bgr"]["jpeg_forms"] = jpeg_cuda.color_launches
        secs["forms on the card"] = time.perf_counter() - t0
        # each against cv2 (lossless, by forms.json's sha256) or the plain decoder (DCT, within the gates)
        worst, lossless_equal = 0.0, 0
        for name, img in cards.items():
            info = jpeg.read_info((forms_dir / name).read_bytes())
            if info.lossless:
                check(sha(img) == meta[name]["cv2"]["color"]["sha256"], f"{name}: the card's pixels are not cv2's")
                lossless_equal += 1
                continue
            want = jpeg.decode((forms_dir / name).read_bytes())
            want = np.repeat(want[..., None], 3, -1) if want.ndim == 2 else want
            d = jpeg_cuda.difference(img, want)
            check(d["mean"] <= jpeg_cuda.GATES["420"], f"{name}: card vs plain {d}")
            worst = max(worst, d["mean"])
        # the colour kernel against its plain version on each form's planes
        geometries = {}
        for name in cards:
            (planes, pinfo), = jpeg_cuda.decode_planes([(forms_dir / name).read_bytes()], dev)
            kw = dict(color=pinfo.color, k=planes[3] if len(planes) == 4 else None, fancy=not pinfo.lossless,
                      upsampling=pinfo.upsampling, size=(pinfo.height, pinfo.width))
            check(torch.equal(jpeg_cuda.ycc_to_bgr(*planes[:3], **kw),
                              jpeg_cuda.ycc_to_bgr_reference(*planes[:3], **kw)),
                  f"{name}: the colour kernel != its plain version ({pinfo.upsampling}, {pinfo.color})")
            key = ",".join(f"{h}x{v}" for h, v in pinfo.upsampling) + ("" if kw["fancy"] else " replicated")
            geometries[key] = geometries.get(key, 0) + 1
        record["forms"] = {"decoded": len(cards), "refused_as_cv2": sorted(refused), "routes": routes_seen,
                           "lossless_equal_cv2": lossless_equal, "dct_worst_mean_vs_plain": worst,
                           "kernel_equal_plain_geometries": geometries}
        print(f"JPEG forms on the card: {len(cards)} decoded (routes {routes_seen}), {lossless_equal} lossless "
              f"equal to cv2's sha256, DCT forms within the gate of the plain decoder (worst mean {worst:.4f}); "
              f"{len(refused)} refused by name where cv2 returns None ({', '.join(sorted(refused))}); the colour "
              f"kernel == its plain version in {len(geometries)} geometries {geometries}; plain decodes 0 "
              f"[{label}]", flush=True)

        # ---- 17b. multi_demo over an arithmetic, a lossless, a 4:1:1 and a progressive-with-restart file
        t0 = time.perf_counter()
        src = create_model(net, (H, W), num_classes=NUM_CLASSES, device=dev,
                           generator=torch.Generator().manual_seed(17))
        model_dir = work / "model"
        CheckpointManager(checkpoint_prefix(str(model_dir), net, H)).save(
            0, MultiTaskSolver(src.model, src.anchors, device=dev).init_state())
        del src
        demo_names = ["big_arith_420.jpg", "big_lossless_rgb_p1.jpg", "big_411.jpg", "big_prog_rst_420.jpg"]
        paths = []
        for n in demo_names:
            paths.append(work / n)
            paths[-1].write_bytes((forms_dir / n).read_bytes())
        demo_args = ["--network", net, "--data-shape", f"3,{H},{W}", "--model-dir", str(model_dir), "--epoch", "0",
                     "--dtype", "bfloat16", "--vis-thresh", "0.3", "--out-dir", str(work / "out"),
                     "--device", str(dev), "--images", ",".join(str(x) for x in paths)]
        reset()
        t1 = time.perf_counter()
        written = multi_demo.main(demo_args)
        torch.cuda.synchronize()
        secs["multi_demo"] = time.perf_counter() - t1
        n = len(paths)
        got = {"nms": nms_cuda.launches, "images": jpeg_cuda.images, "colour": jpeg_cuda.color_launches,
               "plain_decodes": jpeg.decodes, "plain_colour": jpeg_cuda.color_plain_calls,
               "transcoded": jpeg_cuda.routes["transcoded"], "host_lossless": jpeg_cuda.routes["host_lossless"],
               "batched": jpeg_cuda.routes["batched"]}
        want = {"nms": n, "images": n, "colour": n, "plain_decodes": 0, "plain_colour": 0, "transcoded": 2,
                "host_lossless": 1, "batched": 1}
        check(got == want, f"multi_demo on the forms: counts {got}, expected {want}")
        check([Path(w).name for w in written] == [x.stem + "_out.jpg" for x in paths], f"written {written}")
        for w, x in zip(written, paths):
            check(jpeg.read_header(Path(w).read_bytes())[:2] == jpeg.read_header(x.read_bytes())[:2],
                  f"{w}: not the input's size")
        launches["nms_keep_mask"]["jpeg_forms_demo"] = got["nms"]
        launches["jpeg_ycc_to_bgr"]["jpeg_forms_demo"] = got["colour"]
        record["demo"] = {"counts": got, "seconds": secs["multi_demo"]}
        print(f"multi_demo {net} {H}x{W} bf16 on {', '.join(demo_names)}: {secs['multi_demo']:.2f} s with the "
              f"model build; counts {got}; each _out.jpg the input's size [{label}]", flush=True)
        secs["demo with checkpoint"] = time.perf_counter() - t0

        # ---- 17c. one DeviceAugIterator batch mixing the forms at one raw size (37x53)
        batch_names = ["arith_seq_dac_rst.jpg", "arith_prog_rst1.jpg", "lossless_rgb_p7_pt2_rst.jpg",
                       "samp_4x1_1x1.jpg", "samp_1x2_1x1.jpg", "prog_rstrows_gray.jpg"]
        rng = np.random.RandomState(17)
        samples = []
        for n_ in batch_names:
            path = work / n_
            path.write_bytes((forms_dir / n_).read_bytes())
            rows = synthetic.make_example(rng, (37, 53), 3)[1]
            samples.append(Sample(str(path), SampleIndex.pad_label(rows), None))
        B = len(samples)
        reset()
        it = DeviceAugIterator(SampleIndex(samples), B, (H, W), device=dev, seed=233, enable_aug=False, shuffle=False)
        (batch, names), = list(it.epoch())
        torch.cuda.synchronize()
        loader_counts = {"images": jpeg_cuda.images, "colour": jpeg_cuda.color_launches, "plain": jpeg.decodes,
                         "routes": {k: v for k, v in jpeg_cuda.routes.items() if v}}
        check(jpeg.decodes == 0 and jpeg_cuda.images == B, f"the loader's counts {loader_counts}")
        launches["jpeg_ycc_to_bgr"]["jpeg_forms_loader"] = jpeg_cuda.color_launches
        raw = torch.stack([jpeg_cuda.decode_images([Path(s.image_path).read_bytes()], dev)[0] for s in samples])
        labels = torch.from_numpy(np.stack([s.label for s in samples]).astype(np.float32))
        ref = device_augment_batch(raw, None, labels, torch.zeros(B, 6), it.lut, (H, W), enable_aug=False,
                                   mean_pixels=it.mean_pixels)
        check(torch.equal(batch["images"], ref["images"]), "the loader's mixed-form batch != the per-image decodes")
        record["loader"] = {"forms": batch_names, "counts": loader_counts}
        print(f"DeviceAugIterator b{B} over {', '.join(batch_names)} (37x53 -> {H}x{W}): images == the "
              f"per-image decodes through device_augment_batch bit for bit; counts {loader_counts} [{label}]",
              flush=True)

        # ---- 17d. the host stages and the colour kernel at full size
        # each beside its bound: its bytes in and out once at the card's
        # memory rate, were the stage on the card
        host = {}
        for name in ("big_arith_420.jpg", "big_prog_rst_420.jpg"):
            data = (forms_dir / name).read_bytes()
            t1 = time.perf_counter()
            out = jpeg.transcode_baseline(data)
            host[f"transcode_baseline {name} ms"] = (time.perf_counter() - t1) * 1e3
            host[f"transcode_baseline {name} bound us"] = bound_us(len(data) + len(out), 0)[0]
        data = (forms_dir / "big_lossless_rgb_p1.jpg").read_bytes()
        t1 = time.perf_counter()
        planes = jpeg.lossless_planes(data).planes
        host["lossless_planes big_lossless_rgb_p1.jpg (512x1024) ms"] = (time.perf_counter() - t1) * 1e3
        host["lossless_planes big_lossless_rgb_p1.jpg (512x1024) bound us"] = bound_us(
            len(data) + sum(p.size for p in planes), 0)[0]
        kernel = {}
        for name in ("big_411.jpg", "big_440.jpg"):
            (planes, info), = jpeg_cuda.decode_planes([(forms_dir / name).read_bytes()], dev)
            out = torch.empty((info.height, info.width, 3), dtype=torch.uint8, device=dev)
            kw = dict(upsampling=info.upsampling, size=(info.height, info.width))
            t = kernel_times(lambda: jpeg_cuda.ycc_to_bgr(*planes, out=out, **kw), COLOR_KERNELS)
            p_ms = cuda_ms(lambda: jpeg_cuda.ycc_to_bgr_reference(*planes, **kw), 10)
            Hh, Ww = info.height, info.width
            # the three planes read once, BGR written once; about 20 int32
            # operations a pixel, at half the float32 rate
            bound = bound_us(sum(p.numel() for p in planes) + 3 * Hh * Ww, 2 * 20 * Hh * Ww)
            sub = "4:1:1" if info.factors == (4, 1) else "4:4:0"
            print_times(f"ycc_to_bgr (colour kernel) {Hh}x{Ww} {sub}", t, p_ms, bound, label)
            kernel[f"{Hh}x{Ww} {sub}"] = dict(t, plain_ms=p_ms, bound_us=bound[0], bound_by=bound[1])
        # 4:2:0 (the arithmetic file's planes, after its transcode): the
        # kernel against its baseline (one thread per chroma sample) on the
        # same planes, in turns
        (planes, info), = jpeg_cuda.decode_planes([(forms_dir / "big_arith_420.jpg").read_bytes()], dev)
        old_colour = colour_baseline(dev)
        Hh, Ww = info.height, info.width
        out, out_old = (torch.empty((Hh, Ww, 3), dtype=torch.uint8, device=dev) for _ in range(2))
        check(torch.equal(jpeg_cuda.ycc_to_bgr(*planes, factors=info.factors, out=out),
                          old_colour(*planes, out_old)), "the colour kernel != its baseline at 4:2:0")
        new_fn = lambda: jpeg_cuda.ycc_to_bgr(*planes, factors=info.factors, out=out)  # noqa: E731
        old_fn = lambda: old_colour(*planes, out_old)  # noqa: E731
        turns = [kernel_times(f, COLOR_KERNELS) for f in (new_fn, old_fn, old_fn, new_fn)]
        p_ms = cuda_ms(lambda: jpeg_cuda.ycc_to_bgr_reference(*planes, factors=info.factors), 10)
        bound = bound_us(sum(p.numel() for p in planes) + 3 * Hh * Ww, 2 * 20 * Hh * Ww)
        kernel[f"{Hh}x{Ww} 4:2:0"] = dict(with_baseline(turns[0], turns[1]), plain_ms=p_ms, bound_us=bound[0],
                                          bound_by=bound[1], turns_device_us=[t["device_us"] for t in turns])
        print(f"ycc_to_bgr (colour kernel) {Hh}x{Ww} 4:2:0 against its baseline (one thread per chroma "
              f"sample), in turns new, old, old, new: device " + " / ".join(f"{t['device_us']:.3f}" for t in turns)
              + " us, events " + " / ".join(f"{t['event_ms'] * 1e3:.3f}" for t in turns) + f" us; bound "
              f"{bound[0]:.4f} us ({bound[1]}), plain {p_ms:.4f} ms; outputs equal [{label}]", flush=True)
        record["host_ms"], record["colour_kernel"] = host, kernel
        print("host stages: " + ", ".join(f"{k} {v:.4f}" for k, v in host.items()) + f" [{label}]", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    record["seconds"] = secs
    print(json.dumps({"jpeg_forms_phase": record}), flush=True)
    return launches, record


#: the formats phase 18 writes at full size with the port's writers, and the
#: array each must read back to (IMREAD_UNCHANGED)
ROUND_TRIPS = (".bmp", ".ppm", ".pam", ".pfm", ".tif", ".sr", ".webp", ".gif")


def image_formats_phase(dev, label):
    """Phase 18: the still-image formats beside JPEG and PNG on the card's
    machine. Every committed form of ``tests/fixtures/image_forms/`` decoded
    under each flag against the sha256 cv2 gave (``forms.json``; this
    machine has no cv2), the refusals by name; a 1024x2048 scene written in
    each lossless format by the port's writers and read back equal, with the
    host decode ms of each and of the committed lossy WebP and GIF beside
    their bound; ``multi_demo --images`` at resnet-50_multi 512x1024 bf16
    over a BMP, an LZW TIFF, a lossy WebP, a GIF and a PPM (NMS launches =
    images; nvJPEG images, colour launches and plain JPEG decodes 0); one
    ``DeviceAugIterator`` batch over ``YoloFormat`` indexes of TIFF and of
    BMP images equal to the per-image host decodes, each fed to one
    ``train_step`` (matcher launches counted); ``voc_palette`` into BMP,
    TIFF, PGM / PPM, WebP and GIF read back equal. Returns ({kernel: {path:
    launches}}, record)."""
    import hashlib
    import tempfile

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import multi_demo
    from dspnet_torch.data import image_io, jpeg, jpeg_cuda, synthetic
    from dspnet_torch.data.device_pipeline import DeviceAugIterator, device_augment_batch
    from dspnet_torch.data.imdb import YoloFormat
    from dspnet_torch.data.iterator import SampleIndex
    from dspnet_torch.ops import matching_cuda, nms_cuda
    from dspnet_torch.tools import voc_palette
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix

    net = "resnet-50_multi"
    forms_dir = ROOT / "tests" / "fixtures" / "image_forms"
    meta = json.loads((forms_dir / "forms.json").read_text())["files"]
    flags = {"color": image_io.IMREAD_COLOR, "gray": image_io.IMREAD_GRAYSCALE,
             "unchanged": image_io.IMREAD_UNCHANGED}
    launches = {"nms_keep_mask": {}, "bipartite_match": {}}
    record, secs = {}, {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_images_", dir=ROOT / "build"))

    def reset():
        nms_cuda.launches = matching_cuda.launches = 0
        jpeg_cuda.launches = jpeg_cuda.images = jpeg_cuda.color_launches = jpeg_cuda.color_plain_calls = 0
        jpeg.decodes = 0

    def sha(img):
        return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()

    try:
        # ---- 18a. every committed form under each flag
        t0 = time.perf_counter()
        equal, refused, per_ext = 0, [], {}
        for name in sorted(meta):
            data = (forms_dir / name).read_bytes()
            ext = Path(name).suffix
            for key, flag in flags.items():
                rec = meta[name]["cv2"][key]
                if rec is None:
                    try:
                        image_io.imdecode(data, flag)
                    except ValueError as e:
                        check(str(e), f"{name} {key}: refused without a reason")
                        refused.append(f"{name}:{key}")
                        continue
                    check(False, f"{name} {key}: cv2 returns None for it and the port decoded it")
                img = image_io.imdecode(data, flag)
                if "columns" in rec:
                    img = img[:, :rec["columns"]]
                check((str(img.dtype), list(img.shape), sha(img)) == (rec["dtype"], rec["shape"], rec["sha256"]),
                      f"{name} {key}: not cv2's array")
                equal += 1
                per_ext[ext] = per_ext.get(ext, 0) + 1
        secs["committed forms"] = time.perf_counter() - t0
        record["forms"] = {"files": len(meta), "equal_cv2": equal, "refused_as_cv2": len(refused),
                           "equal_by_extension": per_ext}
        print(f"image forms on the card's machine: {len(meta)} files x 3 flags, {equal} arrays equal to cv2's "
              f"sha256 ({per_ext}), {len(refused)} refused by name where cv2 returns None; "
              f"{secs['committed forms']:.2f} s [{label}]", flush=True)

        # ---- 18b. round trips at 1024x2048 and the host stages' times
        scene, _, seg = synthetic.make_example(np.random.RandomState(18), (1024, 2048), 4)[:3]
        host = {}
        for ext in ROUND_TRIPS:
            src = seg if ext == ".gif" else scene
            t1 = time.perf_counter()
            data = image_io.imencode(ext, src)
            enc_ms = (time.perf_counter() - t1) * 1e3
            t1 = time.perf_counter()
            back = image_io.imdecode(data, image_io.IMREAD_UNCHANGED)
            dec_ms = (time.perf_counter() - t1) * 1e3
            want = (src.astype(np.float32) if ext == ".pfm"
                    else np.repeat(src[..., None], 3, -1) if ext == ".gif" else src)
            check(back.dtype == want.dtype and np.array_equal(back, want), f"{ext} 1024x2048 round trip differs")
            host[ext] = {"bytes": len(data), "encode_ms": enc_ms, "decode_ms": dec_ms,
                         "decode_bound_us": bound_us(len(data) + back.nbytes, 0)[0]}
        for name in ("big_lossy.webp", "big.gif"):
            data = (forms_dir / name).read_bytes()
            t1 = time.perf_counter()
            img = image_io.imdecode(data, image_io.IMREAD_COLOR)
            dec_ms = (time.perf_counter() - t1) * 1e3
            check(sha(img) == meta[name]["cv2"]["color"]["sha256"], f"{name}: not cv2's pixels")
            host[name] = {"bytes": len(data), "decode_ms": dec_ms,
                          "decode_bound_us": bound_us(len(data) + img.nbytes, 0)[0]}
        record["host_ms_1024x2048"] = host
        print("1024x2048 round trips equal (port writer -> port reader, IMREAD_UNCHANGED); host ms: "
              + ", ".join(f"{k} {v['bytes']} B enc {v.get('encode_ms', float('nan')):.3f} dec "
                          f"{v['decode_ms']:.3f} (bound {v['decode_bound_us']:.4f} us)" for k, v in host.items())
              + f" [{label}]", flush=True)

        # ---- 18c. multi_demo over a BMP, an LZW TIFF, a lossy WebP, a GIF and a PPM
        t0 = time.perf_counter()
        src = create_model(net, (H, W), num_classes=NUM_CLASSES, device=dev,
                           generator=torch.Generator().manual_seed(18))
        model_dir = work / "model"
        CheckpointManager(checkpoint_prefix(str(model_dir), net, H)).save(
            0, MultiTaskSolver(src.model, src.anchors, device=dev).init_state())
        paths = []
        for ext in (".bmp", ".tif", ".ppm"):
            paths.append(Path(image_io.imwrite(str(work / f"scene_{ext[1:]}{ext}"), scene)))
        for name in ("big_lossy.webp", "big.gif"):
            paths.append(work / name)
            paths[-1].write_bytes((forms_dir / name).read_bytes())
        demo_args = ["--network", net, "--data-shape", f"3,{H},{W}", "--model-dir", str(model_dir), "--epoch", "0",
                     "--dtype", "bfloat16", "--vis-thresh", "0.3", "--out-dir", str(work / "out"),
                     "--device", str(dev), "--images", ",".join(str(x) for x in paths)]
        reset()
        t1 = time.perf_counter()
        written = multi_demo.main(demo_args)
        torch.cuda.synchronize()
        secs["multi_demo"] = time.perf_counter() - t1
        got = {"nms": nms_cuda.launches, "nvjpeg_images": jpeg_cuda.images, "colour": jpeg_cuda.color_launches,
               "plain_jpeg_decodes": jpeg.decodes}
        want = {"nms": len(paths), "nvjpeg_images": 0, "colour": 0, "plain_jpeg_decodes": 0}
        check(got == want, f"multi_demo on the image formats: counts {got}, expected {want}")
        check([Path(w).name for w in written] == [x.stem + "_out.jpg" for x in paths], f"written {written}")
        for w in written:
            check(jpeg.read_header(Path(w).read_bytes())[:2] == (1024, 2048), f"{w}: not the input's size")
        launches["nms_keep_mask"]["image_formats_demo"] = got["nms"]
        record["demo"] = {"files": [x.name for x in paths], "counts": got, "seconds": secs["multi_demo"]}
        print(f"multi_demo {net} {H}x{W} bf16 on {', '.join(x.name for x in paths)} (1024x2048): "
              f"{secs['multi_demo']:.2f} s with the model build; counts {got} [{label}]", flush=True)
        secs["demo with checkpoint"] = time.perf_counter() - t0

        # ---- 18d. a loader batch over YoloFormat TIFF and BMP images, each into one train_step
        B = 4
        solver = MultiTaskSolver(src.model, src.anchors, batch_size=B, compute_dtype="bfloat16", device=dev,
                                 seg_normalize="valid", learning_rate=5e-4)
        state = solver.init_state()
        classes = ["person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle"]
        rng = np.random.RandomState(180)
        loader_record = {}
        for ext in (".tif", ".bmp"):
            root = work / f"yolo{ext[1:]}"
            (root / "images").mkdir(parents=True)
            (root / "labels").mkdir()
            ids = []
            for i in range(B):
                img, rows = synthetic.make_example(rng, (H, W), 4)[:2]
                iid = f"im{i}"
                ids.append(iid)
                image_io.imwrite(str(root / "images" / (iid + ext)), img)
                lines = [f"{int(r[0])} {(r[1] + r[3]) / 2:.6f} {(r[2] + r[4]) / 2:.6f} {r[3] - r[1]:.6f} "
                         f"{r[4] - r[2]:.6f}" for r in np.asarray(rows) if r[0] >= 0]
                (root / "labels" / (iid + ".txt")).write_text("\n".join(lines) + "\n")
            (root / "list.txt").write_text("\n".join(ids) + "\n")
            index = SampleIndex(YoloFormat(str(root / "list.txt"), str(root / "images"), str(root / "labels"),
                                           classes, image_ext=ext).samples())
            reset()
            t1 = time.perf_counter()
            it = DeviceAugIterator(index, B, (H, W), device=dev, seed=18, enable_aug=False, shuffle=False)
            (batch, names), = list(it.epoch())
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t1
            counts = {"nvjpeg_images": jpeg_cuda.images, "colour": jpeg_cuda.color_launches,
                      "plain_jpeg_decodes": jpeg.decodes}
            check(counts == {"nvjpeg_images": 0, "colour": 0, "plain_jpeg_decodes": 0}, f"{ext} loader {counts}")
            raw = torch.stack([torch.from_numpy(image_io.imread(s.image_path)).to(dev) for s in index])
            labels = torch.from_numpy(np.stack([s.label for s in index]).astype(np.float32))
            ref = device_augment_batch(raw, None, labels, torch.zeros(B, 6), it.lut, (H, W), enable_aug=False,
                                       mean_pixels=it.mean_pixels)
            check(torch.equal(batch["images"], ref["images"]), f"{ext} loader batch != the per-image host decodes")
            check(torch.equal(batch["label_det"], ref["label_det"].to(batch["label_det"].device)),
                  f"{ext} loader labels != the per-image labels")
            reset()
            state, m = solver.train_step(state, batch)
            loss = float(m["loss"])
            check(np.isfinite(loss), f"{ext} train_step loss {loss}")
            check(matching_cuda.launches == 1, f"{ext} train_step launched the matcher {matching_cuda.launches} times")
            launches["bipartite_match"][f"image_formats_train{ext}"] = matching_cuda.launches
            loader_record[ext] = {"images": names, "load_s": load_s, "loss": loss, "counts": counts}
            print(f"DeviceAugIterator b{B} over YoloFormat(image_ext={ext!r}) {H}x{W}: equal to the per-image "
                  f"host decodes through device_augment_batch; {load_s:.3f} s; one train_step loss {loss:.6g}, "
                  f"matcher launches {launches['bipartite_match'][f'image_formats_train{ext}']}; counts {counts} [{label}]", flush=True)
        record["loader"] = loader_record
        del solver, state, src

        # ---- 18e. voc_palette into each format and back
        idx = seg.astype(np.uint8)
        colour_png = work / "mask.png"
        image_io.imwrite(str(colour_png), voc_palette.voc_palette()[idx][..., ::-1])
        checked = []
        for ext in (".bmp", ".tif", ".pgm", ".webp", ".gif"):
            dst = work / f"index{ext}"
            voc_palette.main([str(colour_png), str(dst)])
            back = image_io.imread(str(dst), image_io.IMREAD_UNCHANGED)
            back = back[..., 0] if back.ndim == 3 else back
            check(np.array_equal(back, idx), f"voc_palette -> {ext}: the index map does not read back equal")
            checked.append(f"index{ext}")
        for ext in (".ppm", ".bmp", ".tif", ".webp", ".gif"):
            dst = work / f"colour{ext}"
            voc_palette.main(["--colorize", str(work / "index.bmp"), str(dst)])
            back = image_io.imread(str(dst), image_io.IMREAD_UNCHANGED)
            check(np.array_equal(back, voc_palette.voc_palette()[idx][..., ::-1]),
                  f"voc_palette --colorize -> {ext}: the colours do not read back equal")
            checked.append(f"colour{ext}")
        record["voc_palette"] = checked
        print(f"voc_palette 1024x2048 into {', '.join(checked)}: every file reads back equal [{label}]", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    record["seconds"] = secs
    print(json.dumps({"image_formats_phase": record}), flush=True)
    return launches, record


#: the kernels of ``csrc/jpeg2000.cu`` by name, as the profiler shows them
J2K_KERNELS = {"t1_decode": "t1_decode_kernel", "idwt": "idwt_kernel", "mct_store": "mct_store_kernel"}


def j2k_device_us(fn, name, counter, key, n=20):
    """Device us per call of ``fn`` (every launch of the kernel ``name`` in
    one call summed), launches per call (the wrapper's ``counter[key]``),
    and how it was timed: torch.profiler over ``n`` calls when it recorded
    every launch, else CUDA events around ``n`` calls back to back (the
    device runs behind the host there; a long run's profiler can drop
    events)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    event_us = cuda_ms(fn, n) * 1e3
    before = counter[key]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    launched = counter[key] - before
    evts = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    if len(evts) == launched:
        return sum(e.device_time for e in evts) / n, launched / n, "torch.profiler"
    return event_us, launched / n, f"CUDA events (the profiler recorded {len(evts)} of {launched} launches)"


def j2k_host_us(fn, n=20):
    """The wrapper's host time per call (no synchronize inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def jpeg2000_phase(dev, label):
    """Phase 19: JPEG 2000 through the three kernels of ``csrc/jpeg2000.cu``
    (``data/jpeg2000_cuda.py``). Every committed form of
    ``tests/fixtures/jpeg2000_forms/`` under each flag decoded on the card
    to the sha256 cv2 gave (``forms.json``; no cv2 here), the refusals by
    name, a palette refused on the card and read on the host; each kernel
    against its plain version bit for bit on every form; then a 1024x2048
    textured street scene as the port's lossless 5/3 file (written here by
    the port's encoder, its code-blocks coded by a process pool) and as the
    committed 9/7 file of it: host tier-2 ms, each kernel bit for bit
    against its plain version (the plain tier-1 over the pool), its device
    us (torch.profiler, every launch of a call summed), launches, the
    wrapper's host us, the bound (bytes once at 3.35 TB/s), the plain
    version's ms, and one read end to end on each; the 5/3 read equals the
    scene. Last, with every count set to 0 just before: ``multi_demo
    --images`` on both 1024x2048 files, one ``DeviceAugIterator`` batch over
    ``YoloFormat(image_ext=".jp2")`` into one ``train_step``; the plain
    decoder runs 0 times there. Returns ({kernel: {path: launches}},
    {kernel: timings at 1024x2048 5/3}, record)."""
    import functools
    import hashlib
    import multiprocessing
    import os
    import tempfile

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import multi_demo
    from dspnet_torch.data import image_io, jpeg, jpeg2000, jpeg2000_cuda, jpeg_cuda, synthetic
    from dspnet_torch.data.device_pipeline import DeviceAugIterator, device_augment_batch
    from dspnet_torch.data.imdb import YoloFormat
    from dspnet_torch.data.iterator import SampleIndex
    from dspnet_torch.ops import matching_cuda, nms_cuda
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix

    net = "resnet-50_multi"
    forms_dir = ROOT / "tests" / "fixtures" / "jpeg2000_forms"
    meta = json.loads((forms_dir / "forms.json").read_text())["files"]
    flags = {"color": 1, "gray": 0, "unchanged": -1}
    launches = {"nms_keep_mask": {}, "bipartite_match": {}, **{k: {} for k in J2K_KERNELS}}
    record, secs = {}, {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_j2k_", dir=ROOT / "build"))

    def reset():
        nms_cuda.launches = matching_cuda.launches = 0
        jpeg_cuda.launches = jpeg_cuda.images = jpeg_cuda.color_launches = jpeg_cuda.color_plain_calls = 0
        jpeg.decodes = jpeg2000.decodes = 0
        for d in (jpeg2000_cuda.launches, jpeg2000_cuda.plain_calls):
            for k in d:
                d[k] = 0

    def sha(img):
        return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()

    def equal_kernels(st, what, pool_map=map):
        """Each kernel against its plain version on ``st``; returns the
        kernels' output and the plain versions' seconds."""
        coef = jpeg2000_cuda.t1_decode(st)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = jpeg2000_cuda.t1_decode_ref(st, map=pool_map)
        plain = {"t1_decode": time.perf_counter() - t1}
        check(torch.equal(coef, ref), f"{what}: t1_decode_kernel != t1_decode_ref "
                                      f"({int((coef != ref).sum())} values differ)")
        t1 = time.perf_counter()
        samples_ref = jpeg2000_cuda.idwt_ref(st, ref)
        plain["idwt"] = time.perf_counter() - t1
        samples = jpeg2000_cuda.idwt(st, coef)
        torch.cuda.synchronize()
        check(torch.equal(samples, samples_ref), f"{what}: idwt_kernel != idwt_ref "
                                                 f"({int((samples != samples_ref).sum())} values differ)")
        img = jpeg2000_cuda.mct_store(st, samples)
        t1 = time.perf_counter()
        img_ref = jpeg2000_cuda.mct_store_ref(st, samples)
        plain["mct_store"] = time.perf_counter() - t1
        check(np.array_equal(img.cpu().numpy(), img_ref.cpu().numpy()), f"{what}: mct_store_kernel != mct_store_ref")
        return img, samples, plain

    try:
        # ---- 19a. every committed form under each flag, on the card
        t0 = time.perf_counter()
        equal, refused, host_palette = 0, [], 0
        for name in sorted(meta):
            data = (forms_dir / name).read_bytes()
            palette = jpeg2000.read_boxes(data).pclr is not None
            for key, flag in flags.items():
                rec = meta[name]["cv2"][key]
                reset()
                if rec is None or palette:
                    try:
                        jpeg2000_cuda.decode(data, flag, dev)
                    except ValueError as e:
                        check(str(e), f"{name} {key}: refused without a reason")
                        refused.append(f"{name}:{key}")
                    else:
                        check(False, f"{name} {key}: decoded on the card where it must raise")
                    if rec is not None:  # a palette: the plain decoder on the host reads it
                        check(sha(jpeg2000.decode(data, flag)) == rec["sha256"], f"{name} {key}: host read differs")
                        host_palette += 1
                    continue
                img = jpeg2000_cuda.decode(data, flag, dev)
                check(img.device.type == "cuda" and (str(img.dtype).replace("torch.", ""), list(img.shape))
                      == (rec["dtype"], rec["shape"]) and sha(img.cpu().numpy()) == rec["sha256"],
                      f"{name} {key}: the card's array is not cv2's")
                check(jpeg2000.decodes == 0 and sum(jpeg2000_cuda.plain_calls.values()) == 0,
                      f"{name} {key}: a plain decode on the card's path")
                equal += 1
        secs["committed forms"] = time.perf_counter() - t0
        record["forms"] = {"files": len(meta), "equal_cv2_on_card": equal, "refused": len(refused),
                           "palette_on_host": host_palette}
        print(f"JPEG 2000 forms on the card: {len(meta)} files x 3 flags, {equal} arrays equal to cv2's sha256 "
              f"through the kernels, {len(refused)} refused by name (cv2 returns None, or a palette, "
              f"{host_palette} of them read on the host to cv2's array); {secs['committed forms']:.2f} s [{label}]",
              flush=True)

        # ---- 19b. each kernel against its plain version on every form
        t0 = time.perf_counter()
        n = 0
        for name in sorted(meta):
            data = (forms_dir / name).read_bytes()
            read = [k for k in ("unchanged", "gray", "color") if meta[name]["cv2"][k]]
            if not read or jpeg2000.read_boxes(data).pclr is not None or name.startswith("big"):
                continue
            st = jpeg2000_cuda.stage(jpeg2000_cuda.pack(jpeg2000.prepare(data), flags[read[0]]), dev)
            equal_kernels(st, name)
            n += 1
        secs["kernels vs plain, forms"] = time.perf_counter() - t0
        print(f"t1_decode, idwt and mct_store == their plain versions bit for bit on {n} forms "
              f"({secs['kernels vs plain, forms']:.2f} s) [{label}]", flush=True)

        # ---- 19c. 1024x2048: the port's lossless 5/3 file and the committed 9/7 file
        scene = np.clip(synthetic.make_example(np.random.RandomState(19), (1024, 2048), 4)[0]
                        + synthetic.texture_offsets(np.random.RandomState(20), (1024, 2048)), 0, 255).astype(np.uint8)
        workers = os.cpu_count() or 1
        timings, big = {}, {}
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            pmap = functools.partial(pool.map, chunksize=8)
            t1 = time.perf_counter()
            lossless = jpeg2000.encode(scene, map=pmap)
            secs["encode 5/3 (pool)"] = time.perf_counter() - t1
            files = {"5/3": lossless, "9/7": (forms_dir / "big_97.jp2").read_bytes()}
            for route, data in files.items():
                t1 = time.perf_counter()
                plan = jpeg2000.prepare(data)
                tier2_ms = (time.perf_counter() - t1) * 1e3
                t1 = time.perf_counter()
                packed = jpeg2000_cuda.pack(plan, 1)
                pack_ms = (time.perf_counter() - t1) * 1e3
                st = jpeg2000_cuda.stage(packed, dev)
                img, samples, plain = equal_kernels(st, f"1024x2048 {route}", pmap)
                if route == "5/3":
                    check(np.array_equal(img.cpu().numpy(), scene), "the lossless 1024x2048 read is not the scene")
                else:
                    check(sha(img.cpu().numpy()) == meta["big_97.jp2"]["cv2"]["color"]["sha256"],
                          "the 9/7 1024x2048 read is not cv2's")
                size = plan.size
                coef_scratch = jpeg2000_cuda.t1_decode(st)
                res_bytes = sum(int(r[0]) * int(r[1]) for t in packed.tcs for r in packed.res[t[5] + 1:t[5] + t[3] + 1])
                work_bytes = {"t1_decode": packed.blob.nbytes + packed.blocks.nbytes + packed.segs.nbytes + 4 * size,
                              "idwt": 8 * size, "mct_store": 4 * size + img.numel() * img.element_size()}
                # 9/7: about 10 float32 operations a sample a pass (2 passes a level); 5/3 counted as bytes
                ops = {"t1_decode": 0, "idwt": 0 if route == "5/3" else 20 * res_bytes,
                       "mct_store": 0 if route == "5/3" else 10 * img.numel()}
                calls = {"t1_decode": lambda: jpeg2000_cuda.t1_decode(st),
                         "idwt": lambda: jpeg2000_cuda.idwt(st, coef_scratch),
                         "mct_store": lambda: jpeg2000_cuda.mct_store(st, samples)}
                per = {}
                for k, fn in calls.items():
                    dev_us, per_call, how = j2k_device_us(fn, J2K_KERNELS[k], jpeg2000_cuda.launches, k)
                    bound = bound_us(work_bytes[k], ops[k])
                    per[k] = {"device_us": dev_us, "launches_per_call": per_call, "how": how,
                              "host_us": j2k_host_us(fn),
                              "bound_us": bound[0], "bound_by": bound[1], "plain_ms": plain[k] * 1e3,
                              "bytes": work_bytes[k]}
                for _ in range(2):
                    jpeg2000_cuda.decode(data, 1, dev)
                reps = []
                for _ in range(5):
                    t1 = time.perf_counter()
                    out = jpeg2000_cuda.decode(data, 1, dev)
                    reps.append((time.perf_counter() - t1) * 1e3)
                check(out.shape == (1024, 2048, 3), f"{route} read shape {tuple(out.shape)}")
                big[route] = {"bytes": len(data), "tier2_ms": tier2_ms, "pack_ms": pack_ms,
                              "blocks": int(len(packed.blocks)), "end_to_end_ms": sorted(reps)[2],
                              "end_to_end_ms_all": reps, "kernels": per}
                timings[route] = per
                print(f"1024x2048 {route} ({len(data)} B, {len(packed.blocks)} code-blocks): host tier-2 "
                      f"{tier2_ms:.3f} ms, pack {pack_ms:.3f} ms, one read end to end {sorted(reps)[2]:.3f} ms "
                      f"(median of 5, host clock with the stream's synchronize) [{label}]", flush=True)
                for k, v in per.items():
                    print(f"  {J2K_KERNELS[k]}: device {v['device_us']:.3f} us/call ({v['launches_per_call']:g} "
                          f"launches, {v['how']}), host {v['host_us']:.3f} us/call (wrapper), bound "
                          f"{v['bound_us']:.4f} us ({v['bound_by']}), plain {v['plain_ms']:.3f} ms "
                          f"({'over ' + str(workers) + ' processes' if k == 't1_decode' else 'one process'}) "
                          f"[{label}]", flush=True)
        record["1024x2048"] = big
        print(f"1024x2048 kernels == their plain versions bit for bit on both files; the 5/3 read equals the "
              f"scene; encode (port, {workers} processes) {secs['encode 5/3 (pool)']:.2f} s [{label}]", flush=True)

        # ---- 19d. the main path: multi_demo, a loader batch and a train_step on .jp2 images
        src = create_model(net, (H, W), num_classes=NUM_CLASSES, device=dev,
                           generator=torch.Generator().manual_seed(19))
        model_dir = work / "model"
        CheckpointManager(checkpoint_prefix(str(model_dir), net, H)).save(
            0, MultiTaskSolver(src.model, src.anchors, device=dev).init_state())
        paths = [work / "scene_53.jp2", work / "scene_97.jp2"]
        paths[0].write_bytes(lossless)
        paths[1].write_bytes(files["9/7"])
        demo_args = ["--network", net, "--data-shape", f"3,{H},{W}", "--model-dir", str(model_dir), "--epoch", "0",
                     "--dtype", "bfloat16", "--vis-thresh", "0.3", "--out-dir", str(work / "out"),
                     "--device", str(dev), "--images", ",".join(str(x) for x in paths)]
        reset()
        t1 = time.perf_counter()
        written = multi_demo.main(demo_args)
        torch.cuda.synchronize()
        secs["multi_demo"] = time.perf_counter() - t1
        got = {"nms": nms_cuda.launches, "t1_decode": jpeg2000_cuda.launches["t1_decode"],
               "mct_store": jpeg2000_cuda.launches["mct_store"], "plain_j2k_decodes": jpeg2000.decodes,
               "plain_versions": sum(jpeg2000_cuda.plain_calls.values()), "nvjpeg_images": jpeg_cuda.images}
        check(got == {"nms": 2, "t1_decode": 2, "mct_store": 2, "plain_j2k_decodes": 0, "plain_versions": 0,
                      "nvjpeg_images": 0}, f"multi_demo on .jp2: counts {got}")
        check(jpeg2000_cuda.launches["idwt"] >= 2, "multi_demo on .jp2 launched no idwt")
        check([Path(w).name for w in written] == [x.stem + "_out.jpg" for x in paths], f"written {written}")
        for k in J2K_KERNELS:
            launches[k]["jpeg2000_demo"] = jpeg2000_cuda.launches[k]
        launches["nms_keep_mask"]["jpeg2000_demo"] = got["nms"]
        record["demo"] = {"counts": got, "idwt": jpeg2000_cuda.launches["idwt"], "seconds": secs["multi_demo"]}
        print(f"multi_demo {net} {H}x{W} bf16 on the 1024x2048 5/3 and 9/7 files: {secs['multi_demo']:.2f} s; "
              f"counts {got}, idwt launches {jpeg2000_cuda.launches['idwt']} [{label}]", flush=True)

        B = 4
        solver = MultiTaskSolver(src.model, src.anchors, batch_size=B, compute_dtype="bfloat16", device=dev,
                                 seg_normalize="valid", learning_rate=5e-4)
        state = solver.init_state()
        classes = ["person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle"]
        rng = np.random.RandomState(190)
        root = work / "yolo"
        (root / "images").mkdir(parents=True)
        (root / "labels").mkdir()
        ids = []
        t1 = time.perf_counter()
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            pmap = functools.partial(pool.map, chunksize=8)
            for i in range(B):
                img, rows = synthetic.make_example(rng, (H, W), 4)[:2]
                iid = f"im{i}"
                ids.append(iid)
                (root / "images" / (iid + ".jp2")).write_bytes(jpeg2000.encode(img, map=pmap))
                lines = [f"{int(r[0])} {(r[1] + r[3]) / 2:.6f} {(r[2] + r[4]) / 2:.6f} {r[3] - r[1]:.6f} "
                         f"{r[4] - r[2]:.6f}" for r in np.asarray(rows) if r[0] >= 0]
                (root / "labels" / (iid + ".txt")).write_text("\n".join(lines) + "\n")
        secs["write yolo .jp2"] = time.perf_counter() - t1
        (root / "list.txt").write_text("\n".join(ids) + "\n")
        index = SampleIndex(YoloFormat(str(root / "list.txt"), str(root / "images"), str(root / "labels"),
                                       classes, image_ext=".jp2").samples())
        reset()
        t1 = time.perf_counter()
        it = DeviceAugIterator(index, B, (H, W), device=dev, seed=19, enable_aug=False, shuffle=False)
        (batch, names), = list(it.epoch())
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        counts = {"t1_decode": jpeg2000_cuda.launches["t1_decode"], "mct_store": jpeg2000_cuda.launches["mct_store"],
                  "plain_j2k_decodes": jpeg2000.decodes, "plain_versions": sum(jpeg2000_cuda.plain_calls.values()),
                  "nvjpeg_images": jpeg_cuda.images}
        check(counts == {"t1_decode": B, "mct_store": B, "plain_j2k_decodes": 0, "plain_versions": 0,
                         "nvjpeg_images": 0}, f".jp2 loader counts {counts}")
        for k in J2K_KERNELS:
            launches[k]["jpeg2000_loader"] = jpeg2000_cuda.launches[k]
        raw = torch.stack([torch.from_numpy(jpeg2000.decode((Path(s.image_path)).read_bytes())).to(dev)
                           for s in index])
        labels = torch.from_numpy(np.stack([s.label for s in index]).astype(np.float32))
        ref = device_augment_batch(raw, None, labels, torch.zeros(B, 6), it.lut, (H, W), enable_aug=False,
                                   mean_pixels=it.mean_pixels)
        check(torch.equal(batch["images"], ref["images"]), ".jp2 loader batch != the plain decodes")
        reset()
        state, m = solver.train_step(state, batch)
        loss = float(m["loss"])
        check(np.isfinite(loss), f".jp2 train_step loss {loss}")
        check(matching_cuda.launches == 1, f".jp2 train_step launched the matcher {matching_cuda.launches} times")
        launches["bipartite_match"]["jpeg2000_train"] = matching_cuda.launches
        record["loader"] = {"images": names, "load_s": load_s, "loss": loss, "counts": counts,
                            "write_s": secs["write yolo .jp2"]}
        print(f"DeviceAugIterator b{B} over YoloFormat(image_ext='.jp2') {H}x{W}: equal to the plain decodes "
              f"through device_augment_batch; {load_s:.3f} s; one train_step loss {loss:.6g}; counts {counts} "
              f"[{label}]", flush=True)
        del solver, state, src
    finally:
        shutil.rmtree(work, ignore_errors=True)
    record["seconds"] = secs
    print(json.dumps({"jpeg2000_phase": record}), flush=True)
    return launches, timings, record


MP4V_KERNELS = {"mp4v_parse": "mp4v_parse_kernel", "mp4v_recon": "mp4v_recon_kernel",
                "yuv420_to_bgr": "yuv420_to_bgr_kernel"}


def _plain_parse(args):
    """One VOP through the plain entropy stage (a pool worker's job)."""
    from dspnet_torch.data import mpeg4

    sample, config, bit, kind, qp, fcode, thr = args
    vol = mpeg4.parse_config(config)
    t0 = time.perf_counter()
    mb, levels = mpeg4.parse_vop(sample, vol, mpeg4.VopHeader(kind, True, 0, thr, qp, fcode, 0, bit))
    return mb, levels, time.perf_counter() - t0


def mp4v_phase(dev, label):
    """Phase 20: MPEG-4 Part 2 through the three kernels of ``csrc/mpeg4.cu``
    (``data/mpeg4_cuda.py``). Every committed form of
    ``tests/fixtures/mp4v_forms/`` decoded on the card against cv2's sha256
    per frame (cv2's 2048x1024 clip among them: half-pel MVs with f_code up
    to 6, both rounding types, intra macroblocks in P-VOPs, MVs off the
    frame's edges), each kernel against its plain version bit for bit stage
    by stage (the plain parse over a process pool; on 2 VOPs a batch of
    cv2's 2048x1024 clip), the parse kernel against the one before its
    redesign (``baselines/mp4v_parse_per_thread.cu``) on every batch, the
    refusals by name; a 1024x2048 textured clip of 24 frames (two GOPs)
    written by the port on the card, its kernels against their plain versions
    (2 VOPs a batch) and timed, the parse before and after its redesign in
    turns with its longest VOP's VLC symbols; ``multi_demo
    --images clip.mp4`` at resnet-50_multi 512x1024 bf16 (seed 20) with the
    launches counted, its ``detection_out.mp4`` read back by the port's
    decoder, each stage's ms per frame, the writer's bytes and PSNR. Returns
    ({kernel: {path: launches}}, {kernel: times and the largest difference
    from its plain version}, record)."""
    import hashlib
    import multiprocessing
    import os
    import tempfile

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import multi_demo
    from dspnet_torch.data import avi, jpeg, jpeg_cuda, mp4, mpeg4, mpeg4_cuda
    from dspnet_torch.data.device_pipeline import resize_linear
    from dspnet_torch.detect import video
    from dspnet_torch.detect.pipeline import ServingPipeline
    from dspnet_torch.ops import nms_cuda
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils import draw, text
    from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix

    net, n_frames, FH, FW, thresh = "resnet-50_multi", 24, 1024, 2048, 0.3
    fixture = ROOT / "tests" / "fixtures" / "mp4v_forms"
    meta = json.loads((fixture / "forms.json").read_text())
    launches = {"nms_keep_mask": {}, **{k: {} for k in MP4V_KERNELS}}
    record, secs, timings = {}, {}, {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_mp4v_", dir=ROOT / "build"))
    workers = min(8, os.cpu_count() or 1)

    def reset():
        for d in (mpeg4_cuda.launches, mpeg4_cuda.plain_calls):
            d.update(dict.fromkeys(d, 0))
        nms_cuda.launches = jpeg_cuda.images = jpeg.decodes = mpeg4.encodes = 0

    def sha(t):
        return hashlib.sha256(np.ascontiguousarray(t.cpu().numpy() if torch.is_tensor(t) else t).tobytes()).hexdigest()

    def psnr(a, b):
        mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
        return 10 * np.log10(255.0 ** 2 / mse)

    err = dict.fromkeys(MP4V_KERNELS, 0)

    def largest(a, b):
        return int((torch.as_tensor(a).cpu().to(torch.int32) - torch.as_tensor(b).cpu().to(torch.int32)).abs().max())

    old_parse = mp4v_parse_baseline(dev)
    plain_vops = {"mp4v_parse": 0}

    def stagewise(samples, config, fourcc, pmap, plain_per_batch=None):
        """Each batch of 8 through the kernels and their plain versions on
        the same inputs (the plain versions on the first ``plain_per_batch``
        VOPs of a batch, every one when None), the parse kernel also against
        the kernel before its redesign on every VOP (tables, levels and
        status), the largest difference of each kept in ``err``; -> (frames,
        plain seconds by kernel)."""
        dec = mpeg4_cuda.Decoder(dev, config, fourcc)
        frames, plain = [], dict.fromkeys(MP4V_KERNELS, 0.0)
        for i in range(0, len(samples), 8):
            chunk = samples[i:i + 8]
            headers = [mpeg4.read_vop_header(x, dec.vol) for x in chunk]
            coded = [(x, h) for x, h in zip(chunk, headers) if h.coded]
            if not coded:
                continue
            bits, vops = mpeg4_cuda.stage([c[0] for c in coded], [c[1] for c in coded], dev)
            mb, levels = mpeg4_cuda.parse(bits, vops, dec.vol)
            (new_mb, new_lv, new_st), new_l = mpeg4_cuda.parse_launches(bits, vops, dec.vol)
            (old_mb, old_lv, old_st), old_l, _ = old_parse(bits, vops, dec.vol)
            new_l[0][1]()
            old_l[0][1]()
            err["mp4v_parse"] = max(err["mp4v_parse"], largest(mb, old_mb), largest(levels, old_lv),
                                    largest(new_st, old_st))
            check(torch.equal(mb, old_mb) and torch.equal(levels, old_lv) and torch.equal(new_st, old_st) and
                  torch.equal(mb, new_mb) and torch.equal(levels, new_lv),
                  f"mp4v_parse_kernel != the kernel before its redesign on the batch from VOP {i}")
            jobs = [(x, config if config else x, h.bitpos, h.kind, h.qp, h.fcode, h.dc_threshold) for x, h in coded]
            if not config:  # the VOL is in band: parse it from the first sample of the stream
                jobs = [(x, samples[0], *rest) for x, _, *rest in jobs]
            for k, (mb_ref, lv_ref, s_ref) in enumerate(pmap(_plain_parse, jobs[:plain_per_batch])):
                plain["mp4v_parse"] += s_ref
                plain_vops["mp4v_parse"] += 1
                err["mp4v_parse"] = max(err["mp4v_parse"], largest(mb[k], mb_ref), largest(levels[k], lv_ref))
                check(np.array_equal(mb[k].cpu().numpy(), mb_ref) and np.array_equal(levels[k].cpu().numpy(), lv_ref),
                      f"mp4v_parse_kernel != plain on VOP {i + k}")
            for k, (_, hdr) in enumerate(coded):
                ref = dec.ref if hdr.kind == "P" else None
                planes = mpeg4_cuda.recon(mb[k], levels[k], dec.vol, hdr.rounding, ref)
                if plain_per_batch is not None and k >= plain_per_batch:
                    dec.ref = planes
                    frames.append(mpeg4_cuda.yuv420_to_bgr(*planes, dec.vol.height, dec.vol.width))
                    continue
                t0 = time.perf_counter()
                want = mpeg4_cuda.recon_ref(mb[k].cpu(), levels[k].cpu(), dec.vol, hdr.rounding,
                                            None if ref is None else tuple(p.cpu() for p in ref))
                plain["mp4v_recon"] += time.perf_counter() - t0
                err["mp4v_recon"] = max(err["mp4v_recon"], *(largest(p, w) for p, w in zip(planes, want)))
                check(all(torch.equal(p.cpu(), w) for p, w in zip(planes, want)), f"mp4v_recon_kernel != plain, VOP {i + k}")
                dec.ref = planes
                frame = mpeg4_cuda.yuv420_to_bgr(*planes, dec.vol.height, dec.vol.width)
                t0 = time.perf_counter()
                host = mpeg4.yuv420_to_bgr(*(p.cpu() for p in planes), dec.vol.height, dec.vol.width)
                plain["yuv420_to_bgr"] += time.perf_counter() - t0
                err["yuv420_to_bgr"] = max(err["yuv420_to_bgr"], largest(frame, host))
                check(torch.equal(frame.cpu(), host), f"yuv420_to_bgr_kernel != plain, VOP {i + k}")
                frames.append(frame)
        return frames, plain

    pool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        # ---- 20a. the committed forms: cv2's sha256, kernels == plain, refusals
        t0 = time.perf_counter()
        n_forms = n_vops = 0
        for name, m in sorted(meta.items()):
            with avi.open_video(fixture / name) as reader:
                samples, stream = list(reader), reader.stream
            if m["source"] == "refusal":
                reset()
                try:
                    mpeg4_cuda.Decoder(dev, stream.extradata, stream.fourcc).decode(samples)
                    check(False, f"{name}: decoded, expected a refusal naming {m['refused']!r}")
                except avi.VideoError as e:
                    check(m["refused"] in str(e), f"{name}: the refusal does not name {m['refused']!r}: {e}")
                check(sum(mpeg4_cuda.launches.values()) == 0, f"{name}: launched before refusing")
                continue
            reset()
            dec = mpeg4_cuda.Decoder(dev, stream.extradata, stream.fourcc)
            frames = [f for i in range(0, len(samples), 8) for f in dec.decode(samples[i:i + 8])]
            want = m.get("port_bgr_sha256", m["bgr_sha256"])  # an odd height: the port's own frames
            check([sha(f) for f in frames] == want, f"{name}: frames != cv2's sha256")
            check(mpeg4_cuda.plain_calls == dict.fromkeys(MP4V_KERNELS, 0) and
                  mpeg4_cuda.launches["mp4v_recon"] == len(frames) == mpeg4_cuda.launches["yuv420_to_bgr"],
                  f"{name}: launches {mpeg4_cuda.launches}, plain calls {mpeg4_cuda.plain_calls}")
            # the plain versions on 2 VOPs a batch of cv2's 2048x1024 clip (a plain VOP there takes about a second)
            again, _ = stagewise(samples, stream.extradata, stream.fourcc, pool.map,
                                 2 if m["width"] * m["height"] > 640 * 480 else None)
            check([sha(f) for f in again] == want, f"{name}: stagewise frames != cv2's sha256")
            n_forms += 1
            n_vops += len(frames)
        secs["forms"] = time.perf_counter() - t0
        n_refused = sum(m["source"] == "refusal" for m in meta.values())
        record["forms"] = {"decoded": n_forms, "frames": n_vops, "refused": n_refused}
        print(f"mp4v forms on the card: {n_forms} streams, {n_vops} frames == cv2's sha256 through the three kernels "
              f"(plain calls 0), each kernel == its plain version on every VOP; {n_refused} refusals by name; "
              f"{secs['forms']:.1f} s [{label}]", flush=True)

        # ---- 20b. a 1024x2048 textured clip of 24 frames written by the port on the card
        rng = np.random.default_rng(20)
        base = torch.from_numpy(rng.integers(0, 256, (FH // 8 + 16, FW // 8 + 24, 3), dtype=np.uint8)).to(dev)
        base = torch.nn.functional.interpolate(base.permute(2, 0, 1)[None].float(), scale_factor=8, mode="bilinear")
        base = base[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)
        clip = work / "clip.mp4"
        enc = mpeg4.Encoder(FW, FH)
        src_frames = [base[2 * i:2 * i + FH, 3 * i:3 * i + FW].contiguous() for i in range(n_frames)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mp4.Mp4Writer(str(clip), FW, FH, enc.config) as writer:
            for f in src_frames:
                writer.write(*enc.encode(f))
        secs["write clip"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with avi.open_video(clip) as reader:
            samples, stream = list(reader), reader.stream
        container_ms = (time.perf_counter() - t0) * 1e3
        vol = mpeg4.parse_config(stream.extradata)
        t0 = time.perf_counter()
        headers = [mpeg4.read_vop_header(x, vol) for x in samples]
        headers_ms = (time.perf_counter() - t0) * 1e3
        check(len(samples) == n_frames and [h.kind for h in headers].count("I") == 2,
              f"the clip: {len(samples)} VOPs, kinds {[h.kind for h in headers]}")
        t0 = time.perf_counter()
        plain_vops["mp4v_parse"] = 0
        frames, plain = stagewise(samples, stream.extradata, "mp4v", pool.map, plain_per_batch=2)
        secs["stagewise 1024x2048"] = time.perf_counter() - t0
        encoded_db = [psnr(f.cpu().numpy(), s.cpu().numpy()) for f, s in zip(frames, src_frames)]
        # the kernels timed at the clip's shapes: the parse of the first batch
        # (8 VOPs, one launch), the reconstruction of an I- and a P-VOP, the
        # colour of one frame
        bits, vops = mpeg4_cuda.stage(samples[:8], headers[:8], dev)
        mb, levels = mpeg4_cuda.parse(bits, vops, vol)
        i_planes = mpeg4_cuda.recon(mb[0], levels[0], vol, 0, None)
        n_mb = vol.mb_num
        plane_bytes = n_mb * 384  # Y, U and V of every macroblock
        p_planes = mpeg4_cuda.recon(mb[1], levels[1], vol, headers[1].rounding, i_planes)
        calls = {"mp4v_parse": lambda: mpeg4_cuda.parse(bits, vops, vol),
                 "mp4v_recon": lambda: mpeg4_cuda.recon(mb[1], levels[1], vol, headers[1].rounding, i_planes),
                 "yuv420_to_bgr": lambda: mpeg4_cuda.yuv420_to_bgr(*p_planes, FH, FW)}
        # bytes each function must move (inputs read once, outputs written
        # once) and its integer operations (counted at the float32 rate)
        coded_bytes = int(sum(len(x) for x in samples[:8]))
        nz = int((levels[1] != 0).sum())
        work_bytes = {"mp4v_parse": coded_bytes + 8 * n_mb * (12 * 4 + 6 * 64 * 2),
                      "mp4v_recon": n_mb * (12 * 4 + 6 * 64 * 2) + 2 * plane_bytes,
                      "yuv420_to_bgr": FH * FW * 3 // 2 + FH * FW * 3}
        ops = {"mp4v_parse": 0, "mp4v_recon": n_mb * 6 * (64 * 20 + 2 * 8 * 40) + 3 * nz,
               "yuv420_to_bgr": FH * FW * 12}
        plain_ms = {"mp4v_parse": plain["mp4v_parse"] / plain_vops["mp4v_parse"] * 8e3,
                    "mp4v_recon": plain["mp4v_recon"] / plain_vops["mp4v_parse"] * 1e3,
                    "yuv420_to_bgr": plain["yuv420_to_bgr"] / plain_vops["mp4v_parse"] * 1e3}
        # the parse before and after its redesign in turns (old, new, new, old; CUDA events around each launch),
        # and the chain: VLC symbols of the longest VOP of the batch
        steps = torch.zeros(len(vops), dtype=torch.int32, device=dev)
        (_, _, _), new_l = mpeg4_cuda.parse_launches(bits, vops, vol, steps=steps)
        (_, _, _), old_l, old_prep = old_parse(bits, vops, vol)
        new_us, old_us = parse_turns(new_l, old_l, old_prep)
        chain = int(steps.max())
        per = {}
        for k, fn in calls.items():
            if k == "mp4v_parse":  # events around each launch, the first new turn (the profiler drops launches)
                dev_us, per_call, how = new_us[0], 1.0, "CUDA events around each launch"
            else:
                dev_us, per_call, how = j2k_device_us(fn, MP4V_KERNELS[k], mpeg4_cuda.launches, k, n=20)
            bound = bound_us(work_bytes[k], ops[k])
            per[k] = {"device_us": dev_us, "launches_per_call": per_call, "how": how,
                      "host_us": j2k_host_us(fn, n=3 if k == "mp4v_parse" else 20), "max_abs_err": err[k],
                      "bound_us": bound[0], "bound_by": bound[1], "plain_ms": plain_ms[k], "bytes": work_bytes[k]}
        per["mp4v_parse"].update(new_us_turns=new_us, old_us_turns=old_us, chain_steps=chain,
                                 ns_per_step=new_us[0] * 1e3 / chain, us_per_mb=new_us[0] / n_mb,
                                 old_ns_per_step=old_us[0] * 1e3 / chain, plain_vops=plain_vops["mp4v_parse"])
        timings = per
        record["1024x2048"] = {"bytes": int(sum(len(x) for x in samples)), "container_ms": container_ms,
                               "vop_headers_ms": headers_ms, "writer_psnr_db": [min(encoded_db), max(encoded_db)],
                               "stagewise_s": secs["stagewise 1024x2048"], "kernels": per}
        print(f"1024x2048 mp4v clip, {n_frames} VOPs (2 GOPs) written by the port on the card in {secs['write clip']:.2f} "
              f"s ({record['1024x2048']['bytes']} bytes, {min(encoded_db):.2f}-{max(encoded_db):.2f} dB against the "
              f"source frames): each kernel == its plain version on every VOP; host: container {container_ms:.3f} ms, "
              f"{n_frames} VOP headers {headers_ms:.3f} ms [{label}]", flush=True)
        pv = per["mp4v_parse"]
        print(f"  mp4v_parse_kernel before -> after its redesign, in turns old, new, new, old (CUDA events around each "
              f"launch, 8 VOPs): old {old_us[0]:.1f} [{old_us[1]:.1f}] us -> new {new_us[0]:.1f} [{new_us[1]:.1f}] us "
              f"({old_us[0] / new_us[0]:.2f}x), equal on every batch; the longest VOP's chain {chain} VLC symbols: new "
              f"{pv['ns_per_step']:.1f} ns a symbol, {pv['us_per_mb']:.3f} us a macroblock ({n_mb} a VOP); old "
              f"{pv['old_ns_per_step']:.1f} ns a symbol [{label}]", flush=True)
        plain_how = {"mp4v_parse": f"8 VOPs, from {pv['plain_vops']} VOPs over {workers} processes"}
        for k, v in per.items():
            print(f"  {MP4V_KERNELS[k]}: device {v['device_us']:.3f} us/call ({v['launches_per_call']:g} launches, "
                  f"{v['how']}{', 8 VOPs a launch' if k == 'mp4v_parse' else ''}), host {v['host_us']:.3f} us/call "
                  f"(wrapper), bound {v['bound_us']:.4f} us ({v['bound_by']}), plain {v['plain_ms']:.3f} ms "
                  f"({plain_how.get(k, 'one process')}) [{label}]", flush=True)
        del base, src_frames, frames

        # ---- 20c. multi_demo on the clip: the counts, the written file
        src = create_model(net, (H, W), num_classes=NUM_CLASSES, device=dev,
                           generator=torch.Generator().manual_seed(20))
        model_dir = work / "model"
        CheckpointManager(checkpoint_prefix(str(model_dir), net, H)).save(
            0, MultiTaskSolver(src.model, src.anchors, device=dev).init_state())
        del src
        out_dir = work / "out"
        demo_args = ["--network", net, "--data-shape", f"3,{H},{W}", "--model-dir", str(model_dir), "--epoch", "0",
                     "--dtype", "bfloat16", "--vis-thresh", str(thresh), "--out-dir", str(out_dir),
                     "--device", str(dev), "--images", str(clip)]
        reset()
        t0 = time.perf_counter()
        written = multi_demo.main(demo_args)
        torch.cuda.synchronize()
        secs["multi_demo"] = time.perf_counter() - t0
        slots = 3
        got = {"nms": nms_cuda.launches, **mpeg4_cuda.launches, "plain_calls": sum(mpeg4_cuda.plain_calls.values()),
               "mp4v_encodes": mpeg4.encodes, "nvjpeg_images": jpeg_cuda.images}
        want = {"nms": 2 * slots, "mp4v_parse": n_frames // 8, "mp4v_recon": n_frames, "yuv420_to_bgr": n_frames,
                "plain_calls": 0, "mp4v_encodes": n_frames, "nvjpeg_images": 0}
        check(got == want, f"multi_demo on clip.mp4: counts {got}, expected {want}")
        check(written == [str(out_dir / "detection_out.mp4")], f"multi_demo wrote {written}")
        for k in MP4V_KERNELS:
            launches[k]["mp4v_demo"] = got[k]
        launches["nms_keep_mask"]["mp4v_demo"] = got["nms"]
        nms_cuda.launches = 0  # the checks below count apart from the demo
        with avi.open_video(written[0]) as reader:
            out_samples, out_stream = list(reader), reader.stream
        check((len(out_samples), out_stream.fps, out_stream.width, out_stream.height, out_stream.fourcc) ==
              (n_frames, 25.0, FW, FH, "mp4v"), f"detection_out.mp4: {len(out_samples)} VOPs, {out_stream[:5]}")
        out_dec = mpeg4_cuda.Decoder(dev, out_stream.extradata, out_stream.fourcc)
        back = [f for i in range(0, n_frames, 8) for f in out_dec.decode(out_samples[i:i + 8])]
        detector = multi_demo.get_detector(multi_demo.parse_args(demo_args))
        with avi.open_video(clip) as reader:
            rendered = list(video.render(detector, reader, thresh, 0.95))
        out_db = [psnr(b.cpu().numpy(), r) for b, r in zip(back, rendered)]
        record["demo"] = {"counts": got, "seconds": secs["multi_demo"], "out_bytes_per_frame":
                          [len(x) for x in out_samples], "out_psnr_db": out_db}
        print(f"multi_demo {net} {H}x{W} bf16 --images clip.mp4 ({n_frames} frames): {secs['multi_demo']:.2f} s with "
              f"the model build; counts {got}; detection_out.mp4 read back by the port's decoder: {len(back)} frames, "
              f"25 fps, {FW}x{FH}; writer bytes per frame {min(len(x) for x in out_samples)}-"
              f"{max(len(x) for x in out_samples)}, PSNR per frame against the rendered frames {min(out_db):.2f}-"
              f"{max(out_db):.2f} dB [{label}]", flush=True)

        # ---- 20d. each stage per 1024x2048 frame (synchronised around each)
        stage = dict.fromkeys(("read", "headers", "parse", "recon", "colour", "resize", "serve", "nms 0.95",
                               "overlay", "draw", "encode", "write"), 0.0)

        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stage[name] += time.perf_counter() - t
            return out

        with avi.open_video(clip) as reader:
            samples = timed("read", lambda: list(reader))
        dec = mpeg4_cuda.Decoder(dev, stream.extradata, "mp4v")
        frames = []
        for i in range(0, n_frames, 8):
            chunk = samples[i:i + 8]
            hdrs = timed("headers", lambda: [mpeg4.read_vop_header(x, dec.vol) for x in chunk])
            b_, v_ = mpeg4_cuda.stage(chunk, hdrs, dev)
            mb_, lv_ = timed("parse", lambda: mpeg4_cuda.parse(b_, v_, dec.vol))
            for k, h in enumerate(hdrs):
                dec.ref = timed("recon", lambda: mpeg4_cuda.recon(mb_[k], lv_[k], dec.vol, h.rounding,
                                                                  dec.ref if h.kind == "P" else None))
                frames.append(timed("colour", lambda: mpeg4_cuda.yuv420_to_bgr(*dec.ref, FH, FW)))
        raws = [timed("resize", lambda: resize_linear(f, (H, W))) for f in frames]
        pipe = ServingPipeline(detector, depth=2, raw=True)
        for r in raws[:3]:
            pipe.submit(r)
        list(pipe.drain())

        def serve_all():
            res = [pipe.submit(r) for r in raws]
            return [x for x in res if x is not None] + list(pipe.drain())

        results = [x[1] for x in timed("serve", serve_all)]
        rows = [detector._filter_rows(r["det"][0], 0.0) for r in results]
        kept = [timed("nms 0.95", lambda: video.second_nms(d, (H, W), 0.95)) for d in rows]
        segs = [torch.from_numpy(r["seg"][0]) for r in results]
        overs = [timed("overlay", lambda: draw.seg_overlay_tensor(f, s_, detector.palette)) for f, s_ in zip(frames, segs)]
        text.STATS.update(hits=0, misses=0)
        drawn = [timed("draw", lambda: detector.draw_boxes(o.cpu().numpy(), d, thresh)) for o, d in zip(overs, kept)]
        record["text_cache"] = dict(text.STATS, labels=sum(int((d[:, 1] >= thresh).sum()) for d in kept))
        del overs, frames, raws
        encoder = mpeg4.Encoder(FW, FH)
        encoded = [timed("encode", lambda: encoder.encode(torch.from_numpy(img).to(dev))) for img in drawn]
        with mp4.Mp4Writer(str(work / "stages.mp4"), FW, FH, encoder.config, 25) as writer:
            for e in encoded:
                timed("write", lambda: writer.write(*e))
        per_frame = {k: v * 1e3 / n_frames for k, v in stage.items()}
        t0 = time.perf_counter()
        detector.detect_and_visualize(str(clip), str(work / "again"), thresh)
        total_ms = (time.perf_counter() - t0) * 1e3 / n_frames
        record["stage_ms"] = per_frame
        record["total_ms_per_frame"] = total_ms
        print(f"mp4v video per {FH}x{FW} frame ({n_frames} frames, each stage synchronised; parse per batch of 8 "
              f"VOPs spread over its frames): " + ", ".join(f"{k} {v:.3f} ms" for k, v in per_frame.items())
              + f"; stages summed {sum(per_frame.values()):.3f} ms; detect_and_visualize end to end {total_ms:.3f} "
              f"ms/frame ({1e3 / total_ms:.2f} frames/s) [{label}]", flush=True)
        print(f"phase 20 draw stage {per_frame['draw']:.3f} ms per {FH}x{FW} frame, "
              f"{record['text_cache']['labels']} labels: text layout cache {record['text_cache']['hits']} hits, "
              f"{record['text_cache']['misses']} misses [{label}]", flush=True)
        launches["nms_keep_mask"]["mp4v_checks"] = nms_cuda.launches
    finally:
        pool.terminate()
        pool.join()
        shutil.rmtree(work, ignore_errors=True)
    record["seconds"] = secs
    record["max_abs_err"] = err
    print(json.dumps({"mp4v_phase": record}), flush=True)
    return launches, timings, record


def text_phase(dev, label):
    """Phase 21: the demo's text as cv2 5.0.0 draws it, on the card's
    machine, which has no cv2: the font's sha256, every committed form of
    ``tests/fixtures/text_forms/`` drawn on its seeded background (numpy's
    legacy ``RandomState``, as ``tests/make_text_fixtures.py`` draws it)
    equal to cv2's sha256 and ``getTextSize`` to cv2's, the refusals by
    name, then host ms per form, and per 1024x2048 frame of 40 demo labels
    with the caches cold and warm."""
    import hashlib

    from dspnet_torch.data.cs_labels import DET_CLASSES
    from dspnet_torch.utils import draw, text

    record = {}
    font_sha = hashlib.sha256(text.FONT_PATH.read_bytes()).hexdigest()
    text.font()  # raises on a font other than cv2's
    check(font_sha == text.FONT_SHA256, f"font sha256 {font_sha}")
    forms = json.loads((ROOT / "tests" / "fixtures" / "text_forms" / "forms.json").read_text())["forms"]
    text.clear_caches()
    t0 = time.perf_counter()
    bad = []
    for f in forms:
        img = np.random.RandomState(f["seed"]).randint(0, 256, f["shape"]).astype(np.uint8)
        text.put_text(img, f["text"], f["org"], f["face"], f["scale"], f["color"], f["thickness"])
        (w, h), bl = text.get_text_size(f["text"], f["face"], f["scale"], f["thickness"])
        if hashlib.sha256(img.tobytes()).hexdigest() != f["sha256"] or [[w, h], bl] != f["text_size"]:
            bad.append(f["text"])
    forms_ms = (time.perf_counter() - t0) * 1e3 / len(forms)
    check(not bad, f"text forms unequal to cv2's: {bad[:5]}")
    refusals = {}
    for name, call in (("FONT_HERSHEY_DUPLEX", lambda: text.get_text_size("a", 2, 0.5, 1)),
                       ("FONT_ITALIC", lambda: text.get_text_size("a", 16, 0.5, 1)),
                       ("thickness 4", lambda: text.get_text_size("a", 0, 0.5, 4)),
                       ("mirrors", lambda: text.get_text_size("a", 0, -0.5, 1)),
                       ("U+4E2D", lambda: text.get_text_size("\u4e2d", 0, 0.5, 1)),
                       ("bottomLeftOrigin", lambda: text.put_text(np.zeros((9, 9, 3), np.uint8), "a", (0, 5), 0,
                                                                  0.5, (1, 2, 3), 1, True))):
        try:
            call()
            refusals[name] = "not refused"
        except text.TextError as e:
            refusals[name] = "refused" if name in str(e) else f"wrong message: {e}"
    check(all(v == "refused" for v in refusals.values()), f"refusals {refusals}")
    rng = np.random.RandomState(21)
    labels = [(f"{DET_CLASSES[rng.randint(8)]} {rng.randint(256)}m", (int(rng.randint(0, 1900)),
                                                                      int(rng.randint(12, 1024))),
               tuple(int(v) for v in rng.randint(0, 256, 3))) for _ in range(40)]
    frame = rng.randint(0, 256, (1024, 2048, 3)).astype(np.uint8)
    frame_ms = {}
    for state in ("cold", "warm"):
        if state == "cold":
            text.clear_caches()
        img = frame.copy()
        t0 = time.perf_counter()
        for s_, org, colour in labels:
            draw.put_text(img, s_, org, text.FONT_HERSHEY_SIMPLEX, 0.5, colour, 1)
        frame_ms[state] = (time.perf_counter() - t0) * 1e3
    record.update(font_sha256=font_sha, forms=len(forms), unequal=len(bad), ms_per_form=forms_ms,
                  frame_40_labels_ms=frame_ms, refusals=refusals, cache=dict(text.STATS))
    print(f"text: font {text.FONT_PATH.name} sha256 {font_sha}; {len(forms)} committed forms equal to cv2 5.0.0's "
          f"sha256 and getTextSize ({forms_ms:.3f} ms per form, caches cold at the start); refusals "
          f"{sorted(refusals)}; 40 labels on a 1024x2048 frame {frame_ms['cold']:.3f} ms cold, "
          f"{frame_ms['warm']:.3f} ms warm [{label}]", flush=True)
    print(json.dumps({"text_phase": record}), flush=True)
    return record


#: the kernels of ``csrc/av1.cu`` by name, as the profiler shows them
AV1_KERNELS = {"recon": "av1_recon_kernel", "deblock": "av1_deblock_kernel", "cdef": "av1_cdef_kernel",
               "lr": "av1_lr_kernel"}
#: phase 22's 1024x2048 scenes (the deblocking levels of the speed-0 frame are 0; the default frame has no
#: loop restoration: each kernel's line takes the scene where it runs)
AVIF_SCENES = {"big_default.avif": "1024x2048 AVIF at cv2's defaults",
               "big_s0.avif": "1024x2048 AVIF at speed 0 (loop restoration)"}


def _union_count(shape, y0, y1, x0, x1) -> int:
    """How many samples of a (H, W) plane the boxes [y0, y1) x [x0, x1)
    cover together (each box clipped to the plane)."""
    H, W = shape
    y0, y1 = np.clip(y0, 0, H), np.clip(y1, 0, H)
    x0, x1 = np.clip(x0, 0, W), np.clip(x1, 0, W)
    k = (y1 > y0) & (x1 > x0)
    d = np.zeros((H + 1, W + 1), np.int64)
    for ys, xs, v in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1), (y1, x1, 1)):
        np.add.at(d, (ys[k], xs[k]), v)
    return int((d.cumsum(0).cumsum(1)[:H, :W] > 0).sum())


def av1_work(packed, ref):
    """What the function of each AV1 kernel must move and do for this frame,
    from its data: ({kernel: bytes}, {kernel: integer operations}). Samples
    count at the stream's depth (1 B at 8 bits, 2 B above), each read once
    and each written once; ``ref`` holds the plain versions' planes.

    recon: 8 B a transform block (position, size, type, mode, eob), 2 B a
      coded coefficient, the palettes and colour maps in, every sample of
      the frame out; about 12 operations a predicted sample, 4 (log2 w +
      log2 h) + 3 a sample of a block with coefficients, 4 a coefficient.
    deblock: the samples within the taps of a filtered edge (4 lines of
      ``length`` samples across it, both directions) in, the samples it
      changes out; about 5 operations a tap of a line.
    cdef: the 8x8 luma blocks its direction search reads, and each plane's
      filtered blocks with their 2-sample border, in; the CDEF indices and
      one skip bit an 8x8; the samples it changes out; about 900 operations
      a direction search, 150 a filtered sample.
    lr: each restoration rectangle with its 3-sample border, from the CDEF
      planes within the stripe and from the deblocked rows beside it, 8 B
      of unit parameters a rectangle, the samples it changes out; about 32
      operations a Wiener sample, 90 a self-guided one."""
    from dspnet_torch.data import av1_filters
    from dspnet_torch.data import av1_tables as T

    parsed = packed.parsed
    s, h = parsed.frame.seq, parsed.frame.hdr
    bps = 1 if s.bit_depth == 8 else 2
    subs = [(0, 0)] + [(s.ssx, s.ssy)] * (len(packed.dims) - 1)

    def changed(after, before):
        return sum(int((np.asarray(a) != np.asarray(b)).sum()) for a, b in zip(after, before))

    tx = packed.txbs.astype(np.int64)
    pels = tx[:, 19] * tx[:, 20]
    coded = tx[:, 6] > 0
    logs = np.log2(np.array(T.TX_W, np.float64))[tx[:, 4]] + np.log2(np.array(T.TX_H, np.float64))[tx[:, 4]]
    frame_samples = sum(((h.height + sy) >> sy) * ((h.width + sx) >> sx) for sx, sy in subs)
    nbytes = {"recon": 8 * len(tx) + 2 * len(packed.coefs) + bps * packed.palette.size + packed.maps.nbytes
              + bps * frame_samples}
    ops = {"recon": int(12 * pels[tx[:, 0] == 0].sum() + (pels * (4 * logs + 3))[coded].sum()
                        + 4 * len(packed.coefs))}

    reads = 0
    for p, dims in enumerate(packed.dims):
        boxes = []
        for d in (0, 1):
            e = packed.edges[d].astype(np.int64)
            e = e[e[:, 0] == p]
            x, y, half = e[:, 1], e[:, 2], e[:, 3] // 2
            boxes.append((y, y + 4, x - half, x + half) if d == 0 else (y - half, y + half, x, x + 4))
        reads += _union_count(dims, *(np.concatenate(v) for v in zip(*boxes)))
    nbytes["deblock"] = bps * (reads + changed(ref["deblock"], ref["recon"]))
    ops["deblock"] = int(20 * sum(int(e[:, 3].sum()) for e in packed.edges))

    blocks = av1_filters.cdef_blocks(parsed, ref["deblock"]) if _cdef_runs(packed) else np.zeros((0, 5), np.int64)
    reads, filtered = 0, 0
    for p, dims in enumerate(packed.dims):
        sx, sy = subs[p]
        H, W = (h.mi_rows * 4) >> sy, (h.mi_cols * 4) >> sx
        bh, bw = 8 >> sy, 8 >> sx
        y0, x0 = (blocks[:, 0] * 4) >> sy, (blocks[:, 1] * 4) >> sx
        on = np.zeros(len(blocks), bool)
        if len(blocks):
            pri, sec = av1_filters.block_strengths(parsed, blocks, p)[:2]
            on = (pri > 0) | (sec > 0)
        filtered += int(on.sum()) * bh * bw
        box = [[y0[on] - 2], [y0[on] + bh + 2], [x0[on] - 2], [x0[on] + bw + 2]]
        if p == 0:  # the direction search reads every block's 8x8 luma
            for v, extra in zip(box, (y0, y0 + 8, x0, x0 + 8)):
                v.append(extra)
        reads += _union_count((min(H, dims[0]), min(W, dims[1])), *(np.concatenate(v) for v in box))
    n8 = ((h.mi_rows + 1) // 2) * ((h.mi_cols + 1) // 2)
    nbytes["cdef"] = (bps * (reads + changed(ref["cdef"], ref["deblock"])) + packed.cdef_idx.nbytes + (n8 + 7) // 8
                      if len(blocks) else 0)
    ops["cdef"] = 900 * len(blocks) + 150 * filtered

    r = packed.rects.astype(np.int64)
    reads = 0
    for p in range(len(packed.dims)):
        q = r[r[:, 0] == p]
        sx, sy = subs[p]
        shape = ((h.height + sy) >> sy, (h.width + sx) >> sx)
        x0, y0, w, hh, s0, s1 = q[:, 1], q[:, 2], q[:, 3], q[:, 4], q[:, 6], q[:, 7]
        reads += _union_count(shape, np.maximum(y0 - 3, s0), np.minimum(y0 + hh + 3, s1 + 1), x0 - 3, x0 + w + 3)
        top = (np.maximum(y0 - 3, s0 - 2), s0)
        bottom = (s1 + 1, np.minimum(y0 + hh + 3, s1 + 3))
        reads += _union_count(shape, *(np.concatenate(v) for v in zip(top, bottom)),
                              np.concatenate([x0 - 3] * 2), np.concatenate([x0 + w + 3] * 2))
    nbytes["lr"] = bps * (reads + changed(ref["lr"], ref["cdef"])) + 8 * len(r) if len(r) else 0
    ops["lr"] = int((r[:, 3] * r[:, 4] * np.where(r[:, 5] == 1, 32, 90)).sum())
    return nbytes, ops


def _cdef_runs(packed) -> bool:
    s, h = packed.parsed.frame.seq, packed.parsed.frame.hdr
    return bool(s.enable_cdef and not h.coded_lossless and not h.allow_intrabc)


def _avif_plain(args):
    """Every plain stage of one AV1 item of a committed AVIF form (a pool
    worker's job): the reconstruction, deblocked, CDEF and restored planes,
    and each stage's seconds."""
    from dspnet_torch.data import av1_filters, av1_parse, av1_recon, avif

    name, k = args
    data = (ROOT / "tests" / "fixtures" / "avif_forms" / name).read_bytes()
    p = avif.plan(data)
    parsed = av1_parse.parse((p.color + p.alpha)[k].frame)
    t = [time.perf_counter()]
    rec = av1_recon.reconstruct(parsed)
    t.append(time.perf_counter())
    deb = [v.astype(np.int32) for v in av1_filters.deblock(parsed, rec)]
    t.append(time.perf_counter())
    cd = [v.astype(np.int32) for v in av1_filters.cdef(parsed, deb)]
    t.append(time.perf_counter())
    lr = [v.astype(np.int32) for v in av1_filters.loop_restore(parsed, deb, cd)]
    t.append(time.perf_counter())
    secs = dict(zip(("recon", "deblock", "cdef", "lr"), (b - a for a, b in zip(t, t[1:]))))
    return {"recon": rec, "deblock": deb, "cdef": cd, "lr": lr}, secs


def avif_phase(dev, label):
    """Phase 22: AVIF through the four kernels of ``csrc/av1.cu``
    (``data/av1_cuda.py``). Every AV1 item of every committed form of
    ``tests/fixtures/avif_forms/`` parsed once on the host and decoded
    through the four kernels, then read under each flag (film grain, the
    grid, the alpha and libavif's colour rule as torch ops) to the sha256
    cv2 gave (``forms.json``; no cv2 here); ``av1_cuda.decode`` itself on
    five forms; the refusals by name. Meanwhile a process pool runs the
    plain stages of every item, the two 1024x2048 scenes first (cv2's
    defaults, and speed 0 with loop restoration). While it finishes them:
    one read of each scene end to end, then, with every count set to 0 just
    before, ``multi_demo --images`` on both scenes and one
    ``DeviceAugIterator`` batch over ``YoloFormat(image_ext=".avif")`` into
    one ``train_step``; no plain version runs there. Then each kernel is
    held to its plain version bit for bit on every item, fed the plain
    version's input, and on the two scenes: host parse ms, each kernel's
    device us (torch.profiler, every launch of a call summed), launches,
    the wrapper's host us, the bound (``av1_work``: the frame's bytes once
    at 3.35 TB/s or its operations at 67 T/s, the larger) and the plain
    version's ms. Returns ({kernel: {path: launches}}, {scene: {kernel:
    timings}}, record)."""
    import hashlib
    import multiprocessing
    import os
    import tempfile

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import multi_demo
    from dspnet_torch.data import av1_cuda, av1_parse, avif, jpeg_cuda
    from dspnet_torch.data.device_pipeline import DeviceAugIterator, device_augment_batch
    from dspnet_torch.data.imdb import YoloFormat
    from dspnet_torch.data.iterator import SampleIndex
    from dspnet_torch.ops import matching_cuda, nms_cuda
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix

    net = "resnet-50_multi"
    forms_dir = ROOT / "tests" / "fixtures" / "avif_forms"
    meta = json.loads((forms_dir / "forms.json").read_text())["files"]
    flags = {"color": 1, "gray": 0, "unchanged": -1}
    launches = {"nms_keep_mask": {}, "bipartite_match": {}, **{k: {} for k in AV1_KERNELS}}
    record, secs = {}, {}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_avif_", dir=ROOT / "build"))

    def reset():
        nms_cuda.launches = matching_cuda.launches = 0
        jpeg_cuda.launches = jpeg_cuda.images = 0
        for d in (av1_cuda.launches, av1_cuda.plain_calls):
            for k in d:
                d[k] = 0

    def sha(t):
        return hashlib.sha256(np.ascontiguousarray(t.cpu().numpy()).tobytes()).hexdigest()

    workers = os.cpu_count() or 1
    pool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        # ---- 22a. every committed form under each flag, on the card; the plain stages over a pool
        t0 = time.perf_counter()
        equal, refused, items = 0, [], []
        plans = {}
        for name in sorted(meta):
            try:
                plans[name] = avif.plan((forms_dir / name).read_bytes())
            except avif.AvifError as e:
                check(all(r is None for r in meta[name]["cv2"].values()), f"{name}: refused ({e}) where cv2 reads it")
                refused.append(name)
                continue
            items += [(name, k) for k in range(len(plans[name].color) + len(plans[name].alpha))]
        big_staged, plain_secs, parse_ms = {}, {}, {}
        order = sorted(items, key=lambda it: not it[0].startswith("big_"))
        plain = pool.imap(_avif_plain, order)
        staged, frames_out = {}, {}
        for name, k in order:  # the card's path, while the pool runs the plain stages
            coded = (plans[name].color + plans[name].alpha)[k]
            reset()
            t1 = time.perf_counter()
            parsed = av1_parse.parse(coded.frame)
            parse_ms[(name, k)] = (time.perf_counter() - t1) * 1e3
            st = av1_cuda.stage(av1_cuda.pack(parsed), dev)
            rec = av1_cuda.recon(st)
            deb = av1_cuda.deblock(st, rec)
            cd = av1_cuda.cdef(st, deb)
            lr = av1_cuda.loop_restore(st, deb, cd)
            check(av1_cuda.launches["recon"] == len(st.packed.waves) and sum(av1_cuda.plain_calls.values()) == 0,
                  f"{name} item {k}: counts {av1_cuda.launches} {av1_cuda.plain_calls}")
            staged[(name, k)] = (st, rec)
            frames_out[(name, k)] = avif.finish(coded.frame, lr)
        for name in sorted(plans):
            plan, recs = plans[name], meta[name]["cv2"]
            n_color = len(plan.color)
            color = avif.assemble(plan, plan.color, [frames_out[(name, k)] for k in range(n_color)])
            alpha = None
            if plan.alpha and not plan.mono:
                alpha = avif.assemble(plan, plan.alpha, [frames_out[(name, n_color + k)]
                                                         for k in range(len(plan.alpha))])
            for key, flag in flags.items():
                rec = recs[key]
                a_ = alpha if (flag == -1 or plan.premultiplied) else None
                if rec is None:
                    try:
                        avif.to_output(plan, color, a_, flag)
                    except ValueError:
                        refused.append(f"{name}:{key}")
                        continue
                    check(False, f"{name} {key}: read on the card where cv2 returns None")
                out = avif.to_output(plan, color, a_, flag)
                check(out.device.type == "cuda" and (str(out.dtype).replace("torch.", ""), list(out.shape))
                      == (rec["dtype"], rec["shape"]) and sha(out) == rec["sha256"],
                      f"{name} {key}: the card's array is not cv2's")
                equal += 1
        for name in ("cv2_default.avif", "pil_alpha.avif", "made_grid.avif", "pil_grain6.avif", "cv2_d12.avif"):
            reset()
            got = av1_cuda.decode((forms_dir / name).read_bytes(), -1, dev)
            check(sha(got) == meta[name]["cv2"]["unchanged"]["sha256"] and sum(av1_cuda.plain_calls.values()) == 0,
                  f"{name}: av1_cuda.decode differs from cv2")
        secs["committed forms"] = time.perf_counter() - t0
        record["forms"] = {"files": len(meta), "items": len(items), "equal_cv2_on_card": equal,
                           "refused": refused}
        print(f"AVIF forms on the card: {len(meta)} files ({len(items)} AV1 items) x 3 flags, {equal} arrays equal "
              f"to cv2's sha256 through the four kernels, refused by name where cv2 returns None: {refused}; "
              f"{secs['committed forms']:.2f} s [{label}]", flush=True)

        # ---- 22b. while the pool finishes the scenes' plain stages: one read of each scene end to end, then
        # the main path: multi_demo, a loader batch and a train_step on .avif images
        read_ms = {}
        for name in AVIF_SCENES:
            reset()
            t1 = time.perf_counter()
            out = av1_cuda.decode((forms_dir / name).read_bytes(), 1, dev)
            read_ms[name] = (time.perf_counter() - t1) * 1e3
            check(tuple(out.shape) == (1024, 2048, 3) and sha(out) == meta[name]["cv2"]["color"]["sha256"]
                  and sum(av1_cuda.plain_calls.values()) == 0, f"{name} read differs from cv2's")
        src = create_model(net, (H, W), num_classes=NUM_CLASSES, device=dev,
                           generator=torch.Generator().manual_seed(22))
        model_dir = work / "model"
        CheckpointManager(checkpoint_prefix(str(model_dir), net, H)).save(
            0, MultiTaskSolver(src.model, src.anchors, device=dev).init_state())
        paths = [work / "scene_default.avif", work / "scene_s0.avif"]
        paths[0].write_bytes((forms_dir / "big_default.avif").read_bytes())
        paths[1].write_bytes((forms_dir / "big_s0.avif").read_bytes())
        demo_args = ["--network", net, "--data-shape", f"3,{H},{W}", "--model-dir", str(model_dir), "--epoch", "0",
                     "--dtype", "bfloat16", "--vis-thresh", "0.3", "--out-dir", str(work / "out"),
                     "--device", str(dev), "--images", ",".join(str(x) for x in paths)]
        reset()
        t1 = time.perf_counter()
        written = multi_demo.main(demo_args)
        torch.cuda.synchronize()
        secs["multi_demo"] = time.perf_counter() - t1
        got = {"nms": nms_cuda.launches, **{k: av1_cuda.launches[k] for k in AV1_KERNELS},
               "plain_versions": sum(av1_cuda.plain_calls.values()), "nvjpeg_images": jpeg_cuda.images}
        check(got["nms"] == 2 and got["plain_versions"] == 0 and got["nvjpeg_images"] == 0
              and all(got[k] >= 1 for k in ("recon", "deblock", "cdef", "lr")),
              f"multi_demo on .avif: counts {got}")
        check([Path(w).name for w in written] == [x.stem + "_out.jpg" for x in paths], f"written {written}")
        for k in AV1_KERNELS:
            launches[k]["avif_demo"] = av1_cuda.launches[k]
        launches["nms_keep_mask"]["avif_demo"] = got["nms"]
        record["demo"] = {"counts": got, "seconds": secs["multi_demo"]}
        print(f"multi_demo {net} {H}x{W} bf16 on the two 1024x2048 .avif scenes: {secs['multi_demo']:.2f} s; "
              f"counts {got} [{label}]", flush=True)

        B = 4
        solver = MultiTaskSolver(src.model, src.anchors, batch_size=B, compute_dtype="bfloat16", device=dev,
                                 seg_normalize="valid", learning_rate=5e-4)
        state = solver.init_state()
        classes = ["person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle"]
        rng = np.random.RandomState(220)
        root = work / "yolo"
        (root / "images").mkdir(parents=True)
        (root / "labels").mkdir()
        ids = []
        sources = ["cv2_default.avif", "cv2_q75.avif", "cv2_s5.avif", "pil_444.avif"]  # 96x128 each
        for i, src_name in enumerate(sources):
            iid = f"im{i}"
            ids.append(iid)
            (root / "images" / (iid + ".avif")).write_bytes((forms_dir / src_name).read_bytes())
            x, y = rng.uniform(0.1, 0.6, 2)
            (root / "labels" / (iid + ".txt")).write_text(f"{rng.randint(8)} {x:.6f} {y:.6f} 0.2 0.2\n")
        (root / "list.txt").write_text("\n".join(ids) + "\n")
        index = SampleIndex(YoloFormat(str(root / "list.txt"), str(root / "images"), str(root / "labels"),
                                       classes, image_ext=".avif").samples())
        reset()
        t1 = time.perf_counter()
        it = DeviceAugIterator(index, B, (H, W), device=dev, seed=22, enable_aug=False, shuffle=False)
        (batch, names), = list(it.epoch())
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        counts = {**{k: av1_cuda.launches[k] for k in AV1_KERNELS},
                  "plain_versions": sum(av1_cuda.plain_calls.values()), "nvjpeg_images": jpeg_cuda.images}
        check(counts["recon"] >= B and counts["plain_versions"] == 0 and counts["nvjpeg_images"] == 0,
              f".avif loader counts {counts}")
        loader_launches = {k: av1_cuda.launches[k] for k in AV1_KERNELS}
        # the per-image reads (av1_cuda.decode, held to cv2's sha256 in 22a) through the batch augmentation
        raw = torch.stack([av1_cuda.decode(Path(s_.image_path).read_bytes(), 1, dev) for s_ in index])
        labels = torch.from_numpy(np.stack([s_.label for s_ in index]).astype(np.float32))
        ref = device_augment_batch(raw, None, labels, torch.zeros(B, 6), it.lut, (H, W), enable_aug=False,
                                   mean_pixels=it.mean_pixels)
        check(torch.equal(batch["images"], ref["images"]), ".avif loader batch != the per-image reads")
        reset()
        state, m = solver.train_step(state, batch)
        loss = float(m["loss"])
        check(np.isfinite(loss), f".avif train_step loss {loss}")
        check(matching_cuda.launches == 1, f".avif train_step launched the matcher {matching_cuda.launches} times")
        for k in AV1_KERNELS:
            launches[k]["avif_loader"] = loader_launches[k]
        launches["bipartite_match"]["avif_train"] = matching_cuda.launches
        record["loader"] = {"images": names, "load_s": load_s, "loss": loss, "counts": counts}
        print(f"DeviceAugIterator b{B} over YoloFormat(image_ext='.avif') {H}x{W}: equal to the plain decodes "
              f"through device_augment_batch; {load_s:.3f} s; one train_step loss {loss:.6g}; counts {counts} "
              f"[{label}]", flush=True)
        del solver, state, src

        # ---- 22c. each kernel against its plain version on every item, fed the plain version's input
        t0 = time.perf_counter()
        max_err = {k: 0 for k in AV1_KERNELS}
        for (name, k), (ref, ps) in zip(order, plain):
            st, rec = staged.pop((name, k))
            up = lambda arrs: [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev) for a in arrs]
            rec_ref, deb_ref, cd_ref = up(ref["recon"]), up(ref["deblock"]), up(ref["cdef"])
            outs = {"recon": rec, "deblock": av1_cuda.deblock(st, rec_ref), "cdef": av1_cuda.cdef(st, deb_ref),
                    "lr": av1_cuda.loop_restore(st, deb_ref, cd_ref)}
            for stage_name, got in outs.items():
                want = up(ref[stage_name])
                err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
                max_err[stage_name] = max(max_err[stage_name], err)
                check(err == 0, f"{name} item {k}: {AV1_KERNELS[stage_name]} != its plain version "
                                f"(max abs err {err})")
            if name.startswith("big_"):
                plain_secs[name] = ps
                big_staged[name] = (st, rec_ref, deb_ref, cd_ref, ref)
        secs["kernels vs plain"] = time.perf_counter() - t0
        record["max_abs_err"] = max_err
        print(f"av1_recon, av1_deblock, av1_cdef and av1_lr == their plain versions bit for bit on {len(items)} AV1 "
              f"items of the committed forms, the two 1024x2048 scenes among them (max abs err {max_err}; plain "
              f"stages over {workers} processes); {secs['kernels vs plain']:.2f} s after the main path [{label}]",
              flush=True)

        # ---- 22d. the 1024x2048 scenes: host parse, each kernel's times
        timings, big = {}, {}
        for name in AVIF_SCENES:
            data = (forms_dir / name).read_bytes()
            st, rec_ref, deb_ref, cd_ref, ref = big_staged[name]
            packed = st.packed
            h = packed.parsed.frame.hdr
            t1 = time.perf_counter()
            av1_cuda.pack(packed.parsed)
            pack_ms = (time.perf_counter() - t1) * 1e3
            work_bytes, work_ops = av1_work(packed, ref)
            calls = {"recon": lambda: av1_cuda.recon(st), "deblock": lambda: av1_cuda.deblock(st, rec_ref),
                     "cdef": lambda: av1_cuda.cdef(st, deb_ref), "lr": lambda: av1_cuda.loop_restore(st, deb_ref, cd_ref)}
            per = {}
            for k, fn in calls.items():
                dev_us, per_call, how = j2k_device_us(fn, AV1_KERNELS[k], av1_cuda.launches, k, n=5)
                bound = bound_us(work_bytes[k], work_ops[k])
                per[k] = {"device_us": dev_us, "launches_per_call": per_call, "how": how,
                          "host_us": j2k_host_us(fn, n=5), "bound_us": bound[0], "bound_by": bound[1],
                          "plain_ms": plain_secs[name][k] * 1e3, "bytes": work_bytes[k], "ops": work_ops[k],
                          "max_abs_err": max_err[k]}
            big[name] = {"bytes": len(data), "parse_ms": parse_ms[(name, 0)], "pack_ms": pack_ms,
                         "transform_blocks": int(len(packed.txbs)), "coefficients": int(len(packed.coefs)),
                         "waves": len(packed.waves), "lr_type": list(h.lr_type), "rects": int(len(packed.rects)),
                         "end_to_end_ms": read_ms[name], "kernels": per}
            timings[name] = per
            print(f"1024x2048 {name} ({len(data)} B, {len(packed.txbs)} transform blocks, {len(packed.coefs)} "
                  f"coefficients, {len(packed.waves)} waves, restoration {list(h.lr_type)}): host parse "
                  f"{parse_ms[(name, 0)]:.3f} ms, pack {pack_ms:.3f} ms, one read end to end {read_ms[name]:.3f} ms "
                  f"(host clock with the stream's synchronize) [{label}]", flush=True)
            for k, v in per.items():
                print(f"  {AV1_KERNELS[k]}: device {v['device_us']:.3f} us/call ({v['launches_per_call']:g} launches, "
                      f"{v['how']}), host {v['host_us']:.3f} us/call (wrapper), bound {v['bound_us']:.4f} us "
                      f"({v['bound_by']}), plain {v['plain_ms']:.3f} ms (one process) [{label}]", flush=True)
        record["1024x2048"] = big
        del big_staged
    finally:
        pool.terminate()
        pool.join()
        shutil.rmtree(work, ignore_errors=True)
    record["seconds"] = secs
    print(json.dumps({"avif_phase": record}), flush=True)
    return launches, timings, record


def probe_codec_libraries():
    """ROADMAP Queue A items 20 and 24 and Queue C item 4: which of the
    Video Codec SDK's headers and libraries (NVDEC / NVENC), libjpeg /
    libpng, libzstd (which ``utils/zstd.py`` loads to read the JAX
    package's checkpoints), nvJPEG2000 and the JPEG 2000 / AV1 libraries
    (OpenJPEG, dav1d, libaom) this machine has, under the toolkit's and the system's include directories
    and on the loader's path. Reports only; never fails the run."""
    import fnmatch
    import os

    try:
        cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
        inc = [cuda / "include", *cuda.glob("targets/*/include"), Path("/usr/include"),
               Path("/usr/include/x86_64-linux-gnu"), Path("/usr/local/include")]
        libdirs = [Path(p) for p in os.environ.get("LD_LIBRARY_PATH", "").split(":") if p]
        libdirs += [cuda / "lib64", *cuda.glob("targets/*/lib"), Path("/usr/lib/x86_64-linux-gnu"),
                    Path("/lib/x86_64-linux-gnu"), Path("/usr/lib64"), Path("/usr/lib"), Path("/usr/local/lib")]
        ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True, timeout=30).stdout
        cached = [line.split("=>")[-1].strip() for line in ldconfig.splitlines() if "=>" in line]
        found = {}
        for name in ("nvcuvid.h", "cuviddec.h", "nvEncodeAPI.h", "jpeglib.h", "png.h", "nvjpeg2k.h"):
            found[name] = sorted({str(d / name) for d in inc if (d / name).exists()})
        for pattern in ("libnvcuvid.so*", "libnvidia-encode.so*", "libjpeg.so*", "libpng*.so*", "libzstd.so*",
                        "libnvjpeg2k.so*", "libopenjp2.so*", "libdav1d.so*", "libaom.so*"):
            hits = {str(p) for d in libdirs if d.is_dir() for p in d.glob(pattern)}
            hits |= {p for p in cached if fnmatch.fnmatch(os.path.basename(p), pattern)}
            found[pattern] = sorted(hits)
        print("probe (ROADMAP Queue A items 20, 24; Queue C item 4): " + "; ".join(
            f"{k} " + (f"yes ({', '.join(v[:3])})" if v else "no") for k, v in found.items()), flush=True)
        return found
    except Exception as e:  # the probe only reports
        print(f"probe (ROADMAP Queue A items 20, 24) failed: {e!r}", flush=True)
        return None


#: the stages of csrc/h264.cu (h264_cuda.KERNELS names each one's kernels)
H264_STAGES = ("h264_parse", "h264_recon", "h264_deblock")
#: what each kernel stands in for in FFmpeg behind cv2.VideoCapture
H264_REPLACES = {
    "h264_parse_kernel": "h264_cabac.c / h264_cavlc.c macroblock layer (slice data: CABAC and CAVLC)",
    "h264_mv_kernel": "h264_mvpred.h / h264_direct.c (motion vector prediction, P_Skip, B direct)",
    "h264_inter_kernel": "h264_mb.c inter half, h264qpel, h264chroma, h264idct (residual, motion compensation, "
                         "weights)",
    "h264_intra_kernel": "h264_mb.c intra half, h264pred (Intra 4x4 / 8x8 / 16x16, chroma, I_PCM)",
    "h264_bs_kernel": "h264_loopfilter.c bS (check_mv, the edge rules)",
    "h264_filter_kernel": "h264_loopfilter.c alpha / beta / tC0 filters"}
#: the small forms whose every picture phase 23 also holds stage by stage to
#: the plain versions (the plain Python decoder takes about 0.2 s a picture
#: at 176x144): CAVLC and CABAC, P and B, direct both ways, weights, 8x8,
#: slices, PCM, long-term references
H264_STAGEWISE = ("cavlc_intra.mp4", "cavlc_p_partitions.mp4", "cavlc_longterm_mmco.mp4", "cabac_ipbb_temporal.mp4",
                  "cabac_wp_explicit.mp4", "cabac_wp_implicit.mp4", "high_8x8_cabac.mp4", "cabac_slices_pb.mp4")


def _h264_syntax_bytes(table, levels) -> int:
    """The bytes of the macroblock layer's syntax, packed, for a parsed
    picture's (table, levels) rows (:func:`_h264_syntax_parts` summed)."""
    return sum(_h264_syntax_parts(table, levels).values())


def _h264_syntax_parts(table, levels) -> dict:
    """The bytes of the macroblock layer's syntax, packed, for a parsed
    picture's (table, levels) rows, by part: "mb", 4 B a macroblock (type,
    partitions and lists, CBP, QP, the transform flag, the chroma mode) and
    2 B of sub-macroblock types (8x8 partitions); "intra", 8 B of intra 4x4
    / 8x8 modes and 384 B of I_PCM samples; "motion", 1 B a distinct
    reference index and 4 B a distinct nonzero motion vector difference per
    macroblock and list; "levels", 2 B a nonzero level; no dense slots, no
    zero padding."""
    from dspnet_torch.data import h264_parse as HP

    table, levels = np.asarray(table, np.int64), np.asarray(levels)
    typ = table[:, HP.F_TYPE]
    inter = typ == HP.T_INTER
    pcm = typ == HP.T_PCM
    parts = {"mb": 4 * len(table) + 2 * int((inter & (table[:, HP.F_PART] == HP.PART_8x8)).sum()),
             "intra": 8 * int(np.isin(typ, (HP.T_I4, HP.T_I8)).sum()) + 384 * int(pcm.sum())}
    n = 0
    for lx in range(2):
        refs = (table[inter, HP.F_REF0 + lx][:, None] >> (8 * np.arange(4))) & 0xFF
        refs = np.where(refs == 0xFF, -1, refs)
        n += sum(int(((refs[:, k] >= 0) & (refs[:, k, None] != refs[:, :k]).all(1)).sum()) for k in range(4))
        mvd = table[inter, HP.F_MVD + 32 * lx:HP.F_MVD + 32 * lx + 32].reshape(-1, 16, 2)
        key = np.sort((mvd[..., 0] + (1 << 15)) * (1 << 17) + mvd[..., 1] + (1 << 15), axis=1)
        zero = (1 << 15) * (1 << 17) + (1 << 15)
        distinct = np.concatenate([np.ones((len(key), 1), bool), key[:, 1:] != key[:, :-1]], 1) & (key != zero)
        n += 4 * int(distinct.sum())
    parts["motion"] = n
    parts["levels"] = 2 * int((levels[~pcm] != 0).sum())
    return parts


def h264_work(jobs, tables, pic):
    """What the function of each H.264 kernel must move and do for the data
    it ran on, counted from that data: ({kernel: bytes}, {kernel: integer
    operations}). ``jobs`` and ``tables`` are a parse launch's slices and
    its (table, levels) per picture; ``pic`` holds the timed picture's
    (numpy) ``table``, ``levels``, ``slices``, ``mb`` (width, height),
    motion field ``mv`` / ``ref`` / ``ref_id``, unfiltered planes ``pre``
    and filtered planes ``post``.

    parse: each slice's coded bytes in, the syntax it decodes out
      (:func:`_h264_syntax_bytes`); about 16 operations a coded bit (a
      CABAC bin or a VLC step).
    recon: the picture's syntax in; from each reference picture the union
      of the windows its blocks read (a 4x4 luma block's 4x4, 9 wide or
      high where its vector is fractional that way; chroma 2x2, 3x3 where
      fractional), only the lists the blocks use; the planes out (1 B a
      sample) and the motion field (4 B of vector and 1 B of reference a
      4x4 block and list in use); about 40 operations a predicted luma
      sample at a fractional position and 2 at a whole one, 12 / 2 a chroma
      sample, 4 an intra sample, 10 a sample of a block with coefficients.
    deblock: the samples within the taps of the edges it filters (bS > 0:
      luma p3..q3 at bS 4, p2..q2 else; chroma p1..q1), 5 B of fields a
      macroblock and the motion field of the lists in use in; the samples
      it changes out; about 20 operations a filtered luma line, 12 a chroma
      one, 10 a bS.

    Each stage's count is also split among its kernels (keys the kernels'
    names; what one kernel hands the next is the stage's own and counted
    nowhere): h264_mv_kernel the macroblock and motion syntax in, the motion
    field out, about 30 operations a 4x4 block and list; h264_inter_kernel
    the levels and the reference windows in, the inter macroblocks' samples
    out, the prediction and residual operations; h264_intra_kernel the
    intra modes and I_PCM samples in, the intra macroblocks' samples out,
    their operations; h264_bs_kernel the fields and the motion field in, the
    bS operations; h264_filter_kernel the taps in and the changed samples
    out, the filter's operations."""
    from dspnet_torch.data import h264_filters
    from dspnet_torch.data import h264_parse as HP

    nbytes, ops = {}, {}
    coded = sum(len(j.rbsp) for j, _ in jobs)
    out = 0
    for k, (t, lv) in enumerate(tables):
        m = next(s.mb_width * s.mb_height for j, s in jobs if j.picture == k)
        out += _h264_syntax_bytes(t[:m], lv[:m])
    nbytes["h264_parse"] = nbytes["h264_parse_kernel"] = coded + out
    ops["h264_parse"] = ops["h264_parse_kernel"] = 16 * 8 * coded

    table, levels = np.asarray(pic["table"], np.int64), np.asarray(pic["levels"])
    mv, ref, ref_id = (np.asarray(pic[k], np.int64) for k in ("mv", "ref", "ref_id"))
    Y = pic["pre"][0]
    H, W = Y.shape
    typ = table[:, HP.F_TYPE]
    used = ref >= 0  # (2, H4, W4): the lists each 4x4 block predicts from
    by, bx = np.nonzero(np.ones(ref.shape[1:], bool))
    reads = 0
    luma_ops = chroma_ops = 0
    for rid in np.unique(ref_id[used]):
        for c, (ph, pw, unit, span, taps) in enumerate(((H, W, 4, 4, 5), (H // 2, W // 2, 8, 2, 1),
                                                         (H // 2, W // 2, 8, 2, 1))):
            boxes = [[], [], [], []]
            for lx in range(2):
                on = (ref_id[lx] == rid).ravel()
                mx, my = mv[lx, ..., 0].ravel()[on], mv[lx, ..., 1].ravel()[on]
                x0, y0 = bx[on] * span + (mx >> (2 if c == 0 else 3)), by[on] * span + (my >> (2 if c == 0 else 3))
                fx, fy = (mx & (unit - 1)) != 0, (my & (unit - 1)) != 0
                lead = 2 if c == 0 else 0
                boxes[0].append(y0 - lead * fy)
                boxes[1].append(y0 + span + taps * fy - lead * fy)
                boxes[2].append(x0 - lead * fx)
                boxes[3].append(x0 + span + taps * fx - lead * fx)
                frac = fx | fy
                if c == 0:
                    luma_ops += int(16 * (40 * frac.sum() + 2 * (~frac).sum()))
                else:
                    chroma_ops += int(4 * (12 * frac.sum() + 2 * (~frac).sum()))
            reads += _union_count((ph, pw), *(np.concatenate(v) for v in boxes))
    intra = typ <= HP.T_PCM
    nz_blocks = sum(int(((table[:, HP.F_NZ] >> b) & 1).sum()) for b in range(16))
    chroma_res = int(((table[:, HP.F_CBP] >> 4) != 0).sum())
    n_list = int(used.sum())
    samples = int(sum(p.size for p in pic["pre"]))
    syntax = _h264_syntax_parts(table, levels)
    intra_samples = samples * int(intra.sum()) // len(table)
    nbytes["h264_mv_kernel"] = syntax["mb"] + syntax["motion"] + 5 * n_list
    nbytes["h264_inter_kernel"] = syntax["levels"] + reads + samples - intra_samples
    nbytes["h264_intra_kernel"] = syntax["intra"] + intra_samples
    ops["h264_mv_kernel"] = 30 * n_list
    ops["h264_inter_kernel"] = luma_ops + chroma_ops + 10 * (16 * nz_blocks + 128 * chroma_res)
    ops["h264_intra_kernel"] = 4 * 384 * int(intra.sum())
    for d in (nbytes, ops):
        d["h264_recon"] = d["h264_mv_kernel"] + d["h264_inter_kernel"] + d["h264_intra_kernel"]

    mbw, mbh = pic["mb"]
    bs = h264_filters.strengths(table, mv, ref_id, pic["slices"], mbw, mbh)  # (n, dir, edge, segment)
    n_i, d_i, e_i, k_i = np.nonzero(bs)
    strong = bs[n_i, d_i, e_i, k_i] == 4
    mx, my = n_i % mbw, n_i // mbw
    reads = 0
    lines = {"luma": 0, "chroma": 0}
    for c, plane in enumerate(pic["pre"]):
        size, step, seg = (16, 4, 4) if c == 0 else (8, 2, 2)
        keep = np.ones(len(n_i), bool) if c == 0 else (e_i % 2 == 0)
        half = np.where(strong, 4, 3) if c == 0 else np.full(len(n_i), 2)
        d, e, k, x, y, h = d_i[keep], e_i[keep], k_i[keep], mx[keep], my[keep], half[keep]
        edge_x = size * x + step * e
        edge_y = size * y + step * e
        row0 = np.where(d == 0, size * y + seg * k, edge_y - h)
        row1 = np.where(d == 0, size * y + seg * k + seg, edge_y + h)
        col0 = np.where(d == 0, edge_x - h, size * x + seg * k)
        col1 = np.where(d == 0, edge_x + h, size * x + seg * k + seg)
        reads += _union_count(plane.shape, row0, row1, col0, col1)
        lines["luma" if c == 0 else "chroma"] += seg * int(keep.sum())
    changed = sum(int((np.asarray(a) != np.asarray(b)).sum()) for a, b in zip(pic["post"], pic["pre"]))
    inter_lists = int(used[:, np.repeat(np.repeat(~intra.reshape(mbh, mbw), 4, 0), 4, 1)].sum())
    nbytes["h264_bs_kernel"] = 5 * len(table) + 5 * inter_lists
    nbytes["h264_filter_kernel"] = reads + changed
    ops["h264_bs_kernel"] = 10 * int(bs.size)
    ops["h264_filter_kernel"] = 20 * lines["luma"] + 12 * lines["chroma"]
    for d in (nbytes, ops):
        d["h264_deblock"] = d["h264_bs_kernel"] + d["h264_filter_kernel"]
    return nbytes, ops


def _h264_largest(a, b) -> int:
    return int((a.cpu().to(torch.int64) - b.cpu().to(torch.int64)).abs().max()) if a.numel() else 0


def h264_launch_us(launches, prepare=None, n=3):
    """Device us of each of a stage's launches [(kernel, launch)]: CUDA
    events around each launch, the mean of ``n`` rounds after one to warm
    up; ``prepare`` runs before each round, outside the events -> {kernel:
    us}."""
    out = {name: 0.0 for name, _ in launches}
    for r in range(n + 1):
        if prepare is not None:
            prepare()
        marks = []
        for name, launch in launches:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            marks.append((name, start, end))
        torch.cuda.synchronize()
        if r:
            for name, start, end in marks:
                out[name] += start.elapsed_time(end) * 1e3 / n
    return out


def h264_device_us(fn, names, n=5):
    """Device us per call of ``fn`` from torch.profiler, every launch of the
    kernels ``names`` summed, and how: (us, "torch.profiler") when it
    recorded each kernel ``n`` times, else (None, what it recorded)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evts = {name: [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
            for name in names}
    if all(len(v) == n for v in evts.values()):
        return sum(e.device_time for v in evts.values() for e in v) / n, "torch.profiler"
    return None, "the profiler recorded " + ", ".join(f"{len(v)} of {n} {k}" for k, v in evts.items())


def h264_parse_vs_old(err, old_parse, jobs, n, tables, where):
    """The parse kernel and the kernel before its redesign (``old_parse``,
    :func:`h264_parse_baseline`) on a batch: tables, levels, scratch and
    status equal, and equal to what the wrapper returned (``tables``); the
    largest difference kept in ``err``."""
    from dspnet_torch.data import h264_cuda

    new_out, new_l = h264_cuda.parse_launches(jobs, n, tables[0][0].device)
    old_out, old_l = old_parse(jobs, n)
    new_l[0][1]()
    old_l[0][1]()
    err["h264_parse"] = max(err["h264_parse"], *(_h264_largest(a, b) for a, b in zip(new_out, old_out)))
    check(all(torch.equal(a, b) for a, b in zip(new_out, old_out)) and
          all(torch.equal(t, new_out[0][k]) and torch.equal(lv, new_out[1][k]) for k, (t, lv) in enumerate(tables)),
          f"h264_parse_kernel != the kernel before its redesign in {where}")


def h264_stagewise(dev, err, samples, config, fourcc, limit=None, picks=(), old_parse=None, parse_limit=None):
    """The samples through ``h264_cuda.Decoder.decode`` on ``dev`` with its
    stages wrapped: each stage held to its plain version on the same inputs
    (the plain parse of the batch's slices, the plain reconstruction from
    the card's tables and references, the plain filter on the card's
    unfiltered planes) on the first ``limit`` pictures (every one when
    None; the parse on its first ``parse_limit`` when given), the largest
    difference of each kept in ``err``; the parse kernel
    also held to the kernel before its redesign (``old_parse``,
    :func:`h264_parse_baseline`) on every batch: tables, levels, scratch and
    status; for each picture of ``picks`` (in decode order) its inputs and
    outputs kept under its index, and the first one's parse launch ->
    (pictures compared, plain seconds by stage, what was kept)."""
    from dspnet_torch.data import h264_cuda

    dec = h264_cuda.Decoder(dev, config, fourcc)
    plain = dict.fromkeys(H264_STAGES, 0.0)
    seen = {"parsed": 0, "done": 0}
    host, kept = {}, {}

    def compared(k):
        return limit is None or k < limit

    def parse(jobs, n, device):
        tables = h264_cuda.parse(jobs, n, device)
        if old_parse is not None:
            h264_parse_vs_old(err, old_parse, jobs, n, tables, f"the batch from picture {seen['parsed']}")
        plimit = limit if parse_limit is None else parse_limit
        few = n if plimit is None else max(0, min(plimit - seen["parsed"], n))
        if few:
            t0 = time.perf_counter()
            ref = h264_cuda.parse_ref([j for j in jobs if j[0].picture < few], few, torch.device("cpu"))
            plain["h264_parse"] += time.perf_counter() - t0
            for (t, lv), (rt, rlv) in zip(tables, ref):
                n_mb = rt.shape[0]
                err["h264_parse"] = max(err["h264_parse"], _h264_largest(t[:n_mb], rt),
                                        _h264_largest(lv[:n_mb], rlv))
                check(torch.equal(t[:n_mb].cpu(), rt) and torch.equal(lv[:n_mb].cpu(), rlv),
                      f"h264_parse_kernel != plain in the batch from picture {seen['parsed']}")
        if picks and seen["parsed"] <= picks[0] < seen["parsed"] + n:
            kept["parse"] = (jobs, n, device)
            kept["tables"] = tables
        seen["parsed"] += n
        return tables

    def recon(table, levels, slices, sps, refs, col, poc):
        y, u, v, mf = h264_cuda.recon(table, levels, slices, sps, refs, col, poc)
        k = seen["done"]
        if compared(k):
            t0 = time.perf_counter()
            ry, ru, rv, rmf = h264_cuda.recon_ref(table.cpu(), levels.cpu(), slices, sps, refs, col, poc)
            plain["h264_recon"] += time.perf_counter() - t0
            pairs = [(y, ry), (u, ru), (v, rv), (mf.mv, rmf.mv), (mf.ref, rmf.ref), (mf.ref_id, rmf.ref_id)]
            err["h264_recon"] = max(err["h264_recon"], *(_h264_largest(a, b) for a, b in pairs))
            check(all(torch.equal(a.cpu(), b.cpu()) for a, b in pairs),
                  f"the reconstruction kernels != plain on picture {k}")
            host["planes"] = (y.cpu().clone(), u.cpu().clone(), v.cpu().clone())
            host["mf"] = rmf
        if k in picks:
            kept[k] = {"recon": (table, levels, slices, sps, refs, col, poc), "pre": (y.clone(), u.clone(), v.clone()),
                       "mf": mf}
        return y, u, v, mf

    def deblock(y, u, v, table, mf, slices, sps):
        h264_cuda.deblock(y, u, v, table, mf, slices, sps)
        k = seen["done"]
        if compared(k):
            hy, hu, hv = host.pop("planes")
            t0 = time.perf_counter()
            h264_cuda.deblock_ref(hy, hu, hv, table.cpu(), host.pop("mf"), slices, sps)
            plain["h264_deblock"] += time.perf_counter() - t0
            pairs = ((y, hy), (u, hu), (v, hv))
            err["h264_deblock"] = max(err["h264_deblock"], *(_h264_largest(a, b) for a, b in pairs))
            check(torch.equal(y.cpu(), hy) and torch.equal(u.cpu(), hu) and torch.equal(v.cpu(), hv),
                  f"the deblocking kernels != plain on picture {k}")
        if k in picks:
            kept[k]["post"] = (y.clone(), u.clone(), v.clone())
        seen["done"] += 1

    dec.stages.update(parse=parse, recon=recon, deblock=deblock)
    for i in range(0, len(samples), 8):
        dec.decode(samples[i:i + 8])
    done = seen["done"] if limit is None else min(limit, seen["done"])
    return done, plain, kept


def h264_clip_timings(dev, err, kept, jobs, plain, pics_checked, label):
    """Phase 23b on what ``h264_stagewise`` kept of a clip's first batch
    (picture 0 an I picture, 1 a P picture): per picture the stages'
    bounds (``h264_work``), the kernels before their redesign and the
    current ones on the same inputs, equal, and timed in turns (old, new,
    new, old; CUDA events around each launch), the stages' torch.profiler
    time on the P picture where it records every launch, host us and plain
    ms; the parse launch timed -> {"P": {stage: ...}, "I": ..., "parse": ...}."""
    from dspnet_torch.data import h264_cuda

    old_recon, old_deblock = h264_baseline(dev)
    # the parse before and after its redesign in turns (old, new, new, old; CUDA events around each launch), and
    # the chain: bins of the longest slice of the batch, and that slice's macroblocks
    pjobs, pn, _ = kept["parse"]
    steps = torch.zeros(len(pjobs), dtype=torch.int32, device=dev)
    (ptab, _, _, _), new_l = h264_cuda.parse_launches(pjobs, pn, dev, steps=steps)
    new_l[0][1]()
    parse_new, parse_old = parse_turns(new_l, h264_parse_baseline(dev)(pjobs, pn)[1])
    longest = int(steps.argmax())
    job = pjobs[longest][0]
    from dspnet_torch.data import h264_parse as HP

    slice_mbs = int((ptab[job.picture, :, HP.F_SLICE] == job.index).sum())
    chain = {"chain_steps": int(steps.max()), "slice_mbs": slice_mbs, "new_us_turns": parse_new,
             "old_us_turns": parse_old, "ns_per_step": parse_new[0] * 1e3 / int(steps.max()),
             "us_per_mb": parse_new[0] / slice_mbs, "old_ns_per_step": parse_old[0] * 1e3 / int(steps.max()),
             "steps_by_slice": steps.cpu().tolist()}
    parse_us, parse_how = parse_new[0], "CUDA events around each launch"
    per = {}
    for tag, k in (("P", 1), ("I", 0)):
        table, levels, slices, sps = kept[k]["recon"][:4]
        check(all(x.slice_type == (0 if tag == "P" else 2) for x in slices),
              f"picture {k} of the clip in decode order is not an {tag} picture")
        n_mb = sps.mb_width * sps.mb_height
        mf = kept[k]["mf"]
        nb, ops = h264_work(jobs, [(t.cpu().numpy(), lv.cpu().numpy()) for t, lv in kept["tables"]],
                            {"table": table[:n_mb].cpu().numpy(), "levels": levels[:n_mb].cpu().numpy(),
                             "slices": slices, "mb": (sps.mb_width, sps.mb_height), "mv": mf.mv.cpu().numpy(),
                             "ref": mf.ref.cpu().numpy(), "ref_id": mf.ref_id.cpu().numpy(),
                             "pre": [p.cpu().numpy() for p in kept[k]["pre"]],
                             "post": [p.cpu().numpy() for p in kept[k]["post"]]})
        # each stage's launches, the kernels before their redesign and the current ones, on the same inputs
        new_out, new_recon = h264_cuda.recon_launches(*kept[k]["recon"])
        old_out, old_recon_l = old_recon(*kept[k]["recon"])
        pre = kept[k]["pre"]
        planes = {"new": [p.clone() for p in pre], "old": [p.clone() for p in pre]}
        new_deblock = h264_cuda.deblock_launches(*planes["new"], table, mf, slices, sps)
        old_deblock_l = old_deblock(*planes["old"], table, mf, slices, sps)
        stage_launches = {("h264_recon", "new"): new_recon, ("h264_recon", "old"): old_recon_l,
                          ("h264_deblock", "new"): new_deblock, ("h264_deblock", "old"): old_deblock_l}
        turns = {key: [] for key in stage_launches}
        for which in ("old", "new", "new", "old"):
            for stage in ("h264_recon", "h264_deblock"):
                prepare = None
                if stage == "h264_deblock":
                    prepare = (lambda w=which: [d.copy_(x) for d, x in zip(planes[w], pre)])
                turns[(stage, which)].append(h264_launch_us(stage_launches[(stage, which)], prepare))
        # old == new: planes and motion field out of the reconstruction, planes out of the filter
        pairs = list(zip(new_out[:3], old_out[:3])) + [(getattr(new_out[3], f), getattr(old_out[3], f))
                                                        for f in ("mv", "ref", "ref_id")]
        pairs += list(zip(planes["new"], planes["old"])) + list(zip(planes["new"], kept[k]["post"]))
        check(all(torch.equal(x, y) for x, y in pairs), f"the {tag} picture: the kernels before and after "
              f"their redesign disagree")
        rec = per.setdefault(tag, {})
        for stage in ("h264_recon", "h264_deblock"):
            kernels = list(h264_cuda.KERNELS[stage])
            call = {"h264_recon": lambda: h264_cuda.recon(*kept[k]["recon"]),
                    "h264_deblock": lambda: h264_cuda.deblock(*(p.clone() for p in pre), table, mf, slices,
                                                              sps)}[stage]
            # torch.profiler on the P picture only (phase 23's time)
            prof_us, how = h264_device_us(call, kernels, n=5) if tag == "P" else (None, "events only")
            new_us = [sum(t.values()) for t in turns[(stage, "new")]]
            old_us = [sum(t.values()) for t in turns[(stage, "old")]]
            bound = bound_us(nb[stage], ops[stage])
            rec[stage] = {"device_us": prof_us if prof_us is not None else new_us[0], "how": how,
                          "new_us_turns": new_us, "old_us_turns": old_us,
                          "kernels": {}, "host_us": j2k_host_us(call, n=5), "max_abs_err": err[stage],
                          "bound_us": bound[0], "bound_by": bound[1], "bytes": nb[stage], "ops": ops[stage],
                          "plain_ms": plain[stage] * 1e3 / pics_checked}
            for name in kernels:
                kb = bound_us(nb[name], ops[name])
                rec[stage]["kernels"][name] = {"device_us": [t[name] for t in turns[(stage, "new")]],
                                               "bound_us": kb[0], "bound_by": kb[1], "bytes": nb[name],
                                               "ops": ops[name]}
            print(f"  {stage} on the {tag} picture: device us old {old_us[0]:.1f} [{old_us[1]:.1f}] -> new "
                  f"{new_us[0]:.1f} [{new_us[1]:.1f}] (CUDA events around each launch, turns old, new, new, "
                  f"old; the stage's kernels summed; torch.profiler: "
                  f"{'%.1f' % prof_us if prof_us is not None else how}); "
                  + ", ".join(f"{n_} {v['device_us'][0]:.1f} [{v['device_us'][1]:.1f}] us, bound "
                              f"{v['bound_us']:.4f} us ({v['bound_by']})"
                              for n_, v in rec[stage]["kernels"].items())
                  + f"; stage bound {bound[0]:.4f} us ({bound[1]}); host {rec[stage]['host_us']:.1f} us "
                  f"(wrapper); plain {rec[stage]['plain_ms']:.1f} ms (a picture, the mean of the first two) "
                  f"[{label}]", flush=True)
        if tag == "P":
            pb = bound_us(nb["h264_parse"], ops["h264_parse"])
            per["parse"] = {"device_us": parse_us, "how": parse_how, "max_abs_err": err["h264_parse"],
                            "host_us": j2k_host_us(lambda: h264_cuda.parse(*kept["parse"]), n=2),
                            "bound_us": pb[0], "bound_by": pb[1], "bytes": nb["h264_parse"],
                            "ops": ops["h264_parse"], "plain_ms": plain["h264_parse"] * 1e3, **chain}  # one picture
        del new_out, old_out, planes, stage_launches, new_recon, old_recon_l, new_deblock, old_deblock_l
    print(f"  h264_parse_kernel: device {per['parse']['device_us']:.3f} us/call ({parse_how}, {len(jobs)} slices "
          f"of 8 pictures a launch), host {per['parse']['host_us']:.3f} us/call (wrapper), bound "
          f"{per['parse']['bound_us']:.4f} us ({per['parse']['bound_by']}), plain {per['parse']['plain_ms']:.3f} "
          f"ms (a picture) [{label}]", flush=True)
    print(f"  h264_parse_kernel before -> after its redesign, in turns old, new, new, old (CUDA events around each "
          f"launch): old {parse_old[0]:.1f} [{parse_old[1]:.1f}] us -> new {parse_new[0]:.1f} [{parse_new[1]:.1f}] us "
          f"({parse_old[0] / parse_new[0]:.2f}x), equal on every batch (tables, levels, scratch, status); the longest "
          f"slice's chain {chain['chain_steps']} bins over {slice_mbs} macroblocks: new {chain['ns_per_step']:.1f} ns "
          f"a bin, {chain['us_per_mb']:.3f} us a macroblock; old {chain['old_ns_per_step']:.1f} ns a bin [{label}]",
          flush=True)
    return per


def h264_kernel_entry(times, stage, name):
    """A kernel's numbers for the ``kernels`` line from phase 23's record:
    its device us on the 1024x2048 P picture (the parse: the batch of 8
    pictures) and its bound there, its stage's largest difference from the
    plain version, the stage's plain ms and host us (a kernel of a stage has
    no plain version of its own: the stage's is the plain version of its
    kernels together), the stage's old (before the redesign) and new device
    us, and the I picture's."""
    if stage == "h264_parse":
        t = times["parse"]
        return {"max_abs_err": float(t["max_abs_err"]), "ms": t["device_us"] / 1e3, "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"], "library_ms": None,
                "at": "8 pictures of 1024x2048 (32 slices) in one launch", "host_us": t["host_us"], "how": t["how"],
                **{k: t[k] for k in ("new_us_turns", "old_us_turns", "chain_steps", "slice_mbs", "ns_per_step",
                                     "us_per_mb", "old_ns_per_step")}}
    t, i = times["P"][stage], times["I"][stage]
    k = t["kernels"][name]
    return {"max_abs_err": float(t["max_abs_err"]), "ms": k["device_us"][0] / 1e3, "plain_ms": t["plain_ms"],
            "bound_ms": k["bound_us"] / 1e3, "bound_by": k["bound_by"], "library_ms": None,
            "at": "one 1024x2048 P picture", "how": "CUDA events around each launch",
            "stage": {"name": stage, "host_us": t["host_us"], "device_us": t["device_us"], "how": t["how"],
                      "new_us_turns": t["new_us_turns"], "old_us_turns": t["old_us_turns"],
                      "bound_us": t["bound_us"], "bound_by": t["bound_by"], "plain_is": "the stage's"},
            "I_picture": {"device_us": i["kernels"][name]["device_us"], "bound_us": i["kernels"][name]["bound_us"],
                          "stage_old_us_turns": i["old_us_turns"], "stage_new_us_turns": i["new_us_turns"]}}


def h264_phase(dev, label):
    """Phase 23: H.264 through the six kernels of ``csrc/h264.cu``
    (``data/h264_cuda.py``). Every committed form of
    ``tests/fixtures/h264_forms/`` decoded on the card against cv2's sha256
    per frame (``forms.json``; no cv2 here: count, order and pixels), the
    refusals by name; each stage against its plain version on the same
    inputs (every picture of the small forms, the first two of the
    1024x2048 clip, the parse on its first); the parse kernel against the one
    before its redesign (``baselines/h264_parse_per_thread.cu``) on every
    batch of every form, timed in turns with its longest slice's bins; on
    the clip's I and P pictures the reconstruction and deblocking kernels
    before their redesign (``baselines/h264_wave_per_thread.cu``) against
    the current ones and both timed in turns beside the bounds;
    ``multi_demo --images``
    on the 1024x2048 clip (High profile CABAC, I P B B, 13 frames) at
    resnet-50_multi 512x1024 bf16 with each kernel's launches counted and
    each stage's ms per frame. Returns ({kernel: {path: launches}}, {"P" /
    "I": {stage: times, bounds, the largest difference from its plain
    version, each kernel's}, "parse": ...}, record)."""
    import hashlib
    import tempfile

    from dspnet_torch.api import create_model
    from dspnet_torch.cli import multi_demo
    from dspnet_torch.data import avi, h264_cuda, jpeg_cuda, mp4, mpeg4, mpeg4_cuda
    from dspnet_torch.data.device_pipeline import resize_linear
    from dspnet_torch.detect import video
    from dspnet_torch.detect.pipeline import ServingPipeline
    from dspnet_torch.ops import nms_cuda
    from dspnet_torch.train.solver import MultiTaskSolver
    from dspnet_torch.utils import draw
    from dspnet_torch.utils.checkpoint import CheckpointManager, checkpoint_prefix

    net, thresh = "resnet-50_multi", 0.3
    fixture = ROOT / "tests" / "fixtures" / "h264_forms"
    meta = json.loads((fixture / "forms.json").read_text())["forms"]
    launches = {"nms_keep_mask": {}, **{k: {} for k in h264_cuda.kernel_launches}, "yuv420_to_bgr": {}}
    record, secs = {}, {}
    err = dict.fromkeys(H264_STAGES, 0)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_h264_", dir=ROOT / "build"))

    def reset():
        for d in (h264_cuda.launches, h264_cuda.kernel_launches, h264_cuda.plain_calls, mpeg4_cuda.launches,
                  mpeg4_cuda.plain_calls):
            d.update(dict.fromkeys(d, 0))
        nms_cuda.launches = jpeg_cuda.images = mpeg4.encodes = 0

    def sha(t):
        return hashlib.sha256(np.ascontiguousarray(t.cpu().numpy()).tobytes()).hexdigest()

    def decode_all(dec, samples):
        frames = []
        for i in range(0, len(samples), 8):
            frames += dec.decode(samples[i:i + 8])
        return frames + dec.flush()

    old_parse = h264_parse_baseline(dev)
    try:
        # ---- 23a. the committed forms: cv2's sha256, kernels == plain, refusals
        t0 = time.perf_counter()
        n_forms = n_frames = n_pics = 0
        for name, m in sorted(meta.items()):
            if "refused" in m:
                reset()
                try:
                    with avi.open_video(fixture / name) as reader:
                        samples, stream = list(reader), reader.stream
                    decode_all(h264_cuda.Decoder(dev, stream.extradata, stream.fourcc), samples)
                    check(False, f"{name}: decoded, expected a refusal naming {m['refused']!r}")
                except avi.VideoError as e:  # h264_nal.H264Error is one
                    check(m["refused"] in str(e), f"{name}: the refusal does not name {m['refused']!r}: {e}")
                check(sum(h264_cuda.launches.values()) == 0, f"{name}: launched before refusing")
                continue
            with avi.open_video(fixture / name) as reader:
                samples, stream = list(reader), reader.stream
            reset()
            dec = h264_cuda.Decoder(dev, stream.extradata, stream.fourcc)
            if name not in H264_STAGEWISE:  # (those hold the parse to its old kernel below)
                batches = []

                def parse_vs_old(jobs, n, device):
                    tables = h264_cuda.parse(jobs, n, device)
                    batches.append((jobs, n, tables))
                    return tables

                dec.stages["parse"] = parse_vs_old
            frames = decode_all(dec, samples)
            if name not in H264_STAGEWISE:
                for k, (jobs, n, tables) in enumerate(batches):
                    h264_parse_vs_old(err, old_parse, jobs, n, tables, f"{name}, batch {k}")
            check([sha(f) for f in frames] == m["bgr_sha256"], f"{name}: frames != cv2's sha256 "
                  f"({len(frames)} frames, cv2 {m['frames']})")
            check(h264_cuda.plain_calls == dict.fromkeys(H264_STAGES, 0) and
                  mpeg4_cuda.plain_calls["yuv420_to_bgr"] == 0 and
                  mpeg4_cuda.launches["yuv420_to_bgr"] == len(frames),
                  f"{name}: launches {h264_cuda.launches}, plain calls {h264_cuda.plain_calls}")
            if name in H264_STAGEWISE:
                pics, _, _ = h264_stagewise(dev, err, samples, stream.extradata, stream.fourcc, old_parse=old_parse)
                n_pics += pics
            n_forms += 1
            n_frames += len(frames)
        secs["forms"] = time.perf_counter() - t0
        n_refused = sum("refused" in m for m in meta.values())
        record["forms"] = {"decoded": n_forms, "frames": n_frames, "refused": n_refused}
        print(f"H.264 forms on the card: {n_forms} streams, {n_frames} frames == cv2's sha256 through the three "
              f"kernels and the colour kernel (plain calls 0); each kernel == its plain version on every picture of "
              f"{len(H264_STAGEWISE)} small forms ({n_pics} pictures); {n_refused} refusals by name; "
              f"{secs['forms']:.1f} s [{label}]", flush=True)

        # ---- 23b. the 1024x2048 clip: each stage against its plain version; the kernels before and after their
        # redesign equal, and timed in turns on an I and a P picture
        clip = fixture / "big_1024x2048.mp4"
        with avi.open_video(clip) as reader:
            samples, stream = list(reader), reader.stream
        FH, FW, n_clip = stream.height, stream.width, len(samples)
        t0 = time.perf_counter()
        pics_checked, plain, kept = h264_stagewise(dev, err, samples, stream.extradata, stream.fourcc,
                                                   limit=2, picks=(0, 1), old_parse=old_parse, parse_limit=1)
        secs["stagewise 1024x2048"] = time.perf_counter() - t0
        jobs = kept["parse"][0]
        record["1024x2048"] = {"bytes": int(sum(len(x) for x in samples)), "frames": n_clip,
                               "stagewise_s": secs["stagewise 1024x2048"], "slices_per_batch": len(jobs)}
        print(f"1024x2048 H.264 clip ({n_clip} frames, {record['1024x2048']['bytes']} bytes, High CABAC I P B B, 4 "
              f"slices a picture): the reconstruction and deblocking == their plain versions on its first two pictures, "
              f"the parse on its first (the plain Python decoder takes seconds a picture there), and the parse == "
              f"the kernel before its redesign on both batches [{label}]", flush=True)
        per = h264_clip_timings(dev, err, kept, jobs, plain, pics_checked, label)
        record["1024x2048"]["kernels"] = per
        del kept

        # ---- 23c. multi_demo on the clip: the counts, the written file
        src = create_model(net, (H, W), num_classes=NUM_CLASSES, device=dev,
                           generator=torch.Generator().manual_seed(23))
        model_dir = work / "model"
        CheckpointManager(checkpoint_prefix(str(model_dir), net, H)).save(
            0, MultiTaskSolver(src.model, src.anchors, device=dev).init_state())
        del src
        out_dir = work / "out"
        demo_args = ["--network", net, "--data-shape", f"3,{H},{W}", "--model-dir", str(model_dir), "--epoch", "0",
                     "--dtype", "bfloat16", "--vis-thresh", str(thresh), "--out-dir", str(out_dir),
                     "--device", str(dev), "--images", str(clip)]
        reset()
        t0 = time.perf_counter()
        written = multi_demo.main(demo_args)
        torch.cuda.synchronize()
        secs["multi_demo"] = time.perf_counter() - t0
        got = {"nms": nms_cuda.launches, **h264_cuda.launches, **h264_cuda.kernel_launches,
               "yuv420_to_bgr": mpeg4_cuda.launches["yuv420_to_bgr"],
               "plain_calls": sum(h264_cuda.plain_calls.values()) + mpeg4_cuda.plain_calls["yuv420_to_bgr"],
               "mp4v_encodes": mpeg4.encodes}
        per_stage = {"h264_parse": -(-n_clip // 8), "h264_recon": n_clip, "h264_deblock": n_clip}
        want = {"nms": 2 * 3, **per_stage, **{k: per_stage[st] for st, ks in h264_cuda.KERNELS.items() for k in ks},
                "yuv420_to_bgr": n_clip, "plain_calls": 0, "mp4v_encodes": n_clip}
        check(got == want, f"multi_demo on the H.264 clip: counts {got}, expected {want}")
        check(written == [str(out_dir / "detection_out.mp4")], f"multi_demo wrote {written}")
        for k in h264_cuda.kernel_launches:
            launches[k]["h264_demo"] = got[k]
        print("kernel launches a picture in multi_demo: " + ", ".join(
            f"{k} {got[k] / n_clip:g}" for k in h264_cuda.kernel_launches) + f" [{label}]", flush=True)
        launches["yuv420_to_bgr"]["h264_demo"] = got["yuv420_to_bgr"]
        launches["nms_keep_mask"]["h264_demo"] = got["nms"]
        nms_cuda.launches = 0
        with avi.open_video(written[0]) as reader:
            out_samples, out_stream = list(reader), reader.stream
        check((len(out_samples), out_stream.fps, out_stream.width, out_stream.height, out_stream.fourcc) ==
              (n_clip, 25.0, FW, FH, "mp4v"), f"detection_out.mp4: {len(out_samples)} VOPs, {out_stream[:5]}")
        record["demo"] = {"counts": got, "seconds": secs["multi_demo"]}
        print(f"multi_demo {net} {H}x{W} bf16 --images big_1024x2048.mp4 (H.264, {n_clip} frames): "
              f"{secs['multi_demo']:.2f} s with the model build; counts {got}; detection_out.mp4: {len(out_samples)} "
              f"mp4v frames, 25 fps, {FW}x{FH} [{label}]", flush=True)

        # ---- 23d. each stage per 1024x2048 frame (synchronised around each)
        detector = multi_demo.get_detector(multi_demo.parse_args(demo_args))
        stage = dict.fromkeys(("demux", "parse", "recon", "deblock", "colour", "resize", "serve", "nms 0.95",
                               "overlay", "draw", "encode", "write"), 0.0)

        def timed(name, fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            stage[name] += time.perf_counter() - t
            return out

        def timed_stage(name, fn):
            return lambda *args: timed(name, lambda: fn(*args))

        with avi.open_video(clip) as reader:
            samples = timed("demux", lambda: list(reader))
        dec = h264_cuda.Decoder(dev, stream.extradata, stream.fourcc)
        dec.stages.update({k: timed_stage(k, dec.stages[k]) for k in ("parse", "recon", "deblock", "colour")})
        inside = sum(stage[k] for k in ("parse", "recon", "deblock", "colour"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = decode_all(dec, samples)
        torch.cuda.synchronize()
        # the decode's time outside its stages: NAL units, headers, the DPB's plan, the crop
        stage["demux"] += time.perf_counter() - t0 - (sum(stage[k] for k in ("parse", "recon", "deblock", "colour"))
                                                       - inside)
        check(len(frames) == n_clip and [sha(f) for f in frames] == meta["big_1024x2048.mp4"]["bgr_sha256"],
              "the staged decode of the clip != cv2's frames")
        raws = [timed("resize", lambda: resize_linear(f, (H, W))) for f in frames]
        pipe = ServingPipeline(detector, depth=2, raw=True)
        for r in raws[:3]:
            pipe.submit(r)
        list(pipe.drain())

        def serve_all():
            res = [pipe.submit(r) for r in raws]
            return [x for x in res if x is not None] + list(pipe.drain())

        results = [x[1] for x in timed("serve", serve_all)]
        rows = [detector._filter_rows(r["det"][0], 0.0) for r in results]
        kept = [timed("nms 0.95", lambda: video.second_nms(d, (H, W), 0.95)) for d in rows]
        segs = [torch.from_numpy(r["seg"][0]) for r in results]
        overs = [timed("overlay", lambda: draw.seg_overlay_tensor(f, s_, detector.palette)) for f, s_ in zip(frames, segs)]
        drawn = [timed("draw", lambda: detector.draw_boxes(o.cpu().numpy(), d, thresh)) for o, d in zip(overs, kept)]
        del overs, frames, raws
        encoder = mpeg4.Encoder(FW, FH)
        encoded = [timed("encode", lambda: encoder.encode(torch.from_numpy(img).to(dev))) for img in drawn]
        with mp4.Mp4Writer(str(work / "stages.mp4"), FW, FH, encoder.config, 25) as writer:
            for e in encoded:
                timed("write", lambda: writer.write(*e))
        per_frame = {k: v * 1e3 / n_clip for k, v in stage.items()}
        t0 = time.perf_counter()
        detector.detect_and_visualize(str(clip), str(work / "again"), thresh)
        total_ms = (time.perf_counter() - t0) * 1e3 / n_clip
        record["stage_ms"] = per_frame
        record["total_ms_per_frame"] = total_ms
        print(f"H.264 video per {FH}x{FW} frame ({n_clip} frames, each stage synchronised; parse per batch of 8 "
              f"pictures spread over its frames): " + ", ".join(f"{k} {v:.3f} ms" for k, v in per_frame.items())
              + f"; stages summed {sum(per_frame.values()):.3f} ms; detect_and_visualize end to end {total_ms:.3f} "
              f"ms/frame ({1e3 / total_ms:.2f} frames/s) [{label}]", flush=True)
        launches["nms_keep_mask"]["h264_checks"] = nms_cuda.launches
    finally:
        shutil.rmtree(work, ignore_errors=True)
    record["seconds"] = secs
    record["max_abs_err"] = err
    print(json.dumps({"h264_phase": record}), flush=True)
    return launches, per, record


phase_s = {}  # seconds of each phase, in order
T0 = time.perf_counter()


def timed_phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    phase_s[name] = time.perf_counter() - t0
    print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
    return out


def print_phase_seconds():
    """The seconds of each phase and the script's total (from its start,
    imports included), on a line before the last."""
    print(json.dumps({"phase_seconds": {k: round(v, 1) for k, v in phase_s.items()},
                      "total_seconds": round(time.perf_counter() - T0, 1)}), flush=True)


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
    from dspnet_torch.data import jpeg_cuda
    from dspnet_torch.detect.detector import Detector
    from dspnet_torch.models import factory
    from dspnet_torch.ops import _build, matching_cuda, nms_cuda
    from dspnet_torch.ops.detection import multibox_detection

    # ---- 1. card
    t_start = time.perf_counter()
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    label = card_label()
    print(f"card: {kind} | nvidia-smi name, power.limit:")
    print(label)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off (cudnn.allow_tf32 and cuda.matmul.allow_tf32 False): float32 work below "
          "is full float32", flush=True)
    probe_codec_libraries()

    # ---- 2. build
    t0 = time.perf_counter()
    libs = _build.build_libraries([_build.CSRC / "nms.cu", _build.CSRC / "match.cu", _build.CSRC / "jpeg.cu",
                                   _build.CSRC / "jpeg2000.cu", _build.CSRC / "mpeg4.cu", _build.CSRC / "av1.cu",
                                   _build.CSRC / "h264.cu", *BASELINE_SOURCES,
                                   COLOUR_BASELINE, H264_BASELINE, H264_PARSE_BASELINE, MP4V_PARSE_BASELINE])
    print(f"build: {', '.join(str(x.relative_to(ROOT)) for x in libs)} ready in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)")
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip())
    nms_cuda.load_library()
    matching_cuda.load_library()
    phase_s["1-2 card, build"] = time.perf_counter() - t_start
    if "--real-data-only" in sys.argv[1:]:
        timed_phase("8-9 real data, reference weights", real_data_phase, dev, label)
        print_phase_seconds()
        return 0
    if "--ssd-only" in sys.argv[1:]:
        timed_phase("10 plain SSD", ssd_phase, dev, label)
        print_phase_seconds()
        return 0
    if "--options-only" in sys.argv[1:]:
        timed_phase("11 inceptionv3, seg_fast, remat, data parallelism", options_phase, dev, label)
        print_phase_seconds()
        return 0
    if "--prepare-only" in sys.argv[1:]:
        timed_phase("12 data preparation", prepare_phase, dev, label)
        print_phase_seconds()
        return 0
    if "--export-only" in sys.argv[1:]:
        timed_phase("13 serving deployment", deployment_phase, dev, label)
        print_phase_seconds()
        return 0
    if "--host-loaders-only" in sys.argv[1:]:
        timed_phase("14 host loaders, run scripts, bench", host_loaders_phase, dev, label)
        print_phase_seconds()
        return 0
    if "--jax-checkpoints-only" in sys.argv[1:]:
        timed_phase("15 JAX checkpoints", jax_checkpoints_phase, dev, label)
        print_phase_seconds()
        return 0
    if "--video-only" in sys.argv[1:]:
        timed_phase("16 video", video_phase, dev, label)
        print_phase_seconds()
        return 0
    if "--jpeg-forms-only" in sys.argv[1:]:
        timed_phase("17 JPEG forms", jpeg_forms_phase, dev, label)
        print_phase_seconds()
        return 0
    if "--image-formats-only" in sys.argv[1:]:
        timed_phase("18 image formats", image_formats_phase, dev, label)
        print_phase_seconds()
        return 0
    if "--jpeg2000-only" in sys.argv[1:]:
        timed_phase("19 JPEG 2000", jpeg2000_phase, dev, label)
        print_phase_seconds()
        return 0
    if "--mp4v-only" in sys.argv[1:]:
        timed_phase("20 MPEG-4 Part 2", mp4v_phase, dev, label)
        print_phase_seconds()
        return 0
    if "--text-only" in sys.argv[1:]:
        timed_phase("21 text", text_phase, dev, label)
        print_phase_seconds()
        return 0
    if "--avif-only" in sys.argv[1:]:
        timed_phase("22 AVIF", avif_phase, dev, label)
        print_phase_seconds()
        return 0
    if "--h264-only" in sys.argv[1:]:
        timed_phase("23 H.264", h264_phase, dev, label)
        print_phase_seconds()
        return 0
    t_phase3 = time.perf_counter()
    base_nms, base_match = baseline_kernels(dev)
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
    # nms_topk <= 0 runs NMS over every anchor: K = A = 12,264, the device-memory mask
    rows = random_rows(rng, 1, 12264)
    for force in (False, True):
        compare(rows, 0.45, force, "B=1 K=12264")
    # both sides of the shared-memory limit, and more images than SMs
    for B, K in ((1, 1216), (1, 1217), (133, 400)):
        compare(random_rows(rng, B, K), 0.45, False, f"B={B} K={K}")
    # IoUs within a few ulps of the threshold: the IEEE division decides
    for thr in (0.45, 0.5):
        compare(near_threshold_rows(rng, 4, 64, thr), thr, False, "IoUs at the threshold")
    boxes, ids, valid = random_rows(rng, 1, 400)
    compare((boxes, ids, np.zeros_like(valid)), 0.5, False, "an all-invalid image")
    max_err = max(errs)
    print(f"kernel vs plain: {len(errs)} cases equal bit for bit (torch.equal on keep masks), "
          f"plans {nms_cuda.launch_plan(1, 400)} at B=1 K=400, {nms_cuda.launch_plan(1, 1217)} at K=1217")

    nms_times = {}
    for B in (1, 128):
        rows = random_rows(rng, B, 400)
        args = [torch.from_numpy(a).to(dev) for a in rows]
        check(torch.equal(nms_cuda.nms_keep_mask(*args, 0.45), base_nms(*args, 0.45)),
              f"NMS kernel != baseline kernel at B={B} K=400")
        t = kernel_times(lambda: nms_cuda.nms_keep_mask(*args, 0.45), NMS_KERNELS)
        t_old = kernel_times(lambda: base_nms(*args, 0.45), NMS_KERNELS)
        p_ms = cuda_ms(lambda: nms_cuda.nms_keep_mask_reference(*args, 0.45), 20)
        # boxes, ids, valid read once and keep written once; ~13 float32
        # operations for each pair of valid rows (IoU, class test, compare)
        v = rows[2].sum(axis=1).astype(np.int64)
        bound = bound_us(B * 400 * (16 + 4 + 1 + 1), 13 * int((v * (v - 1) // 2).sum()))
        nms_times[f"B={B} K=400"] = dict(with_baseline(t, t_old), plain_ms=p_ms, bound_us=bound[0],
                                         bound_by=bound[1])
        print_times(f"nms_keep_mask B={B} K=400", t, p_ms, bound, label)
        print_times(f"nms_keep_mask B={B} K=400, baseline kernel", t_old, p_ms, bound, label)
        if nms_cuda.launch_plan(B, 400).cluster > 1:  # the same call on one block per image
            one = nms_cuda.launch_plan(B, 400)._replace(cluster=1)
            t1 = kernel_times(lambda: nms_cuda._launch(*args, 0.45, False, plan=one), NMS_KERNELS)
            print_times(f"nms_keep_mask B={B} K=400 one block per image (no cluster)", t1, p_ms, bound, label)

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

    phase_s["3-4 NMS kernel, serving"] = time.perf_counter() - t_phase3
    match_err, match_times = timed_phase("5 matcher kernel", matcher_phase, dev, bundle.anchors, label, base_match)
    match_launches, train_ips = timed_phase("6 training", training_phase, dev, label)
    cli_launches = timed_phase("7 CLIs", cli_phase, dev, label, train_ips[4])
    real_launches, decoder, (ref_launches, reference) = timed_phase("8-9 real data, reference weights",
                                                                    real_data_phase, dev, label)
    ssd_launches, ssd_times, ssd_errs = timed_phase("10 plain SSD", ssd_phase, dev, label)
    opt_launches, opt_times, opt_errs = timed_phase("11 inceptionv3, seg_fast, remat, data parallelism",
                                                    options_phase, dev, label)
    prep_launches, prep_errs, _ = timed_phase("12 data preparation", prepare_phase, dev, label)
    deploy_launches, _ = timed_phase("13 serving deployment", deployment_phase, dev, label)
    host_launches, _ = timed_phase("14 host loaders, run scripts, bench", host_loaders_phase, dev, label)
    jax_ckpt_launches, _ = timed_phase("15 JAX checkpoints", jax_checkpoints_phase, dev, label)
    video_launches, _ = timed_phase("16 video", video_phase, dev, label)
    forms_launches, forms_record = timed_phase("17 JPEG forms", jpeg_forms_phase, dev, label)
    image_launches, _ = timed_phase("18 image formats", image_formats_phase, dev, label)
    j2k_launches, j2k_times, _ = timed_phase("19 JPEG 2000", jpeg2000_phase, dev, label)
    mp4v_launches, mp4v_times, _ = timed_phase("20 MPEG-4 Part 2", mp4v_phase, dev, label)
    timed_phase("21 text", text_phase, dev, label)
    avif_launches, avif_times, _ = timed_phase("22 AVIF", avif_phase, dev, label)
    h264_launches, h264_times, _ = timed_phase("23 H.264", h264_phase, dev, label)
    from dspnet_torch.data.h264_cuda import KERNELS as h264_kernel_names
    mp4v_launches["yuv420_to_bgr"].update(h264_launches["yuv420_to_bgr"])  # the colour kernel serves both codecs
    for times in (ssd_times, opt_times):
        nms_times.update(times["nms_keep_mask"])
        match_times.update(times["bipartite_match"])

    # ---- 21. results: launches summed over the paths, each counted from 0
    by_path = {"nms_keep_mask": {"serving": launches, "cli": cli_launches["nms_keep_mask"],
                                 "real_data": real_launches["nms_keep_mask"], **ref_launches["nms_keep_mask"],
                                 "ssd": ssd_launches["nms_keep_mask"], "options": opt_launches["nms_keep_mask"],
                                 "prepare": prep_launches["nms_keep_mask"],
                                 "deployment": deploy_launches["nms_keep_mask"], **host_launches["nms_keep_mask"],
                                 **jax_ckpt_launches["nms_keep_mask"], **video_launches["nms_keep_mask"],
                                 **forms_launches["nms_keep_mask"], **image_launches["nms_keep_mask"],
                                 **j2k_launches["nms_keep_mask"], **mp4v_launches["nms_keep_mask"],
                                 **avif_launches["nms_keep_mask"], **h264_launches["nms_keep_mask"]},
               "bipartite_match": {"training": match_launches, "cli": cli_launches["bipartite_match"],
                                   "real_data": real_launches["bipartite_match"],
                                   **ref_launches["bipartite_match"], "ssd": ssd_launches["bipartite_match"],
                                   "options": opt_launches["bipartite_match"],
                                   "prepare": prep_launches["bipartite_match"], **host_launches["bipartite_match"],
                                   **jax_ckpt_launches["bipartite_match"], **image_launches["bipartite_match"],
                                   **j2k_launches["bipartite_match"], **avif_launches["bipartite_match"]},
               "jpeg_ycc_to_bgr": {"real_data": real_launches["jpeg_ycc_to_bgr"],
                                   **ref_launches["jpeg_ycc_to_bgr"], "prepare": prep_launches["jpeg_ycc_to_bgr"],
                                   **host_launches["jpeg_ycc_to_bgr"], **jax_ckpt_launches["jpeg_ycc_to_bgr"],
                                   **video_launches["jpeg_ycc_to_bgr"], **forms_launches["jpeg_ycc_to_bgr"]}}
    colour = decoder.pop("colour_kernel")

    shape_keys = ("device_us", "host_us", "event_ms", "bound_us", "plain_ms", "before_device_us",
                  "before_host_us", "before_event_ms", "refills")

    def entry(name, source, replaces, path_launches, err, times, main):
        t = times[main]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(path_launches.values()), "launches_by_path": path_launches,
            "max_abs_err": float(err),
            "ms": t["device_us"] / 1e3, "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"], "library_ms": None,
            "at": main, **{k: t[k] for k in shape_keys if k in t},
            "other_shapes": {s: {k: v[k] for k in shape_keys if k in v}
                             for s, v in times.items() if s != main},
        }

    # nvJPEG is the counterpart of the JAX package's host decode (cv2 on
    # libjpeg), not of a TPU kernel: its record stands on a line of its own.
    # The colour kernel, written by hand for the card, stands in the kernels
    # line beside the two TPU kernels' ports
    print(json.dumps({"decoders": [
        {"name": "jpeg_decode_batch", "route": "nvjpeg", "source": "dspnet_torch/csrc/jpeg.cu",
         "replaces": "dspnet_tpu/data/iterator.py:73 (cv2.imdecode on the host)", **decoder}]}))
    print(json.dumps({"reference_weights": reference}))
    print(json.dumps({"kernels": [
        entry("nms_keep_mask", "dspnet_torch/csrc/nms.cu", "dspnet_tpu/ops/nms_pallas.py:30",
              by_path["nms_keep_mask"], max(max_err, ssd_errs["nms_keep_mask"], opt_errs["nms_keep_mask"],
                                            prep_errs["nms_keep_mask"]),
              nms_times, "B=1 K=400"),
        entry("bipartite_match", "dspnet_torch/csrc/match.cu", "dspnet_tpu/ops/matching_pallas.py:42",
              by_path["bipartite_match"], max(match_err, ssd_errs["bipartite_match"], opt_errs["bipartite_match"],
                                              prep_errs["bipartite_match"]),
              match_times, "B=8 A=12264 num_gt=8"),
        {"name": "jpeg_ycc_to_bgr", "route": "cuda", "source": "dspnet_torch/csrc/jpeg.cu",
         "replaces": "libjpeg-turbo's jdsample.c upsamplers (h2v1/h2v2/h1v2 fancy, int_upsample) + jdcolor.c behind "
                     "cv2.imdecode "
                     "(dspnet_tpu/data/iterator.py:73), not a TPU kernel",
         "launches": sum(by_path["jpeg_ycc_to_bgr"].values()), "launches_by_path": by_path["jpeg_ycc_to_bgr"],
         "max_abs_err": float(decoder["colour_max_abs_err"]), "ms": colour["device_us"] / 1e3, "plain_ms": colour["plain_ms"],
         "bound_ms": colour["bound_us"] / 1e3, "bound_by": colour["bound_by"], "library_ms": None,
         "at": "1024x2048 4:2:0", "host_us": colour["host_us"], "event_ms": colour["event_ms"],
         "cases_equal": colour["cases"], "launches_by_mode": dict(jpeg_cuda.color_mode_launches),
         "launches_by_factors": dict(jpeg_cuda.color_factor_launches),
         "other_shapes": {s: {k: v[k] for k in shape_keys if k in v}
                          for s, v in forms_record["colour_kernel"].items()}},
        *[{"name": name, "route": "cuda", "source": "dspnet_torch/csrc/jpeg2000.cu",
           "replaces": f"OpenJPEG's {lib} behind cv2.imdecode (dspnet_tpu/data/iterator.py:73), not a TPU kernel",
           "launches": sum(j2k_launches[key].values()), "launches_by_path": j2k_launches[key], "max_abs_err": 0.0,
           "ms": j2k_times["5/3"][key]["device_us"] / 1e3, "plain_ms": j2k_times["5/3"][key]["plain_ms"],
           "bound_ms": j2k_times["5/3"][key]["bound_us"] / 1e3, "bound_by": j2k_times["5/3"][key]["bound_by"],
           "library_ms": None, "at": "1024x2048 5/3 (lossless, textured)",
           "host_us": j2k_times["5/3"][key]["host_us"], "how": j2k_times["5/3"][key]["how"],
           "launches_per_call": j2k_times["5/3"][key]["launches_per_call"],
           "other_shapes": {"1024x2048 9/7": {k: j2k_times["9/7"][key][k] for k in
                                              ("device_us", "host_us", "bound_us", "plain_ms", "launches_per_call")}}}
          for name, key, lib in (("t1_decode_kernel", "t1_decode", "t1.c (tier-1: EBCOT passes, MQ decoder)"),
                                 ("idwt_kernel", "idwt", "dwt.c (inverse 5/3 and 9/7 wavelets, dequantisation)"),
                                 ("mct_store_kernel", "mct_store",
                                  "mct.c (inverse RCT / ICT) + tcd.c's DC shift and clipping + cv2's copy"))],
        *[{"name": MP4V_KERNELS[key], "route": "cuda", "source": "dspnet_torch/csrc/mpeg4.cu",
           "replaces": f"FFmpeg's {lib} behind cv2.VideoCapture (dspnet_tpu/detect/detector.py:289), not a TPU kernel",
           "launches": sum(mp4v_launches[key].values()), "launches_by_path": mp4v_launches[key],
           "max_abs_err": mp4v_times[key]["max_abs_err"],
           "ms": mp4v_times[key]["device_us"] / 1e3, "plain_ms": mp4v_times[key]["plain_ms"],
           "bound_ms": mp4v_times[key]["bound_us"] / 1e3, "bound_by": mp4v_times[key]["bound_by"],
           "library_ms": None, "at": at, "host_us": mp4v_times[key]["host_us"], "how": mp4v_times[key]["how"],
           "launches_per_call": mp4v_times[key]["launches_per_call"],
           **{k: mp4v_times[key][k] for k in ("new_us_turns", "old_us_turns", "chain_steps", "ns_per_step", "us_per_mb",
                                             "old_ns_per_step") if k in mp4v_times[key]}}
          for key, lib, at in (("mp4v_parse", "mpeg4videodec.c / h263dec.c macroblock layer (VLCs, MV and AC/DC "
                                              "prediction, scans)", "8 VOPs of 1024x2048 in one launch"),
                               ("mp4v_recon", "unquantize, x86 simple IDCT and hpeldsp motion compensation",
                                "one 1024x2048 P-VOP"),
                               ("yuv420_to_bgr", "swscale's unscaled YUV420P -> BGR24 (x86 SIMD rule)",
                                "one 1024x2048 frame"))],
        *[{"name": AV1_KERNELS[key], "route": "cuda", "source": "dspnet_torch/csrc/av1.cu",
           "replaces": f"libaom 3.14's {lib} behind cv2.imdecode on libavif (dspnet_tpu/data/iterator.py:73), "
                       "not a TPU kernel",
           "launches": sum(avif_launches[key].values()), "launches_by_path": avif_launches[key],
           "max_abs_err": float(avif_times[scene][key]["max_abs_err"]),
           "ms": avif_times[scene][key]["device_us"] / 1e3, "plain_ms": avif_times[scene][key]["plain_ms"],
           "bound_ms": avif_times[scene][key]["bound_us"] / 1e3, "bound_by": avif_times[scene][key]["bound_by"],
           "library_ms": None, "at": AVIF_SCENES[scene], "host_us": avif_times[scene][key]["host_us"],
           "how": avif_times[scene][key]["how"], "launches_per_call": avif_times[scene][key]["launches_per_call"],
           "other_shapes": {AVIF_SCENES[other]: {k: avif_times[other][key][k] for k in
                                                  ("device_us", "host_us", "bound_us", "plain_ms",
                                                   "launches_per_call")}}}
          for key, lib, scene, other in (
              ("recon", "av1_predict_intra_block + av1_inv_txfm2d_add (dequantisation, inverse transforms, intra "
                        "prediction, IntraBC, add and clip)", "big_default.avif", "big_s0.avif"),
              ("deblock", "av1_filter_block_plane_vert / _horz (deblocking)", "big_default.avif", "big_s0.avif"),
              ("cdef", "av1_cdef_frame (CDEF)", "big_default.avif", "big_s0.avif"),
              ("lr", "av1_loop_restoration_filter_frame (Wiener, self-guided)", "big_s0.avif",
               "big_default.avif"))],
        *[{"name": name, "route": "cuda", "source": "dspnet_torch/csrc/h264.cu",
           "replaces": f"FFmpeg's {H264_REPLACES[name]} behind cv2.VideoCapture (dspnet_tpu/detect/detector.py:289), "
                       "not a TPU kernel",
           "launches": sum(h264_launches[name].values()), "launches_by_path": h264_launches[name],
           **h264_kernel_entry(h264_times, stage, name)}
          for stage in H264_STAGES for name in h264_kernel_names[stage]],
    ]}))
    print_phase_seconds()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
