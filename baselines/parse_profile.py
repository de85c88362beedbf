"""Where the cycles of the two entropy-parse kernels go, on the card.

Copies ``dspnet_torch/csrc/h264.cu`` and ``csrc/mpeg4.cu`` into ``build/``
with ``clock64()`` stamps around the parts of the chain (each slice's or
VOP's whole run, each macroblock step, the residual / each block, the TCOEF
loop, the DC / AC prediction), builds them with nvcc, runs them through the
wrappers' own launch path (``parse_launches``, whose ``steps`` buffer takes
the stamps) on the 1024x2048 H.264 clip's first batch (8 pictures, 32
slices) and cv2's 2048x1024 mp4v clip's first 8 VOPs, and prints per slice
or VOP the chain's steps, the cycles of each part and cycles a step. With
``--sass`` it also writes ``cuobjdump -sass`` of both copies beside them.
The stamped copies are measurement builds only: nothing on a path loads
them. Run on a card from the repository's root:

    python3 baselines/parse_profile.py [--sass]
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def _patch(text, edits, what):
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{what}: the source no longer has the place to stamp: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def stamped_sources():
    """The two sources with the stamps, written under build/ -> their paths."""
    h264 = _patch((ROOT / "dspnet_torch" / "csrc" / "h264.cu").read_text(), [
        ("  int steps;  // bins decoded (the CABAC chain's steps)\n",
         "  int steps;  // bins decoded (the CABAC chain's steps)\n  long long tres; int bres;\n"),
        ("  __device__ __forceinline__ void residual(int i16) {\n    int32_t* rw = row(mb);",
         "  __device__ __forceinline__ void residual(int i16) {\n    long long c0 = clock64(); int s0 = e.steps;\n"
         "    residual_(i16);\n    e.tres += clock64() - c0; e.bres += e.steps - s0;\n  }\n"
         "  __device__ __forceinline__ void residual_(int i16) {\n    int32_t* rw = row(mb);"),
        ("      p.e.steps = 0;", "      p.e.steps = 0; p.e.tres = 0; p.e.bres = 0;"),
        ("    for (int it = 0;; it++) {\n      int16_t* lb = lbuf + (it & 1) * N_LEVELS;",
         "    long long tv0 = clock64(), tstep = 0;\n    for (int it = 0;; it++) {\n"
         "      int16_t* lb = lbuf + (it & 1) * N_LEVELS;"),
        ("        in[0] = p.step(lb);", "        long long cs = clock64();\n        in[0] = p.step(lb);\n"
                                      "        tstep += clock64() - cs;"),
        ("          if (steps) steps[si] = p.e.chain_steps();",
         "          if (steps) { int* o = steps + 8 * si; o[0] = p.e.chain_steps();"
         " o[1] = (int)((clock64() - tv0) >> 4); o[2] = (int)(tstep >> 4); o[3] = (int)(p.e.tres >> 4);"
         " o[4] = p.e.bres; }"),
    ], "h264.cu")
    mpeg4 = _patch((ROOT / "dspnet_torch" / "csrc" / "mpeg4.cu").read_text(), [
        ("  int steps;  // VLC symbols read (the chain's steps)\n",
         "  int steps;  // VLC symbols read (the chain's steps)\n  long long tco, tblk, tdc; int ncoef;\n"),
        ("    steps = 0;\n  }", "    steps = 0; tco = 0; tblk = 0; tdc = 0; ncoef = 0;\n  }"),
        ("  if (coded) {\n    const int* tab = tco",
         "  long long c1 = clock64();\n  if (coded) {\n    const int* tab = tco"),
        ("        blk64[scan[i < 63 ? i : 63]] = (int16_t)(e >> 8);",
         "        blk64[scan[i < 63 ? i : 63]] = (int16_t)(e >> 8);\n        b.ncoef++;"),
        ("      blk64[scan[i]] = (int16_t)level;\n      if (last) break;\n    }\n    if (err) return err;\n  }\n"
         "  if (intra) {\n    if (!use_dc_vlc) blk64[0] = (int16_t)pred_dc(v, y, x, blk, blk64[0], scale, &dir);\n"
         "    pred_ac(v, y, x, blk, blk64, dir);\n  }\n  return OK;",
         "      blk64[scan[i]] = (int16_t)level;\n      b.ncoef++;\n      if (last) break;\n    }\n"
         "    if (err) return err;\n  }\n  long long c2 = clock64();\n  b.tco += c2 - c1;\n  if (intra) {\n"
         "    if (!use_dc_vlc) blk64[0] = (int16_t)pred_dc(v, y, x, blk, blk64[0], scale, &dir);\n"
         "    pred_ac(v, y, x, blk, blk64, dir);\n  }\n  b.tdc += clock64() - c2;\n  return OK;"),
        ("    int16_t* blk64 = lvo + blk * 64;\n    err = read_block_levels(",
         "    int16_t* blk64 = lvo + blk * 64;\n    long long cb = clock64();\n    err = read_block_levels("),
        ("    if (err) {  // a block that fails leaves no levels",
         "    b.tblk += clock64() - cb;\n    if (err) {  // a block that fails leaves no levels"),
        ("    Reader b;\n    int err = OK;",
         "    Reader b;\n    int err = OK;\n    long long tv0 = clock64(), tparse = 0;"),
        ("        if (index < n) err = parse_mb(",
         "        long long cp = clock64();\n        if (index < n) err = parse_mb("),
        ("        in[0] = index < n ? index : -1;",
         "        tparse += clock64() - cp;\n        in[0] = index < n ? index : -1;"),
        ("          if (steps) steps[vi] = b.steps;",
         "          if (steps) { int* o = steps + 8 * vi; o[0] = b.steps; o[1] = (int)((clock64() - tv0) >> 4);"
         " o[2] = (int)(tparse >> 4); o[3] = (int)(b.tblk >> 4); o[4] = (int)(b.tco >> 4);"
         " o[5] = (int)(b.tdc >> 4); o[6] = b.ncoef; }"),
    ], "mpeg4.cu")
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    paths = (out / "h264_stamped.cu", out / "mpeg4_stamped.cu")
    for path, text in zip(paths, (h264, mpeg4)):
        path.write_text(text)
    return paths


def main():
    if not torch.cuda.is_available():
        print("parse_profile: torch.cuda.is_available() is false; this measurement runs on a CUDA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from dspnet_torch.data import avi, h264_cuda, mpeg4, mpeg4_cuda
    from dspnet_torch.ops import _build

    dev = torch.device("cuda:0")
    h264_src, mpeg4_src = stamped_sources()
    libs = _build.build_libraries([h264_src, mpeg4_src])
    label = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    print(f"card: {label}")

    h264_cuda._SOURCE, mpeg4_cuda._SOURCE = h264_src, mpeg4_src
    h264_cuda.load_library.cache_clear()
    mpeg4_cuda.load_library.cache_clear()

    with avi.open_video(ROOT / "tests" / "fixtures" / "h264_forms" / "big_1024x2048.mp4") as reader:
        samples, stream = list(reader), reader.stream
    dec = h264_cuda.Decoder(dev, stream.extradata, stream.fourcc)
    pictures = dec._slices(samples[:8])
    plans = dec._plan(pictures)
    jobs = [(j, plans[j.picture].sps) for p in pictures for j in p]
    stamps = torch.zeros(len(jobs) * 8, dtype=torch.int32, device=dev)
    (table, *_), launches = h264_cuda.parse_launches(jobs, len(pictures), dev, steps=stamps)
    for _ in range(2):
        launches[0][1]()
    torch.cuda.synchronize()
    from dspnet_torch.data.h264_parse import F_SLICE

    print("H.264, the clip's first batch (stamps of the second launch), cycles:")
    for (job, sps), row in zip(jobs, stamps.view(-1, 8).cpu().numpy().astype(np.int64)):
        bins, total, step, res, res_bins = row[0], row[1] * 16, row[2] * 16, row[3] * 16, row[4]
        mbs = int((table[job.picture, :sps.mb_width * sps.mb_height, F_SLICE] == job.index).sum())
        print(f"  picture {job.picture} slice {job.index} (type {job.h.slice_type}): {bins} bins; total {total}, in "
              f"the macroblock steps {step}, in the residual {res} ({res_bins} bins); a bin: {total / bins:.1f} in "
              f"all, {res / max(res_bins, 1):.1f} a residual bin, {(step - res) / max(bins - res_bins, 1):.1f} a "
              f"macroblock-layer bin; outside the steps {(total - step) / mbs:.1f} a macroblock (of {mbs})")

    with avi.open_video(ROOT / "tests" / "fixtures" / "mp4v_forms" / "cv2_mp4v_2048x1024.mp4") as reader:
        samples, stream = list(reader), reader.stream
    vol = mpeg4.parse_config(stream.extradata)
    headers = [mpeg4.read_vop_header(x, vol) for x in samples[:8]]
    bits, vops = mpeg4_cuda.stage(samples[:8], headers, dev)
    stamps = torch.zeros(len(vops) * 8, dtype=torch.int32, device=dev)
    _, launches = mpeg4_cuda.parse_launches(bits, vops, vol, steps=stamps)
    for _ in range(2):
        launches[0][1]()
    torch.cuda.synchronize()
    print("mp4v, cv2's 2048x1024 clip's first 8 VOPs (stamps of the second launch), cycles:")
    for h, row in zip(headers, stamps.view(-1, 8).cpu().numpy().astype(np.int64)):
        symbols, total, mbs_c, blocks, coef, dcac, ncoef = row[0], *(row[1:6] * 16), row[6]
        print(f"  {h.kind}-VOP: {symbols} VLC symbols, {ncoef} coefficients; total {total}, in the macroblocks "
              f"{mbs_c}, in the blocks {blocks}, in the TCOEF loops {coef} ({coef / max(ncoef, 1):.1f} a "
              f"coefficient), in the DC / AC prediction {dcac} ({dcac / (6 * vol.mb_num):.1f} a block); the "
              f"macroblock layer {mbs_c - blocks} ({(mbs_c - blocks) / vol.mb_num:.1f} a macroblock), outside the "
              f"macroblocks {(total - mbs_c) / vol.mb_num:.1f} a macroblock; {total / symbols:.1f} a symbol")

    if "--sass" in sys.argv[1:]:
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        for lib in libs:
            sass = lib.with_suffix(".sass")
            sass.write_text(subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True).stdout)
            print(f"SASS: {sass.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
