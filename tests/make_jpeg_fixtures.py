"""Write the committed JPEG forms under ``tests/fixtures/jpeg_forms/``: files
that ``cv2.imdecode`` reads (or refuses) and that the port's decoders must
read the same way, made by IJG-family libraries through a small C writer
(``tests/jpeg_forms_writer.c``), so that the card's machine, which has no
cv2 and no such writer, can decode them too.

    python tests/make_jpeg_fixtures.py

Needs ``gcc``, libjpeg-turbo's headers and library (``jpeglib.h``,
``-ljpeg``) and GDCM's builds of the IJG library with the lossless patch
(``gdcm-3.0/gdcmjpeg/{8,12}``, ``-lgdcmjpeg8`` / ``-lgdcmjpeg12``). The
forms:

* arithmetic coding (libjpeg-turbo's ``arith_code``): sequential (SOF9) and
  progressive (SOF10, ``jpeg_simple_progression``), with and without restart
  intervals, with DAC conditioning other than the default, gray, 4:4:4,
  4:2:2, 4:2:0, 4:1:1, 4:4:0, RGB-coded, CMYK, YCCK and sizes off the MCU
  grid; a Huffman file coded as RGB at 4:2:0;
* lossless (SOF3, GDCM's ``jpeg_simple_lossless``: components coded as RGB
  or gray): predictors 1-7, point transforms 0 and 2, restart intervals;
* every integral sampling geometry libjpeg-turbo writes in one interleaved
  scan (luma h x v and chroma h x v, each 1..4, the ratios integral);
* Huffman progressive files with restart intervals;
* refusals: a 12-bit file (GDCM's 12-bit build) and fractional sampling
  factors (3x1 luma over 2x1 chroma, the writer's own downsampling): cv2
  returns None for both;
* at 1024x2048, untextured street scenes (``synthetic.make_example``): an
  arithmetic file, a progressive file with restart intervals, a 4:1:1 and a
  4:4:0 file; and a lossless file at 512x1024 (at 1024x2048 it alone would
  take about 1.5 MB).

``forms.json`` records each file's form, the writer's arguments, and what
cv2 returns for it under IMREAD_COLOR, IMREAD_GRAYSCALE and IMREAD_UNCHANGED
(the array's shape and the sha256 of its bytes, or null for None). The
files stay under 1 MB together.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "jpeg_forms"
WRITER = ROOT / "tests" / "jpeg_forms_writer.c"
GDCM = Path("/usr/include/gdcm-3.0/gdcmjpeg")
BIG, LOSSLESS_BIG = (1024, 2048), (512, 1024)


def build(work: Path) -> dict:
    """The writer against each library: {"turbo", "gdcm8", "gdcm12"} ->
    executable."""
    exes = {"turbo": (["-DTURBO"], ["-ljpeg"]), "gdcm8": ([f"-I{GDCM}/8"], ["-lgdcmjpeg8"]),
            "gdcm12": ([f"-I{GDCM}/12"], ["-lgdcmjpeg12"])}
    out = {}
    for name, (cflags, libs) in exes.items():
        exe = work / f"writer_{name}"
        subprocess.run(["gcc", "-O1", *cflags, "-o", str(exe), str(WRITER), *libs], check=True)
        out[name] = exe
    return out


def scenes() -> dict:
    """The source images by name: (H, W, 3) BGR or (H, W) gray uint8."""
    import cv2

    from dspnet_torch.data import synthetic

    rng = np.random.RandomState(14)
    noise = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    smooth = cv2.GaussianBlur(rng.randint(0, 256, (37, 53, 3)).astype(np.uint8), (5, 5), 1.5)
    street = synthetic.make_example(rng, (64, 96), 4)[0]
    return {"noise": noise, "smooth": smooth, "street": street, "gray": smooth[..., 1].copy(),
            "cmyk": rng.randint(0, 256, (37, 53, 4)).astype(np.uint8),
            "big": synthetic.make_example(rng, BIG, 6)[0],
            "lossless_big": synthetic.make_example(rng, LOSSLESS_BIG, 6)[0]}


def forms():
    """(name, writer, source, arguments) of every file."""
    out = [
        ("arith_seq_420_street", "turbo", "street", ["arith=1", "samp=2x2,1x1,1x1"]),
        ("arith_seq_444_noise_q95", "turbo", "noise", ["arith=1", "q=95", "samp=1x1,1x1,1x1"]),
        ("arith_seq_422_rst2", "turbo", "smooth", ["arith=1", "samp=2x1,1x1,1x1", "rst=2"]),
        ("arith_seq_gray", "turbo", "gray", ["arith=1"]),
        ("arith_seq_gray_rst1", "turbo", "gray", ["arith=1", "rst=1"]),
        ("arith_seq_dac", "turbo", "noise", ["arith=1", "dac=2,6,20"]),
        ("arith_seq_dac_rst", "turbo", "smooth", ["arith=1", "dac=1,1,63", "rst=3"]),
        ("arith_seq_411", "turbo", "smooth", ["arith=1", "samp=4x1,1x1,1x1"]),
        ("arith_seq_cmyk", "turbo", "cmyk", ["arith=1", "cs=cmyk"]),
        ("arith_seq_ycck_420", "turbo", "cmyk", ["arith=1", "cs=ycck", "samp=2x2,1x1,1x1,2x2"]),
        ("arith_seq_rgb", "turbo", "smooth", ["arith=1", "cs=rgb"]),
        ("seq_rgb_420", "turbo", "smooth", ["cs=rgb", "samp=2x2,1x1,1x1"]),
        ("arith_prog_420", "turbo", "street", ["arith=1", "prog=1"]),
        ("arith_prog_444_noise", "turbo", "noise", ["arith=1", "prog=1", "q=95", "samp=1x1,1x1,1x1"]),
        ("arith_prog_gray", "turbo", "gray", ["arith=1", "prog=1"]),
        ("arith_prog_rst1", "turbo", "smooth", ["arith=1", "prog=1", "rst=1"]),
        ("arith_prog_dac_rstrows", "turbo", "noise", ["arith=1", "prog=1", "dac=3,7,2", "rstrows=1"]),
        ("arith_prog_440", "turbo", "smooth", ["arith=1", "prog=1", "samp=1x2,1x1,1x1"]),
        ("arith_prog_cmyk", "turbo", "cmyk", ["arith=1", "prog=1", "cs=cmyk"]),
        ("prog_rst2_420", "turbo", "street", ["prog=1", "rst=2"]),
        ("prog_rstrows_gray", "turbo", "gray", ["prog=1", "rstrows=1"]),
        ("twelve_bit", "gdcm12", "smooth", []),
        ("fractional_3x1_2x1", "turbo", "smooth", ["raw=1", "samp=3x1,2x1,2x1"]),
        ("big_arith_420", "turbo", "big", ["arith=1", "q=75"]),
        ("big_prog_rst_420", "turbo", "big", ["prog=1", "q=75", "rstrows=1"]),
        ("big_411", "turbo", "big", ["q=75", "samp=4x1,1x1,1x1"]),
        ("big_440", "turbo", "big", ["q=75", "samp=1x2,1x1,1x1"]),
        ("big_lossless_rgb_p1", "gdcm8", "lossless_big", ["lossless=1,0", "optimize=1"]),
    ]
    for p in range(1, 8):
        out.append((f"lossless_rgb_p{p}", "gdcm8", "smooth", [f"lossless={p},0"]))
        out.append((f"lossless_gray_p{p}", "gdcm8", "gray", [f"lossless={p},0"]))
    out += [("lossless_rgb_p7_pt2_rst", "gdcm8", "smooth", ["lossless=7,2", "rstrows=2"]),
            ("lossless_gray_p4_pt3_rst", "gdcm8", "gray", ["lossless=4,3", "rstrows=1"])]
    for hy, vy, hc, vc in itertools.product(range(1, 5), repeat=4):
        if (hy, vy) == (hc, vc) == (1, 1) or max(hy, hc) % min(hy, hc) or max(vy, vc) % min(vy, vc):
            continue
        if hy * vy + 2 * hc * vc > 10:  # more blocks than one interleaved MCU holds
            continue
        out.append((f"samp_{hy}x{vy}_{hc}x{vc}", "turbo", "smooth", ["q=90", f"samp={hy}x{vy},{hc}x{vc},{hc}x{vc}"]))
    return out


def raw_input(img: np.ndarray, bits: int = 8) -> bytes:
    """The writer's input: RGB (or gray, or CMYK) samples after a header."""
    arr = img[..., ::-1] if img.ndim == 3 and img.shape[-1] == 3 else img
    c = 1 if arr.ndim == 2 else arr.shape[-1]
    data = (arr.astype("<u2") << 4) if bits == 12 else arr
    return f"{img.shape[0]} {img.shape[1]} {c} {bits}\n".encode() + np.ascontiguousarray(data).tobytes()


def cv2_reads(data: bytes) -> dict:
    import cv2

    out = {}
    for name, flag in (("color", cv2.IMREAD_COLOR), ("gray", cv2.IMREAD_GRAYSCALE),
                       ("unchanged", cv2.IMREAD_UNCHANGED)):
        img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        out[name] = None if img is None else {"shape": list(img.shape),
                                              "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
    return out


def main():
    import cv2

    sys.path.insert(0, str(ROOT))
    from dspnet_torch.data import jpeg

    FIXTURE.mkdir(parents=True, exist_ok=True)
    for old in FIXTURE.glob("*.jpg"):
        old.unlink()
    imgs = scenes()
    meta = {"cv2": cv2.__version__, "files": {}}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        exes = build(work)
        for name, writer, source, args in forms():
            src = work / f"{source}_{writer}.raw"
            if not src.exists():
                src.write_bytes(raw_input(imgs[source], 12 if writer == "gdcm12" else 8))
            out = FIXTURE / f"{name}.jpg"
            subprocess.run([str(exes[writer]), str(src), str(out), *args], check=True)
            data = out.read_bytes()
            reads = cv2_reads(data)
            try:
                info = jpeg.read_info(data)._asdict()
                info["upsampling"] = [None if u is None else list(u) for u in info["upsampling"]]
                info["factors"] = list(info["factors"])
            except jpeg.JpegError as e:
                info = {"refused": str(e)}
            meta["files"][f"{name}.jpg"] = {"writer": writer, "source": source, "args": args, "cv2": reads,
                                            "info": info, "bytes": len(data)}
    (FIXTURE / "forms.json").write_text(json.dumps(meta, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in FIXTURE.iterdir())
    print(f"{len(meta['files'])} files, {total} bytes in {FIXTURE}")


if __name__ == "__main__":
    main()
