"""The port's demo path on the CPU against cv2 and the JAX package: the
cv2-equal bilinear resize, the drawing primitives, ``visualize_detection``
on the whole image (its cv2 5 text included), ``im_detect_single`` on JPEG and PNG files, and
``import_mxnet`` -> ``multi_demo`` in-process (resnet-18_multi 128x256).

Two cv2 facts the tests rely on (cv2 5.0.0 here): an exact 2x downscale
with ``INTER_LINEAR`` gives ``INTER_AREA``'s pixels (cv2 switches to it);
at other factors cv2's uint8 bilinear is fixed point (11-bit weights), which
``resize_linear`` reproduces bit for bit."""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import cv2

from dspnet_tpu.api import create_model as jax_create_model
from dspnet_tpu.detect.detector import Detector as JaxDetector
from dspnet_tpu.utils import mxnet_import as jmx
from dspnet_torch.api import create_model
from dspnet_torch.cli import multi_demo
from dspnet_torch.data import avi, image_io, jpeg, mpeg4_cuda
from dspnet_torch.data.cs_labels import DET_CLASSES
from dspnet_torch.data.device_pipeline import resize_area, resize_linear
from dspnet_torch.detect.detector import Detector
from dspnet_torch.tools import import_mxnet
from dspnet_torch.utils import draw
from dspnet_torch.utils.convert import load_flax_variables
from tests.torch_parity import random_flax_variables

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

H, W = 128, 256
VIDEO_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "video"


@pytest.mark.parametrize("src,dst", [((1024, 2048), (512, 1024)), ((256, 512), (128, 256)),
                                     ((300, 500), (128, 256)), ((720, 1280), (512, 1024)),
                                     ((37, 53), (128, 256)), ((57, 91), (128, 256)), ((33, 65), (16, 32)),
                                     ((10, 7), (3, 5)), ((1, 1), (4, 4)), ((61, 97), (61, 97))])
def test_resize_linear_equals_cv2(src, dst):
    """cv2.resize(INTER_LINEAR) bit for bit: at 2x (cv2's INTER_AREA), at
    non-integer down- and up-scales, at odd sizes and at 1 pixel."""
    img = np.random.RandomState(src[0]).randint(0, 256, src + (3,)).astype(np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = resize_linear(torch.from_numpy(img), dst)
    assert got.dtype == torch.uint8 and got.shape == dst + (3,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(resize_linear(torch.from_numpy(img)[None].repeat(2, 1, 1, 1), dst)[1].numpy(),
                                  want)
    if src == (2 * dst[0], 2 * dst[1]):
        np.testing.assert_array_equal(want, cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA))
        np.testing.assert_array_equal(resize_area(torch.from_numpy(img), dst).numpy(), want)


@pytest.mark.parametrize("thickness", [1, 2, -1])
def test_rectangle_equals_cv2(thickness):
    """cv2.rectangle's pixels at thickness 1, 2 (corners included: the
    pinned difference is 0 pixels) and filled, over random corners in any
    order, partly or wholly outside the image, and degenerate ones."""
    rng = np.random.RandomState(thickness + 5)
    for _ in range(200):
        img = rng.randint(0, 256, (40, 60, 3)).astype(np.uint8)
        want = img.copy()
        p1 = tuple(int(v) for v in rng.randint(-10, 70, 2))
        p2 = tuple(int(v) for v in (p1 + rng.randint(-6, 6, 2) if rng.rand() < 0.3 else rng.randint(-10, 70, 2)))
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        cv2.rectangle(want, p1, p2, color, thickness)
        np.testing.assert_array_equal(draw.rectangle(img, p1, p2, color, thickness), want, err_msg=f"{p1} {p2}")


def test_add_weighted_and_seg_overlay_equal_cv2():
    rng = np.random.RandomState(0)
    a, b = (rng.randint(0, 256, (31, 47, 3)).astype(np.uint8) for _ in range(2))
    for alpha, beta, gamma in ((0.5, 0.5, 0.0), (0.3, 0.7, 0.0), (1.0, 1.0, 10.0), (0.25, 0.5, -3.0)):
        np.testing.assert_array_equal(draw.add_weighted(a, alpha, b, beta, gamma),
                                      cv2.addWeighted(a, alpha, b, beta, gamma))
    seg = rng.randint(0, 19, (8, 12)).astype(np.uint8)
    seg[0, 0] = 255
    pal = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    seg_bgr = cv2.resize(pal[seg][:, :, ::-1], (47, 31), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(draw.seg_overlay(a, seg, pal, 0.5), cv2.addWeighted(a, 0.5, seg_bgr, 0.5, 0))


def _jax_detector(classes=DET_CLASSES):
    return JaxDetector(None, None, np.zeros((1, 4), np.float32), (H, W), classes=classes)


def test_visualize_detection_equals_jax_outside_the_text_boxes():
    """The JAX Detector's cv2 drawing and the port's on the same image, dets
    and seg map: equal bit for bit on the whole image, the labels' text
    included (``utils/text.py``; the name is older than that)."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (256, 512, 3)).astype(np.uint8)
    seg = rng.randint(0, 19, (64, 128)).astype(np.uint8)
    rows = []
    for k in range(12):
        x0, y0 = rng.uniform(0, 0.8, 2)
        w, h = rng.uniform(0.05, 0.3, 2)
        rows.append([k % 8, rng.uniform(0.5, 1.0), x0, y0, min(x0 + w, 1.0), min(y0 + h, 1.0), rng.uniform(0, 0.5)])
    rows.append([-1, 0.9, 0.1, 0.1, 0.2, 0.2, 0.1])  # suppressed: not drawn
    rows.append([3, 0.2, 0.1, 0.1, 0.2, 0.2, 0.1])  # under the threshold: not drawn
    dets = np.asarray(rows, np.float32)
    bundle = create_model("resnet-18_multi", (H, W), device="cpu")
    port = Detector(bundle.model, bundle.anchors, (H, W), device="cpu", classes=DET_CLASSES)
    for s in (seg, None):
        want = _jax_detector().visualize_detection(img, dets, s, thresh=0.6)
        got = port.visualize_detection(img, dets, s, thresh=0.6)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, img)


def test_label_box_outside_the_text_equals_jax_put_text():
    """``draw.label_box`` against ``dspnet_tpu/utils/misc.py::put_text``:
    equal bit for bit on the whole image, banner and text included (34x9
    for "car 12m" in ``FONT_HERSHEY_PLAIN`` 0.6; the name is older than
    that)."""
    from dspnet_tpu.utils.misc import put_text

    img = np.random.RandomState(1).randint(0, 256, (80, 120, 3)).astype(np.uint8)
    assert cv2.getTextSize("car 12m", cv2.FONT_HERSHEY_PLAIN, 0.6, 1) == ((34, 9), 1)
    for text, bbox in (("car 12m", (20, 30, 90, 70)), ("person", (5, 15, 60, 40)), ("truck 7m", (-4, 6, 50, 30))):
        want = put_text(img.copy(), text, bbox, (0, 255, 0))
        got = draw.label_box(img.copy(), text, bbox, (0, 255, 0))
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """resnet-18_multi at 128x256 on seeded weights in both packages, and a
    few image files: JPEG 4:2:0 at 2x (the area path), JPEG at a
    non-integer factor, a PNG."""
    root = tmp_path_factory.mktemp("demo")
    bundle = jax_create_model("resnet-18_multi", (H, W))
    variables = random_flax_variables(bundle.model, (1, H, W, 3), seed=31, train=False)
    port = create_model("resnet-18_multi", (H, W), device="cpu")
    load_flax_variables(port.model, variables)
    rng = np.random.RandomState(2)
    paths = []
    for name, hw in (("twice.jpg", (256, 512)), ("odd.jpg", (150, 333)), ("plain.png", (100, 300))):
        img = cv2.GaussianBlur(rng.randint(0, 256, hw + (3,)).astype(np.uint8), (7, 7), 3)
        paths.append(image_io.imwrite(str(root / name), img))
    jdet = JaxDetector(bundle.model, variables, bundle.anchors, (H, W), classes=DET_CLASSES)
    pdet = Detector(port.model, port.anchors, (H, W), device="cpu", classes=DET_CLASSES)
    return root, variables, jdet, pdet, paths


def test_im_detect_single_matches_jax(served):
    """``im_detect_single`` on JPEG and PNG files and on an array: the port
    reads and resizes to cv2's pixels (``transform`` too), then the det rows
    match the JAX Detector's within 1e-4 with ids equal, the seg maps
    equal."""
    _, _, jdet, pdet, paths = served
    for p in paths:
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(pdet.read_image(p).numpy(), img)
        np.testing.assert_array_equal(pdet.transform(img), jdet.transform(img))
        for src in (p, img):
            want = jdet.im_detect_single(src)
            got = pdet.im_detect_single(src)
            np.testing.assert_array_equal(got[1], want[1])
            assert got[0].shape == want[0].shape
            np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
            np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["arith_seq_420_street.jpg", "arith_prog_rst1.jpg", "arith_seq_cmyk.jpg",
                                  "lossless_rgb_p5.jpg", "samp_4x1_1x1.jpg", "samp_1x2_1x1.jpg",
                                  "prog_rst2_420.jpg", "samp_2x2_1x1.jpg"])
def test_im_detect_single_on_jpeg_forms_matches_jax(served, name):
    """``im_detect_single`` on the committed arithmetic-coded, lossless,
    4:1:1, 4:4:0 and progressive-with-restart files: the port reads cv2's
    pixels, and its det rows and seg map match the JAX Detector's as on any
    other file."""
    _, _, jdet, pdet, _ = served
    path = str(Path(__file__).resolve().parent / "fixtures" / "jpeg_forms" / name)
    np.testing.assert_array_equal(pdet.read_image(path).numpy(), cv2.imread(path, cv2.IMREAD_COLOR))
    want = jdet.im_detect_single(path)
    got = pdet.im_detect_single(path)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)


def test_detect_and_visualize_writes_each_image(served, tmp_path):
    """One ``<stem>_out.jpg`` per input (the JAX demo's names): the bytes of
    the port's encoder (q95 4:2:0) on ``visualize_detection`` of
    ``im_detect_single``'s results, at the input's size; an MP4 (mp4v, the
    committed clip) is read into ``detection_out.mp4``, an H.264 one raises
    naming its codec, and a webcam id raises saying why
    (``tests/test_torch_video.py`` holds the video branch against JAX)."""
    _, _, jdet, pdet, paths = served
    written = pdet.detect_and_visualize(paths, str(tmp_path / "port"), thresh=0.3)
    want = jdet.detect_and_visualize(paths, str(tmp_path / "jax"), thresh=0.3)
    assert [os.path.basename(w) for w in written] == [os.path.basename(w) for w in want]
    for w, p in zip(written, paths):
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        vis = pdet.visualize_detection(img, *pdet.im_detect_single(p), thresh=0.3)
        assert open(w, "rb").read() == jpeg.encode(vis, 95)
        assert image_io.imread(w).shape == img.shape
    shutil.copy(VIDEO_FIXTURES / "mp4v.mp4", tmp_path / "clip.mp4")
    assert pdet.detect_and_visualize(str(tmp_path / "clip.mp4"), str(tmp_path)) == [
        str(tmp_path / "detection_out.mp4")]
    data = (tmp_path / "clip.mp4").read_bytes()
    (tmp_path / "h264.mp4").write_bytes(data.replace(b"mp4v", b"avc1"))
    with pytest.raises(avi.VideoError, match="video coded as H.264 .*mp4v or Motion-JPEG"):
        pdet.detect_and_visualize(str(tmp_path / "h264.mp4"), str(tmp_path))
    with pytest.raises(NotImplementedError, match="webcam 0 .*camera"):
        pdet.detect_and_visualize(0, str(tmp_path))


def test_import_mxnet_then_multi_demo(served, tmp_path, monkeypatch):
    """A JAX-written .params -> the port's import tool -> ``multi_demo.main``
    (--device cpu): the written files decode to the inputs' sizes; bf16
    serving writes the same files list; --seg-fast serves the fast seg head
    from the same checkpoint; ``--images clip.avi`` (the committed cv2-written
    Motion-JPEG clip) writes ``detection_out.mp4``, its 4 frames at the
    clip's size and 25 fps."""
    _, variables, _, _, paths = served
    monkeypatch.chdir(tmp_path)
    args, auxs = jmx.export_multitask(variables["params"], variables["batch_stats"], "resnet-18_multi", H)
    jmx.save_params(str(tmp_path / "ref-0003.params"), args, auxs)
    net = ["--network", "resnet-18_multi", "--data-shape", f"3,{H},{W}", "--model-dir", str(tmp_path / "model"),
           "--device", "cpu"]
    import_mxnet.main(net + ["--params", str(tmp_path / "ref-0003.params"), "--epoch", "3"])
    for dtype in ("float32", "bfloat16"):
        out = tmp_path / dtype
        written = multi_demo.main(net + ["--images", ",".join(paths), "--out-dir", str(out), "--dtype", dtype,
                                         "--vis-thresh", "0.0"])
        assert [os.path.basename(w) for w in written] == ["twice_out.jpg", "odd_out.jpg", "plain_out.jpg"]
        for w, p in zip(written, paths):
            assert jpeg.read_header(open(w, "rb").read())[:2] == cv2.imread(p).shape[:2]
    # --seg-fast serves the score-then-upsample head from the same checkpoint
    written = multi_demo.main(net + ["--images", paths[0], "--out-dir", str(tmp_path / "fast"), "--seg-fast"])
    assert [os.path.basename(w) for w in written] == ["twice_out.jpg"]
    shutil.copy(VIDEO_FIXTURES / "cv2_mjpeg.avi", tmp_path / "clip.avi")
    written = multi_demo.main(net + ["--images", "clip.avi", "--out-dir", str(tmp_path / "video")])
    assert written == [str(tmp_path / "video" / "detection_out.mp4")]
    with avi.open_video(written[0]) as reader:
        assert (len(reader), reader.stream.width, reader.stream.height, reader.stream.fps) == (4, 256, 128, 25.0)
        dec = mpeg4_cuda.Decoder("cpu", reader.stream.extradata, reader.stream.fourcc)
        assert [f.shape for f in dec.decode(list(reader))] == [(128, 256, 3)] * 4


def test_slice_modules_import_no_jax_cv2_or_pil():
    """The modules of this slice, the demo CLI and the import tool load none
    of jax, flax, cv2, PIL or dspnet_tpu (the card's machine has none)."""
    import subprocess
    import sys

    modules = ["dspnet_torch.utils.mxnet_import", "dspnet_torch.utils.transfer", "dspnet_torch.tools.import_mxnet",
               "dspnet_torch.utils.draw", "dspnet_torch.utils.profiler", "dspnet_torch.detect.pipeline",
               "dspnet_torch.detect.detector", "dspnet_torch.cli.multi_demo", "dspnet_torch.cli.multi_train",
               "dspnet_torch.data.jpeg_cuda", "dspnet_torch.data.device_pipeline", "dspnet_torch.data.avi",
               "dspnet_torch.detect.video"]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import dspnet_torch; dspnet_torch.ServingPipeline\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2', 'PIL', 'dspnet_tpu'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
