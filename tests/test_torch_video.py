"""The video branch of the port's demo on the CPU against cv2 and the JAX
package: ``data/avi.py`` (Motion-JPEG AVI read and written) against cv2's
two backends, the JAX ``detect_and_visualize`` video branch against
``Detector.detect_and_visualize`` on a Motion-JPEG AVI and on a cv2-written
mp4v MP4 (resnet-18_multi at 128x256, 256x512 frames), the port's
``detection_out.mp4`` read back by cv2, the second host NMS at 0.95, the seg
overlay as torch ops, and the refusals (H.264, HEVC, AV1 and VP9 MP4s by
codec, a foreign AVI fourcc, an interlaced field pair, a webcam).

The JAX branch reads through ``cv2.VideoCapture``, whose backend cv2
chooses; for the Motion-JPEG clip it is pinned here to cv2's own Motion-JPEG
reader (``CAP_OPENCV_MJPEG``, libjpeg's pixels), which the port follows.
cv2's FFmpeg backend decodes the same frames to other pixels: the gap is
measured and bounded by ``test_ffmpeg_backend_gap``. The mp4v clip goes
through FFmpeg's ``mpeg4`` decoder (``CAP_FFMPEG``), which the port's
MPEG-4 decoder follows bit for bit.
"""

import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cv2

from dspnet_tpu.api import create_model as jax_create_model
from dspnet_tpu.detect import detector as jax_detector_module
from dspnet_tpu.detect.detector import Detector as JaxDetector
from dspnet_tpu.ops.nms import nms as jax_nms
from dspnet_torch.api import create_model
from dspnet_torch.data import avi, jpeg, jpeg_cuda, mp4, mpeg4, mpeg4_cuda, synthetic
from dspnet_torch.data.cs_labels import DET_CLASSES, train_id_palette
from dspnet_torch.detect import video
from dspnet_torch.detect.detector import Detector
from dspnet_torch.utils import draw
from dspnet_torch.utils.convert import load_flax_variables
from tests.torch_parity import random_flax_variables

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "video"
H, W = 128, 256
FRAME_HW = (256, 512)
THRESH = 0.05  # low enough that random weights draw boxes and texts


def _frames(seed: int, n: int, hw=FRAME_HW):
    """n textured street scenes, each moved 8 pixels from the last."""
    rng = np.random.RandomState(seed)
    img = synthetic.make_example(rng, (hw[0], hw[1] + 8 * n), 6)[0].astype(np.float32)
    img += synthetic.texture_offsets(rng, img.shape[:2])
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return [np.ascontiguousarray(img[:, 8 * i:8 * i + hw[1]]) for i in range(n)]


def _cv2_write(path, frames):
    """An MJPG AVI at 25 fps from cv2's own writer."""
    writer = cv2.VideoWriter(str(path), cv2.CAP_OPENCV_MJPEG, cv2.VideoWriter_fourcc(*"MJPG"), 25,
                             (frames[0].shape[1], frames[0].shape[0]))
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()
    return str(path)


def _cv2_read(path, api):
    """(frames, fps, count, (width, height)) through one cv2 backend."""
    cap = cv2.VideoCapture(str(path), api)
    assert cap.isOpened(), (path, api)
    props = (cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
             (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return (frames, *props)


def _imdecode(data: bytes):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """resnet-18_multi at 128x256 on the same seeded weights in both
    packages, and a 5-frame 256x512 clip from cv2's own MJPEG writer."""
    root = tmp_path_factory.mktemp("video")
    bundle = jax_create_model("resnet-18_multi", (H, W))
    variables = random_flax_variables(bundle.model, (1, H, W, 3), seed=37, train=False)
    port = create_model("resnet-18_multi", (H, W), device="cpu")
    load_flax_variables(port.model, variables)
    jdet = JaxDetector(bundle.model, variables, bundle.anchors, (H, W), classes=DET_CLASSES)
    pdet = Detector(port.model, port.anchors, (H, W), device="cpu", classes=DET_CLASSES)
    clip = _cv2_write(root / "clip.avi", _frames(3, 5))
    return root, jdet, pdet, clip


# ------------------------------------------------------------ the JAX branch


def _jax_branch_vs_port(jdet, pdet, clip, api, tmp_path, monkeypatch):
    """The JAX ``detect_and_visualize`` on ``clip``, its ``VideoCapture``
    pinned to the cv2 backend ``api`` and its ``VideoWriter`` replaced by a
    recorder of the frames handed to ``write``, against the port's rendered
    frames on the same weights (the comparison of the test below); returns
    the port's rendered frames."""
    real_capture = cv2.VideoCapture
    recorded, writers = [], []

    class Recorder:
        def __init__(self, path, fourcc, fps, size):
            writers.append((os.path.basename(path), fps, size))

        def write(self, img):
            recorded.append(np.array(img, copy=True))

        def release(self):
            pass

    jax_rows, port_rows = [], []
    jax_vis = JaxDetector.visualize_detection

    def jax_visualize(self, img, dets, seg=None, thresh=0.6, seg_alpha=0.5):
        jax_rows.append(np.array(dets, copy=True))
        return jax_vis(self, img, dets, seg, thresh, seg_alpha)

    port_draw = Detector.draw_boxes

    def port_draw_boxes(self, img, dets, thresh=0.6):
        port_rows.append(np.array(dets, copy=True))
        return port_draw(self, img, dets, thresh)

    monkeypatch.setattr(jax_detector_module.cv2, "VideoCapture", lambda src: real_capture(src, api))
    monkeypatch.setattr(jax_detector_module.cv2, "VideoWriter", Recorder)
    monkeypatch.setattr(JaxDetector, "visualize_detection", jax_visualize)
    monkeypatch.setattr(Detector, "draw_boxes", port_draw_boxes)
    want = jdet.detect_and_visualize(clip, str(tmp_path / "jax"), thresh=THRESH, video_nms=0.95)
    assert [os.path.basename(w) for w in want] == ["detection_out.mp4"] and writers[0][1:] == (25, (512, 256))
    with avi.open_video(clip) as reader:
        got = list(video.render(pdet, reader, THRESH, 0.95))
    monkeypatch.undo()
    assert len(got) == len(recorded) == 5 and len(port_rows) == len(jax_rows) == 5
    drawn = shifted = 0
    for i, (g, w, pr, jr) in enumerate(zip(got, recorded, port_rows, jax_rows)):
        assert g.shape == w.shape == FRAME_HW + (3,) and g.dtype == w.dtype == np.uint8
        assert pr.shape == jr.shape, i
        np.testing.assert_array_equal(pr[:, 0], jr[:, 0])
        np.testing.assert_allclose(pr, jr, rtol=0, atol=1e-4)
        inside = np.zeros(FRAME_HW + (3,), np.uint8)
        for r, q in zip(pr, jr):
            if r[1] < THRESH:
                continue
            drawn += 1
            # rows equal within 1e-4 can put a corner on either side of a
            # pixel edge: such a box's bands and its label, anchored at the
            # corner, both ways, are left out
            corners = [(int(x[2] * FRAME_HW[1]), int(x[3] * FRAME_HW[0]), int(x[4] * FRAME_HW[1]),
                        int(x[5] * FRAME_HW[0])) for x in (r, q)]
            if corners[0] != corners[1]:
                shifted += 1
                for x, (x1, y1, x2, y2) in zip((r, q), corners):
                    draw.rectangle(inside, (x1, y1), (x2, y2), (1, 1, 1), 2)
                    label = f"{DET_CLASSES[int(x[0])]} {x[6] * 255.0:.0f}m"
                    (tw, th), bl = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
                    oy = max(12, y1 - 4)
                    inside[max(oy - th, 0):oy + bl + 1, max(x1, 0):x1 + tw + 1] = 1
        inside = inside[..., 0].astype(bool)
        np.testing.assert_array_equal(g[~inside], w[~inside], err_msg=f"frame {i}")
    print(f"{drawn} boxes drawn in 5 frames, {shifted} a pixel apart between the two packages' rows")
    assert drawn > 0 and shifted <= drawn // 100
    return got


def test_jax_branch_equals_the_port_outside_the_text_boxes(served, tmp_path, monkeypatch):
    """The JAX ``detect_and_visualize`` on a cv2-written MJPEG AVI, its
    ``VideoCapture`` pinned to ``CAP_OPENCV_MJPEG`` and its ``VideoWriter``
    replaced by a recorder of the frames handed to ``write``, against the
    port's rendered frames on the same weights: as many, in the same order,
    equal bit for bit, the labels' text included (the name is older than
    that), outside the bands of a box whose corner lands a pixel apart (rows equal within 1e-4 on either side of a pixel
    edge: at most 1 box in 100); the rows each side drew (after the 0.95
    NMS) agree within 1e-4, ids equal; the port writes
    ``detection_out.mp4`` as the JAX branch names it, mp4v that cv2 reads
    with the same count, 25 fps and the frames' size (:func:`_check_written`)."""
    _, jdet, pdet, clip = served
    got = _jax_branch_vs_port(jdet, pdet, clip, cv2.CAP_OPENCV_MJPEG, tmp_path, monkeypatch)
    written = pdet.detect_and_visualize(clip, str(tmp_path / "port"), thresh=THRESH)
    assert written == [str(tmp_path / "port" / "detection_out.mp4")]
    _check_written(written[0], got)


def _check_written(path, rendered):
    """The port's ``detection_out.mp4``: cv2 (FFmpeg) reads as many frames
    as were rendered, at 25 fps and their size; the port's MPEG-4 decoder
    returns exactly cv2's frames; their PSNR against the rendered frames is
    no lower than that of cv2's own mp4v writer on the same frames less 1 dB
    (both printed: chroma subsampling of the saturated scenes holds both
    near 20 dB)."""
    frames, fps, count, size = _cv2_read(path, cv2.CAP_FFMPEG)
    h, w = rendered[0].shape[:2]
    assert (len(frames), fps, count, size) == (len(rendered), 25.0, len(rendered), (w, h))
    with avi.open_video(path) as reader:
        assert (reader.stream.codec, reader.stream.fourcc) == ("mpeg4", "mp4v")
        dec = mpeg4_cuda.Decoder("cpu", reader.stream.extradata, reader.stream.fourcc)
        mine = [f.numpy() for f in dec.decode(list(reader))]
    assert len(mine) == len(frames) and all(np.array_equal(a, b) for a, b in zip(mine, frames))
    theirs = Path(path).with_name("cv2_writer.mp4")
    writer = cv2.VideoWriter(str(theirs), cv2.VideoWriter_fourcc(*"mp4v"), 25, (w, h))
    for r in rendered:
        writer.write(r)
    writer.release()

    def psnr(decoded):
        return float(np.mean([10 * np.log10(255.0 ** 2 / np.mean((f.astype(np.float64) - r) ** 2))
                              for f, r in zip(decoded, rendered)]))

    port_db, cv2_db = psnr(frames), psnr(_cv2_read(theirs, cv2.CAP_FFMPEG)[0])
    print(f"detection_out.mp4: PSNR {port_db:.2f} dB ({os.path.getsize(path)} bytes); cv2's mp4v writer on the "
          f"same frames {cv2_db:.2f} dB ({os.path.getsize(theirs)} bytes)")
    assert port_db >= cv2_db - 1.0


def test_jax_branch_equals_the_port_on_an_mp4v_clip(served, tmp_path, monkeypatch):
    """The same comparison on a cv2-written mp4v MP4 (the codec the JAX
    branch writes): the JAX branch reads it through cv2's FFmpeg backend
    (``CAP_FFMPEG``, the backend cv2 picks for it), the port through its
    plain MPEG-4 decoder; equal, text included; both name
    ``detection_out.mp4``, and the port's is read back by cv2."""
    _, jdet, pdet, _ = served
    clip = tmp_path / "clip.mp4"
    frames = _frames(3, 5)
    writer = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"mp4v"), 25, (frames[0].shape[1], frames[0].shape[0]))
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()
    got = _jax_branch_vs_port(jdet, pdet, str(clip), cv2.CAP_FFMPEG, tmp_path, monkeypatch)
    written = pdet.detect_and_visualize(str(clip), str(tmp_path / "port"), thresh=THRESH)
    assert written == [str(tmp_path / "port" / "detection_out.mp4")]
    _check_written(written[0], got)


def test_ffmpeg_backend_gap(served):
    """The same clip through cv2's FFmpeg backend: FFmpeg's JPEG decoder is
    not libjpeg's, so its frames differ from the port's (and from cv2's own
    MJPEG reader's) by a measured gap. Measured on this clip (cv2 5.0.0): a
    mean of 1.61 levels, a 99th percentile of 15, a max of 92; the bound
    held here is a mean in (0.5, 3], a 99th percentile <= 32."""
    _, _, _, clip = served
    with avi.open_video(clip) as reader:
        port = np.stack([jpeg.decode(b) for b in reader])
    mjpeg = np.stack(_cv2_read(clip, cv2.CAP_OPENCV_MJPEG)[0])
    np.testing.assert_array_equal(port, mjpeg)
    ffmpeg = np.stack(_cv2_read(clip, cv2.CAP_FFMPEG)[0])
    d = np.abs(ffmpeg.astype(np.int16) - port)
    mean, p99 = float(d.mean()), float(np.percentile(d, 99))
    print(f"FFmpeg backend vs libjpeg: mean {mean:.3f}, p99 {p99:.0f}, max {int(d.max())}")
    assert 0.5 < mean <= 3.0 and p99 <= 32


def test_second_nms_where_the_jax_branch_applies_it():
    """``video.second_nms`` is the JAX branch's step (``detector.py:304-309``,
    written out here): untouched at 0 and 1 rows, ``nms`` at 0.95 over the
    rows' boxes scaled by the data shape and their scores otherwise, kept in
    its order; near-duplicates above 0.95 go, ones below stay."""
    h, w = H, W

    def jax_step(dets, thr):
        if dets.shape[0] > 1:
            scaled = np.hstack([dets[:, 2:6] * np.array([w, h, w, h]), dets[:, 1:2]]).astype(np.float32)
            dets = dets[jax_nms(scaled, thr)]
        return dets

    one = np.array([[2, 0.9, 0.1, 0.2, 0.3, 0.4, 0.1]], np.float32)
    base = [1, 0.8, 0.20, 0.20, 0.60, 0.70, 0.2]
    dup = np.array([base, [1, 0.9, 0.2001, 0.2, 0.6, 0.7, 0.2], [3, 0.7, 0.2, 0.2001, 0.6001, 0.7, 0.3],
                    [1, 0.6, 0.25, 0.25, 0.6, 0.7, 0.2], [5, 0.5, 0.7, 0.1, 0.9, 0.3, 0.4]], np.float32)
    for dets in (np.zeros((0, 7), np.float32), one, dup, dup[::-1].copy()):
        for thr in (0.95, 0.5):
            np.testing.assert_array_equal(video.second_nms(dets, (h, w), thr), jax_step(dets, thr))
    np.testing.assert_array_equal(video.second_nms(one, (h, w), 0.0), one)
    kept = video.second_nms(dup, (h, w), 0.95)
    assert len(kept) == 3 and kept[0, 1] == np.float32(0.9)  # two near-duplicates of the best go


def test_seg_overlay_on_the_device_equals_numpy():
    """``draw.seg_overlay_tensor`` (the video branch's overlay, torch ops)
    equals ``draw.seg_overlay`` (numpy, held to cv2) bit for bit, at the
    demo's 4x and at other ratios, for alphas 0.5, 0.3, 0.7."""
    rng = np.random.RandomState(5)
    pal = train_id_palette()
    for hw, shw in (((256, 512), (32, 64)), ((37, 53), (9, 13)), ((64, 128), (16, 32))):
        img = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
        seg = rng.randint(0, 19, shw).astype(np.uint8)
        seg[0, 0] = 255
        for alpha in (0.5, 0.3, 0.7):
            got = draw.seg_overlay_tensor(torch.from_numpy(img), torch.from_numpy(seg), pal, alpha)
            np.testing.assert_array_equal(got.numpy(), draw.seg_overlay(img, seg, pal, alpha))


# ------------------------------------------------------------ the reader


def _without_idx1(data: bytes) -> bytes:
    """An AVI with its idx1 chunk removed and the RIFF size patched."""
    i = data.rindex(b"idx1")
    (size,) = struct.unpack("<I", data[i + 4:i + 8])
    out = data[:i] + data[i + 8 + size:]
    return out[:4] + struct.pack("<I", len(out) - 8) + out[8:]


@pytest.mark.parametrize("name", ["cv2_mjpeg.avi", "ffmpeg_mjpeg.avi", "dht_less.avi"])
@pytest.mark.parametrize("idx1", [True, False])
def test_reader_equals_cv2(tmp_path, name, idx1):
    """The committed fixtures (cv2's own writer, cv2's FFmpeg writer, and a
    copy without Huffman tables), with and without their idx1: ``avi.py``
    gives the frames ``frames.json`` recorded (the writers' chunks), cv2's
    count, fps and size, and each frame decodes in the plain decoder to
    ``cv2.imdecode``'s pixels; where cv2's own reader opens the file, its
    frames equal those pixels too."""
    meta = json.loads((FIXTURE / "frames.json").read_text())[name]
    data = (FIXTURE / name).read_bytes()
    path = tmp_path / name
    path.write_bytes(data if idx1 else _without_idx1(data))
    with avi.open_video(path) as reader:
        frames = list(reader)
        stream = reader.stream
    assert [hashlib.sha256(f).hexdigest() for f in frames] == meta["sha256"]
    assert (len(frames), stream.width, stream.height, stream.fps, stream.fourcc) == (4, 256, 128, 25.0, "MJPG")
    pixels = [jpeg.decode(f) for f in frames]
    for f, p in zip(frames, pixels):
        np.testing.assert_array_equal(p, _imdecode(f))
    if name == "dht_less.avi":
        assert all(b"\xff\xc4" not in f[:f.index(b"\xff\xda")] for f in frames)
    if idx1:
        got, fps, count, size = _cv2_read(path, cv2.CAP_OPENCV_MJPEG)
        assert (fps, count, size) == (25.0, 4, (256, 128))
        np.testing.assert_array_equal(np.stack(got), np.stack(pixels))


@pytest.mark.parametrize("split", [False, True])
def test_writer_read_by_cv2(tmp_path, split):
    """``avi.AviWriter``'s files, one RIFF and with a forced OpenDML split
    (a segment limit of 20 KB: RIFF AVIX continuations), through cv2's two
    backends: the same count, 25 fps and size; cv2's own reader gives each
    frame's ``cv2.imdecode`` pixels; ``avi.py`` reads back the bytes written,
    also from an odd-sized frame (its pad byte)."""
    frames = [jpeg.encode(f, 90) for f in _frames(9, 6, (96, 160))]
    frames[2] += b"\x00" * (1 - len(frames[2]) % 2)  # an odd size (a byte after EOI): a pad byte follows
    assert len(frames[2]) % 2 == 1
    path = tmp_path / "out.avi"
    with avi.AviWriter(path, 160, 96, 25, _riff_limit=20_000 if split else avi.RIFF_LIMIT) as writer:
        for f in frames:
            writer.write(f)
    data = path.read_bytes()
    assert (data.count(b"AVIX") >= 2) == split
    with avi.open_video(path) as reader:
        assert list(reader) == frames and reader.stream.declared_frames == 6
    for api in (cv2.CAP_OPENCV_MJPEG, cv2.CAP_FFMPEG):
        got, fps, count, size = _cv2_read(path, api)
        assert (len(got), fps, count, size) == (6, 25.0, 6, (160, 96)), api
        if api == cv2.CAP_OPENCV_MJPEG:
            for g, f in zip(got, frames):
                np.testing.assert_array_equal(g, _imdecode(f))


# ------------------------------------------------------------ refusals


def _mp4(fourcc: bytes) -> bytes:
    """The boxes of an MP4 down to one video sample entry of ``fourcc``."""
    def box(kind, body):
        return struct.pack(">I", 8 + len(body)) + kind + body

    entry = box(fourcc, bytes(78))
    stsd = box(b"stsd", bytes(4) + struct.pack(">I", 1) + entry)
    hdlr = box(b"hdlr", bytes(8) + b"vide" + bytes(12) + b"\x00")
    trak = box(b"trak", box(b"mdia", hdlr + box(b"minf", box(b"stbl", stsd))))
    return box(b"ftyp", b"isom" + bytes(4)) + box(b"moov", trak)


def test_refusals(served, tmp_path):
    """MP4s of other codecs are refused by their codec's name (H.264, HEVC,
    AV1 and VP9 sample entries) through ``avi.open_video`` and
    ``detect_and_visualize``, the message saying to write mp4v or
    Motion-JPEG; the committed mp4v clip and an XVID AVI are read; an AVI
    coded otherwise than Motion-JPEG or MPEG-4 Part 2 names its fourcc; an
    interlaced AVI1 field pair is refused; MPEG-4 tools outside Simple
    Profile (a B-VOP, quarter-pel, a packed bitstream) raise by name through
    ``detect_and_visualize``; a webcam id raises and says why; no
    ``detection_out.mp4`` is left behind."""
    _, _, pdet, clip = served
    assert avi.probe_mp4(str(FIXTURE / "mp4v.mp4")) == "mp4v"
    with avi.open_video(FIXTURE / "mp4v.mp4") as reader:
        dec = mpeg4_cuda.Decoder("cpu", reader.stream.extradata, reader.stream.fourcc)
        assert reader.stream.codec == "mpeg4" and len(dec.decode(list(reader))) == len(reader) > 0
    for fourcc, codec in ((b"avc1", "H.264"), (b"hev1", "HEVC"), (b"av01", "AV1"), (b"vp09", "VP9")):
        name = f"{fourcc.decode()}.mp4"
        (tmp_path / name).write_bytes(_mp4(fourcc))
        assert avi.probe_mp4(str(tmp_path / name)) == fourcc.decode()
        want = f"{codec} \\('{fourcc.decode()}'\\).*mp4v or Motion-JPEG"
        with pytest.raises(avi.VideoError, match=want):
            avi.open_video(tmp_path / name)
        with pytest.raises(avi.VideoError, match=want):
            pdet.detect_and_visualize(str(tmp_path / name), str(tmp_path / "out"))
    data = (FIXTURE / "cv2_mjpeg.avi").read_bytes()
    i = data.index(b"strf") + 8 + 16
    (tmp_path / "xvid.avi").write_bytes(data[:i] + b"XVID" + data[i + 4:])
    with avi.open_video(tmp_path / "xvid.avi") as reader:
        assert (reader.stream.codec, reader.stream.fourcc) == ("mpeg4", "XVID")
    (tmp_path / "h264.avi").write_bytes(data[:i] + b"H264" + data[i + 4:])
    with pytest.raises(avi.VideoError, match="H264.*write the clip as mp4v or Motion-JPEG"):
        avi.open_video(tmp_path / "h264.avi")
    field = b"\xff\xd8\xff\xe0\x00\x10AVI1\x01" + bytes(9) + jpeg.encode(np.zeros((8, 16, 3), np.uint8))[2:]
    with avi.AviWriter(tmp_path / "fields.avi", 16, 16) as writer:
        writer.write(field)
    with pytest.raises(avi.VideoError, match="interlaced"):
        list(avi.open_video(tmp_path / "fields.avi"))
    forms = ROOT / "tests" / "fixtures" / "mp4v_forms"
    for name, tool in (("r_bvop.mp4", "B-VOPs"), ("r_quarter_pel.mp4", "quarter-pel"), ("r_packed.mp4", "packed")):
        with pytest.raises(avi.VideoError, match=tool):
            pdet.detect_and_visualize(str(forms / name), str(tmp_path / "out"))
    with pytest.raises(NotImplementedError, match="webcam 0 .*camera.*mp4v or Motion-JPEG"):
        pdet.detect_and_visualize(0, str(tmp_path / "out"))
    with pytest.raises(FileNotFoundError):
        pdet.detect_and_visualize(str(tmp_path / "missing.avi"), str(tmp_path / "out"))
    assert not (tmp_path / "out" / "detection_out.mp4").exists()


def test_the_cpu_path_decodes_and_encodes_with_the_plain_codec(served, tmp_path):
    """On the CPU the video branch decodes with the plain decoder and
    encodes with the MPEG-4 writer on the CPU (their counts move by the
    frames; the card's counts do not), and a DHT-less clip reads as its
    original."""
    _, _, pdet, _ = served
    jpeg.decodes = jpeg.encodes = mpeg4.encodes = 0
    launches, encodes = jpeg_cuda.launches, jpeg_cuda.encodes
    written = pdet.detect_and_visualize(str(FIXTURE / "dht_less.avi"), str(tmp_path), thresh=THRESH)
    assert (jpeg.decodes, jpeg.encodes, mpeg4.encodes) == (4, 0, 4)
    assert (jpeg_cuda.launches, jpeg_cuda.encodes) == (launches, encodes)
    with avi.open_video(FIXTURE / "dht_less.avi") as bare, avi.open_video(FIXTURE / "cv2_mjpeg.avi") as full:
        for a, b in zip(bare, full):
            np.testing.assert_array_equal(jpeg.decode(a), jpeg.decode(b))
    with avi.open_video(written[0]) as reader:
        assert (len(reader), reader.stream.width, reader.stream.height) == (4, 256, 128)
    assert jpeg_cuda.encode(torch.zeros(8, 16, 3, dtype=torch.uint8)) == jpeg.encode(np.zeros((8, 16, 3), np.uint8))


def test_video_modules_import_no_jax_cv2_or_pil():
    """``data/avi.py``, ``data/mp4.py``, ``data/mpeg4.py``,
    ``data/mpeg4_cuda.py`` and ``detect/video.py`` (and the demo CLI that
    reaches them) load none of jax, flax, cv2, PIL or dspnet_tpu."""
    modules = ["dspnet_torch.data.avi", "dspnet_torch.data.mp4", "dspnet_torch.data.mpeg4",
               "dspnet_torch.data.mpeg4_cuda", "dspnet_torch.detect.video", "dspnet_torch.cli.multi_demo"]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'cv2', 'PIL', 'dspnet_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
