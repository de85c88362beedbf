"""Write the committed video fixtures under ``tests/fixtures/video/``: small
Motion-JPEG AVIs from cv2's two writers, a copy without Huffman tables, and
an mp4v MP4, so that the video demo can be tried on the card's machine,
which has no cv2.

    python tests/make_video_fixtures.py

* ``cv2_mjpeg.avi``: cv2's own writer (``CAP_OPENCV_MJPEG``, fourcc MJPG,
  25 frames per second);
* ``ffmpeg_mjpeg.avi``: cv2's FFmpeg writer (``CAP_FFMPEG``, MJPG, 25 fps);
* ``dht_less.avi``: ``cv2_mjpeg.avi``'s frames with every DHT segment
  removed (the form of many Motion-JPEG cameras' frames), written by the
  port's ``data/avi.py`` writer;
* ``mp4v.mp4``: cv2's FFmpeg writer, fourcc mp4v (what the JAX demo writes),
  for the refusal by codec;
* ``jpeg_forms/``: still JPEGs of the forms the plain decoder learned, for
  the card's decoder: cv2's progressive files (q75 4:2:0, q95 4:4:4, gray,
  one with restart intervals), a baseline file without DHT segments,
  Pillow's RGB-coded file (``keep_rgb``, Adobe transform 0), its CMYK files
  (4:4:4, and with three planes at half size) and a YCCK file (the 4:4:4
  CMYK file marked Adobe transform 2).

Each clip holds ``FRAMES`` street scenes of ``HW`` from seed 13 with a light
photographic texture (``synthetic.make_example`` and
``synthetic.texture_offsets`` at a third of their amplitude), moving by a
few pixels a frame. ``frames.json`` records each file's frame count, size,
fps and each frame's sha256, and each still's form. The files stay under 300
KB together.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "video"
HW, FRAMES, FPS, SEED = (128, 256), 4, 25, 13


def scenes():
    from dspnet_torch.data import synthetic

    rng = np.random.RandomState(SEED)
    img = synthetic.make_example(rng, (HW[0], HW[1] + 4 * FRAMES), 4)[0].astype(np.float32)
    img += synthetic.texture_offsets(rng, img.shape[:2]) / 3
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return [np.ascontiguousarray(img[:, 4 * i:4 * i + HW[1]]) for i in range(FRAMES)]


def strip_dht(data: bytes) -> bytes:
    """A JPEG with its DHT segments before the first scan removed."""
    import struct

    out, pos = bytearray(data[:2]), 2
    while True:
        marker, (length,) = data[pos + 1], struct.unpack(">H", data[pos + 2:pos + 4])
        if marker != 0xC4:
            out += data[pos:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDA:
            return bytes(out) + data[pos:]


def write_forms(img: np.ndarray) -> dict:
    """The stills of ``jpeg_forms/`` from one frame; returns {name: form}."""
    import io

    import cv2
    from PIL import Image

    from dspnet_torch.data import jpeg

    forms = FIXTURE / "jpeg_forms"
    forms.mkdir(exist_ok=True)
    prog = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    out = {
        "progressive_q75_420.jpg": cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 75, *prog])[1].tobytes(),
        "progressive_q95_444.jpg": cv2.imencode(".jpg", img, [
            cv2.IMWRITE_JPEG_QUALITY, 95, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            *prog])[1].tobytes(),
        "progressive_gray.jpg": cv2.imencode(".jpg", img[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 90, *prog])[1].tobytes(),
        "progressive_rst.jpg": cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                                         cv2.IMWRITE_JPEG_RST_INTERVAL, 3, *prog])[1].tobytes(),
        "dht_less.jpg": strip_dht(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])[1].tobytes()),
    }

    def pillow(arr, mode, **kw):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, "JPEG", **kw)
        return buf.getvalue()

    out["rgb.jpg"] = pillow(np.ascontiguousarray(img[..., ::-1]), "RGB", quality=90, keep_rgb=True)
    cmyk = np.asarray(Image.fromarray(np.ascontiguousarray(img[..., ::-1])).convert("CMYK"))
    out["cmyk444.jpg"] = pillow(cmyk, "CMYK", quality=90, subsampling=0)
    out["cmyk420.jpg"] = pillow(cmyk, "CMYK", quality=90, subsampling=2)
    i = out["cmyk444.jpg"].index(b"Adobe") + 11
    out["ycck444.jpg"] = out["cmyk444.jpg"][:i] + b"\x02" + out["cmyk444.jpg"][i + 1:]
    meta = {}
    for name, data in out.items():
        (forms / name).write_bytes(data)
        info = jpeg.read_info(data)
        assert np.array_equal(jpeg.decode(data), cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED))
        meta[name] = {"color": info.color, "progressive": info.progressive, "upsampling": info.upsampling}
    return meta


def main():
    import cv2

    sys.path.insert(0, str(ROOT))
    from dspnet_torch.data import avi

    FIXTURE.mkdir(parents=True, exist_ok=True)
    frames = scenes()
    size = (HW[1], HW[0])
    for name, api, fourcc in (("cv2_mjpeg.avi", cv2.CAP_OPENCV_MJPEG, "MJPG"),
                              ("ffmpeg_mjpeg.avi", cv2.CAP_FFMPEG, "MJPG"), ("mp4v.mp4", cv2.CAP_FFMPEG, "mp4v")):
        writer = cv2.VideoWriter(str(FIXTURE / name), api, cv2.VideoWriter_fourcc(*fourcc), FPS, size)
        assert writer.isOpened(), name
        for f in frames:
            writer.write(f)
        writer.release()
    with avi.open_video(FIXTURE / "cv2_mjpeg.avi") as reader:
        bare = [strip_dht(f) for f in reader]
    with avi.AviWriter(FIXTURE / "dht_less.avi", HW[1], HW[0], FPS) as writer:
        for f in bare:
            writer.write(f)
    meta = {}
    for name in ("cv2_mjpeg.avi", "ffmpeg_mjpeg.avi", "dht_less.avi"):
        with avi.open_video(FIXTURE / name) as reader:
            meta[name] = {"frames": len(reader), "width": reader.stream.width, "height": reader.stream.height,
                          "fps": reader.stream.fps,
                          "sha256": [hashlib.sha256(f).hexdigest() for f in reader]}
    meta["mp4v.mp4"] = {"fourcc": avi.probe_mp4(str(FIXTURE / "mp4v.mp4"))}
    meta["jpeg_forms"] = write_forms(frames[0])
    (FIXTURE / "frames.json").write_text(json.dumps(meta, indent=1) + "\n")
    total = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    print(f"wrote {FIXTURE}: {total} bytes")
    assert total < 300_000, total


if __name__ == "__main__":
    main()
