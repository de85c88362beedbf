"""How far the two packages' detection rows lie apart on H.264 clips of the
writer's random syntax, where the frames both read are equal bit for bit.

    python -m pytest tests/h264_row_gap.py -q -s

(needs cv2 and JAX, like the tier-1 video tests; not collected by the
tier-1 run, whose pattern is ``test_*.py``). For each seed it writes a
256x512 Main profile CABAC stream (``make_h264_fixtures.stream``, I P B B
P, random macroblock syntax), asserts that the port's decoder returns cv2's
frames, runs the JAX ``detect_and_visualize`` and the port's
``video.render`` on it with the same weights as ``test_torch_video.py``,
and prints, per frame, the largest difference between the rows each side
drew and its column. Since both sides read the same pixels, a difference
is made after the decode: in the two packages' float32 network and box
arithmetic."""

import numpy as np
import pytest

from tests import h264_writer as W
from tests import make_h264_fixtures as F
from tests.test_torch_h264 import cv2_frames, port_frames
from tests.test_torch_video import (THRESH, Detector, JaxDetector, avi, cv2, jax_detector_module,  # noqa: F401
                                    served, video)

COLUMNS = ("class", "score", "x1", "y1", "x2", "y2", "depth")


def _rows(jdet, pdet, clip, monkeypatch):
    """The rows each package drew on each frame of ``clip``."""
    real = cv2.VideoCapture
    jax_rows, port_rows = [], []

    class Recorder:
        def __init__(self, *args):
            pass

        def write(self, img):
            pass

        def release(self):
            pass

    jax_vis, port_draw = JaxDetector.visualize_detection, Detector.draw_boxes

    def jax_visualize(self, img, dets, seg=None, thresh=0.6, seg_alpha=0.5):
        jax_rows.append(np.array(dets, copy=True))
        return jax_vis(self, img, dets, seg, thresh, seg_alpha)

    def port_draw_boxes(self, img, dets, thresh=0.6):
        port_rows.append(np.array(dets, copy=True))
        return port_draw(self, img, dets, thresh)

    monkeypatch.setattr(jax_detector_module.cv2, "VideoCapture", lambda src: real(src, cv2.CAP_FFMPEG))
    monkeypatch.setattr(jax_detector_module.cv2, "VideoWriter", Recorder)
    monkeypatch.setattr(JaxDetector, "visualize_detection", jax_visualize)
    monkeypatch.setattr(Detector, "draw_boxes", port_draw_boxes)
    jdet.detect_and_visualize(clip, str(clip) + ".jax", thresh=THRESH, video_nms=0.95)
    with avi.open_video(clip) as reader:
        list(video.render(pdet, reader, THRESH, 0.95))
    monkeypatch.undo()
    return jax_rows, port_rows


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_row_gap_on_random_syntax(served, tmp_path, monkeypatch, seed):  # noqa: F811
    _, jdet, pdet, _ = served
    clip = tmp_path / "random.mp4"
    _, params, pics, size = F.stream(seed, dict(mb_width=32, mb_height=16), F.CABAC, F.gop(5), dict(t8=0.0))
    W.write_mp4(clip, [W.length_prefixed(p) for p in pics], size[0], size[1], W.avcc(params[:1], params[1:]))
    want, mine = cv2_frames(clip), port_frames(clip)
    assert len(mine) == len(want) == 5 and all(np.array_equal(a, b) for a, b in zip(mine, want))
    jax_rows, port_rows = _rows(jdet, pdet, str(clip), monkeypatch)
    assert len(jax_rows) == len(port_rows) == 5
    for k, (j, p) in enumerate(zip(jax_rows, port_rows)):
        assert j.shape == p.shape and np.array_equal(j[:, 0], p[:, 0])
        d = np.abs(j.astype(np.float64) - p)
        i, c = np.unravel_index(d.argmax(), d.shape)
        print(f"seed {seed} frame {k}: {len(j)} rows, largest difference {d.max():.3e} in {COLUMNS[c]} of row {i} "
              f"(JAX {j[i, c]:.7f}, port {p[i, c]:.7f}); rows past 1e-4: {int((d > 1e-4).any(1).sum())}")
