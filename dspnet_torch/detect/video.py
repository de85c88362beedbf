"""The video branch of the demo (counterpart of the video branch of
``dspnet_tpu/detect/detector.py::Detector.detect_and_visualize``,
``:284-333``; reference multitask_detector.py:401-458) for Motion-JPEG AVI.

For each frame, in order:

1. its JPEG bytes come from the file (``data/avi.py``, in place of
   ``cv2.VideoCapture``);
2. frames decode in batches on the detector's device (``jpeg_cuda.
   decode_images``: nvJPEG and the colour kernel on the card, a stream
   without Huffman tables getting Annex K's; the plain decoder on the CPU);
3. ``device_pipeline.resize_linear`` takes the frame to the data shape on
   the device (cv2's ``INTER_LINEAR``, its area rule at an exact 2x);
4. ``ServingPipeline(depth=2, raw=True)`` serves it, the full frame as the
   tag (on the card, CUDA graphs replaying the NMS kernel);
5. each result, in submission order: the rows with id >= 0
   (``Detector._filter_rows(det, 0.0)``), then ``ops/nms.py::nms`` at
   ``video_nms`` over the boxes scaled to the data shape's pixels with
   their scores, when there is more than one row (the reference's second
   host NMS), then the seg overlay on the device
   (``draw.seg_overlay_tensor``), one copy to the host, the boxes and texts
   in numpy (``Detector.draw_boxes``);
6. the rendered frame goes back to the device and is encoded there
   (``jpeg_cuda.encode``: nvJPEG on the card, q95 4:2:0; the plain encoder
   on the CPU) and appended to ``detection_out.avi`` (``avi.AviWriter``, 25
   frames per second, the rendered frame's size).

The JAX branch writes ``detection_out.mp4`` as mp4v through cv2; NVENC has
no mp4v encoder and the port writes Motion-JPEG, so the name ends in
``.avi``. :func:`render` yields the rendered frames (numpy BGR) without
encoding them; :func:`detect_video` writes the file.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from dspnet_torch.data import avi, jpeg_cuda
from dspnet_torch.data.device_pipeline import resize_linear
from dspnet_torch.ops.nms import nms as host_nms
from dspnet_torch.utils import draw

#: the output file's name under ``out_dir``
OUT_NAME = "detection_out.avi"
#: frames per second written, as the JAX branch's ``cv2.VideoWriter``
FPS = 25
#: frames decoded together on the device
DECODE_BATCH = 8


def second_nms(dets: np.ndarray, data_shape, video_nms: float) -> np.ndarray:
    """The JAX branch's host NMS over one frame's rows (``:304-309``): with
    more than one row, ``nms`` at ``video_nms`` on the boxes scaled by the
    data shape (width, height) with their scores, in float32; the kept rows
    in its order."""
    if dets.shape[0] <= 1:
        return dets
    h, w = data_shape
    scaled = np.hstack([dets[:, 2:6] * np.array([w, h, w, h]), dets[:, 1:2]]).astype(np.float32)
    return dets[host_nms(scaled, video_nms)]


def _frames(detector, buffers: Iterable[bytes]) -> Iterator[torch.Tensor]:
    """Each frame decoded on the detector's device, ``DECODE_BATCH`` at a time."""
    chunk = []
    for data in buffers:
        chunk.append(data)
        if len(chunk) == DECODE_BATCH:
            yield from jpeg_cuda.decode_images(chunk, detector.device)
            chunk = []
    if chunk:
        yield from jpeg_cuda.decode_images(chunk, detector.device)


def render(detector, buffers: Iterable[bytes], thresh: float = 0.6, video_nms: float = 0.95) -> Iterator[np.ndarray]:
    """The rendered frames, in order, of the JPEG frames ``buffers``
    (steps 2-5 of the module's text): (H, W, 3) uint8 BGR numpy arrays."""
    from dspnet_torch.detect.pipeline import ServingPipeline

    pipe = ServingPipeline(detector, depth=2, raw=True)

    def finish(frame: torch.Tensor, res: dict) -> np.ndarray:
        dets = (detector._filter_rows(res["det"][0], 0.0) if "det" in res else np.zeros((0, 7), np.float32))
        dets = second_nms(dets, detector.data_shape, video_nms)
        if "seg" in res:
            img = draw.seg_overlay_tensor(frame, torch.from_numpy(res["seg"][0]), detector.palette).cpu().numpy()
        else:
            img = frame.cpu().numpy().copy()
        return detector.draw_boxes(img, dets, thresh)

    for frame in _frames(detector, buffers):
        done = pipe.submit(resize_linear(frame, detector.data_shape), tag=frame)
        if done is not None:
            yield finish(*done)
    for frame, res in pipe.drain():
        yield finish(frame, res)


def encode_frame(img: np.ndarray, device: torch.device) -> bytes:
    """A rendered frame as JPEG bytes (q95 4:2:0): on a card uploaded and
    encoded by nvJPEG, on the CPU by the plain encoder."""
    t = torch.from_numpy(np.ascontiguousarray(img))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return jpeg_cuda.encode(t, 95)


def detect_video(detector, path, out_dir: str = ".", thresh: float = 0.6, video_nms: float = 0.95) -> List[str]:
    """A Motion-JPEG AVI through the detector into ``out_dir/detection_out.avi``;
    returns ``[that path]``, or ``[]`` for a clip without frames (as the JAX
    branch, which opens its writer at the first frame). An MP4 or any other
    file raises ``avi.VideoError`` naming what it holds."""
    os.makedirs(out_dir, exist_ok=True)
    writer: Optional[avi.AviWriter] = None
    out = os.path.join(out_dir, OUT_NAME)
    with avi.open_video(path) as reader:
        try:
            for img in render(detector, reader, thresh, video_nms):
                if writer is None:
                    writer = avi.AviWriter(out, img.shape[1], img.shape[0], FPS)
                writer.write(encode_frame(img, detector.device))
        finally:
            if writer is not None:
                writer.close()
    return [out] if writer is not None else []
