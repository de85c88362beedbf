"""The video branch of the demo (counterpart of the video branch of
``dspnet_tpu/detect/detector.py::Detector.detect_and_visualize``,
``:284-333``; reference multitask_detector.py:401-458) for Motion-JPEG AVI,
MPEG-4 Part 2 (mp4v ``.mp4``; ``XVID``, ``DIVX``, ``FMP4`` and the other
fourccs of ``data/avi.py`` in ``.avi``) and H.264 (``avc1`` / ``avc3``
``.mp4``; ``H264``, ``X264``, ``avc1`` and the other fourccs of
``data/avi.py`` in ``.avi``).

For each frame, in order:

1. its bytes come from the file (``data/avi.py`` / ``data/mp4.py``, in
   place of ``cv2.VideoCapture``), and the stream's ``codec`` picks the
   decoder;
2. frames decode in batches of ``DECODE_BATCH`` on the detector's device:
   Motion-JPEG by ``jpeg_cuda.decode_images`` (nvJPEG and the colour kernel
   on the card, a stream without Huffman tables getting Annex K's; the plain
   decoder on the CPU); MPEG-4 Part 2 by ``mpeg4_cuda.Decoder`` on the card
   (the parse kernel over the batch's VOPs, then the reconstruction and
   colour kernels VOP by VOP) and on the CPU (those kernels' plain
   versions); H.264 by ``h264_cuda.Decoder`` (the parse kernel over the
   batch's slices, then the reconstruction and deblocking kernels picture by
   picture, the colour kernel; the plain versions on the CPU), its delayed
   frames flushed at the end as FFmpeg's are; each gives cv2's frames;
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
6. the rendered frame goes back to the device, is encoded there as MPEG-4
   Part 2 (``mpeg4.Encoder``: torch ops on the frame's device) and appended
   to ``detection_out.mp4`` (``mp4.Mp4Writer``, mp4v, 25 frames per second,
   the rendered frame's size, an odd side cut to even as cv2's writer cuts
   it), as the JAX branch writes it through ``cv2.VideoWriter(fourcc
   "mp4v")``, whatever the input's codec.

:func:`render` yields the rendered frames (numpy BGR) without encoding them;
:func:`detect_video` writes the file.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from dspnet_torch.data import avi, h264_cuda, jpeg_cuda, mp4, mpeg4, mpeg4_cuda
from dspnet_torch.data.device_pipeline import resize_linear
from dspnet_torch.ops.nms import nms as host_nms
from dspnet_torch.utils import draw

#: the output file's name under ``out_dir``
OUT_NAME = "detection_out.mp4"
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


def _chunks(items: Iterable[bytes]) -> Iterator[List[bytes]]:
    chunk = []
    for data in items:
        chunk.append(data)
        if len(chunk) == DECODE_BATCH:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def _frames(detector, reader) -> Iterator[torch.Tensor]:
    """Each frame of ``reader`` (``avi.open_video``'s, or bare JPEG bytes)
    decoded on the detector's device, ``DECODE_BATCH`` at a time."""
    stream = getattr(reader, "stream", None)
    if stream is None or stream.codec == "mjpeg":
        for chunk in _chunks(reader):
            yield from jpeg_cuda.decode_images(chunk, detector.device)
        return
    if stream.codec == "h264":
        dec = h264_cuda.Decoder(detector.device, stream.extradata, stream.fourcc)
        for chunk in _chunks(reader):
            yield from dec.decode(chunk)
        yield from dec.flush()
        return
    dec = mpeg4_cuda.Decoder(detector.device, stream.extradata, stream.fourcc)
    for chunk in _chunks(reader):
        yield from dec.decode(chunk)


def render(detector, reader, thresh: float = 0.6, video_nms: float = 0.95) -> Iterator[np.ndarray]:
    """The rendered frames, in order, of a reader's frames (``avi.open_video``;
    bare bytes are Motion-JPEG frames), steps 2-5 of the module's text:
    (H, W, 3) uint8 BGR numpy arrays."""
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

    for frame in _frames(detector, reader):
        done = pipe.submit(resize_linear(frame, detector.data_shape), tag=frame)
        if done is not None:
            yield finish(*done)
    for frame, res in pipe.drain():
        yield finish(frame, res)


def detect_video(detector, path, out_dir: str = ".", thresh: float = 0.6, video_nms: float = 0.95) -> List[str]:
    """A Motion-JPEG, MPEG-4 Part 2 or H.264 video through the detector into
    ``out_dir/detection_out.mp4``; returns ``[that path]``, or ``[]`` for a
    clip without frames (as the JAX branch, which opens its writer at the
    first frame). Any other file raises ``avi.VideoError`` naming what it
    holds."""
    os.makedirs(out_dir, exist_ok=True)
    writer: Optional[mp4.Mp4Writer] = None
    encoder: Optional[mpeg4.Encoder] = None
    out = os.path.join(out_dir, OUT_NAME)
    with avi.open_video(path) as reader:
        try:
            for img in render(detector, reader, thresh, video_nms):
                frame = torch.from_numpy(img)
                if detector.device.type == "cuda":
                    frame = frame.pin_memory().to(detector.device, non_blocking=True)
                if writer is None:
                    encoder = mpeg4.Encoder(img.shape[1], img.shape[0])
                    writer = mp4.Mp4Writer(out, encoder.width, encoder.height, encoder.config, FPS)
                writer.write(*encoder.encode(frame))
        finally:
            if writer is not None:
                writer.close()
    return [out] if writer is not None else []
