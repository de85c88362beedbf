"""Multitask inference API (counterpart of ``dspnet_tpu/detect/detector.py``).

One class serves the whole preprocess -> forward -> decode -> NMS -> seg
argmax path:
  * ``predict(images)``      — preprocessed float NHWC images
  * ``predict_raw(raw_bgr)`` — uint8 BGR frames: a uint8 host-to-device copy
                               (through pinned memory on CUDA), then the
                               BGR->RGB flip and mean subtraction on the device
  * ``detect(images)``       — per-image det rows with id >= 0 + seg maps,
                               as numpy (reference multitask_detector.py:166-272)
  * ``im_detect_single``     — one image file (JPEG or PNG) or BGR array: a
                               JPEG decodes on the card (nvJPEG and the colour
                               kernel, ``data/jpeg_cuda.py``; the plain decoder
                               on the CPU), then ``resize_linear`` (cv2's
                               INTER_LINEAR, bit for bit) on the device, then
                               ``predict_raw`` (multitask_detector.py:307-334)
  * ``visualize_detection``  — boxes in per-class colours, nearest drawn last,
                               the "NNm" distance text and the seg overlay,
                               drawn by ``utils/draw.py`` (no cv2; the text
                               as cv2 5.0.0 draws it, ``utils/text.py``)
                               (:336-399)
  * ``detect_and_visualize`` — image paths -> ``<stem>_out.jpg`` through the
                               port's JPEG encoder (q95 4:2:0, as cv2.imwrite);
                               a Motion-JPEG or MPEG-4 Part 2 video ->
                               ``detection_out.mp4`` as mp4v at 25 fps
                               (``detect/video.py``: decode and encode on the
                               card, ``ServingPipeline`` at depth 2, the 0.95
                               host NMS)

The network runs in ``dtype``; the class softmax, box decode and NMS run in
float32 whatever that dtype is. On a CUDA device NMS is always the
hand-written kernel (``ops/nms_cuda.py``).

``devices=[...]`` (the JAX Detector's ``mesh=``) serves each batch over
several devices: one replica of the served copy per device, the batch
padded to a multiple of their number with copies of its last row, one
contiguous block of rows per replica in order, each run under its own
device and (on a card) its own stream, and the results gathered on
``devices[0]`` with the padding sliced off, so b1 serves on any list. A
list may name one card twice (two replicas sharing it on two streams).

The detector never mutates the module it is given: it serves its own copy,
cast to ``dtype`` on ``device`` and in eval mode, and ``update_weights``
copies new weights into that copy (the JAX Detector's
``update_variables``), so a training loop can hand it its weights as they
move. A video is a Motion-JPEG or MPEG-4 Part 2 AVI or an mp4v MP4
(``data/avi.py``, ``data/mp4.py``); an MP4 of another codec (H.264, HEVC,
AV1, VP9) raises with its codec's name, and a webcam id raises: neither
machine has a camera, and the JAX CLI passes ``--images`` as a string, so it
cannot reach that branch either.
"""

from __future__ import annotations

import copy
import os
import random
from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dspnet_torch.data import image_io, jpeg2000, jpeg2000_cuda, jpeg_cuda
from dspnet_torch.data.cs_labels import train_id_palette
from dspnet_torch.data.device_pipeline import resize_linear
from dspnet_torch.ops.detection import multibox_detection
from dspnet_torch.utils import draw, text
from dspnet_torch.utils.precision import cast_floating

#: RGB mean pixel (reference iterator.py:340; dspnet_tpu/data/augment.py)
MEAN_PIXELS = (123.68, 116.779, 103.939)


def _check_raw(raw: torch.Tensor) -> torch.Tensor:
    if raw.dtype != torch.uint8 or raw.ndim != 4 or raw.shape[-1] != 3:
        raise ValueError(f"expected (B, H, W, 3) uint8, got {tuple(raw.shape)} {raw.dtype}")
    return raw


class _Replica:
    """One served copy of the network on one device, with its anchors, its
    mean pixel and, when it shares the serving with others on a card, a
    stream of its own."""

    def __init__(self, model, anchors, mean_pixels, device, own_stream):
        self.model = model
        self.device = device
        self.anchors = None if anchors is None else torch.as_tensor(anchors, device=device)
        self.mean = torch.tensor(mean_pixels, dtype=torch.float32, device=device)
        self.stream = torch.cuda.Stream(device) if own_stream and device.type == "cuda" else None


class Detector:
    def __init__(
        self,
        model: torch.nn.Module,
        anchors: Optional[np.ndarray],
        data_shape: Tuple[int, int],
        device="cuda",
        dtype: torch.dtype = torch.float32,
        nms_thresh: float = 0.5,
        force_suppress: bool = False,
        nms_topk: int = 400,
        score_threshold: float = 0.01,
        seg_probabilities: bool = False,
        mean_pixels: Sequence[float] = MEAN_PIXELS,
        classes: Optional[Sequence[str]] = None,
        devices: Optional[Sequence] = None,
    ):
        """Serves a copy of ``model`` cast to ``dtype`` on ``device`` (the
        card unless the caller asks for ``"cpu"``); ``model`` itself is left
        as it was. ``seg_probabilities``: also return the (B, H/4, W/4, C)
        float32 softmax of the seg head as ``seg_prob``, for the Cityscapes
        result-PNG writer (JAX ``detector.py:67-84,139-140``). ``classes``:
        the names ``visualize_detection`` writes (class ids without).
        ``devices``: serve over these devices instead of ``device`` (one
        replica each; results on ``devices[0]``)."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        if devices is not None and not devices:
            raise ValueError("devices must name at least one device")
        self.devices = [torch.device(d) for d in devices] if devices else [torch.device(device)]
        if len({d.type for d in self.devices}) > 1:
            raise ValueError(f"devices must all be of one type, got {self.devices}")
        self.device = self.devices[0]
        self.dtype = dtype
        self.mean_pixels = tuple(mean_pixels)
        served = cast_floating(copy.deepcopy(model).to(self.device), dtype).eval()
        served.requires_grad_(False)
        anchors = None if anchors is None else np.asarray(anchors, np.float32)  # None: seg-only
        self._replicas = [_Replica(served if i == 0 else copy.deepcopy(served).to(d), anchors,
                                   self.mean_pixels, d, len(self.devices) > 1)
                          for i, d in enumerate(self.devices)]
        self.model, self.anchors, self.mean = served, self._replicas[0].anchors, self._replicas[0].mean
        self.data_shape = tuple(data_shape)
        self.classes = list(classes) if classes else None
        self.palette = train_id_palette()
        self.nms_thresh = nms_thresh
        self.force_suppress = force_suppress
        self.nms_topk = nms_topk
        self.score_threshold = score_threshold
        self.seg_probabilities = seg_probabilities

    @torch.no_grad()
    def update_weights(self, weights: Union[torch.nn.Module, Mapping[str, torch.Tensor]]) -> None:
        """Copy every parameter and buffer of ``weights`` (a module of the
        same architecture, or its state dict) into the served copy, cast to
        its dtype and device; strict, like ``load_state_dict``."""
        if isinstance(weights, torch.nn.Module):
            weights = weights.state_dict()
        weights = dict(weights)
        for rep in self._replicas:
            if rep.stream is not None:  # the copy waits for the replica's frames in flight
                torch.cuda.current_stream(rep.device).wait_stream(rep.stream)
            rep.model.load_state_dict(weights, strict=True)

    # ------------------------------------------------------------- core

    def _postprocess(self, out: dict, anchors) -> dict:
        """Head outputs -> ``{"det": (B, K, 7) f32, "seg": (B, H/4, W/4) uint8}``,
        decoded against ``anchors`` on the outputs' device."""
        results = {}
        if "cls_logits" in out:
            cls_prob = torch.softmax(out["cls_logits"].float(), dim=-1)  # (B, A, C)
            results["det"] = multibox_detection(
                cls_prob.transpose(1, 2),
                out["loc_preds"],
                anchors,
                threshold=self.score_threshold,
                nms_threshold=self.nms_thresh,
                force_suppress=self.force_suppress,
                nms_topk=self.nms_topk,
            )
        if "seg_logits" in out:
            # uint8 trainId map: 4x fewer device->host bytes than int64
            results["seg"] = out["seg_logits"].argmax(dim=-1).to(torch.uint8)
            if self.seg_probabilities:
                results["seg_prob"] = torch.softmax(out["seg_logits"].float(), dim=-1)
        return results

    @torch.inference_mode()
    def predict(self, images) -> dict:
        """images (B, H, W, 3) preprocessed float (numpy or tensor)."""
        images = torch.as_tensor(images).to(self.device, self.dtype)
        return self._run_padded(self.float_rows, images)

    @torch.inference_mode()
    def predict_raw(self, raw_bgr) -> dict:
        """raw (B, H, W, 3) uint8 BGR at data_shape (numpy or tensor)."""
        raw = _check_raw(torch.as_tensor(raw_bgr))
        if self.device.type == "cuda" and raw.device.type == "cpu":
            raw = raw.pin_memory()
        raw = raw.to(self.device, non_blocking=True)
        return self._run_padded(self.raw_rows, raw)

    def raw_rows(self, rep: _Replica, x: torch.Tensor) -> dict:
        """``predict_raw``'s work on one replica's block of uint8 BGR rows,
        on the replica's device (``detect/pipeline.py`` captures it in a CUDA
        graph, so the check runs at each capture, for each new shape and
        dtype)."""
        images = _check_raw(x).flip(-1).float() - rep.mean
        return self._postprocess(rep.model(images.to(self.dtype)), rep.anchors)

    def float_rows(self, rep: _Replica, x: torch.Tensor) -> dict:
        """``predict``'s work on one replica's block of preprocessed rows."""
        return self._postprocess(rep.model(x.to(self.dtype)), rep.anchors)

    def _run_padded(self, fn, batch: torch.Tensor, streams: Optional[Sequence] = None) -> dict:
        """``fn(replica, rows)`` over the batch on ``self.device``: with one
        replica a plain call; with n, the batch padded to a multiple of n with
        copies of its last row (JAX ``_run_padded``), a contiguous block of
        rows per replica, each under its device and on its stream (each
        replica's own, or ``streams[i]``: ``detect/pipeline.py`` passes a
        slot's), and the results concatenated on ``self.device`` with the
        padding sliced off. Nothing synchronises the host: each replica's
        stream waits for the batch on the current stream, and the gather
        waits for each replica's stream."""
        if len(self._replicas) == 1:
            return fn(self._replicas[0], batch)
        n, B = len(self._replicas), batch.shape[0]
        pad = (-B) % n
        if pad:
            batch = torch.cat([batch, batch[-1:].expand(pad, *batch.shape[1:])])
        streams = streams or [rep.stream for rep in self._replicas]
        parts = []
        for rep, stream, rows in zip(self._replicas, streams, batch.chunk(n)):
            if stream is None:
                parts.append(fn(rep, rows.to(rep.device)))
                continue
            home = torch.cuda.current_stream(rep.device)
            with torch.cuda.device(rep.device):
                # the batch was written on the current stream of devices[0],
                # the replica's weights on its device's current stream
                stream.wait_stream(torch.cuda.current_stream(self.device))
                stream.wait_stream(home)
                with torch.cuda.stream(stream):
                    if rep.device == self.device:
                        rows.record_stream(stream)  # read there after this call returns
                    out = fn(rep, rows.to(rep.device, non_blocking=True))
                home.wait_stream(stream)
                for v in out.values():
                    v.record_stream(home)  # made on the replica's stream, read on its device's current
            parts.append({k: v.to(self.device, non_blocking=True) for k, v in out.items()})
        return {k: torch.cat([p[k] for p in parts])[:B] for k in parts[0]}

    @staticmethod
    def _filter_rows(rows: np.ndarray, det_threshold: float) -> np.ndarray:
        """Keep rows with id >= 0 (non-suppressed sentinel) and score >=
        threshold (reference multitask_detector.py:268-271)."""
        return rows[(rows[:, 0] >= 0) & (rows[:, 1] >= det_threshold)]

    def detect(self, images, det_threshold: float = 0.0):
        """Returns (list of per-image (n, 7) arrays with id >= 0 and
        score >= det_threshold, seg maps (B, H/4, W/4) or None)."""
        res = self.predict(images)
        dets_out: List[np.ndarray] = []
        if "det" in res:
            det = res["det"].cpu().numpy()
            for b in range(det.shape[0]):
                dets_out.append(self._filter_rows(det[b], det_threshold))
        seg = res["seg"].cpu().numpy() if "seg" in res else None
        return dets_out, seg

    # ------------------------------------------------------------ images

    def transform(self, img_bgr) -> np.ndarray:
        """Resize (cv2 ``INTER_LINEAR``'s pixels) + mean-sub RGB float32
        (reference multitask_detector.py:65-76), on the host."""
        img = resize_linear(torch.as_tensor(np.asarray(img_bgr)), self.data_shape).numpy()
        return img[:, :, ::-1].astype(np.float32) - np.asarray(self.mean_pixels, np.float32)

    def read_image(self, image) -> torch.Tensor:
        """A path (any format ``data/image_io.py`` reads, by content) or an
        (H, W, 3) uint8 BGR array -> that image as a uint8 BGR tensor on the
        detector's device. A JPEG decodes there: on the card by nvJPEG and
        the colour kernel, on the CPU by the plain decoder; on the card a
        JPEG 2000 file decodes by the kernels of ``data/jpeg2000_cuda.py``;
        every other format (and JPEG 2000 on the CPU) decodes on the host to
        cv2's pixels and is uploaded."""
        if isinstance(image, torch.Tensor):
            return image.to(self.device)
        if isinstance(image, (str, os.PathLike)):
            with open(image, "rb") as f:
                data = f.read()
            if data[:3] == image_io.JPEG_MAGIC:
                return jpeg_cuda.decode_images([data], self.device)[0]
            if self.device.type == "cuda" and jpeg2000.is_jpeg2000(data):
                return jpeg2000_cuda.decode(data, jpeg2000.IMREAD_COLOR, self.device)
            image = image_io.imdecode(data)
        image = np.asarray(image)
        if image.dtype != np.uint8 or image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f"expected an (H, W, 3) uint8 BGR image, got {image.shape} {image.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(image))
        return t.pin_memory().to(self.device, non_blocking=True) if self.device.type == "cuda" else t

    def im_detect_single(self, image, det_threshold: float = 0.0):
        """image: a path, an (H, W, 3) uint8 BGR array or such a tensor.
        Returns ((n, 7) dets with id >= 0 and score >= det_threshold, the
        (H/4, W/4) seg map or None), as numpy."""
        raw = resize_linear(self.read_image(image), self.data_shape)
        res = self.predict_raw(raw[None])
        dets_out = np.zeros((0, 7), np.float32)
        if "det" in res:
            dets_out = self._filter_rows(res["det"][0].cpu().numpy(), det_threshold)
        seg = res["seg"][0].cpu().numpy() if "seg" in res else None
        return dets_out, seg

    # --------------------------------------------------------- visualize

    def visualize_detection(self, img_bgr: np.ndarray, dets: np.ndarray, seg: Optional[np.ndarray] = None,
                            thresh: float = 0.6, seg_alpha: float = 0.5) -> np.ndarray:
        """Boxes in class colours (``random.Random(1)``, as the JAX one),
        farthest first so the nearest lands on top, each with its "name NNm"
        text, over the seg overlay. Returns a BGR image."""
        img = np.array(img_bgr, np.uint8, copy=True)
        if seg is not None:
            img = draw.seg_overlay(img, seg, self.palette, seg_alpha)
        return self.draw_boxes(img, dets, thresh)

    def draw_boxes(self, img: np.ndarray, dets: np.ndarray, thresh: float = 0.6) -> np.ndarray:
        """``visualize_detection``'s boxes and texts, drawn into ``img`` (an
        (H, W, 3) uint8 BGR array) in place; returns it."""
        height, width = img.shape[:2]
        rng = random.Random(1)
        colors = {}
        rows = [r for r in np.asarray(dets) if r[0] >= 0 and r[1] >= thresh]
        rows.sort(key=lambda r: -r[6])  # farthest first, nearest on top (:365)
        for r in rows:
            cid = int(r[0])
            if cid not in colors:
                colors[cid] = (rng.randint(0, 255), rng.randint(0, 255), rng.randint(0, 255))
            xmin, ymin = int(r[2] * width), int(r[3] * height)
            xmax, ymax = int(r[4] * width), int(r[5] * height)
            draw.rectangle(img, (xmin, ymin), (xmax, ymax), colors[cid], 2)
            cname = self.classes[cid] if self.classes else str(cid)
            draw.put_text(img, f"{cname} {r[6] * 255.0:.0f}m", (xmin, max(12, ymin - 4)), text.FONT_HERSHEY_SIMPLEX,
                          0.5, colors[cid], 1)
        return img

    def detect_and_visualize(self, inputs, out_dir: str = ".", thresh: float = 0.6,
                             video_nms: float = 0.95) -> List[str]:
        """Image path(s) -> ``<stem>_out.jpg`` under ``out_dir`` each (JPEG
        q95 4:2:0 by ``data/jpeg.py``), or one video path (``.avi`` /
        ``.mp4``) -> ``detection_out.mp4`` (``detect/video.py``, with the
        reference's second host NMS at ``video_nms``); returns the written
        paths. Motion-JPEG and MPEG-4 Part 2 are read; another codec raises
        with its name; a webcam id raises."""
        if isinstance(inputs, int):
            raise NotImplementedError(
                f"webcam {inputs} is not read: neither the card's machine nor the test machine has a camera, "
                "and the JAX CLI passes --images as a string, so it cannot reach this branch either "
                "(ROADMAP Queue A item 24); pass a clip written as mp4v or Motion-JPEG")
        if isinstance(inputs, (str, os.PathLike)) and str(inputs).lower().endswith((".mp4", ".avi")):
            from dspnet_torch.detect import video

            return video.detect_video(self, inputs, out_dir, thresh, video_nms)
        os.makedirs(out_dir, exist_ok=True)
        written = []
        for path in [inputs] if isinstance(inputs, str) else list(inputs):
            img = self.read_image(path)
            dets, seg = self.im_detect_single(img)
            vis = self.visualize_detection(img.cpu().numpy(), dets, seg, thresh)
            out = os.path.join(out_dir, os.path.splitext(os.path.basename(path))[0] + "_out.jpg")
            written.append(image_io.imwrite(out, vis))
        return written
