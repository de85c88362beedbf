"""Multitask inference API (counterpart of ``dspnet_tpu/detect/detector.py``).

One class serves the whole preprocess -> forward -> decode -> NMS -> seg
argmax path:
  * ``predict(images)``      — preprocessed float NHWC images
  * ``predict_raw(raw_bgr)`` — uint8 BGR frames: a uint8 host-to-device copy
                               (through pinned memory on CUDA), then the
                               BGR->RGB flip and mean subtraction on the device
  * ``detect(images)``       — per-image det rows with id >= 0 + seg maps,
                               as numpy (reference multitask_detector.py:166-272)

The network runs in ``dtype``; the class softmax, box decode and NMS run in
float32 whatever that dtype is. On a CUDA device NMS is always the
hand-written kernel (``ops/nms_cuda.py``).

The detector never mutates the module it is given: it serves its own copy,
cast to ``dtype`` on ``device`` and in eval mode, and ``update_weights``
copies new weights into that copy (the JAX Detector's
``update_variables``), so a training loop can hand it its weights as they
move. Visualisation, video, single-image file input and the pipelined
server are not ported yet.
"""

from __future__ import annotations

import copy
from typing import List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from dspnet_torch.ops.detection import multibox_detection
from dspnet_torch.utils.precision import cast_floating

#: RGB mean pixel (reference iterator.py:340; dspnet_tpu/data/augment.py)
MEAN_PIXELS = (123.68, 116.779, 103.939)


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
    ):
        """Serves a copy of ``model`` cast to ``dtype`` on ``device`` (the
        card unless the caller asks for ``"cpu"``); ``model`` itself is left
        as it was. ``seg_probabilities``: also return the (B, H/4, W/4, C)
        float32 softmax of the seg head as ``seg_prob``, for the Cityscapes
        result-PNG writer (JAX ``detector.py:67-84,139-140``)."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.device = torch.device(device)
        self.dtype = dtype
        self.model = cast_floating(copy.deepcopy(model).to(self.device), dtype).eval()
        self.model.requires_grad_(False)
        self.anchors = (None if anchors is None  # seg-only model
                        else torch.as_tensor(np.asarray(anchors, np.float32), device=self.device))
        self.data_shape = tuple(data_shape)
        self.mean = torch.tensor(MEAN_PIXELS, dtype=torch.float32, device=self.device)
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
        self.model.load_state_dict(dict(weights), strict=True)

    # ------------------------------------------------------------- core

    def _postprocess(self, out: dict) -> dict:
        """Head outputs -> ``{"det": (B, K, 7) f32, "seg": (B, H/4, W/4) uint8}``."""
        results = {}
        if "cls_logits" in out:
            cls_prob = torch.softmax(out["cls_logits"].float(), dim=-1)  # (B, A, C)
            results["det"] = multibox_detection(
                cls_prob.transpose(1, 2),
                out["loc_preds"],
                self.anchors,
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
        return self._postprocess(self.model(images))

    @torch.inference_mode()
    def predict_raw(self, raw_bgr) -> dict:
        """raw (B, H, W, 3) uint8 BGR at data_shape (numpy or tensor)."""
        raw = torch.as_tensor(raw_bgr)
        if raw.dtype != torch.uint8 or raw.ndim != 4 or raw.shape[-1] != 3:
            raise ValueError(f"expected (B, H, W, 3) uint8, got {tuple(raw.shape)} {raw.dtype}")
        if self.device.type == "cuda" and raw.device.type == "cpu":
            raw = raw.pin_memory()
        raw = raw.to(self.device, non_blocking=True)
        images = raw.flip(-1).float() - self.mean
        return self._postprocess(self.model(images.to(self.dtype)))

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
