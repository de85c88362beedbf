"""On-device augmentation pipeline (counterpart of
``dspnet_tpu/data/device_pipeline.py``).

The device picks where images decode. On ``cuda`` the host threads only read
each sample's encoded bytes (path- or span-backed) and decode its PNG mask;
``prefetch_to_device``'s thread decodes the batch's JPEGs with nvJPEG
(``data/jpeg_cuda.py``) on its side stream into the raw uint8 batch (an image
in another format decodes on the host). On ``cpu`` the host threads decode
everything with the plain codecs (``data/image_io.py``). Either way the raw
uint8 batch lands on the device, and one call does the whole augmentation
there, batched: affine warp (bilinear, border
128) + horizontal flip + BGR->RGB mean-sub for the image; nearest warp
(border 255) + flip + 1/4 nearest downsample + LUT for the seg mask; and the box-corner transform, distance rescale,
area and out-of-image filters and top-compaction of the reference
(iterator.py:485-539) as fixed-shape masked ops over the batch.

The seed-233 parameter table, its order, the batch contract (``pad_last``,
maskless samples filled with 255) and the matrix math are the JAX
package's. The rotation's cosine and sine are taken in float64 and rounded
to float32, so the card and the CPU build the same matrices.

``predownscale`` resizes each image to ``data_shape`` right after its decode
(:func:`resize_area`, on the device on ``cuda``, the same torch ops on the
host on ``cpu``) and each mask with nearest sampling on the host
(``image_io.resize_nearest``), so raw resolutions may differ within a batch. The
JAX package does this with cv2 (``INTER_AREA`` / ``INTER_NEAREST``): the
masks equal cv2's bit for bit, the images too at factor 2 (cv2's rounding,
(sum + 2) >> 2), and within a level of cv2's elsewhere. The JAX package's ``s2d`` (a
TPU input layout) is not ported (ROADMAP Queue A item 17).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from dspnet_torch.data import augment as aug
from dspnet_torch.data import image_io, jpeg, jpeg_cuda
from dspnet_torch.data.cs_labels import seg_label_lut
from dspnet_torch.data.iterator import SampleIndex, load_sample_arrays, load_sample_bytes, shard_positions
from dspnet_torch.data.prefetch import prefetch_to_device


def _area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of cv2's ``INTER_AREA`` along one axis
    (``computeResizeAreaTab``): each output averages the source cells its
    interval [d * s, (d + 1) * s) covers, partial cells by their covered
    fraction, s = src / dst."""
    scale = src / dst
    out = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        width = min(scale, src - f1)
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        if s1 - f1 > 1e-3:
            out[d, s1 - 1] = (s1 - f1) / width
        out[d, s1:s2] = 1.0 / width
        if f2 - s2 > 1e-3:
            out[d, s2] = min(f2 - s2, 1.0, width) / width
    return out.astype(np.float32)


def resize_area(images: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(..., h, w, C) uint8 -> (..., H, W, C) uint8 downscale by area on the
    tensor's device, cv2 ``INTER_AREA``'s counterpart. At integer factors
    each output is its fy x fx box's sum, rounded half up ((sum + 2) >> 2 at
    factor 2, as cv2); elsewhere cv2's fractional-area weights, summed in
    float32 as two matrix products and rounded half to even, within a level
    of cv2."""
    H, W = hw
    x = images if images.ndim == 4 else images[None]
    B, h, w, C = x.shape
    if (h, w) == (H, W):
        return images
    if h % H == 0 and w % W == 0:
        fy, fx = h // H, w // W
        s = x.reshape(B, H, fy, W, fx, C).sum(dim=(2, 4), dtype=torch.int32)
        out = ((s + (fy * fx) // 2) // (fy * fx)).to(torch.uint8)
    else:
        wy = torch.from_numpy(_area_weights(h, H)).to(x.device)
        wx = torch.from_numpy(_area_weights(w, W)).to(x.device)
        t = torch.einsum("Hh,bhwc->bHwc", wy, x.float())
        out = torch.einsum("Ww,bHwc->bHWc", wx, t).round().clamp(0, 255).to(torch.uint8)
    return out if images.ndim == 4 else out[0]


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """cv2's ``INTER_LINEAR`` taps along one axis (``resize.cpp``,
    ``computeResizeLinear`` with fixed-point coefficients): for output d,
    f = float32((d + 0.5) * src / dst - 0.5), the taps floor(f) and
    floor(f) + 1 clamped into the image, the weights (1 - frac, frac) times
    2048 rounded to the nearest (even) integer. Along x (``clamp_weights``)
    a tap outside the image also moves the weight onto the edge sample, as
    cv2's horizontal pass does; along y only the rows are clamped."""
    f = ((np.arange(dst) + 0.5) * (np.float64(src) / dst) - 0.5).astype(np.float32)
    s0 = np.floor(f).astype(np.int64)
    frac = (f - s0.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        out = (s0 < 0) | (s0 >= src - 1)
        frac = np.where(out, np.float32(0), frac)
        s0 = np.clip(s0, 0, src - 1)
    w0 = np.rint((np.float32(1) - frac) * np.float32(2048)).astype(np.int32)
    w1 = np.rint(frac * np.float32(2048)).astype(np.int32)
    return np.clip(s0, 0, src - 1), np.clip(s0 + 1, 0, src - 1), w0, w1


def resize_linear(images: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(..., h, w, C) uint8 -> (..., H, W, C) uint8 bilinear resize on the
    tensor's device, equal to ``cv2.resize(..., INTER_LINEAR)`` bit for bit
    (the JAX ``Detector``'s resize, ``dspnet_tpu/detect/detector.py:156,
    213``). cv2 resizes uint8 in fixed point: a horizontal pass with 11-bit
    weights into int32 sums, then a vertical pass ``((b0 * (S0 >> 4)) >> 16 +
    (b1 * (S1 >> 4)) >> 16 + 2) >> 2``; integer tensor ops here do the same.
    An exact 2x downscale is cv2's ``INTER_AREA`` (cv2 switches to it, and
    the two rules give the same pixels there): :func:`resize_area`."""
    H, W = int(hw[0]), int(hw[1])
    x = images if images.ndim == 4 else images[None]
    h, w = x.shape[1:3]
    if (h, w) == (H, W):
        return images
    if (h, w) == (2 * H, 2 * W):
        return resize_area(images, (H, W))
    dev = x.device
    x0, x1, a0, a1 = (torch.from_numpy(t).to(dev) for t in _linear_taps(w, W, True))
    y0, y1, b0, b1 = (torch.from_numpy(t).to(dev) for t in _linear_taps(h, H, False))
    xi = x.to(torch.int32)
    rows = (xi[:, :, x0] * a0[:, None] + xi[:, :, x1] * a1[:, None]) >> 4  # (B, h, W, C)
    out = (((b0[:, None, None] * rows[:, y0]) >> 16) + ((b1[:, None, None] * rows[:, y1]) >> 16) + 2) >> 2
    out = out.clamp(0, 255).to(torch.uint8)
    return out if images.ndim == 4 else out[0]


class EncodedImages:
    """A batch's images as the host threads left them: JPEG bytes, decoded
    on the device by nvJPEG when the batch is placed there (on
    ``prefetch_to_device``'s side stream), or uint8 arrays the host decoded.
    ``resize_to``: the predownscale target, applied after the decode."""

    def __init__(self, items, resize_to: Optional[Tuple[int, int]] = None):
        self.items = list(items)
        self.resize_to = resize_to

    def place_on(self, device) -> torch.Tensor:
        """(B, H, W, 3) uint8 BGR on ``device``."""
        device = torch.device(device)
        out = [None] * len(self.items)
        encoded = [i for i, x in enumerate(self.items) if isinstance(x, bytes)]
        if encoded:
            for i, t in zip(encoded, jpeg_cuda.decode_images([self.items[i] for i in encoded], device)):
                out[i] = t
        for i, x in enumerate(self.items):
            if out[i] is None:
                t = torch.from_numpy(x)
                out[i] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
        if self.resize_to is not None:
            out = [resize_area(t, self.resize_to) for t in out]
        return torch.stack(out)


def _filter_and_compact(label: torch.Tensor, data_shape, out_of_image: bool) -> torch.Tensor:
    """(B, L, 6) labels: clear degenerate rows to -1, survivors to the top in
    their order (iterator.py:522-539)."""
    H, W = data_shape
    xmin, ymin, xmax, ymax = label[..., 1], label[..., 2], label[..., 3], label[..., 4]
    area = (xmax - xmin) * W * (ymax - ymin) * H
    bad = (label[..., 0] < 0) | (area < 100.0)
    if out_of_image:
        bad |= (xmax < 0.01) | (xmin > 0.99) | (ymax < 0.01) | (ymin > 0.99)
    label = torch.where(bad[..., None], -1.0, label)
    order = torch.argsort(bad.to(torch.uint8), dim=1, stable=True)
    return torch.gather(label, 1, order[..., None].expand_as(label))


def _cos_sin(theta: torch.Tensor):
    return torch.cos(theta.double()).float(), torch.sin(theta.double()).float()


def _augment_boxes(label: torch.Tensor, params: torch.Tensor, data_shape) -> torch.Tensor:
    """The box path of the reference (iterator.py:485-539), batched: (B, L, 6)
    labels, (B, 6) params."""
    H, W = data_shape
    flip, theta, sx, sy, tx, ty = (params[:, i:i + 1] for i in range(6))
    valid = label[..., 0] >= 0
    ca, sa = _cos_sin(theta)

    def tf(x, y):
        return sx * ca * x - sy * sa * y + tx, sx * sa * x + sy * ca * y + ty

    x1, y1 = tf(label[..., 1] * W, label[..., 2] * H)
    x2, y2 = tf(label[..., 3] * W, label[..., 4] * H)
    do_flip = flip > 0.5
    x1f = torch.where(do_flip, W - x1, x1)
    x2f = torch.where(do_flip, W - x2, x2)
    # flip mirrors corners, then xmin/xmax swap (augment.py:102-108)
    nx1 = torch.where(do_flip, x2f, x1f)
    nx2 = torch.where(do_flip, x1f, x2f)
    box = torch.stack([nx1 / W, y1 / H, nx2 / W, y2 / H], dim=-1).clamp(0.0, 1.0)
    dist = label[..., 5] / torch.sqrt(sx * sy)
    new = torch.cat([label[..., :1], box, dist[..., None]], dim=-1)
    label = torch.where(valid[..., None], new, label)
    return _filter_and_compact(label, data_shape, out_of_image=True)


@torch.no_grad()
def device_augment_batch(
    raw_images: torch.Tensor,  # (B, hh, ww, 3) uint8 BGR
    raw_segs: Optional[torch.Tensor],  # (B, hh, ww) uint8 or None
    labels: torch.Tensor,  # (B, 200, 6) f32
    params: torch.Tensor,  # (B, 6) f32 [flip, theta, sx, sy, tx, ty]
    lut: torch.Tensor,  # (256,) int32
    data_shape: Tuple[int, int],
    enable_aug: bool = True,
    mean_pixels=aug.MEAN_PIXELS,
) -> dict:
    """One augmented batch on the inputs' device: ``images`` (B, H, W, 3) f32
    RGB mean-subtracted, ``seg_label`` (B, H/4, W/4) int32 (when ``raw_segs``
    is given) and ``label_det`` (B, 200, 6) f32. Without ``enable_aug`` the
    warp is a plain resize (border 0) and boxes are only filtered.

    ``mean_pixels``: RGB, a tuple or a float32 tensor on the device. Every
    other constant enters as a Python scalar: a small tensor made from host
    values would be a blocking copy, which on CUDA waits for the stream
    (and so for the train step queued ahead of this batch)."""
    H, W = data_shape
    B, hh, ww = raw_images.shape[:3]
    dev = raw_images.device
    if not enable_aug:
        params = torch.zeros(B, 6, device=dev)
        params[:, 2:4] = 1.0  # identity: [0, 0, 1, 1, 0, 0]
    params = params.to(dev, torch.float32)
    flip, theta = params[:, 0], params[:, 1]
    sx, sy, tx, ty = params[:, 2], params[:, 3], params[:, 4], params[:, 5]
    sx2, sy2 = sx * (W / float(ww)), sy * (H / float(hh))
    ca, sa = _cos_sin(theta)
    M = torch.stack([
        torch.stack([sx2 * ca, -sy2 * sa, tx], dim=-1),
        torch.stack([sx2 * sa, sy2 * ca, ty], dim=-1),
    ], dim=1)  # (B, 2, 3)

    border = 128.0 if enable_aug else 0.0
    img = aug.warp_affine_batch(raw_images, M, (H, W), border)
    do_flip = (flip > 0.5) & enable_aug
    img = torch.where(do_flip[:, None, None, None], img.flip(2), img)
    img = img.flip(-1) - torch.as_tensor(mean_pixels, dtype=torch.float32, device=dev)  # BGR->RGB

    out = {"images": img}
    if raw_segs is not None:
        seg_border = 255.0 if enable_aug else 0.0
        seg = aug.warp_affine_batch(raw_segs, M, (H, W), seg_border, nearest=True)
        seg = torch.where(do_flip[:, None, None], seg.flip(2), seg)
        seg = seg[:, ::4, ::4].long()  # nearest 1/4 (src = dst*4)
        out["seg_label"] = lut.to(dev)[seg.clamp(0, 255)]

    labels = labels.to(dev, torch.float32)
    if enable_aug:
        out["label_det"] = _augment_boxes(labels, params, (H, W))
    else:
        out["label_det"] = _filter_and_compact(labels, (H, W), out_of_image=False)
    return out


class DeviceAugIterator:
    """Batches of ``{'images', 'label_det', 'seg_label'}`` (+ filenames),
    augmented on ``device``.

    Host worker threads read the samples (on ``cuda`` the JPEG bytes and the
    decoded masks, on ``cpu`` decoded images and masks),
    ``prefetch_to_device`` makes each raw batch on ``device`` (decoding its
    JPEGs there on ``cuda``), and the consumer's thread runs
    :func:`device_augment_batch`. All images must share one raw resolution,
    checked on the host from each JPEG's frame header, unless
    ``predownscale`` resizes them to ``data_shape`` first. ``device`` and
    ``seed`` are explicit: the batches land where the caller computes, and
    the seed fixes the epoch's order and augmentation table (233 in the
    reference).
    """

    def __init__(
        self,
        index: SampleIndex,
        batch_size: int,
        data_shape: Tuple[int, int],
        *,
        device,
        seed: int,
        enable_aug: bool = True,
        shuffle: bool = True,
        shard: Tuple[int, int] = (0, 1),
        num_threads: int = 4,
        pad_last: bool = False,
        predownscale: bool = False,
    ):
        """``pad_last``: also yield a final partial batch, padded to
        ``batch_size`` by repeating its last sample, with ``fnames`` listing
        only the real samples (consumers slice outputs by ``len(fnames)``);
        eval passes True, training False. ``predownscale``: resize every
        image and mask to ``data_shape`` right after its decode (see the
        module docstring)."""
        self.index = index
        self.predownscale = predownscale
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.device = torch.device(device)
        self.pad_last = pad_last
        # made on the device once: a per-batch copy from the host would wait
        # for the stream (see device_augment_batch)
        self.mean_pixels = torch.tensor(aug.MEAN_PIXELS, device=self.device)
        self.enable_aug = enable_aug
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.lut = torch.from_numpy(seg_label_lut().astype(np.int32)).to(self.device)
        self.num_samples = len(index)
        self.positions = shard_positions(self.num_samples, shard)
        self.order = np.arange(self.num_samples)
        if shuffle:
            self.rng.shuffle(self.order)
        self._resample_aug()
        self.cursor = 0
        self.num_threads = num_threads
        self.raw_hw: Optional[Tuple[int, int]] = None
        self._hw_lock = threading.Lock()

    def _resample_aug(self):
        self.aug_params = aug.sample_aug_params(self.num_samples, self.data_shape, self.rng)

    def reset(self):
        if self.shuffle:
            self.rng.shuffle(self.order)
        self._resample_aug()
        self.cursor = 0

    # ------------------------------------------------------------- host side

    def _load_raw(self, pos: int):
        """(image, label, mask, name) of one sample: the image as JPEG bytes
        when the device decodes it, else a uint8 BGR array."""
        sample = self.index[int(self.order[pos])]
        if self.device.type == "cuda":
            img, seg = load_sample_bytes(sample)
            if img[:3] == image_io.JPEG_MAGIC:
                hw = jpeg.read_header(img)[:2]
            else:
                img = image_io.imdecode(img, image_io.IMREAD_COLOR)
                hw = img.shape[:2]
        else:
            img, seg = load_sample_arrays(sample)
            hw = img.shape[:2]
        if self.predownscale:
            if seg is not None and seg.shape[:2] != self.data_shape:
                seg = image_io.resize_nearest(seg, self.data_shape)
            hw = self.data_shape  # every image is resized after its decode
        with self._hw_lock:
            if self.raw_hw is None:
                self.raw_hw = tuple(hw)
        if tuple(hw) != self.raw_hw:
            raise ValueError(
                f"mixed raw resolutions {tuple(hw)} vs {self.raw_hw}; on-device augmentation "
                "batches raw images: resize the dataset offline or pass predownscale=True")
        return img, sample.label, seg, sample.image_path

    def _raw_batches(self) -> Iterator:
        from concurrent.futures import ThreadPoolExecutor

        bs = self.batch_size
        n = len(self.positions)
        starts = list(range(0, n - bs + 1, bs))
        if self.pad_last and n % bs:
            starts.append((n // bs) * bs)  # padded tail
        with ThreadPoolExecutor(self.num_threads) as pool:
            for start in starts:
                poss = self.positions[start:start + bs]
                decoded = list(pool.map(lambda p: self._load_raw(int(p)), poss))
                n_real = len(decoded)
                # pad the tail by repeating the last decoded sample: consumers
                # keep only the real rows (len(fnames)), so the padded content
                # is never read, and repetition keeps one raw shape
                decoded.extend([decoded[-1]] * (bs - n_real))
                params = np.concatenate(
                    [self.aug_params[poss], np.repeat(self.aug_params[poss[-1:]], bs - n_real, axis=0)])
                segs = [d[2] for d in decoded]
                seg_arr = None
                if any(s is not None for s in segs):
                    hw = next(s.shape for s in segs if s is not None)
                    # maskless samples fill with 255 (ignore), not 0 (road)
                    seg_arr = np.stack([s if s is not None else np.full(hw, 255, np.uint8)
                                        for s in segs]).astype(np.uint8)
                imgs = [d[0] for d in decoded]
                if self.predownscale or any(isinstance(x, bytes) for x in imgs):
                    raw = EncodedImages(imgs, self.data_shape if self.predownscale else None)
                else:
                    raw = np.stack(imgs)
                yield {
                    "raw": raw,
                    "segs": seg_arr,
                    "labels": np.stack([d[1] for d in decoded]).astype(np.float32),
                    "params": params.astype(np.float32),
                    "names": [d[3] for d in decoded[:n_real]],
                }

    # ----------------------------------------------------------- device side

    def epoch(self) -> Iterator:
        """(batch, fnames) pairs. Decode runs ahead on ``prefetch_to_device``'s
        thread, which also copies each raw batch to the device (pinned memory,
        a side stream on CUDA); the augmentation runs on the consumer's stream."""
        self.reset()
        # closing: an abandoned epoch releases the decode thread at once
        with contextlib.closing(prefetch_to_device(self._raw_batches(), size=3, device=self.device)) as raw:
            for item in raw:
                batch = device_augment_batch(
                    item["raw"], item["segs"], item["labels"], item["params"], self.lut,
                    self.data_shape, enable_aug=self.enable_aug, mean_pixels=self.mean_pixels)
                yield batch, item["names"]

    def __iter__(self):
        for batch, _ in self.epoch():
            yield batch
