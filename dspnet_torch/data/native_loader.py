"""The JAX CLIs' ``--loader native`` (counterpart of
``dspnet_tpu/data/native_loader.py``).

The JAX package's native loader is a multithreaded C++ pipeline
(``native/dataloader.cpp``: libjpeg / libpng decode, affine warp, box
transform, mean subtraction) that takes its shuffle order and augmentation
table from the Python side (numpy seed 233). It cannot be built on the
card's machine, which has neither ``jpeglib.h`` nor ``png.h`` nor their
libraries. The port's multithreaded loader is the device loader
(``data/device_pipeline.py::DeviceAugIterator``): host threads read the
samples, nvJPEG decodes on the card and the warp runs there. So
:class:`NativeMultiTaskIterator` is that loader behind the JAX native
loader's constructor and batch contract, a deliberate difference (ROADMAP
Queue C):

* the same seed-233 tables, drawn at construction; the first epoch runs on
  them and every later ``epoch()`` (or :meth:`reset`) draws anew, as the
  JAX native loader does;
* ``num_threads`` is the number of host read threads and ``queue_cap`` the
  number of raw batches decoded ahead;
* ``device_normalize`` (``--native-u8``) is accepted and has no effect: it
  chooses where the JAX loader subtracts the mean, and here the batch always
  crosses as uint8 and the mean is subtracted on the card;
* a padded last batch (``pad_last``) repeats its last sample instead of
  holding empty rows; ``fnames`` list the real samples either way;
* batches are tensors on ``device``; ``s2d`` is refused (ROADMAP item 17).

Its batches differ from the python loader's (``MultiTaskIterator``) as the
JAX native loader's do: float bilinear against cv2's rounding, within the
JAX package's own native-vs-python bounds (the tests hold them).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from dspnet_torch.data import augment as aug
from dspnet_torch.data.device_pipeline import DeviceAugIterator
from dspnet_torch.data.iterator import SampleIndex


def native_available(device="cuda") -> bool:
    """True where the device loader runs: on the CPU, and on ``cuda`` when a
    card is there."""
    device = torch.device(device)
    return device.type != "cuda" or torch.cuda.is_available()


class NativeMultiTaskIterator(DeviceAugIterator):
    """The JAX ``NativeMultiTaskIterator``'s arguments and batch contract over
    the device loader (see the module docstring)."""

    def __init__(
        self,
        index: SampleIndex,
        batch_size: int,
        data_shape: Tuple[int, int],
        mean_pixels=aug.MEAN_PIXELS,
        enable_aug: bool = True,
        seed: int = 233,
        num_threads: int = 8,
        queue_cap: int = 4,
        shuffle: bool = True,
        shard: Tuple[int, int] = (0, 1),
        device_normalize: bool = False,
        pad_last: bool = False,
        s2d: bool = False,
        *,
        device="cuda",
    ):
        if s2d:
            raise ValueError("s2d (the TPU's space-to-depth input layout) is not ported: ROADMAP item 17")
        super().__init__(index, batch_size, data_shape, device=device, seed=seed, enable_aug=enable_aug,
                         shuffle=shuffle, shard=shard, num_threads=num_threads, pad_last=pad_last)
        self.mean_pixels = torch.tensor(tuple(float(m) for m in mean_pixels), device=self.device)
        self.prefetch = queue_cap
        self.device_normalize = device_normalize
        self._drawn = True  # the construction tables are the first epoch's
        self._gen = None

    def reset(self):
        """A new shuffle and augmentation table; the next batch starts the epoch."""
        self.close()
        super().reset()

    def next_batch(self) -> dict:
        """The next batch of the current epoch (its names: ``last_names``)."""
        if self._gen is None:
            self._drawn = False
            self._gen = self.batches()
        batch, self.last_names = next(self._gen)
        return batch

    def epoch(self) -> Iterator:
        """(batch, fnames) pairs over one epoch: the tables drawn at
        construction for the first, new ones for every later epoch."""
        if not self._drawn:
            self.reset()
        self._drawn = False
        yield from self.batches()

    def close(self):
        """Release the epoch that ``next_batch`` has in progress (its decode
        thread)."""
        if self._gen is not None:
            self._gen.close()
            self._gen = None
