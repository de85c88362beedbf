"""The on-device augmentation on the card vs the same code on the CPU.

Skips without a CUDA device. The file imports no jax, so it also runs on a
machine with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_data_cuda.py
"""

import numpy as np
import pytest
import torch

from dspnet_torch.data import augment, device_pipeline
from dspnet_torch.data.cs_labels import seg_label_lut
from dspnet_torch.data.prefetch import prefetch_to_device

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

# bilinear pixels: the same float32 ops in the same order on both devices,
# each a separate kernel (no fused multiply-add), so equal in practice; the
# bound allows one rounding of a 0..255 value
IMG_ATOL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the warp runs on the card")
    return torch.device("cuda:0")


def _affines(rng, B):
    M = np.zeros((B, 2, 3), np.float32)
    th, s = rng.uniform(-0.09, 0.09, B), rng.uniform(0.4, 2.2, B)
    M[:, 0, 0], M[:, 0, 1], M[:, 0, 2] = s * np.cos(th), -s * 1.1 * np.sin(th), rng.uniform(-600, 5, B)
    M[:, 1, 0], M[:, 1, 1], M[:, 1, 2] = s * np.sin(th), s * 1.1 * np.cos(th), rng.uniform(-300, 5, B)
    return M


@pytest.mark.cuda
@pytest.mark.parametrize("nearest", [False, True])
def test_warp_affine_batch_on_the_card_matches_the_cpu(cuda_device, nearest):
    rng = np.random.RandomState(int(nearest))
    M = torch.from_numpy(_affines(rng, 4))
    for raw in (rng.randint(0, 256, (4, 512, 1024, 3)).astype(np.uint8),
                rng.randint(0, 34, (4, 512, 1024)).astype(np.uint8)):
        cpu = augment.warp_affine_batch(torch.from_numpy(raw), M, (512, 1024), 128.0, nearest=nearest)
        card = augment.warp_affine_batch(torch.from_numpy(raw).to(cuda_device), M.to(cuda_device),
                                         (512, 1024), 128.0, nearest=nearest)
        assert card.device.type == "cuda"
        if nearest:
            assert torch.equal(card.cpu(), cpu)
        else:
            torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=IMG_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("enable_aug", [True, False])
def test_device_augment_batch_on_the_card_matches_the_cpu(cuda_device, enable_aug):
    rng = np.random.RandomState(3)
    B, hh, ww = 4, 512, 1024
    raw = torch.from_numpy(rng.randint(0, 256, (B, hh, ww, 3)).astype(np.uint8))
    segs = torch.from_numpy(np.repeat(np.repeat(rng.randint(0, 34, (B, hh // 16, ww // 16)), 16, 1), 16, 2)
                            .astype(np.uint8))
    labels = np.full((B, 200, 6), -1.0, np.float32)
    x1, y1 = rng.rand(2, B, 8) * 0.8
    labels[:, :8] = np.stack([rng.randint(0, 8, (B, 8)), x1, y1, x1 + 0.1, y1 + 0.1, rng.rand(B, 8)], -1)
    labels = torch.from_numpy(labels)
    params = torch.from_numpy(augment.sample_aug_params(B, (hh, ww), np.random.RandomState(233))
                              .astype(np.float32))
    lut = torch.from_numpy(seg_label_lut().astype(np.int32))
    cpu = device_pipeline.device_augment_batch(raw, segs, labels, params, lut, (hh, ww), enable_aug=enable_aug)
    card = device_pipeline.device_augment_batch(*(t.to(cuda_device) for t in (raw, segs, labels, params, lut)),
                                                (hh, ww), enable_aug=enable_aug)
    torch.testing.assert_close(card["label_det"].cpu(), cpu["label_det"], rtol=0, atol=1e-5)
    torch.testing.assert_close(card["images"].cpu(), cpu["images"], rtol=0, atol=IMG_ATOL)
    assert torch.equal(card["seg_label"].cpu(), cpu["seg_label"])


@pytest.mark.cuda
def test_prefetch_to_the_card(cuda_device):
    """Host arrays arrive on the card (copied on a side stream), equal;
    tensors already on the card pass through as they are, whether the
    device is named 'cuda' or 'cuda:0'."""
    for name in ("cuda", cuda_device):
        items = [{"x": np.full((3, 1000), i, np.float32), "y": torch.arange(i, i + 5),
                  "z": torch.full((4,), i, device=cuda_device)} for i in range(6)]
        out = list(prefetch_to_device(iter(items), size=2, device=name))
        for i, o in enumerate(out):
            assert o["x"].device.type == "cuda" and o["y"].device.type == "cuda"
            assert float((o["x"] * 2).sum()) == 2 * i * 3000
            assert torch.equal(o["y"].cpu(), torch.arange(i, i + 5))
            assert o["z"] is items[i]["z"]
