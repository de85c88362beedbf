"""The plain-SSD path on the card: the DetIterator's device work, cv2's five
resizes and the 8-bit colour conversions on CUDA tensors against the same
torch ops on the CPU, and the two kernels at this path's shapes against
their plain versions.

Skips without a CUDA device. The file imports no jax and no cv2, so it
runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_det_cuda.py
"""

import numpy as np
import pytest
import torch

from dspnet_torch.data import augment, device_pipeline, jpeg, jpeg_cuda, synthetic
from dspnet_torch.data.det_iterator import DetIterator, PlannedImages
from dspnet_torch.data.imdb import PascalVoc
from dspnet_torch.models import factory
from dspnet_torch.ops import matching_cuda, nms_cuda
from dspnet_torch.ops.boxes import iou_matrix


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the path's kernels and nvJPEG have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = synthetic.build_voc_dataset(str(tmp_path_factory.mktemp("voc")), num_samples=10, hw=(375, 500),
                                       seed=5)
    return PascalVoc("train", "", root, classes=synthetic.class_names()).index()


@pytest.mark.cuda
@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
def test_resizes_on_the_card_equal_the_cpu(cuda_device, interp):
    """Every interpolation, up, down and mixed factors, bit for bit."""
    rng = np.random.RandomState(interp)
    for src, dst in [((375, 500), (300, 300)), ((100, 150), (512, 512)), ((1500, 2000), (300, 300)),
                     ((97, 211), (300, 301)), ((600, 600), (300, 300)), ((900, 300), (300, 300))]:
        img = torch.from_numpy(rng.randint(0, 256, src + (3,)).astype(np.uint8))
        want = device_pipeline.resize(img, dst, interp)
        got = device_pipeline.resize(img.to(cuda_device), dst, interp).cpu()
        assert torch.equal(got, want), (interp, src, dst)


@pytest.mark.cuda
def test_colour_conversions_on_the_card_equal_the_cpu(cuda_device):
    """BGR2HSV and BGR2GRAY over all 2^24 colours, HSV2BGR over all
    180 x 256 x 256 values in rows of 90 (vector blocks and scalar tail)."""
    v = np.arange(256)
    b, g, r = np.meshgrid(v, v, v, indexing="ij")
    bgr = torch.from_numpy(np.stack([b, g, r], -1).astype(np.uint8).reshape(4096, 4096, 3))
    assert torch.equal(augment.bgr_to_hsv(bgr.to(cuda_device)).cpu(), augment.bgr_to_hsv(bgr))
    assert torch.equal(augment.bgr_to_gray(bgr.to(cuda_device)).cpu(), augment.bgr_to_gray(bgr))
    hh, ss, vv = np.meshgrid(np.arange(180), v, v, indexing="ij")
    hsv = torch.from_numpy(np.stack([hh, ss, vv], -1).astype(np.int32).reshape(-1, 90, 3))
    assert torch.equal(augment.hsv_to_bgr(hsv.to(cuda_device)).cpu(), augment.hsv_to_bgr(hsv))


@pytest.mark.cuda
def test_det_iterator_device_work_equals_the_cpu(cuda_device, voc):
    """The same plans on the same decoded pixels (the plain decoder's, copied
    to the card): crop / pad / mirror / resize / jitter / mean-sub on the
    card equal the CPU's bit for bit, over two epochs of train batches."""
    cpu_it = DetIterator(voc, 8, (300, 300), device="cpu")
    for _ in range(2):
        cpu_it.reset()
        while cpu_it.cursor < len(voc):
            planned = cpu_it.plan_batch()["images"]
            arrays = [jpeg.decode(x) for x in planned.items]
            want = PlannedImages(arrays, planned.plans, (300, 300), augment.MEAN_PIXELS).place_on("cpu")
            mean = torch.tensor(augment.MEAN_PIXELS, device=cuda_device)
            got = PlannedImages(arrays, planned.plans, (300, 300), mean).place_on(cuda_device)
            assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("is_train", [True, False])
def test_det_iterator_on_the_card_against_the_cpu(cuda_device, voc, is_train):
    """The whole iterator on the card (nvJPEG decode) against the CPU (plain
    decoder) from one seed: labels bit for bit, the plain decoder never runs
    on the card, one nvJPEG image per image read; the images differ only
    through nvJPEG's IDCT (``jpeg_cuda.GATES``: mean under half a level),
    which the resize keeps and the jitter may enlarge: mean |difference|
    under 1 level."""
    card = DetIterator(voc, 8, (300, 300), is_train=is_train, device=cuda_device)
    cpu = DetIterator(voc, 8, (300, 300), is_train=is_train, device="cpu")
    decodes, images = jpeg.decodes, jpeg_cuda.images
    diffs, n = [], 0
    for got, want in zip(card, cpu):
        assert got["images"].device.type == "cuda"
        assert torch.equal(got["label_det"].cpu(), want["label_det"])
        diffs.append((got["images"].cpu() - want["images"]).abs())
        n += got["images"].shape[0]
    assert n == 16
    decoded_on_cpu = jpeg.decodes - decodes
    assert jpeg_cuda.images - images == n and decoded_on_cpu == n  # the CPU iterator's own decodes
    assert float(torch.cat([d.flatten() for d in diffs]).mean()) < 1.0


def _nms_rows(rng, B, K, classes=20):
    cx, cy = rng.uniform(0.1, 0.9, (2, B, K))
    w, h = rng.uniform(0.05, 0.4, (2, B, K))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)
    valid = rng.rand(B, K) > 0.2
    ids = np.where(valid, rng.randint(0, classes, (B, K)), -1).astype(np.float32)
    return boxes, ids, valid


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("force", [False, True])
def test_nms_at_the_ssd_shapes(cuda_device, B, force):
    """K = 400 rows of 20 foreground classes (21 with the background), IoU
    threshold 0.45, with and without force_suppress: kernel == plain."""
    args = [torch.from_numpy(a).to(cuda_device) for a in _nms_rows(np.random.RandomState(B), B, 400)]
    before = nms_cuda.launches
    got = nms_cuda.nms_keep_mask(*args, 0.45, force)
    want = nms_cuda.nms_keep_mask_reference(*args, 0.45, force)
    assert nms_cuda.launches == before + 1
    assert torch.equal(got, want)


def _corners(rng, *shape, lo=0.05, hi=0.3):
    cx, cy = rng.uniform(0.1, 0.9, (2, *shape))
    w, h = rng.uniform(lo, hi, (2, *shape))
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("network,size,B", [("vgg16_reduced", 300, 8), ("vgg16_reduced", 300, 32),
                                            ("vgg16_reduced", 512, 8)])
@pytest.mark.parametrize("crowded", [False, True])
def test_matcher_at_the_ssd_shapes(cuda_device, network, size, B, crowded):
    """The preset's anchors (A = 8,732 / 24,576) against L = 100 label rows
    (DetIterator.max_objects), random GTs or 60 jittered around one centre:
    kernel == plain, every valid column matched once."""
    anchors = torch.from_numpy(factory.build_anchors(factory.get_config(network, size), (size, size)))
    rng = np.random.RandomState(size + B + crowded)
    if crowded:
        c = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
        gts = c + rng.normal(0, 0.02, (B, 100, 4)).astype(np.float32) + np.array([-0.2, -0.2, 0.2, 0.2], np.float32)
        num_gt = 60
    else:
        gts = _corners(rng, B, 100, lo=0.1, hi=0.4)
        num_gt = 12
    col_valid = torch.zeros(B, 100, dtype=torch.bool)
    col_valid[:, :num_gt] = True
    iou = iou_matrix(anchors.to(cuda_device)[None].expand(B, -1, -1),
                     torch.from_numpy(gts).to(cuda_device)).contiguous()
    col_valid = col_valid.to(cuda_device)
    before = matching_cuda.launches
    got = matching_cuda.bipartite_match(iou, col_valid)
    want = matching_cuda.bipartite_match_reference(iou, col_valid)
    assert matching_cuda.launches == before + 1
    for g, w, name in zip(got, want, ("matched", "match_gt", "match_iou")):
        assert torch.equal(g, w), name
    assert int(got[0].sum()) == B * num_gt
