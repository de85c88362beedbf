"""The still-image formats on the card: the device loader and the detector
over BMP, TIFF, WebP, GIF and PPM files decode them on the host
(``data/image_io.py``), upload the arrays and take the card's path from
there; nvJPEG, the colour kernel and the plain JPEG decoder are not used.

Skips without a CUDA device. The file imports no jax or cv2, so it runs on
the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_image_formats_cuda.py
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dspnet_torch.data import image_io, jpeg, jpeg_cuda, synthetic

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

FORMS = Path(__file__).resolve().parent / "fixtures" / "image_forms"
FLAGS = {"color": 1, "gray": 0, "unchanged": -1}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the loader's and the detector's card path")
    return torch.device("cuda:0")


def _reset():
    jpeg_cuda.launches = jpeg_cuda.images = jpeg_cuda.color_launches = jpeg_cuda.color_plain_calls = 0
    jpeg.decodes = 0


@pytest.mark.cuda
def test_committed_forms_equal_their_record_on_the_cards_machine(cuda_device):
    """Every committed form decodes on the card's machine to the sha256
    cv2 gave (or raises where cv2 returns None or would overrun a PAM)."""
    meta = json.loads((FORMS / "forms.json").read_text())["files"]
    for name, m in sorted(meta.items()):
        data = (FORMS / name).read_bytes()
        for key, flag in FLAGS.items():
            rec = m["cv2"][key]
            if rec is None:
                with pytest.raises(ValueError):
                    image_io.imdecode(data, flag)
                continue
            img = image_io.imdecode(data, flag)
            if "columns" in rec:
                img = img[:, :rec["columns"]]
            assert hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest() == rec["sha256"], (name, key)


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [".bmp", ".tif", ".webp", ".gif", ".ppm"])
def test_device_loader_batch_equals_the_host_decodes(cuda_device, tmp_path, ext):
    """One ``DeviceAugIterator`` batch over files of one format: equal to
    the per-image host decodes uploaded and augmented; no nvJPEG image, no
    colour launch, no plain JPEG decode."""
    from dspnet_torch.data.device_pipeline import DeviceAugIterator, device_augment_batch
    from dspnet_torch.data.iterator import Sample, SampleIndex

    rng = np.random.RandomState(3)
    samples = []
    for i in range(3):
        img, rows = synthetic.make_example(rng, (96, 160), 4)[:2]
        path = image_io.imwrite(str(tmp_path / f"im{i}{ext}"), img)
        samples.append(Sample(path, SampleIndex.pad_label(rows), None))
    _reset()
    it = DeviceAugIterator(SampleIndex(samples), 3, (64, 128), device=cuda_device, seed=5, enable_aug=False,
                           shuffle=False)
    (batch, _), = list(it.epoch())
    assert (jpeg_cuda.images, jpeg_cuda.color_launches, jpeg.decodes) == (0, 0, 0)
    raw = torch.stack([torch.from_numpy(image_io.imread(s.image_path)).to(cuda_device) for s in samples])
    labels = torch.from_numpy(np.stack([s.label for s in samples]).astype(np.float32))
    ref = device_augment_batch(raw, None, labels, torch.zeros(3, 6), it.lut, (64, 128), enable_aug=False,
                               mean_pixels=it.mean_pixels)
    assert torch.equal(batch["images"], ref["images"])


@pytest.mark.cuda
@pytest.mark.parametrize("ext", [".bmp", ".tif", ".webp", ".gif", ".ppm"])
def test_detector_reads_the_host_decode(cuda_device, tmp_path, ext):
    """``Detector.read_image`` of a non-JPEG file: the host decode, on the
    card, with no JPEG route taken."""
    from dspnet_torch.api import create_model
    from dspnet_torch.detect.detector import Detector

    img = synthetic.make_example(np.random.RandomState(4), (90, 150), 4)[0]
    path = image_io.imwrite(str(tmp_path / f"x{ext}"), img)
    bundle = create_model("resnet-18_multi", (128, 256), device=cuda_device)
    det = Detector(bundle.model, bundle.anchors, (128, 256), device=cuda_device)
    _reset()
    got = det.read_image(path)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), torch.from_numpy(image_io.imread(path)))
    dets, seg = det.im_detect_single(path)
    assert dets.ndim == 2 and seg.ndim == 2
    assert (jpeg_cuda.images, jpeg_cuda.color_launches, jpeg.decodes) == (0, 0, 0)
