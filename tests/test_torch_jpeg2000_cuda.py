"""JPEG 2000 on the card: the three kernels of ``csrc/jpeg2000.cu``
(``data/jpeg2000_cuda.py``) against their plain versions bit for bit, every
committed form of ``tests/fixtures/jpeg2000_forms/`` against the sha256 cv2
gave, and the device loader and the DET loader over ``.jp2`` files, with
the launch counts (the plain decoder's whole-image count stays 0).

Skips without a CUDA device. The file imports no jax or cv2, so it runs on
the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_jpeg2000_cuda.py
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dspnet_torch.data import image_io, jpeg, jpeg2000, jpeg2000_cuda, jpeg_cuda, synthetic

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

FORMS = Path(__file__).resolve().parent / "fixtures" / "jpeg2000_forms"
FLAGS = {"color": 1, "gray": 0, "unchanged": -1}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the JPEG 2000 kernels have no CPU mode")
    return torch.device("cuda:0")


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(np.ascontiguousarray(t.cpu().numpy()).tobytes()).hexdigest()


def _reset():
    for d in (jpeg2000_cuda.launches, jpeg2000_cuda.plain_calls):
        for k in d:
            d[k] = 0
    jpeg2000.decodes = jpeg.decodes = jpeg_cuda.images = 0


@pytest.mark.cuda
def test_committed_forms_equal_cv2_on_the_card(cuda_device):
    """Every form under every flag decodes through the kernels to cv2's
    sha256; where cv2 returns None it raises; a palette raises on the card
    and decodes on the host to cv2's array. No plain decode on the card."""
    meta = json.loads((FORMS / "forms.json").read_text())["files"]
    for name, m in sorted(meta.items()):
        data = (FORMS / name).read_bytes()
        palette = jpeg2000.read_boxes(data).pclr is not None
        for key, flag in FLAGS.items():
            rec = m["cv2"][key]
            _reset()
            if rec is None or palette:
                with pytest.raises(ValueError):
                    jpeg2000_cuda.decode(data, flag, cuda_device)
                if rec is not None:
                    assert hashlib.sha256(np.ascontiguousarray(jpeg2000.decode(data, flag)).tobytes()).hexdigest() \
                        == rec["sha256"], (name, key)
                continue
            got = jpeg2000_cuda.decode(data, flag, cuda_device)
            assert got.device.type == "cuda" and list(got.shape) == rec["shape"], (name, key)
            assert _sha(got) == rec["sha256"], (name, key)
            assert jpeg2000.decodes == 0 and sum(jpeg2000_cuda.plain_calls.values()) == 0
            assert jpeg2000_cuda.launches["t1_decode"] == 1 and jpeg2000_cuda.launches["mct_store"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pil_97_tiles_rpcl.jp2", "pil_53_tiles_cprl.jp2", "port_style_all_styles.jp2",
                                  "port_roi.jp2", "port_levels0.jp2", "box_cdef_reversed.jp2", "cv2_u16.jp2"])
def test_each_kernel_equals_its_plain_version(cuda_device, name):
    """t1_decode, idwt and mct_store on the card equal t1_decode_ref,
    idwt_ref and mct_store_ref on the same inputs, bit for bit."""
    data = (FORMS / name).read_bytes()
    packed = jpeg2000_cuda.pack(jpeg2000.prepare(data), jpeg2000.IMREAD_UNCHANGED)
    st = jpeg2000_cuda.stage(packed, cuda_device)
    coef = jpeg2000_cuda.t1_decode(st)
    ref = jpeg2000_cuda.t1_decode_ref(st)
    torch.cuda.synchronize()
    assert torch.equal(coef, ref), name
    samples = jpeg2000_cuda.idwt(st, coef.clone())
    assert torch.equal(samples, jpeg2000_cuda.idwt_ref(st, ref)), name
    got = jpeg2000_cuda.mct_store(st, samples)
    want = jpeg2000_cuda.mct_store_ref(st, samples)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy(), err_msg=name)


@pytest.mark.cuda
def test_device_loader_decodes_jp2_on_the_card(cuda_device, tmp_path):
    """One ``DeviceAugIterator`` batch over ``.jp2`` files: the kernels run
    once an image, no nvJPEG image and no plain decode, and the batch equals
    the host decodes uploaded and augmented."""
    from dspnet_torch.data.device_pipeline import DeviceAugIterator, device_augment_batch
    from dspnet_torch.data.iterator import Sample, SampleIndex

    rng = np.random.RandomState(3)
    samples = []
    for i in range(3):
        img, rows = synthetic.make_example(rng, (96, 160), 4)[:2]
        path = image_io.imwrite(str(tmp_path / f"im{i}.jp2"), img)
        samples.append(Sample(path, SampleIndex.pad_label(rows), None))
    _reset()
    it = DeviceAugIterator(SampleIndex(samples), 3, (64, 128), device=cuda_device, seed=5, enable_aug=False,
                           shuffle=False)
    (batch, _), = list(it.epoch())
    assert jpeg2000_cuda.launches["t1_decode"] == 3 and jpeg2000_cuda.launches["mct_store"] == 3
    assert (jpeg_cuda.images, jpeg2000.decodes, sum(jpeg2000_cuda.plain_calls.values())) == (0, 0, 0)
    raw = torch.stack([torch.from_numpy(image_io.imread(s.image_path)).to(cuda_device) for s in samples])
    labels = torch.from_numpy(np.stack([s.label for s in samples]).astype(np.float32))
    ref = device_augment_batch(raw, None, labels, torch.zeros(3, 6), it.lut, (64, 128), enable_aug=False,
                               mean_pixels=it.mean_pixels)
    assert torch.equal(batch["images"], ref["images"])


@pytest.mark.cuda
def test_detector_reads_jp2_through_the_kernels(cuda_device, tmp_path):
    """``Detector.read_image`` of a ``.jp2`` file decodes it on the card by
    the kernels, to the host decode's pixels."""
    from dspnet_torch.api import create_model
    from dspnet_torch.detect.detector import Detector

    img = synthetic.make_example(np.random.RandomState(4), (90, 150), 4)[0]
    path = image_io.imwrite(str(tmp_path / "x.jp2"), img)
    bundle = create_model("resnet-18_multi", (128, 256), device=cuda_device)
    det = Detector(bundle.model, bundle.anchors, (128, 256), device=cuda_device)
    _reset()
    got = det.read_image(path)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), torch.from_numpy(img))
    assert jpeg2000_cuda.launches["t1_decode"] == 1 and jpeg2000.decodes == 0 and jpeg_cuda.images == 0


@pytest.mark.cuda
def test_det_loader_reads_jp2_bytes_for_the_card(cuda_device, tmp_path):
    """The DET loader hands a ``.jp2`` file's bytes to the card, where the
    kernels decode them to the host decode's pixels."""
    from dspnet_torch.data.device_pipeline import place_images

    img = synthetic.make_example(np.random.RandomState(4), (70, 90), 3)[0]
    data = image_io.imencode(".jp2", img)
    _reset()
    (t,) = place_images([data], cuda_device)
    assert torch.equal(t.cpu(), torch.from_numpy(img))
    assert jpeg2000_cuda.launches["t1_decode"] == 1 and jpeg2000.decodes == 0
