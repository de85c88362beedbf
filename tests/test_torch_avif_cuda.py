"""AVIF on the card: the four kernels of ``csrc/av1.cu``
(``data/av1_cuda.py``) against their plain versions bit for bit, every
committed form of ``tests/fixtures/avif_forms/`` against the sha256 cv2
gave, and the device loader over ``.avif`` files, with the launch counts
(the plain versions run 0 times on the card's path).

Skips without a CUDA device. The file imports no jax or cv2, so it runs on
the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_avif_cuda.py
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dspnet_torch.data import av1_cuda, av1_parse, avif, image_io

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

FORMS = Path(__file__).resolve().parent / "fixtures" / "avif_forms"
FLAGS = {"color": 1, "gray": 0, "unchanged": -1}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the AV1 kernels have no CPU mode")
    return torch.device("cuda:0")


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(np.ascontiguousarray(t.cpu().numpy()).tobytes()).hexdigest()


def _reset():
    for d in (av1_cuda.launches, av1_cuda.plain_calls):
        for k in d:
            d[k] = 0


@pytest.mark.cuda
def test_committed_forms_equal_cv2_on_the_card(cuda_device):
    """Every small form under every flag decodes through the kernels to
    cv2's sha256; where cv2 returns None it raises; no plain version runs
    and the reconstruction kernel launches."""
    meta = json.loads((FORMS / "forms.json").read_text())["files"]
    for name, m in sorted(meta.items()):
        if name.startswith("big_"):
            continue
        data = (FORMS / name).read_bytes()
        for key, flag in FLAGS.items():
            rec = m["cv2"][key]
            _reset()
            if rec is None:
                with pytest.raises(ValueError):
                    av1_cuda.decode(data, flag, cuda_device)
                continue
            got = av1_cuda.decode(data, flag, cuda_device)
            assert got.device.type == "cuda" and list(got.shape) == rec["shape"], (name, key)
            assert _sha(got) == rec["sha256"], (name, key)
            assert sum(av1_cuda.plain_calls.values()) == 0 and av1_cuda.launches["recon"] >= 1, (name, key)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cv2_default.avif", "cv2_s0.avif", "pil_screen.avif", "pil_lr.avif",
                                  "pil_444cdef.avif", "pil_422cdef.avif", "cv2_d12.avif", "pil_lossless.avif",
                                  "pil_s0.avif", "pil_deltalf.avif"])
def test_each_kernel_equals_its_plain_version(cuda_device, name):
    """recon, deblock, cdef and loop_restore on the card equal their plain
    versions on the same inputs, bit for bit."""
    p = avif.plan((FORMS / name).read_bytes())
    for coded in p.color + p.alpha:
        parsed = av1_parse.parse(coded.frame)
        st = av1_cuda.stage(av1_cuda.pack(parsed), cuda_device)
        ref = av1_cuda.recon_ref(st)
        got = av1_cuda.recon(st)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), name
        deb = av1_cuda.deblock(st, ref)
        assert all(torch.equal(a, b) for a, b in zip(deb, av1_cuda.deblock_ref(st, ref))), name
        cd = av1_cuda.cdef(st, deb)
        assert all(torch.equal(a, b) for a, b in zip(cd, av1_cuda.cdef_ref(st, deb))), name
        lr = av1_cuda.loop_restore(st, deb, cd)
        assert all(torch.equal(a, b) for a, b in zip(lr, av1_cuda.loop_restore_ref(st, deb, cd))), name


@pytest.mark.cuda
def test_device_loader_reads_avif_on_the_card(cuda_device, tmp_path):
    """``place_images`` on AVIF bytes decodes through the kernels to the
    plain reader's array."""
    from dspnet_torch.data.device_pipeline import place_images

    data = (FORMS / "cv2_default.avif").read_bytes()
    _reset()
    (img,) = place_images([data], cuda_device)
    assert av1_cuda.launches["recon"] >= 1 and sum(av1_cuda.plain_calls.values()) == 0
    np.testing.assert_array_equal(img.cpu().numpy(), image_io.imdecode(data, avif.IMREAD_COLOR))
