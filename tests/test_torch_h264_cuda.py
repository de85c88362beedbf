"""``data/h264_cuda.py`` on a card: the three kernels of ``csrc/h264.cu``
built by nvcc. Every committed form of ``tests/fixtures/h264_forms/``
decoded on the card gives cv2's frames (``forms.json``'s sha256), with no
plain stage; each kernel equals its plain version picture by picture on
forms of every tool. Skips without a card (``chip_smoke.py`` phase 23 runs
the same checks and times the kernels)."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dspnet_torch.data import avi, h264_cuda

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
FORMS = ROOT / "tests" / "fixtures" / "h264_forms"
META = json.loads((FORMS / "forms.json").read_text())["forms"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the H.264 kernels have no interpret mode (the emulated test runs their "
                    "source on the CPU)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("name", sorted(n for n, m in META.items() if "refused" not in m))
def test_forms_on_the_card_give_cv2s_frames(name):
    dev = _card()
    with avi.open_video(FORMS / name) as reader:
        samples, stream = list(reader), reader.stream
    for d in (h264_cuda.launches, h264_cuda.plain_calls):
        d.update(dict.fromkeys(d, 0))
    dec = h264_cuda.Decoder(dev, stream.extradata, stream.fourcc)
    frames = []
    for i in range(0, len(samples), 8):
        frames += dec.decode(samples[i:i + 8])
    frames += dec.flush()
    got = [hashlib.sha256(np.ascontiguousarray(f.cpu().numpy()).tobytes()).hexdigest() for f in frames]
    assert got == META[name]["bgr_sha256"]
    assert h264_cuda.plain_calls == dict.fromkeys(h264_cuda.plain_calls, 0)
