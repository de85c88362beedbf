"""MPEG-4 Part 2 on the card: the three kernels of ``csrc/mpeg4.cu``
(``data/mpeg4_cuda.py``) against their plain versions bit for bit on every
committed form of ``tests/fixtures/mp4v_forms/`` (cv2's 2048x1024 clip
among them: half-pel MVs with large ``f_code``, both rounding types, MVs
off the frame's edges) and on a clip of the port's writer encoded on the
card, every form against the sha256 cv2 gave, the refusals, and the launch
counts (no plain version called).

Skips without a CUDA device. The file imports no jax or cv2, so it runs on
the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mp4v_cuda.py
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dspnet_torch.data import avi, mp4, mpeg4, mpeg4_cuda

FORMS = Path(__file__).resolve().parent / "fixtures" / "mp4v_forms"
META = json.loads((FORMS / "forms.json").read_text())
DECODED = sorted(n for n, m in META.items() if m["source"] != "refusal")
REFUSED = sorted(n for n, m in META.items() if m["source"] == "refusal")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MPEG-4 kernels have no CPU mode")
    return torch.device("cuda:0")


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(np.ascontiguousarray(t.cpu().numpy()).tobytes()).hexdigest()


def _reset():
    for d in (mpeg4_cuda.launches, mpeg4_cuda.plain_calls):
        for k in d:
            d[k] = 0


def kernels_against_plain(samples, config, fourcc, dev):
    """Each stage of every batch of 8 through the kernel and its plain
    version on the same inputs -> the frames the kernels gave; raises
    AssertionError on the first difference."""
    dec = mpeg4_cuda.Decoder(dev, config, fourcc)
    frames = []
    for i in range(0, len(samples), 8):
        chunk = samples[i:i + 8]
        headers = [mpeg4.read_vop_header(s, dec.vol) for s in chunk]
        coded = [(s, h) for s, h in zip(chunk, headers) if h.coded]
        if not coded:
            continue
        bits, vops = mpeg4_cuda.stage([c[0] for c in coded], [c[1] for c in coded], dev)
        mb, levels = mpeg4_cuda.parse(bits, vops, dec.vol)
        mb_ref, levels_ref = mpeg4_cuda.parse_ref(bits.cpu(), vops.cpu(), dec.vol)
        assert torch.equal(mb.cpu(), mb_ref) and torch.equal(levels.cpu(), levels_ref), f"parse, batch at {i}"
        for k, (_, hdr) in enumerate(coded):
            ref = dec.ref if hdr.kind == "P" else None
            planes = mpeg4_cuda.recon(mb[k], levels[k], dec.vol, hdr.rounding, ref)
            want = mpeg4_cuda.recon_ref(mb_ref[k], levels_ref[k], dec.vol, hdr.rounding,
                                        None if ref is None else tuple(p.cpu() for p in ref))
            assert all(torch.equal(p.cpu(), w) for p, w in zip(planes, want)), f"recon, VOP {i + k}"
            dec.ref = planes
            frame = mpeg4_cuda.yuv420_to_bgr(*planes, dec.vol.height, dec.vol.width)
            plain = mpeg4.yuv420_to_bgr(*(p.cpu() for p in planes), dec.vol.height, dec.vol.width)
            assert torch.equal(frame.cpu(), plain), f"colour, VOP {i + k}"
            frames.append(frame)
    return frames


@pytest.mark.cuda
@pytest.mark.parametrize("name", DECODED)
def test_forms_equal_cv2_through_the_kernels(cuda_device, name):
    """Every committed form decodes on the card to cv2's sha256 per frame
    (the odd-height form to the port's own, the deliberate difference),
    through the three kernels (launched, no plain version called),
    and each kernel equals its plain version on it stage by stage."""
    with avi.open_video(FORMS / name) as reader:
        samples, stream = list(reader), reader.stream
    _reset()
    dec = mpeg4_cuda.Decoder(cuda_device, stream.extradata, stream.fourcc)
    frames = [f for i in range(0, len(samples), 8) for f in dec.decode(samples[i:i + 8])]
    torch.cuda.synchronize()
    want = META[name].get("port_bgr_sha256", META[name]["bgr_sha256"])  # an odd height: the port's own
    assert [_sha(f) for f in frames] == want
    n = len(frames)
    assert mpeg4_cuda.launches == {"mp4v_parse": (len(samples) + 7) // 8,
                                   "mp4v_recon": n, "yuv420_to_bgr": n}
    assert all(v == 0 for v in mpeg4_cuda.plain_calls.values())
    again = kernels_against_plain(samples, stream.extradata, stream.fourcc, cuda_device)
    assert [_sha(f) for f in again] == want


@pytest.mark.cuda
@pytest.mark.parametrize("name", REFUSED)
def test_refusals_on_the_card(cuda_device, name):
    """Each refused tool raises naming it (from the VOL headers or a VOP's)
    before any launch."""
    _reset()
    with avi.open_video(FORMS / name) as reader:
        with pytest.raises(avi.VideoError, match=META[name]["refused"].replace("(", "\\(").replace(")", "\\)")):
            mpeg4_cuda.Decoder(cuda_device, reader.stream.extradata, reader.stream.fourcc).decode(list(reader))
    assert all(v == 0 for v in mpeg4_cuda.launches.values())


@pytest.mark.cuda
def test_the_writer_on_the_card(cuda_device, tmp_path):
    """The port's writer encoding on the card (a 13-frame 256x512 clip, two
    GOPs, into an MP4): the kernels equal their plain versions on it, and
    the decoded frames are the writer's own reconstruction."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)).to(cuda_device)
    base = torch.nn.functional.interpolate(base.permute(2, 0, 1)[None].float(), scale_factor=8, mode="bilinear")
    base = base[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)
    enc = mpeg4.Encoder(512, 256)
    recons = []
    with mp4.Mp4Writer(str(tmp_path / "clip.mp4"), 512, 256, enc.config) as w:
        for i in range(13):
            w.write(*enc.encode(base[i * 3:i * 3 + 256, i * 5:i * 5 + 512].contiguous()))
            recons.append(mpeg4.yuv420_to_bgr(*(p.to(torch.uint8) for p in enc.ref), 256, 512))
    with avi.open_video(tmp_path / "clip.mp4") as reader:
        frames = kernels_against_plain(list(reader), reader.stream.extradata, "mp4v", cuda_device)
    assert len(frames) == 13 and all(torch.equal(f, r) for f, r in zip(frames, recons))
