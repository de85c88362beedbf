"""MPEG-4 Part 2 on the CPU: the decoder (``data/mpeg4_cuda.py``'s
``Decoder`` on the CPU, which runs ``data/mpeg4.py``'s plain stages) against
cv2 5.0.0 bit for bit on every committed form of ``tests/fixtures/mp4v_forms/``
(BGR, and the luma plane cv2 returns with ``CAP_PROP_CONVERT_RGB`` 0), the
refusals by name, ``data/mp4.py``'s demuxer and muxer, and the writer
(``mpeg4.Encoder`` into ``mp4.Mp4Writer``) read back by cv2: the right frame
count, 25 fps and size, the port's decoder equal to cv2's frames of it, and
its PSNR against the input no lower than cv2's own ``mp4v`` writer's less
1 dB. The forms come from ``python tests/make_mp4v_fixtures.py``.
"""

import hashlib
import json
import os
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from dspnet_torch.data import avi, mp4, mpeg4, mpeg4_cuda

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

FORMS = Path(__file__).resolve().parent / "fixtures" / "mp4v_forms"
META = json.loads((FORMS / "forms.json").read_text())
DECODED = sorted(n for n, m in META.items() if m["source"] != "refusal")
REFUSED = sorted(n for n, m in META.items() if m["source"] == "refusal")


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _decoder(reader) -> mpeg4_cuda.Decoder:
    return mpeg4_cuda.Decoder("cpu", reader.stream.extradata, reader.stream.fourcc)


def _decode(path):
    """(BGR frames, luma planes, stream) of a file by the decoder on the CPU."""
    with avi.open_video(path) as reader:
        dec = _decoder(reader)
        planes = dec.decode_planes(list(reader))
        stream = reader.stream
    h, w = dec.vol.height, dec.vol.width
    frames = [mpeg4.yuv420_to_bgr(*p, h, w).numpy() for p in planes]
    return frames, [p[0][:h, :w].numpy() for p in planes], stream


def _cv2_read(path):
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    fps, count = cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return frames, fps, count


# ------------------------------------------------------------------ tables


@pytest.mark.parametrize("name", ["INTRA_MCBPC", "INTER_MCBPC", "CBPY", "MVTAB", "DC_LUM", "DC_CHROM", "INTRA_VLC",
                                  "INTER_VLC"])
def test_vlc_tables_are_complete_prefix_codes(name):
    """Each VLC table is prefix-free, and its Kraft sum leaves exactly the
    prefixes the standard leaves unused (all zeros: 1/512 of the TCOEF and
    inter MCBPC code space, 1/2048 of the MV table's with its sign bits,
    ...), so a slip in a code or a length shows; the TCOEF tables hold 102
    codes and the escape, in the (last, run, level) order of their LMAX."""
    from fractions import Fraction

    codes = [c for c in getattr(mpeg4, name) if c[1]]
    bits = [format(c, f"0{n}b") for c, n in codes]
    assert len(set(bits)) == len(bits)
    for a in bits:
        assert not any(b != a and b.startswith(a) for b in bits), a
    if name == "MVTAB":  # every code but 0 carries a sign bit
        kraft = Fraction(1, 2 ** codes[0][1]) + sum(Fraction(2, 2 ** (n + 1)) for _, n in codes[1:])
    else:
        kraft = sum(Fraction(1, 2 ** n) for _, n in codes)
    unused = {"INTRA_MCBPC": Fraction(7, 512), "INTER_MCBPC": Fraction(1, 512), "CBPY": Fraction(1, 32),
              "MVTAB": Fraction(1, 2048), "DC_LUM": Fraction(1, 2048), "DC_CHROM": Fraction(1, 4096),
              "INTRA_VLC": Fraction(1, 512), "INTER_VLC": Fraction(1, 512)}[name]
    assert 1 - kraft == unused
    if name in ("INTRA_VLC", "INTER_VLC"):
        rll = mpeg4.INTRA_RLL if name == "INTRA_VLC" else mpeg4.INTER_RLL
        assert len(codes) == 103 and len(rll) == 102 and len(set(rll)) == 102


def test_scans_and_luts():
    """The three scans are permutations, the vertical one the horizontal
    one transposed; every lookup table entry decodes its own code."""
    for scan in (mpeg4.ZIGZAG, mpeg4.ALT_HORIZONTAL, mpeg4.ALT_VERTICAL):
        assert sorted(scan) == list(range(64))
    assert mpeg4.ZIGZAG[:10] == [0, 1, 8, 16, 9, 2, 3, 10, 17, 24]
    luts = mpeg4.luts()
    tables = [mpeg4.INTRA_MCBPC, mpeg4.INTER_MCBPC[:21], mpeg4.CBPY, mpeg4.MVTAB, mpeg4.DC_LUM, mpeg4.DC_CHROM,
              mpeg4.INTRA_VLC, mpeg4.INTER_VLC]
    for lut, table in zip(luts, tables):
        for sym, (code, n) in enumerate(table):
            if n:
                e = int(lut[code << (mpeg4.LUT_BITS - n)])
                assert (e >> 8, e & 0xFF) == (sym, n)


# ------------------------------------------------------------------ the forms


@pytest.mark.parametrize("name", DECODED)
def test_plain_decoder_equals_cv2(name):
    """Every frame of every committed form, BGR and luma, equals cv2's
    sha256; the reader's size, fps and frame count are cv2's (a VOP with
    ``vop_coded`` 0 gives cv2 no frame, and none here)."""
    m = META[name]
    frames, lumas, stream = _decode(FORMS / name)
    assert (stream.width, stream.height, stream.fps) == (m["width"], m["height"], m["fps"])
    assert len(frames) == m["frames"]
    assert [_sha(f) for f in lumas] == m["luma_sha256"]
    # an odd height: the deliberate difference (the test below), the port's
    # own frames pinned
    assert [_sha(f) for f in frames] == m.get("port_bgr_sha256", m["bgr_sha256"])
    if name == "w_not_coded.mp4":
        assert (m["samples"], m["frames"], m["declared"]) == (6, 4, 6)


def test_odd_height_colour_is_a_deliberate_difference():
    """At an odd height cv2 converts YUV to BGR through swscale's scaling
    path, not the unscaled converter whose rule the port follows: on the
    96x63 form the decoded planes equal cv2's (the luma plane bit for bit)
    and the BGR frames differ from cv2's by the measured gap, a mean of
    8.6616 levels and at most 201 (cv2 5.0.0). An even height with an odd
    width follows cv2 bit for bit. The port's writer cuts an odd side to
    even, as cv2's writer does, so it writes no such stream."""
    name = "w_odd_height.mp4"
    assert META[name]["bgr_gap"] == {"mean": 8.6616, "max": 201}
    frames, lumas, _ = _decode(FORMS / name)
    theirs, _, _ = _cv2_read(FORMS / name)
    assert [_sha(f) for f in lumas] == META[name]["luma_sha256"]
    gap = np.concatenate([np.abs(a.astype(np.int16) - b).ravel() for a, b in zip(frames, theirs)])
    assert (round(float(gap.mean()), 4), int(gap.max())) == (8.6616, 201)
    enc = mpeg4.Encoder(33, 25)
    data, _ = enc.encode(torch.zeros(25, 33, 3, dtype=torch.uint8))
    assert (enc.width, enc.height) == (32, 24)
    assert mpeg4.parse_config(enc.config).height == 24


def test_forms_json_is_cv2s_reading():
    """cv2 here decodes the committed forms to the recorded sha256s (the
    fixture is cv2's reading, not the port's)."""
    for name in DECODED:
        frames, fps, _ = _cv2_read(FORMS / name)
        assert [_sha(f) for f in frames] == META[name]["bgr_sha256"], name


@pytest.mark.parametrize("name", REFUSED)
def test_refusals_name_the_tool(name):
    """Each refused tool raises ``mpeg4.Mpeg4Error`` (a ``VideoError``)
    naming what it found, before any frame."""
    with pytest.raises(avi.VideoError, match=META[name]["refused"].replace("(", "\\(").replace(")", "\\)")):
        with avi.open_video(FORMS / name) as reader:
            _decoder(reader).decode(list(reader))


def test_what_the_forms_pin():
    """The forms reach FFmpeg's x86 rules (the plain decoder equals cv2 on
    them only with those rules): in ``w_codes.mp4`` an I-VOP row leaves
    int16 in the IDCT's row pass (the saturating store) and escape 3 reaches
    +-2047; ``w_rounding.mp4``'s reference holds samples of 0 beside odd ones
    under rounding-type-1 P-VOPs with half-pel 4MV and 1MV macroblocks (the
    8-wide approximation, the exact 16x16 average)."""
    with avi.open_video(FORMS / "w_codes.mp4") as reader:
        vol = mpeg4.parse_config(reader.stream.extradata)
        sample = next(iter(reader))
    hdr = mpeg4.read_vop_header(sample, vol)
    mb, levels = mpeg4.parse_vop(sample, vol, hdr)
    r = mpeg4.dequantize(torch.from_numpy(levels), torch.from_numpy(mb), vol).reshape(-1, 8, 8)
    raw = torch.stack(mpeg4._butterfly(*[r[..., k] for k in range(8)], mpeg4.W4 * r[..., 0] + 1024), -1) >> 11
    assert (raw.abs() > 32767).any()
    assert np.abs(levels).max() == 2047
    with avi.open_video(FORMS / "w_rounding.mp4") as reader:
        dec = _decoder(reader)
        samples = list(reader)
    (y, u, v), = dec.decode_planes(samples[:1])
    for plane in (y, u, v):
        p = plane.numpy().astype(int)
        assert ((p[:, :-1] == 0) & (p[:, 1:] % 2 == 1)).any() and ((p[:-1] == 0) & (p[1:] % 2 == 1)).any()
    for sample in samples[1:]:
        hdr = mpeg4.read_vop_header(sample, dec.vol)
        mb, _ = mpeg4.parse_vop(sample, dec.vol, hdr)
        assert hdr.rounding == 1 and {mpeg4.MODE_INTER, mpeg4.MODE_INTER4V} <= set(mb[:, 0].tolist())
        assert (mb[:, 4:12] & 1).any()


# ------------------------------------------------------------------ mp4


def test_mp4_reader_against_cv2():
    """The demuxer on cv2's files: mp4v sample entry, the esds's VOL, the
    sample count cv2 reports, stts' fps, stss' I-VOPs (every 12th)."""
    with mp4.Mp4Reader(str(FORMS / "cv2_mp4v.mp4")) as r:
        assert (r.stream.fourcc, r.stream.codec, len(r), r.stream.fps) == ("mp4v", "mpeg4", 26, 25.0)
        assert r.stream.extradata.startswith(b"\x00\x00\x01\xb0")
        assert r.keyframes == [0, 12, 24]
        vol = mpeg4.parse_config(r.stream.extradata)
        assert (vol.width, vol.height, vol.user_data[0][:4]) == (176, 144, b"Lavc")
    assert avi.probe_mp4(str(FORMS / "cv2_mp4v.mp4")) == mp4.probe_mp4(str(FORMS / "cv2_mp4v.mp4")) == "mp4v"


def _boxes_of(data: bytes, kind: bytes):
    return [(k, p, e) for k, p, e in mp4.boxes(data, 0, len(data)) if k == kind]


def test_mp4_refusals(tmp_path):
    """A fragmented file, an edit list that shifts frames and two video
    tracks are refused by name."""
    data = (FORMS / "w_dquant.mp4").read_bytes()
    (tmp_path / "frag.mp4").write_bytes(data + struct.pack(">I4s", 16, b"moof") + bytes(8))
    i = data.index(b"elst") + 4 + 4 + 4 + 4  # version/flags, count, segment duration
    (tmp_path / "shift.mp4").write_bytes(data[:i] + struct.pack(">i", 512) + data[i + 4:])
    _, p, e = _boxes_of(data, b"moov")[0]
    trak = next((p2 - 8, e2) for k, p2, e2 in mp4.boxes(data, p, e) if k == b"trak")
    body = data[p:e] + data[trak[0]:trak[1]]
    (tmp_path / "two.mp4").write_bytes(data[:p - 8] + struct.pack(">I4s", 8 + len(body), b"moov") + body)
    for name, words in (("frag.mp4", "fragmented"), ("shift.mp4", "edit list"), ("two.mp4", "2 video tracks")):
        with pytest.raises(avi.VideoError, match=words):
            avi.open_video(tmp_path / name)


def test_mp4_writer_layout(tmp_path):
    """ftyp, free, mdat, moov in cv2's order; stss lists the I-VOPs; the
    chunk offsets go to co64 once a sample lies past 4 GiB."""
    enc = mpeg4.Encoder(48, 32)
    with mp4.Mp4Writer(str(tmp_path / "a.mp4"), 48, 32, enc.config) as w:
        for k in range(14):
            w.write(*enc.encode(torch.full((32, 48, 3), 10 * k, dtype=torch.uint8)))
        moov = w._moov()
        w._offsets[-1] = 1 << 32
        assert b"co64" in w._moov() and b"stco" not in w._moov()
    data = (tmp_path / "a.mp4").read_bytes()
    assert [k for k, _, _ in mp4.boxes(data, 0, len(data))] == [b"ftyp", b"free", b"mdat", b"moov"]
    assert b"stco" in moov
    with mp4.Mp4Reader(str(tmp_path / "a.mp4")) as r:
        assert r.keyframes == [0, 12] and len(r) == 14


# ------------------------------------------------------------------ the writer


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    return float(10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2)))


def test_writer_read_back_by_cv2(tmp_path):
    """The port's writer at 200x120 (not a multiple of 16), 26 frames (three
    GOPs): cv2 reads it with the right count, 25 fps and size; the port's
    decoder returns exactly cv2's frames, and the writer's reconstruction
    is the decoder's; its PSNR against the input frames is at least cv2's
    own mp4v writer's on the same frames less 1 dB (both printed)."""
    from tests import make_mp4v_fixtures as fx

    frames = fx.clip(np.random.default_rng(5), 120, 200, 26, (2.5, -1.5))
    enc = mpeg4.Encoder(200, 120)
    out = tmp_path / "port.mp4"
    recons = []
    with mp4.Mp4Writer(str(out), 200, 120, enc.config) as w:
        for f in frames:
            w.write(*enc.encode(torch.from_numpy(f)))
            recons.append(enc.ref)
    got, fps, count = _cv2_read(out)
    assert (len(got), fps, count, got[0].shape) == (26, 25.0, 26, (120, 200, 3))
    mine, _, _ = _decode(out)
    assert len(mine) == 26 and all(np.array_equal(a, b) for a, b in zip(mine, got))
    with avi.open_video(out) as reader:
        planes = _decoder(reader).decode_planes(list(reader))
    assert len(planes) == 26
    for p, rec in zip(planes, recons):
        assert all(np.array_equal(a.numpy(), b.numpy()) for a, b in zip(p, rec))
    fx.cv2_write(tmp_path / "cv2.mp4", "mp4v", frames)
    theirs, _, _ = _cv2_read(tmp_path / "cv2.mp4")
    port_psnr = np.mean([_psnr(a, b) for a, b in zip(got, frames)])
    cv2_psnr = np.mean([_psnr(a, b) for a, b in zip(theirs, frames)])
    print(f"PSNR: port {port_psnr:.2f} dB ({os.path.getsize(out)} bytes), "
          f"cv2 {cv2_psnr:.2f} dB ({os.path.getsize(tmp_path / 'cv2.mp4')} bytes)")
    assert port_psnr >= cv2_psnr - 1.0


def test_encoder_symbols_decode_as_planned():
    """The vectorised writer's I- and P-VOP on a frame with flat, textured
    and saturated regions: every macroblock mode it can choose appears
    (intra, inter, not coded), and the plain parse returns its levels."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    a[:16] = 255
    b = a.copy()
    b[16:32] = rng.integers(0, 256, (16, 64, 3), dtype=np.uint8)
    b[32:] = np.clip(a[32:].astype(int) + rng.integers(-6, 7, (16, 64, 3)), 0, 255)
    enc = mpeg4.Encoder(64, 48)
    i_vop, key = enc.encode(torch.from_numpy(a))
    p_vop, key2 = enc.encode(torch.from_numpy(b))
    assert key and not key2
    vol = mpeg4.parse_config(enc.config)
    hdr = mpeg4.read_vop_header(p_vop, vol)
    mb, _ = mpeg4.parse_vop(p_vop, vol, hdr)
    assert hdr.qp == mpeg4.ENCODE_QP and set(mb[:, 0].tolist()) == {mpeg4.MODE_SKIP, mpeg4.MODE_INTER, mpeg4.MODE_INTRA}


# ------------------------------------------------------------------ the kernels' plain routes


def test_card_decoder_runs_its_plain_versions_on_the_cpu():
    """``mpeg4_cuda.Decoder`` on the CPU: each wrapper takes its plain
    version (counted in ``plain_calls``, no launch), batches of 8 over a
    form with packets, 4MV and a skipped VOP, equal to cv2's frames."""
    for d in (mpeg4_cuda.launches, mpeg4_cuda.plain_calls):
        for k in d:
            d[k] = 0
    for name in ("w_resync.mp4", "w_not_coded.mp4", "cv2_xvid.avi"):
        with avi.open_video(FORMS / name) as reader:
            dec = mpeg4_cuda.Decoder("cpu", reader.stream.extradata, reader.stream.fourcc)
            samples = list(reader)
        frames = []
        for i in range(0, len(samples), 8):
            frames += dec.decode(samples[i:i + 8])
        assert [_sha(f.numpy()) for f in frames] == META[name]["bgr_sha256"], name
    assert all(v == 0 for v in mpeg4_cuda.launches.values())
    assert mpeg4_cuda.plain_calls["mp4v_parse"] == 1 + 1 + 2
    assert mpeg4_cuda.plain_calls["mp4v_recon"] == 5 + 4 + 14 == mpeg4_cuda.plain_calls["yuv420_to_bgr"]
