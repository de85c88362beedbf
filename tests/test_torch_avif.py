"""The port's AVIF reader (``data/avif.py`` over ``heif.py``,
``av1_obu.py``, ``av1_symbol.py``, ``av1_parse.py``, ``av1_recon.py``,
``av1_filters.py``, ``av1_grain.py``, ``av1_tables.py``) and the card
decoder's plain versions (``data/av1_cuda.py``) against cv2 5.0.0 bit for
bit, and the JAX entry points that read ``.avif`` files against the port's.

* every committed form of ``tests/fixtures/avif_forms/`` but the two
  1024x2048 scenes (written by ``tests/make_avif_fixtures.py``: cv2's
  qualities, speeds, depths, gray and odd sizes; Pillow's subsamplings,
  alpha, lossless, tiles, ranges, quantizer matrices, film grain tables,
  screen content with palettes and IntraBC, loop restoration, 128x128
  superblocks, delta q / lf, an image sequence; hand-made containers with a
  grid, idat, extents, irot / imir / clap, nclx matrices, ICC, no colr and
  a premultiplied alpha; forms cv2 returns None for) under IMREAD_COLOR,
  IMREAD_GRAYSCALE and IMREAD_UNCHANGED: the port's array equals
  ``cv2.imdecode``'s (dtype, shape, every element, no tolerance) and the
  sha256 ``forms.json`` records; where cv2 returns None the port raises;
* the tables' structure (every CDF row, the quantizer lookups, the scans,
  the closed forms), the inverse transforms against a float DCT, the
  header bit readers, each stage's plain version against the next
  stage's input, the card wrappers' plain versions on CPU tensors
  (counted, no launch);
* ``--loader python`` over a ``YoloFormat`` index of ``.avif`` images and
  ``Detector.im_detect_single`` on an ``.avif`` file against the JAX
  package's (which read them through cv2), and the refusals by name.

The one AVIF decoder is ``av1_cuda.decode``; ``image_io.imdecode`` runs it
on the CPU, through its plain versions. A form's frames decode once per
module (:func:`_planes`): the three flags of a form share one decode, as
cv2's three reads share libaom's output.
"""

import hashlib
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from dspnet_torch.data import (av1_cuda, av1_filters, av1_grain, av1_obu, av1_parse, av1_recon, av1_symbol,
                               av1_tables, avif, heif, image_io, synthetic)

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

ROOT = Path(__file__).resolve().parents[1]
FORMS = ROOT / "tests" / "fixtures" / "avif_forms"
META = json.loads((FORMS / "forms.json").read_text())["files"]
FLAGS = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE, "unchanged": cv2.IMREAD_UNCHANGED}
SMALL = sorted(n for n in META if not n.startswith("big_"))


def _sha(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _cv2(data: bytes, flag: int):
    return cv2.imdecode(np.frombuffer(data, np.uint8), flag)


def _assert_same(got, want, what=""):
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.fixture(scope="module", autouse=True)
def _planes():
    """``av1_cuda.decode_frame`` memoised on the frame (its headers and tile
    bytes) and device for this module: the three flags of a form read the
    same decoded planes."""
    plain = av1_cuda.decode_frame
    cache = {}

    def cached(frame, device):
        key = b"".join(t[2] for t in frame.tiles) + repr((frame.seq, frame.hdr, str(device))).encode()
        if key not in cache:
            cache[key] = plain(frame, device)
        return [p.clone() for p in cache[key]]

    av1_cuda.decode_frame = cached
    yield cache
    av1_cuda.decode_frame = plain


# ------------------------------------------------------------ committed forms


@pytest.mark.parametrize("flag", sorted(FLAGS))
@pytest.mark.parametrize("name", SMALL)
def test_committed_form_equals_cv2(name, flag):
    """One committed file under one flag: the port's array is cv2's bit for
    bit and has the recorded sha256; where cv2 returns None the port
    raises."""
    data = (FORMS / name).read_bytes()
    f = FLAGS[flag]
    rec = META[name]["cv2"][flag]
    if rec is None:
        assert _cv2(data, f) is None
        with pytest.raises(ValueError):
            image_io.imdecode(data, f)
        return
    got = image_io.imdecode(data, f)
    _assert_same(got, _cv2(data, f), name)
    assert _sha(got) == rec["sha256"]


def _parsed(name: str) -> list:
    p = avif.plan((FORMS / name).read_bytes())
    return [av1_parse.parse(c.frame) for c in p.color + p.alpha]


def test_forms_cover_each_coding_tool_and_container_form():
    """The forms hold every coding tool the port decodes (palettes, IntraBC,
    filter intra, CfL, each intra mode, angle deltas, lossless blocks, both
    restoration types, film grain, 4:2:0 / 4:2:2 / 4:4:4 / 4:0:0, 8 / 10 /
    12 bits, 64x64 and 128x128 superblocks, tiles, delta q and lf, each
    transform type class) and each container form, under 1 MB together."""
    seen = set()
    for name in SMALL:
        try:
            p = avif.plan((FORMS / name).read_bytes())
        except avif.AvifError:
            seen.add("refused")
            continue
        for c in p.color + p.alpha:
            s, h = c.frame.seq, c.frame.hdr
            seen |= {f"bd{s.bit_depth}", f"ss{s.ssx}{s.ssy}{s.mono}", f"sb{128 if s.sb128 else 64}"}
            seen |= {"grain"} if h.grain.apply else set()
            seen |= {"tiles"} if len(c.frame.tiles) > 1 else set()
            seen |= {"delta_lf"} if h.delta_lf_present else set()
            seen |= {"qm"} if h.using_qmatrix else set()
            pr = av1_parse.parse(c.frame)
            b, t = pr.blocks, pr.txbs
            seen |= {f"ymode{m}" for m in np.unique(b[:, 3])}
            seen |= {"palette"} if (b[:, 10] > 0).any() else set()
            seen |= {"intrabc"} if b[:, 21].any() else set()
            seen |= {"filter_intra"} if (b[:, 7] >= 0).any() else set()
            seen |= {"angle"} if (b[:, 5] != 0).any() else set()
            seen |= {"cfl"} if (t[:, 10] & av1_parse.F_CFL).any() else set()
            seen |= {"lossless"} if (t[:, 10] & av1_parse.F_LOSSLESS).any() else set()
            seen |= {f"txtype{x}" for x in np.unique(t[:, 5])}
            seen |= {f"lr{u.kind}" for plane in pr.lr for u in plane.values()}
    want = {"bd8", "bd10", "bd12", "ss110", "ss100", "ss000", "ss111", "sb64", "sb128", "grain", "tiles", "delta_lf",
            "qm", "palette", "intrabc", "filter_intra", "angle", "cfl", "lossless", "lr1", "lr2", "refused"}
    want |= {f"ymode{m}" for m in range(13)}
    want |= {"txtype0", "txtype1", "txtype2", "txtype3", "txtype9", "txtype10", "txtype11"}
    assert want <= seen, want - seen
    assert {n.split("_")[0] for n in SMALL} >= {"cv2", "pil", "made"}
    assert sum((FORMS / n).stat().st_size for n in SMALL) < 1 << 20
    assert sum(1 for n in META if all(META[n]["cv2"][k] is None for k in FLAGS)) >= 2


def test_cv2_ignores_the_transform_properties():
    """cv2 5.0.0 applies none of ``irot`` / ``imir`` / ``clap``: each such
    form reads as the payload without them (measured here; the port does
    the same)."""
    base = _cv2((FORMS / "made_extents.avif").read_bytes(), cv2.IMREAD_COLOR)
    for name in ("made_irot1.avif", "made_irot2.avif", "made_irot3.avif", "made_imir0.avif", "made_imir1.avif",
                 "made_clap.avif"):
        _assert_same(_cv2((FORMS / name).read_bytes(), cv2.IMREAD_COLOR), base, name)
        _assert_same(image_io.imdecode((FORMS / name).read_bytes(), cv2.IMREAD_COLOR), base, name)


# ------------------------------------------------------------------ tables


def _check_cdf_rows(a: np.ndarray):
    n = a.shape[-1]
    for row in a.reshape(-1, n):
        if not row.any():
            continue
        k = int(np.argmax(row == 0))
        vals = row[:k].astype(np.int64)
        assert k >= 1 and (vals < 32768).all() and (np.diff(vals) < 0).all() and not row[k:].any(), row


@pytest.mark.parametrize("key", av1_tables.MODE_CDF_KEYS + av1_tables.COEF_CDF_KEYS)
def test_cdf_table_rows_are_cdfs(key):
    """Every default CDF row: strictly decreasing inverse values, then 0,
    then a 0 counter (or an unused all-zero row); the coefficient tables
    hold four q contexts."""
    a = av1_tables.table(key)
    _check_cdf_rows(a)
    if key in av1_tables.COEF_CDF_KEYS:
        assert a.shape[0] == 4


def test_quantizer_lookups_and_scans():
    """Dc / Ac lookups rise with q at each depth (libaom's first values);
    each scan is a permutation with DC first; the quantizer matrices are
    row-major (the 4x8 matrix starts 32, 42, 75, 91 as in the
    specification); the closed forms hold their known values."""
    for k in ("8", "10", "12"):
        for kind in ("dc_q", "ac_q"):
            t = av1_tables.table(kind + k).astype(np.int64)
            assert (np.diff(t) >= 0).all() and t[0] > 0
    assert av1_tables.table("dc_q8")[:4].tolist() == [4, 8, 8, 9]
    assert av1_tables.table("ac_q8")[:4].tolist() == [4, 8, 9, 10]
    for tx in range(19):
        w, h = min(av1_tables.TX_W[tx], 32), min(av1_tables.TX_H[tx], 32)
        for ty in (0, 9, 10, 11):
            sc = av1_tables.scan(tx, ty)
            assert sorted(sc) == list(range(w * h)) and sc[0] == 0
    assert av1_tables.scan(av1_tables.TX_4X4, 0)[:6] == (0, 1, 4, 8, 5, 2)
    qm = av1_tables.table("qm")
    off = av1_tables.qm_offset(av1_tables.TX_4X8)
    assert qm[0, 0, off:off + 4].tolist() == [32, 42, 75, 91]
    assert av1_tables.div_lut()[:3].tolist() == [16384, 16320, 16257]
    assert av1_tables.x_by_xplus1()[:4].tolist() == [1, 128, 171, 192]
    assert av1_tables.one_by_x()[:4].tolist() == [4096, 2048, 1365, 1024]
    assert av1_tables.cospi(12)[:3].tolist() == [4096, 4095, 4091]
    assert av1_tables.sinpi(12).tolist() == [0, 1321, 2482, 3344, 3803]


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_inverse_dct_is_a_scaled_inverse_dct(n):
    """The integer butterflies equal the orthonormal inverse DCT scaled by
    sqrt(n / 2) within the rounding of its stages (2 log2(n): a wrong
    butterfly is off by hundreds)."""
    from scipy.fft import idct as fidct

    rng = np.random.RandomState(n)
    x = rng.randint(-2000, 2000, (20, n))
    got = np.stack(av1_recon.idct([x[:, k].astype(np.int64) for k in range(n)], 24), 1)
    want = fidct(x.astype(np.float64), norm="ortho", axis=1) * np.sqrt(n / 2)
    assert np.abs(got - want).max() <= 2 * np.log2(n)


def test_header_bit_readers():
    """The header readers: f(n), su(n), ns(n), leb128 and uvlc as the
    specification defines them; a tile of 0 bytes is refused."""
    r = av1_obu.BitReader(bytes([0b10110110, 0b01000000]))
    assert r.f(4) == 0b1011
    assert r.su(4) == 0b0110
    r = av1_obu.BitReader(bytes([0b11110000]))
    assert r.su(4) == -1
    r = av1_obu.BitReader(bytes([0b01100000]))
    assert r.ns(5) == 1  # w = 3, m = 3: v = f(2) = 1 < m
    assert av1_obu.BitReader(bytes([0x85, 0x01])).leb128() == 133
    assert av1_obu.BitReader(bytes([0b00101000])).uvlc() == 4  # 2 zeros, 1, then f(2) = 1: 1 + 3
    with pytest.raises(av1_symbol.SymbolError):
        av1_symbol.SymbolDecoder(b"")


# ------------------------------------------------------------------ stages


@pytest.mark.parametrize("name", ["cv2_default.avif", "cv2_s0.avif", "pil_screen.avif", "pil_lr.avif",
                                  "pil_444cdef.avif", "pil_422cdef.avif", "cv2_d10.avif", "pil_lossless.avif"])
def test_card_plain_versions_chain_the_plain_stages(name):
    """On CPU tensors the card wrappers run their plain versions (counted;
    no launch), each taking the previous stage's output: recon == the
    plain reconstruction, deblock / cdef / loop_restore == the plain
    filters on it, and the chain with film grain == ``av1_cuda.decode_frame``'s
    planes."""
    p = avif.plan((FORMS / name).read_bytes())
    frame = p.color[0].frame
    parsed = av1_parse.parse(frame)
    st = av1_cuda.stage(av1_cuda.pack(parsed), "cpu")
    before, launched = dict(av1_cuda.plain_calls), dict(av1_cuda.launches)
    rec = av1_cuda.recon(st)
    want = av1_recon.reconstruct(parsed)
    for a, b in zip(rec, want):
        np.testing.assert_array_equal(a.numpy(), b)
    deb = av1_cuda.deblock(st, rec)
    for a, b in zip(deb, av1_filters.deblock(parsed, want)):
        np.testing.assert_array_equal(a.numpy(), b)
    cd = av1_cuda.cdef(st, deb)
    for a, b in zip(cd, av1_filters.cdef(parsed, [d.numpy() for d in deb])):
        np.testing.assert_array_equal(a.numpy(), b)
    lr = av1_cuda.loop_restore(st, deb, cd)
    for a, b in zip(lr, av1_filters.loop_restore(parsed, [d.numpy() for d in deb], [c.numpy() for c in cd])):
        np.testing.assert_array_equal(a.numpy(), b)
    assert all(av1_cuda.plain_calls[k] == before[k] + 1 for k in before)
    assert av1_cuda.launches == launched
    got = avif.finish(frame, lr)
    for a, b in zip(got, av1_cuda.decode_frame(frame, "cpu")):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    packed = st.packed
    assert len(packed.txbs) == len(parsed.txbs) and sum(len(w) for w in packed.waves) == parsed.sb_rows * parsed.sb_cols


@pytest.mark.parametrize("name", ["cv2_default.avif", "pil_alpha.avif", "made_prem.avif", "cv2_gray_d12.avif",
                                  "pil_grain6.avif", "made_grid.avif"])
def test_card_decode_on_the_cpu_runs_the_plain_versions(name):
    """``av1_cuda.decode`` on the CPU gives cv2's array under each flag
    through the plain versions, launching nothing."""
    data = (FORMS / name).read_bytes()
    for key, flag in FLAGS.items():
        launched = dict(av1_cuda.launches)
        got = av1_cuda.decode(data, flag, "cpu")
        assert got.device.type == "cpu"
        assert _sha(got.numpy()) == META[name]["cv2"][key]["sha256"], key
        assert av1_cuda.launches == launched


def _grain_noise_by_blocks(g, bd, mono, ssx, ssy, w, h):
    """The specification's noise stripes (7.18.3.5), block by block and row
    by row: each 32x32 block copied from the template at its random offset
    over the stripe, its first columns blended with the block before, then
    each stripe's first rows with the stripe above."""
    tmpl = av1_grain.templates(g, bd, mono, ssx, ssy)
    gmin, gmax = -(128 << (bd - 8)), (128 << (bd - 8)) - 1
    rows, cols = (((h + 1) // 2) + 15) // 16, (((w + 1) // 2) + 15) // 16
    offs = av1_grain._block_offsets(g, rows, cols)

    def blend(a, b, wa, wb):
        return min(gmax, max(gmin, (a * wa + b * wb + 16) >> 5))

    out = []
    for p in range(1 if mono else 3):
        psx, psy = (ssx, ssy) if p else (0, 0)
        stripes = np.zeros((rows, 34, cols * 32 + 34), np.int64)
        for ln in range(rows):
            for bx in range(cols):
                oy, ox = offs[ln, bx]
                poy, pox = (6 + oy if psy else 9 + 2 * oy), (6 + ox if psx else 9 + 2 * ox)
                for i in range(34 >> psy):
                    for j in range(34 >> psx):
                        v = int(tmpl[p][poy + i, pox + j])
                        x = bx * (32 >> psx) + j
                        if g.overlap and bx and j < (2 >> psx):
                            old = int(stripes[ln, i, x])
                            v = blend(old, v, 23, 22) if psx else blend(old, v, (27, 17)[j], (17, 27)[j])
                        stripes[ln, i, x] = v
        ph, pw = (h + psy) >> psy, (w + psx) >> psx
        img = np.zeros((ph, pw), np.int64)
        for y in range(ph):
            ln, i = y >> (5 - psy), y & ((32 >> psy) - 1)
            for x in range(pw):
                v = int(stripes[ln, i, x])
                if g.overlap and ln and i < (2 >> psy):
                    old = int(stripes[ln - 1, i + (32 >> psy), x])
                    v = blend(old, v, 23, 22) if psy else blend(old, v, (27, 17)[i], (17, 27)[i])
                img[y, x] = v
        out.append(img)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_grain_noise_equals_the_block_by_block_rule(seed):
    """The noise planes (blocks gathered from the templates and overlaps
    blended as torch ops) equal the specification's block-by-block loops at
    random grain parameters, depths, subsamplings and odd sizes."""
    rng = np.random.RandomState(seed)
    lag = int(rng.randint(4))
    n = 2 * lag * (lag + 1)
    g = av1_obu.FilmGrain(apply=1, seed=int(rng.randint(1 << 16)), points_y=[(0, 20), (255, 40)],
                          points_cb=[(0, 30)] if seed % 2 else [], points_cr=[(9, 40)],
                          chroma_scaling_from_luma=int(seed == 3), ar_coeff_lag=lag,
                          ar_coeffs_y=rng.randint(-128, 128, n).tolist(),
                          ar_coeffs_cb=rng.randint(-128, 128, n + 1).tolist(),
                          ar_coeffs_cr=rng.randint(-128, 128, n + 1).tolist(), ar_coeff_shift=6 + seed,
                          grain_scale_shift=seed % 3, overlap=int(seed != 1))
    bd, (ssx, ssy), mono = (8, 10, 12, 8)[seed], ((1, 1), (1, 0), (0, 0), (1, 1))[seed], seed == 3
    w, h = int(rng.randint(40, 140)), int(rng.randint(40, 140))
    got = av1_grain.noise_planes(g, bd, mono, ssx, ssy, w, h)
    want = _grain_noise_by_blocks(g, bd, mono, ssx, ssy, w, h)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_intrabc_sources_lie_in_earlier_waves():
    """The superblock waves of an IntraBC frame (lag 5 at 64x64) finish
    every source before its block; a lag of 1 would not, and raises by
    name."""
    parsed = _parsed("pil_screen.avif")[0]
    assert parsed.blocks[:, 21].any() and parsed.frame.hdr.allow_intrabc
    assert av1_cuda._wave_lag(parsed) == 5
    av1_cuda._check_intrabc(parsed, 5)
    with pytest.raises(avif.AvifError, match="IntraBC source"):
        av1_cuda._check_intrabc(parsed, 1)


# ------------------------------------------------------------------ refusals


def test_refusals_by_name():
    """Layered images, a grid of tiles below 64 samples (cv2 returns None
    for both), a gain-map image, a premultiplied alpha above 8 bits, an
    inter frame and another device raise, naming the form; ``.avif`` keeps
    no writer."""
    with pytest.raises(avif.AvifError, match="a1lx"):
        av1_cuda.decode((FORMS / "made_a1lx.avif").read_bytes(), avif.IMREAD_COLOR, "cpu")
    with pytest.raises(avif.AvifError, match="64 samples"):
        av1_cuda.decode((FORMS / "made_grid_small.avif").read_bytes(), avif.IMREAD_COLOR, "cpu")
    from tests.make_avif_fixtures import container, payload

    base = payload((FORMS / "cv2_default.avif").read_bytes())
    tmap = container([{"id": 1, "type": "tmap", "data": b"\0" * 8, "props": []}], 1)
    with pytest.raises(avif.AvifError, match="tmap"):
        av1_cuda.decode(tmap, avif.IMREAD_COLOR, "cpu")
    frame = bytearray(base["data"])
    with pytest.raises(av1_obu.Av1Error):
        av1_obu.read_frame(bytes(frame[:2]))
    packed = av1_cuda.pack(_parsed("cv2_default.avif")[0])
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        av1_cuda.stage(packed, "meta")
    with pytest.raises(ValueError, match="no image writer"):
        image_io.imencode(".avif", np.zeros((8, 8, 3), np.uint8))


def test_heif_reads_each_item_location_form():
    """idat (construction method 1), several extents and both together give
    the same item bytes as one extent in mdat."""
    items = {}
    for name in ("made_extents.avif", "made_idat.avif", "made_idat_extents.avif", "made_nocolr.avif"):
        h = heif.parse((FORMS / name).read_bytes())
        items[name] = h.items[h.primary].data
    assert len(set(items.values())) == 1
    assert heif.is_avif((FORMS / "cv2_default.avif").read_bytes())
    assert not heif.is_avif(b"\0\0\0\x18ftypheic\0\0\0\0mif1heic")


# ------------------------------------------------------- against the JAX package


def _avif_bytes(img: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".avif", img)
    assert ok
    return buf.tobytes()


@pytest.fixture(scope="module")
def detectors():
    from dspnet_tpu.api import create_model as jax_create_model
    from dspnet_tpu.detect.detector import Detector as JaxDetector
    from dspnet_torch.api import create_model
    from dspnet_torch.data.cs_labels import DET_CLASSES
    from dspnet_torch.detect.detector import Detector
    from dspnet_torch.utils.convert import load_flax_variables
    from tests.torch_parity import random_flax_variables

    hw = (128, 256)
    bundle = jax_create_model("resnet-18_multi", hw)
    variables = random_flax_variables(bundle.model, (1, *hw, 3), seed=43, train=False)
    port = create_model("resnet-18_multi", hw, device="cpu")
    load_flax_variables(port.model, variables)
    return (JaxDetector(bundle.model, variables, bundle.anchors, hw, classes=DET_CLASSES),
            Detector(port.model, port.anchors, hw, device="cpu", classes=DET_CLASSES))


def test_im_detect_single_on_avif_matches_jax(detectors, tmp_path):
    """An ``.avif`` street scene (cv2's writer): the port reads cv2's
    pixels, then its det rows (ids equal, values within 1e-4, the JAX
    Detector's own bound for other formats) and seg map match the JAX
    Detector's."""
    jdet, pdet = detectors
    img = synthetic.make_example(np.random.RandomState(8), (70, 133), 4)[0]
    path = tmp_path / "scene.avif"
    path.write_bytes(_avif_bytes(img))
    np.testing.assert_array_equal(pdet.read_image(str(path)).numpy(), cv2.imread(str(path), cv2.IMREAD_COLOR))
    want = jdet.im_detect_single(str(path))
    got = pdet.im_detect_single(str(path))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)


def _yolo_avif_layout(root: Path, n: int = 5) -> Path:
    """A YOLO layout of ``n`` street scenes as cv2-written ``.avif`` files,
    odd sizes among them, one without a label file."""
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.RandomState(19)
    ids = []
    for i in range(n):
        img, _, rows = synthetic.make_example(rng, (70, 110) if i % 2 else (64, 96), 4)[:3]
        iid = f"im{i}"
        ids.append(iid)
        (root / "images" / (iid + ".avif")).write_bytes(_avif_bytes(img))
        if i == n - 1:
            continue
        lines = []
        for r in np.asarray(rows):
            if r[0] < 0:
                continue
            cx, cy, w, h = (r[1] + r[3]) / 2, (r[2] + r[4]) / 2, r[3] - r[1], r[4] - r[2]
            lines.append(f"{int(r[0])} {cx:.6f} {cy:.6f} {w:.6f} {h:.6f}")
        (root / "labels" / (iid + ".txt")).write_text("\n".join(lines) + "\n")
    (root / "list.txt").write_text("\n".join(ids) + "\n")
    return root


def test_python_loader_over_yolo_avif_equals_jax(tmp_path):
    """Two epochs of the port's ``MultiTaskIterator`` (``--loader python``)
    over a ``YoloFormat(image_ext=".avif")`` index equal the JAX
    ``MultiTaskIterator``'s over the JAX ``YoloFormat`` bit for bit."""
    from dspnet_tpu.data.imdb import YoloFormat as JaxYolo
    from dspnet_tpu.data.iterator import MultiTaskIterator as JaxIterator
    from dspnet_tpu.data.iterator import SampleIndex as JaxIndex
    from dspnet_torch.data.imdb import YoloFormat
    from dspnet_torch.data.iterator import MultiTaskIterator, SampleIndex

    root = _yolo_avif_layout(tmp_path)
    classes = ["person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle"]
    args = (str(root / "list.txt"), str(root / "images"), str(root / "labels"), classes)
    jax_index = JaxIndex(JaxYolo(*args, image_ext=".avif").samples())
    port_index = SampleIndex(YoloFormat(*args, image_ext=".avif").samples())
    kw = dict(batch_size=2, data_shape=(64, 128), enable_aug=True, pad_last=True)
    want_it, got_it = JaxIterator(jax_index, **kw), MultiTaskIterator(port_index, **kw)
    for _ in range(2):
        want, got = list(want_it.epoch()), list(got_it.epoch())
        assert len(got) == len(want) == 3
        for (wb, wn), (gb, gn) in zip(want, got):
            assert gn == wn
            for k in wb:
                assert gb[k].dtype == wb[k].dtype, k
                np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
