"""The port's JPEG 2000 reader and writer (``data/jpeg2000.py``) and the
card decoder's plain versions (``data/jpeg2000_cuda.py``) against cv2 5.0.0
bit for bit, and the JAX entry points that read ``.jp2`` files against the
port's.

* every committed form of ``tests/fixtures/jpeg2000_forms/`` (written by
  ``tests/make_jpeg2000_fixtures.py``: cv2's lossy and lossless files,
  PIL's 5/3 and 9/7 with tiles, precincts, each progression order, layers,
  gray, alpha and 16 bits, raw codestreams, the port's writer with each
  code-block style, SOP / EPH, PPM / PPT and ROI, palette and ``cdef``
  boxes, and forms cv2 returns None for) under IMREAD_COLOR,
  IMREAD_GRAYSCALE and IMREAD_UNCHANGED: the port's array equals
  ``cv2.imdecode``'s (dtype, shape, every element; 9/7 included, no
  tolerance) and the sha256 ``forms.json`` records; where cv2 returns None
  the port raises;
* the three plain versions of the card's kernels equal the plain decoder's
  own stages on every form, and the wrapper's CPU path equals the reader;
* the writer: gray, BGR and BGRA, uint8 and uint16, at 32x32, 33x47 and
  130x70, read back equal by cv2; below 32 pixels on a side it raises;
* ``--loader python`` over a ``YoloFormat`` index of ``.jp2`` images and
  ``Detector.im_detect_single`` on a ``.jp2`` file against the JAX
  package's (which read them through cv2).
"""

import hashlib
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from dspnet_torch.data import image_io, jpeg2000, jpeg2000_cuda, synthetic

torch.set_num_threads(2)  # tier-1 runs six workers on eight cores

ROOT = Path(__file__).resolve().parents[1]
FORMS = ROOT / "tests" / "fixtures" / "jpeg2000_forms"
META = json.loads((FORMS / "forms.json").read_text())["files"]
FLAGS = {"color": cv2.IMREAD_COLOR, "gray": cv2.IMREAD_GRAYSCALE, "unchanged": cv2.IMREAD_UNCHANGED}


def _sha(img) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _cv2(data: bytes, flag: int):
    return cv2.imdecode(np.frombuffer(data, np.uint8), flag)


def _assert_same(got, want, what=""):
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ------------------------------------------------------------ committed forms


@pytest.mark.parametrize("flag", sorted(FLAGS))
@pytest.mark.parametrize("name", sorted(META))
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


def test_forms_cover_each_writer_and_option():
    """The forms hold each writer, both wavelets, each progression order,
    each code-block style bit, tiles, layers, packed headers, ROI and the
    boxes; some are refused by cv2, all under 1 MB together."""
    names = set(META)
    assert {n.split("_")[0] for n in names} >= {"cv2", "pil", "port", "box", "refused", "big"}
    for prog in ("lrcp", "rlcp", "rpcl", "pcrl", "cprl"):
        assert f"pil_53_layers_{prog}.jp2" in names
    styles = 0
    for n in names:
        plan = jpeg2000.prepare((FORMS / n).read_bytes()) if not n.startswith("refused") else None
        if plan is not None:
            for t in plan.tiles:
                for tc in t.comps:
                    styles |= tc.coding.style
    assert styles == 63
    assert sum(p.stat().st_size for p in FORMS.iterdir()) < 1 << 20
    assert sum(1 for n in names if all(META[n]["cv2"][k] is None for k in FLAGS)) >= 3


@pytest.mark.parametrize("name", sorted(n for n in META if not n.startswith("refused") and not n.startswith("big")))
def test_plain_versions_equal_the_plain_decoders_stages(name):
    """The card decoder's plain versions on the packed tables (on the CPU)
    equal ``jpeg2000.tier1``, ``inverse_dwt`` and the reader's output; a
    palette is refused by the card's packing and read on the host, and a
    form cv2 returns None for raises there too."""
    data = (FORMS / name).read_bytes()
    plan = jpeg2000.prepare(data)
    read = [k for k in ("unchanged", "gray") if META[name]["cv2"][k]]
    flag = FLAGS[read[0]] if read else cv2.IMREAD_COLOR
    if plan.boxes.pclr is not None or not read:
        with pytest.raises(ValueError, match="palette" if read else "offset"):
            jpeg2000_cuda.pack(plan, flag)
        return
    st = jpeg2000_cuda.stage(jpeg2000_cuda.pack(plan, flag), "cpu")
    coef = jpeg2000_cuda.t1_decode_ref(st)
    want = jpeg2000.tier1(plan)
    np.testing.assert_array_equal(coef.numpy(), want)
    samples = jpeg2000_cuda.idwt_ref(st, coef)
    np.testing.assert_array_equal(samples.numpy(), jpeg2000.inverse_dwt(plan, want))
    got = jpeg2000_cuda.mct_store_ref(st, samples).numpy()
    assert _sha(got) == META[name]["cv2"][read[0]]["sha256"]


@pytest.mark.parametrize("name", ["pil_97_tiles_rpcl.jp2", "port_style_all_styles.jp2", "box_cdef_reversed.jp2",
                                  "cv2_u16.jp2", "port_levels0.jp2"])
def test_wrapper_on_the_cpu_runs_the_plain_versions(name):
    """``jpeg2000_cuda.decode`` on the CPU runs the plain versions (counted)
    and gives the reader's array under each flag."""
    data = (FORMS / name).read_bytes()
    for key, flag in FLAGS.items():
        before = dict(jpeg2000_cuda.plain_calls)
        launched = dict(jpeg2000_cuda.launches)
        got = jpeg2000_cuda.decode(data, flag, "cpu")
        assert got.device.type == "cpu"
        assert _sha(got.numpy()) == META[name]["cv2"][key]["sha256"], key
        assert all(jpeg2000_cuda.plain_calls[k] == before[k] + 1 for k in before)
        assert jpeg2000_cuda.launches == launched


def test_the_card_refuses_what_its_kernels_do_not_take():
    """A palette raises on the card's packing, naming it; a form cv2 returns
    None for raises there as in the reader; another device raises."""
    plan = jpeg2000.prepare((FORMS / "box_pclr.jp2").read_bytes())
    with pytest.raises(ValueError, match="pclr"):
        jpeg2000_cuda.pack(plan, cv2.IMREAD_COLOR)
    with pytest.raises(ValueError, match="signed"):
        jpeg2000_cuda.pack(jpeg2000.prepare((FORMS / "refused_signed.jp2").read_bytes()), cv2.IMREAD_COLOR)
    packed = jpeg2000_cuda.pack(jpeg2000.prepare((FORMS / "port_bgr.jp2").read_bytes()), cv2.IMREAD_COLOR)
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        jpeg2000_cuda.stage(packed, "meta")


def test_image_size_reads_siz_alone():
    for name in ("pil_97_tiles_rpcl.jp2", "pil_nojp2.j2k", "big_97.jp2"):
        shape = META[name]["cv2"]["unchanged"]["shape"]
        assert jpeg2000.image_size((FORMS / name).read_bytes()) == tuple(shape[:2])


# ------------------------------------------------------------------ writer

SIZES = [(32, 32), (33, 47), (130, 70)]


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("dtype", ["uint8", "uint16"])
def test_writer_read_back_equal_by_cv2(hw, channels, dtype):
    """``imencode(".jp2")`` of gray, BGR and BGRA, uint8 and uint16: cv2
    reads the array back unchanged, and so does the port."""
    rng = np.random.RandomState(hw[0] * channels)
    top = 256 if dtype == "uint8" else 65536
    img = cv2.GaussianBlur(rng.randint(0, top, hw + (channels,)).astype(dtype), (3, 3), 1)
    img = img.reshape(hw + ((channels,) if channels > 1 else ()))
    data = image_io.imencode(".jp2", img)
    assert data.startswith(jpeg2000.JP2_MAGIC)
    _assert_same(_cv2(data, cv2.IMREAD_UNCHANGED), img, "cv2")
    _assert_same(image_io.imdecode(data, cv2.IMREAD_UNCHANGED), img, "port")


@pytest.mark.parametrize("shape", [(31, 40, 3), (40, 31), (16, 16, 4), (1, 64)])
def test_writer_refuses_below_32_pixels_as_cv2_fails(tmp_path, shape):
    """cv2's OpenJPEG writer fails below 32 pixels on a side; the port's
    raises there and writes no file."""
    img = np.zeros(shape, np.uint8)
    try:
        ok = cv2.imencode(".jp2", img)[0]
    except cv2.error:
        ok = False
    assert not ok
    with pytest.raises(ValueError, match="below 32"):
        image_io.imwrite(str(tmp_path / "x.jp2"), img)
    assert list(tmp_path.iterdir()) == []


def test_writer_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="uint8 or uint16"):
        jpeg2000.encode(np.zeros((40, 40, 3), np.float32))
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        jpeg2000.encode(np.zeros((40, 40, 2), np.uint8))


def test_imwrite_picks_jp2_by_extension_and_keeps_j2k_without_a_writer(tmp_path):
    img = synthetic.make_example(np.random.RandomState(2), (48, 64), 3)[0]
    path = image_io.imwrite(str(tmp_path / "x.JP2"), img)
    assert Path(path).read_bytes().startswith(jpeg2000.JP2_MAGIC)
    _assert_same(cv2.imread(path, cv2.IMREAD_COLOR), img)
    with pytest.raises(ValueError, match="no image writer"):
        image_io.imwrite(str(tmp_path / "x.j2k"), img)


# ------------------------------------------------------- against the JAX package


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
    variables = random_flax_variables(bundle.model, (1, *hw, 3), seed=41, train=False)
    port = create_model("resnet-18_multi", hw, device="cpu")
    load_flax_variables(port.model, variables)
    return (JaxDetector(bundle.model, variables, bundle.anchors, hw, classes=DET_CLASSES),
            Detector(port.model, port.anchors, hw, device="cpu", classes=DET_CLASSES))


@pytest.mark.parametrize("writer", ["port", "pil_97"])
def test_im_detect_single_on_jp2_matches_jax(detectors, tmp_path, writer):
    """A ``.jp2`` street scene (the port's lossless file, and PIL's 9/7):
    the port reads cv2's pixels, then its det rows (ids equal, values within
    1e-4, the JAX Detector's own bound for other formats) and seg map match
    the JAX Detector's."""
    import io

    from PIL import Image

    jdet, pdet = detectors
    img = synthetic.make_example(np.random.RandomState(7), (70, 133), 4)[0]
    path = tmp_path / "scene.jp2"
    if writer == "port":
        image_io.imwrite(str(path), img)
    else:
        buf = io.BytesIO()
        Image.fromarray(img[..., ::-1]).save(buf, format="JPEG2000", irreversible=True)
        path.write_bytes(buf.getvalue())
    np.testing.assert_array_equal(pdet.read_image(str(path)).numpy(), cv2.imread(str(path), cv2.IMREAD_COLOR))
    want = jdet.im_detect_single(str(path))
    got = pdet.im_detect_single(str(path))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)


def test_python_loader_over_yolo_jp2_equals_jax(tmp_path):
    """Two epochs of the port's ``MultiTaskIterator`` (``--loader python``)
    over a ``YoloFormat(image_ext=".jp2")`` index equal the JAX
    ``MultiTaskIterator``'s over the JAX ``YoloFormat`` bit for bit."""
    from dspnet_tpu.data.imdb import YoloFormat as JaxYolo
    from dspnet_tpu.data.iterator import MultiTaskIterator as JaxIterator
    from dspnet_tpu.data.iterator import SampleIndex as JaxIndex
    from dspnet_torch.data.imdb import YoloFormat
    from dspnet_torch.data.iterator import MultiTaskIterator, SampleIndex
    from tests.test_torch_image_formats import _yolo_layout

    root = _yolo_layout(tmp_path, ".jp2")
    classes = ["person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle"]
    args = (str(root / "list.txt"), str(root / "images"), str(root / "labels"), classes)
    jax_index = JaxIndex(JaxYolo(*args, image_ext=".jp2").samples())
    port_index = SampleIndex(YoloFormat(*args, image_ext=".jp2").samples())
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


def test_sycc_colour_rule_on_the_card_path_equals_cvtcolor():
    """sYCC's colour (ROADMAP Queue C item 5): ``cvt_color.yuv_to_bgr`` and
    the card's torch version (``jpeg2000_cuda.yuv_to_bgr``, run on CPU
    tensors) equal ``cv2.cvtColor(COLOR_YUV2BGR)`` on every 8-bit triple and
    on random 16-bit ones."""
    from dspnet_torch.data import cvt_color

    a = np.arange(1 << 24, dtype=np.uint32)
    u8 = np.stack([(a >> 16) & 255, (a >> 8) & 255, a & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    u16 = np.random.RandomState(18).randint(0, 65536, (256, 256, 3)).astype(np.uint16)
    for img in (u8, u16):
        want = cv2.cvtColor(img, cv2.COLOR_YUV2BGR)
        np.testing.assert_array_equal(cvt_color.yuv_to_bgr(img), want)
        np.testing.assert_array_equal(jpeg2000_cuda.yuv_to_bgr(torch.from_numpy(img[:512])).numpy(), want[:512])
