"""The port's JPEG decoder and Pillow geometry against Pillow, bit for bit.

``focalformer3d_tpu_torch/data/image_io.py`` stands in for the Pillow calls
of the JAX data layer (the card's machine has no Pillow). Pillow (built on
libjpeg-turbo) writes and reads every case here:

- ``decode``: sampling 4:4:4, 4:2:2, 4:2:0 and grayscale at quality 50, 75
  and 95, standard and optimised Huffman tables, sizes from 1 x 1 to
  53 x 37 (widths and heights that are not multiples of the MCU, and
  chroma two columns wide or less, where libjpeg does not upsample
  fancily), restart intervals, one 1600 x 900 camera; progressive and CMYK
  files raise ``NotImplementedError``, a truncated header ``ValueError``,
  and a library that does not build raises with g++'s messages;
- the port's own writer (``encode_jpeg``): Pillow decodes its files to
  exactly what the port's decoder gives;
- ``resize`` (up and down, 1600 x 900 to 800 x 448, the 0.4-0.6 scales of
  ``ImageAug3D``), ``crop`` inside and outside the image, ``flip_lr``, and
  ``rotate`` at +-5.4 degrees, 0, the multiples of 90 and random angles;
- the committed fixtures of ``tests/torch_images/``: their SHA-256
  digests in ``digests.json`` (of Pillow's decode and of a resize, crop,
  flip and rotate chain, as ``ImageAug3D`` runs it) are Pillow's, and the
  port gives them. ``tests/test_torch_cuda.py`` checks the same digests on
  the card's machine. ``python tests/test_torch_image_io.py
  --write-fixtures`` rewrites the fixtures and the digests with Pillow.
"""
import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from focalformer3d_tpu_torch.data import image_io

FIXTURES = Path(__file__).resolve().parent / "torch_images"
SIZES = [(1, 1), (1, 2), (2, 1), (2, 3), (3, 5), (5, 4), (8, 8), (9, 17),
         (16, 16), (17, 9), (37, 53), (53, 37)]
SAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "gray": None}


def textured(rng, h, w, channels=3):
    """Gradients plus noise: every 8 x 8 block carries detail."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     ((x + y) * 3) % 256], -1)
    img = np.clip(base + rng.randint(-40, 41, (h, w, 3)), 0, 255)
    img = img.astype(np.uint8)
    return img[..., 0].copy() if channels == 1 else img


def pillow_jpeg(img, sampling="4:2:0", **kw):
    buf = io.BytesIO()
    if sampling != "gray":
        kw["subsampling"] = SAMPLING[sampling]
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pillow_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)))


def assert_same(got, ref):
    assert got.dtype == ref.dtype == np.uint8
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quality", [50, 75, 95])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_decode_equals_pillow(sampling, quality):
    rng = np.random.RandomState(quality)
    for h, w in SIZES:
        img = textured(rng, h, w, 1 if sampling == "gray" else 3)
        for optimize in (False, True):
            data = pillow_jpeg(img, sampling, quality=quality,
                               optimize=optimize)
            assert_same(image_io.decode(data), pillow_decode(data))


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1},
                                     {"restart_marker_blocks": 5},
                                     {"restart_marker_rows": 1}])
@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:2", "4:2:0", "gray"])
def test_decode_restart_intervals(sampling, restart):
    img = textured(np.random.RandomState(1), 45, 77,
                   1 if sampling == "gray" else 3)
    data = pillow_jpeg(img, sampling, quality=80, **restart)
    assert b"\xff\xdd" in data  # a DRI segment
    assert_same(image_io.decode(data), pillow_decode(data))


@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4"])
def test_decode_a_camera_frame(sampling, tmp_path):
    """One 1600 x 900 camera, through ``imread``, also on threads."""
    img = textured(np.random.RandomState(2), 900, 1600)
    path = tmp_path / "cam.jpg"
    path.write_bytes(pillow_jpeg(img, sampling, quality=95))
    ref = np.asarray(Image.open(path))
    assert_same(image_io.imread(path), ref)
    for got in image_io.parallel_map(image_io.imread, [path, path]):
        assert_same(got, ref)


def test_decode_counts_and_times():
    data = pillow_jpeg(textured(np.random.RandomState(3), 16, 24))
    image_io.reset_call_count()
    image_io.decode(data)
    image_io.decode(data)
    s = image_io.stats()
    assert image_io.call_count() == s["decodes"] == 2
    assert s["decode_s"] > 0 and s["resamples"] == 0
    image_io.resize(image_io.decode(data), (7, 5))
    assert image_io.stats()["resamples"] == 1
    image_io.reset_call_count()
    assert image_io.call_count() == 0


@pytest.mark.parametrize("mode, kw, what", [
    ("RGB", {"progressive": True}, "progressive"),
    ("L", {"progressive": True}, "progressive"),
    ("CMYK", {}, "four components"),
])
def test_unsupported_files_raise(mode, kw, what):
    img = Image.fromarray(textured(np.random.RandomState(4), 20, 30))
    buf = io.BytesIO()
    img.convert(mode).save(buf, "JPEG", **kw)
    with pytest.raises(NotImplementedError, match=what) as e:
        image_io.decode(buf.getvalue())
    assert "Queue 3" in str(e.value)


def test_corrupt_files_raise():
    data = pillow_jpeg(textured(np.random.RandomState(5), 20, 30))
    with pytest.raises(ValueError, match="not a JPEG"):
        image_io.decode(b"PNG" + data)
    with pytest.raises(ValueError, match="corrupt"):
        image_io.decode(data[:40])


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that cannot run, or a source that does not
    compile, raises with the compiler's message."""
    from focalformer3d_tpu_torch.data import native

    data = pillow_jpeg(textured(np.random.RandomState(5), 8, 8))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no" / "g++"))
    with pytest.raises(RuntimeError, match="image library: cannot run"):
        image_io.decode(data)
    monkeypatch.setattr(native, "CXX", "g++")
    bad = tmp_path / "jpeg_decode.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "IMAGE_SOURCES",
                        (bad,) + native.IMAGE_SOURCES[1:])
    with pytest.raises(RuntimeError, match="error") as e:
        image_io.resize(np.zeros((4, 4, 3), np.uint8), (2, 2))
    assert "jpeg_decode.cpp" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------------------------
# the fixture writer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("quality", [50, 90])
def test_writer_files_decode_alike(quality, channels):
    rng = np.random.RandomState(quality)
    for h, w in SIZES + [(90, 160)]:
        for _ in range(2):
            img = textured(rng, h, w, channels)
            data = image_io.encode_jpeg(img, quality)
            got = image_io.decode(data)
            assert_same(got, pillow_decode(data))
            if h * w >= 256:  # (a few pixels' chroma averages far off)
                # a faithful encoder: close to its input on average
                assert np.abs(got.astype(int) - img).mean() < 25


def test_writer_on_a_smooth_frame_is_close():
    y, x = np.mgrid[0:900, 0:1600]
    img = np.stack([x * 255 // 1599, y * 255 // 899,
                    (x + y) * 255 // 2498], -1).astype(np.uint8)
    got = image_io.decode(image_io.encode_jpeg(img, 90))
    assert np.abs(got.astype(int) - img).mean() < 1.0


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

RESIZES = [((900, 1600), (800, 448)), ((900, 1600), (640, 360)),
           ((900, 1600), (960, 540)), ((900, 1600), (1600, 900)),
           ((900, 1600), (1600, 450)), ((900, 1600), (800, 900)),
           ((64, 96), (45, 30)), ((37, 53), (80, 60)), ((37, 53), (53, 20)),
           ((37, 53), (10, 37)), ((5, 7), (1, 1)), ((1, 1), (4, 3))]
RESIZES += [((900, 1600), (int(1600 * s), int(900 * s)))
            for s in (0.4, 0.433, 0.5, 0.55, 0.6)]


@pytest.mark.parametrize("hw, size", RESIZES)
def test_resize_equals_pillow(hw, size):
    img = textured(np.random.RandomState(hw[0] + size[0]), *hw)
    ref = np.asarray(Image.fromarray(img).resize(size))
    assert_same(image_io.resize(img, size), ref)


def test_resize_gray_equals_pillow():
    img = textured(np.random.RandomState(6), 37, 53, 1)
    ref = np.asarray(Image.fromarray(img).resize((20, 71)))
    assert_same(image_io.resize(img, (20, 71)), ref)


@pytest.mark.parametrize("box", [(0, 0, 53, 37), (5, 3, 20, 30),
                                 (-10, -5, 30, 20), (40, 30, 80, 60),
                                 (-5, -5, 60, 45), (60, 40, 80, 50),
                                 (0, -88, 80, 0), (2.4, 3.6, 20.5, 30.5)])
def test_crop_equals_pillow(box):
    img = textured(np.random.RandomState(7), 37, 53)
    assert_same(image_io.crop(img, box),
                np.asarray(Image.fromarray(img).crop(box)))


def test_flip_equals_pillow():
    img = textured(np.random.RandomState(8), 37, 53)
    ref = Image.fromarray(img).transpose(Image.FLIP_LEFT_RIGHT)
    assert_same(image_io.flip_lr(img), np.asarray(ref))


ANGLES = [5.4, -5.4, 0, 0.0, 360, -360, 90, -90, 180, 270, 45, 1e-14,
          -1e-14, 359.99999999999]
ANGLES += list(np.random.RandomState(9).uniform(-5.4, 5.4, 12))
ANGLES += list(np.random.RandomState(10).uniform(-180, 180, 8))


@pytest.mark.parametrize("hw", [(448, 800), (37, 53), (32, 32)])
def test_rotate_equals_pillow(hw):
    img = textured(np.random.RandomState(hw[0]), *hw)
    for angle in ANGLES:
        ref = np.asarray(Image.fromarray(img).rotate(angle))
        got = image_io.rotate(img, angle)
        assert got.shape == ref.shape
        assert np.array_equal(got, ref), angle


def test_geometry_rejects_other_dtypes_and_huge_rotations():
    with pytest.raises(ValueError, match="uint8"):
        image_io.resize(np.zeros((4, 4, 3), np.float32), (2, 2))
    with pytest.raises(NotImplementedError, match="floating-point affine"):
        image_io.rotate(np.zeros((2, 40000), np.uint8), 3.0)


# ---------------------------------------------------------------------------
# committed fixtures
# ---------------------------------------------------------------------------

def fixture_chain(img, p):
    """The port's steps of the fixtures' chain: resize, crop, flip, rotate
    (the order of ``ImageAug3D``), and the test-time resize of the decoded
    image (``ScaleImageMultiViewImage``); ``pillow_chain`` is Pillow's."""
    steps = {}
    out = image_io.resize(img, p["resize"])
    steps["resize"] = out
    out = image_io.crop(out, p["crop"])
    steps["crop"] = out
    out = image_io.flip_lr(out)
    steps["flip"] = out
    steps["rotate"] = image_io.rotate(out, p["rotate"])
    steps["scale"] = image_io.resize(img, p["scale"])
    return steps


def pillow_chain(img, p):
    steps = {}
    im = Image.fromarray(img).resize(tuple(p["resize"]))
    steps["resize"] = im
    im = im.crop(tuple(p["crop"]))
    steps["crop"] = im
    im = im.transpose(Image.FLIP_LEFT_RIGHT)
    steps["flip"] = im
    steps["rotate"] = im.rotate(p["rotate"])
    steps["scale"] = Image.fromarray(img).resize(tuple(p["scale"]))
    return {k: np.asarray(v) for k, v in steps.items()}


def sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _load_digests():
    return json.loads((FIXTURES / "digests.json").read_text())


def test_fixtures_are_small():
    files = sorted(FIXTURES.glob("*.jpg"))
    assert len(files) >= 5
    assert sum(f.stat().st_size for f in files) < 150_000
    assert sorted(_load_digests()["files"]) == [f.name for f in files]


def test_fixture_digests_are_pillows_and_the_ports():
    d = _load_digests()
    for name, rec in d["files"].items():
        path = FIXTURES / name
        ref = np.asarray(Image.open(path))
        assert list(ref.shape) == rec["shape"]
        assert sha(ref) == rec["decode"], name
        got = image_io.imread(path)
        assert sha(got) == rec["decode"], name
        if "chain" not in rec:
            continue
        want = pillow_chain(ref, rec["chain"])
        for step, arr in fixture_chain(got, rec["chain"]).items():
            assert sha(want[step]) == rec[step], (name, step)
            assert sha(arr) == rec[step], (name, step)


def write_fixtures():
    """Rewrite ``tests/torch_images/`` with Pillow: the JPEGs and
    ``digests.json``."""
    rng = np.random.RandomState(2024)
    FIXTURES.mkdir(exist_ok=True)
    specs = [  # name, (h, w), channels, save options, chain parameters
        ("camera_420_q90.jpg", (225, 400), 3,
         dict(quality=90, subsampling=2),
         dict(resize=[200, 112], crop=[6, -2, 186, 102], rotate=-3.7,
              scale=[160, 90])),
        ("camera_420_q75_restart.jpg", (144, 256), 3,
         dict(quality=75, subsampling=2, restart_marker_blocks=3),
         dict(resize=[140, 78], crop=[0, 0, 128, 72], rotate=5.4,
              scale=[96, 64])),
        ("odd_422_q95_optimize.jpg", (61, 97), 3,
         dict(quality=95, subsampling=1, optimize=True),
         dict(resize=[48, 30], crop=[-4, 3, 44, 35], rotate=2.25,
              scale=[97, 61])),
        ("odd_444_q50.jpg", (53, 37), 3, dict(quality=50, subsampling=0),
         dict(resize=[74, 106], crop=[10, 10, 60, 90], rotate=-5.4,
              scale=[20, 30])),
        ("gray_q80.jpg", (37, 53), 1, dict(quality=80), None),
    ]
    out = {"made_with": f"Pillow {Image.__version__}", "files": {}}
    for name, hw, ch, opts, chain in specs:
        path = FIXTURES / name
        Image.fromarray(textured(rng, *hw, ch)).save(path, "JPEG", **opts)
        img = np.asarray(Image.open(path))
        rec = {"shape": list(img.shape), "decode": sha(img)}
        if chain:
            rec["chain"] = chain
            rec.update({k: sha(v) for k, v in pillow_chain(img,
                                                           chain).items()})
        out["files"][name] = rec
    (FIXTURES / "digests.json").write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixtures"]:
        write_fixtures()
