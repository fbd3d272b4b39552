"""The port's native host runtime (``utils/native.py``): each entry point
against the port's numpy version, with the tolerances of
``tests/test_native.py``, and bit for bit against the JAX package's binding
of the same sources on the same inputs.  Skips only where there is no C++
toolchain, as the JAX package's file does.

``jax_binding_whole`` points the JAX binding at a whole library for a
module's tests; every port test file that compares with that binding,
directly or through the JAX package's data and evaluation code, uses it."""

import contextlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from yolo_quantization_tpu.utils import native as jnative
from yolo_quantization_tpu_torch.data import image as timage
from yolo_quantization_tpu_torch.data import voc as tvoc
from yolo_quantization_tpu_torch.eval import detect as tdetect
from yolo_quantization_tpu_torch.utils import native

ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable (no C++ toolchain)")


@contextlib.contextmanager
def jax_binding_whole():
    """The JAX package's binding holding the whole native library, image
    entry points included wherever the port's library has them, until the
    block ends; then its own state again.

    The binding builds ``native/libyoloq_host.so`` in place with ``make``
    when the file is missing, and the Makefile's libjpeg probe writes and
    deletes one shared file.  Under several test workers a process can load
    a half-written library (the binding then takes its numpy and PIL
    fallbacks for good) or one whose probe lost the race (no image entry
    points), and a comparison with "the JAX binding" compares with
    something else.  So the binding is given a private copy of the port's
    library: the same sources and the Makefile's flags, built atomically.
    The copy has a name of its own: ``dlopen`` returns the handle it holds
    for a path or a file already loaded.  Where there is no toolchain the
    binding is left as it is (the tests skip)."""
    lib = native.load_library()
    if lib is None:
        yield
        return
    src = Path(lib._name)
    dst = ROOT / "build" / "jax_host" / f"{src.stem}.{os.getpid()}.so"
    if not dst.exists():
        dst.parent.mkdir(parents=True, exist_ok=True)
        tmp = dst.with_suffix(".tmp")
        shutil.copyfile(src, tmp)
        os.replace(tmp, dst)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH", str(dst))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_lib_failed", False)
        got = jnative.load_library(build=False)
        if got is None or got._has_image != lib._has_image:
            pytest.fail(f"the JAX binding did not load {dst} whole (loaded: {got is not None}, image "
                        f"entry points: {got is not None and got._has_image}, the port's: {lib._has_image})")
        yield


@pytest.fixture(scope="module", autouse=True)
def jax_binding():
    with jax_binding_whole():
        yield


@pytest.fixture
def image_support():
    if not native.has_image():
        pytest.skip("library built without libjpeg/libpng")
    assert jnative.load_library()._has_image, "the JAX binding lacks the image entry points"


def make_dets(rng, m=50, classes=5):
    boxes = np.stack([rng.uniform(0.1, 0.9, m), rng.uniform(0.1, 0.9, m),
                      rng.uniform(0.05, 0.4, m), rng.uniform(0.05, 0.4, m)], axis=1).astype(np.float32)
    obj = rng.uniform(0, 1, m).astype(np.float32)
    obj[rng.uniform(size=m) < 0.1] = 0.5  # ties
    cls = rng.uniform(0, 1, (m, classes)).astype(np.float32)
    return boxes, obj, cls


def survivors(b, o):
    """NMS survivors as an (objectness, box) multiset: the native version
    keeps the input row order, the numpy version sorts."""
    return sorted((round(float(o[i]), 6), *np.round(b[i], 6).tolist()) for i in np.where(o > 0)[0])


def test_library_lands_in_build_and_import_builds_nothing():
    lib = native.load_library()
    path = Path(lib._name)
    assert path.parent == ROOT / "build" / "torch_host" and path.name.startswith("libyoloq_host.")
    assert not (ROOT / "native" / ".imgtest.cc").exists()
    code = ("import sys; sys.modules['jax'] = None; sys.modules['yolo_quantization_tpu'] = None\n"
            "from yolo_quantization_tpu_torch.utils import native\n"
            "from yolo_quantization_tpu_torch.data import image, voc\n"
            "from yolo_quantization_tpu_torch.eval import f1, valid\n"
            "from yolo_quantization_tpu_torch.infer import serving\n"
            "assert native._lib is None and not native._lib_failed, 'import loaded the library'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CXX="/nonexistent/c++")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_a_built_library_loads_without_the_image_probe(monkeypatch):
    """Once the hashed library exists, loading it runs no compiler."""
    built = Path(native.load_library()._name)

    def no_compiler(*args, **kwargs):
        raise AssertionError("the compiler ran for a library that is already built")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_have_image_libs", no_compiler)
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    assert Path(native.load_library()._name) == built


def test_no_toolchain_falls_back_to_numpy(monkeypatch, rng):
    """Without a compiler every entry point runs the port's numpy version."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    assert not native.available() and not native.has_image()
    boxes, obj, cls = make_dets(rng)
    for got, want in zip(native.nms_obj(boxes, obj, cls, 0.3), tdetect.nms_obj(boxes, obj, cls, 0.3)):
        np.testing.assert_array_equal(got, want)
    im = rng.uniform(0, 1, (30, 50, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.letterbox(im, 32, 32), timage.letterbox(im, 32, 32))
    assert native.decode_image(__file__) is None


def test_nms_obj_survivors_match_numpy_and_jax(rng):
    for seed in range(3):
        boxes, obj, cls = make_dets(np.random.default_rng(seed))
        nb, no, nc = native.nms_obj(boxes, obj, cls, 0.3)
        rb, ro, _ = tdetect.nms_obj(boxes, obj, cls, 0.3)
        assert survivors(nb, no) == survivors(rb, ro)
        np.testing.assert_array_equal(nb, boxes)  # the native version keeps the row order
        for got, want in zip((nb, no, nc), jnative.nms_obj(boxes, obj, cls, 0.3)):
            np.testing.assert_array_equal(got, want)


def test_nms_sort_matches_numpy_and_jax(rng):
    boxes, obj, cls = make_dets(rng)
    probs = obj[:, None] * cls
    got = native.nms_sort(boxes, probs, 0.3)
    np.testing.assert_allclose(got, tdetect.nms_sort_per_class(boxes, probs, 0.3), atol=1e-6)
    np.testing.assert_array_equal(got, jnative.nms_sort(boxes, probs, 0.3))


def test_match_truths_matches_numpy_and_jax(rng):
    boxes, obj, _ = make_dets(rng, m=30)
    truths = np.stack([rng.uniform(0.2, 0.8, 7), rng.uniform(0.2, 0.8, 7),
                       rng.uniform(0.1, 0.3, 7), rng.uniform(0.1, 0.3, 7)], axis=1).astype(np.float32)
    for thresh in (0.1, 0.3, 0.5):
        tp, acc = native.match_truths(boxes, obj, truths, thresh, 0.1)
        tp_np, acc_np = tdetect.match_truths(boxes, obj, truths, thresh, 0.1)
        assert tp == tp_np
        assert acc == pytest.approx(acc_np, abs=1e-5)
        assert (tp, acc) == jnative.match_truths(boxes, obj, truths, thresh, 0.1)


# The native resize computes its sample coordinates in float32 (darknet's C
# arithmetic), numpy in float64: the two differ by 1e-5 at most at the JAX
# package's test size and by up to 7.8e-5 from a 720x1280 source, where a
# coordinate's float32 error times the pixel step reaches that.
@pytest.mark.parametrize("shape,net,atol", [((96, 128, 3), (64, 64), 1e-5),
                                            ((50, 30, 3), (96, 64), 1e-5),
                                            ((720, 1280, 3), (416, 416), 1e-4)])
def test_letterbox_matches_numpy_and_jax(rng, shape, net, atol):
    im = rng.uniform(0, 1, shape).astype(np.float32)
    got = native.letterbox(im, *net)
    np.testing.assert_allclose(got, timage.letterbox(im, *net), atol=atol)
    np.testing.assert_array_equal(got, jnative.letterbox(im, *net))


def test_png_decode_exact(rng, tmp_path, image_support):
    arr = (rng.uniform(0, 1, (37, 53, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "x.png")
    Image.fromarray(arr).save(p)
    got = native.decode_image(p)
    assert got is not None and got.shape == (37, 53, 3)
    np.testing.assert_allclose(got, arr.astype(np.float32) / 255.0, atol=1e-6)
    np.testing.assert_array_equal(got, jnative.decode_image(p))
    np.testing.assert_array_equal(timage.load_image_rgb(p), got)  # load_image_rgb decodes natively


def test_jpeg_decode_close_to_pil(rng, tmp_path, image_support):
    arr = (rng.uniform(0, 1, (64, 48, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "x.jpg")
    Image.fromarray(arr).save(p, quality=95)
    got = native.decode_image(p)
    with Image.open(p) as im:
        ref = np.asarray(im.convert("RGB"), np.float32) / 255.0
    assert np.max(np.abs(got - ref)) <= 2.5 / 255.0  # two IDCTs may differ by a few LSBs
    np.testing.assert_array_equal(got, jnative.decode_image(p))


def test_unsupported_format_falls_back_to_pil(tmp_path, image_support):
    p = str(tmp_path / "x.bin")
    with open(p, "wb") as f:
        f.write(b"not an image")
    assert native.decode_image(p) is None
    bmp = str(tmp_path / "x.bmp")
    arr = np.arange(4 * 5 * 3, dtype=np.uint8).reshape(4, 5, 3)
    Image.fromarray(arr).save(bmp)
    np.testing.assert_array_equal(timage.load_image_rgb(bmp), arr.astype(np.float32) / 255.0)


@pytest.mark.parametrize("nw,nh,dx,dy,dhue,dsat,dexp,flip", [
    (64, 48, 10, 5, 0.0, 1.0, 1.0, False),      # placement only
    (100, 90, -20, -15, 0.05, 1.3, 0.8, True),  # crop, distortion, flip
    (30, 30, 40, 40, -0.08, 0.7, 1.4, False),   # small, off centre
    (160, 160, -50, -60, 0.1, 1.5, 1.5, True),  # zoomed-in crop
])
def test_augment_place_matches_numpy_and_jax(rng, image_support, nw, nh, dx, dy, dhue, dsat, dexp,
                                             flip):
    im = rng.uniform(0, 1, (57, 71, 3)).astype(np.float32)
    args = (80, 64, nw, nh, dx, dy, dhue, dsat, dexp, flip)
    got = native.augment_place(im, *args)
    assert got.shape == (64, 80, 3)
    np.testing.assert_allclose(got, tvoc.place_distort_flip_numpy(im, *args), atol=2e-5)
    np.testing.assert_array_equal(got, jnative.augment_place(im, *args))


def test_augment_detection_goes_through_the_native_chain(image_support):
    """The port's augment_detection equals the JAX package's, both on their
    native chains, for the same draws."""
    from yolo_quantization_tpu.data import voc as jvoc

    im = np.random.default_rng(4).uniform(0, 1, (80, 120, 3)).astype(np.float32)
    boxes = np.array([[1, 0.5, 0.5, 0.6, 0.6], [0, 0.2, 0.3, 0.1, 0.2]], np.float32)
    for seed in range(3):
        ti, tb = tvoc.augment_detection(im, boxes, 96, 96, np.random.default_rng(seed))
        ji, jb = jvoc.augment_detection(im, boxes, 96, 96, np.random.default_rng(seed))
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tb, jb)
        assert 0 <= ti.min() and ti.max() <= 1
