"""ctypes binding for the native host runtime (``native/yoloq_host.cc``,
``native/yoloq_image.cc``): NMS, truth matching, letterbox, image decode
and the fused augmentation chain.

The counterpart of ``yolo_quantization_tpu/utils/native.py``, with its own
copy of the library: the first call builds the repository's ``native/``
sources with the Makefile's flags into
``build/torch_host/libyoloq_host.<hash>.so``, the hash taken over the
sources, the compiler, the flags and the host CPU's flags (``-march=native``
code runs only on the CPU it was built for).  The image entry points are
compiled in when libjpeg and libpng link, as the Makefile's probe decides.
Nothing is built at import time.  Where there is no C++ toolchain, every
entry point falls back to the port's numpy version (``eval/detect.py``,
``data/image.py``, ``data/voc.py``), as the reference's binding does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_host"
HOST_SOURCES = ("yoloq_host.cc",)
IMAGE_SOURCES = ("yoloq_image.cc",)
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
IMAGE_LIBS = ("-ljpeg", "-lpng")
# native/Makefile's probe: jpeglib.h needs stdio included first
_IMAGE_PROBE = "#include <cstdio>\n#include <jpeglib.h>\n#include <png.h>\nint main(){return 0;}\n"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_failed = False


def _compiler() -> str | None:
    return shutil.which(os.environ.get("CXX", "g++"))


def _have_image_libs(cxx: str) -> bool:
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "imgtest.cc")
        with open(src, "w") as f:
            f.write(_IMAGE_PROBE)
        proc = subprocess.run([cxx, "-x", "c++", src, *IMAGE_LIBS, "-o", os.path.join(d, "a.out")],
                              capture_output=True, timeout=120)
    return proc.returncode == 0


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    return line
    except OSError:
        pass
    return b""


def library_path(cxx: str, image: bool) -> Path:
    digest = hashlib.sha256()
    for name in HOST_SOURCES + (IMAGE_SOURCES if image else ()):
        digest.update((NATIVE_DIR / name).read_bytes())
    digest.update(" ".join((cxx, *CXXFLAGS, *(IMAGE_LIBS if image else ()))).encode())
    digest.update(_cpu_flags())
    return BUILD_DIR / f"libyoloq_host.{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    """The library's path, compiled first if neither hashed file (with or
    without the image entry points) exists; only then is the libjpeg/libpng
    probe run, so a built library costs no compiler call.  (A library built
    without image support is kept after the image libraries appear, until
    ``build/torch_host`` is removed.)  Raises OSError or SubprocessError
    where it cannot be built."""
    cxx = _compiler()
    if cxx is None:
        raise OSError("no C++ compiler")
    for image in (True, False):
        if library_path(cxx, image).exists():
            return library_path(cxx, image)
    image = _have_image_libs(cxx)
    out = library_path(cxx, image)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    srcs = [str(NATIVE_DIR / n) for n in HOST_SOURCES + (IMAGE_SOURCES if image else ())]
    try:
        subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp), *srcs,
                        *(IMAGE_LIBS if image else ())],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)  # atomic: concurrent builders each write their own tmp
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    F = ctypes.POINTER(ctypes.c_float)
    I = ctypes.POINTER(ctypes.c_int)
    lib.yq_nms_obj.restype = ctypes.c_int
    lib.yq_nms_obj.argtypes = [F, F, F, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.yq_nms_sort.restype = None
    lib.yq_nms_sort.argtypes = [F, F, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.yq_match_truths.restype = ctypes.c_int
    lib.yq_match_truths.argtypes = [F, F, ctypes.c_int, F, ctypes.c_int,
                                    ctypes.c_float, ctypes.c_float, F]
    lib.yq_resize_bilinear.restype = None
    lib.yq_resize_bilinear.argtypes = [F, ctypes.c_int, ctypes.c_int, F, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int]
    lib.yq_letterbox.restype = None
    lib.yq_letterbox.argtypes = [F, ctypes.c_int, ctypes.c_int, F, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int]
    lib.yq_version.restype = ctypes.c_int
    # the decode and augmentation entry points exist only in a library built
    # with libjpeg/libpng
    try:
        lib.yq_image_size.restype = ctypes.c_int
        lib.yq_image_size.argtypes = [ctypes.c_char_p, I, I]
        lib.yq_decode_image.restype = ctypes.c_int
        lib.yq_decode_image.argtypes = [ctypes.c_char_p, F, ctypes.c_int, ctypes.c_int]
        lib.yq_augment_place.restype = None
        lib.yq_augment_place.argtypes = [
            F, ctypes.c_int, ctypes.c_int, F, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ]
        lib._has_image = True
    except AttributeError:
        lib._has_image = False


def load_library(build: bool = True) -> ctypes.CDLL | None:
    """Load (building if needed) the port's copy of the library; None where
    it cannot be built or loaded (then every entry point runs numpy)."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed or not build:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError):
            _lib_failed = True
            return None
        _bind(lib)
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def has_image() -> bool:
    """Whether the library holds the libjpeg/libpng decode and augmentation."""
    lib = load_library()
    return lib is not None and lib._has_image


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def nms_obj(boxes: np.ndarray, obj: np.ndarray, cls: np.ndarray, thresh: float):
    """darknet's do_nms_obj; falls back to ``eval.detect.nms_obj``.  The
    native path zeroes in objectness order but keeps the input row order,
    where the numpy version returns the rows sorted; suppressed rows stay
    (with objectness 0) either way."""
    lib = load_library()
    if lib is None:
        from yolo_quantization_tpu_torch.eval.detect import nms_obj as np_nms

        return np_nms(boxes, obj, cls, thresh)
    b, o, c = _f32(boxes), _f32(obj.copy()), _f32(cls.copy())
    lib.yq_nms_obj(_ptr(b), _ptr(o), _ptr(c), len(o), c.shape[1], thresh)
    return b, o, c


def nms_sort(boxes: np.ndarray, probs: np.ndarray, thresh: float) -> np.ndarray:
    """darknet's do_nms_sort on (M, C) probs; falls back to
    ``eval.detect.nms_sort_per_class``."""
    lib = load_library()
    if lib is None:
        from yolo_quantization_tpu_torch.eval.detect import nms_sort_per_class

        return nms_sort_per_class(boxes, probs, thresh)
    b, p = _f32(boxes), _f32(probs.copy())
    lib.yq_nms_sort(_ptr(b), _ptr(p), len(b), p.shape[1], thresh)
    return p


def match_truths(det_boxes: np.ndarray, det_obj: np.ndarray, truth_boxes: np.ndarray,
                 thresh: float, iou_thresh: float) -> tuple[int, float]:
    """(TP count, sum of best IoUs) of the F1 harness's inner loop; falls
    back to ``eval.detect.match_truths``."""
    lib = load_library()
    if lib is None:
        from yolo_quantization_tpu_torch.eval.detect import match_truths as np_match

        return np_match(det_boxes, det_obj, truth_boxes, thresh, iou_thresh)
    db, do, tb = _f32(det_boxes), _f32(det_obj), _f32(truth_boxes)
    acc = np.zeros(1, np.float32)
    tp = lib.yq_match_truths(_ptr(db), _ptr(do), len(do), _ptr(tb), len(tb), thresh, iou_thresh,
                             _ptr(acc))
    return int(tp), float(acc[0])


def decode_image(path: str) -> np.ndarray | None:
    """libjpeg/libpng decode to float32 HWC RGB in [0, 1]; None where the
    caller falls back to PIL (another format, or no image support)."""
    lib = load_library()
    if lib is None or not lib._has_image:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.yq_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    dst = np.empty((h.value, w.value, 3), np.float32)
    if lib.yq_decode_image(path.encode(), _ptr(dst), h.value, w.value) != 0:
        return None
    return dst


def augment_place(im: np.ndarray, out_w: int, out_h: int, nw: int, nh: int, dx: int, dy: int,
                  dhue: float, dsat: float, dexp: float, flip: bool) -> np.ndarray:
    """The fused resize, canvas placement, HSV distortion and flip of one
    training sample (random parameters drawn by the caller); falls back to
    ``data.voc.place_distort_flip_numpy``, the native kernel's golden
    reference."""
    lib = load_library()
    if lib is None or not lib._has_image:
        from yolo_quantization_tpu_torch.data.voc import place_distort_flip_numpy

        return place_distort_flip_numpy(im, out_w, out_h, nw, nh, dx, dy, dhue, dsat, dexp, flip)
    src = _f32(im)
    dst = np.empty((out_h, out_w, 3), np.float32)
    lib.yq_augment_place(_ptr(src), im.shape[0], im.shape[1], _ptr(dst), out_h, out_w,
                         nw, nh, dx, dy, dhue, dsat, dexp, int(flip))
    return dst


def letterbox(im: np.ndarray, net_w: int, net_h: int) -> np.ndarray:
    """darknet's letterbox; falls back to ``data.image.letterbox``."""
    lib = load_library()
    if lib is None:
        from yolo_quantization_tpu_torch.data.image import letterbox as np_letterbox

        return np_letterbox(im, net_w, net_h)
    src = _f32(im)
    dst = np.empty((net_h, net_w, im.shape[2]), np.float32)
    lib.yq_letterbox(_ptr(src), im.shape[0], im.shape[1], _ptr(dst), net_h, net_w, im.shape[2])
    return dst
