"""Hand-written CUDA integer shortcut (``csrc/shortcut.cu``) and its wrapper.

Replaces the integer branch of the shortcut in
``yolo_quantization_tpu/infer/engine.py::build_forward`` (an XLA loop fusion
there, not a Pallas kernel): one pass that reads both int8 operands with
16-byte loads and writes the output codes, every float operation rounded
on its own (``ops/shortcut.py`` says why).

On a CPU tensor the wrapper runs the plain PyTorch version
(``ops/shortcut.py::int_shortcut``); on a CUDA tensor it launches the kernel
or raises — there is no fallback.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from yolo_quantization_tpu_torch.ops import _build
from yolo_quantization_tpu_torch.ops.cuda_qconv import check_aligned
from yolo_quantization_tpu_torch.ops.shortcut import ShortcutConsts, int_shortcut

launches = 0  # kernel launches since import (or since a caller reset it)
_launches_lock = threading.Lock()  # the server's threads launch concurrently


def _library() -> ctypes.CDLL:
    lib = _build.load("shortcut")
    fn = lib.yq_shortcut
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_float] * 4
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    return lib


def build() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def int_shortcut_cuda(x_i8: torch.Tensor, skip_i8: torch.Tensor, k: ShortcutConsts) -> torch.Tensor:
    """The integer shortcut of ``ops/shortcut.py::int_shortcut``: shifted
    int8 ``x_i8`` (the previous layer) and ``skip_i8`` (the skip source), of
    one shape, contiguous, on one device; returns shifted int8 codes."""
    global launches
    if x_i8.dtype != torch.int8 or skip_i8.dtype != torch.int8:
        raise ValueError(f"shortcut: expected int8 operands, got {x_i8.dtype} and {skip_i8.dtype}")
    if x_i8.shape != skip_i8.shape:
        raise ValueError(f"shortcut: operand shapes {tuple(x_i8.shape)} and {tuple(skip_i8.shape)} differ")
    if x_i8.device != skip_i8.device:
        raise ValueError(f"shortcut: operands on {x_i8.device} and {skip_i8.device}")
    if not (x_i8.is_contiguous() and skip_i8.is_contiguous()):
        raise ValueError("shortcut: operands must be contiguous")
    if x_i8.device.type == "cpu":
        return int_shortcut(x_i8, skip_i8, k)
    if x_i8.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_i8.device}")
    check_aligned(("x", x_i8), ("skip", skip_i8))
    out = torch.empty_like(x_i8)
    lib = _library()
    dev = x_i8.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yq_shortcut(x_i8.data_ptr(), skip_i8.data_ptr(), out.data_ptr(), out.numel(),
                              k.ra, k.rb, k.cst, k.cap, k.act, k.out_zp, stream)
    if err != 0:
        raise RuntimeError(f"shortcut kernel launch failed: cudaError {err}")
    with _launches_lock:
        launches += 1
    return out
