"""The SPP block as one hand-written CUDA kernel (``csrc/spp.cu``).

YOLOv4's spatial pyramid pooling, stride-1 maxpools of 5, 9 and 13 over one
map and a route that concatenates them with the map, each branch
requantized onto the route's grid: ``infer/engine.py::spp_plan`` finds such
a block and the engine runs it here in one call.  A branch is (size,
identity, ratio, zp_in): size 1 is the input itself, else its darknet
stride-1 maxpool of that odd size (padding size - 1, the domain minimum);
``identity`` copies the codes, else the route's requant
(``nn/layers.py::requant_i8``) regrids them from ``zp_in`` by ``ratio``.

The wrapper launches ``spp_kernel`` on a CUDA tensor or raises, with no
fallback: off the card the engine runs the block's layers one by one, and
the kernel equals them (``maxpool_u8`` per pool, the route's requant and
concat) bit for bit (``csrc/spp.cu`` says why).  ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from yolo_quantization_tpu_torch.ops import _build
from yolo_quantization_tpu_torch.ops.cuda_qconv import check_aligned

launches = 0  # kernel launches since import (or since a caller reset it)
_launches_lock = threading.Lock()  # the server's threads launch concurrently
MAX_BRANCHES = 8  # csrc/spp.cu::kMaxBranches
CHANNEL_STEP = 16  # the kernel takes C in multiples of 16 (one 16-byte word a pixel)


def _library() -> ctypes.CDLL:
    lib = _build.load("spp")
    fn = lib.yq_spp
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
                       + [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
                       + [ctypes.c_int, ctypes.c_void_p])
    return lib


def build() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def check_branches(branches, channels: int) -> None:
    """The branches the kernel takes: 1 to 8, each of size 1 or an odd
    pool size from 3, at least one pool, a positive ratio; C a multiple of
    16."""
    if not 1 <= len(branches) <= MAX_BRANCHES:
        raise ValueError(f"spp: {len(branches)} branches, the kernel takes 1 to {MAX_BRANCHES}")
    for size, identity, ratio, _ in branches:
        if size != 1 and (size < 3 or size % 2 == 0):
            raise ValueError(f"spp: pool size {size} is not odd and at least 3")
        if not identity and not ratio > 0:
            raise ValueError(f"spp: requant ratio {ratio} is not positive")
    if all(size == 1 for size, *_ in branches):
        raise ValueError("spp: no branch pools")
    if channels % CHANNEL_STEP:
        raise ValueError(f"spp: {channels} channels, the kernel takes a multiple of {CHANNEL_STEP}")


def spp_cuda(x_i8: torch.Tensor, branches, out_zp: int) -> torch.Tensor:
    """The SPP block on shifted int8 codes (N, H, W, C) in one launch of
    ``spp_kernel``: each branch's codes, pooled and requantized as the
    engine's layers would, concatenated in branch order to (N, H, W,
    len(branches) C).  ``branches``: (size, identity, ratio, zp_in) in
    route order; ``out_zp`` and each ``zp_in`` are uint8-domain zero
    points."""
    global launches
    if x_i8.dtype != torch.int8 or x_i8.dim() != 4:
        raise ValueError(f"spp: expected (N, H, W, C) int8 codes, got {x_i8.dtype} {tuple(x_i8.shape)}")
    n, h, w, c = x_i8.shape
    check_branches(branches, c)
    if x_i8.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_i8.device}")
    if not x_i8.is_contiguous():
        raise ValueError("spp: x must be contiguous")
    if n > 65535:
        raise ValueError(f"batch {n} > 65535")
    out = torch.empty((n, h, w, c * len(branches)), dtype=torch.int8, device=x_i8.device)
    check_aligned(("x", x_i8), ("out", out))
    k = len(branches)
    size = (ctypes.c_int * k)(*(b[0] for b in branches))
    identity = (ctypes.c_int * k)(*(int(b[1]) for b in branches))
    ratio = (ctypes.c_float * k)(*(float(np.float32(b[2])) for b in branches))
    zin = (ctypes.c_int * k)(*(int(b[3]) - 128 for b in branches))
    lib = _library()
    with torch.cuda.device(x_i8.device):
        stream = torch.cuda.current_stream(x_i8.device).cuda_stream
        err = lib.yq_spp(x_i8.data_ptr(), out.data_ptr(), n, h, w, c, k, size, identity, ratio, zin,
                         int(out_zp) - 128, stream)
    if err != 0:
        raise RuntimeError(f"spp kernel launch failed: cudaError {err}")
    with _launches_lock:
        launches += 1
    return out
