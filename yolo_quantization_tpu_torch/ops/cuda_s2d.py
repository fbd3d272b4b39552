"""Hand-written CUDA s2d stem kernel (``csrc/s2d_qconv.cu``) and its wrapper.

Replaces ``yolo_quantization_tpu/ops/pallas_qconv.py::pallas_s2d_conv_phase_max``:
the 3x3/s1/p1 conv over the 2x2 space-to-depth input with the block kernel
of ``infer/convert.py::_s2d_weights``, the max over the 4 output-phase
groups on the int32 accumulators, then the requant epilogue — the stem's
conv + 2x2/s2 maxpool in one pass.  The kernel reads the NHWC input
directly, applying the space-to-depth index map and the zero-point padding
as it loads.  It is an implicit GEMM on the int8 tensor cores whose B
operand ``pack_weights`` lays out with an output channel's four phase
columns side by side, so the phase max is taken in registers.

On a CPU tensor the wrapper runs the plain PyTorch version
(``ops/qconv.py::s2d_conv_phase_max`` over ``space_to_depth(x)``); on a
CUDA tensor it launches the kernel or raises.  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from yolo_quantization_tpu_torch.ops import _build
from yolo_quantization_tpu_torch.ops.cuda_qconv import (
    ACTS,
    check_aligned,
    check_bias_m,
    check_tensor,
    per_image_zp,
    zero_point_args,
)
from yolo_quantization_tpu_torch.ops.qconv import (
    ACT_LINEAR,
    s2d_conv_phase_max,
    space_to_depth,
    u8_to_i8,
)

launches = 0  # kernel launches since import (or since a caller reset it)
_launches_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    lib = _build.load("s2d_qconv")
    fn = lib.yq_s2d_qconv
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    return lib


def build() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def pack_weights(w_s2d: torch.Tensor) -> torch.Tensor:
    """(3,3,4C,4O) block kernel -> the kernel's B operand, (N_pad, K_pad)
    int8, K contiguous in w_s2d's flatten order (tap-major, slot-minor) and
    zero-padded to a multiple of 32.  Output slot ph*O + o goes to column
    16*(o//4) + 8*(ph//2) + 2*(o%4) + ph%2: in the m16n8 accumulator a
    thread holds columns 2t and 2t+1 of each n8 tile, so the two n8 tiles
    of a 16-column group hold phases 0..3 of channel 4*group + t in one
    thread.  O is zero-padded to a multiple of 4 (N_pad = 4*O_pad)."""
    kh, kw, c4, o4 = w_s2d.shape
    depth, o = kh * kw * c4, o4 // 4
    w = F.pad(w_s2d.reshape(depth, 4, o), (0, -o % 4))            # [k][ph][o]
    w = w.reshape(depth, 2, 2, -1, 4).permute(3, 1, 4, 2, 0)       # [o/4][ph/2][o%4][ph%2][k]
    return F.pad(w.reshape(-1, depth), (0, -depth % 32)).contiguous()


def packed_shape(c: int, o: int) -> tuple[int, int]:
    """(N_pad, K_pad) of ``pack_weights`` for C input and O output channels."""
    return -(-o // 4) * 16, -(-(36 * c) // 32) * 32


def s2d_conv_phase_max_cuda(
    x_u8: torch.Tensor,
    w_s2d: torch.Tensor,
    bias_i32: torch.Tensor,
    m: torch.Tensor,
    x_zp_i32,
    *,
    act: int = ACT_LINEAR,
    out_zp_static: int = 0,
    exact_leaky: bool = False,
    w_packed: torch.Tensor | None = None,
) -> torch.Tensor:
    """The stem's conv + 2x2/s2 maxpool through the s2d block kernel.

    x_u8: (N,H,W,C) uint8 codes or shifted int8, H and W even (NHWC, not
    yet space-to-depth); w_s2d: (3,3,4C,4O) int8; bias_i32/m: (O,) or per
    image (N,O); x_zp_i32: the shifted input zero point, an int or an (N,)
    int32 tensor.  ``w_packed`` is ``pack_weights(w_s2d)``.  Returns shifted
    int8 (N,H/2,W/2,O).
    """
    global launches
    if x_u8.dim() != 4 or w_s2d.dim() != 4:
        raise ValueError(f"expected NHWC x and HWIO w_s2d, got {tuple(x_u8.shape)}, {tuple(w_s2d.shape)}")
    n, h, w, c = x_u8.shape
    if tuple(w_s2d.shape[:3]) != (3, 3, 4 * c) or w_s2d.shape[3] % 4:
        raise ValueError(f"w_s2d {tuple(w_s2d.shape)} does not fit input {tuple(x_u8.shape)}")
    if h % 2 or w % 2:
        raise ValueError(f"the s2d stem needs even H and W, got {h}x{w}")
    if act not in ACTS:
        raise ValueError(f"unsupported quantized activation code {act}")
    o = w_s2d.shape[3] // 4
    x_zp = per_image_zp(x_zp_i32, n)

    if x_u8.device.type == "cpu":
        x = x_u8 if x_u8.dtype == torch.int8 else u8_to_i8(x_u8)
        return s2d_conv_phase_max(space_to_depth(x), w_s2d, bias_i32, m, x_zp, out_zp_static,
                                  act=act, exact_leaky=exact_leaky)
    if x_u8.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_u8.device}")

    if x_u8.dtype not in (torch.uint8, torch.int8):
        raise ValueError(f"x: expected uint8/int8 codes, got {x_u8.dtype}")
    if not 0 <= int(out_zp_static) <= 255:
        raise ValueError(f"output zero point {out_zp_static} out of range")
    if n > 65535:
        raise ValueError(f"batch {n} > 65535")
    dev = x_u8.device
    x = x_u8 if x_u8.dtype == torch.int8 else u8_to_i8(x_u8)
    if w_packed is None:
        w_packed = pack_weights(w_s2d)
    check_tensor("x", x, torch.int8, (n, h, w, c), dev)
    check_tensor("w_packed", w_packed, torch.int8, packed_shape(c, o), dev)
    per_image = check_bias_m(bias_i32, m, n, o, dev)
    check_aligned(("x", x), ("w_packed", w_packed))
    zp_ptr, zp_static = zero_point_args(x_zp, n, dev)
    out = torch.empty((n, h // 2, w // 2, o), dtype=torch.int8, device=dev)

    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yq_s2d_qconv(
            x.data_ptr(), w_packed.data_ptr(), zp_ptr, bias_i32.data_ptr(), m.data_ptr(),
            out.data_ptr(), n, h, w, c, o, zp_static, int(out_zp_static), act,
            int(exact_leaky), int(per_image), stream,
        )
    if err != 0:
        raise RuntimeError(f"s2d_qconv kernel launch failed: cudaError {err}")
    with _launches_lock:
        launches += 1
    return out
