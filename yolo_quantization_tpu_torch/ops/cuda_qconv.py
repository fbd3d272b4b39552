"""Hand-written CUDA int8 conv kernel (``csrc/qconv.cu``) and its wrapper.

Replaces ``yolo_quantization_tpu/ops/pallas_qconv.py::pallas_quantized_conv2d``:
a fused stride-1 or stride-2 conv, the requant epilogue, and optionally (at
stride 1) the following darknet 2x2/s2 maxpool.  The int8 carrier is an
implicit GEMM on the int8 tensor cores over the weights packed by
``pack_weights``, in three designs (``design``): ``wgmma`` (Hopper's
warpgroup MMA, weights by TMA, a warp-specialised ring) for the
operation-bound convs, Ci a multiple of 64; ``halo`` (each tile's input
halo fetched once by TMA, A read from it in place, ``mma.sync`` s8,
16-byte stores) for the bytes-bound 3x3 convs from Ci 3, 16, 32 or 48 to
Co 16, 32 or 64; ``mma.sync`` s8 with its own loaders for the rest.
Unlike the Pallas kernel it takes what the
reference engine ran on XLA: stride 2 (yolov3's downsampling convs), any
input channel count (the 3-channel stem), asymmetric weights, a per-image
input zero point and (N, Co) bias/m (``dynamic_input``), ``exact_leaky``,
mish's table epilogue (YOLOv4; ``ops/qconv.py::mish_table``) and the int16
carrier.

On a CPU tensor the wrapper runs the plain PyTorch version
(``ops/qconv.py``); on a CUDA tensor it launches the kernel or raises —
there is no fallback.  ``launches`` counts kernel launches,
``design_launches`` the same launches by the design the C side reports.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from yolo_quantization_tpu_torch.ops import _build
from yolo_quantization_tpu_torch.ops.qconv import (
    ACT_LEAKY,
    ACT_LINEAR,
    ACT_MISH,
    ACT_RELU,
    ACT_RELU6,
    quantized_conv2d,
    quantized_conv2d_pool,
    u8_to_i8,
)

launches = 0  # kernel launches since import (or since a caller reset it)
# the same launches by design ("wgmma", "halo", "mma.sync", "int16"); reset_launches zeroes both
design_launches = {"wgmma": 0, "halo": 0, "mma.sync": 0, "int16": 0}
_launches_lock = threading.Lock()  # the server's threads launch concurrently
_ROUTES = {1: "mma.sync", 2: "wgmma", 3: "int16", 4: "halo"}  # yq_qconv's route codes
_FORCE = {None: 0, "mma.sync": 1, "wgmma": 2, "halo": 4}  # yq_qconv's design argument

ACTS = (ACT_LINEAR, ACT_LEAKY, ACT_RELU, ACT_RELU6, ACT_MISH)  # mish with its table
_MAX_K = 3
_STRIDES = (1, 2)
_CARRIERS = ("int8", "int16")


def _library() -> ctypes.CDLL:
    lib = _build.load("qconv")
    fn = lib.yq_qconv
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
                       + [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    return lib


def build() -> None:
    """Build (if needed) and load the kernel library."""
    _library()


def reset_launches() -> None:
    """Zero ``launches`` and ``design_launches``."""
    global launches
    with _launches_lock:
        launches = 0
        for key in design_launches:
            design_launches[key] = 0


def design(ci: int, k: int, co: int, carrier: str = "int8", *, pad: int, w: int) -> str:
    """The design the kernel launches for a conv (``qconv.cu::launch_tile``):
    ``halo`` where ``halo_capable``; ``wgmma`` for the int8 carrier with Ci a
    multiple of 64 (a K slab is one tap's 64 or 128 channels) and K 1 or 3,
    at either stride, with any option, but for the 1x1 convs that ran slower
    there on the H100 (Ci up to 128; Co past 128 and not a multiple of 16
    with Ci up to 512); ``int16`` for that carrier; ``mma.sync`` for the
    rest (the narrow layers the halo design does not take).  ``pad`` and
    ``w`` are the conv's padding and input width."""
    if carrier == "int16":
        return "int16"
    if halo_capable(ci, k, co, carrier, pad=pad, w=w):
        return "halo"
    if not wgmma_capable(ci, k, carrier) or (k == 1 and (ci <= 128 or (co > 128 and co % 16 and ci <= 512))):
        return "mma.sync"
    return "wgmma"


def wgmma_capable(ci: int, k: int, carrier: str) -> bool:
    """The convs the wgmma design can run (``qconv.cu::wgmma_takes``), routed
    there or not."""
    return carrier == "int8" and ci % 64 == 0 and k in (1, 3)


def halo_capable(ci: int, k: int, co: int, carrier: str, *, pad: int, w: int) -> bool:
    """The convs the halo design runs (``qconv.cu::halo_takes``), all routed
    there: the int8 carrier, 3x3 with pad 1 at stride 1 or 2 (pooled or
    not), Co 16, 32 or 64, and Ci 16, 32 or 48, or Ci 3 where a row of
    W * 3 bytes is a multiple of 16 (TMA's stride rule; every darknet
    width, a multiple of 32, is)."""
    if carrier != "int8" or k != 3 or pad != 1 or co not in (16, 32, 64):
        return False
    return w % 16 == 0 if ci == 3 else ci % 16 == 0 and ci <= 48


def forcible(ci: int, k: int, co: int, carrier: str, *, pad: int, w: int) -> tuple[str, ...]:
    """The designs ``_design`` may force on a conv: none where only one
    design can run it, else mma.sync and the design that takes it."""
    if wgmma_capable(ci, k, carrier):
        return ("mma.sync", "wgmma")
    if halo_capable(ci, k, co, carrier, pad=pad, w=w):
        return ("mma.sync", "halo")
    return ()


def pack_weights(w_i8: torch.Tensor) -> torch.Tensor:
    """HWIO int8 weights -> the kernel's B operand, (Co_pad, K_pad) int8:
    row o holds w[ky, kx, ci, o] at column (ky*K + kx)*Cin + ci (the HWIO
    flatten order), K zero-padded to a multiple of 32 (one tensor-core
    k-step) and Co to a multiple of 16."""
    k, k2, ci, co = w_i8.shape
    depth = k * k2 * ci
    w = w_i8.reshape(depth, co).t()
    return F.pad(w, (0, -depth % 32, 0, -co % 16)).contiguous()


def packed_shape(k: int, ci: int, co: int) -> tuple[int, int]:
    """(Co_pad, K_pad) of ``pack_weights`` for a KxK conv from Ci to Co."""
    return -(-co // 16) * 16, -(-(k * k * ci) // 32) * 32


def check_tensor(name, t: torch.Tensor, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_aligned(*named: tuple[str, torch.Tensor]) -> None:
    """The int8 kernels read their operands with 16-byte copies."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data must start on a 16-byte boundary")


def per_image_zp(x_zp_i32, n: int):
    """The input zero point as an int, or as an (n,) int32 tensor when it
    is one per image (``dynamic_input``)."""
    if isinstance(x_zp_i32, torch.Tensor) and x_zp_i32.ndim == 1:
        if x_zp_i32.shape[0] != n:
            raise ValueError(f"x_zp: {x_zp_i32.shape[0]} zero points for {n} images")
        return x_zp_i32
    return int(x_zp_i32)


def zero_point_args(x_zp, n: int, dev) -> tuple[int | None, int]:
    """The kernels' (per-image pointer, static value) pair for the input
    zero point returned by ``per_image_zp``."""
    if isinstance(x_zp, torch.Tensor):
        check_tensor("x_zp", x_zp, torch.int32, (n,), dev)
        return x_zp.data_ptr(), 0
    if not -128 <= x_zp <= 127:
        raise ValueError(f"input zero point {x_zp} out of range")
    return None, x_zp


def check_bias_m(bias_i32: torch.Tensor, m: torch.Tensor, n: int, co: int, dev) -> bool:
    """Validate (Co,) or per-image (N, Co) bias/m; True when per image."""
    per_image = bias_i32.ndim == 2
    shape = (n, co) if per_image else (co,)
    check_tensor("bias_i32", bias_i32, torch.int32, shape, dev)
    check_tensor("m", m, torch.float32, shape, dev)
    return per_image


def quantized_conv2d_cuda(
    x_u8: torch.Tensor,
    w_i8: torch.Tensor,
    bias_i32: torch.Tensor,
    m: torch.Tensor,
    x_zp_i32,
    *,
    stride: int = 1,
    pad: int = 0,
    act: int = ACT_LINEAR,
    out_zp_static: int = 0,
    fuse_pool: bool = False,
    out_i8: bool = False,
    w_packed: torch.Tensor | None = None,
    w_zp: torch.Tensor | None = None,
    exact_leaky: bool = False,
    carrier: str = "int8",
    mish: tuple | None = None,
    _design: str | None = None,
) -> torch.Tensor:
    """Fused integer conv, stride 1 or 2 (darknet's output geometry, (H + 2
    pad - K) // stride + 1): the kernel's argument list is the Pallas
    kernel's plus the reference engine's options.  ``w_packed`` is
    ``pack_weights(w_i8)``, precomputed by callers that run the same weights
    repeatedly.

    x_u8: (N,H,W,Ci) uint8 codes or shifted int8; w_i8: (K,K,Ci,Co) int8;
    bias_i32: (Co,) int32 or per image (N, Co); m: float32, same shape;
    x_zp_i32: the shifted input zero point, an int or per image an (N,)
    int32 tensor; w_zp: (Co,) int32 shifted weight zero points, None for
    symmetric weights; ``mish`` (T, lo) with ``act=ACT_MISH``: the uint8
    table of ``ops/qconv.py::mish_table`` as a tensor on x's device, and its
    start.  Returns uint8 (N,Ho,Wo,Co), shifted int8 with ``out_i8``, pooled
    to (N,Ho/2,Wo/2,Co) with ``fuse_pool`` (stride 1 only, and not with
    mish, which is not monotone).  ``_design`` ("mma.sync", "wgmma" or "halo") forces a design on a
    conv that the wgmma or the halo design can run (``forcible``), whatever
    ``design`` routes it to; only the timing tool, the tests and the smoke
    run pass it, to hold and time two designs on the same conv.
    """
    global launches
    if stride not in _STRIDES:
        raise ValueError(f"unsupported stride {stride}: the kernel takes 1 or 2")
    if fuse_pool and stride != 1:
        raise ValueError("fuse_pool requires stride 1")
    if x_u8.dim() != 4 or w_i8.dim() != 4:
        raise ValueError(f"expected NHWC x and HWIO w, got {tuple(x_u8.shape)}, {tuple(w_i8.shape)}")
    n, h, w, ci = x_u8.shape
    k, k2, wci, co = w_i8.shape
    if k != k2 or wci != ci:
        raise ValueError(f"weights {tuple(w_i8.shape)} do not fit input {tuple(x_u8.shape)}")
    if pad < 0 or h + 2 * pad < k or w + 2 * pad < k:
        raise ValueError(f"invalid geometry: pad {pad}, kernel {k}, input {h}x{w}")
    h_out, w_out = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    if act not in ACTS:
        raise ValueError(f"unsupported quantized activation code {act}")
    if act == ACT_MISH and mish is None:
        raise ValueError("the mish epilogue needs its table (mish=(T, lo))")
    if act == ACT_MISH and fuse_pool:
        raise ValueError("fuse_pool cannot take mish: the pool would run before a non-monotone epilogue")
    if carrier not in _CARRIERS:
        raise ValueError(f"unsupported conv carrier {carrier!r}")
    if fuse_pool and (h_out % 2 or w_out % 2):
        raise ValueError("fuse_pool requires even conv output dims")
    if _design not in _FORCE:
        raise ValueError(f"_design: 'mma.sync', 'wgmma' or 'halo' may be forced, got {_design!r}")
    if _design and _design not in forcible(ci, k, co, carrier, pad=pad, w=w):
        raise ValueError(f"_design: {_design!r} cannot run a {k}x{k} conv (pad {pad}) from {ci} to {co} channels "
                         f"at width {w} ({carrier}); forcible there: {forcible(ci, k, co, carrier, pad=pad, w=w)}")
    x_zp = per_image_zp(x_zp_i32, n)

    if x_u8.device.type == "cpu":
        kw = dict(act=act, out_i8=out_i8, carrier=carrier, exact_leaky=exact_leaky)
        if fuse_pool:
            return quantized_conv2d_pool(x_u8, w_i8, bias_i32, m, x_zp, out_zp_static,
                                         pad=pad, w_zp_i32=w_zp, **kw)
        return quantized_conv2d(x_u8, w_i8, bias_i32, m, x_zp, w_zp, out_zp_static,
                                stride=stride, pad=pad, symmetric=w_zp is None, mish=mish, **kw)
    if x_u8.device.type != "cuda":
        raise ValueError(f"no kernel for device {x_u8.device}")

    if x_u8.dtype not in (torch.uint8, torch.int8):
        raise ValueError(f"x: expected uint8/int8 codes, got {x_u8.dtype}")
    if not 0 <= int(out_zp_static) <= 255:
        raise ValueError(f"output zero point {out_zp_static} out of range")
    if k > _MAX_K:
        raise ValueError(f"kernel size {k} > {_MAX_K}")
    if n > 65535:
        raise ValueError(f"batch {n} > 65535")
    dev = x_u8.device
    x = x_u8 if x_u8.dtype == torch.int8 else u8_to_i8(x_u8)
    if w_packed is None:
        w_packed = pack_weights(w_i8)
    check_tensor("x", x, torch.int8, (n, h, w, ci), dev)
    check_tensor("w_packed", w_packed, torch.int8, packed_shape(k, ci, co), dev)
    per_image = check_bias_m(bias_i32, m, n, co, dev)
    if w_zp is not None:
        check_tensor("w_zp", w_zp, torch.int32, (co,), dev)
    table, t_lo = (None, 0) if act != ACT_MISH else mish
    if table is not None:
        check_tensor("mish table", table, torch.uint8, (table.numel(),), dev)
    check_aligned(("x", x), ("w_packed", w_packed))
    zp_ptr, zp_static = zero_point_args(x_zp, n, dev)
    oh, ow = (h_out // 2, w_out // 2) if fuse_pool else (h_out, w_out)
    out = torch.empty((n, oh, ow, co), dtype=torch.int8 if out_i8 else torch.uint8, device=dev)

    lib = _library()
    route = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yq_qconv(
            x.data_ptr(), w_packed.data_ptr(), None if w_zp is None else w_zp.data_ptr(),
            zp_ptr, bias_i32.data_ptr(), m.data_ptr(), out.data_ptr(),
            n, h, w, ci, co, k, pad, stride, zp_static, int(out_zp_static), act, int(exact_leaky),
            int(out_i8), int(fuse_pool), int(per_image), int(carrier == "int16"),
            _FORCE[_design], None if table is None else table.data_ptr(), int(t_lo),
            0 if table is None else table.numel(), ctypes.byref(route), stream,
        )
    if err != 0:
        raise RuntimeError(f"qconv kernel launch failed: cudaError {err}")
    launched = _ROUTES.get(route.value)
    expected = _design or design(ci, k, co, carrier, pad=pad, w=w)
    if launched != expected:
        raise RuntimeError(f"qconv launched design {launched!r} (route {route.value}), expected {expected!r}")
    with _launches_lock:
        launches += 1
        design_launches[launched] += 1
    return out
