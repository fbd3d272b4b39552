"""Hand-written CUDA s2d stem kernel (``csrc/s2d_qconv.cu``) and its wrapper.

Replaces ``yolo_quantization_tpu/ops/pallas_qconv.py::pallas_s2d_conv_phase_max``:
the 3x3/s1/p1 conv over the 2x2 space-to-depth input with the block kernel
of ``infer/convert.py::_s2d_weights``, the max over the 4 output-phase
groups on the int32 accumulators, then the requant epilogue — the stem's
conv + 2x2/s2 maxpool in one pass.  The kernel reads the NHWC input
directly, applying the space-to-depth index map and the zero-point padding
as it loads.  Two designs (``design``), chosen by the block kernel that
``pack_weights`` packs: ``halo`` for a *structured* one (every entry
outside ``_s2d_weights``' pattern zero: each output phase is then a 3x3
conv of its own, 36·C·O MACs a block), K1's halo tile with one B slice per
phase; ``mma.sync`` for any other (a dense implicit GEMM over the whole
block kernel, 144·C·O MACs a block, whose B ``pack_dense`` lays out with an
output channel's four phase columns side by side, so the phase max is
taken in registers) and for the shapes the halo design does not take.

On a CPU tensor the wrapper runs the plain PyTorch version
(``ops/qconv.py::s2d_conv_phase_max`` over ``space_to_depth(x)``); on a
CUDA tensor it launches the kernel or raises.  ``launches`` counts kernel
launches, ``design_launches`` the same launches by the design the C side
reports.
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
# the same launches by design ("halo", "mma.sync"); reset_launches zeroes both
design_launches = {"halo": 0, "mma.sync": 0}
_launches_lock = threading.Lock()
_ROUTES = {1: "mma.sync", 4: "halo"}  # yq_s2d_qconv's route codes
HALO_CO = (16, 32, 64)


def _library() -> ctypes.CDLL:
    lib = _build.load("s2d_qconv")
    fn = lib.yq_s2d_qconv
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
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


def halo_capable(c: int, o: int, *, w: int) -> bool:
    """The convs the halo design runs (``s2d_qconv.cu::halo_takes``) where
    the block kernel is structured: O 16, 32 or 64, and C 16, 32 or 48, or
    C 3 where a row of W * 3 bytes is a multiple of 16 (TMA's stride rule;
    every darknet width, a multiple of 32, is) — K1's rule for its pooled
    3x3 convs."""
    return _halo_channels(c, o) and (c != 3 or w % 16 == 0)


def _halo_channels(c: int, o: int) -> bool:
    return o in HALO_CO and (c == 3 or (c % 16 == 0 and c <= 48))


def design(c: int, o: int, *, w: int, structured: bool) -> str:
    """The design the kernel launches (``s2d_qconv.cu``'s entry): ``halo``
    for a structured block kernel on a conv ``halo_capable`` admits,
    ``mma.sync`` for the rest.  ``w`` is the input width."""
    return "halo" if structured and halo_capable(c, o, w=w) else "mma.sync"


def forcible(c: int, o: int, *, w: int) -> tuple[str, ...]:
    """The designs ``_design`` may force on a conv: mma.sync and halo where
    the halo design can run the conv (with a structured block kernel),
    none elsewhere."""
    return ("mma.sync", "halo") if halo_capable(c, o, w=w) else ()


def _pattern():
    """For output phase ph = py*2+px and original tap (u, v) (0..2), the
    block tap and the slot group ``_s2d_weights`` writes it to: yields (ph,
    u, v, block row, block column, slot group)."""
    for py in (0, 1):
        for px in (0, 1):
            for u in range(3):
                ay, qy = divmod(py + u - 1, 2)
                for v in range(3):
                    ax, qx = divmod(px + v - 1, 2)
                    yield py * 2 + px, u, v, ay + 1, ax + 1, qy * 2 + qx


def phase_kernels(w_s2d: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """The four phase kernels of a block kernel, (4, 3, 3, C, O) (phase
    (py, px) at py*2+px, HWIO), read from ``_s2d_weights``' pattern, and
    whether the block kernel is structured: zero everywhere else."""
    kh, kw, c4, o4 = w_s2d.shape
    c, o = c4 // 4, o4 // 4
    w = w_s2d.cpu()
    kernels = torch.zeros((4, 3, 3, c, o), dtype=w.dtype)
    rest = w.clone()
    for ph, u, v, by, bx, q in _pattern():
        kernels[ph, u, v] = w[by, bx, q * c:(q + 1) * c, ph * o:(ph + 1) * o]
        rest[by, bx, q * c:(q + 1) * c, ph * o:(ph + 1) * o] = 0
    return kernels, not bool(rest.any())


def pack_phases(w_s2d: torch.Tensor, share: bool = True) -> torch.Tensor:
    """A structured block kernel -> the halo design's B operand, (P, O,
    K_pad) int8 on w_s2d's device: slice ph (P = 4) or the one slice all
    four phases share (P = 1, where they are equal and ``share``) holds
    the phase's 3x3 kernel as K1's ``pack_weights`` packs one, row o at
    column (u*3 + v)*C + c, K = 9C zero-padded to a multiple of 32.
    ``share=False`` keeps four slices of equal kernels (to time the
    four-slice tile on an engine's weights)."""
    kernels, structured = phase_kernels(w_s2d)
    if not structured:
        raise ValueError("pack_phases: the block kernel has entries outside _s2d_weights' pattern")
    if share and all(torch.equal(kernels[0], k) for k in kernels[1:]):
        kernels = kernels[:1]
    p, _, _, c, o = kernels.shape
    b = kernels.reshape(p, 9 * c, o).transpose(1, 2)
    return F.pad(b, (0, -(9 * c) % 32)).contiguous().to(w_s2d.device)


def phases_shape(c: int, o: int, phases: int) -> tuple[int, int, int]:
    """(P, O, K_pad) of ``pack_phases`` for C input and O output channels."""
    return phases, o, -(-(9 * c) // 32) * 32


def pack_weights(w_s2d: torch.Tensor) -> torch.Tensor:
    """The operand of the design the block kernel takes, decided exactly
    on the host once per weight tensor (the engine caches it): a structured
    kernel whose channels the halo design takes (O 16, 32 or 64; C 3, 16,
    32 or 48) packs as ``pack_phases``, (P, O, K_pad); any other as
    ``pack_dense``, (N_pad, K_pad).  The wrapper reads the design off the
    operand's rank (and packs densely where a C 3 width misses TMA's
    stride rule)."""
    c, o = w_s2d.shape[2] // 4, w_s2d.shape[3] // 4
    if _halo_channels(c, o) and phase_kernels(w_s2d)[1]:
        return pack_phases(w_s2d)
    return pack_dense(w_s2d)


def pack_dense(w_s2d: torch.Tensor) -> torch.Tensor:
    """(3,3,4C,4O) block kernel -> the mma.sync design's B operand, (N_pad,
    K_pad) int8, K contiguous in w_s2d's flatten order (tap-major,
    slot-minor) and zero-padded to a multiple of 32.  Output slot ph*O + o
    goes to column 16*(o//4) + 8*(ph//2) + 2*(o%4) + ph%2: in the m16n8
    accumulator a thread holds columns 2t and 2t+1 of each n8 tile, so the
    two n8 tiles of a 16-column group hold phases 0..3 of channel 4*group +
    t in one thread.  O is zero-padded to a multiple of 4 (N_pad =
    4*O_pad)."""
    kh, kw, c4, o4 = w_s2d.shape
    depth, o = kh * kw * c4, o4 // 4
    w = F.pad(w_s2d.reshape(depth, 4, o), (0, -o % 4))            # [k][ph][o]
    w = w.reshape(depth, 2, 2, -1, 4).permute(3, 1, 4, 2, 0)       # [o/4][ph/2][o%4][ph%2][k]
    return F.pad(w.reshape(-1, depth), (0, -depth % 32)).contiguous()


def packed_shape(c: int, o: int) -> tuple[int, int]:
    """(N_pad, K_pad) of ``pack_dense`` for C input and O output channels."""
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
    _design: str | None = None,
) -> torch.Tensor:
    """The stem's conv + 2x2/s2 maxpool through the s2d block kernel.

    x_u8: (N,H,W,C) uint8 codes or shifted int8, H and W even (NHWC, not
    yet space-to-depth); w_s2d: (3,3,4C,4O) int8; bias_i32/m: (O,) or per
    image (N,O); x_zp_i32: the shifted input zero point, an int or an (N,)
    int32 tensor.  ``w_packed`` is ``pack_weights(w_s2d)``: its rank names
    the design (``design``).  ``_design`` ("mma.sync" or "halo") forces a
    design on a conv the halo design can run (``forcible``; "halo" needs a
    structured block kernel), with ``w_packed`` then that design's operand
    where given; only the timing tool, the tests and the smoke run pass it.
    Returns shifted int8 (N,H/2,W/2,O).
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
    if _design not in (None, "mma.sync", "halo"):
        raise ValueError(f"_design: 'mma.sync' or 'halo' may be forced, got {_design!r}")
    if _design and _design not in forcible(c, o, w=w):
        raise ValueError(f"_design: {_design!r} cannot run the s2d stem from {c} to {o} channels at width {w}; "
                         f"forcible there: {forcible(c, o, w=w)}")
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
    structured = w_packed.dim() == 3
    ran = _design or design(c, o, w=w, structured=structured)
    if ran == "halo":
        if not structured:
            raise ValueError("_design: 'halo' needs a structured block kernel (pack_weights gave the dense operand)")
        phases = w_packed.shape[0]
        if phases not in (1, 4):
            raise ValueError(f"w_packed: {phases} phase slices, expected 1 or 4")
        check_tensor("w_packed", w_packed, torch.int8, phases_shape(c, o, phases), dev)
    else:
        if structured:  # mma.sync multiplies the whole block kernel
            w_packed = pack_dense(w_s2d)
        phases = 0
        check_tensor("w_packed", w_packed, torch.int8, packed_shape(c, o), dev)
    check_tensor("x", x, torch.int8, (n, h, w, c), dev)
    per_image = check_bias_m(bias_i32, m, n, o, dev)
    check_aligned(("x", x), ("w_packed", w_packed))
    zp_ptr, zp_static = zero_point_args(x_zp, n, dev)
    out = torch.empty((n, h // 2, w // 2, o), dtype=torch.int8, device=dev)

    lib = _library()
    route = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yq_s2d_qconv(
            x.data_ptr(), w_packed.data_ptr(), zp_ptr, bias_i32.data_ptr(), m.data_ptr(),
            out.data_ptr(), n, h, w, c, o, zp_static, int(out_zp_static), act,
            int(exact_leaky), int(per_image), phases, ctypes.byref(route), stream,
        )
    if err != 0:
        raise RuntimeError(f"s2d_qconv kernel launch failed: cudaError {err}")
    launched = _ROUTES.get(route.value)
    if launched != ran:
        raise RuntimeError(f"s2d_qconv launched design {launched!r} (route {route.value}), expected {ran!r}")
    with _launches_lock:
        launches += 1
        design_launches[launched] += 1
    return out
