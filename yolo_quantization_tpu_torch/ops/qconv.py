"""Integer uint8 convolution in plain PyTorch: the oracles for the CUDA kernels.

The counterpart of ``yolo_quantization_tpu/ops/qconv.py``, bit for bit:

- uint8 codes are carried as int8 shifted by -128 (``u8_to_i8``), with the
  shift folded into the zero points;
- the input is padded with its zero point (one per image with
  ``dynamic_input``);
- the int32 accumulator is a float64 ``F.conv2d`` cast to int32.  PyTorch
  has no integer convolution, and float64 is exact here: |acc| is at most
  9 * 1024 * 255 * 128 < 2^53 (TF32 switches apply to float32 only);
- the epilogue keeps the reference's cast order: int32 add, then f32, then
  one multiply by the per-channel multiplier, leaky slope before a single
  round-half-even, zero point, clamp, narrow;
- mish (YOLOv4) is a table on the rounded pre-activation, built in float64
  at conversion (``mish_table``): a written departure from a float mish of
  the unrounded value, like ``exact_leaky``'s double rounding, which puts
  every code within 1 of round(mish(v S) / S) + zp.

Layouts are the reference's: NHWC activations, HWIO weights.  These run on
any device; ``ops/cuda_qconv.py`` and ``ops/cuda_s2d.py`` hold the hand
kernels for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from yolo_quantization_tpu_torch.nn.layers import maxpool_u8

ACT_LINEAR = 0
ACT_LEAKY = 1   # slope 0.1
ACT_RELU = 2
ACT_RELU6 = 3
ACT_MISH = 4    # the conv epilogue's table (mish_table); no shortcut takes it

ACTIVATION_BY_NAME = {  # the epilogues of the conv and the integer shortcut
    "linear": ACT_LINEAR,
    "leaky": ACT_LEAKY,
    "relu": ACT_RELU,
    "relu6": ACT_RELU6,
}
CONV_ACTIVATION_BY_NAME = {**ACTIVATION_BY_NAME, "mish": ACT_MISH}
_MISH_SCAN = 1 << 20  # the most pre-activation codes mish_table scans

_TENTH = float(np.float32(0.1))  # the f32 leaky slope, exactly


def mish64(x: np.ndarray) -> np.ndarray:
    """darknet's mish in float64: x tanh(softplus(x)), softplus x above 20
    and exp(x) below -20 (src/activations.h)."""
    x = np.asarray(x, np.float64)
    sp = np.where(x > 20.0, x, np.where(x < -20.0, np.exp(x), np.log1p(np.exp(np.minimum(x, 20.0)))))
    return x * np.tanh(sp)


def mish_table(out_scale: float, out_zp: int) -> tuple[int, np.ndarray]:
    """(lo, T): a mish conv's epilogue table, in float64.  The epilogue
    rounds the rescaled accumulator to r (output-scale units) and gives
    T[r - lo] for lo <= r < lo + len(T), ``out_zp`` below the table and
    clamp(r + out_zp) above it, where
    T[j] = clamp(round_half_even(mish((lo + j) S) / S) + zp, 0, 255).

    lo and len(T) are the tightest for which those two rules hold for every
    r.  Mish's tails are monotone in what they leave out: |mish(x)| <= |x|
    e^x below its minimum, and x - mish(x) = 2x / ((1 + e^x)^2 + 1) falls
    past x = 1.  So the rules are checked over r between the points where
    each of those is below S / 4, and hold beyond them."""
    scale, zp = float(out_scale), int(out_zp)
    x_lo = -2.0
    while -x_lo * np.exp(x_lo) >= scale / 4:
        x_lo -= 1.0
    x_hi = 1.0
    while 2 * x_hi / ((1 + np.exp(x_hi)) ** 2 + 1) >= scale / 4:
        x_hi += 1.0
    r_a, r_b = int(np.floor(x_lo / scale)) - 1, int(np.ceil(x_hi / scale)) + 1
    if r_b - r_a > _MISH_SCAN:
        raise ValueError(f"mish_table: output scale {scale} needs a scan of {r_b - r_a} codes")
    r = np.arange(r_a, r_b + 1, dtype=np.int64)
    codes = np.clip(np.round(mish64(r * scale) / scale) + zp, 0, 255)
    below_fails = r[codes != zp]
    above_fails = r[codes != np.clip(r + zp, 0, 255)]
    lo = int(below_fails.min()) if below_fails.size else None
    hi = int(above_fails.max()) + 1 if above_fails.size else None
    if lo is None and hi is None:
        lo = hi = 0
    elif lo is None:
        lo = min(hi, 0)
    elif hi is None:
        hi = max(lo, 0)
    lo = min(lo, hi)  # rules that never overlap need no table between them
    return lo, codes[lo - r_a:hi - r_a].astype(np.uint8)


def u8_to_i8(x_u8: torch.Tensor) -> torch.Tensor:
    """Shift uint8 codes to int8 (x - 128) without leaving the 8-bit domain."""
    return torch.bitwise_xor(x_u8, 0x80).view(torch.int8)


def _pad_zp(xf: torch.Tensor, pad: int, x_zp_i32) -> torch.Tensor:
    """Pad an NCHW float tensor by ``pad`` with the input zero point: a
    scalar (int or 0-d tensor), or one per image ((N,) tensor)."""
    if isinstance(x_zp_i32, torch.Tensor) and x_zp_i32.ndim == 1:
        zp = x_zp_i32.to(xf.device, xf.dtype).reshape(-1, 1, 1, 1)
        xp = F.pad(xf, (pad, pad, pad, pad))
        interior = torch.zeros(xp.shape[2:], dtype=torch.bool, device=xf.device)
        interior[pad : pad + xf.shape[2], pad : pad + xf.shape[3]] = True
        return torch.where(interior, xp, zp)
    return F.pad(xf, (pad, pad, pad, pad), value=float(int(x_zp_i32)))


def conv_acc_int32(
    x_i8: torch.Tensor,
    w_i8: torch.Tensor,
    x_zp_i32,
    w_zp_i32: torch.Tensor | None,
    stride: int,
    pad: int,
    symmetric: bool = False,
    carrier: str = "int8",
) -> torch.Tensor:
    """int32 accumulator of sum (x - zx)(w - zw[o]) over each conv window.

    x_i8 (N,H,W,C) and w_i8 (KH,KW,C,O) are shifted int8 codes; x_zp_i32 is
    the shifted input zero point (int or 0-d tensor, or (N,) per image),
    w_zp_i32 the (O,) shifted weight zero points.  As in the reference, the
    two static correction terms live in the converter's int32 bias; only the
    data-dependent -zw[o]*patchsum(x) term is computed here (skipped when
    ``symmetric``).

    ``carrier="int16"`` carries the codes in 16-bit containers, the
    reference's s16 x s16 -> s32 cross-check; the float64 accumulation is
    the same, so the result is too.
    """
    if carrier == "int16":
        x_i8, w_i8 = x_i8.to(torch.int16), w_i8.to(torch.int16)
    elif carrier != "int8":
        raise ValueError(f"unsupported conv carrier {carrier!r}")
    xf = x_i8.permute(0, 3, 1, 2).to(torch.float64)
    if pad:
        xf = _pad_zp(xf, pad, x_zp_i32)
    wf = w_i8.permute(3, 2, 0, 1).to(torch.float64)
    acc = F.conv2d(xf, wf, stride=stride).to(torch.int32)
    if not symmetric:
        ones = torch.ones((1,) + tuple(wf.shape[1:]), dtype=torch.float64, device=xf.device)
        patchsum = F.conv2d(xf, ones, stride=stride).to(torch.int32)
        acc = acc - w_zp_i32.to(acc.device, torch.int32).reshape(1, -1, 1, 1) * patchsum
    return acc.permute(0, 2, 3, 1).contiguous()


def requant_activate(
    acc: torch.Tensor,
    bias_i32: torch.Tensor,
    m: torch.Tensor,
    out_zp,
    act: int,
    out_i8: bool = False,
    exact_leaky: bool = False,
    mish: tuple | None = None,
) -> torch.Tensor:
    """Epilogue: bias add, per-channel rescale, quantized activation, clamp.

      v = round((acc + bias) * M[o])   leaky: 0.1 slope before the round
      out = clamp(v + zp_out, lo, hi)  relu/relu6: lo = max(zp_out, 0)

    ``exact_leaky`` is darknet's double-rounded leaky, round(0.1*round(v)).
    ``bias_i32``/``m`` are (O,) or per-image (N, O).  ACT_MISH takes
    ``mish`` = (T, lo), ``mish_table``'s uint8 table as a tensor and its
    start: r = round((acc + bias) * M[o]), then T[r - lo] inside the table,
    zp_out below it, clamp(r + zp_out) above it.
    """
    b = bias_i32.reshape(1, 1, 1, -1) if bias_i32.ndim == 1 else bias_i32[:, None, None, :]
    mm = m.reshape(1, 1, 1, -1) if m.ndim == 1 else m[:, None, None, :]
    vf = (acc + b).to(torch.float32) * mm
    if act == ACT_MISH:
        if mish is None:
            raise ValueError("the mish epilogue needs its table (mish_table)")
        table, lo = mish
        r = torch.round(vf)
        j = r - float(lo)
        zpf = float(int(out_zp))
        code = torch.clamp(r + zpf, 0.0, 255.0)
        if table.numel():
            idx = torch.clamp(j, 0, table.numel() - 1).to(torch.int64)
            code = torch.where(j < table.numel(), table.to(vf.device)[idx].to(torch.float32), code)
        code = torch.where(j < 0, torch.full_like(code, zpf), code)
        return (code - 128.0).to(torch.int8) if out_i8 else code.to(torch.uint8)
    if act == ACT_LEAKY:
        if exact_leaky:
            v1 = torch.round(vf)
            v = torch.where(v1 < 0, torch.round(v1 * _TENTH), v1)
        else:
            v = torch.round(torch.where(vf < 0, vf * _TENTH, vf))
    elif act in (ACT_RELU, ACT_RELU6, ACT_LINEAR):
        v = torch.round(vf)
    else:
        raise ValueError(f"unsupported quantized activation code {act}")
    relu_like = act in (ACT_RELU, ACT_RELU6)
    zp = int(out_zp)
    if out_i8:
        zps = float(zp - 128)
        lo = max(zps, -128.0) if relu_like else -128.0
        return torch.clamp(v + zps, lo, 127.0).to(torch.int8)
    zpf = float(zp)
    lo = max(zpf, 0.0) if relu_like else 0.0
    return torch.clamp(v + zpf, lo, 255.0).to(torch.uint8)


def quantized_conv2d(
    x_u8: torch.Tensor,
    w_i8: torch.Tensor,
    bias_i32: torch.Tensor,
    m: torch.Tensor,
    x_zp_i32,
    w_zp_i32: torch.Tensor | None,
    out_zp,
    *,
    stride: int = 1,
    pad: int = 0,
    act: int = ACT_LINEAR,
    symmetric: bool = False,
    out_i8: bool = False,
    carrier: str = "int8",
    exact_leaky: bool = False,
    mish: tuple | None = None,
) -> torch.Tensor:
    """Full integer conv layer: uint8 (or shifted int8) in -> uint8 out
    (shifted int8 with ``out_i8``)."""
    x_i8 = x_u8 if x_u8.dtype == torch.int8 else u8_to_i8(x_u8)
    acc = conv_acc_int32(
        x_i8, w_i8, x_zp_i32, w_zp_i32, stride, pad, symmetric, carrier=carrier
    )
    return requant_activate(
        acc, bias_i32, m, out_zp, act, out_i8=out_i8, exact_leaky=exact_leaky, mish=mish
    )


def quantized_conv2d_pool(
    x_u8: torch.Tensor,
    w_i8: torch.Tensor,
    bias_i32: torch.Tensor,
    m: torch.Tensor,
    x_zp_i32,
    out_zp,
    *,
    pad: int = 0,
    act: int = ACT_LINEAR,
    out_i8: bool = False,
    w_zp_i32: torch.Tensor | None = None,
    carrier: str = "int8",
    exact_leaky: bool = False,
) -> torch.Tensor:
    """Stride-1 conv then the darknet 2x2/s2 maxpool: the plain version of
    the kernel's ``fuse_pool``.  ``w_zp_i32`` None means symmetric weights."""
    y = quantized_conv2d(
        x_u8, w_i8, bias_i32, m, x_zp_i32, w_zp_i32, out_zp,
        stride=1, pad=pad, act=act, symmetric=w_zp_i32 is None, out_i8=out_i8,
        carrier=carrier, exact_leaky=exact_leaky,
    )
    return maxpool_u8(y, 2, 2, 1)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C) -> (N,H/2,W/2,4C), slot (qy*2+qx)*C + c holding pixel
    (2i+qy, 2j+qx): the layout of ``infer/convert.py::_s2d_weights``."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth needs even H and W, got {h}x{w}")
    xs = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return xs.reshape(n, h // 2, w // 2, 4 * c)


def s2d_conv_phase_max(
    xs_i8: torch.Tensor,
    w_s2d: torch.Tensor,
    bias_i32: torch.Tensor,
    m: torch.Tensor,
    x_zp_i32,
    out_zp,
    *,
    act: int = ACT_LINEAR,
    exact_leaky: bool = False,
) -> torch.Tensor:
    """The s2d stem stage: a 3x3/s1 conv over the space-to-depth input
    ``xs_i8`` (N,H2,W2,4C) with the block kernel ``w_s2d`` (3,3,4C,4O), its
    blocks padded by 1 with the input zero point, then the max over the 4
    output-phase groups on the int32 accumulators, then the epilogue.
    Returns shifted int8 (N,H2,W2,O): conv -> requant -> 2x2/s2 maxpool of
    the original graph, bit for bit (the epilogue is monotone in acc)."""
    acc = conv_acc_int32(xs_i8, w_s2d, x_zp_i32, None, 1, 1, symmetric=True)
    o = acc.shape[-1] // 4
    accm = torch.maximum(
        torch.maximum(acc[..., :o], acc[..., o : 2 * o]),
        torch.maximum(acc[..., 2 * o : 3 * o], acc[..., 3 * o :]),
    )
    return requant_activate(accm, bias_i32, m, out_zp, act, out_i8=True,
                            exact_leaky=exact_leaky)


def fold_static_bias(bias_f, s_in, s_w, x_zp_i32, w_zp_i32, w_i8):
    """Fold the float bias and static zero-point terms into one int32 bias.

    bias_i32[o] = round(bias_f[o] / (S1*S2[o])) - zx*wsum[o] + K*zx*zw[o],
    all zero points int8-shifted.  Numpy, conversion-time.
    """
    bias_f = np.asarray(bias_f, np.float64)
    w_i8 = np.asarray(w_i8)
    k = w_i8.shape[0] * w_i8.shape[1] * w_i8.shape[2]
    wsum = w_i8.astype(np.int64).sum(axis=(0, 1, 2))
    x_zp = np.int64(np.asarray(x_zp_i32))
    w_zp = np.asarray(w_zp_i32, np.int64)
    static = -x_zp * wsum + k * x_zp * w_zp
    return (
        np.round(bias_f / (np.asarray(s_in, np.float64) * np.asarray(s_w, np.float64)))
        + static
    ).astype(np.int32)
