"""uint8 affine-quantization math: the tensor ops of QAT and the host-side
conversion helpers.

The counterpart of ``yolo_quantization_tpu/core/quant.py`` (the Jacob et al.
scheme of the darknet reference):

  real = scale * (quant - zero_point),   quant in [0, 255]

  - ``nudge_min_max``: a float range -> (scale, zero_point) with an exactly
    representable 0;
  - ``quantize`` / ``dequantize``;
  - the four fake-quant ops, each a ``torch.autograd.Function`` with the
    reference's straight-through masks: gated for the min/max ranges, plain
    for the symmetric weight scheme, and the learned-range form whose
    clamped elements feed d/dmin and d/dmax;
  - ``ema_update`` (EMA range tracking with the "fresh" warm start);
  - ``requantize_float`` and the gemmlowp multiplier encoding.

The fake-quant forwards and ``ema_update`` run inside profiler ranges
("fake_quant", "ema_update"), which ``tools/profile_train.py`` reads.
Every rounding sits where the reference puts it (``torch.round`` rounds half
to even, as ``jnp.round``).  Divisions by a constant divide by a tensor on
the operand's device: CUDA turns a division by a host scalar into a multiply
by its reciprocal, which can differ by an ulp.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

QUANT_MIN = 0
QUANT_MAX = 255
EMA_DECAY = 0.999


class QuantParams(NamedTuple):
    """``scale`` float32 and ``zero_point`` int32 tensors, scalar (per
    tensor) or (C,) (per channel)."""

    scale: torch.Tensor
    zero_point: torch.Tensor

    @property
    def per_channel(self) -> bool:
        return self.scale.ndim > 0 and self.scale.shape[0] > 1


def _const(x: torch.Tensor, v: float) -> torch.Tensor:
    """float32(v) as a 0-d tensor on x's device."""
    return torch.tensor(float(np.float32(v)), dtype=torch.float32, device=x.device)


def nudge_min_max(min_val: torch.Tensor, max_val: torch.Tensor) -> QuantParams:
    """The range widened to hold 0, scale = (max - min)/255 (1/255 for an
    empty range), zero point round(-min/scale) clamped to [0, 255]."""
    min_val = torch.minimum(min_val.to(torch.float32), _const(min_val, 0.0))
    max_val = torch.maximum(max_val.to(torch.float32), _const(max_val, 0.0))
    rng = max_val - min_val
    scale = torch.where(rng > 0, rng, _const(rng, 1.0)) / _const(rng, QUANT_MAX - QUANT_MIN)
    initial_zp = QUANT_MIN - min_val / scale
    zero_point = torch.clamp(torch.round(initial_zp), QUANT_MIN, QUANT_MAX).to(torch.int32)
    return QuantParams(scale=scale, zero_point=zero_point)


def _broadcast(qp: QuantParams, ndim: int, channel_axis: int | None):
    scale, zp = qp.scale, qp.zero_point
    if scale.ndim == 0 or channel_axis is None:
        return scale, zp
    shape = [1] * ndim
    shape[channel_axis] = scale.shape[0]
    return scale.reshape(shape), zp.reshape(shape)


def quantize(x: torch.Tensor, qp: QuantParams, channel_axis: int | None = None) -> torch.Tensor:
    """Real -> uint8 codes: clamp(round(x/S) + Z, 0, 255)."""
    scale, zp = _broadcast(qp, x.ndim, channel_axis)
    q = torch.round(x / scale) + zp
    return torch.clamp(q, QUANT_MIN, QUANT_MAX).to(torch.uint8)


def dequantize(q: torch.Tensor, qp: QuantParams, channel_axis: int | None = None) -> torch.Tensor:
    """uint8 codes -> reals: (q - Z) * S."""
    scale, zp = _broadcast(qp, q.ndim, channel_axis)
    return (q.to(torch.int32) - zp).to(torch.float32) * scale


def _nudged_grid(x, min_val, max_val):
    """(out, nudged_min, nudged_max): x clamped to the nudged range and
    snapped to its 256-level grid."""
    qp = nudge_min_max(min_val, max_val)
    nudged_min = (QUANT_MIN - qp.zero_point).to(torch.float32) * qp.scale
    nudged_max = (QUANT_MAX - qp.zero_point).to(torch.float32) * qp.scale
    clamped = torch.minimum(torch.maximum(x, nudged_min), nudged_max)
    q = torch.round((clamped - nudged_min) / qp.scale)
    return q * qp.scale + nudged_min, nudged_min, nudged_max


class _FakeQuant(torch.autograd.Function):
    """Gated straight-through estimator: the gradient passes where x lies
    inside the nudged range, and none reaches min or max."""

    @staticmethod
    def forward(ctx, x, min_val, max_val):
        with record_function("fake_quant"):
            out, lo, hi = _nudged_grid(x, min_val, max_val)
            ctx.save_for_backward((x >= lo) & (x <= hi))
        return out

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        return torch.where(mask, g, torch.zeros_like(g)), None, None


def fake_quant(x: torch.Tensor, min_val: torch.Tensor, max_val: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize x through the nudged uint8 grid of [min, max]."""
    return _FakeQuant.apply(x, min_val, max_val)


def fake_quant_per_channel(x: torch.Tensor, min_val: torch.Tensor, max_val: torch.Tensor) -> torch.Tensor:
    """Per-channel fake-quant over the LAST axis (HWIO conv weights, per
    output channel); min/max have shape (C,)."""
    return _FakeQuant.apply(x, min_val, max_val)


class _FakeQuantSymmetric(torch.autograd.Function):
    """scale = max|x|/127 per last-axis channel; plain straight-through
    gradient (the clamp at +-max|x| never bites)."""

    @staticmethod
    def forward(ctx, x):
        with record_function("fake_quant"):
            absmax = torch.amax(torch.abs(x), dim=tuple(range(x.ndim - 1)))
            scale = torch.where(absmax > 0, absmax, _const(absmax, 1.0)) / _const(absmax, 127.0)
            q = torch.clamp(torch.round(x / scale), -127, 127)
            return q * scale

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant_symmetric_per_channel(x: torch.Tensor) -> torch.Tensor:
    """Symmetric per-channel (last axis) weight fake-quant, the QAT twin of
    ``convert(symmetric_weights=True)``."""
    return _FakeQuantSymmetric.apply(x)


class _FakeQuantLearned(torch.autograd.Function):
    """The forward of ``fake_quant``; the gradient passes to x inside the
    range, and the gradients landing below / above it sum into d/dmin and
    d/dmax (TF's FakeQuantWithMinMaxVarsGradient)."""

    @staticmethod
    def forward(ctx, x, min_val, max_val):
        with record_function("fake_quant"):
            out, lo, hi = _nudged_grid(x, min_val, max_val)
            ctx.save_for_backward(x < lo, x > hi)
        ctx.range_shapes = (min_val.shape, max_val.shape)
        return out

    @staticmethod
    def backward(ctx, g):
        below, above = ctx.saved_tensors
        zero = torch.zeros_like(g)
        gx = torch.where(below | above, zero, g)
        gmin = torch.sum(torch.where(below, g, zero)).reshape(ctx.range_shapes[0])
        gmax = torch.sum(torch.where(above, g, zero)).reshape(ctx.range_shapes[1])
        return gx, gmin, gmax


def fake_quant_learned(x: torch.Tensor, min_val: torch.Tensor, max_val: torch.Tensor) -> torch.Tensor:
    """fake_quant with gradients to the (scalar) range: learnable ranges."""
    return _FakeQuantLearned.apply(x, min_val, max_val)


def ema_update(ema_min, ema_max, batch_min, batch_max, decay: float = EMA_DECAY):
    """m <- m - (m - new) * (1 - decay); a range still at (0, 0) ("unseen")
    adopts the batch statistics directly."""
    with record_function("ema_update"):
        fresh = (ema_min == 0.0) & (ema_max == 0.0)
        rate = float(np.float32(1.0 - decay))
        new_min = ema_min - (ema_min - batch_min) * rate
        new_max = ema_max - (ema_max - batch_max) * rate
        return torch.where(fresh, batch_min, new_min), torch.where(fresh, batch_max, new_max)


def quantize_multiplier(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Encode real multipliers M > 0 as (M0 int32, right_shift).

    M ~= M0 * 2^-31 * 2^-right_shift with M0 in [2^30, 2^31); M >= 1 gets a
    negative right_shift (a left shift).
    """
    m = np.asarray(m, dtype=np.float64)
    if np.any(m <= 0.0):
        raise ValueError(f"multipliers must be > 0; got min {m.min()}")
    mant, exp = np.frexp(m)  # m = mant * 2**exp, mant in [0.5, 1)
    shift = (-exp).astype(np.int32)
    q = np.round(mant * (1 << 31)).astype(np.int64)
    overflow = q == (1 << 31)
    q = np.where(overflow, q >> 1, q)
    shift = np.where(overflow, shift - 1, shift).astype(np.int32)
    return q.astype(np.int32), shift


def multiplier_from_fixed(m0: np.ndarray, right_shift: np.ndarray) -> np.ndarray:
    """Decode (M0, shift) back to the real multiplier (float64)."""
    return np.asarray(m0, np.float64) * 2.0**-31 * 2.0 ** -np.asarray(right_shift, np.float64)


def requantize_float(acc: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """int32 accumulators onto the output grid: round(acc * M) in float32."""
    return torch.round(acc.to(torch.float32) * m)


def requantize_fixed_np(acc: np.ndarray, m0: np.ndarray, shift: np.ndarray) -> np.ndarray:
    """Bit-exact gemmlowp requantization (numpy spec): a saturating rounding
    doubling high multiply by M0 (C++ truncation toward zero), then a
    rounding right shift (a left shift for a negative shift)."""
    acc = np.asarray(acc, dtype=np.int64)
    m0 = np.asarray(m0, dtype=np.int64)
    shift = np.asarray(shift, dtype=np.int64)
    prod = acc * m0  # fits in int64: |acc| < 2^31, m0 < 2^31
    nudge = np.where(prod >= 0, 1 << 30, 1 - (1 << 30))
    summed = prod + nudge
    high = np.sign(summed) * (np.abs(summed) >> 31)
    left = np.maximum(-shift, 0)
    rs = np.maximum(shift, 0)
    high = high << left
    mask = (np.int64(1) << rs) - 1
    remainder = high & mask
    threshold = (mask >> 1) + np.where(high < 0, 1, 0)
    out = (high >> rs) + np.where(remainder > threshold, 1, 0)
    return out.astype(np.int32)
