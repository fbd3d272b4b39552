"""The integer shortcut (residual add) in plain PyTorch: the oracle of
``csrc/shortcut.cu`` and the CPU path.

The counterpart of the integer branch of the shortcut in
``yolo_quantization_tpu/infer/engine.py::build_forward``.  Both int8
operands regrid onto the output grid with conversion-time ratios, and the
add, the activation and one rounding run as one expression:

    q_o = clamp(round(act((q_x * ra + q_k * rb) + cst)) + z_o - 128, -128, 127)

with ra = s_x / s_o, rb = s_k / s_o and cst = -(z_x - 128) ra - (z_k - 128) rb
computed in float64 on the host, then cast to float32 (``shortcut_params``).
Leaky and relu commute with the positive 1/s_o scaling; relu6's cap becomes
6/s_o.  ``round`` is half to even.

Every float32 operation rounds on its own, in the JAX engine's order, which
is what the un-jitted JAX engine computes.  (Under ``jax.jit`` XLA's CPU
backend contracts the first product and the sum into an FMA, which moves a
value near a .5 tie by one code: ``tests/test_torch_shortcut.py``.)  Each
torch operation below is its own kernel on CUDA, so nothing contracts
across them; ``torch.add(..., alpha=)`` and ``addcmul`` are single functors
that nvcc may contract, so they are not used.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY, ACT_RELU, ACT_RELU6, ACTIVATION_BY_NAME

_TENTH = float(np.float32(0.1))  # the f32 leaky slope, exactly


def _f32(v: float) -> float:
    return float(np.float32(v))


class ShortcutConsts(NamedTuple):
    """One integer shortcut's float32 constants (as exact Python floats)
    and its activation code; ``cap`` is relu6's 6/s_o, else 0."""

    ra: float
    rb: float
    cst: float
    cap: float
    act: int
    out_zp: int


def shortcut_params(qp_x, qp_k, out_scale: float, out_zp: int, activation: str) -> ShortcutConsts:
    """The constants of a shortcut whose operands have (scale, zero point)
    ``qp_x`` (the previous layer) and ``qp_k`` (the skip source), with the
    JAX engine's float64 expressions before the float32 cast."""
    if activation not in ACTIVATION_BY_NAME:
        raise ValueError(f"integer shortcut: unsupported activation {activation!r}")
    ra = qp_x[0] / out_scale
    rb = qp_k[0] / out_scale
    cst = -(qp_x[1] - 128) * ra - (qp_k[1] - 128) * rb
    act = ACTIVATION_BY_NAME[activation]
    cap = _f32(6.0 / out_scale) if act == ACT_RELU6 else 0.0
    return ShortcutConsts(_f32(ra), _f32(rb), _f32(cst), cap, act, int(out_zp))


def int_shortcut(x_i8: torch.Tensor, skip_i8: torch.Tensor, k: ShortcutConsts) -> torch.Tensor:
    """Shifted int8 codes of the shortcut's output from its two shifted int8
    operands (any device, same shape)."""
    if k.act not in ACTIVATION_BY_NAME.values():
        raise ValueError(f"unsupported shortcut activation code {k.act}")
    t = x_i8.to(torch.float32) * k.ra
    t = t + skip_i8.to(torch.float32) * k.rb
    t = t + k.cst
    if k.act == ACT_LEAKY:
        t = torch.where(t < 0, t * _TENTH, t)
    elif k.act == ACT_RELU:
        t = torch.clamp(t, min=0.0)
    elif k.act == ACT_RELU6:
        t = torch.clamp(t, 0.0, k.cap)
    return torch.clamp(torch.round(t) + float(k.out_zp - 128), -128.0, 127.0).to(torch.int8)
