"""QAT checkpoint -> integer program conversion (host-side numpy).

Turns float params + learned quantization ranges into the integer program
the engine runs, exactly as ``yolo_quantization_tpu/infer/convert.py`` does:

  per quantized conv:  fold BN (rolling stats) into weights/bias
                       per-channel weight quantization (symmetric by default)
                       inherit the input scale from the producing layer
                       fold the float bias and static zero-point terms into
                       one int32 bias
                       requant multiplier M = S1*S2/S3 as f32 and as the
                       gemmlowp (M0, shift) pair
                       mish: the epilogue's table on the rounded
                       pre-activation (``ops/qconv.py::mish_table``), in
                       ``mish_table`` and ``mish_lo``
  maxpool/upsample:    output scale := input scale
  route:               multi-input concat re-quantizes each branch onto the
                       learned common grid
  shortcut:            float-domain add, re-quantized to a learned range

The params may be any mapping of numpy-convertible arrays (``init_params_numpy``
or a checkpoint turned into numpy); the resulting arrays equal the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from yolo_quantization_tpu_torch.core.quant import QUANT_MAX, QUANT_MIN, quantize_multiplier
from yolo_quantization_tpu_torch.nn.graph import (
    SIMPLE_SPECS,
    ConvSpec,
    MaxPoolSpec,
    NetworkDef,
    RouteSpec,
    ShortcutSpec,
    UpsampleSpec,
    YoloSpec,
)
from yolo_quantization_tpu_torch.ops.qconv import CONV_ACTIVATION_BY_NAME, fold_static_bias, mish_table

BN_EPS = 1e-6  # darknet adds eps to sqrt(var)


def _s2d_weights(w_i8: np.ndarray) -> np.ndarray:
    """Space-to-depth rewrite of a 3x3/stride-1/pad-1 conv kernel.

    x(H,W,C) becomes xs(H/2,W/2,4C) with slot (qy,qx,c); the original conv's
    output at (2i+py, 2j+px, o) is a 3x3 conv over blocks whose (3,3,4C,4O)
    kernel holds the original taps scattered by phase.  Output slot layout:
    (py,px,o) -> (py*2+px)*O + o, so a following 2x2/s2 maxpool is a max over
    the 4 phase groups.
    """
    kh, kw, c, o = w_i8.shape
    assert (kh, kw) == (3, 3)
    w2 = np.zeros((3, 3, 4 * c, 4 * o), np.int8)
    for py in (0, 1):
        for px in (0, 1):
            for u in (-1, 0, 1):
                qy, ay = (py + u) % 2, (py + u) // 2
                for v in (-1, 0, 1):
                    qx, ax = (px + v) % 2, (px + v) // 2
                    w2[
                        ay + 1, ax + 1,
                        (qy * 2 + qx) * c : (qy * 2 + qx + 1) * c,
                        (py * 2 + px) * o : (py * 2 + px + 1) * o,
                    ] = w_i8[u + 1, v + 1]
    return w2


def _nudge_np(lo: float, hi: float) -> tuple[float, int]:
    """Float range -> (scale, zero_point) with an exactly representable 0."""
    lo, hi = min(lo, 0.0), max(hi, 0.0)
    rng = hi - lo
    scale = (rng if rng > 0 else 1.0) / (QUANT_MAX - QUANT_MIN)
    zp = int(np.clip(np.round(-lo / scale), QUANT_MIN, QUANT_MAX))
    return float(scale), zp


@dataclass
class QuantizedLayerCfg:
    """Static (non-array) config for one layer of the integer program."""

    kind: str  # qconv | maxpool | upsample | route | shortcut | yolo | ...
    spec: Any
    out_scale: float
    out_zp: int
    # qconv extras
    act: int = 0
    quant_stop: bool = False
    symmetric_w: bool = False  # all weight zero-points == 128 (0 shifted)
    s2d_pool: bool = False     # arrays carry w_s2d (space-to-depth conv+pool)
    # route extras: per-branch (identity, ratio, zp_in) — ratio = s_in/s_out
    branches: tuple = ()
    # shortcut / float-boundary extras
    in_scales: tuple = ()


@dataclass
class IntProgram:
    """A fully-converted integer inference graph: static per-layer ``cfg``
    plus per-layer numpy ``arrays`` (weights, biases, multipliers)."""

    net: NetworkDef
    cfg: list[QuantizedLayerCfg]
    arrays: dict[int, dict[str, np.ndarray]]
    in_scale: float
    in_zp: int
    meta: dict = field(default_factory=dict)


def convert(
    net: NetworkDef, params, quant_state, *, symmetric_weights: bool = True,
    route_rescale: bool = True,
) -> IntProgram:
    """Build the integer program from float params + learned ranges.

    ``symmetric_weights=True`` quantizes weights symmetrically per channel
    (scale = max|w|/127, zero point 128 in uint8 codes, 0 once shifted), so
    the conv needs no data-dependent zero-point cross term.
    ``symmetric_weights=False`` reproduces the darknet reference's
    asymmetric per-channel weights.  ``route_rescale=False`` reproduces the
    reference's raw-byte concat across mismatched branch scales.
    """
    params = {k: {n: np.asarray(v) for n, v in p.items()} for k, p in params.items()}
    qs = {k: {n: float(v) for n, v in st.items()} for k, st in quant_state.items()}

    in_scale, in_zp = _nudge_np(qs["input"]["min"], qs["input"]["max"])
    domains = net.output_domains()
    shapes = net.shapes()
    referenced = set()  # layer outputs consumed by non-sequential consumers
    for s in net.specs:
        if isinstance(s, RouteSpec):
            referenced.update(s.layers)
        elif isinstance(s, ShortcutSpec):
            referenced.add(s.index)
    out_qp: list[tuple[float, int] | None] = []  # (scale, zp) of u8 outputs
    cfg: list[QuantizedLayerCfg] = []
    arrays: dict[int, dict[str, np.ndarray]] = {}

    cur_qp: tuple[float, int] | None = (in_scale, in_zp)
    for i, s in enumerate(net.specs):
        in_domain = domains[i - 1] if i > 0 else "u8"
        if isinstance(s, ConvSpec) and not s.quantized:
            # float conv: fold BN into f32 weights
            p = params[i]
            w = p["w"].astype(np.float64)
            if s.batch_normalize:
                inv = p["gamma"] / (np.sqrt(p["var"]) + BN_EPS)
                w = w * inv.reshape(1, 1, 1, -1)
                bias = p["bias"] - p["mean"] * inv
            else:
                bias = p["bias"].astype(np.float64)
            arrays[i] = {"w_f32": w.astype(np.float32), "bias_f32": bias.astype(np.float32)}
            cfg.append(
                QuantizedLayerCfg(
                    kind="fconv", spec=s, out_scale=0.0, out_zp=0,
                    in_scales=((cur_qp if in_domain == "u8" else None),),
                )
            )
            cur_qp = None
            out_qp.append(None)
            continue

        if isinstance(s, ConvSpec):
            p = params[i]
            w = p["w"].astype(np.float64)  # HWIO
            if s.batch_normalize:
                inv = p["gamma"] / (np.sqrt(p["var"]) + BN_EPS)
                w = w * inv.reshape(1, 1, 1, -1)
                bias = p["bias"] - p["mean"] * inv
            else:
                bias = p["bias"].astype(np.float64)

            if symmetric_weights:
                absmax = np.abs(w).max(axis=(0, 1, 2))
                s_w = np.where(absmax > 0, absmax, 1.0) / 127.0
                zp_w = np.full(w.shape[-1], 128, np.int64)
                w_i8 = np.clip(
                    np.round(w / s_w.reshape(1, 1, 1, -1)), -127, 127
                ).astype(np.int8)
            else:
                w_min = np.minimum(w.min(axis=(0, 1, 2)), 0.0)
                w_max = np.maximum(w.max(axis=(0, 1, 2)), 0.0)
                rngs = np.where(w_max - w_min > 0, w_max - w_min, 1.0)
                s_w = rngs / (QUANT_MAX - QUANT_MIN)
                zp_w = np.clip(np.round(-w_min / s_w), QUANT_MIN, QUANT_MAX).astype(np.int64)
                w_u8 = np.clip(
                    np.round(w / s_w.reshape(1, 1, 1, -1)) + zp_w.reshape(1, 1, 1, -1),
                    QUANT_MIN,
                    QUANT_MAX,
                ).astype(np.int64)
                w_i8 = (w_u8 - 128).astype(np.int8)

            qin = None
            if in_domain == "f32":
                key = f"in_{i}"
                if key not in qs:
                    raise ValueError(
                        f"layer {i}: quantized conv after a float layer needs "
                        f"a tracked input range ({key}) — run QAT calibration"
                    )
                qin = _nudge_np(qs[key]["min"], qs[key]["max"])
                cur_qp = qin
            s_in, zp_in = cur_qp
            so, zo = _nudge_np(qs[f"act_{i}"]["min"], qs[f"act_{i}"]["max"])

            # static zero-point folds, in the int8-shifted domain
            x_zp_s = zp_in - 128
            w_zp_s = zp_w - 128
            bias_i32 = fold_static_bias(bias, s_in, s_w, x_zp_s, w_zp_s, w_i8)

            m = (s_in * s_w / so).astype(np.float64)
            m0, shift = quantize_multiplier(m)

            arrays[i] = {
                "w_i8": w_i8,
                "bias_i32": bias_i32,
                "m": m.astype(np.float32),
                "x_zp": np.int32(x_zp_s),
                "w_zp": w_zp_s.astype(np.int32),
                "out_zp": np.int32(zo),
                # serialization-parity artifacts (not used by the f32 epilogue)
                "m0": m0,
                "m_shift": shift,
                "w_scale": s_w.astype(np.float32),
                "w_zp_u8": zp_w.astype(np.uint8),
            }
            if s.activation == "mish":
                lo, table = mish_table(so, zo)
                arrays[i]["mish_table"] = table
                arrays[i]["mish_lo"] = np.int32(lo)
            if i == 0:
                # raw ingredients of the per-image (dynamic_input) rebuild
                arrays[i]["bias_f"] = bias.astype(np.float32)
                arrays[i]["wsum_i32"] = (
                    w_i8.astype(np.int64).sum(axis=(0, 1, 2)).astype(np.int32)
                )
                arrays[i]["out_scale_f"] = np.float32(so)
            in_ch = shapes[i - 1][2] if i > 0 else net.channels
            oh, ow, _ = shapes[i]
            nxt = net.specs[i + 1] if i + 1 < len(net.specs) else None
            if (
                symmetric_weights
                and not s.quant_stop
                and s.activation != "mish"  # K2 pools before the epilogue
                and s.size == 3 and s.stride == 1 and s.pad == 1
                and in_ch <= 32
                and oh % 2 == 0 and ow % 2 == 0
                and isinstance(nxt, MaxPoolSpec)
                and nxt.size == 2 and nxt.stride == 2 and nxt.padding == 1
                and i not in referenced and (i + 1) not in referenced
            ):
                arrays[i]["w_s2d"] = _s2d_weights(w_i8)
                s2d = True
            else:
                s2d = False
            cfg.append(
                QuantizedLayerCfg(
                    kind="qconv",
                    spec=s,
                    out_scale=so,
                    out_zp=zo,
                    act=CONV_ACTIVATION_BY_NAME[s.activation],
                    quant_stop=s.quant_stop,
                    symmetric_w=symmetric_weights,
                    in_scales=(qin,),
                    s2d_pool=s2d,
                )
            )
            cur_qp = None if s.quant_stop else (so, zo)

        elif isinstance(s, (MaxPoolSpec, UpsampleSpec)):
            cfg.append(
                QuantizedLayerCfg(
                    kind="maxpool" if isinstance(s, MaxPoolSpec) else "upsample",
                    spec=s,
                    out_scale=cur_qp[0] if cur_qp else 0.0,
                    out_zp=cur_qp[1] if cur_qp else 0,
                )
            )

        elif isinstance(s, RouteSpec):
            srcs = [out_qp[j] for j in s.layers]
            if domains[i] == "u8":
                if len(srcs) == 1:
                    so, zo = srcs[0]
                else:
                    so, zo = _nudge_np(qs[f"act_{i}"]["min"], qs[f"act_{i}"]["max"])
                branches = []
                for (sb, zb) in srcs:
                    ratio = sb / so
                    identity = (
                        not route_rescale
                        or (abs(ratio - 1.0) < 1e-9 and zb == zo)
                    )
                    branches.append((identity, float(ratio), int(zb)))
                cfg.append(
                    QuantizedLayerCfg(
                        kind="route", spec=s, out_scale=so, out_zp=zo,
                        branches=tuple(branches),
                    )
                )
                cur_qp = (so, zo)
            else:
                cfg.append(
                    QuantizedLayerCfg(
                        kind="route_f32", spec=s, out_scale=0.0, out_zp=0,
                        branches=tuple(srcs),
                    )
                )
                cur_qp = None

        elif isinstance(s, ShortcutSpec):
            skip_qp = out_qp[s.index]
            if domains[i] == "u8":
                so, zo = _nudge_np(qs[f"act_{i}"]["min"], qs[f"act_{i}"]["max"])
                cfg.append(
                    QuantizedLayerCfg(
                        kind="shortcut", spec=s, out_scale=so, out_zp=zo,
                        in_scales=(cur_qp, skip_qp),
                    )
                )
                cur_qp = (so, zo)
            else:
                cfg.append(
                    QuantizedLayerCfg(
                        kind="shortcut_f32", spec=s, out_scale=0.0, out_zp=0,
                        in_scales=(cur_qp, skip_qp),
                    )
                )
                cur_qp = None

        elif isinstance(s, YoloSpec):
            cfg.append(
                QuantizedLayerCfg(
                    kind="yolo", spec=s,
                    out_scale=cur_qp[0] if cur_qp else 0.0,
                    out_zp=cur_qp[1] if cur_qp else 0,
                )
            )
        elif isinstance(s, SIMPLE_SPECS):
            if i in params:
                arrays[i] = {k: v.astype(np.float32) for k, v in params[i].items()}
            cfg.append(
                QuantizedLayerCfg(
                    kind="simple", spec=s, out_scale=0.0, out_zp=0,
                    in_scales=((cur_qp if in_domain == "u8" else None),),
                )
            )
            cur_qp = None
        else:
            raise TypeError(f"unknown spec {s}")

        out_qp.append(cur_qp)

    return IntProgram(
        net=net, cfg=cfg, arrays=arrays, in_scale=in_scale, in_zp=in_zp
    )
