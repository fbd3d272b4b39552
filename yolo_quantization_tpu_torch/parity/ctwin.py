"""C-twin: a numpy forward bit-exact to the compiled reference binary.

The counterpart of ``yolo_quantization_tpu/parity/ctwin.py``, over the
port's specs (``nn/graph.py``) and ``models/darknet_weights.py::
DarknetCheckpoint``.  It is an oracle of a CPU binary: numpy on the host,
used by ``tools/parity_check.py`` and ``tools/crossf1.py``, never by a path
that serves.

The reference's uint8 inference path does NOT use true fixed-point
requantization: it truncates through C doubles and narrows to uint8 before
a no-op clamp.  This module transcribes that arithmetic exactly so that,
given the same cfg + .weights file and the same letterboxed input, the
per-layer uint8 outputs match the compiled reference byte for byte.

Transcribed semantics (reference file:line):
  - dynamic per-image input quantization, min/max seeded at 0, float32
    nudge, round-half-away-from-zero      (src/blas.c:108-168 via :259-281)
  - BN fold into float biases at load     (src/blas.c:582-601)
  - requant constants: M in float32, gemmlowp (M0, shift) from a float32
    doubling loop, M_value = 2^-31*M0 and 2^-shift as doubles
                                          (src/blas.c:387-418, :306-334)
  - biases_int32 via float32 division + int->float32 add, truncated
                                          (src/blas.c:331-334)
  - conv: zero-point-padded im2col, uint8 GEMM minus weight-zero-point-plane
    GEMM, each accumulated through a float32 accumulator rounded on every k
    step, epilogue (acc+bias)*M_value truncated to int64, *2^-shift
    truncated to int32, activation in codes, uint8 narrowing BEFORE the
    (no-op) clamp -- i.e. wrap mod 256, not saturate
                                          (src/convolutional_layer.c:694-761,
                                           src/im2col.c:26-50, src/gemm.c:279-299)
  - maxpool: uint8 max seeded at 0, window offset -pad/2 (C int division)
                                          (src/maxpool_layer.c:109-172)
  - route: raw byte concat, NO rescaling across branches
                                          (src/route_layer.c:107-130)
  - upsample: nearest repeat of codes     (src/upsample_layer.c:96-113)
  - input scale inheritance: conv i takes layers[i-1]'s stored activ scale;
    single-input routes take their source's scale at load
                                          (src/blas.c:301-305, src/parser.c:1176-1183)
  - yolo decode + letterbox inverse       (src/yolo_layer.c:83-91,132-146,247-343)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from yolo_quantization_tpu_torch.models.darknet_weights import DarknetCheckpoint
from yolo_quantization_tpu_torch.nn.graph import (
    ConvSpec,
    MaxPoolSpec,
    NetworkDef,
    RouteSpec,
    UpsampleSpec,
    YoloSpec,
)

F32 = np.float32
F64 = np.float64


def _c_round(x):
    """C round(): half away from zero (numpy's and torch's round half to even)."""
    x = np.asarray(x, F64)
    return np.sign(x) * np.floor(np.abs(x) + 0.5)


def dynamic_input_qp(x: np.ndarray) -> tuple[np.float32, int]:
    """Per-image input (scale, zero_point), float32-exact to the reference.

    quant_weights_with_min_max_channel with size_channel=1 (src/blas.c:108-150):
    min/max seeded at 0, scale = (max-min)/255 in float32, zp = the nudge of
    -min/scale rounded half-away and clamped to [0,255].
    """
    x = np.asarray(x, F32)
    mx = F32(max(float(x.max()), 0.0))
    mn = F32(min(float(x.min()), 0.0))
    scale = F32((mx - mn) / F32(255.0))
    izp = F64(F32(F32(0.0) - F32(mn / scale)))  # float32 ops, widened to double
    if izp < 0:
        zp = 0
    elif izp > 255:
        zp = 255
    else:
        zp = int(_c_round(izp))
    return scale, zp


def quantize_input_c(x: np.ndarray, scale: np.float32, zp: int) -> np.ndarray:
    """uint8 codes of the input, C-exact (src/blas.c:152-158).

    temp = round(x / scale) + zp computed through float32, then int clamp.
    """
    x = np.asarray(x, F32)
    t = _c_round(F64(1) * (x / scale)) + zp  # x/scale is f32; round in f64 exact
    return np.clip(t, 0, 255).astype(np.uint8)


def quant_multiplier_c(m_f32: np.float32) -> tuple[int, int]:
    """gemmlowp (M0, right_shift) from a float32 doubling loop (src/blas.c:387-418)."""
    m = F32(m_f32)
    if not F32(0.0) < m < F32(1.0):
        raise ValueError(f"the reference asserts 0 < real_multiplier < 1, got {m}")
    s = 0
    while m < F32(0.5):
        m = F32(m * F32(2.0))
        s += 1
    # C: round(real_multiplier * (1ll << 31)): the int64 is converted to
    # FLOAT by the usual arithmetic conversions, so the product is computed
    # in float32 (24-bit mantissa), not double
    q = int(_c_round(F64(F32(m * F32(2147483648.0)))))
    if q == 1 << 31:
        q //= 2
        s -= 1
    if s < 0:
        raise ValueError(f"the reference asserts right_shift >= 0, got {s}")
    return q, s


def _fold_bias_c(bias, gamma, mean, var) -> np.ndarray:
    """batch_normalize_bias (src/blas.c:594-601): float32 gamma*mean divided by
    double sqrt(var)+1e-6f, subtracted in double, stored back to float32."""
    num = (np.asarray(gamma, F32) * np.asarray(mean, F32)).astype(F64)
    den = np.sqrt(np.asarray(var, F64)) + F64(F32(1e-6))
    return (np.asarray(bias, F64) - num / den).astype(F32)


def _im2col_u8(x: np.ndarray, ks: int, stride: int, pad: int, zp: int) -> np.ndarray:
    """(C*ks*ks, oh*ow) patch matrix, out-of-range pixels = input zero point
    (src/im2col.c:26-50)."""
    c, h, w = x.shape
    oh = (h + 2 * pad - ks) // stride + 1
    ow = (w + 2 * pad - ks) // stride + 1
    xp = np.full((c, h + 2 * pad, w + 2 * pad), zp, np.uint8)
    xp[:, pad : pad + h, pad : pad + w] = x
    cols = np.empty((c, ks, ks, oh, ow), np.uint8)
    for kh in range(ks):
        for kw in range(ks):
            cols[:, kh, kw] = xp[:, kh : kh + oh * stride : stride, kw : kw + ow * stride : stride]
    return cols.reshape(c * ks * ks, oh * ow)


def _maxpool_u8_c(x: np.ndarray, size: int, stride: int, pad: int) -> np.ndarray:
    """uint8 maxpool, max seeded at 0 and invalid pixels effectively 0
    (src/maxpool_layer.c:109-152).  Window offset is -pad/2 with C integer
    division (truncation toward zero)."""
    c, h, w = x.shape
    oh = (h + pad - size) // stride + 1
    ow = (w + pad - size) // stride + 1
    off = -(pad // 2)  # C: -l.pad/2, pad >= 0
    # pad with zeros so that out-of-range lookups return 0 (the seed value)
    lo = -off
    hi_h = off + (oh - 1) * stride + size
    hi_w = off + (ow - 1) * stride + size
    xp = np.zeros((c, lo + max(hi_h, h), lo + max(hi_w, w)), np.uint8)
    xp[:, lo : lo + h, lo : lo + w] = x
    out = np.zeros((c, oh, ow), np.uint8)
    for n in range(size):
        for m in range(size):
            sl = xp[:, lo + off + n : lo + off + n + oh * stride : stride,
                    lo + off + m : lo + off + m + ow * stride : stride]
            out = np.maximum(out, sl)
    return out


def _gemm_u8_f32acc(a, b, alpha: float, c: np.ndarray) -> np.ndarray:
    """C += alpha*A*B with per-step float32 accumulator round-trips,
    transcribing gemm_nn_uint8_int32_te (src/gemm.c:279-299): the int32
    accumulator is converted to float32, added in float32, and truncated
    back toward zero on every k step, in ascending-k order.

    That rounding is the semantics: the loop is not reordered, blocked or
    vectorised over k.  The accumulator stays a float32 array between steps
    (a truncated float32 is an integer float32 holds exactly, so the
    int -> float32 conversion of the next step is the identity)."""
    af = np.asarray(a, F32) * F32(alpha)
    bf = np.asarray(b, F32)
    acc = np.asarray(c).astype(F32)
    prod = np.empty_like(acc)
    for k in range(af.shape[1]):
        np.multiply(af[:, k : k + 1], bf[k][None, :], out=prod)  # exact: |a*b| <= 65025
        acc += prod                                              # f32 add, rounds
        np.trunc(acc, out=acc)                                   # trunc toward zero
    return acc.astype(np.int64)


def yolo_activations(s: YoloSpec, x_f32: np.ndarray, h: int, w: int) -> np.ndarray:
    """forward_yolo_layer's CPU entry activations (src/yolo_layer.c:132-146):
    logistic of x, y, objectness and the classes of a (na*(5+classes), h, w)
    head, as (na, 5+classes, h, w) float32."""
    na = len(s.mask)
    y = x_f32.reshape(na, 4 + 1 + s.classes, h, w).astype(F32).copy()

    def logi(v):
        return (1.0 / (1.0 + np.exp(-v.astype(F64)))).astype(F32)

    y[:, 0:2] = logi(y[:, 0:2])
    y[:, 4:] = logi(y[:, 4:])
    return y


@dataclass
class TwinLayer:
    kind: str
    u8: np.ndarray | None = None   # output_uint8_final, CHW flat order
    f32: np.ndarray | None = None  # float output (quant_stop / yolo)
    act_scale: np.float32 = F32(0)
    act_zp: int = 0
    shape: tuple[int, int, int] = (0, 0, 0)  # (c, h, w)


@dataclass
class TwinResult:
    input_u8: np.ndarray
    in_scale: np.float32
    in_zp: int
    layers: list[TwinLayer] = field(default_factory=list)
    # convs that took the step-wise float32 GEMM (a partial reached 2^24)
    stepwise_convs: list[int] = field(default_factory=list)


class CTwin:
    """Bit-exact numpy replica of the reference uint8 inference engine."""

    def __init__(self, net: NetworkDef, ckpt: DarknetCheckpoint):
        self.net = net
        self.ckpt = ckpt
        self.shapes = net.shapes()  # (h, w, c) per layer

    # --- stored activ scale/zp per layer, as the C parser materializes them
    def _stored_act(self) -> list[tuple[np.float32, int]]:
        out: list[tuple[np.float32, int]] = []
        raw = self.ckpt.raw_quant
        for i, s in enumerate(self.net.specs):
            if isinstance(s, (ConvSpec, MaxPoolSpec, UpsampleSpec)) and i in raw:
                out.append((F32(raw[i]["activ_scale"]), int(raw[i]["activ_zp"])))
            elif isinstance(s, RouteSpec):
                if i in raw:  # multi-input: stored (src/parser.c:1176-1183)
                    out.append((F32(raw[i]["activ_scale"]), int(raw[i]["activ_zp"])))
                else:  # single input inherits its source's scale at load
                    out.append(out[s.layers[0]])
            else:
                out.append((F32(0), 0))
        return out

    def forward(self, sized_chw: np.ndarray, thresh: float = 0.25) -> TwinResult:
        """Run the quantized forward on a letterboxed float32 CHW image."""
        del thresh  # the layers' outputs do not depend on it (yolo_detections_c does)
        net, raw = self.net, self.ckpt.raw_quant
        x_f32 = np.asarray(sized_chw, F32)
        in_scale, in_zp = dynamic_input_qp(x_f32)
        input_u8 = quantize_input_c(x_f32, in_scale, in_zp)
        res = TwinResult(input_u8=input_u8, in_scale=in_scale, in_zp=in_zp)
        act = self._stored_act()

        cur_u8: np.ndarray | None = input_u8  # CHW
        cur_f32: np.ndarray | None = None
        in_shape = (net.channels, net.height, net.width)
        for i, s in enumerate(net.specs):
            oh, ow, oc = self.shapes[i]
            tl = TwinLayer(kind=type(s).__name__, shape=(oc, oh, ow))
            if isinstance(s, ConvSpec):
                if not s.quantized:
                    raise NotImplementedError("twin covers the quantized path only")
                r = raw[i]
                s1, z1 = (in_scale, in_zp) if i == 0 else act[i - 1]
                s3, z3 = act[i]
                tl.act_scale, tl.act_zp = s3, z3
                u8, f32v, stepwise = self._conv(s, r, cur_u8, in_shape, s1, z1, s3, z3, i)
                if stepwise:
                    res.stepwise_convs.append(i)
                tl.u8, tl.f32 = u8, f32v
                cur_u8, cur_f32 = u8, f32v
            elif isinstance(s, MaxPoolSpec):
                y = _maxpool_u8_c(cur_u8, s.size, s.stride, s.padding)
                tl.u8 = y
                tl.act_scale, tl.act_zp = act[i]
                cur_u8, cur_f32 = y, None
            elif isinstance(s, UpsampleSpec):
                y = np.repeat(np.repeat(cur_u8, s.stride, axis=1), s.stride, axis=2)
                tl.u8 = y
                tl.act_scale, tl.act_zp = act[i]
                cur_u8, cur_f32 = y, None
            elif isinstance(s, RouteSpec):
                # raw byte concat -- the reference does NOT rescale branches
                y = np.concatenate([res.layers[j].u8 for j in s.layers], axis=0)
                tl.u8 = y
                tl.act_scale, tl.act_zp = act[i]
                cur_u8, cur_f32 = y, None
            elif isinstance(s, YoloSpec):
                y = yolo_activations(s, cur_f32, oh, ow)
                tl.f32 = y
                cur_u8, cur_f32 = None, y
            else:
                raise NotImplementedError(f"twin: layer {type(s).__name__}")
            res.layers.append(tl)
            in_shape = (oc, oh, ow)
        return res

    def _conv(self, s: ConvSpec, r, x_u8, in_shape, s1, z1, s3, z3, i):
        """forward_convolutional_layer_quant_inputi_outputi, C-exact.
        Returns (u8, quant_stop floats or None, whether the step-wise
        float32 GEMM ran)."""
        c, h, w = in_shape
        n, ks = s.filters, s.size
        K = c * ks * ks
        p = self.ckpt.params[i]
        if s.batch_normalize:
            bias_f = _fold_bias_c(p["bias"], p["gamma"], p["mean"], p["var"])
        else:
            bias_f = np.asarray(p["bias"], F32)

        w_u8 = r["weights_u8"].reshape(n, K).astype(np.int64)  # OIHW flat = im2col order
        zw = r["weight_zps"].astype(np.int64)
        sw = r["weight_scales"].astype(F32)

        # preprocessing constants (src/blas.c:290-334), float32-exact
        wsum = (np.int64(K) * z1 * zw - w_u8.sum(axis=1) * z1).astype(np.int64)
        m0 = np.empty(n, np.int64)
        shift = np.empty(n, np.int64)
        for o in range(n):
            m_f32 = F32(F32(F32(s1) * sw[o]) / F32(s3))
            m0[o], shift[o] = quant_multiplier_c(m_f32)
        m_value = np.ldexp(m0.astype(F64), -31)          # pow(2,-31)*M0, exact
        m0rs_value = np.ldexp(np.ones(n, F64), -shift.astype(np.int64))
        t = bias_f.astype(F32) / (F32(s1) * sw)           # float32 division
        bias_i32 = np.trunc((t + wsum.astype(F32)).astype(F64)).astype(np.int64)

        # two uint8 GEMMs (src/gemm.c:279-299).  ALPHA is a C float, so
        # `C += ALPHA*A*B` converts the int32 accumulator to float32 every
        # step: once |acc| exceeds 2^24 the accumulation rounds.  GEMM1
        # (alpha=+1) partials are monotone nondecreasing and GEMM2 (alpha=-1)
        # monotone nonincreasing, so the exact final values bound every
        # partial: when both stay under 2^24 the float path is exact and one
        # integer product reproduces it; otherwise emulate step by step.
        # The integer product comes from a float64 matmul: u8*u8 sums stay
        # far below 2^53, so it is exact.
        col = _im2col_u8(x_u8, ks, s.stride, s.pad, z1)
        g1 = (w_u8.astype(F64) @ col.astype(F64)).astype(np.int64)  # (n, oh*ow)
        colsum = col.sum(axis=0, dtype=np.int64)
        g2 = g1 - zw[:, None] * colsum[None, :]
        stepwise = not (g1.max(initial=0) < 2**24 and np.abs(g2).max(initial=0) < 2**24)
        if stepwise:
            acc = _gemm_u8_f32acc(w_u8, col, 1.0, np.zeros_like(g1))
            acc = _gemm_u8_f32acc(
                np.broadcast_to(zw[:, None], w_u8.shape), col, -1.0, acc
            )
        else:
            acc = g2

        # epilogue: truncation through doubles (convolutional_layer.c:726-750)
        t64 = np.trunc((acc + bias_i32[:, None]).astype(F64) * m_value[:, None])
        v = np.trunc(t64 * m0rs_value[:, None]).astype(np.int64)
        a = s.activation
        if a == "leaky":
            out = np.where(v < 0, _c_round(v.astype(F64) * 0.1).astype(np.int64) + z3, v + z3)
        elif a == "relu6":
            out = np.where(v <= 0, np.int64(z3), v + z3)
        elif a in ("linear", "relu"):
            out = v + z3
        else:
            raise NotImplementedError(f"quant activation {a}")
        u8 = (out & 0xFF).astype(np.uint8)  # uint8 narrowing BEFORE the no-op clamp

        f32v = None
        if s.quant_stop:
            f32v = ((u8.astype(np.int32) - z3).astype(F32) * F32(s3))
        oh = (h + 2 * s.pad - ks) // s.stride + 1
        ow = (w + 2 * s.pad - ks) // s.stride + 1
        u8 = u8.reshape(n, oh, ow)
        if f32v is not None:
            f32v = f32v.reshape(n, oh, ow)
        return u8, f32v, stepwise


def yolo_detections_c(
    net: NetworkDef,
    yolo_outputs: list[np.ndarray],  # (na, 5+classes, h, w) float32 per head
    im_w: int,
    im_h: int,
    thresh: float,
) -> np.ndarray:
    """Replicates get_network_boxes for yolo heads: per-head raster scan,
    objectness filter, box decode, letterbox inverse (src/yolo_layer.c:316-343,
    :247-273).  Rows: [x, y, w, h, objectness, prob_0..prob_{C-1}] in the same
    order the C fills them."""
    netw, neth = net.width, net.height
    heads = [s for s in net.specs if isinstance(s, YoloSpec)]
    rows = []
    for spec, out in zip(heads, yolo_outputs):
        na, _, lh, lw = out.shape
        for i in range(lw * lh):
            row_, col_ = i // lw, i % lw
            for n in range(na):
                obj = out[n, 4, row_, col_]
                if obj <= thresh:
                    continue
                ax, ay = spec.anchors[spec.mask[n]]
                bx = F32((col_ + out[n, 0, row_, col_]) / F32(lw))
                by = F32((row_ + out[n, 1, row_, col_]) / F32(lh))
                bw = F32(np.exp(F64(out[n, 2, row_, col_])) * ax / netw)
                bh = F32(np.exp(F64(out[n, 3, row_, col_])) * ay / neth)
                probs = out[n, 5:, row_, col_] * obj
                probs = np.where(probs > thresh, probs, 0.0).astype(F32)
                rows.append([bx, by, bw, bh, obj] + probs.tolist())
    dets = np.asarray(rows, F32).reshape(-1, 5 + heads[0].classes)
    # correct_yolo_boxes, relative=1 (src/yolo_layer.c:247-273)
    if (netw / im_w) < (neth / im_h):
        new_w, new_h = netw, (im_h * netw) // im_w
    else:
        new_h, new_w = neth, (im_w * neth) // im_h
    if len(dets):
        dets[:, 0] = (dets[:, 0] - (netw - new_w) / 2.0 / netw) / (new_w / netw)
        dets[:, 1] = (dets[:, 1] - (neth - new_h) / 2.0 / neth) / (new_h / neth)
        dets[:, 2] *= netw / new_w
        dets[:, 3] *= neth / new_h
    return dets
