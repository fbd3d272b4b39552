"""darknet .weights (de)serialization, including the quantization extension.

The counterpart of ``yolo_quantization_tpu/models/darknet_weights.py``:
binary interchange with darknet and with the JAX package, numpy on the
host.  Format (darknet's src/parser.c):

  header:  int32 major=0, minor=2, revision=0; uint64 seen   (:970-976)
  conv:    biases[n] f32
           if batch_normalize: scales[n], rolling_mean[n], rolling_var[n] f32
           quant block (when the file was written with QUANTIZATION):
             input_scale f32, input_zp u8,
             activ_scale f32, activ_zp u8,
             weight_scales[n] f32, weight_zps[n] u8,
             weights_uint8[n*c*k*k] u8                        (:898-908)
           weights[n*c*k*k] f32 in OIHW                       (:910)
  maxpool: activ_scale f32, activ_zp u8                       (:913-917)
  route:   (quantized, >1 input) activ_scale f32, activ_zp u8 (:919-923)
  upsample:(quantized) activ_scale f32, activ_zp u8           (:925-929)

Layout conversion: darknet stores conv weights OIHW; the params are HWIO.

On import, stored (scale, zero_point) pairs are converted back to (min, max)
ranges, min = -zp * scale and max = (255 - zp) * scale in float32, and
returned as a quant_state ready for ``infer/convert.py``; re-nudging them in
float32 (``core/quant.py::nudge_min_max``) gives back the stored zero point
and the stored scale (``tests/test_torch_darknet_io.py`` holds both).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from yolo_quantization_tpu_torch.nn.graph import (
    BatchNormSpec,
    ConnectedSpec,
    ConvSpec,
    DeconvSpec,
    LocalSpec,
    MaxPoolSpec,
    NetworkDef,
    RouteSpec,
    UpsampleSpec,
)


def _range_from_scale_zp(scale: float, zp: int) -> tuple[float, float]:
    """Invert the nudge: min = (0 - zp) * scale, max = (255 - zp) * scale."""
    return (0 - zp) * scale, (255 - zp) * scale


@dataclass
class DarknetCheckpoint:
    params: dict[int, dict[str, np.ndarray]]
    quant_state: dict[str, dict[str, np.float32]]
    seen: int
    # raw per-layer quant artifacts for exact round-trips / debugging
    raw_quant: dict[int, dict[str, np.ndarray]]


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def f32(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.data, np.float32, n, self.off)
        self.off += 4 * n
        return out.copy()

    def u8(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.data, np.uint8, n, self.off)
        self.off += n
        return out.copy()

    def i32(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.data, np.int32, n, self.off)
        self.off += 4 * n
        return out.copy()

    def remaining(self) -> int:
        return len(self.data) - self.off


def load_darknet_weights(
    path: str, net: NetworkDef, quantized: bool | None = None
) -> DarknetCheckpoint:
    """Read a darknet weights file laid out for ``net``.

    ``quantized=None`` auto-detects whether the file contains the quant
    extension by checking the total byte count against both layouts.
    """
    with open(path, "rb") as f:
        data = f.read()
    if quantized is None:
        for flag in (True, False):
            if _layout_size(net, flag) + 20 == len(data):
                quantized = flag
                break
        else:
            raise ValueError(
                f"file size {len(data)} matches neither quantized "
                f"({_layout_size(net, True) + 20}) nor float "
                f"({_layout_size(net, False) + 20}) layout"
            )
    r = _Reader(data)
    major, minor, revision = r.i32(3)
    if major >= 1 or minor >= 2:
        (seen,) = struct.unpack_from("<Q", data, r.off)
        r.off += 8
    else:  # pragma: no cover - legacy format
        (seen,) = struct.unpack_from("<I", data, r.off)
        r.off += 4

    params: dict[int, dict[str, np.ndarray]] = {}
    qs: dict[str, dict[str, np.float32]] = {}
    raw: dict[int, dict[str, np.ndarray]] = {}
    in_c = net.channels
    in_h, in_w = net.height, net.width
    chans = net.out_channels()
    shapes = net.shapes()

    for i, s in enumerate(net.specs):
        if isinstance(s, ConvSpec):
            n, k = s.filters, s.size
            p: dict[str, np.ndarray] = {"bias": r.f32(n)}
            if s.batch_normalize:
                p["gamma"] = r.f32(n)
                p["mean"] = r.f32(n)
                p["var"] = r.f32(n)
            if quantized:
                in_scale, = r.f32(1)
                in_zp, = r.u8(1)
                act_scale, = r.f32(1)
                act_zp, = r.u8(1)
                w_scales = r.f32(n)
                w_zps = r.u8(n)
                w_u8 = r.u8(n * in_c * k * k)
                raw[i] = {
                    "input_scale": np.float32(in_scale),
                    "input_zp": np.uint8(in_zp),
                    "activ_scale": np.float32(act_scale),
                    "activ_zp": np.uint8(act_zp),
                    "weight_scales": w_scales,
                    "weight_zps": w_zps,
                    "weights_u8": w_u8.reshape(n, in_c, k, k),
                }
                lo, hi = _range_from_scale_zp(act_scale, int(act_zp))
                qs[f"act_{i}"] = {"min": np.float32(lo), "max": np.float32(hi)}
                if i == 0:
                    lo, hi = _range_from_scale_zp(in_scale, int(in_zp))
                    qs["input"] = {"min": np.float32(lo), "max": np.float32(hi)}
            w = r.f32(n * in_c * k * k).reshape(n, in_c, k, k)  # OIHW
            p["w"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # HWIO
            params[i] = p
        elif isinstance(s, DeconvSpec):
            # darknet serializes deconv exactly like conv (save_weights_upto:982)
            n, k = s.filters, s.size
            p = {"bias": r.f32(n)}
            if s.batch_normalize:
                p["gamma"] = r.f32(n)
                p["mean"] = r.f32(n)
                p["var"] = r.f32(n)
            w = r.f32(n * in_c * k * k).reshape(n, in_c, k, k)
            p["w"] = np.ascontiguousarray(w.transpose(2, 3, 1, 0))
            params[i] = p
        elif isinstance(s, ConnectedSpec):
            # biases then (outputs, inputs) weights (parser.c load_connected_weights)
            fin = in_h * in_w * in_c
            p = {"bias": r.f32(s.outputs)}
            w = r.f32(s.outputs * fin).reshape(s.outputs, fin)
            p["w"] = np.ascontiguousarray(w.T)
            if s.batch_normalize:
                p["gamma"] = r.f32(s.outputs)
                p["mean"] = r.f32(s.outputs)
                p["var"] = r.f32(s.outputs)
            params[i] = p
        elif isinstance(s, LocalSpec):
            oh, ow, _ = shapes[i]
            outputs = oh * ow * s.filters
            kin = s.size * s.size * in_c
            p = {"bias": r.f32(outputs).reshape(s.filters, oh * ow).T.copy()}
            # darknet local weights: (locations, filters, kin) row-major? the C
            # forward indexes weights + j*size*size*c*n, A=(n, kin) per loc
            w = r.f32(oh * ow * s.filters * kin).reshape(oh * ow, s.filters, kin)
            p["w"] = np.ascontiguousarray(w.transpose(0, 2, 1))
            params[i] = p
        elif isinstance(s, BatchNormSpec):
            # darknet saves scales/mean/var only — beta is NOT serialized
            # (save_batchnorm_weights parser.c:931-941)
            p = {"gamma": r.f32(in_c), "mean": r.f32(in_c), "var": r.f32(in_c),
                 "bias": np.zeros((in_c,), np.float32)}
            params[i] = p
        elif isinstance(s, MaxPoolSpec):
            if quantized:
                scale, = r.f32(1)
                zp, = r.u8(1)
                raw[i] = {"activ_scale": np.float32(scale), "activ_zp": np.uint8(zp)}
        elif isinstance(s, RouteSpec):
            # first_time=1: fine-tuning a pre-quant checkpoint — no quant
            # block in the file; range inherited (src/parser.c:1176-1183)
            if quantized and s.quantized and len(s.layers) > 1 and not s.first_time:
                scale, = r.f32(1)
                zp, = r.u8(1)
                raw[i] = {"activ_scale": np.float32(scale), "activ_zp": np.uint8(zp)}
                lo, hi = _range_from_scale_zp(float(scale), int(zp))
                qs[f"act_{i}"] = {"min": np.float32(lo), "max": np.float32(hi)}
        elif isinstance(s, UpsampleSpec):
            if quantized and s.quantized and not s.first_time:
                scale, = r.f32(1)
                zp, = r.u8(1)
                raw[i] = {"activ_scale": np.float32(scale), "activ_zp": np.uint8(zp)}
        in_h, in_w, in_c = shapes[i]

    if r.remaining():
        raise ValueError(f"{r.remaining()} trailing bytes — layout mismatch")
    if "input" not in qs:
        qs["input"] = {"min": np.float32(0.0), "max": np.float32(1.0)}
    return DarknetCheckpoint(params=params, quant_state=qs, seen=seen, raw_quant=raw)


def _layout_size(net: NetworkDef, quantized: bool) -> int:
    """Byte count of the body (without the 20-byte header)."""
    total = 0
    in_c = net.channels
    in_h, in_w = net.height, net.width
    shapes = net.shapes()
    for i, s in enumerate(net.specs):
        if isinstance(s, DeconvSpec):
            n, k = s.filters, s.size
            total += 4 * n + (3 * 4 * n if s.batch_normalize else 0)
            total += 4 * n * in_c * k * k
        elif isinstance(s, ConnectedSpec):
            fin = in_h * in_w * in_c
            total += 4 * s.outputs * (1 + fin)
            if s.batch_normalize:
                total += 3 * 4 * s.outputs
        elif isinstance(s, LocalSpec):
            oh, ow, _ = shapes[i]
            total += 4 * oh * ow * s.filters * (1 + s.size * s.size * in_c)
        elif isinstance(s, BatchNormSpec):
            total += 3 * 4 * in_c
        elif isinstance(s, ConvSpec):
            n, k = s.filters, s.size
            total += 4 * n  # biases
            if s.batch_normalize:
                total += 3 * 4 * n
            if quantized:
                total += (4 + 1) * 2          # input/activ scale+zp
                total += (4 + 1) * n          # per-channel weight scale+zp
                total += n * in_c * k * k     # uint8 weights
            total += 4 * n * in_c * k * k     # float weights
        elif isinstance(s, MaxPoolSpec):
            if quantized:
                total += 5
        elif isinstance(s, RouteSpec):
            if quantized and s.quantized and len(s.layers) > 1 and not s.first_time:
                total += 5
        elif isinstance(s, UpsampleSpec):
            if quantized and s.quantized and not s.first_time:
                total += 5
        in_h, in_w, in_c = shapes[i]
    return total


def save_darknet_weights(
    path: str,
    net: NetworkDef,
    params: dict[int, dict[str, np.ndarray]],
    quant_state: dict[str, dict[str, float]] | None = None,
    seen: int = 0,
) -> None:
    """Write params (+ quant extension when quant_state given) in darknet layout.

    The quant block's per-layer artifacts (weight uint8 codes + scales) are
    re-derived from the float weights by the same BN-fold + per-channel nudge
    as ``infer/convert.py``, so a file written here and loaded by the darknet
    binary sees the integer model the engine runs.
    """
    from yolo_quantization_tpu_torch.infer.convert import convert

    program = convert(net, params, quant_state) if quant_state is not None else None

    out = bytearray()
    out += struct.pack("<iii", 0, 2, 0)
    out += struct.pack("<Q", seen)
    in_c = net.channels
    chans = net.out_channels()
    prev_qp = (program.in_scale, program.in_zp) if program else None

    for i, s in enumerate(net.specs):
        if isinstance(s, ConvSpec):
            p = params[i]
            n, k = s.filters, s.size
            out += np.asarray(p["bias"], np.float32).tobytes()
            if s.batch_normalize:
                out += np.asarray(p["gamma"], np.float32).tobytes()
                out += np.asarray(p["mean"], np.float32).tobytes()
                out += np.asarray(p["var"], np.float32).tobytes()
            if program is not None:
                a = program.arrays[i]
                c = program.cfg[i]
                out += struct.pack("<f", prev_qp[0]) + struct.pack("<B", prev_qp[1])
                out += struct.pack("<f", c.out_scale) + struct.pack("<B", c.out_zp)
                out += np.asarray(a["w_scale"], np.float32).tobytes()
                out += np.asarray(a["w_zp_u8"], np.uint8).tobytes()
                w_u8 = (a["w_i8"].astype(np.int16) + 128).astype(np.uint8)  # HWIO
                out += np.ascontiguousarray(w_u8.transpose(3, 2, 0, 1)).tobytes()
            w = np.asarray(p["w"], np.float32)  # HWIO -> OIHW
            out += np.ascontiguousarray(w.transpose(3, 2, 0, 1)).tobytes()
        elif isinstance(s, DeconvSpec):
            p = params[i]
            out += np.asarray(p["bias"], np.float32).tobytes()
            if s.batch_normalize:
                out += np.asarray(p["gamma"], np.float32).tobytes()
                out += np.asarray(p["mean"], np.float32).tobytes()
                out += np.asarray(p["var"], np.float32).tobytes()
            w = np.asarray(p["w"], np.float32)
            out += np.ascontiguousarray(w.transpose(3, 2, 0, 1)).tobytes()
        elif isinstance(s, ConnectedSpec):
            p = params[i]
            out += np.asarray(p["bias"], np.float32).tobytes()
            out += np.ascontiguousarray(np.asarray(p["w"], np.float32).T).tobytes()
            if s.batch_normalize:
                out += np.asarray(p["gamma"], np.float32).tobytes()
                out += np.asarray(p["mean"], np.float32).tobytes()
                out += np.asarray(p["var"], np.float32).tobytes()
        elif isinstance(s, LocalSpec):
            p = params[i]
            out += np.ascontiguousarray(np.asarray(p["bias"], np.float32).T).tobytes()
            w = np.asarray(p["w"], np.float32)  # (loc, kin, n) -> (loc, n, kin)
            out += np.ascontiguousarray(w.transpose(0, 2, 1)).tobytes()
        elif isinstance(s, BatchNormSpec):
            p = params[i]
            out += np.asarray(p["gamma"], np.float32).tobytes()
            out += np.asarray(p["mean"], np.float32).tobytes()
            out += np.asarray(p["var"], np.float32).tobytes()
        elif isinstance(s, (MaxPoolSpec, UpsampleSpec)):
            # unlike the reference's save (which ignores first_time and can
            # write files its own loader then misreads), writer and reader
            # here agree: first_time layers have no quant block either way
            if program is not None and (
                not isinstance(s, UpsampleSpec) or (s.quantized and not s.first_time)
            ):
                c = program.cfg[i]
                out += struct.pack("<f", c.out_scale) + struct.pack("<B", c.out_zp)
        elif isinstance(s, RouteSpec):
            if (
                program is not None and s.quantized and len(s.layers) > 1
                and not s.first_time
            ):
                c = program.cfg[i]
                out += struct.pack("<f", c.out_scale) + struct.pack("<B", c.out_zp)
        if program is not None:
            c = program.cfg[i]
            prev_qp = (c.out_scale, c.out_zp)
        in_c = chans[i]

    with open(path, "wb") as f:
        f.write(bytes(out))
