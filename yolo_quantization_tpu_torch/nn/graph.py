"""Declarative network graph: layer specs, shape inference, numpy init and
the float / QAT forward.

The counterpart of ``yolo_quantization_tpu/nn/graph.py``: the 21 ``*Spec``
dataclasses with identical field names and defaults, ``NetworkDef`` with its
static shape and domain inference, the numpy parameter / quant-state
initializers, and ``forward`` in every training and evaluation mode over a
functional parameter layout: ``params[i]`` holds layer i's tensors under the
reference's keys (``w`` HWIO, ``bias``, ``gamma``, ``mean``, ``var``) and
``quant_state`` maps ``input`` / ``act_i`` / ``in_i`` to ``{min, max}``
0-d tensors.  ``params_to_torch`` and ``params_to_numpy`` (and the pair for
the quant state) carry them to and from numpy, which is how weights cross
between this package and the JAX one and how ``convert`` reads them.
``NetParams`` holds the same layout as a module (what a trainer keeps, and
DDP and FSDP2 wrap); a ``ForwardMode`` with a data-parallel group takes its
batch statistics, ranges and dropout masks over the global batch.
"""

from __future__ import annotations

from dataclasses import InitVar, dataclass
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from yolo_quantization_tpu_torch.core.quant import (
    ema_update,
    fake_quant,
    fake_quant_learned,
    fake_quant_per_channel,
    fake_quant_symmetric_per_channel,
)
from yolo_quantization_tpu_torch.core.tree import softmax_tree
from yolo_quantization_tpu_torch.nn import layers as L
from yolo_quantization_tpu_torch.parallel import mesh as pmesh
from yolo_quantization_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class ConvSpec:
    filters: int
    size: int = 3
    stride: int = 1
    pad: int = 1
    activation: str = "leaky"
    batch_normalize: bool = True
    quantized: bool = True
    quant_stop: bool = False  # dequantize output to float (YOLO head input)


@dataclass(frozen=True)
class MaxPoolSpec:
    size: int = 2
    stride: int = 2
    pad: int | None = None  # darknet default: size - 1
    quantized: bool = True

    @property
    def padding(self) -> int:
        return self.size - 1 if self.pad is None else self.pad


@dataclass(frozen=True)
class RouteSpec:
    layers: tuple[int, ...]  # absolute layer indices
    quantized: bool = True
    first_time: bool = False


@dataclass(frozen=True)
class UpsampleSpec:
    stride: int = 2
    quantized: bool = True
    first_time: bool = False


@dataclass(frozen=True)
class ShortcutSpec:
    index: int  # absolute layer index of the skip source
    activation: str = "linear"


@dataclass(frozen=True)
class YoloSpec:
    """A [yolo] head.  ``scale_x_y`` (YOLOv4's grid sensitivity, default 1)
    stretches the box centre's sigmoid about the cell's middle:
    bx = (col + s sig(tx) - (s - 1) / 2) / W.  It is an init-only value, not
    a field, so that the spec's fields, repr and dict (and the serialized
    form, where it is 1) stay those of the reference package's YoloSpec;
    equality and the hash take it in."""

    mask: tuple[int, ...]
    anchors: tuple[tuple[float, float], ...]  # ALL anchors; mask selects
    classes: int
    scale_x_y: InitVar[float] = 1.0

    def __post_init__(self, scale_x_y: float) -> None:
        object.__setattr__(self, "scale_x_y", float(scale_x_y))

    def __eq__(self, other) -> bool:
        if other.__class__ is not self.__class__:
            return NotImplemented
        return ((self.mask, self.anchors, self.classes, self.scale_x_y)
                == (other.mask, other.anchors, other.classes, other.scale_x_y))

    def __hash__(self) -> int:
        return hash((self.mask, self.anchors, self.classes, self.scale_x_y))


@dataclass(frozen=True)
class ConnectedSpec:
    outputs: int
    activation: str = "linear"
    batch_normalize: bool = False


@dataclass(frozen=True)
class SoftmaxSpec:
    groups: int = 1
    temperature: float = 1.0
    tree: Any = None


@dataclass(frozen=True)
class AvgPoolSpec:
    """Global average pool."""


@dataclass(frozen=True)
class DropoutSpec:
    probability: float = 0.5


@dataclass(frozen=True)
class CropSpec:
    crop_height: int
    crop_width: int
    flip: bool = False


@dataclass(frozen=True)
class LocalSpec:
    filters: int
    size: int = 3
    stride: int = 1
    pad: int = 0
    activation: str = "leaky"


@dataclass(frozen=True)
class DeconvSpec:
    filters: int
    size: int = 3
    stride: int = 1
    activation: str = "leaky"
    batch_normalize: bool = False


@dataclass(frozen=True)
class ReorgSpec:
    stride: int = 2
    reverse: bool = False


@dataclass(frozen=True)
class LRNSpec:
    size: int = 5
    alpha: float = 0.0001
    beta: float = 0.75
    kappa: float = 1.0


@dataclass(frozen=True)
class L2NormSpec:
    pass


@dataclass(frozen=True)
class LogisticSpec:
    """Standalone logistic activation layer."""


@dataclass(frozen=True)
class ActivationSpec:
    activation: str = "linear"


@dataclass(frozen=True)
class BatchNormSpec:
    """Standalone batchnorm layer."""


@dataclass(frozen=True)
class RegionSpec:
    """YOLOv2 head; anchors in feature-grid units."""

    anchors: tuple[tuple[float, float], ...]
    classes: int = 20
    num: int = 5
    softmax: bool = True
    tree: Any = None
    object_scale: float = 5.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    coord_scale: float = 1.0
    rescore: bool = True
    thresh: float = 0.6


@dataclass(frozen=True)
class DetectionSpec:
    """YOLOv1 head, fed by a connected layer."""

    classes: int = 20
    num: int = 2
    side: int = 7
    coords: int = 4
    sqrt: bool = True
    rescore: bool = False
    softmax: bool = False
    forced: bool = False
    random: bool = False
    object_scale: float = 1.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    coord_scale: float = 1.0


LayerSpec = Any  # union of the above

HEAD_SPECS = (YoloSpec, RegionSpec, DetectionSpec)

SIMPLE_SPECS = (
    ConnectedSpec, SoftmaxSpec, AvgPoolSpec, DropoutSpec, CropSpec, LocalSpec,
    DeconvSpec, ReorgSpec, LRNSpec, L2NormSpec, LogisticSpec, ActivationSpec,
    BatchNormSpec, RegionSpec, DetectionSpec,
)


@dataclass(frozen=True)
class NetworkDef:
    """A model: input geometry + ordered layer specs."""

    specs: tuple[LayerSpec, ...]
    width: int = 416
    height: int = 416
    channels: int = 3

    def shapes(self) -> list[tuple[int, int, int]]:
        """Static shape inference: (h, w, c) produced by each layer."""
        out: list[tuple[int, int, int]] = []
        h, w, c = self.height, self.width, self.channels
        for s in self.specs:
            if isinstance(s, ConvSpec):
                h = (h + 2 * s.pad - s.size) // s.stride + 1
                w = (w + 2 * s.pad - s.size) // s.stride + 1
                c = s.filters
            elif isinstance(s, MaxPoolSpec):
                p = s.padding
                h = (h + p - s.size) // s.stride + 1
                w = (w + p - s.size) // s.stride + 1
            elif isinstance(s, UpsampleSpec):
                h, w = h * s.stride, w * s.stride
            elif isinstance(s, RouteSpec):
                h, w, _ = out[s.layers[0]]
                c = sum(out[j][2] for j in s.layers)
            elif isinstance(s, (ShortcutSpec, YoloSpec, RegionSpec, DetectionSpec,
                                SoftmaxSpec, DropoutSpec, LRNSpec, L2NormSpec,
                                LogisticSpec, ActivationSpec, BatchNormSpec)):
                pass
            elif isinstance(s, ConnectedSpec):
                h, w, c = 1, 1, s.outputs
            elif isinstance(s, AvgPoolSpec):
                h, w = 1, 1
            elif isinstance(s, CropSpec):
                h, w = s.crop_height, s.crop_width
            elif isinstance(s, LocalSpec):
                h = (h + 2 * s.pad - s.size) // s.stride + 1
                w = (w + 2 * s.pad - s.size) // s.stride + 1
                c = s.filters
            elif isinstance(s, DeconvSpec):
                h = (h - 1) * s.stride + s.size
                w = (w - 1) * s.stride + s.size
                c = s.filters
            elif isinstance(s, ReorgSpec):
                if s.reverse:
                    h, w, c = h * s.stride, w * s.stride, c // (s.stride**2)
                else:
                    h, w, c = h // s.stride, w // s.stride, c * s.stride**2
            else:
                raise TypeError(f"unknown spec {s}")
            out.append((h, w, c))
        return out

    def out_channels(self) -> list[int]:
        """Static shape inference: the channels produced by each layer."""
        return [c for (_, _, c) in self.shapes()]

    def head_indices(self) -> list[int]:
        return [i for i, s in enumerate(self.specs) if isinstance(s, HEAD_SPECS)]

    def output_domains(self) -> list[str]:
        """Static per-layer output domain at integer inference: "u8" or "f32"."""
        doms: list[str] = []

        def inp(i: int) -> str:
            return doms[i - 1] if i > 0 else "u8"  # net input is quantized

        for i, s in enumerate(self.specs):
            if isinstance(s, ConvSpec):
                d = ("f32" if s.quant_stop else "u8") if s.quantized else "f32"
            elif isinstance(s, (MaxPoolSpec, UpsampleSpec)):
                d = inp(i)
            elif isinstance(s, RouteSpec):
                d = "u8" if s.quantized and all(doms[j] == "u8" for j in s.layers) else "f32"
            elif isinstance(s, ShortcutSpec):
                d = "u8" if inp(i) == "u8" and doms[s.index] == "u8" else "f32"
            elif isinstance(s, YoloSpec):
                d = inp(i)
            else:
                d = "f32"
            doms.append(d)
        return doms


def init_params_numpy(seed: int, net: NetworkDef) -> dict[int, dict[str, np.ndarray]]:
    """He-style init (darknet scale*randn) from a numpy seed.

    Draws the same numbers in the same order as the reference's
    ``init_params_numpy``, so one seed gives one set of weights in both.
    """
    rng = np.random.default_rng(seed)
    params: dict[int, dict[str, np.ndarray]] = {}
    shapes = net.shapes()

    def randn(shape, scale):
        return (rng.standard_normal(shape) * scale).astype("float32")

    def bn_extras(p, n):
        p["gamma"] = np.ones((n,), "float32")
        p["mean"] = np.zeros((n,), "float32")
        p["var"] = np.ones((n,), "float32")

    for i, s in enumerate(net.specs):
        in_h, in_w, in_c = shapes[i - 1] if i > 0 else (net.height, net.width, net.channels)
        if isinstance(s, ConvSpec):
            scale = float(np.sqrt(2.0 / (s.size * s.size * in_c)))
            p = {
                "w": randn((s.size, s.size, in_c, s.filters), scale),
                "bias": np.zeros((s.filters,), "float32"),
            }
            if s.batch_normalize:
                bn_extras(p, s.filters)
            params[i] = p
        elif isinstance(s, ConnectedSpec):
            fin = in_h * in_w * in_c
            p = {
                "w": randn((fin, s.outputs), float(np.sqrt(2.0 / fin))),
                "bias": np.zeros((s.outputs,), "float32"),
            }
            if s.batch_normalize:
                bn_extras(p, s.outputs)
            params[i] = p
        elif isinstance(s, LocalSpec):
            oh, ow, _ = shapes[i]
            kin = s.size * s.size * in_c
            params[i] = {
                "w": randn((oh * ow, kin, s.filters), float(np.sqrt(2.0 / kin))),
                "bias": np.zeros((oh * ow, s.filters), "float32"),
            }
        elif isinstance(s, DeconvSpec):
            scale = float(np.sqrt(2.0 / (s.size * s.size * in_c)))
            p = {
                "w": randn((s.size, s.size, in_c, s.filters), scale),
                "bias": np.zeros((s.filters,), "float32"),
            }
            if s.batch_normalize:
                bn_extras(p, s.filters)
            params[i] = p
        elif isinstance(s, BatchNormSpec):
            p = {"bias": np.zeros((in_c,), "float32")}
            bn_extras(p, in_c)
            params[i] = p
    return params


def init_quant_state(
    net: NetworkDef, input_calibration: tuple[float, ...] = ()
) -> dict[str, dict[str, np.float32]]:
    """EMA range state: one (min, max) pair per tracked activation.

    Tracked: the network input, every quantized conv output (plus its input
    at a float -> quant boundary), every multi-input quantized route and
    every shortcut.  Zeros mean "unseen".  ``input_calibration`` seeds the
    input range: one value v means [0, v], two mean [min, max].
    """
    if len(input_calibration) >= 2:
        in_lo, in_hi = float(input_calibration[0]), float(input_calibration[1])
    elif len(input_calibration) == 1:
        in_lo, in_hi = 0.0, float(input_calibration[0])
    else:
        in_lo = in_hi = 0.0
    qs = {"input": {"min": np.float32(min(in_lo, 0.0)), "max": np.float32(max(in_hi, 0.0))}}
    domains = net.output_domains()
    for i, s in enumerate(net.specs):
        if isinstance(s, ConvSpec) and s.quantized:
            qs[f"act_{i}"] = {"min": np.float32(0.0), "max": np.float32(0.0)}
            if i > 0 and domains[i - 1] == "f32":
                qs[f"in_{i}"] = {"min": np.float32(0.0), "max": np.float32(0.0)}
        elif isinstance(s, RouteSpec) and s.quantized and len(s.layers) > 1:
            qs[f"act_{i}"] = {"min": np.float32(0.0), "max": np.float32(0.0)}
        elif isinstance(s, ShortcutSpec):
            qs[f"act_{i}"] = {"min": np.float32(0.0), "max": np.float32(0.0)}
    return qs


# ---------------------------------------------------------------------------
# Parameters and quant state as tensors
# ---------------------------------------------------------------------------

TRAINABLE = ("w", "bias", "gamma")  # mean/var are BN rolling statistics


def params_to_torch(params_np, device, requires_grad: bool = False) -> dict[int, dict[str, torch.Tensor]]:
    """numpy (or any array) params -> float32 tensors on ``device``; with
    ``requires_grad`` the trainable ones (w, bias, gamma) are leaves that
    take gradients."""
    out = {}
    for i, p in params_np.items():
        out[i] = {}
        for k, v in p.items():
            t = torch.tensor(np.asarray(v, np.float32), device=device)
            out[i][k] = t.requires_grad_(requires_grad and k in TRAINABLE)
    return out


def params_to_numpy(params_t) -> dict[int, dict[str, np.ndarray]]:
    """Copies (never views of the live tensors, which the optimizer updates
    in place).  A sharded tensor (FSDP2) is gathered whole, a collective
    every rank of its mesh must join."""
    def whole(v):
        return v.full_tensor() if isinstance(v, DTensor) else v

    return {i: {k: whole(v.detach()).cpu().numpy().copy() for k, v in p.items()}
            for i, p in params_t.items()}


class NetParams(torch.nn.Module):
    """A network's parameters as a module (what DDP and FSDP2 wrap): layer
    i's trainable tensors (w, bias, gamma) are parameters of child module
    ``str(i)``, its BN rolling statistics (mean, var) buffers.  Indexing
    gives the functional layout ``forward`` reads, ``params[i] -> {name:
    tensor}``, looked up on every access: inside the module's own forward
    that is the tensor DDP's hooks see and FSDP2's unsharded parameter."""

    def __init__(self, net: NetworkDef, params: dict[int, dict[str, torch.Tensor]]):
        super().__init__()
        self.net = net
        self.layers = torch.nn.ModuleDict()
        self._names = {}
        for i, p in params.items():
            layer = torch.nn.Module()
            for k, v in p.items():
                if k in TRAINABLE:
                    layer.register_parameter(k, torch.nn.Parameter(v.detach(), requires_grad=True))
                else:
                    layer.register_buffer(k, v.detach())
            self.layers[str(i)] = layer
            self._names[i] = tuple(p)

    def __getitem__(self, i: int) -> dict[str, torch.Tensor]:
        layer = self.layers[str(i)]
        return {k: getattr(layer, k) for k in self._names[i]}

    def get(self, i: int, default=None):
        return self[i] if i in self._names else default

    def __contains__(self, i) -> bool:
        return i in self._names

    def __iter__(self):
        return iter(self._names)

    def keys(self):
        return self._names.keys()

    def items(self):
        return [(i, self[i]) for i in self._names]

    def values(self):
        return [self[i] for i in self._names]

    def forward(self, x: torch.Tensor, mode: "ForwardMode", quant_state=None,
                generator: torch.Generator | None = None, return_outputs: bool = False):
        return forward(self.net, self, x, mode, quant_state, return_outputs, generator)


def quant_state_to_torch(qs_np, device) -> dict[str, dict[str, torch.Tensor]]:
    """Ranges -> 0-d float32 tensors on ``device``."""
    return {k: {n: torch.tensor(float(np.float32(v)), dtype=torch.float32, device=device)
                for n, v in st.items()} for k, st in qs_np.items()}


def quant_state_to_numpy(qs_t) -> dict[str, dict[str, np.float32]]:
    return {k: {n: np.float32(v.detach().cpu().numpy()) for n, v in st.items()}
            for k, st in qs_t.items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ForwardMode:
    train: bool = False        # BN batch stats (+ stats aux out)
    qat: bool = False          # fake-quant weights + activations
    update_ranges: bool = False  # EMA-update quant ranges (training only)
    symmetric_w: bool = True   # weight fake-quant scheme; must match the
                               # convert(symmetric_weights=...) used at export
    # conv operand dtype: "float32" (TF32 off) or "bfloat16" (float32
    # accumulation and outputs; params stay float32)
    compute_dtype: str = "float32"
    # activation-range statistic fed to the EMA tracker: "minmax" (raw batch
    # extremes) or "percentile" / "percentile:<p>" (p% per tail, 0.1 by
    # default, over a strided subsample)
    range_stat: str = "minmax"
    # learnable ranges: fake-quant passes gradients to min/max and the train
    # step moves them by sign-SGD
    learned_ranges: bool = False
    # data parallelism: the process group whose ranks hold the rest of the
    # global batch.  Batch statistics, activation ranges and dropout masks
    # are the global batch's (parallel/mesh.py); None is one process
    group: Any = None


def _batch_range(y: torch.Tensor, stat: str, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-batch activation range for the EMA tracker (no gradient), over
    the global batch of ``group``'s ranks.

    "minmax": raw extremes.  "percentile[:p]": the p and 100-p percentiles
    (linear interpolation, the reference's float32 arithmetic) of every
    (n // 65536)-th element.
    """
    with span("range_stats"):
        return _batch_range_stat(y.detach(), stat, group)


def _batch_range_stat(y: torch.Tensor, stat: str, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    if stat == "minmax":
        return pmesh.batch_minmax(y, group)
    if stat.startswith("percentile"):
        tail = float(stat.split(":", 1)[1]) if ":" in stat else 0.1
        sub = torch.sort(pmesh.strided_sample(y.reshape(-1), group).to(torch.float32)).values
        n = sub.shape[0]
        # the rank arithmetic in float32, as the reference's quantile does
        q = np.asarray([tail, 100.0 - tail], np.float32) / np.float32(100.0)
        q = q * np.float32(n - 1)
        low, high = np.floor(q), np.ceil(q)
        hw = q - low
        lw = np.float32(1.0) - hw
        low = np.clip(low, 0, n - 1).astype(np.int64)
        high = np.clip(high, 0, n - 1).astype(np.int64)
        out = [sub[int(lo_)] * float(lw_) + sub[int(hi_)] * float(hw_)
               for lo_, hi_, lw_, hw_ in zip(low, high, lw, hw)]
        return out[0], out[1]
    raise ValueError(f"unknown range_stat {stat!r}")


def _act_fq(mode: ForwardMode):
    return fake_quant_learned if mode.learned_ranges else fake_quant


def _hooked(fq_hook, kind: str, out: torch.Tensor, *inputs) -> torch.Tensor:
    """``out``, or what ``fq_hook(kind, out, *inputs)`` returns in its place
    (``layer_forward``'s hook on each fake-quant)."""
    return out if fq_hook is None else fq_hook(kind, out, *inputs)


def _track(x: torch.Tensor, st, mode: ForwardMode, qs, key: str, stat: str | None = None,
           fq_hook=None):
    """Fake-quant x with the range ``st`` (EMA-updated first when the mode
    tracks ranges, the update written back to ``qs[key]``)."""
    lo, hi = st["min"], st["max"]
    if mode.update_ranges:
        lo, hi = ema_update(lo, hi, *_batch_range(x, stat or mode.range_stat, mode.group))
        qs[key] = {"min": lo, "max": hi}
    return _hooked(fq_hook, "act", _act_fq(mode)(x, lo, hi), x, lo, hi)


# clamp-family activations that fold into the fake-quant clamp exactly
_FOLDABLE = {"relu6": (0.0, 6.0), "relu": (0.0, float("inf"))}


def _conv_forward(s: ConvSpec, p: dict[str, torch.Tensor], x: torch.Tensor, mode: ForwardMode,
                  act_state: dict[str, torch.Tensor] | None, fq_hook=None):
    """One conv layer in any mode: (y, bn_stats | None, new_act_state | None).

    QAT: batch statistics from a float conv, BN folded into the weights with
    them, the folded weights fake-quantized per output channel, the conv,
    the folded bias, the activation, and the activation's fake-quant with
    its tracked range.  In the float phase the stats conv is the layer conv
    (per-channel scaling commutes with the contraction): one conv and a
    per-channel scale and shift.  relu6 and relu fold into the fake-quant
    clamp (their ranges lie inside the activation's bounds, so the clamp and
    the straight-through gate reproduce them, values and gradients).
    """
    quantizing = mode.qat and s.quantized
    bn_stats = None
    if s.batch_normalize and mode.train and not quantizing:
        pre = L.conv2d(x, p["w"], s.stride, s.pad, mode.compute_dtype)
        mean, var = pmesh.batch_stats(pre, mode.group)
        bn_stats = (mean, var)
        inv, bias = L.bn_inference_scale_bias(p["gamma"], p["bias"], mean, var)
        y = pre * inv.reshape(1, 1, 1, -1) + bias.reshape(1, 1, 1, -1)
        return L.activate(y, s.activation), bn_stats, act_state

    if s.batch_normalize:
        if mode.train:
            pre = L.conv2d(x, p["w"], s.stride, s.pad, mode.compute_dtype)
            mean, var = pmesh.batch_stats(pre, mode.group)
            bn_stats = (mean, var)
        else:
            mean, var = p["mean"], p["var"]
        w_folded, bias = L.fold_bn_into_weights(p["w"], None, p["gamma"], p["bias"], mean, var)
    else:
        w_folded, bias = p["w"], p["bias"]

    if quantizing:
        if mode.symmetric_w:
            w_used = fake_quant_symmetric_per_channel(w_folded)
        else:
            wd = w_folded.detach()
            w_used = fake_quant_per_channel(w_folded, torch.amin(wd, dim=(0, 1, 2)),
                                            torch.amax(wd, dim=(0, 1, 2)))
        w_used = _hooked(fq_hook, "w", w_used, w_folded)
    else:
        w_used = w_folded

    y = L.conv2d(x, w_used, s.stride, s.pad, mode.compute_dtype)
    y = y + bias.reshape(1, 1, 1, -1)

    fold_bounds = _FOLDABLE.get(s.activation) if quantizing and act_state is not None else None
    if fold_bounds is None:
        y = L.activate(y, s.activation)

    new_state = act_state
    if quantizing and act_state is not None:
        lo, hi = act_state["min"], act_state["max"]
        if mode.update_ranges:
            # heads (quant_stop) always track raw extremes: their strongest
            # responses are the detections
            stat = "minmax" if s.quant_stop else mode.range_stat
            blo, bhi = _batch_range(y, stat, mode.group)
            if fold_bounds is not None:
                blo, bhi = L.clip(blo, *fold_bounds), L.clip(bhi, *fold_bounds)
            lo, hi = ema_update(lo, hi, blo, bhi)
            new_state = {"min": lo, "max": hi}
        if fold_bounds is not None:
            # identity for every range this trainer produces; exact again
            # for a loaded range outside the activation's bounds
            lo, hi = L.clip(lo, *fold_bounds), L.clip(hi, *fold_bounds)
        y = _hooked(fq_hook, "act", _act_fq(mode)(y, lo, hi), y, lo, hi)
    return y, bn_stats, new_state


def apply_simple_layer(s: LayerSpec, p: dict[str, torch.Tensor] | None, x: torch.Tensor, *,
                       train: bool = False, generator: torch.Generator | None = None,
                       rows: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Forward of the extended (float-only) darknet layers, shared by the
    float/QAT graph and the integer engine (which dequantizes into it).

    ``[softmax]`` with a WordTree: the grouped softmax (with temperature).
    ``[region]``: logistic on x, y and objectness, the raw w and h, and the
    classes by the WordTree's grouped softmax where the head has a tree,
    else softmax (or with ``softmax=0`` logistic).  ``[detection]``: the
    raw output, with ``softmax`` a softmax over each cell's classes.
    ``rows`` = (rank, world): x is this rank's share of a global batch, and
    dropout takes that share of the global batch's mask.
    """
    if isinstance(s, ConnectedSpec):
        if s.batch_normalize:
            y = L.connected(x, p["w"], torch.zeros_like(p["bias"]))
            scale, bias = L.bn_inference_scale_bias(p["gamma"], p["bias"], p["mean"], p["var"])
            y = y * scale + bias
        else:
            y = L.connected(x, p["w"], p["bias"])
        return L.activate(y, s.activation)
    if isinstance(s, SoftmaxSpec):
        if s.tree is not None:
            return softmax_tree(x, s.tree, s.temperature)
        return L.softmax(x, s.temperature, s.groups)
    if isinstance(s, AvgPoolSpec):
        return L.global_avgpool(x)
    if isinstance(s, DropoutSpec):
        return L.dropout(x, s.probability, generator if train else None, rows)
    if isinstance(s, CropSpec):
        return L.crop(x, s.crop_height, s.crop_width, train=train, generator=generator, flip=s.flip)
    if isinstance(s, LocalSpec):
        return L.activate(L.local_conv(x, p["w"], p["bias"], s.size, s.stride, s.pad), s.activation)
    if isinstance(s, DeconvSpec):
        y = L.deconv2d(x, p["w"], s.stride)
        if s.batch_normalize:
            scale, bias = L.bn_inference_scale_bias(p["gamma"], p["bias"], p["mean"], p["var"])
            y = y * scale.reshape(1, 1, 1, -1) + bias.reshape(1, 1, 1, -1)
        else:
            y = y + p["bias"].reshape(1, 1, 1, -1)
        return L.activate(y, s.activation)
    if isinstance(s, ReorgSpec):
        return L.reorg(x, s.stride, s.reverse)
    if isinstance(s, LRNSpec):
        return L.lrn(x, s.size, s.alpha, s.beta, s.kappa)
    if isinstance(s, L2NormSpec):
        return L.l2norm(x)
    if isinstance(s, LogisticSpec):
        return torch.sigmoid(x)
    if isinstance(s, ActivationSpec):
        return L.activate(x, s.activation)
    if isinstance(s, BatchNormSpec):
        scale, bias = L.bn_inference_scale_bias(p["gamma"], p["bias"], p["mean"], p["var"])
        shape = (1,) * (x.ndim - 1) + (-1,)
        return x * scale.reshape(shape) + bias.reshape(shape)
    if isinstance(s, RegionSpec):
        n, h, w, _ = x.shape
        r = x.reshape(n, h, w, s.num, 5 + s.classes)
        if s.tree is not None:
            cls = softmax_tree(r[..., 5:], s.tree)
        else:
            cls = torch.softmax(r[..., 5:], dim=-1) if s.softmax else torch.sigmoid(r[..., 5:])
        return torch.cat([torch.sigmoid(r[..., 0:2]), r[..., 2:4], torch.sigmoid(r[..., 4:5]), cls],
                         dim=-1).reshape(x.shape)
    if isinstance(s, DetectionSpec):
        if s.softmax:
            b, s2 = x.shape[0], s.side * s.side
            cls = torch.softmax(x[:, : s2 * s.classes].reshape(b, s2, s.classes), dim=-1)
            x = torch.cat([cls.reshape(b, s2 * s.classes), x[:, s2 * s.classes :]], dim=-1)
        return x
    raise TypeError(f"not a simple layer: {s}")


def layer_forward(net: NetworkDef, i: int, params, x: torch.Tensor, outputs: list[torch.Tensor],
                  mode: ForwardMode, qs: dict | None, bn_stats: dict,
                  generator: torch.Generator | None = None, fq_hook=None) -> torch.Tensor:
    """Layer i of ``forward``: its output from its input ``x`` and the earlier
    layers' ``outputs`` (routes and shortcuts read them).  Range updates go
    into ``qs`` (a dict the caller owns), batch statistics into
    ``bn_stats``; dropout and the training crop draw from ``generator``.
    Running a layer on given inputs is how two forwards are compared layer
    by layer.  ``fq_hook(kind, out, *inputs)``, where given, sees each
    fake-quant the layer makes and returns the tensor used in its place:
    ``("act", out, v, lo, hi)`` for an activation's, ``("w", out,
    w_folded)`` for a conv's weights."""
    s = net.specs[i]
    key = f"act_{i}"
    if isinstance(s, ConvSpec):
        in_key = f"in_{i}"
        if mode.qat and in_key in qs:
            # float -> quant boundary: fake-quant the input
            x = _track(x, qs[in_key], mode, qs, in_key, fq_hook=fq_hook)
        y, stats, new_state = _conv_forward(s, params[i], x, mode, qs.get(key) if qs else None, fq_hook)
        if stats is not None:
            bn_stats[i] = stats
        if qs is not None and new_state is not None and key in qs:
            qs[key] = new_state
        return y
    if isinstance(s, MaxPoolSpec):
        return L.maxpool(x, s.size, s.stride, s.padding)
    if isinstance(s, UpsampleSpec):
        return L.upsample_nearest(x, s.stride)
    if isinstance(s, RouteSpec):
        y = L.route_concat([outputs[j] for j in s.layers])
        return _track(y, qs[key], mode, qs, key, fq_hook=fq_hook) if mode.qat and key in qs else y
    if isinstance(s, ShortcutSpec):
        y = L.activate(L.shortcut_add(x, outputs[s.index]), s.activation)
        return _track(y, qs[key], mode, qs, key, fq_hook=fq_hook) if mode.qat and key in qs else y
    if isinstance(s, YoloSpec):
        return x  # decoded separately (eval/detect.py)
    if isinstance(s, SIMPLE_SPECS):
        return apply_simple_layer(s, params.get(i), x, train=mode.train, generator=generator,
                                  rows=pmesh.rank_world(mode.group))
    raise TypeError(f"unknown spec {s}")


def input_forward(x: torch.Tensor, mode: ForwardMode, qs: dict | None) -> torch.Tensor:
    """The network input's fake-quant in QAT modes (its range EMA-updated
    into ``qs`` when the mode tracks ranges); the identity otherwise."""
    if not mode.qat:
        return x
    if qs is None:
        raise ValueError("QAT forward requires quant_state")
    st = qs["input"]
    lo, hi = st["min"], st["max"]
    if mode.update_ranges:
        lo, hi = ema_update(lo, hi, *pmesh.batch_minmax(x.detach(), mode.group))
        qs["input"] = {"min": lo, "max": hi}
    return _act_fq(mode)(x, lo, hi)


def forward(net: NetworkDef, params: dict[int, dict[str, torch.Tensor]], x: torch.Tensor,
            mode: ForwardMode = ForwardMode(),
            quant_state: dict[str, dict[str, torch.Tensor]] | None = None,
            return_outputs: bool = False, generator: torch.Generator | None = None):
    """Run the graph.  Returns (head_outputs, aux).

    head_outputs: one tensor per head: the raw float NHWC output of every
    YoloSpec (channels A*(4+1+classes)), the forward output of every
    RegionSpec and DetectionSpec.  aux: {"bn_stats": {i: (mean, var)},
    "quant_state": the (EMA-updated) ranges}, and with ``return_outputs``
    also "input" (the fake-quantized input) and "outputs" (every layer's
    output).  In training modes, dropout and the crop layer draw from
    ``generator``; without one they are the identity and the centre crop.
    """
    qs = dict(quant_state) if quant_state is not None else None
    x = input_forward(x, mode, qs)
    aux = {"input": x} if return_outputs else {}
    outputs: list[torch.Tensor] = []
    heads: list[torch.Tensor] = []
    bn_stats: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
    for i, s in enumerate(net.specs):
        y = layer_forward(net, i, params, x, outputs, mode, qs, bn_stats, generator)
        if isinstance(s, HEAD_SPECS):
            heads.append(y)
        outputs.append(y)
        x = y
    aux.update(bn_stats=bn_stats, quant_state=qs)
    if return_outputs:
        aux["outputs"] = outputs
    return heads, aux
