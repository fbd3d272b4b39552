"""Canonical ready-to-run model builds (flagship config + synthetic ranges).

``flagship_program`` builds the reference benchmark config — quantized
yolov3-tiny, 5 classes, relu6, per-channel symmetric int8 weights — from
seeded random weights and fixed synthetic quantization ranges.
``parity_program`` builds the configuration that matches the darknet C
binary byte for byte: leaky yolov3-tiny with the reference's asymmetric
weights and raw-byte route concat (run it with ``dynamic_input=True`` and
``exact_leaky=True``).  ``v3_program`` builds full yolov3 (darknet53, 80
classes) the same way, the configuration ``scripts/bench_v3.py`` serves;
``v2_tiny_program`` and ``v2_program`` build yolov2-tiny and yolov2 (VOC,
20 classes, leaky, [region] heads).
"""

from __future__ import annotations

import numpy as np

from yolo_quantization_tpu_torch.infer.convert import IntProgram, convert
from yolo_quantization_tpu_torch.models import zoo
from yolo_quantization_tpu_torch.nn.graph import (
    ConvSpec,
    NetworkDef,
    init_params_numpy,
    init_quant_state,
)


def synthetic_quant_state(net: NetworkDef):
    """Fixed ranges: input [0,1], relu6 convs [0,6], linear heads [-12,12],
    everything else [-2,6]."""
    qs = init_quant_state(net)
    qs["input"] = {"min": np.float32(0.0), "max": np.float32(1.0)}
    for i, s in enumerate(net.specs):
        key = f"act_{i}"
        if key not in qs:
            continue
        if isinstance(s, ConvSpec) and s.activation == "relu6":
            qs[key] = {"min": np.float32(0.0), "max": np.float32(6.0)}
        elif isinstance(s, ConvSpec) and s.activation == "linear":
            qs[key] = {"min": np.float32(-12.0), "max": np.float32(12.0)}
        else:  # leaky convs, routes, shortcuts
            qs[key] = {"min": np.float32(-2.0), "max": np.float32(6.0)}
    return qs


def flagship_network(classes: int = 5, size: int = 416) -> NetworkDef:
    return zoo.yolov3_tiny(classes=classes, width=size, height=size)


def flagship_program(classes: int = 5, size: int = 416, seed: int = 0) -> IntProgram:
    net = flagship_network(classes, size)
    params = init_params_numpy(seed, net)
    return convert(net, params, synthetic_quant_state(net))


def parity_program(classes: int = 5, size: int = 416, seed: int = 0) -> IntProgram:
    net = zoo.yolov3_tiny(classes=classes, activation="leaky", width=size, height=size)
    params = init_params_numpy(seed, net)
    return convert(net, params, synthetic_quant_state(net), symmetric_weights=False,
                   route_rescale=False)


def perturbed_quant_state(qs):
    """The ranges moved off the synthetic rationals: the idx-th tracked range
    after the input gets its minimum scaled by 1 + 0.013 (idx + 1) and its
    maximum by 1 + 0.017 (idx + 1).  Under synthetic ranges every leaky conv
    and shortcut of yolov3 is [-2, 6], so each shortcut's ratios are 1 and
    its constant an integer; learned ranges are never so round, and only
    these exercise the shortcut's rounding."""
    out = dict(qs)
    for idx, key in enumerate(k for k in qs if k != "input"):
        out[key] = {
            "min": np.float32(qs[key]["min"]) * np.float32(1.0 + 0.013 * (idx + 1)),
            "max": np.float32(qs[key]["max"]) * np.float32(1.0 + 0.017 * (idx + 1)),
        }
    return out


def v3_program(classes: int = 80, size: int = 416, seed: int = 0, *, perturbed: bool = False,
               symmetric_weights: bool = True) -> IntProgram:
    """Full yolov3 from seeded weights and synthetic ranges, or with
    ``perturbed`` the ranges of ``perturbed_quant_state``."""
    net = zoo.yolov3(classes=classes, width=size, height=size)
    qs = synthetic_quant_state(net)
    if perturbed:
        qs = perturbed_quant_state(qs)
    return convert(net, init_params_numpy(seed, net), qs, symmetric_weights=symmetric_weights)


def v2_quant_state(net: NetworkDef):
    """``synthetic_quant_state`` with every float -> quant boundary range
    (``in_i``, yolov2's conv 29 after the reorg route) at [-2, 6], the range
    of the leaky outputs it concatenates; unseen, it would nudge to [0, 1]."""
    qs = synthetic_quant_state(net)
    for key in qs:
        if key.startswith("in_"):
            qs[key] = {"min": np.float32(-2.0), "max": np.float32(6.0)}
    return qs


def v2_tiny_program(classes: int = 20, size: int = 416, seed: int = 0) -> IntProgram:
    """yolov2-tiny (9 convs) from seeded weights and synthetic ranges,
    symmetric int8 weights."""
    net = zoo.yolov2_tiny(classes=classes, width=size, height=size)
    return convert(net, init_params_numpy(seed, net), v2_quant_state(net))


def v2_program(classes: int = 20, size: int = 416, seed: int = 0) -> IntProgram:
    """yolov2 (23 convs, the reorg passthrough as a float route into conv
    29) from seeded weights and synthetic ranges, symmetric int8 weights."""
    net = zoo.yolov2(classes=classes, width=size, height=size)
    return convert(net, init_params_numpy(seed, net), v2_quant_state(net))
