"""Canonical ready-to-run model builds (flagship config + synthetic ranges).

``flagship_program`` builds the reference benchmark config — quantized
yolov3-tiny, 5 classes, relu6, per-channel symmetric int8 weights — from
seeded random weights and fixed synthetic quantization ranges.
``parity_program`` builds the configuration that matches the darknet C
binary byte for byte: leaky yolov3-tiny with the reference's asymmetric
weights and raw-byte route concat (run it with ``dynamic_input=True`` and
``exact_leaky=True``).
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
