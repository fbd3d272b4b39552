"""darknet ``.cfg`` text -> the reference's layer list, with shapes.

A plain reader of the section kinds the benchmark's detectors use:
``[net]``, ``[convolutional]``, ``[maxpool]``, ``[upsample]``, ``[route]``,
``[shortcut]`` and ``[yolo]``.  It follows darknet's parser
(src/parser.c): ``pad=1`` means ``size // 2``; a maxpool's padding defaults
to ``size - 1`` and its output is ``(h + padding - size) // stride + 1``;
relative route and shortcut indices count back from the layer itself.
Any other section kind is refused.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Layer:
    kind: str                  # conv | maxpool | upsample | route | shortcut | yolo
    out_shape: tuple           # (h, w, c) of this layer's output
    in_shape: tuple = ()       # (h, w, c) of the previous layer's output
    filters: int = 0
    size: int = 1
    stride: int = 1
    pad: int = 0
    activation: str = "linear"
    batch_normalize: bool = False
    quant_stop: bool = False
    sources: tuple = ()        # route: absolute layer indices; shortcut: (skip,)
    mask: tuple = ()
    anchors: tuple = ()
    classes: int = 0
    options: dict = field(default_factory=dict)


@dataclass
class Network:
    width: int
    height: int
    channels: int
    layers: list


def sections(text: str) -> list[tuple[str, dict]]:
    out: list[tuple[str, dict]] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].split(";", 1)[0].strip()
        if not line:
            continue
        if line.startswith("["):
            out.append((line.strip("[]").strip().lower(), {}))
        elif "=" in line:
            if not out:
                raise ValueError(f"option outside any section: {line!r}")
            key, value = line.split("=", 1)
            out[-1][1][key.strip()] = value.strip()
    return out


def _ints(v: str) -> tuple:
    return tuple(int(t) for t in v.replace(" ", "").split(",") if t)


def _floats(v: str) -> tuple:
    return tuple(float(t) for t in v.replace(" ", "").split(",") if t)


def parse(text: str) -> Network:
    secs = sections(text)
    if not secs or secs[0][0] not in ("net", "network"):
        raise ValueError("a cfg starts with [net]")
    net = secs[0][1]
    w = int(net.get("width", 416))
    h = int(net.get("height", 416))
    c = int(net.get("channels", 3))
    layers: list[Layer] = []
    shape = (h, w, c)
    for kind, o in secs[1:]:
        i = len(layers)
        if kind == "convolutional":
            size = int(o.get("size", 1))
            stride = int(o.get("stride", 1))
            pad = size // 2 if int(o.get("pad", 0)) else int(o.get("padding", 0))
            filters = int(o["filters"])
            oh = (shape[0] + 2 * pad - size) // stride + 1
            ow = (shape[1] + 2 * pad - size) // stride + 1
            layer = Layer("conv", (oh, ow, filters), shape, filters=filters, size=size,
                          stride=stride, pad=pad, activation=o.get("activation", "logistic"),
                          batch_normalize=bool(int(o.get("batch_normalize", 0))),
                          quant_stop=bool(int(o.get("quant_stop", 0))), options=o)
        elif kind == "maxpool":
            size = int(o.get("size", 1))
            stride = int(o.get("stride", 1))
            pad = int(o.get("padding", size - 1))
            oh = (shape[0] + pad - size) // stride + 1
            ow = (shape[1] + pad - size) // stride + 1
            layer = Layer("maxpool", (oh, ow, shape[2]), shape, size=size, stride=stride,
                          pad=pad, options=o)
        elif kind == "upsample":
            stride = int(o.get("stride", 2))
            layer = Layer("upsample", (shape[0] * stride, shape[1] * stride, shape[2]), shape,
                          stride=stride, options=o)
        elif kind == "route":
            srcs = tuple(j if j >= 0 else i + j for j in _ints(o["layers"]))
            oh, ow, _ = layers[srcs[0]].out_shape
            layer = Layer("route", (oh, ow, sum(layers[j].out_shape[2] for j in srcs)), shape,
                          sources=srcs, options=o)
        elif kind == "shortcut":
            frm = int(o["from"])
            layer = Layer("shortcut", shape, shape, sources=(frm if frm >= 0 else i + frm,),
                          activation=o.get("activation", "linear"), options=o)
        elif kind == "yolo":
            flat = _floats(o["anchors"])
            layer = Layer("yolo", shape, shape, mask=_ints(o.get("mask", "0")),
                          anchors=tuple((flat[k], flat[k + 1]) for k in range(0, len(flat), 2)),
                          classes=int(o.get("classes", 20)), options=o)
        else:
            raise ValueError(f"section [{kind}] is not one the reference reads")
        layers.append(layer)
        shape = layer.out_shape
    return Network(w, h, c, layers)
