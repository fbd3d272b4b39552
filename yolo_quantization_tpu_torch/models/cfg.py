"""darknet .cfg importer: ini-style model files -> NetworkDef + TrainConfig.

The counterpart of ``yolo_quantization_tpu/models/cfg.py``: darknet's cfg
dialect (every section kind of the graph, the per-layer ``quantized=`` /
``quant_stop=`` / ``first_time=`` flags, the [net] training options) read
into the port's specs and ``train/qat.py::TrainConfig``.  Relative layer
references ([route] layers=-4, [shortcut] from=-3) become absolute indices.
A ``tree=`` option (WordTree softmax and region heads) is read with
``core/tree.py::read_tree``, relative to the cfg's directory.
"""

from __future__ import annotations

import os

from yolo_quantization_tpu_torch.core.tree import read_tree
from yolo_quantization_tpu_torch.nn.graph import (
    ActivationSpec,
    AvgPoolSpec,
    BatchNormSpec,
    ConnectedSpec,
    ConvSpec,
    CropSpec,
    DeconvSpec,
    DetectionSpec,
    DropoutSpec,
    L2NormSpec,
    LRNSpec,
    LocalSpec,
    LogisticSpec,
    MaxPoolSpec,
    NetworkDef,
    RegionSpec,
    ReorgSpec,
    RouteSpec,
    ShortcutSpec,
    SoftmaxSpec,
    UpsampleSpec,
    YoloSpec,
)
from yolo_quantization_tpu_torch.train.qat import TrainConfig

_ACT_MAP = {  # every darknet cfg activation name (src/activations.c get_activation)
    name: name
    for name in (
        "linear", "leaky", "relu", "relu6", "leaky6", "logistic", "loggy",
        "relie", "ramp", "tanh", "elu", "selu", "plse", "stair", "hardtan",
        "lhtan",
    )
}


def read_cfg_sections(text: str) -> list[tuple[str, dict[str, str]]]:
    """[section] blocks of key=value lines, comments (#, ;) stripped."""
    sections: list[tuple[str, dict[str, str]]] = []
    cur: dict[str, str] | None = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line[0] in "#;":
            continue
        if line.startswith("["):
            cur = {}
            sections.append((line.strip("[]").lower(), cur))
        elif "=" in line and cur is not None:
            k, v = line.split("=", 1)
            cur[k.strip()] = v.strip()
    return sections


def _ints(v: str) -> tuple[int, ...]:
    return tuple(int(x) for x in v.replace(" ", "").split(",") if x != "")


def _floats(v: str) -> tuple[float, ...]:
    return tuple(float(x) for x in v.replace(" ", "").split(",") if x != "")


def _load_tree(opts: dict[str, str], base_dir: str | None):
    """A section's ``tree=`` option (src/parser.c:223-224, 323-324): None
    when absent; a relative path is resolved against ``base_dir``."""
    tree_file = opts.get("tree")
    if not tree_file:
        return None
    if base_dir and not os.path.isabs(tree_file):
        tree_file = os.path.join(base_dir, tree_file)
    return read_tree(tree_file)


def parse_cfg(text: str, base_dir: str | None = None) -> tuple[NetworkDef, TrainConfig]:
    """cfg text -> (NetworkDef, TrainConfig); ``base_dir`` resolves relative
    file options (``tree=``)."""
    sections = read_cfg_sections(text)
    if not sections or sections[0][0] not in ("net", "network"):
        raise ValueError("cfg must start with a [net] section")
    net_opts = sections[0][1]
    width = int(net_opts.get("width", 416))
    height = int(net_opts.get("height", 416))
    channels = int(net_opts.get("channels", 3))

    train_cfg = TrainConfig(
        learning_rate=float(net_opts.get("learning_rate", 1e-3)),
        momentum=float(net_opts.get("momentum", 0.9)),
        weight_decay=float(net_opts.get("decay", 5e-4)),
        burn_in=int(net_opts.get("burn_in", 0)),
        max_batches=int(net_opts.get("max_batches", 500000)),
        policy=net_opts.get("policy", "constant"),
        lr_steps=_ints(net_opts.get("steps", "")) if "steps" in net_opts else (),
        lr_scales=_floats(net_opts.get("scales", "")) if "scales" in net_opts else (),
        power=float(net_opts.get("power", 4)),
        gamma=float(net_opts.get("gamma", 1)),
        lr_step=int(net_opts.get("step", 1)),
        lr_scale=float(net_opts.get("scale", 1)),
        quant_start_step=int(net_opts.get("start_quantization_step", 10**9)),
        batch_size=int(net_opts.get("batch", 1)),
        adam=bool(int(net_opts.get("adam", 0))),
        adam_b1=float(net_opts.get("B1", 0.9)),
        adam_b2=float(net_opts.get("B2", 0.999)),
        input_calibration=_floats(net_opts.get("input_calibration", "")),
    )

    specs = []
    for name, opts in sections[1:]:
        i = len(specs)  # index this layer will get

        def flag(key, default=0):
            return bool(int(opts.get(key, default)))

        if name == "convolutional":
            size = int(opts.get("size", 1))
            # darknet: pad flag means size//2 (src/parser.c:166-168)
            pad = size // 2 if flag("pad") else int(opts.get("padding", 0))
            specs.append(
                ConvSpec(
                    filters=int(opts.get("filters", 1)),
                    size=size,
                    stride=int(opts.get("stride", 1)),
                    pad=pad,
                    activation=_ACT_MAP[opts.get("activation", "logistic")],
                    batch_normalize=flag("batch_normalize"),
                    quantized=flag("quantized"),
                    quant_stop=flag("quant_stop"),
                )
            )
        elif name == "maxpool":
            size = int(opts.get("size", 1))
            stride = int(opts.get("stride", 1))  # darknet default, src/parser.c parse_maxpool
            pad = int(opts.get("padding", size - 1))
            specs.append(
                MaxPoolSpec(
                    size=size,
                    stride=stride,
                    pad=None if pad == size - 1 else pad,  # None = darknet default
                    quantized=flag("quantized"),
                )
            )
        elif name == "upsample":
            specs.append(
                UpsampleSpec(
                    stride=int(opts.get("stride", 2)),
                    quantized=flag("quantized"),
                    first_time=flag("first_time"),
                )
            )
        elif name == "route":
            rel = _ints(opts["layers"])
            absolute = tuple(r if r >= 0 else i + r for r in rel)
            specs.append(
                RouteSpec(
                    layers=absolute,
                    quantized=flag("quantized"),
                    first_time=flag("first_time"),
                )
            )
        elif name == "shortcut":
            frm = int(opts["from"])
            specs.append(
                ShortcutSpec(
                    index=frm if frm >= 0 else i + frm,
                    activation=_ACT_MAP[opts.get("activation", "linear")],
                )
            )
        elif name == "yolo":
            flat = _floats(opts["anchors"])
            anchors = tuple((flat[j], flat[j + 1]) for j in range(0, len(flat), 2))
            specs.append(
                YoloSpec(
                    mask=_ints(opts.get("mask", "0")),
                    anchors=anchors,
                    classes=int(opts.get("classes", 20)),
                )
            )
        elif name == "region":
            flat = _floats(opts.get("anchors", ""))
            anchors = tuple((flat[j], flat[j + 1]) for j in range(0, len(flat), 2))
            specs.append(
                RegionSpec(
                    anchors=anchors,
                    classes=int(opts.get("classes", 20)),
                    num=int(opts.get("num", len(anchors) or 5)),
                    softmax=flag("softmax", 0),
                    tree=_load_tree(opts, base_dir),
                    object_scale=float(opts.get("object_scale", 1)),
                    noobject_scale=float(opts.get("noobject_scale", 1)),
                    class_scale=float(opts.get("class_scale", 1)),
                    coord_scale=float(opts.get("coord_scale", 1)),
                    rescore=flag("rescore", 0),
                    thresh=float(opts.get("thresh", 0.5)),
                )
            )
        elif name == "detection":
            specs.append(
                DetectionSpec(
                    classes=int(opts.get("classes", 20)),
                    num=int(opts.get("num", 2)),
                    side=int(opts.get("side", 7)),
                    coords=int(opts.get("coords", 4)),
                    sqrt=flag("sqrt", 0),
                    rescore=flag("rescore", 0),
                    softmax=flag("softmax", 0),
                    forced=flag("forced", 0),
                    random=flag("random", 0),
                    object_scale=float(opts.get("object_scale", 1)),
                    noobject_scale=float(opts.get("noobject_scale", 1)),
                    class_scale=float(opts.get("class_scale", 1)),
                    coord_scale=float(opts.get("coord_scale", 1)),
                )
            )
        elif name == "connected":
            specs.append(
                ConnectedSpec(
                    outputs=int(opts.get("output", 1)),
                    activation=_ACT_MAP[opts.get("activation", "logistic")],
                    batch_normalize=flag("batch_normalize"),
                )
            )
        elif name == "softmax":
            specs.append(
                SoftmaxSpec(
                    groups=int(opts.get("groups", 1)),
                    temperature=float(opts.get("temperature", 1)),
                    tree=_load_tree(opts, base_dir),
                )
            )
        elif name == "avgpool":
            specs.append(AvgPoolSpec())
        elif name == "dropout":
            specs.append(DropoutSpec(probability=float(opts.get("probability", 0.5))))
        elif name == "crop":
            specs.append(
                CropSpec(
                    crop_height=int(opts.get("crop_height", 1)),
                    crop_width=int(opts.get("crop_width", 1)),
                    flip=flag("flip"),
                )
            )
        elif name == "local":
            size = int(opts.get("size", 1))
            specs.append(
                LocalSpec(
                    filters=int(opts.get("filters", 1)),
                    size=size,
                    stride=int(opts.get("stride", 1)),
                    pad=size // 2 if flag("pad") else 0,
                    activation=_ACT_MAP[opts.get("activation", "logistic")],
                )
            )
        elif name == "deconvolutional":
            specs.append(
                DeconvSpec(
                    filters=int(opts.get("filters", 1)),
                    size=int(opts.get("size", 1)),
                    stride=int(opts.get("stride", 1)),
                    activation=_ACT_MAP[opts.get("activation", "logistic")],
                    batch_normalize=flag("batch_normalize"),
                )
            )
        elif name == "reorg":
            specs.append(
                ReorgSpec(
                    stride=int(opts.get("stride", 1)), reverse=flag("reverse")
                )
            )
        elif name in ("normalization", "lrn"):
            specs.append(
                LRNSpec(
                    size=int(opts.get("size", 5)),
                    alpha=float(opts.get("alpha", 0.0001)),
                    beta=float(opts.get("beta", 0.75)),
                    kappa=float(opts.get("kappa", 1.0)),
                )
            )
        elif name == "l2norm":
            specs.append(L2NormSpec())
        elif name == "logistic":
            specs.append(LogisticSpec())
        elif name == "activation":
            specs.append(ActivationSpec(activation=_ACT_MAP[opts.get("activation", "linear")]))
        elif name == "batchnorm":
            specs.append(BatchNormSpec())
        else:
            raise NotImplementedError(f"cfg section [{name}] not supported")

    return NetworkDef(tuple(specs), width=width, height=height, channels=channels), train_cfg


def load_cfg(path: str) -> tuple[NetworkDef, TrainConfig]:
    """``parse_cfg`` of a cfg file."""
    with open(path) as f:
        return parse_cfg(f.read(), base_dir=os.path.dirname(os.path.abspath(path)))
