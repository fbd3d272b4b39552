"""Model zoo: yolov3-tiny and yolov3 as data.

The other builders of ``yolo_quantization_tpu/models/zoo.py`` (yolov2,
yolov1, classifiers) are not ported yet (ROADMAP queue 1.8).
"""

from __future__ import annotations

from yolo_quantization_tpu_torch.nn.graph import (
    ConvSpec,
    MaxPoolSpec,
    NetworkDef,
    RouteSpec,
    ShortcutSpec,
    UpsampleSpec,
    YoloSpec,
)

# Anchors from the reference quant cfg (cfg/yolov3_tiny_quant_channelwise.cfg)
NOK_TINY_ANCHORS = ((25, 39), (29, 88), (405, 102), (407, 109), (408, 113), (420, 129))
# Standard yolov3.cfg anchors
COCO_V3_ANCHORS = (
    (10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119),
    (116, 90), (156, 198), (373, 326),
)


def yolov3_tiny(
    classes: int = 5,
    activation: str = "relu6",
    anchors: tuple[tuple[float, float], ...] = NOK_TINY_ANCHORS,
    width: int = 416,
    height: int = 416,
    quantized: bool = True,
) -> NetworkDef:
    """The reference's 24-layer quantized yolov3-tiny (layer indices in comments)."""
    q = quantized
    head_filters = 3 * (4 + 1 + classes)
    c = lambda f, k=3, **kw: ConvSpec(  # noqa: E731
        filters=f, size=k, pad=1 if k == 3 else 0, activation=activation,
        quantized=q, **kw,
    )
    head = lambda: ConvSpec(  # noqa: E731
        filters=head_filters, size=1, pad=0, activation="linear",
        batch_normalize=False, quantized=q, quant_stop=True,
    )
    specs = (
        c(16),                                  # 0
        MaxPoolSpec(2, 2, quantized=q),         # 1
        c(32),                                  # 2
        MaxPoolSpec(2, 2, quantized=q),         # 3
        c(64),                                  # 4
        MaxPoolSpec(2, 2, quantized=q),         # 5
        c(128),                                 # 6
        MaxPoolSpec(2, 2, quantized=q),         # 7
        c(256),                                 # 8
        MaxPoolSpec(2, 2, quantized=q),         # 9
        c(512),                                 # 10
        MaxPoolSpec(2, 1, quantized=q),         # 11 (stride 1, SAME-ish pad)
        c(1024),                                # 12
        c(256, k=1),                            # 13
        c(512),                                 # 14
        head(),                                 # 15
        YoloSpec(mask=(3, 4, 5), anchors=anchors, classes=classes),  # 16
        RouteSpec(layers=(13,), quantized=q),   # 17  (cfg: layers = -4)
        c(128, k=1),                            # 18
        UpsampleSpec(2, quantized=q),           # 19
        RouteSpec(layers=(19, 8), quantized=q), # 20  (cfg: layers = -1, 8)
        c(256),                                 # 21
        head(),                                 # 22
        YoloSpec(mask=(0, 1, 2), anchors=anchors, classes=classes),  # 23
    )
    return NetworkDef(specs=specs, width=width, height=height)


def _v3_res_block(specs: list, filters: int, repeats: int, activation: str, q: bool):
    """darknet53 residual stage: downsample conv + n*(1x1 -> 3x3 -> shortcut)."""
    specs.append(ConvSpec(filters=filters, size=3, stride=2, pad=1,
                          activation=activation, quantized=q))
    for _ in range(repeats):
        specs.append(ConvSpec(filters=filters // 2, size=1, pad=0,
                              activation=activation, quantized=q))
        specs.append(ConvSpec(filters=filters, size=3, pad=1,
                              activation=activation, quantized=q))
        specs.append(ShortcutSpec(index=len(specs) - 3))


def yolov3(
    classes: int = 80,
    activation: str = "leaky",
    anchors: tuple[tuple[float, float], ...] = COCO_V3_ANCHORS,
    width: int = 416,
    height: int = 416,
    quantized: bool = True,
) -> NetworkDef:
    """Full YOLOv3 (darknet53 + 3-scale heads), topology of darknet yolov3.cfg:
    107 layers, 75 convs (5 of them stride 2), 23 integer shortcuts, 4
    routes, 2 upsamples and 3 yolo heads."""
    q = quantized
    head_filters = 3 * (4 + 1 + classes)
    s: list = []
    s.append(ConvSpec(filters=32, size=3, pad=1, activation=activation, quantized=q))
    _v3_res_block(s, 64, 1, activation, q)      # ends layer 4
    _v3_res_block(s, 128, 2, activation, q)     # ends layer 11
    _v3_res_block(s, 256, 8, activation, q)     # ends layer 36
    route_36 = len(s) - 1
    _v3_res_block(s, 512, 8, activation, q)     # ends layer 61
    route_61 = len(s) - 1
    _v3_res_block(s, 1024, 4, activation, q)    # ends layer 74

    def conv(f, k):
        return ConvSpec(filters=f, size=k, pad=1 if k == 3 else 0,
                        activation=activation, quantized=q)

    def head_conv():
        return ConvSpec(filters=head_filters, size=1, pad=0, activation="linear",
                        batch_normalize=False, quantized=q, quant_stop=True)

    # Scale 1 (13x13)
    for f, k in [(512, 1), (1024, 3), (512, 1), (1024, 3), (512, 1)]:
        s.append(conv(f, k))
    branch_1 = len(s) - 1
    s.append(conv(1024, 3))
    s.append(head_conv())
    s.append(YoloSpec(mask=(6, 7, 8), anchors=anchors, classes=classes))
    # Scale 2 (26x26)
    s.append(RouteSpec(layers=(branch_1,), quantized=q))
    s.append(conv(256, 1))
    s.append(UpsampleSpec(2, quantized=q))
    s.append(RouteSpec(layers=(len(s) - 1, route_61), quantized=q))
    for f, k in [(256, 1), (512, 3), (256, 1), (512, 3), (256, 1)]:
        s.append(conv(f, k))
    branch_2 = len(s) - 1
    s.append(conv(512, 3))
    s.append(head_conv())
    s.append(YoloSpec(mask=(3, 4, 5), anchors=anchors, classes=classes))
    # Scale 3 (52x52)
    s.append(RouteSpec(layers=(branch_2,), quantized=q))
    s.append(conv(128, 1))
    s.append(UpsampleSpec(2, quantized=q))
    s.append(RouteSpec(layers=(len(s) - 1, route_36), quantized=q))
    for f, k in [(128, 1), (256, 3), (128, 1), (256, 3), (128, 1), (256, 3)]:
        s.append(conv(f, k))
    s.append(head_conv())
    s.append(YoloSpec(mask=(0, 1, 2), anchors=anchors, classes=classes))

    return NetworkDef(specs=tuple(s), width=width, height=height)
