"""The plain reference of YOLOv4 (``configs/yolov4-coco80-608.json``):
``model.py``'s conversion, integer forward, decode and top-k, with what
YOLOv4 adds to them.

- mish on a conv's codes: the epilogue's float32 v = float32(acc) * m, as
  for every activation, rounded half to even to r (output-scale units),
  then clamp(round(mish(r s_o) / s_o) + z_o, 0, 255), mish in float64
  (x tanh(softplus(x)), softplus x above 20 and exp(x) below -20, darknet's
  src/activations.h), from a table over the r the tensor holds.  The
  rounding of the pre-activation is the program's written departure from a
  float mish of v itself (``assumed`` in the configuration), so the
  reference takes it too; every other number is its own;
- the SPP block (stride-1 maxpools of 5, 9 and 13 and a route over them)
  layer by layer: ``model.maxpool_codes`` and the route's requant, as for
  any maxpool and route;
- ``scale_x_y`` s of a ``[yolo]`` head in the float64 decode: bx = (col +
  s sig(tx) - (s - 1) / 2) / W, and likewise by (AlexeyAB's
  forward_yolo_layer).

It reads the .cfg with ``darknet_cfg.parse`` (a ``[yolo]`` keeps its
``scale_x_y`` and training keys among its options) and reuses ``model``'s
functions; it rebinds nothing of either, and imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import darknet_cfg, model

parse = darknet_cfg.parse
SATURATED = 1 << 20  # |r| beyond which mish's codes no longer change, at any s_o above 1e-4


def mish(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    soft = np.where(x > 20.0, x, np.where(x < -20.0, np.exp(x), np.log1p(np.exp(np.minimum(x, 20.0)))))
    return x * np.tanh(soft)


def convert(net, params: dict, ranges: dict, device, bits: int = 8) -> model.Program:
    """``model.convert``, each mish conv's arrays carrying its output scale
    as ``s_out``."""
    program = model.convert(net, params, ranges, device, bits)
    for i, layer in enumerate(net.layers):
        if layer.kind == "conv" and layer.activation == "mish":
            program.layers[i].s_out, _ = model.nudge(ranges[f"act_{i}"]["min"],
                                                     ranges[f"act_{i}"]["max"])
    return program


def mish_codes(r: torch.Tensor, s_out: float, z_out: int) -> torch.Tensor:
    """clamp(round(mish(r s_o) / s_o) + z_o, 0, 255) of integral float32 r,
    from a float64 table over the r present."""
    r = torch.clamp(r, -SATURATED, SATURATED).to(torch.int64)
    lo, hi = int(r.min()), int(r.max())
    grid = np.arange(lo, hi + 1, dtype=np.float64)
    table = np.clip(np.round(mish(grid * s_out) / s_out) + z_out, 0, 255)
    return torch.from_numpy(table).to(r.device)[r - lo]


def conv_codes(x: torch.Tensor, layer, a) -> torch.Tensor:
    """``model.conv_codes``, and mish by ``mish_codes``."""
    if layer.activation != "mish":
        return model.conv_codes(x, layer, a)
    xf = x.permute(0, 3, 1, 2).to(torch.float64) - a.z_in
    acc = F.conv2d(xf, a.w, stride=layer.stride, padding=layer.pad)
    vf = (acc + a.bias.reshape(1, -1, 1, 1)).to(torch.float32) * a.m.reshape(1, -1, 1, 1)
    q = mish_codes(torch.round(vf), a.s_out, a.z_out)
    return q.permute(0, 2, 3, 1).to(torch.int16).contiguous()


def heads(program: model.Program, frames: torch.Tensor) -> list[torch.Tensor]:
    """uint8 NHWC frames -> the dequantized float64 heads, one per [yolo]:
    ``model.heads``' forward, its convs by ``conv_codes``."""
    s_in, z_in = program.in_qp
    step = torch.tensor(float(np.float32(s_in * 255.0)), dtype=torch.float32, device=frames.device)
    x = torch.clamp(torch.round(frames.to(torch.float32) / step) + z_in, 0, 255).to(torch.int16)
    outs, found = [], []
    for i, layer in enumerate(program.net.layers):
        entry = program.layers[i]
        if layer.kind == "conv":
            y = conv_codes(x, layer, entry)
            if layer.quant_stop:
                s, z = entry.dequant
                y = (y.to(torch.float64) - z) * s
        elif layer.kind == "maxpool":
            y = model.maxpool_codes(x, layer)
        elif layer.kind == "upsample":
            y = x.repeat_interleave(layer.stride, 1).repeat_interleave(layer.stride, 2)
        elif layer.kind == "route":
            z_out = program.out_qp[i][1]
            parts = []
            for j, branch in zip(layer.sources, entry):
                t = outs[j]
                if branch is not None:
                    zb, ratio = branch
                    t = (t - zb).to(torch.float32) * ratio
                    t = torch.clamp(torch.round(t) + z_out, 0, 255).to(torch.int16)
                parts.append(t)
            y = torch.cat(parts, dim=-1)
        elif layer.kind == "shortcut":
            y = model.shortcut_codes(x, outs[layer.sources[0]], entry, layer.activation)
        elif layer.kind == "yolo":
            y = x
            found.append(x)
        outs.append(y)
        x = y
    return found


def decode(hs: list[torch.Tensor], net):
    """``model.decode`` with each head's ``scale_x_y``, in float64."""
    yolos = [layer for layer in net.layers if layer.kind == "yolo"]
    boxes, obj, cls = [], [], []
    for raw, layer in zip(hs, yolos):
        n, h, w, _ = raw.shape
        a = len(layer.mask)
        s = float(layer.options.get("scale_x_y", 1.0))
        r = raw.reshape(n, h, w, a, 5 + layer.classes)
        anchors = torch.tensor([layer.anchors[k] for k in layer.mask], dtype=torch.float64,
                               device=raw.device)
        col = torch.arange(w, dtype=torch.float64, device=raw.device).reshape(1, 1, w, 1)
        row = torch.arange(h, dtype=torch.float64, device=raw.device).reshape(1, h, 1, 1)
        bx = (col + s * torch.sigmoid(r[..., 0]) - (s - 1.0) / 2.0) / w
        by = (row + s * torch.sigmoid(r[..., 1]) - (s - 1.0) / 2.0) / h
        bw = torch.exp(r[..., 2]) * anchors[:, 0] / net.width
        bh = torch.exp(r[..., 3]) * anchors[:, 1] / net.height
        boxes.append(torch.stack([bx, by, bw, bh], dim=-1).reshape(n, -1, 4))
        obj.append(torch.sigmoid(r[..., 4]).reshape(n, -1))
        cls.append(torch.sigmoid(r[..., 5:]).reshape(n, h * w * a, layer.classes))
    return torch.cat(boxes, 1), torch.cat(obj, 1), torch.cat(cls, 1)


def _decoded(program: model.Program, frames: torch.Tensor):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        return decode(heads(program, frames), program.net)


def candidates(program: model.Program, frames: torch.Tensor, max_det: int, tie: float,
               block: int = 16) -> list[np.ndarray]:
    """``model.candidates`` over this reference's decode."""
    rows = []
    for b0 in range(0, frames.shape[0], block):
        boxes, obj, cls = _decoded(program, frames[b0:b0 + block])
        k = min(max_det, obj.shape[1])
        kth = torch.topk(obj, k, dim=1).values[:, -1]
        table = torch.cat([boxes, obj[..., None], cls], dim=-1)
        for n in range(obj.shape[0]):
            keep = obj[n] >= kth[n] - tie
            rows.append(table[n][keep].cpu().numpy())
    return rows


def answers(program: model.Program, frames: torch.Tensor, max_det: int, block: int = 16):
    """``model.answers`` over this reference's decode."""
    out = [], [], []
    for b0 in range(0, frames.shape[0], block):
        boxes, obj, cls = _decoded(program, frames[b0:b0 + block])
        _, idx = torch.sort(obj, dim=1, descending=True, stable=True)
        idx = idx[:, :min(max_det, obj.shape[1])]
        out[0].append(torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)))
        out[1].append(torch.gather(obj, 1, idx))
        out[2].append(torch.gather(cls, 1, idx[..., None].expand(-1, -1, cls.shape[2])))
    return tuple(torch.cat(t).to(torch.float32).cpu().numpy() for t in out)
