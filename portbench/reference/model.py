"""The plain reference: conversion, integer forward, decode and top-k.

Independent of the program: it reads the config's ``.cfg`` text with its
own parser (``darknet_cfg``), takes the benchmark's float weights and
activation ranges, and works out everything the program derives from them.

Conversion (per quantized conv), the affine uint8 scheme
real = s (q - z):

- each range widened to hold 0, s = (max - min) / 255, z = round(-min / s);
- BN folded as darknet does it, in float32 (inv = gamma / (sqrt(var) +
  1e-6), bias = beta - mean inv), the weights then scaled in float64;
- weights symmetric per output channel: s_w = max|w| / 127 (``bits=8``; 7
  with ``bits=4``, the control), codes round(w / s_w);
- bias codes round(bias / (s_in s_w)); multiplier m = float32(s_in s_w / s_o).

Integer forward, on uint8 codes:

- the input pixels p quantized as clamp(round(p / float32(255 s_in)) + z_in),
  a true float32 division;
- a conv's accumulator sum (q_x - z_x) w_q over the window, the padding
  contributing 0, computed as a float64 convolution (exact: every partial
  sum is an integer far below 2^53), plus the bias code;
- the epilogue in float32: v = float32(acc) * m, leaky's 0.1 slope before
  one round half to even, then z_o added and the code clamped (relu and
  relu6 from z_o);
- maxpool and upsample on codes (darknet's maxpool geometry); a route
  regrids each branch whose grid differs, round((q - z_b) float32(s_b / s_o))
  + z_o;
- the shortcut as the integer shortcut of the JAX package's engine, the
  published arithmetic of this scheme: on codes shifted by -128, in
  float32, each step rounded, t = q_x ra; t += q_k rb; t += c, with ra =
  s_x / s_o, rb = s_k / s_o, c = -(z_x - 128) ra - (z_k - 128) rb from
  float64; then the activation, one round and z_o;
- the quant_stop heads dequantized in float64, decoded in float64 (bx =
  (sig(tx) + col) / W, bw = exp(tw) a_w / net_w, objectness and classes
  by the sigmoid), candidates in head order, then cell, then anchor.

Nothing here imports the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.darknet_cfg import Network

TENTH = float(np.float32(0.1))
BN_EPS = 1e-6


def nudge(lo: float, hi: float) -> tuple[float, int]:
    lo, hi = min(float(lo), 0.0), max(float(hi), 0.0)
    span = hi - lo
    scale = (span if span > 0 else 1.0) / 255.0
    return scale, int(np.clip(np.round(-lo / scale), 0, 255))


@dataclass
class ConvArrays:
    w: torch.Tensor        # (Co, Ci, k, k) float64 weight codes
    bias: torch.Tensor     # (Co,) float64 bias codes
    m: torch.Tensor        # (Co,) float32 multipliers
    z_in: int
    z_out: int
    dequant: tuple | None = None   # (scale, zero point) of a quant_stop head


@dataclass
class Program:
    net: Network
    in_qp: tuple
    layers: list           # per layer: ConvArrays, a route's branches, shortcut constants or None
    out_qp: list           # per layer: (scale, zero point) of a uint8 output, else None


def fold(p: dict, bn: bool) -> tuple[np.ndarray, np.ndarray]:
    """(float64 HWIO weights, float64 bias) with BN folded in."""
    w = np.asarray(p["w"], np.float32)
    if not bn:
        return w.astype(np.float64), np.asarray(p["bias"], np.float32).astype(np.float64)
    gamma, var = np.asarray(p["gamma"], np.float32), np.asarray(p["var"], np.float32)
    inv = gamma / (np.sqrt(var) + np.float32(BN_EPS))
    bias = np.asarray(p["bias"], np.float32) - np.asarray(p["mean"], np.float32) * inv
    return w.astype(np.float64) * inv.astype(np.float64).reshape(1, 1, 1, -1), bias.astype(np.float64)


def convert(net: Network, params: dict, ranges: dict, device, bits: int = 8) -> Program:
    """The integer program from float weights and ranges; ``bits`` is the
    weight precision (8 as configured, 4 for the control)."""
    qmax = 2 ** (bits - 1) - 1
    in_qp = nudge(ranges["input"]["min"], ranges["input"]["max"])
    layers, out_qp = [], []
    cur = in_qp
    for i, layer in enumerate(net.layers):
        entry = None
        if layer.kind == "conv":
            if layer.options.get("quantized", "0") != "1":
                raise ValueError(f"layer {i}: the reference runs quantized convs only")
            w, bias = fold(params[i], layer.batch_normalize)
            absmax = np.abs(w).max(axis=(0, 1, 2))
            s_w = np.where(absmax > 0, absmax, 1.0) / qmax
            wq = np.clip(np.round(w / s_w.reshape(1, 1, 1, -1)), -qmax, qmax)
            s_in, z_in = cur
            s_out, z_out = nudge(ranges[f"act_{i}"]["min"], ranges[f"act_{i}"]["max"])
            bq = np.round(bias / (s_in * s_w))
            m = (s_in * s_w / s_out).astype(np.float32)
            entry = ConvArrays(
                w=torch.from_numpy(wq.transpose(3, 2, 0, 1).copy()).to(device),
                bias=torch.from_numpy(bq).to(device),
                m=torch.from_numpy(m).to(device),
                z_in=z_in, z_out=z_out, dequant=(s_out, z_out) if layer.quant_stop else None)
            cur = None if layer.quant_stop else (s_out, z_out)
        elif layer.kind == "route":
            srcs = [out_qp[j] for j in layer.sources]
            if len(srcs) == 1:
                cur = srcs[0]
                entry = [None]
            else:
                cur = nudge(ranges[f"act_{i}"]["min"], ranges[f"act_{i}"]["max"])
                entry = [None if qp == cur else (qp[1], float(np.float32(qp[0] / cur[0])))
                         for qp in srcs]
        elif layer.kind == "shortcut":
            qx, qk = cur, out_qp[layer.sources[0]]
            s_o, z_o = nudge(ranges[f"act_{i}"]["min"], ranges[f"act_{i}"]["max"])
            ra, rb = qx[0] / s_o, qk[0] / s_o
            entry = dict(ra=float(np.float32(ra)), rb=float(np.float32(rb)),
                         c=float(np.float32(-(qx[1] - 128) * ra - (qk[1] - 128) * rb)),
                         cap=float(np.float32(6.0 / s_o)), z_out=z_o)
            cur = (s_o, z_o)
        layers.append(entry)
        out_qp.append(cur if layer.kind != "yolo" else None)
    return Program(net, in_qp, layers, out_qp)


def conv_codes(x: torch.Tensor, layer, a: ConvArrays) -> torch.Tensor:
    """uint8 codes (N, H, W, Ci) -> the conv's codes (N, Ho, Wo, Co), int16."""
    xf = x.permute(0, 3, 1, 2).to(torch.float64) - a.z_in
    acc = F.conv2d(xf, a.w, stride=layer.stride, padding=layer.pad)
    vf = (acc + a.bias.reshape(1, -1, 1, 1)).to(torch.float32) * a.m.reshape(1, -1, 1, 1)
    if layer.activation == "leaky":
        vf = torch.where(vf < 0, vf * TENTH, vf)
    elif layer.activation not in ("linear", "relu", "relu6"):
        raise ValueError(f"activation {layer.activation!r} is not one the reference runs")
    lo = a.z_out if layer.activation in ("relu", "relu6") else 0
    q = torch.clamp(torch.round(vf) + a.z_out, lo, 255)
    return q.permute(0, 2, 3, 1).to(torch.int16).contiguous()


def maxpool_codes(x: torch.Tensor, layer) -> torch.Tensor:
    h = x.shape[1]
    out = (h + layer.pad - layer.size) // layer.stride + 1
    lo = layer.pad // 2
    hi = max(0, (out - 1) * layer.stride + layer.size - lo - h)
    xf = F.pad(x.permute(0, 3, 1, 2).to(torch.float32), (lo, hi, lo, hi), value=float("-inf"))
    y = F.max_pool2d(xf, kernel_size=layer.size, stride=layer.stride)
    return y.permute(0, 2, 3, 1).to(torch.int16).contiguous()


def shortcut_codes(x: torch.Tensor, skip: torch.Tensor, k: dict, activation: str) -> torch.Tensor:
    t = (x - 128).to(torch.float32) * k["ra"]
    t = t + (skip - 128).to(torch.float32) * k["rb"]
    t = t + k["c"]
    if activation == "leaky":
        t = torch.where(t < 0, t * TENTH, t)
    elif activation == "relu":
        t = torch.clamp(t, min=0.0)
    elif activation == "relu6":
        t = torch.clamp(t, 0.0, k["cap"])
    elif activation != "linear":
        raise ValueError(f"shortcut activation {activation!r} is not one the reference runs")
    return torch.clamp(torch.round(t) + k["z_out"], 0, 255).to(torch.int16)


def heads(program: Program, frames: torch.Tensor) -> list[torch.Tensor]:
    """uint8 NHWC frames -> the dequantized float64 heads, one per [yolo]."""
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
            y = maxpool_codes(x, layer)
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
            y = shortcut_codes(x, outs[layer.sources[0]], entry, layer.activation)
        elif layer.kind == "yolo":
            y = x
            found.append(x)
        outs.append(y)
        x = y
    return found


def decode(hs: list[torch.Tensor], net: Network):
    """Float64 (boxes (N, M, 4), objectness (N, M), classes (N, M, C))."""
    yolos = [layer for layer in net.layers if layer.kind == "yolo"]
    boxes, obj, cls = [], [], []
    for raw, layer in zip(hs, yolos):
        n, h, w, _ = raw.shape
        a = len(layer.mask)
        r = raw.reshape(n, h, w, a, 5 + layer.classes)
        anchors = torch.tensor([layer.anchors[k] for k in layer.mask], dtype=torch.float64,
                               device=raw.device)
        col = torch.arange(w, dtype=torch.float64, device=raw.device).reshape(1, 1, w, 1)
        row = torch.arange(h, dtype=torch.float64, device=raw.device).reshape(1, h, 1, 1)
        bx = (torch.sigmoid(r[..., 0]) + col) / w
        by = (torch.sigmoid(r[..., 1]) + row) / h
        bw = torch.exp(r[..., 2]) * anchors[:, 0] / net.width
        bh = torch.exp(r[..., 3]) * anchors[:, 1] / net.height
        boxes.append(torch.stack([bx, by, bw, bh], dim=-1).reshape(n, -1, 4))
        obj.append(torch.sigmoid(r[..., 4]).reshape(n, -1))
        cls.append(torch.sigmoid(r[..., 5:]).reshape(n, h * w * a, layer.classes))
    return torch.cat(boxes, 1), torch.cat(obj, 1), torch.cat(cls, 1)


def candidates(program: Program, frames: torch.Tensor, max_det: int, tie: float,
               block: int = 16) -> list[np.ndarray]:
    """Per image, the rows [bx, by, bw, bh, objectness, classes...] (float64,
    on the host) of every candidate whose objectness is within ``tie`` of the
    ``max_det``-th largest or above it: the reference's top-k, and the
    candidates an objectness that rounds differently could swap into it."""
    rows = []
    for b0 in range(0, frames.shape[0], block):
        with torch.no_grad():
            boxes, obj, cls = decode(heads(program, frames[b0:b0 + block]), program.net)
        k = min(max_det, obj.shape[1])
        kth = torch.topk(obj, k, dim=1).values[:, -1]
        table = torch.cat([boxes, obj[..., None], cls], dim=-1)
        for n in range(obj.shape[0]):
            keep = obj[n] >= kth[n] - tie
            rows.append(table[n][keep].cpu().numpy())
    return rows


def answers(program: Program, frames: torch.Tensor, max_det: int, block: int = 16):
    """The reference put in the program's place: (boxes, objectness, classes)
    of its top-k by objectness, as float32 numpy, the program's answer form."""
    out = [], [], []
    for b0 in range(0, frames.shape[0], block):
        with torch.no_grad():
            boxes, obj, cls = decode(heads(program, frames[b0:b0 + block]), program.net)
        val, idx = torch.sort(obj, dim=1, descending=True, stable=True)
        idx = idx[:, :min(max_det, obj.shape[1])]
        out[0].append(torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)))
        out[1].append(torch.gather(obj, 1, idx))
        out[2].append(torch.gather(cls, 1, idx[..., None].expand(-1, -1, cls.shape[2])))
    return tuple(torch.cat(t).to(torch.float32).cpu().numpy() for t in out)
