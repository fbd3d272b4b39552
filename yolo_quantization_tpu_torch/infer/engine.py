"""Integer inference engine: runs an IntProgram on a torch device.

The counterpart of ``yolo_quantization_tpu/infer/engine.py``: the float (or
uint8) NHWC image batch is quantized on the device to the shifted int8
representation (uint8 code - 128), every conv runs through a hand-written
CUDA kernel (``ops/cuda_qconv.py``, and with ``use_s2d`` the stem's
``ops/cuda_s2d.py``), every integer shortcut through another
(``ops/cuda_shortcut.py``), each with its plain PyTorch version on the CPU;
maxpool/route/upsample stay on codes, the quant_stop heads are dequantized,
and yolo decode + top-k run on the device before the host gets the result.
A conv's mish (YOLOv4) is its epilogue's table (``ops/qconv.py::mish_table``);
an SPP block (stride-1 pools over one map and the route that concatenates
them, ``spp_plan``) runs as one kernel on the card (``ops/cuda_spp.py``)
and as its layers off it.

Coverage: qconv (stride 1 and 2, any weights), maxpool, upsample, route
(with requant), the integer shortcut (int8 operands; linear, leaky, relu,
relu6), yolo; and the float kinds of mixed graphs (per-layer quantized=0):
the float conv, the float -> quant boundary before a quantized conv, the
float maxpool, the float route and shortcut, and the dequant -> add ->
requant shortcut for other activations; the ``simple`` kind (the extended
float layers of yolov2/yolov1 and the classifiers: reorg, connected,
dropout, softmax, the region and detection heads, ...), which dequantizes
an int8 input and runs ``nn/graph.py::apply_simple_layer``.  The options
``use_s2d``, ``dynamic_input``, ``exact_leaky``, ``carrier="int16"`` and
``fuse_pool=False`` (each planned conv+pool as the conv kernel then the
integer pool, so every layer keeps its own output); flip TTA and
``at_size``.

Under a profiler each stage of a request is a range of its own
(``utils/profiling.py::span``), on the thread that runs it:
``engine.predict_async`` (the enqueue) holds ``engine.input`` (the move to
the device, and flip's doubled batch), ``engine.quantize`` (the input to
int8 codes), ``engine.layers`` (every layer of the forward),
``engine.decode`` (the heads' decode, and flip's head averaging) and
``engine.topk``, and inside ``engine.layers`` ``engine.spp`` (each SPP
block); ``engine.resolve`` (the resolver) holds ``engine.wait``
(the batch's own event) and ``engine.copy`` (the answer to the host).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from yolo_quantization_tpu_torch.eval import detect
from yolo_quantization_tpu_torch.infer.convert import IntProgram
from yolo_quantization_tpu_torch.nn import layers as L
from yolo_quantization_tpu_torch.nn.graph import (
    HEAD_SPECS,
    DetectionSpec,
    MaxPoolSpec,
    RegionSpec,
    RouteSpec,
    ShortcutSpec,
    YoloSpec,
    apply_simple_layer,
)
from yolo_quantization_tpu_torch.ops import cuda_qconv, cuda_s2d, cuda_shortcut, cuda_spp
from yolo_quantization_tpu_torch.ops.qconv import ACT_MISH, ACTIVATION_BY_NAME
from yolo_quantization_tpu_torch.ops.shortcut import shortcut_params
from yolo_quantization_tpu_torch.utils.profiling import span

_DYNAMIC_INGREDIENTS = ("bias_f", "wsum_i32", "w_scale", "out_scale_f")


def _f32(v: float) -> float:
    """A Python float holding exactly the float32 value of ``v`` (so torch's
    scalar cast inside a float32 op is exact, like JAX's weak-typed scalars)."""
    return float(np.float32(v))


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """x / float32(v), correctly rounded on every device: CUDA turns a
    division by a host scalar into a multiply by its reciprocal, which can
    differ by an ulp; a divisor on the tensor's own device is divided."""
    return x / x.new_full((), _f32(v), dtype=torch.float32)


def _round_half_away(v: torch.Tensor) -> torch.Tensor:
    """C round() (half away from zero) in exact float32 ops: a - floor(a) is
    exact in float32, so the .5 comparison never suffers the rounding an
    |x| + 0.5 addition can."""
    a = torch.abs(v)
    f = torch.floor(a)
    r = f + (a - f >= 0.5).to(v.dtype)
    return torch.where(v < 0, -r, r)


def _dynamic_input_qp(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-image input (scale, zero_point) with the reference's float32
    arithmetic: min/max seeded at 0, scale = (max-min)/255, zp = round(-min/
    scale) clamped.  Returns ((N,) f32 scale, (N,) f32 integral zp)."""
    flat = x.reshape(x.shape[0], -1).to(torch.float32)
    mx = torch.clamp(flat.amax(dim=1), min=0.0)
    mn = torch.clamp(flat.amin(dim=1), max=0.0)
    scale = _div(mx - mn, 255.0)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    zp = torch.clamp(_round_half_away(0.0 - mn / scale), 0.0, 255.0)
    return scale, zp


def _quantize_input_dynamic(x: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor) -> torch.Tensor:
    """Float image -> shifted int8 codes with per-image (scale, zp), C round."""
    t = _round_half_away(x / scale[:, None, None, None]) + zp[:, None, None, None]
    return (torch.clamp(t, 0.0, 255.0) - 128.0).to(torch.int8)


def _dyn_bias_m(a, symmetric_w: bool, k_elems: int, dyn_scale: torch.Tensor,
                dyn_zp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer 0's per-image (N, O) int32 bias and multiplier, the runtime twin
    of the converter's bias fold and m.  The correction is evaluated in
    float32 with the reference's expression tree and only then cast: its
    products exceed 2^24, so integer arithmetic would round differently."""
    denom = dyn_scale[:, None] * a["w_scale"][None, :]
    bias_q = _round_half_away(a["bias_f"][None, :] / denom)
    zx = dyn_zp[:, None] - 128.0
    corr = -zx * a["wsum_i32"].to(torch.float32)
    if not symmetric_w:
        corr = corr + k_elems * zx * a["w_zp"].to(torch.float32)
    return (bias_q + corr).to(torch.int32), denom / a["out_scale_f"]


def _quantize_input(x: torch.Tensor, scale: float, zp: int) -> torch.Tensor:
    """Image floats -> shifted int8 codes: clamp(round(x/scale) + zp - 128)."""
    q = torch.round(_div(x, scale)) + (zp - 128)
    return torch.clamp(q, -128, 127).to(torch.int8)


def _dequant_i8(x_i8: torch.Tensor, scale: float, zp: int) -> torch.Tensor:
    """Shifted int8 codes -> float: (code - zp) * scale with code = x + 128."""
    return (x_i8.to(torch.float32) - (zp - 128)) * _f32(scale)


def fusion_plan(program: IntProgram) -> set[int]:
    """Convs whose following 2x2/s2 maxpool runs inside the conv kernel.

    Mirrors the reference engine's plan, with the kernel's own eligibility
    (stride 1, any weights, any Cin; the kernel fuses no pool at stride 2):
    not a quant_stop head, even output dims, the next layer a
    size-2/stride-2 pool, and no route or shortcut reading the conv's (never
    materialized) pre-pool output.  Asymmetric
    convs qualify: the pool is a max on the zero-point-corrected
    accumulators, and the epilogue is monotone in them (m > 0).  Mish convs
    do not: their epilogue is not monotone.
    """
    net, cfg = program.net, program.cfg
    shapes = net.shapes()
    referenced = set()
    for spec in net.specs:
        if isinstance(spec, RouteSpec):
            referenced.update(spec.layers)
        elif isinstance(spec, ShortcutSpec):
            referenced.add(spec.index)
    plan = set()
    for i, c in enumerate(cfg[:-1]):
        nxt = cfg[i + 1].spec
        oh, ow, _ = shapes[i]
        if (
            c.kind == "qconv" and c.spec.stride == 1
            and not c.quant_stop and c.act != ACT_MISH
            and oh % 2 == 0 and ow % 2 == 0
            and isinstance(nxt, MaxPoolSpec)
            and nxt.size == 2 and nxt.stride == 2 and nxt.padding == 1
            and i not in referenced
        ):
            plan.add(i)
    return plan


@dataclasses.dataclass(frozen=True)
class SppBlock:
    """An SPP block of ``spp_plan``: layers ``base`` + 1 .. ``route``, run as
    ``cuda_spp.spp_cuda(outputs[base], branches, out_zp)``, whose result is
    the route's output."""

    base: int
    route: int
    branches: tuple  # (size, identity, ratio, zp_in) in route order; size 1: the base itself
    out_zp: int


def _consumers(net) -> dict[int, set[int]]:
    """The layers that read each layer's output."""
    readers: dict[int, set[int]] = {}
    for i, spec in enumerate(net.specs):
        sources = spec.layers if isinstance(spec, RouteSpec) else (i - 1,)
        if isinstance(spec, ShortcutSpec):
            sources = (i - 1, spec.index)
        for j in sources:
            readers.setdefault(j, set()).add(i)
    return readers


def spp_plan(program: IntProgram) -> dict[int, SppBlock]:
    """SPP blocks, by their first layer: the engine runs each as one kernel
    on the card, and as its layers under one range off it.

    A block is a route over two or more layers whose sources are a base
    layer b and stride-1 maxpools of odd size >= 3 (darknet's default
    padding) over b; each pool reads b directly or through a single-layer
    route to b; every layer between b and the route is such a pool or such
    a route, and nothing outside the block reads them.  b and the route are
    on codes, and C is a multiple of 16 (the kernel's step).  YOLOv4's
    layers 108-113 are one: pools of 5, 9 and 13 over layer 107.  Pools
    outside such a block (yolov3-tiny's 2x2/s1) stay on ``maxpool_u8``."""
    net, cfg = program.net, program.cfg
    domains, shapes, readers = net.output_domains(), net.shapes(), _consumers(net)

    def to_base(j):  # through single-layer routes
        while cfg[j].kind == "route" and len(net.specs[j].layers) == 1:
            j = net.specs[j].layers[0]
        return j

    def pool_size(j):  # a stride-1 odd pool's size, else 1
        s = net.specs[j]
        ok = (cfg[j].kind == "maxpool" and s.stride == 1 and s.size >= 3 and s.size % 2
              and s.padding == s.size - 1 and j > 0)
        return s.size if ok else 1

    plan = {}
    for r, c in enumerate(cfg):
        s = c.spec
        if c.kind != "route" or len(s.layers) < 2 or domains[r] != "u8":
            continue
        sizes = [pool_size(j) for j in s.layers]
        bases = {to_base(j - 1) if size > 1 else j for j, size in zip(s.layers, sizes)}
        if len(bases) != 1 or max(sizes) == 1:
            continue
        b = bases.pop()
        if (cfg[b].kind == "route" and len(net.specs[b].layers) == 1) or domains[b] != "u8":
            continue
        inside = range(b + 1, r)
        pools = {j for j, size in zip(s.layers, sizes) if size > 1}
        if not all(j in pools or (cfg[j].kind == "route" and to_base(j) == b) for j in inside):
            continue
        if not all(j in inside and to_base(j - 1) == b for j in pools):
            continue
        if any(readers.get(j, set()) - set(inside) - {r} for j in inside):
            continue
        if shapes[b][2] % cuda_spp.CHANNEL_STEP or len(s.layers) > cuda_spp.MAX_BRANCHES:
            continue
        branches = tuple((size, identity, ratio, zb)
                         for size, (identity, ratio, zb) in zip(sizes, c.branches))
        plan[b + 1] = SppBlock(base=b, route=r, branches=branches, out_zp=int(c.out_zp))
    return plan


def device_arrays(program: IntProgram, device) -> dict[int, dict[str, torch.Tensor]]:
    """The program arrays the forward reads, as tensors on ``device``: each
    conv's weights, bias, m and weight zero points, the s2d block kernel
    where the converter made one, a mish conv's table, layer 0's
    ``dynamic_input`` ingredients,
    each float conv's folded float32 weights and bias, and the float params
    of the simple layers that have them (connected, local, ...).  On CUDA
    each quantized conv also carries its weights packed for the kernels."""
    device = torch.device(device)
    out: dict[int, dict[str, torch.Tensor]] = {}
    for i, c in enumerate(program.cfg):
        if c.kind in ("fconv", "simple") and i in program.arrays:
            out[i] = {name: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                      for name, a in program.arrays[i].items()}
        if c.kind != "qconv":
            continue
        a = program.arrays[i]
        names = (("w_i8", "bias_i32", "m", "w_zp", "w_s2d", "mish_table")
                 + (_DYNAMIC_INGREDIENTS if i == 0 else ()))
        t = {
            name: torch.from_numpy(np.ascontiguousarray(a[name])).to(device)
            for name in names if name in a
        }
        if device.type == "cuda":
            t["w_packed"] = cuda_qconv.pack_weights(t["w_i8"])
            if "w_s2d" in t:
                t["w_s2d_packed"] = cuda_s2d.pack_weights(t["w_s2d"])
        out[i] = t
    return out


def build_forward(program: IntProgram, return_outputs: bool = False, *,
                  use_s2d: bool = False, carrier: str = "int8",
                  dynamic_input: bool = False, exact_leaky: bool = False,
                  fuse_pool: bool = True, shard=None):
    """Return fn(arrays, x) -> heads, or (heads, per_layer_outputs) with
    ``return_outputs``.  ``arrays`` is ``device_arrays(program, device)``;
    x is a float32 [0,1] or uint8 NHWC batch on the same device.

    Layers in the conv+pool fusion plan emit the pooled tensor, and the
    fused pool's slot repeats it (the pre-pool tensor never exists);
    ``fuse_pool=False`` runs them as the conv then the integer pool, the
    reference's XLA layout, where every slot holds its own layer's output.
    With ``use_s2d`` every conv the converter marked ``s2d_pool`` runs the s2d
    stem kernel instead, and its slot holds the pooled tensor likewise.
    ``dynamic_input`` quantizes the input per image and rebuilds layer 0's
    bias and m per image; ``exact_leaky`` is darknet's double-rounded leaky;
    ``carrier="int16"`` runs every conv with 16-bit operands (same bits).
    ``shard(i, run)``, where given, runs quantized conv i: ``run(a)`` is the
    conv on layer arrays ``a`` (its weights, bias, m and zero points, or a
    slice of their output channels), and ``shard`` returns the whole
    output: tensor parallelism runs it on channel shards and joins them
    (``parallel/tp.py``).
    """
    if carrier not in ("int8", "int16"):
        raise ValueError(f"unsupported conv carrier {carrier!r}")
    if use_s2d and carrier != "int8":
        # K2 contracts int8 operands only, as the Pallas kernel it replaces;
        # running it would skip the carrier's purpose as a cross-check
        raise ValueError("use_s2d supports carrier='int8' only")
    cfg = program.cfg
    if dynamic_input:
        if cfg[0].kind != "qconv":
            raise ValueError("dynamic_input requires a quantized conv as layer 0")
        missing = set(_DYNAMIC_INGREDIENTS) - set(program.arrays.get(0, {}))
        if missing:
            raise ValueError(
                f"program predates dynamic_input support (layer 0 lacks "
                f"{sorted(missing)}); re-run convert() to regenerate it"
            )
    fused = fusion_plan(program) if fuse_pool else set()
    # an SPP block's pools and routes never exist apart on the card: with
    # return_outputs every slot holds its own layer's output, so the block
    # runs layer by layer, as it does off the card, where there is no kernel
    spp = spp_plan(program) if fuse_pool and not return_outputs else {}
    s2d = {i for i, c in enumerate(cfg) if c.s2d_pool} if use_s2d else set()
    # per-layer scalars stay host ints: reading them from device would sync
    x_zp = {i: int(program.arrays[i]["x_zp"]) for i, c in enumerate(cfg) if c.kind == "qconv"}
    k_elems0 = int(np.prod(program.arrays[0]["w_i8"].shape[:3])) if dynamic_input else 0
    mish_lo = {i: int(program.arrays[i]["mish_lo"]) for i, c in enumerate(cfg)
               if c.kind == "qconv" and c.act == ACT_MISH}
    # each integer shortcut's float32 constants, from float64 on the host
    # (the kernel takes the epilogue's activations; others run dequant ->
    # float add -> requant)
    shortcuts = {
        i: shortcut_params(*c.in_scales, c.out_scale, c.out_zp, c.spec.activation)
        for i, c in enumerate(cfg)
        if c.kind == "shortcut" and c.spec.activation in ACTIVATION_BY_NAME
    }

    def conv(i, c, a, x, zp, bias, m):
        s = c.spec
        if x.dtype != torch.int8:
            # float -> quant boundary (mixed graphs): quantize the input
            # with the QAT-tracked boundary range
            qp = c.in_scales[0]
            x = _quantize_input(x, qp[0], qp[1])
        if i in s2d:
            return cuda_s2d.s2d_conv_phase_max_cuda(
                x, a["w_s2d"], bias, m, zp, act=c.act, out_zp_static=int(c.out_zp),
                w_packed=a.get("w_s2d_packed"), exact_leaky=exact_leaky,
            )
        return cuda_qconv.quantized_conv2d_cuda(
            x, a["w_i8"], bias, m, zp, stride=s.stride, pad=s.pad, act=c.act,
            out_zp_static=int(c.out_zp), fuse_pool=i in fused, out_i8=True,
            w_packed=a.get("w_packed"), w_zp=None if c.symmetric_w else a["w_zp"],
            carrier=carrier, exact_leaky=exact_leaky,
            mish=(a["mish_table"], mish_lo[i]) if i in mish_lo else None,
        )

    def forward(arrays, x):
        dyn = None
        on_card = x.is_cuda
        with span("engine.quantize"):
            if x.dtype == torch.uint8:
                if dynamic_input:
                    x = x.to(torch.float32) * _f32(1.0 / 255.0)
                else:
                    # raw pixel codes: fold the /255 normalization into the scale
                    x = _quantize_input(x.to(torch.float32), program.in_scale * 255.0,
                                        program.in_zp)
            if dynamic_input:
                scale, zp = _dynamic_input_qp(x)
                x = _quantize_input_dynamic(x, scale, zp)
                dyn = (scale, zp)
            elif x.dtype != torch.int8:
                x = _quantize_input(x, program.in_scale, program.in_zp)
        # the loop stays in this frame: the input codes are freed once
        # layer 0 has read them
        with span("engine.layers"), contextlib.ExitStack() as in_block:
            outputs = []
            heads = []
            skip_next = False
            block = None  # the SPP block being passed, under its range until its route
            block_out = None  # on the card, the block's kernel output, for its route's slot
            for i, c in enumerate(cfg):
                s = c.spec
                if skip_next:  # this maxpool ran inside the previous conv kernel
                    skip_next = False
                    outputs.append(outputs[-1])
                    continue
                if i in spp:
                    block = spp[i]
                    in_block.enter_context(span("engine.spp"))
                    if on_card:
                        block_out = cuda_spp.spp_cuda(outputs[block.base], block.branches,
                                                      block.out_zp)
                if block_out is not None:
                    if i < block.route:  # a pool or route of the block: never read
                        outputs.append(None)
                        continue
                    y, block_out = block_out, None
                elif c.kind == "qconv":
                    def run(a, i=i, c=c, x=x):
                        if dyn is not None and i == 0:
                            bias, m = _dyn_bias_m(a, c.symmetric_w, k_elems0, *dyn)
                            return conv(i, c, a, x, (dyn[1] - 128.0).to(torch.int32), bias, m)
                        return conv(i, c, a, x, x_zp[i], a["bias_i32"], a["m"])

                    y = run(arrays[i]) if shard is None else shard(i, run)
                    skip_next = i in fused or i in s2d
                    if c.quant_stop:
                        y = _dequant_i8(y, c.out_scale, c.out_zp)
                elif c.kind == "fconv":
                    # float conv (per-layer quantized=0)
                    a = arrays[i]
                    if x.dtype == torch.int8:
                        qp = c.in_scales[0]
                        x = _dequant_i8(x, qp[0], qp[1])
                    y = L.conv2d(x, a["w_f32"], s.stride, s.pad)
                    y = L.activate(y + a["bias_f32"].reshape(1, 1, 1, -1),
                                   s.activation).contiguous()
                elif c.kind == "maxpool":
                    if x.dtype == torch.int8:
                        y = L.maxpool_u8(x, s.size, s.stride, s.padding)
                    else:
                        y = L.maxpool(x, s.size, s.stride, s.padding).contiguous()
                elif c.kind == "upsample":
                    y = L.upsample_nearest(x, s.stride)
                elif c.kind == "route":
                    parts = []
                    for (j, (identity, ratio, zp_in)) in zip(s.layers, c.branches):
                        t = outputs[j]
                        if not identity:
                            t = L.requant_i8(t, ratio, zp_in, c.out_zp)
                        parts.append(t)
                    y = torch.cat(parts, dim=-1)
                elif c.kind == "route_f32":
                    parts = []
                    for (j, qp) in zip(s.layers, c.branches):
                        t = outputs[j]
                        if t.dtype == torch.int8:
                            t = _dequant_i8(t, qp[0], qp[1])
                        parts.append(t)
                    y = torch.cat(parts, dim=-1)
                elif c.kind in ("shortcut", "shortcut_f32"):
                    skip = outputs[s.index]
                    if (c.kind == "shortcut" and x.dtype == torch.int8 and skip.dtype == torch.int8
                            and i in shortcuts):
                        y = cuda_shortcut.int_shortcut_cuda(x, skip, shortcuts[i])
                    else:
                        # dequant -> float add + activation -> requant (or stay
                        # float for shortcut_f32)
                        qp_x, qp_k = c.in_scales
                        fx = _dequant_i8(x, qp_x[0], qp_x[1]) if x.dtype == torch.int8 else x
                        fk = (_dequant_i8(skip, qp_k[0], qp_k[1]) if skip.dtype == torch.int8
                              else skip)
                        y = L.activate(fx + fk, s.activation)
                        if c.kind == "shortcut":
                            y = _quantize_input(y, c.out_scale, c.out_zp)
                elif c.kind == "yolo":
                    if x.dtype == torch.int8:
                        # quantized pre-head conv without quant_stop
                        x = _dequant_i8(x, c.out_scale, c.out_zp)
                    y = x
                    heads.append(x)
                elif c.kind == "simple":
                    if x.dtype == torch.int8:
                        qp = c.in_scales[0]
                        x = _dequant_i8(x, qp[0], qp[1])
                    y = apply_simple_layer(s, arrays.get(i), x, train=False).contiguous()
                    if isinstance(s, (RegionSpec, DetectionSpec)):
                        heads.append(y)
                else:
                    raise ValueError(c.kind)
                outputs.append(y)
                x = y
                if block is not None and i == block.route:
                    in_block.close()  # the block's range ends with its route
                    block = None
            if return_outputs:
                return heads, outputs
            return heads

    return forward


class Engine:
    """Batched quantized-inference engine for one converted program on one
    torch device: the GPU unless ``device`` says otherwise (``"cpu"`` runs
    the plain versions of the kernels).

    predict() runs image batch -> decoded (boxes, objectness, class_probs)
    top-k on the device and copies only that to the host.  ``approx_topk``
    is accepted for the reference's API and runs the exact stable top-k: the
    reference's approximate top-k is a TPU primitive with no CUDA
    counterpart, and the exact sort costs little here.
    """

    def __init__(self, program: IntProgram, max_det: int = 256, device=None,
                 carrier: str = "int8", use_s2d: bool = False,
                 dynamic_input: bool = False, approx_topk: bool = False,
                 exact_leaky: bool = False, fuse_pool: bool = True, arrays=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Engine runs on the GPU unless asked otherwise, and "
                    "torch.cuda.is_available() is false; pass device='cpu' "
                    "to run the plain versions on the CPU"
                )
            device = "cuda"
        self.program = program
        self.max_det = max_det
        self.device = torch.device(device)
        del approx_topk  # accepted for the reference's API: the top-k is exact
        self.options = dict(use_s2d=use_s2d, carrier=carrier, dynamic_input=dynamic_input,
                            exact_leaky=exact_leaky, fuse_pool=fuse_pool)
        self._fwd = build_forward(program, **self.options)
        self._fwd_all = build_forward(program, return_outputs=True, **self.options)
        # ``arrays``: device arrays to share (the at_size cache)
        self.arrays = arrays if arrays is not None else device_arrays(program, self.device)
        self._head_specs = [s for s in program.net.specs if isinstance(s, HEAD_SPECS)]
        # on the device before the first request, so the enqueue never waits
        self._anchors = detect.head_anchors(program.net, self.device)
        self._size_cache: dict[tuple[int, int], Engine] = {}

    def at_size(self, height: int, width: int | None = None) -> "Engine":
        """The engine for another input resolution, cached per size.  The
        integer program is shape-free, so each size shares this engine's
        device arrays; the native size returns ``self``."""
        width = width or height
        net = self.program.net
        if (height, width) == (net.height, net.width):
            return self
        if height % 32 or width % 32:
            raise ValueError(
                f"input size must be a multiple of 32 (yolo head grids), got {height}x{width}"
            )
        eng = self._size_cache.get((height, width))
        if eng is None:
            prog = dataclasses.replace(
                self.program, net=dataclasses.replace(net, height=height, width=width))
            eng = Engine(prog, max_det=self.max_det, device=self.device,
                         arrays=self.arrays, **self.options)
            self._size_cache[(height, width)] = eng
        return eng

    def _input(self, images) -> torch.Tensor:
        """numpy images, or a tensor on any device (moved to the engine's)."""
        net = self.program.net
        if tuple(images.shape[1:]) != (net.height, net.width, net.channels):
            raise ValueError(
                f"engine expects {(net.height, net.width, net.channels)} images, "
                f"got {tuple(images.shape[1:])}; letterbox to the network size first"
            )
        if isinstance(images, torch.Tensor):
            if images.dtype not in (torch.float32, torch.uint8):
                raise ValueError(f"images must be float32 or uint8, got {images.dtype}")
            return images.to(self.device).contiguous()
        if images.dtype not in (np.float32, np.uint8):
            raise ValueError(f"images must be float32 or uint8, got {images.dtype}")
        return torch.from_numpy(np.ascontiguousarray(images)).to(self.device)

    def _batch(self, images, flip: bool) -> torch.Tensor:
        """The forward's input on the device; with ``flip``, the batch and
        its mirror in one doubled batch."""
        with span("engine.input"):
            x = self._input(images)
            return torch.cat([x, x.flip(2)]) if flip else x

    def _run(self, images: np.ndarray, flip: bool):
        with torch.inference_mode():
            n = images.shape[0]
            # no name here holds the batch: the forward frees it after layer 0
            heads = self._fwd(self.arrays, self._batch(images, flip))
            with span("engine.decode"):
                # flip TTA: the raw yolo heads averaged over the pair; other
                # heads keep the unflipped one
                if flip:
                    heads = [
                        detect.flip_average_head(h[:n], h[n:], spec.classes)
                        if isinstance(spec, YoloSpec) else h[:n]
                        for h, spec in zip(heads, self._head_specs)
                    ]
                boxes, obj, cls = detect.decode_all_heads(heads, self.program.net, self._anchors)
            with span("engine.topk"):
                return detect.top_k_detections(boxes, obj, cls, self.max_det)

    def predict(self, images: np.ndarray, flip: bool = False):
        """images: (N, H, W, 3) float32 letterboxed to the network size, or
        uint8 pixel codes; numpy, or a tensor (one already on the card is
        not copied).  ``flip`` averages the yolo heads over the horizontal
        mirror (the reference's `detector valid2`).  Returns numpy
        (boxes, obj, cls) top-k."""
        return self.predict_async(images, flip=flip)()

    def predict_async(self, images: np.ndarray, flip: bool = False):
        """Enqueue a batch on the current CUDA stream and return a zero-arg
        resolver that waits for it and copies (boxes, obj, cls) to the host."""
        with span("engine.predict_async"):
            outs = self._run(images, flip)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))

            def resolve():
                with span("engine.resolve"):
                    with span("engine.wait"):
                        if done is not None:
                            done.synchronize()
                    with span("engine.copy"):
                        return tuple(t.cpu().numpy() for t in outs)

            return resolve

    def raw_heads(self, images: np.ndarray, return_outputs: bool = False):
        """The dequantized head tensors as numpy; with ``return_outputs``
        also every layer's output (int8 codes for integer layers)."""
        with torch.inference_mode():
            if return_outputs:
                heads, outputs = self._fwd_all(self.arrays, self._input(images))
                return ([h.cpu().numpy() for h in heads],
                        [o.cpu().numpy() for o in outputs])
            heads = self._fwd(self.arrays, self._input(images))
            return [h.cpu().numpy() for h in heads]
