"""Timings of the hand-written kernels and the engines on one GPU.

    python -m yolo_quantization_tpu_torch.tools.kernel_timings

A kernel's time is its device time: 20 calls captured in one CUDA graph,
replayed between CUDA events, so the wrapper's host cost (Python checks,
ctypes) is left out; the eager back-to-back time, which includes that host
cost, is printed beside it.  K1's convs that its wgmma or halo design
can run are timed in both designs in turns (routed, other, other, routed;
the other forced by the wrapper's private ``_design``), and the halo
design's convs on the four models beside their bounds (``time_k1_halo``).  Per-layer K1 vs plain (and
``torch._int_mm``,
graph-timed, on the 1x1 layers its shape rules allow) on the flagship's 13
convs and on yolov3's five stride-2 convs, K2 by design vs K1's fused stem
per layer (``time_k2_stem``),
the shortcut kernel on one shortcut of each yolov3 stage vs its plain
chain, ``spp_kernel`` on YOLOv4's SPP block vs the plain block, device forwards of the engines at batch 1, 16 and 64 (eager, CUDA
events; yolov3, yolov2-tiny and yolov2 at 16 and 64), K1 on the yolov2
family's new shapes (the large-K 13x13 convs, the passthrough 1x1 and the
125-channel head), yolov3's stride-1 convs at batch 16 and 64, the probe
cases vs ``torch._int_mm``.  Each time sits beside its bound.  Prints,
checks nothing.

``chip_smoke.py`` runs ``time_all`` as its last phase.  Run alone, the
module builds the kernels and the engines itself; copied into another
checkout whose wrappers take the same arguments (``cuda_qconv.forcible``
and ``design(..., pad=, w=)`` included), it times that checkout's kernels
with the same code, which is how two versions are compared on one card.
Imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

# flagship conv layers (yolov3-tiny at 416) in layer order
FLAGSHIP_CONVS = (0, 2, 4, 6, 8, 10, 12, 13, 14, 15, 18, 21, 22)
S2D_LAYERS = (0, 2, 4)
# one shortcut of each of yolov3's five stages (the stage's first)
V3_SHORTCUTS = (4, 8, 15, 40, 65)
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): int8 tensor cores, HBM3
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_identity() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time on the card: the larger of bytes over HBM rate and int8
    operations over the tensor-core peak."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_INT8_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def int_mm_ok(m: int, k: int, n: int) -> bool:
    """torch._int_mm's CUDA shape rules: m > 16, k and n multiples of 8."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


def random_layer(rng, n, h, w, ci, co, k):
    """Seeded codes, weights, bias and multipliers with outputs spread over
    the code range (acc std ~ sqrt(K*K*Ci) * 73^2)."""
    x = rng.integers(-128, 128, (n, h, w, ci), dtype=np.int8)
    wt = rng.integers(-127, 128, (k, k, ci, co)).astype(np.int8)
    bias = rng.integers(-(2**14), 2**14, (co,)).astype(np.int32)
    m = (rng.uniform(0.5, 2.0, (co,)) * 40.0 / (np.sqrt(k * k * ci) * 5300.0)).astype(np.float32)
    return x, wt, bias, m


def designs(cuda_qconv, ci: int, k: int, co: int, pad: int, w: int) -> tuple:
    """The ``_design`` values to time a conv under: the routed one first,
    then the other one the wrapper may force (mma.sync, or the design that
    takes the conv); the default only where there is no choice."""
    choice = cuda_qconv.forcible(ci, k, co, "int8", pad=pad, w=w)
    if not choice:
        return (None,)
    routed = cuda_qconv.design(ci, k, co, pad=pad, w=w)
    return (routed, choice[1] if routed == "mma.sync" else "mma.sync")


def time_designs(cuda_qconv, ci, k, co, call, *, pad, w) -> dict:
    """Graph-timed device time of ``call(_design)`` for each of ``designs``,
    in turns (a, b, b, a): {design: ms}, the routed one first and also
    under None."""
    ds = designs(cuda_qconv, ci, k, co, pad, w)
    order = ds + ds[::-1]
    times = [graph_time_ms(lambda d=d: call(d)) for d in order]
    ms = {d: (times[i] + times[len(order) - 1 - i]) / 2 for i, d in enumerate(ds)}
    ms[None] = ms[ds[0]]
    return ms


def design_note(ms: dict, bound: float) -> str:
    """" [routed design]; other design x ms (share of bound)" where the
    conv has two designs (``time_designs``' order)."""
    names = [d for d in ms if d is not None]
    if len(names) < 2:
        return ""
    routed, other = names
    return (f" [{routed}]; {other} {ms[other]:.4f} ms ({bound / ms[other]:.1%} of bound, "
            f"{ms[other] / ms[None]:.2f}x the routed time)")


def flagship_layers():
    """(layer, h, w, ci, co, k, pad, act, in the fusion plan) of the 13 convs."""
    from yolo_quantization_tpu_torch.infer.engine import fusion_plan
    from yolo_quantization_tpu_torch.models.presets import flagship_network, flagship_program
    from yolo_quantization_tpu_torch.ops.qconv import ACT_LINEAR, ACT_RELU6

    net = flagship_network(5, 416)
    shapes = net.shapes()
    plan = fusion_plan(flagship_program(5, 416))
    out = []
    for i in FLAGSHIP_CONVS:
        s = net.specs[i]
        h, w, ci = shapes[i - 1] if i > 0 else (416, 416, 3)
        act = ACT_RELU6 if s.activation == "relu6" else ACT_LINEAR
        out.append((i, h, w, ci, s.filters, s.size, s.pad, act, i in plan))
    return out


def v3_stride2_layers():
    """(layer, h, w, ci, co, k, pad) of yolov3's five stride-2 convs at 416."""
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.nn.graph import ConvSpec

    net = zoo.yolov3(classes=80, width=416, height=416)
    shapes = net.shapes()
    return [(i, *shapes[i - 1], s.filters, s.size, s.pad) for i, s in enumerate(net.specs)
            if isinstance(s, ConvSpec) and s.stride == 2]


def v3_shortcut_shapes():
    """(layer, h, w, c) of ``V3_SHORTCUTS`` at 416."""
    from yolo_quantization_tpu_torch.models import zoo

    shapes = zoo.yolov3(classes=80, width=416, height=416).shapes()
    return [(i, *shapes[i]) for i in V3_SHORTCUTS]


def v3_layers():
    """(h, w, ci, co, k, pad) of yolov3's distinct stride-1 conv shapes at
    416 whose Ci is a multiple of 64 (the wgmma design's), in layer order."""
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.nn.graph import ConvSpec

    net = zoo.yolov3(classes=80, width=416, height=416)
    shapes = net.shapes()
    out = []
    for i, s in enumerate(net.specs):
        if isinstance(s, ConvSpec) and s.stride == 1 and i and shapes[i - 1][2] % 64 == 0:
            shape = (*shapes[i - 1], s.filters, s.size, s.pad)
            if shape not in out:
                out.append(shape)
    return out


def v2_layers():
    """(name, h, w, ci, co, k, pad, act) of the yolov2 family's K1 shapes at
    416 that yolov3-tiny and yolov3 do not have: yolov2-tiny's 3x3 512->1024
    and 1024->1024 at 13x13 (GEMM K 4,608 and 9,216), yolov2's conv 29
    (Cin 1,280 after the reorg route, K 11,520), its passthrough 1x1 conv 26
    (512->64 at 26x26) and the 125-channel region head (Co off 16)."""
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY, ACT_LINEAR

    out = []
    for model, layers in (("yolov2_tiny", (12, 13, 14)), ("yolov2", (26, 29))):
        net = getattr(zoo, model)(width=416, height=416)
        shapes = net.shapes()
        for i in layers:
            s = net.specs[i]
            # yolov2's conv 26 reads route 25, which reads conv 16
            h, w, ci = shapes[16] if (model, i) == ("yolov2", 26) else shapes[i - 1]
            act = ACT_LINEAR if s.activation == "linear" else ACT_LEAKY
            out.append((f"{model}.{i}", h, w, ci, s.filters, s.size, s.pad, act))
    return out


def halo_layers():
    """(model, layer, batch, h, w, ci, co, stride, fuse_pool, act) of the
    convs the halo design takes at 416 (Ci 3, 16, 32), at the batches
    timed: the flagship's (yolov3-tiny's, as yolov2-tiny's) layers 0, 2, 4
    at 1 (the serving path, where layer 4's tiles are fewer than the SMs)
    and 16, yolov3's 0, 1 (stride 2) and 3 at 16 and 64, yolov2's 0 and 2 at
    16.  A conv followed by a 2x2/s2 pool at stride 1 has it fused, as in
    the engine's plan for these layers."""
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.nn.graph import ConvSpec, MaxPoolSpec
    from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY, ACT_RELU6

    out = []
    for model, batches in (("yolov3_tiny", (1, 16)), ("yolov3", (16, 64)), ("yolov2", (16,))):
        net = getattr(zoo, model)(**({"classes": 5} if model == "yolov3_tiny" else {}), width=416, height=416)
        shapes = net.shapes()
        for n in batches:
            for i, sp in enumerate(net.specs):
                h, w, ci = shapes[i - 1] if i else (416, 416, 3)
                if not (isinstance(sp, ConvSpec) and sp.size == 3 and ci in (3, 16, 32)):
                    continue
                nxt = net.specs[i + 1]
                pool = sp.stride == 1 and isinstance(nxt, MaxPoolSpec) and (nxt.size, nxt.stride) == (2, 2)
                act = ACT_RELU6 if model == "yolov3_tiny" else ACT_LEAKY  # the flagship program is relu6
                out.append((model, i, n, h, w, ci, sp.filters, sp.stride, pool, act))
    return out


def time_k1_halo(cuda_qconv, rng, card):
    """K1 on ``halo_layers``, symmetric, in both designs in turns
    (graph-timed), beside the bound: bytes (input, weights, bias and m,
    output, each once) or int8 operations, whichever is longer."""
    log(f"  K1 on the halo design's convs [{card}]: kernel graph-timed, both designs in turns:")
    sums = {}
    for (model, i, n, h, w, ci, co, stride, pool, act) in halo_layers():
        x, wt, bias, m = random_layer(rng, n, h, w, ci, co, 3)
        xt, wt_t = torch.from_numpy(x).cuda(), torch.from_numpy(wt).cuda()
        b_t, m_t = torch.from_numpy(bias).cuda(), torch.from_numpy(m).cuda()
        wp = cuda_qconv.pack_weights(wt_t)

        def call(design=None):
            kw = {"_design": design} if design else {}
            cuda_qconv.quantized_conv2d_cuda(xt, wt_t, b_t, m_t, 3, stride=stride, pad=1, act=act,
                                             out_zp_static=0, fuse_pool=pool, out_i8=True, w_packed=wp, **kw)

        ms = time_designs(cuda_qconv, ci, 3, co, call, pad=1, w=w)
        oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
        mac = n * oh * ow * co * 9 * ci
        out_px = n * (oh // 2) * (ow // 2) if pool else n * oh * ow
        bound = bound_ms(n * h * w * ci + 9 * ci * co + 8 * co + out_px * co, 2 * mac)
        key = (model, n)
        t = sums.setdefault(key, {d: 0.0 for d in ms})
        for d in ms:
            t[d] = t.get(d, 0.0) + ms[d]
        t["bound"] = t.get("bound", 0.0) + bound[0]
        log(f"    {model} layer {i} batch {n}: {h}x{w}x{ci}->{oh}x{ow}x{co} s{stride}{' +pool' if pool else ''}: "
            f"kernel {ms[None]:.4f} ms ({bound[0] / ms[None]:.1%} of bound){design_note(ms, bound[0])}, "
            f"bound {bound[0]:.4f} ms ({bound[1]}) [{card}]")
    for (model, n), t in sums.items():
        other = " ".join(f"{d} {v:.4f} ms" for d, v in t.items() if d not in (None, "bound"))
        log(f"  {model} batch {n}, these convs: routed {t[None]:.4f} ms ({other}), bound {t['bound']:.4f} ms "
            f"[{card}]")


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Eager back-to-back calls between CUDA events: the device time, or the
    host's launch cost per call where that is longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call: ``calls`` calls captured in one CUDA graph
    and replayed between CUDA events, so no host work is timed.  The
    wrappers launch on the current stream, the capture stream here."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up off the capture stream, as graph capture asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (calls * replays)


class Totals:
    """Summed kernel (graph), eager, plain, bound and library times of one
    kernel entry."""

    def __init__(self):
        self.ms = self.eager_ms = self.plain_ms = self.bound_ms = self.bytes_bound_ms = 0.0
        self.earlier_ms = 0.0  # K1: the same convs with every one on mma.sync
        self.library_ms: float | None = 0.0

    def add(self, ms, eager_ms, plain_ms, bound, library_ms):
        self.ms += ms
        self.eager_ms += eager_ms
        self.plain_ms += plain_ms
        self.bound_ms += bound[0]
        if bound[1] == "bytes":
            self.bytes_bound_ms += bound[0]
        # a sum over the cases is a yardstick only when every case has one
        self.library_ms = None if library_ms is None or self.library_ms is None else self.library_ms + library_ms

    def entry(self, name, source, replaces, launches, err):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": self.ms, "plain_ms": self.plain_ms,
            "bound_ms": self.bound_ms,
            "bound_by": "bytes" if self.bytes_bound_ms * 2 >= self.bound_ms else "operations",
            "library_ms": self.library_ms,
        }


def time_k1_layers(cuda_qconv, qconv, rng, card):
    tot = Totals()
    log(f"  per-layer conv at batch 16 [{card}]: kernel = graph-timed device time; eager = "
        "back-to-back calls, the wrapper's host cost included; plain = float64 F.conv2d + "
        "requant on the same card (eager); _int_mm = torch._int_mm int8 GEMM, graph-timed, on "
        "the 1x1 layers where its shape rules allow; inputs warm in L2:")
    for (i, h, w, ci, co, k, pad, act, fused) in flagship_layers():
        x, wt, bias, m = random_layer(rng, 16, h, w, ci, co, k)
        xt, wt_t = torch.from_numpy(x).cuda(), torch.from_numpy(wt).cuda()
        b_t, m_t = torch.from_numpy(bias).cuda(), torch.from_numpy(m).cuda()
        wp = cuda_qconv.pack_weights(wt_t)

        def call(design=None):
            kw = {"_design": design} if design else {}
            cuda_qconv.quantized_conv2d_cuda(xt, wt_t, b_t, m_t, 3, pad=pad, act=act,
                                             out_zp_static=0, fuse_pool=fused, out_i8=True,
                                             w_packed=wp, **kw)

        def kernel():
            call()

        def plain():
            if fused:
                qconv.quantized_conv2d_pool(xt, wt_t, b_t, m_t, 3, 0, pad=pad, act=act, out_i8=True)
            else:
                qconv.quantized_conv2d(xt, wt_t, b_t, m_t, 3, None, 0, pad=pad, act=act,
                                       symmetric=True, out_i8=True)

        # the designs in turns (graph), then the eager form
        ms = time_designs(cuda_qconv, ci, k, co, call, pad=pad, w=w)
        k_ms, e_ms = ms[None], cuda_time_ms(kernel, 20)
        p_ms = cuda_time_ms(plain, 5, warmup=1)
        lib_ms = lib_eager = None
        if k == 1 and int_mm_ok(16 * h * w, ci, co):
            a2, b2 = xt.reshape(-1, ci), wt_t.reshape(ci, co)
            lib_ms = graph_time_ms(lambda: torch._int_mm(a2, b2))
            lib_eager = cuda_time_ms(lambda: torch._int_mm(a2, b2), 20)
        oh, ow = (h // 2, w // 2) if fused else (h, w)
        mac = 16 * h * w * co * k * k * ci
        bound = bound_ms(16 * h * w * ci + k * k * ci * co + 8 * co + 16 * oh * ow * co, 2 * mac)
        tot.add(k_ms, e_ms, p_ms, bound, lib_ms)
        tot.earlier_ms += ms.get("mma.sync", k_ms)
        lib = f"{lib_ms:.4f} ms (eager {lib_eager:.4f})" if lib_ms is not None else "none"
        log(f"    layer {i:2d} {h}x{w}x{ci}->{co} k{k}{' +pool' if fused else ''}: kernel "
            f"{k_ms:.4f} ms ({mac / 1e9 / k_ms:.2f} TMAC/s, {bound[0] / k_ms:.1%} of bound)"
            f"{design_note(ms, bound[0])}, "
            f"eager {e_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), "
            f"_int_mm {lib} [{card}]")
    log(f"  all 13 convs at batch 16: kernel {tot.ms:.4f} ms (graph; every conv on mma.sync "
        f"{tot.earlier_ms:.4f} ms), eager {tot.eager_ms:.4f} ms, plain {tot.plain_ms:.4f} ms, bound "
        f"{tot.bound_ms:.4f} ms [{card}]")
    return tot


def time_k1_stride2(cuda_qconv, qconv, rng, card):
    """K1 on yolov3's five stride-2 convs at batch 16 (symmetric, leaky)."""
    from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY

    tot = Totals()
    log(f"  K1 on yolov3's stride-2 convs at batch 16 [{card}]: kernel graph-timed, eager, plain:")
    for (i, h, w, ci, co, k, pad) in v3_stride2_layers():
        x, wt, bias, m = random_layer(rng, 16, h, w, ci, co, k)
        xt, wt_t = torch.from_numpy(x).cuda(), torch.from_numpy(wt).cuda()
        b_t, m_t = torch.from_numpy(bias).cuda(), torch.from_numpy(m).cuda()
        wp = cuda_qconv.pack_weights(wt_t)

        def call(design=None):
            kw = {"_design": design} if design else {}
            cuda_qconv.quantized_conv2d_cuda(xt, wt_t, b_t, m_t, 3, stride=2, pad=pad, act=ACT_LEAKY,
                                             out_zp_static=0, out_i8=True, w_packed=wp, **kw)

        def plain():
            qconv.quantized_conv2d(xt, wt_t, b_t, m_t, 3, None, 0, stride=2, pad=pad, act=ACT_LEAKY,
                                   symmetric=True, out_i8=True)

        ms = time_designs(cuda_qconv, ci, k, co, call, pad=pad, w=w)
        k_ms, e1 = ms[None], cuda_time_ms(call, 20)
        p_ms = cuda_time_ms(plain, 5, warmup=1)
        oh, ow = (h + 2 * pad - k) // 2 + 1, (w + 2 * pad - k) // 2 + 1
        mac = 16 * oh * ow * co * k * k * ci
        bound = bound_ms(16 * h * w * ci + k * k * ci * co + 8 * co + 16 * oh * ow * co, 2 * mac)
        tot.add(k_ms, e1, p_ms, bound, None)
        tot.earlier_ms += ms.get("mma.sync", k_ms)
        log(f"    layer {i:2d} {h}x{w}x{ci}->{oh}x{ow}x{co} k{k}/s2: kernel {k_ms:.4f} ms "
            f"({mac / 1e9 / k_ms:.2f} TMAC/s, {bound[0] / k_ms:.1%} of bound)"
            f"{design_note(ms, bound[0])}, eager {e1:.4f} ms, "
            f"plain {p_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), library none [{card}]")
    log(f"  the five stride-2 convs at batch 16: kernel {tot.ms:.4f} ms (every conv on mma.sync "
        f"{tot.earlier_ms:.4f} ms), plain {tot.plain_ms:.4f} ms, bound {tot.bound_ms:.4f} ms [{card}]")
    return tot


def time_shortcut(cuda_shortcut, shortcut, rng, card):
    """The shortcut kernel on one shortcut of each yolov3 stage at batch 16,
    under leaky and off-unit ratios, vs the plain float32 chain."""
    tot = Totals()
    k = shortcut.shortcut_params((0.031, 101), (0.027, 93), 0.043, 77, "leaky")
    log(f"  shortcut kernel at batch 16 [{card}]: kernel graph-timed, eager, plain chain:")
    for (i, h, w, c) in v3_shortcut_shapes():
        shape = (16, h, w, c)
        x = torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).cuda()
        skip = torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).cuda()

        def kernel():
            cuda_shortcut.int_shortcut_cuda(x, skip, k)

        g1, e1, g2 = graph_time_ms(kernel), cuda_time_ms(kernel, 20), graph_time_ms(kernel)
        k_ms = (g1 + g2) / 2
        p_ms = cuda_time_ms(lambda: shortcut.int_shortcut(x, skip, k), 10)
        codes = x.numel()
        bound = bound_ms(3 * codes, 0)  # read two codes, write one
        tot.add(k_ms, e1, p_ms, bound, None)
        log(f"    layer {i:2d} 16x{h}x{w}x{c} ({codes / 1e6:.1f} M codes): kernel {k_ms:.4f} ms "
            f"({3 * codes / k_ms / 1e9:.2f} TB/s, {bound[0] / k_ms:.1%} of bound), eager {e1:.4f} ms, "
            f"plain {p_ms:.4f} ms, bound {bound[0]:.4f} ms (bytes), library none [{card}]")
    log(f"  five shortcuts at batch 16: kernel {tot.ms:.4f} ms, plain {tot.plain_ms:.4f} ms, "
        f"bound {tot.bound_ms:.4f} ms [{card}]")
    return tot


def time_spp(cuda_spp, rng, card):
    """``spp_kernel`` on YOLOv4's SPP block (pools of 13, 9 and 5 and the
    map itself, each branch requantized, over 19x19x512 at 608) at batch 16
    and 32, vs the plain block (``maxpool_u8`` per pool, the requant, the
    concat), beside its bytes bound: the input read once, the concat
    written once."""
    from yolo_quantization_tpu_torch.nn.layers import maxpool_u8, requant_i8

    tot = Totals()
    branches = tuple((size, False, 0.994, 56) for size in (13, 9, 5, 1))
    log(f"  SPP kernel (YOLOv4's block) [{card}]: kernel graph-timed, eager, plain block:")
    for n in (16, 32):
        x = torch.from_numpy(rng.integers(-128, 128, (n, 19, 19, 512), dtype=np.int8)).cuda()

        def kernel():
            cuda_spp.spp_cuda(x, branches, 56)

        g1, e1, g2 = graph_time_ms(kernel), cuda_time_ms(kernel, 20), graph_time_ms(kernel)
        k_ms = (g1 + g2) / 2
        def plain():  # the block's layers, as the engine runs them one by one
            return torch.cat([requant_i8(x if size == 1 else maxpool_u8(x, size, 1, size - 1), ratio, zp, 56)
                              for size, _, ratio, zp in branches], dim=-1)

        p_ms = cuda_time_ms(plain, 3, warmup=1)
        nbytes = x.numel() * (1 + len(branches))
        bound = bound_ms(nbytes, 0)
        tot.add(k_ms, e1, p_ms, bound, None)
        log(f"    batch {n} 19x19x512 -> 19x19x2048: kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e9:.2f} TB/s, "
            f"{bound[0] / k_ms:.1%} of bound), eager {e1:.4f} ms, plain {p_ms:.4f} ms, bound "
            f"{bound[0]:.4f} ms (bytes), library none [{card}]")
    return tot


def time_k1_v2(cuda_qconv, qconv, rng, card):
    """K1 on ``v2_layers`` at batch 16 (symmetric), graph-timed, beside its
    ops bound, the plain version and ``torch._int_mm`` on the 1x1 layers its
    shape rules allow (the passthrough conv 26; not the 125-channel head)."""
    tot = Totals()
    log(f"  K1 on the yolov2 family's new shapes at batch 16 [{card}]: kernel graph-timed, eager, "
        "plain, _int_mm (graph):")
    for (name, h, w, ci, co, k, pad, act) in v2_layers():
        x, wt, bias, m = random_layer(rng, 16, h, w, ci, co, k)
        xt, wt_t = torch.from_numpy(x).cuda(), torch.from_numpy(wt).cuda()
        b_t, m_t = torch.from_numpy(bias).cuda(), torch.from_numpy(m).cuda()
        wp = cuda_qconv.pack_weights(wt_t)

        def call(design=None):
            kw = {"_design": design} if design else {}
            cuda_qconv.quantized_conv2d_cuda(xt, wt_t, b_t, m_t, 3, pad=pad, act=act, out_zp_static=0,
                                             out_i8=True, w_packed=wp, **kw)

        def plain():
            qconv.quantized_conv2d(xt, wt_t, b_t, m_t, 3, None, 0, pad=pad, act=act, symmetric=True,
                                   out_i8=True)

        ms = time_designs(cuda_qconv, ci, k, co, call, pad=pad, w=w)
        k_ms, e1 = ms[None], cuda_time_ms(call, 20)
        p_ms = cuda_time_ms(plain, 3, warmup=1)
        lib_ms = None
        if k == 1 and int_mm_ok(16 * h * w, ci, co):
            a2, b2 = xt.reshape(-1, ci), wt_t.reshape(ci, co)
            lib_ms = graph_time_ms(lambda: torch._int_mm(a2, b2))
        mac = 16 * h * w * co * k * k * ci
        bound = bound_ms(16 * h * w * ci + k * k * ci * co + 8 * co + 16 * h * w * co, 2 * mac)
        tot.add(k_ms, e1, p_ms, bound, lib_ms)
        tot.earlier_ms += ms.get("mma.sync", k_ms)
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        log(f"    {name:14s} {h}x{w}x{ci}->{co} k{k} (GEMM K {k * k * ci}): kernel {k_ms:.4f} ms "
            f"({mac / 1e9 / k_ms:.2f} TMAC/s, {bound[0] / k_ms:.1%} of bound)"
            f"{design_note(ms, bound[0])}, eager {e1:.4f} ms, "
            f"plain {p_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), _int_mm {lib} [{card}]")
    log(f"  the yolov2 family's new shapes at batch 16: kernel {tot.ms:.4f} ms (every conv on mma.sync "
        f"{tot.earlier_ms:.4f} ms), plain {tot.plain_ms:.4f} ms, bound {tot.bound_ms:.4f} ms [{card}]")
    return tot


def time_k1_v3(cuda_qconv, rng, card, batches=(16, 64)):
    """K1 on ``v3_layers`` (yolov3's stride-1 convs from Ci 64) at each batch,
    symmetric and leaky, in both designs (graph-timed, in turns), beside the
    ops bound.  The plain version is not timed here (float64 convs at batch
    64)."""
    from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY

    log(f"  K1 on yolov3's stride-1 convs from Ci 64 [{card}]: kernel graph-timed, both designs in turns:")
    for n in batches:
        tot = Totals()
        for (h, w, ci, co, k, pad) in v3_layers():
            x, wt, bias, m = random_layer(rng, n, h, w, ci, co, k)
            xt, wt_t = torch.from_numpy(x).cuda(), torch.from_numpy(wt).cuda()
            b_t, m_t = torch.from_numpy(bias).cuda(), torch.from_numpy(m).cuda()
            wp = cuda_qconv.pack_weights(wt_t)

            def call(design=None):
                kw = {"_design": design} if design else {}
                cuda_qconv.quantized_conv2d_cuda(xt, wt_t, b_t, m_t, 3, pad=pad, act=ACT_LEAKY,
                                                 out_zp_static=0, out_i8=True, w_packed=wp, **kw)

            ms = time_designs(cuda_qconv, ci, k, co, call, pad=pad, w=w)
            mac = n * h * w * co * k * k * ci
            bound = bound_ms(n * h * w * ci + k * k * ci * co + 8 * co + n * h * w * co, 2 * mac)
            tot.add(ms[None], 0.0, 0.0, bound, None)
            tot.earlier_ms += ms.get("mma.sync", ms[None])
            log(f"    batch {n} {h}x{w}x{ci}->{co} k{k}: kernel {ms[None]:.4f} ms ({mac / 1e9 / ms[None]:.2f} "
                f"TMAC/s, {bound[0] / ms[None]:.1%} of bound){design_note(ms, bound[0])}, "
                f"bound {bound[0]:.4f} ms ({bound[1]}) [{card}]")
        log(f"  yolov3's {len(v3_layers())} stride-1 shapes from Ci 64 at batch {n}: kernel {tot.ms:.4f} ms "
            f"(every conv on mma.sync {tot.earlier_ms:.4f} ms), bound {tot.bound_ms:.4f} ms [{card}]")


def k2_bounds(n, h, w, ci, co, slices):
    """K2's two bounds on one stem layer, each (ms, "bytes" or
    "operations"): with the structural zeros counted (any w_s2d: the block
    kernel's 144·C·O MACs a block and its 9·16·C·O bytes, the yardstick of
    the mma.sync design), and structured (the work a structured w_s2d
    needs, held against the halo design: 36·C·O MACs a block, and the
    ``slices`` phase kernels of 9·C·O bytes it reads, 1 where the four
    phases share one).  Both count the input once, bias and m, and the
    pooled output."""
    io = n * h * w * ci + 8 * co + n * (h // 2) * (w // 2) * co
    blocks = n * (h // 2) * (w // 2)
    dense = bound_ms(io + 9 * 16 * ci * co, 2 * blocks * 144 * ci * co)
    structured = bound_ms(io + slices * 9 * ci * co, 2 * blocks * 36 * ci * co)
    return dense, structured


def time_k2_stem(cuda_qconv, cuda_s2d, qconv, rng, card):
    """K2 on the flagship's s2d layers 0, 2, 4 at batch 1 and 16 (the
    engine's weights: _s2d_weights of one 3x3 kernel), graph-timed in
    turns: K1's fused stage, the halo design (one shared slice), the halo
    design with the same kernel as four slices (the per-fragment cost of
    four distinct phase kernels), mma.sync forced, then back; beside both
    bounds (``k2_bounds``) and the plain time.  Returns the Totals of the
    routed design at batch 16, with the structured bound."""
    from yolo_quantization_tpu_torch.infer.convert import _s2d_weights

    tot = Totals()
    log(f"  s2d stem (K2) by design vs K1's fused stem, graph-timed in turns [{card}]:")
    for n in (1, 16):
        sums = {}
        for (i, h, w, ci, co, k, pad, act, fused) in flagship_layers():
            if i not in S2D_LAYERS:
                continue
            x, wt, bias, m = random_layer(rng, n, h, w, ci, co, 3)
            xt, wt_t = torch.from_numpy(x).cuda(), torch.from_numpy(wt).cuda()
            b_t, m_t = torch.from_numpy(bias).cuda(), torch.from_numpy(m).cuda()
            ws_t = torch.from_numpy(_s2d_weights(wt)).cuda()
            wp1, halo1 = cuda_qconv.pack_weights(wt_t), cuda_s2d.pack_weights(ws_t)
            halo4, dense = cuda_s2d.pack_phases(ws_t, share=False), cuda_s2d.pack_dense(ws_t)

            def k2(packed, design=None):
                cuda_s2d.s2d_conv_phase_max_cuda(xt, ws_t, b_t, m_t, 3, act=act, w_packed=packed, _design=design)

            calls = {
                "K1 fused": lambda: cuda_qconv.quantized_conv2d_cuda(
                    xt, wt_t, b_t, m_t, 3, pad=1, act=act, fuse_pool=True, out_i8=True, w_packed=wp1),
                "halo": lambda: k2(halo1), "halo, 4 slices": lambda: k2(halo4),
                "mma.sync": lambda: k2(dense, "mma.sync"),
            }
            order = list(calls) + list(calls)[::-1]
            times = [graph_time_ms(calls[name]) for name in order]
            ms = {name: (times[j] + times[len(order) - 1 - j]) / 2 for j, name in enumerate(calls)}
            dense_b, struct_b = k2_bounds(n, h, w, ci, co, halo1.shape[0])
            for name, v in ms.items():
                sums[name] = sums.get(name, 0.0) + v
            sums["bound zeros counted"] = sums.get("bound zeros counted", 0.0) + dense_b[0]
            sums["bound structured"] = sums.get("bound structured", 0.0) + struct_b[0]
            line = ", ".join(f"{name} {v:.4f} ms" for name, v in ms.items())
            if n == 16:
                e_ms = cuda_time_ms(calls["halo"], 20)
                p_ms = cuda_time_ms(
                    lambda: qconv.s2d_conv_phase_max(qconv.space_to_depth(xt), ws_t, b_t, m_t, 3, 0, act=act),
                    5, warmup=1)
                tot.add(ms["halo"], e_ms, p_ms, struct_b, None)
                line += f", halo eager {e_ms:.4f} ms, plain {p_ms:.4f} ms"
            log(f"    layer {i} batch {n} {h}x{w}x{ci}->{co} +pool: {line}; halo at {struct_b[0] / ms['halo']:.1%} "
                f"of the structured bound {struct_b[0]:.4f} ms ({struct_b[1]}), mma.sync at "
                f"{dense_b[0] / ms['mma.sync']:.1%} of the zeros-counted bound {dense_b[0]:.4f} ms "
                f"({dense_b[1]}); halo/K1 {ms['halo'] / ms['K1 fused']:.2f}x, mma.sync/halo "
                f"{ms['mma.sync'] / ms['halo']:.2f}x [{card}]")
        log(f"  s2d stem layers 0/2/4 at batch {n}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in sums.items())
            + f" [{card}]")
    log(f"  s2d stem layers 0/2/4 at batch 16: K2 (halo) {tot.ms:.4f} ms, plain {tot.plain_ms:.4f} ms, "
        f"structured bound {tot.bound_ms:.4f} ms [{card}]")
    return tot


def time_engines(engines, rng, card):
    """Device forwards of the flagship, s2d and parity engines and of the
    yolov3 ones (CUDA events); ``engines`` maps those names to CUDA
    engines."""
    from yolo_quantization_tpu_torch.infer.engine import build_forward

    for b in (1, 16, 64):
        x = rng.uniform(0, 1, (b, 416, 416, 3)).astype(np.float32)
        xd = torch.from_numpy(x).cuda()
        for cname in ("flagship", "s2d", "parity", "v3", "v3-perturbed", "v2-tiny", "v2"):
            if (b == 1 and cname != "flagship") or cname not in engines:
                continue
            eng = engines[cname]
            forward = build_forward(eng.program, **eng.options)
            torch.cuda.reset_peak_memory_stats()

            def fwd():
                with torch.inference_mode():
                    forward(eng.arrays, xd)

            dev_ms = cuda_time_ms(fwd, 10)
            line = (f"  {cname:12s} batch {b:2d}: device forward {dev_ms:.3f} ms "
                    f"({b / dev_ms * 1e3:.1f} images/s)")
            if cname == "flagship":
                iters = 20 if b < 64 else 5
                eng.predict(x)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(iters):
                    eng.predict(x)
                wall = (time.perf_counter() - t0) / iters
                line += (f"; predict {b / wall:.1f} images/s ({wall * 1e3:.3f} ms per call, "
                         "host input included)")
            peak = torch.cuda.max_memory_allocated() / 2**20
            log(f"{line}; peak memory {peak:.1f} MiB [{card}]")


def time_probe(probe, results, card):
    """The probe's cases, from ``orientation_probe.run_cases``."""
    tots = {"a": Totals(), "b": Totals()}
    for name, orientation, k, o, p, args, _ in results:
        fn = probe.orientation_a if orientation == "a" else probe.orientation_b
        ms = graph_time_ms(lambda: fn(*args))
        e_ms = cuda_time_ms(lambda: fn(*args), 20)
        p_ms = cuda_time_ms(lambda: probe.plain_matmul_i8(*args), 3, warmup=1)
        a, b = args
        lib_ms = None
        if int_mm_ok(a.shape[0], a.shape[1], b.shape[1]):
            lib_ms = graph_time_ms(lambda: torch._int_mm(a, b))
        bound = bound_ms(p * k + k * o + p * o, 2 * p * k * o)
        tots[orientation].add(ms, e_ms, p_ms, bound, lib_ms)
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none (m <= 16)"
        log(f"  {name}: kernel {ms:.4f} ms (graph; {bound[0] / ms:.1%} of bound), eager "
            f"{e_ms:.4f} ms, plain {p_ms:.4f} ms, _int_mm {lib} (graph), bound "
            f"{bound[0]:.4f} ms ({bound[1]}) [{card}]")
    return tots


def time_all(engines, probe_results, card, rng, v3_batches=(16, 64)):
    """Every timing above but ``time_k1_v2`` (timed apart, on its own
    generator), each step's wall time logged; yolov3's stride-1 convs at
    ``v3_batches`` (``chip_smoke.py`` takes 16 alone, to stay inside its
    time limit).  Returns the Totals of K1 (the flagship's 13 convs), K2,
    K3 ({"a", "b"}), the shortcut kernel and the SPP kernel."""
    from yolo_quantization_tpu_torch.ops import cuda_qconv, cuda_s2d, cuda_shortcut, cuda_spp, qconv, shortcut
    from yolo_quantization_tpu_torch.tools import orientation_probe as probe

    t0 = time.perf_counter()

    def step(name, fn):
        t = time.perf_counter()
        out = fn()
        log(f"  [{name}: {time.perf_counter() - t:.1f} s]")
        return out

    k1 = step("K1 layers", lambda: time_k1_layers(cuda_qconv, qconv, rng, card))
    step("K1 halo", lambda: time_k1_halo(cuda_qconv, np.random.default_rng(5), card))
    step("K1 stride 2", lambda: time_k1_stride2(cuda_qconv, qconv, rng, card))
    step("K1 yolov3", lambda: time_k1_v3(cuda_qconv, np.random.default_rng(3), card, v3_batches))
    k2 = step("K2", lambda: time_k2_stem(cuda_qconv, cuda_s2d, qconv, rng, card))
    sc = step("shortcut", lambda: time_shortcut(cuda_shortcut, shortcut, rng, card))
    sp = step("SPP", lambda: time_spp(cuda_spp, np.random.default_rng(11), card))
    step("engines", lambda: time_engines(engines, rng, card))
    k3 = step("K3", lambda: time_probe(probe, probe_results, card))
    log(f"  [timings: {time.perf_counter() - t0:.1f} s]")
    return k1, k2, k3, sc, sp


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timings: needs a CUDA GPU")
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.models.presets import v2_program, v2_tiny_program
    from yolo_quantization_tpu_torch.ops import _build, cuda_qconv, cuda_s2d, cuda_shortcut, qconv
    from yolo_quantization_tpu_torch.tools import orientation_probe as probe
    from yolo_quantization_tpu_torch.tools.profile_engine import configurations

    t_start = time.perf_counter()
    card = card_identity()
    log(f"kernel timings: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    _build.build_all(_build.LIBRARIES)
    cuda_qconv.build()
    cuda_s2d.build()
    cuda_shortcut.build()
    probe.build()
    engines = {name: Engine(program, device="cuda", **option)
               for v3 in (False, True) for name, (program, option) in configurations(v3).items()}
    engines["v2-tiny"] = Engine(v2_tiny_program(), device="cuda")
    engines["v2"] = Engine(v2_program(), device="cuda")
    time_all(engines, list(probe.run_cases("cuda")), card, np.random.default_rng(0))
    time_k1_v2(cuda_qconv, qconv, np.random.default_rng(7), card)
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
