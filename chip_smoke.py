#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. card identity (nvidia-smi name and power limit, torch device name);
  2. build the three kernel libraries (csrc/qconv.cu, s2d_qconv.cu,
     gemm_probe.cu), one nvcc each, all started together; print ptxas;
  3. K1 (qconv) vs its plain PyTorch version, bit for bit: every flagship
     conv shape at 416x416, batch 2, plain and with each reference-engine
     option (asymmetric w_zp, per-image zp and (N,Co) bias/m, exact_leaky,
     the int16 carrier), fused pool where the plan has it, plus edge cases
     (co=130, partial tiles, Cin=3, K=1, every activation, ties, uint8 in);
  4. K2 (s2d_qconv) vs its plain version, bit for bit: layers 0, 2, 4 at 416,
     batch 2, every activation, per-image zp/bias/m, exact_leaky, non-square
     maps and partial tiles;
  5. K3 (orientation_a/b): the probe's four cases at the script's full
     sizes, each kernel vs its plain version bit for bit — the probe's main
     path, whose launches are counted;
  6. engines on the GPU vs on the CPU, every layer's codes equal, float32 and
     uint8 batches of 4: the flagship (13 K1 launches per forward), the
     flagship with use_s2d (3 K2 + 10 K1), the C-parity configuration (leaky,
     asymmetric, dynamic_input, exact_leaky; 13 K1) and the int16 carrier
     (codes equal to the int8 engine's); each engine's predict is a main path
     with counted launches;
  7. flip TTA and at_size(320) agree between GPU and CPU, and f1_rows over
     GPU and CPU predictions gives equal counts;
  8. a Server with the (1, 4, 16) bucket ladder answers seeded requests of
     mixed sizes, float and uint8 — the serving main path;
  9. timings with CUDA events (printed, not asserted): per-layer K1 vs plain
     (and torch._int_mm on the 1x1 layers its shape rules allow), K2 vs K1's
     fused stem per layer, device forwards of the three engines at batch 16
     and 64, the probe cases vs torch._int_mm.

Prints a {"kernels": [...]} JSON line, then the card's nvidia-smi line, and
last {"ok": true, "device": {...}}.  Needs one CUDA device and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# flagship conv layers (yolov3-tiny at 416) in layer order
FLAGSHIP_CONVS = (0, 2, 4, 6, 8, 10, 12, 13, 14, 15, 18, 21, 22)
S2D_LAYERS = (0, 2, 4)
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): int8 tensor cores, HBM3
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# decoded floats: sigmoid/exp differ between the card and the CPU by ulps
DECODE_TOL = dict(rtol=1e-5, atol=1e-6)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_identity() -> str:
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


class Errors:
    """The largest |kernel - plain| per kernel over every comparison."""

    def __init__(self):
        self.worst: dict[str, int] = {}

    def check(self, kernel: str, name: str, got: torch.Tensor, ref: torch.Tensor) -> None:
        torch.cuda.synchronize()
        got, ref = got.cpu(), ref.cpu()
        err = int((got.to(torch.int32) - ref.to(torch.int32)).abs().max()) if got.shape == ref.shape else -1
        self.worst[kernel] = max(self.worst.get(kernel, 0), err)
        if got.dtype != ref.dtype or not torch.equal(got, ref):
            raise AssertionError(f"{kernel} != plain version on case {name} (max_abs_err {err})")


def random_layer(rng, n, h, w, ci, co, k):
    """Seeded codes, weights, bias and multipliers with outputs spread over
    the code range (acc std ~ sqrt(K*K*Ci) * 73^2)."""
    x = rng.integers(-128, 128, (n, h, w, ci), dtype=np.int8)
    wt = rng.integers(-127, 128, (k, k, ci, co)).astype(np.int8)
    bias = rng.integers(-(2**14), 2**14, (co,)).astype(np.int32)
    m = (rng.uniform(0.5, 2.0, (co,)) * 40.0 / (np.sqrt(k * k * ci) * 5300.0)).astype(np.float32)
    return x, wt, bias, m


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


def conv_cases():
    """(name, n, h, w, ci, co, k, pad, act, out_i8, fuse_pool, variant).

    Variants: "" plain symmetric; "asym" weight zero points; "dyn" per-image
    zero points and (N,Co) bias/m; "exact" double-rounded leaky; "int16" the
    int16 carrier; "all" every option at once; "pow2_m" power-of-two
    multipliers (ties for rint); "uint8" uint8 input codes.
    """
    from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY, ACT_LINEAR, ACT_RELU, ACT_RELU6

    cases = []
    for (i, h, w, ci, co, k, pad, act, fused) in flagship_layers():
        cases.append((f"layer{i}", 2, h, w, ci, co, k, pad, act, True, fused, ""))
        if fused:
            cases.append((f"layer{i}_unfused", 2, h, w, ci, co, k, pad, act, True, False, ""))
        for variant in ("asym", "dyn", "exact", "int16"):
            v_act = ACT_LEAKY if variant == "exact" else act
            cases.append((f"layer{i}_{variant}", 2, h, w, ci, co, k, pad, v_act, True, fused, variant))
    for act in (ACT_LINEAR, ACT_LEAKY, ACT_RELU, ACT_RELU6):
        for out_i8 in (False, True):
            cases.append((f"cin3_act{act}_i8{int(out_i8)}", 2, 36, 36, 3, 16, 3, 1, act, out_i8, False, ""))
            cases.append((f"cin3_pool_act{act}_i8{int(out_i8)}", 2, 36, 36, 3, 16, 3, 1, act, out_i8, True, ""))
    cases += [
        ("co130", 1, 20, 20, 8, 130, 3, 1, ACT_LINEAR, False, False, ""),
        ("partial_rows72", 1, 72, 72, 8, 16, 3, 1, ACT_LINEAR, False, False, ""),
        ("partial_rows96_leaky", 1, 96, 96, 12, 24, 3, 1, ACT_LEAKY, False, False, ""),
        ("k1_ci256_co30", 2, 13, 13, 256, 30, 1, 0, ACT_LINEAR, False, False, ""),
        ("k1_cin3", 2, 17, 17, 3, 40, 1, 0, ACT_RELU, True, False, ""),
        ("cin6_nonsquare", 3, 20, 34, 6, 33, 3, 1, ACT_LEAKY, True, False, ""),
        ("cin6_nonsquare_pool", 3, 20, 34, 6, 33, 3, 1, ACT_RELU6, False, True, ""),
        ("pool_partial_tiles", 2, 50, 42, 16, 64, 3, 1, ACT_LEAKY, True, True, ""),
        ("rint_ties_pow2_m", 2, 26, 26, 64, 48, 3, 1, ACT_LEAKY, True, False, "pow2_m"),
        ("uint8_input", 2, 26, 26, 32, 64, 3, 1, ACT_RELU6, False, False, "uint8"),
        ("all_cin3_pool", 2, 36, 36, 3, 16, 3, 1, ACT_LEAKY, True, True, "all"),
        ("all_co130", 2, 20, 20, 8, 130, 3, 1, ACT_LEAKY, False, False, "all"),
        ("all_partial_pool", 2, 50, 42, 16, 64, 3, 1, ACT_LEAKY, True, True, "all"),
        ("all_cin6_nonsquare", 3, 20, 34, 6, 33, 3, 1, ACT_LEAKY, False, False, "all"),
        ("all_k1_ci256", 2, 13, 13, 256, 30, 1, 0, ACT_LEAKY, True, False, "all"),
        ("all_ties_pow2_m", 2, 26, 26, 64, 48, 3, 1, ACT_LEAKY, True, True, "all_pow2_m"),
    ]
    return cases


def phase_k1(cuda_qconv, qconv, rng, errors):
    cases = conv_cases()
    for (name, n, h, w, ci, co, k, pad, act, out_i8, pool, variant) in cases:
        x, wt, bias, m = random_layer(rng, n, h, w, ci, co, k)
        dyn = variant in ("dyn", "all", "all_pow2_m")
        if "pow2_m" in variant:
            m = np.full((co,), 2.0**-12, np.float32)  # many exact .5 ties for rint
        if dyn:
            bias = rng.integers(-(2**14), 2**14, (n, co)).astype(np.int32)
            m = np.tile(m, (n, 1)) * rng.uniform(0.8, 1.25, (n, 1)).astype(np.float32)
            if "pow2_m" in variant:
                m = np.full((n, co), 2.0**-12, np.float32)
        x_zp = (rng.integers(-128, 128, (n,)).astype(np.int32) if dyn
                else int(rng.integers(-128, 128)))
        w_zp = (rng.integers(-128, 128, (co,)).astype(np.int32)
                if variant in ("asym", "all", "all_pow2_m") else None)
        opts = dict(exact_leaky=variant in ("exact", "all", "all_pow2_m"),
                    carrier="int16" if variant in ("int16", "all", "all_pow2_m") else "int8")
        out_zp = int(rng.integers(0, 256))
        xt = torch.from_numpy(x).cuda()
        if variant == "uint8":
            xt = xt.view(torch.uint8)
        wt_t, b_t, m_t = (torch.from_numpy(a).cuda() for a in (wt, bias, m))
        zp_t = torch.from_numpy(x_zp).cuda() if dyn else x_zp
        wzp_t = None if w_zp is None else torch.from_numpy(w_zp).cuda()
        # the plain version on the same card (float64 conv: exact integers)
        if pool:
            ref = qconv.quantized_conv2d_pool(xt, wt_t, b_t, m_t, zp_t, out_zp, pad=pad, act=act,
                                              out_i8=out_i8, w_zp_i32=wzp_t, **opts)
        else:
            ref = qconv.quantized_conv2d(xt, wt_t, b_t, m_t, zp_t, wzp_t, out_zp, stride=1,
                                         pad=pad, act=act, symmetric=w_zp is None,
                                         out_i8=out_i8, **opts)
        got = cuda_qconv.quantized_conv2d_cuda(
            xt, wt_t, b_t, m_t, zp_t, stride=1, pad=pad, act=act, out_zp_static=out_zp,
            fuse_pool=pool, out_i8=out_i8, w_zp=wzp_t, **opts,
        )
        errors.check("qconv", name, got, ref)
        log(f"  {name:24s} x{(n, h, w, ci)} w{(k, k, ci, co)} act={act} out_i8={out_i8} "
            f"pool={pool} {variant or 'plain'}: equal")
    return len(cases)


def s2d_cases():
    """(name, n, h, w, ci, co, act, per-image zp/bias/m, exact_leaky)."""
    from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY, ACT_LINEAR, ACT_RELU, ACT_RELU6

    cases = []
    for (i, h, w, ci, co, *_rest) in flagship_layers():
        if i not in S2D_LAYERS:
            continue
        for act in (ACT_LINEAR, ACT_LEAKY, ACT_RELU, ACT_RELU6):
            cases.append((f"layer{i}_act{act}", 2, h, w, ci, co, act, False, False))
        cases.append((f"layer{i}_dyn_exact", 2, h, w, ci, co, ACT_LEAKY, True, True))
    cases += [
        ("nonsquare_partial_c5", 2, 30, 22, 5, 24, ACT_LEAKY, True, True),
        ("nonsquare_partial_c16", 3, 50, 84, 16, 40, ACT_RELU6, False, False),
        ("nonsquare_c32", 1, 36, 20, 32, 64, ACT_LINEAR, True, False),
    ]
    return cases


def phase_k2(cuda_s2d, qconv, rng, errors):
    from yolo_quantization_tpu_torch.infer.convert import _s2d_weights

    cases = s2d_cases()
    for (name, n, h, w, ci, co, act, dyn, exact) in cases:
        x, wt, bias, m = random_layer(rng, n, h, w, ci, co, 3)
        if dyn:
            bias = rng.integers(-(2**14), 2**14, (n, co)).astype(np.int32)
            m = np.tile(m, (n, 1)) * rng.uniform(0.8, 1.25, (n, 1)).astype(np.float32)
        x_zp = rng.integers(-128, 128, (n,)).astype(np.int32) if dyn else int(rng.integers(-128, 128))
        out_zp = int(rng.integers(0, 256))
        xt, ws_t, b_t, m_t = (torch.from_numpy(a).cuda() for a in (x, _s2d_weights(wt), bias, m))
        zp_t = torch.from_numpy(x_zp).cuda() if dyn else x_zp
        ref = qconv.s2d_conv_phase_max(qconv.space_to_depth(xt), ws_t, b_t, m_t, zp_t, out_zp,
                                       act=act, exact_leaky=exact)
        got = cuda_s2d.s2d_conv_phase_max_cuda(xt, ws_t, b_t, m_t, zp_t, act=act,
                                               out_zp_static=out_zp, exact_leaky=exact)
        errors.check("s2d_qconv", name, got, ref)
        log(f"  {name:24s} x{(n, h, w, ci)} -> {co} act={act} per_image={dyn} "
            f"exact_leaky={exact}: equal")
    return len(cases)


def phase_probe(probe, errors):
    for k in probe.launches:
        probe.launches[k] = 0  # count the probe's main path only
    results = list(probe.run_cases("cuda"))
    launches = dict(probe.launches)
    for name, orientation, k, o, p, args, out in results:
        errors.check(f"orientation_{orientation}", name, out, probe.plain_matmul_i8(*args))
        log(f"  {name}: P={p} K={k} O={o}: equal (wrapped int8)")
    if launches != {"orientation_a": 2, "orientation_b": 2}:
        raise AssertionError(f"probe launches {launches}, expected 2 of each")
    return results, launches


def engine_configs():
    from yolo_quantization_tpu_torch.models.presets import flagship_program, parity_program

    flagship = flagship_program(classes=5, size=416, seed=0)
    return flagship, {
        "flagship": (flagship, {}, (13, 0)),
        "s2d": (flagship, dict(use_s2d=True), (10, 3)),
        "parity": (parity_program(classes=5, size=416, seed=0),
                   dict(dynamic_input=True, exact_leaky=True), (13, 0)),
        "int16": (flagship, dict(carrier="int16"), (13, 0)),
    }


def reset_counts(cuda_qconv, cuda_s2d):
    cuda_qconv.launches = 0
    cuda_s2d.launches = 0


def phase_engines(Engine, cuda_qconv, cuda_s2d, rng):
    flagship, configs = engine_configs()
    x = rng.uniform(0, 1, (4, 416, 416, 3)).astype(np.float32)
    x_u8 = rng.integers(0, 256, (4, 416, 416, 3), dtype=np.uint8)
    engines, main_launches, int8_outs = {}, {}, {}
    for cname, (program, option, (k1, k2)) in configs.items():
        eng_gpu = Engine(program, device="cuda", **option)
        eng_cpu = Engine(program, device="cpu", **option)
        engines[cname] = eng_gpu
        for name, batch in (("float32", x), ("uint8", x_u8)):
            reset_counts(cuda_qconv, cuda_s2d)
            heads_g, outs_g = eng_gpu.raw_heads(batch, return_outputs=True)
            got = (cuda_qconv.launches, cuda_s2d.launches)
            if got != (k1, k2):
                raise AssertionError(f"{cname}: (K1, K2) launches per forward {got}, expected {(k1, k2)}")
            heads_c, outs_c = eng_cpu.raw_heads(batch, return_outputs=True)
            for i, (g, c) in enumerate(zip(outs_g, outs_c)):
                if g.dtype != c.dtype or not np.array_equal(g, c):
                    raise AssertionError(f"{cname} {name} input: layer {i} differs between GPU and CPU")
            for g, c in zip(heads_g, heads_c):
                if not np.array_equal(g, c):
                    raise AssertionError(f"{cname} {name} input: dequantized heads differ")
            if cname == "flagship":
                int8_outs[name] = outs_g
            if cname == "int16":
                for i, (a, b) in enumerate(zip(outs_g, int8_outs[name])):
                    if not np.array_equal(a, b):
                        raise AssertionError(f"int16 carrier: layer {i} differs from the int8 engine")
            log(f"  {cname} {name} batch of 4: all {len(outs_g)} layer outputs equal to the CPU "
                f"engine{' and to the int8 engine' if cname == 'int16' else ''}; "
                f"{k1} K1 + {k2} K2 launches")
        # the engine's predict is this configuration's main path
        reset_counts(cuda_qconv, cuda_s2d)
        boxes, obj, cls = eng_gpu.predict(x)
        main_launches[cname] = (cuda_qconv.launches, cuda_s2d.launches)
        if main_launches[cname] != (k1, k2):
            raise AssertionError(f"{cname} predict launched {main_launches[cname]}, expected {(k1, k2)}")
        if not (np.isfinite(boxes).all() and np.isfinite(cls).all()
                and (obj >= 0).all() and (obj <= 1).all()):
            raise AssertionError(f"{cname} predict: non-finite boxes or objectness outside [0,1]")
        log(f"  {cname} predict: boxes {boxes.shape} finite, objectness in "
            f"[{obj.min():.4f}, {obj.max():.4f}]; launches K1 {k1}, K2 {k2}")
    return engines, main_launches


def phase_flip_size_f1(Engine, engines, rng):
    from yolo_quantization_tpu_torch.eval.f1 import f1_rows

    gpu = engines["flagship"]
    cpu = Engine(gpu.program, device="cpu")
    x = rng.uniform(0, 1, (2, 416, 416, 3)).astype(np.float32)
    for a, b in zip(gpu.predict(x, flip=True), cpu.predict(x, flip=True)):
        np.testing.assert_allclose(a, b, **DECODE_TOL)
    log("  flip TTA: GPU predict(flip=True) agrees with the CPU engine")
    g320, c320 = gpu.at_size(320), cpu.at_size(320)
    if g320 is not gpu.at_size(320) or g320.arrays is not gpu.arrays:
        raise AssertionError("at_size did not cache or share the device arrays")
    x320 = rng.uniform(0, 1, (2, 320, 320, 3)).astype(np.float32)
    for a, b in zip(g320.raw_heads(x320), c320.raw_heads(x320)):
        if not np.array_equal(a, b):
            raise AssertionError("at_size(320): heads differ between GPU and CPU")
    for a, b in zip(g320.predict(x320), c320.predict(x320)):
        np.testing.assert_allclose(a, b, **DECODE_TOL)
    log("  at_size(320): heads bit-equal and detections agree between GPU and CPU")
    xs = rng.uniform(0, 1, (8, 416, 416, 3)).astype(np.float32)
    truths = []
    for _ in range(len(xs)):
        nt = int(rng.integers(1, 6))
        t = np.zeros((nt, 5), np.float32)
        t[:, 0] = rng.integers(0, 5, nt)
        t[:, 1:3] = rng.uniform(0.2, 0.8, (nt, 2))
        t[:, 3:5] = rng.uniform(0.05, 0.5, (nt, 2))
        truths.append(t)
    rows = []
    for eng in (gpu, cpu):
        boxes, obj, _ = eng.predict(xs)
        rows.append(f1_rows([(boxes[i], obj[i], truths[i]) for i in range(len(xs))]))
    counts = [[(r.tp, r.tp_fp, r.tp_fn) for r in rr] for rr in rows]
    if counts[0] != counts[1]:
        raise AssertionError(f"f1_rows differ: GPU {counts[0]} CPU {counts[1]}")
    log(f"  f1_rows over GPU and CPU predictions: equal counts (TP, TP_FP, TP_FN) {counts[0]}")


def phase_serving(Server, Detection, cuda_qconv, cuda_s2d, engine, rng):
    sizes = [(416, 416), (300, 500), (480, 640), (120, 90), (416, 416), (333, 222),
             (600, 400), (64, 96), (250, 250), (720, 1280)]
    images = []
    for i, (h, w) in enumerate(sizes):
        if i % 3 == 1:
            images.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        else:
            images.append(rng.uniform(0, 1, (h, w, 3)).astype(np.float32))
    server = Server(engine, batch_size=(1, 4, 16))
    try:
        reset_counts(cuda_qconv, cuda_s2d)  # count the main path's launches only
        # a lone request (bucket 1), then a burst that batches together
        results = [server.submit(images[0], thresh=0.5, nms=0.45).result(timeout=300)]
        futures = [server.submit(im, thresh=0.5, nms=0.45) for im in images[1:]]
        results += [f.result(timeout=300) for f in futures]
        launches = cuda_qconv.launches
    finally:
        server.close()
    for dets in results:
        if not isinstance(dets, list) or not all(isinstance(d, Detection) for d in dets):
            raise AssertionError("a future did not resolve to a list of Detection")
        for d in dets:
            if not (np.isfinite(d.box).all() and 0.0 <= d.objectness <= 1.0):
                raise AssertionError("non-finite box or objectness outside [0,1]")
    if server.stats["images"] != len(images):
        raise AssertionError(f"stats images {server.stats['images']} != {len(images)} submitted")
    if launches == 0 or launches != 13 * server.stats["batches"]:
        raise AssertionError(f"{launches} kernel launches for {server.stats['batches']} batches")
    log(f"  {len(images)} requests ({sum(im.dtype == np.uint8 for im in images)} uint8) answered; "
        f"{sum(len(r) for r in results)} detections; batches {server.stats['batches']}, "
        f"buckets {server.stats['bucket_hist']}; kernel launches {launches}")
    return launches


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
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


class Totals:
    """Summed kernel, plain, bound and library times of one kernel entry."""

    def __init__(self):
        self.ms = self.plain_ms = self.bound_ms = self.bytes_bound_ms = 0.0
        self.library_ms: float | None = 0.0

    def add(self, ms, plain_ms, bound, library_ms):
        self.ms += ms
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
    log(f"  per-layer conv at batch 16 [{card}] (kernel vs plain float64 F.conv2d + requant on "
        "the same card; torch._int_mm int8 GEMM on the 1x1 layers where its shape rules allow; "
        "inputs warm in L2):")
    for (i, h, w, ci, co, k, pad, act, fused) in flagship_layers():
        x, wt, bias, m = random_layer(rng, 16, h, w, ci, co, k)
        xt, wt_t = torch.from_numpy(x).cuda(), torch.from_numpy(wt).cuda()
        b_t, m_t = torch.from_numpy(bias).cuda(), torch.from_numpy(m).cuda()
        wp = cuda_qconv.pack_weights(wt_t)

        def kernel():
            cuda_qconv.quantized_conv2d_cuda(xt, wt_t, b_t, m_t, 3, pad=pad, act=act,
                                             out_zp_static=0, fuse_pool=fused, out_i8=True,
                                             w_packed=wp)

        def plain():
            if fused:
                qconv.quantized_conv2d_pool(xt, wt_t, b_t, m_t, 3, 0, pad=pad, act=act, out_i8=True)
            else:
                qconv.quantized_conv2d(xt, wt_t, b_t, m_t, 3, None, 0, pad=pad, act=act,
                                       symmetric=True, out_i8=True)

        k_ms = cuda_time_ms(kernel, 20)
        p_ms = cuda_time_ms(plain, 5, warmup=1)
        lib_ms = None
        if k == 1 and int_mm_ok(16 * h * w, ci, co):
            a2, b2 = xt.reshape(-1, ci), wt_t.reshape(ci, co)
            lib_ms = cuda_time_ms(lambda: torch._int_mm(a2, b2), 20)
        oh, ow = (h // 2, w // 2) if fused else (h, w)
        mac = 16 * h * w * co * k * k * ci
        bound = bound_ms(16 * h * w * ci + k * k * ci * co + 8 * co + 16 * oh * ow * co, 2 * mac)
        tot.add(k_ms, p_ms, bound, lib_ms)
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        log(f"    layer {i:2d} {h}x{w}x{ci}->{co} k{k}{' +pool' if fused else ''}: kernel "
            f"{k_ms:.4f} ms ({mac / 1e9 / k_ms:.2f} TMAC/s), plain {p_ms:.4f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]}), _int_mm {lib} [{card}]")
    log(f"  all 13 convs at batch 16: kernel {tot.ms:.4f} ms, plain {tot.plain_ms:.4f} ms, "
        f"bound {tot.bound_ms:.4f} ms [{card}]")
    return tot


def time_k2_stem(cuda_qconv, cuda_s2d, qconv, rng, card):
    from yolo_quantization_tpu_torch.infer.convert import _s2d_weights

    tot = Totals()
    log(f"  s2d stem (K2) vs K1's fused stem at batch 16 [{card}]:")
    for (i, h, w, ci, co, k, pad, act, fused) in flagship_layers():
        if i not in S2D_LAYERS:
            continue
        x, wt, bias, m = random_layer(rng, 16, h, w, ci, co, 3)
        xt, wt_t = torch.from_numpy(x).cuda(), torch.from_numpy(wt).cuda()
        b_t, m_t = torch.from_numpy(bias).cuda(), torch.from_numpy(m).cuda()
        ws_t = torch.from_numpy(_s2d_weights(wt)).cuda()
        wp1, wp2 = cuda_qconv.pack_weights(wt_t), cuda_s2d.pack_weights(ws_t)

        def k2():
            cuda_s2d.s2d_conv_phase_max_cuda(xt, ws_t, b_t, m_t, 3, act=act, w_packed=wp2)

        def k1():
            cuda_qconv.quantized_conv2d_cuda(xt, wt_t, b_t, m_t, 3, pad=1, act=act,
                                             fuse_pool=True, out_i8=True, w_packed=wp1)

        def plain():
            qconv.s2d_conv_phase_max(qconv.space_to_depth(xt), ws_t, b_t, m_t, 3, 0, act=act)

        # K1 and K2 in turns: k1, k2, k2, k1
        t1a, t2a, t2b, t1b = (cuda_time_ms(f, 20) for f in (k1, k2, k2, k1))
        k1_ms, k2_ms = (t1a + t1b) / 2, (t2a + t2b) / 2
        p_ms = cuda_time_ms(plain, 5, warmup=1)
        mac = 16 * (h // 2) * (w // 2) * 4 * co * 9 * 4 * ci
        bound = bound_ms(16 * h * w * ci + 9 * 16 * ci * co + 8 * co + 16 * (h // 2) * (w // 2) * co,
                         2 * mac)
        tot.add(k2_ms, p_ms, bound, None)
        log(f"    layer {i} {h}x{w}x{ci}->{co} +pool: K2 {k2_ms:.4f} ms ({mac / 1e9 / k2_ms:.2f} TMAC/s "
            f"incl. zeros), K1 fused {k1_ms:.4f} ms, K2/K1 {k2_ms / k1_ms:.2f}x, plain {p_ms:.4f} ms, "
            f"bound {bound[0]:.4f} ms ({bound[1]}) [{card}]")
    log(f"  s2d stem layers 0/2/4 at batch 16: K2 {tot.ms:.4f} ms, plain {tot.plain_ms:.4f} ms "
        f"[{card}]")
    return tot


def time_engines(engines, rng, card):
    from yolo_quantization_tpu_torch.infer.engine import build_forward

    for b in (1, 16, 64):
        x = rng.uniform(0, 1, (b, 416, 416, 3)).astype(np.float32)
        xd = torch.from_numpy(x).cuda()
        for cname in ("flagship", "s2d", "parity"):
            if b == 1 and cname != "flagship":
                continue
            eng = engines[cname]
            forward = build_forward(eng.program, **eng.options)
            torch.cuda.reset_peak_memory_stats()

            def fwd():
                with torch.inference_mode():
                    forward(eng.arrays, xd)

            dev_ms = cuda_time_ms(fwd, 10)
            line = (f"  {cname:8s} batch {b:2d}: device forward {dev_ms:.3f} ms "
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
    tots = {"a": Totals(), "b": Totals()}
    for name, orientation, k, o, p, args, _ in results:
        fn = probe.orientation_a if orientation == "a" else probe.orientation_b
        ms = cuda_time_ms(lambda: fn(*args), 20)
        p_ms = cuda_time_ms(lambda: probe.plain_matmul_i8(*args), 3, warmup=1)
        a, b = args
        lib_ms = None
        if int_mm_ok(a.shape[0], a.shape[1], b.shape[1]):
            lib_ms = cuda_time_ms(lambda: torch._int_mm(a, b), 20)
        bound = bound_ms(p * k + k * o + p * o, 2 * p * k * o)
        tots[orientation].add(ms, p_ms, bound, lib_ms)
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none (m <= 16)"
        log(f"  {name}: kernel {ms:.4f} ms, plain {p_ms:.4f} ms, _int_mm {lib}, bound "
            f"{bound[0]:.4f} ms ({bound[1]}) [{card}]")
    return tots


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.infer.serving import Detection, Server
    from yolo_quantization_tpu_torch.ops import _build, cuda_qconv, cuda_s2d, qconv
    from yolo_quantization_tpu_torch.tools import orientation_probe as probe

    t_start = time.perf_counter()
    # the reference comparisons are integer or float64; state the float32 defaults anyway
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(8, os.cpu_count() or 1))

    log("phase 1: card")
    card = card_identity()
    kind = torch.cuda.get_device_name(0)
    log(f"  nvidia-smi: {card}; torch: {kind}; devices {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    log("phase 2: build")
    libs = ("qconv", "s2d_qconv", "gemm_probe")
    t0 = time.perf_counter()
    _build.build_all(libs)
    cuda_qconv.build()
    cuda_s2d.build()
    probe.build()
    log(f"  {', '.join(f'csrc/{n}.cu' for n in libs)} built in parallel and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in libs:
        log(f"  {name}: nvcc {_build.build_seconds.get(name, 0.0):.2f} s")
        for line in _build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"    ptxas: {line.strip()}")

    rng = np.random.default_rng(0)
    errors = Errors()
    log("phase 3: K1 (qconv) vs plain version (bit for bit)")
    log(f"  {phase_k1(cuda_qconv, qconv, rng, errors)} cases equal")
    log("phase 4: K2 (s2d_qconv) vs plain version (bit for bit)")
    log(f"  {phase_k2(cuda_s2d, qconv, rng, errors)} cases equal")
    log("phase 5: K3 (orientation probe) at the script's sizes vs plain version (bit for bit)")
    probe_results, probe_launches = phase_probe(probe, errors)

    log("phase 6: engines (yolov3-tiny 416, 5 classes) GPU vs CPU")
    engines, main_launches = phase_engines(Engine, cuda_qconv, cuda_s2d, rng)

    log("phase 7: flip TTA, at_size(320), f1_rows")
    phase_flip_size_f1(Engine, engines, rng)

    log("phase 8: serving")
    launches = phase_serving(Server, Detection, cuda_qconv, cuda_s2d, engines["flagship"], rng)

    log("phase 9: timings")
    k1 = time_k1_layers(cuda_qconv, qconv, rng, card)
    k2 = time_k2_stem(cuda_qconv, cuda_s2d, qconv, rng, card)
    time_engines(engines, rng, card)
    k3 = time_probe(probe, probe_results, card)
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [
        k1.entry("qconv", "yolo_quantization_tpu_torch/csrc/qconv.cu",
                 "yolo_quantization_tpu/ops/pallas_qconv.py:173", launches, errors.worst["qconv"]),
        k2.entry("s2d_qconv", "yolo_quantization_tpu_torch/csrc/s2d_qconv.cu",
                 "yolo_quantization_tpu/ops/pallas_qconv.py:356", main_launches["s2d"][1],
                 errors.worst["s2d_qconv"]),
        k3["a"].entry("orientation_a", "yolo_quantization_tpu_torch/csrc/gemm_probe.cu",
                      "scripts/mxu_orientation_probe.py:47", probe_launches["orientation_a"],
                      errors.worst["orientation_a"]),
        k3["b"].entry("orientation_b", "yolo_quantization_tpu_torch/csrc/gemm_probe.cu",
                      "scripts/mxu_orientation_probe.py:75", probe_launches["orientation_b"],
                      errors.worst["orientation_b"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
