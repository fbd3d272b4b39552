#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. card identity (nvidia-smi name and power limit, torch device name);
  2. build the four kernel libraries (csrc/qconv.cu, s2d_qconv.cu,
     gemm_probe.cu, shortcut.cu), one nvcc each, all started together; print
     each kernel's ptxas registers, spills and static shared memory, and its
     IMMA (int8 tensor-core) and IDP (__dp4a) instructions from cuobjdump's
     SASS; K1's int8 instantiations, every K2 instantiation and both probe
     kernels must hold IMMA, and K1's symmetric ones, K2's and
     orientation_b no IDP;
  3. K1 (qconv) vs its plain PyTorch version, bit for bit: every flagship
     conv shape at 416x416, at batch 2 plain and with each reference-engine
     option (asymmetric w_zp, per-image zp and (N,Co) bias/m, exact_leaky,
     the int16 carrier), and at batch 16 (the timed shapes, where the large
     layers take the 128x128 tile) plain, asymmetric and with the parity
     engine's options; fused pool where the plan has it; plus edge cases
     (Co 30/130, Cin 3/6/16, M off every tile, pooled partial tiles, every
     block tile of the launch table, K=1, every activation, ties, uint8 in).
     Then stride 2: yolov3's five stride-2 convs at batch 2 and 16 and with
     each option, odd maps (13 -> 7, 9x11), Cin 3 and 6, every block tile;
  4. K2 (s2d_qconv) vs its plain version, bit for bit: layers 0, 2, 4 at 416,
     batch 2, every activation, per-image zp/bias/m, exact_leaky, and at
     batch 16 (the timed shapes) plain and with the per-image options;
     non-square maps, and a case per entry of K2's tile table with partial
     M and N tiles and an arbitrary block kernel;
  5. K3 (orientation_a/b): the probe's four cases at the script's full
     sizes, each kernel vs its plain version bit for bit — the probe's main
     path, whose launches are counted; then orientation_b on a P that is not
     a multiple of its 128-pixel tile;
  5b. the integer shortcut kernel vs its plain version, bit for bit: all
     65,536 code pairs under seeded grids for each activation, one shortcut
     of each yolov3 stage at batch 16, lengths off the 16-code vector, and
     an unaligned view (ValueError);
  6. engines on the GPU vs on the CPU, every layer's codes equal, float32 and
     uint8 batches of 4: the flagship (13 K1 launches per forward), the
     flagship with use_s2d (3 K2 + 10 K1), the C-parity configuration (leaky,
     asymmetric, dynamic_input, exact_leaky; 13 K1; also a float32 batch of
     16, whose large layers take the 128x128 tile) and the int16 carrier
     (codes equal to the int8 engine's); then full yolov3 (80 classes, 416)
     on batches of 2, all 107 layers: "v3" (synthetic ranges) and
     "v3-perturbed" (ranges off the synthetic rationals, asymmetric
     weights, dynamic_input, exact_leaky), 75 K1 + 23 shortcut launches per
     forward; each engine's predict is a main path with counted launches;
  7. flip TTA and at_size(320) agree between GPU and CPU for yolov3-tiny and
     yolov3, and f1_rows over GPU and CPU predictions gives equal counts;
  8. Servers with the (1, 4, 16) bucket ladder answer seeded requests of
     mixed sizes, float and uint8 — the serving main paths: yolov3-tiny (13
     K1 launches per batch) and yolov3 (75 K1 + 23 shortcut per batch);
  9. timings, printed and not asserted
     (yolo_quantization_tpu_torch/tools/kernel_timings.py, which also runs
     alone): each kernel graph-timed (its device time) beside its eager
     time, its bound, the plain version and torch._int_mm; K1 on yolov3's
     stride-2 convs; the shortcut kernel per yolov3 stage; the engines'
     device forwards.

Prints a {"kernels": [...]} JSON line, then the card's nvidia-smi line, and
last {"ok": true, "device": {...}}.  Needs one CUDA device and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# decoded floats: sigmoid/exp differ between the card and the CPU by ulps
DECODE_TOL = dict(rtol=1e-5, atol=1e-6)
# K1's tile edges (n, h, w, ci, co, k, pad, fuse_pool), by the block tile
# the launch table gives them on a 132-SM card: Co 30 and 130 (padded and
# partial N tiles), Cin 3 and 6, 16, 32 and 64, M off every tile, pooled
# layers whose last 32-row group is partial
TILE_EDGES = (
    # the byte gather (Cin % 16 != 0): 128x32 and 128x16
    (1, 7, 9, 3, 30, 3, 1, False),
    (2, 10, 6, 3, 130, 3, 1, True),
    (3, 9, 11, 6, 30, 3, 1, False),
    (1, 6, 14, 6, 130, 3, 1, True),
    (2, 9, 13, 3, 16, 3, 1, False),
    # the pooled 3-channel stem's window loader: 512x16
    (4, 24, 24, 3, 16, 3, 1, True),
    (3, 10, 14, 3, 16, 3, 1, True),
    # 16-byte copies, Co <= 16: 128x16
    (2, 26, 26, 16, 16, 3, 1, True),
    # Co <= 32: 64x32 (fewer blocks than SMs at 128x32), then 128x32
    (2, 13, 13, 16, 30, 1, 0, False),
    (3, 22, 18, 16, 30, 3, 1, True),
    (40, 13, 13, 64, 30, 3, 1, False),
    (6, 50, 60, 16, 30, 3, 1, False),
    # Co <= 64: 64x64, then 128x64
    (9, 20, 20, 16, 64, 3, 1, False),
    (2, 12, 12, 32, 64, 3, 1, True),
    (6, 50, 60, 16, 64, 3, 1, False),
    (27, 22, 30, 32, 64, 3, 1, True),
    # Co > 64: 64x64, then 128x128
    (1, 11, 5, 16, 130, 3, 1, False),
    (1, 5, 3, 64, 130, 3, 1, False),
    (13, 26, 26, 32, 130, 1, 0, False),
    (7, 42, 58, 16, 130, 3, 1, True),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_report(log_text: str) -> dict[str, dict]:
    """Registers, spill bytes and static shared memory per kernel from
    nvcc's -Xptxas -v output."""
    out, fn = {}, None
    for line in log_text.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            fn = m.group(1)
            out[fn] = {"registers": 0, "spill": "0/0", "smem": 0}
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[fn]["spill"] = f"{m.group(1)}/{m.group(2)}"
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out[fn]["registers"] = int(m.group(1))
            if sm := re.search(r"(\d+) bytes smem", line):
                out[fn]["smem"] = int(sm.group(1))
    return out


def sass_counts(lib_path) -> dict[str, dict]:
    """IMMA (int8 tensor-core mma) and IDP (__dp4a) instructions per kernel
    in a built library, from cuobjdump --dump-sass."""
    from yolo_quantization_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib_path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            fn = m.group(1)
            out[fn] = {"IMMA": 0, "IDP": 0}
        elif fn:
            out[fn]["IMMA"] += bool(re.search(r"\bIMMA\b", line))
            out[fn]["IDP"] += bool(re.search(r"\bIDP\b", line))
    return out


def demangle(names) -> dict[str, str]:
    """Readable kernel names through the toolkit's cu++filt, where it has one."""
    from yolo_quantization_tpu_torch.ops import _build

    names = list(names)
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cu++filt")
    if not names or not os.path.exists(tool):
        return {n: n for n in names}
    got = subprocess.run([tool], input="\n".join(names), check=True, capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return dict(zip(names, got)) if len(got) == len(names) else {n: n for n in names}


def phase_kernel_report(libs) -> None:
    """Print ptxas and SASS facts per kernel; K1's int8 instantiations, K2's
    and the probe kernels must run on IMMA, and K1's symmetric int8 ones,
    K2's and orientation_b must hold no IDP (no product on __dp4a)."""
    from yolo_quantization_tpu_torch.ops import _build

    for name in libs:
        ptx = ptxas_report(_build.build_log.get(name, ""))
        sass = sass_counts(_build.library_path(name))
        readable = demangle(sass)
        for fn, counts in sass.items():
            info = ptx.get(fn, {})
            regs = info.get("registers", "?")
            log(f"    {name}: {readable[fn]}: {regs} registers, spill stores/loads "
                f"{info.get('spill', '?')} B, static smem {info.get('smem', '?')} B, "
                f"IMMA {counts['IMMA']}, IDP {counts['IDP']}")
            if (name in ("s2d_qconv", "gemm_probe") or "qconv_mma" in fn) and counts["IMMA"] == 0:
                raise AssertionError(f"{readable[fn]}: no IMMA instruction")
            if (name == "s2d_qconv" or "orientation_b" in fn) and counts["IDP"]:
                raise AssertionError(f"{readable[fn]}: a product runs on __dp4a")
            args = re.search(r"qconv_mma_kernelI((?:L[a-z]\d+E)+)E", fn)
            asym = args and re.findall(r"L[a-z](\d+)E", args.group(1))[4] == "1"
            if args and not asym and counts["IDP"]:
                raise AssertionError(f"{readable[fn]}: a symmetric int8 conv runs __dp4a")


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


def conv_cases():
    """(name, n, h, w, ci, co, k, pad, act, out_i8, fuse_pool, variant, stride).

    Variants: "" plain symmetric; "asym" weight zero points; "dyn" per-image
    zero points and (N,Co) bias/m; "exact" double-rounded leaky; "int16" the
    int16 carrier; "all" every option at once; "parity" the parity engine's
    options (asym, dyn and exact on the int8 carrier); "pow2_m" power-of-two
    multipliers (ties for rint); "uint8" uint8 input codes.
    """
    from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY, ACT_LINEAR, ACT_RELU, ACT_RELU6
    from yolo_quantization_tpu_torch.tools.kernel_timings import flagship_layers

    cases = []
    for (i, h, w, ci, co, k, pad, act, fused) in flagship_layers():
        cases.append((f"layer{i}", 2, h, w, ci, co, k, pad, act, True, fused, ""))
        cases.append((f"layer{i}_b16", 16, h, w, ci, co, k, pad, act, True, fused, ""))
        cases.append((f"layer{i}_b16_asym", 16, h, w, ci, co, k, pad, act, True, fused, "asym"))
        cases.append((f"layer{i}_b16_parity", 16, h, w, ci, co, k, pad, ACT_LEAKY, True, fused,
                      "parity"))
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
    for j, (n, h, w, ci, co, k, pad, pool) in enumerate(TILE_EDGES):
        for variant in ("", "asym"):
            cases.append((f"edge{j}_{variant or 'sym'}", n, h, w, ci, co, k, pad, ACT_LEAKY, True,
                          pool, variant))
    return [case + (1,) for case in cases] + stride2_cases()


# K1 at stride 2 (n, h, w, ci, co, k, pad) by loader and by the block tile
# the launch table gives them on a 132-SM card (as
# tests/test_torch_qconv.py::STRIDE2_EDGES): the byte gather (Ci 3, 6, 8),
# 16-byte copies through L1 (Ci <= 32) and not, each N tile, M off the tile,
# odd maps, 1x1 at stride 2
STRIDE2_EDGES = (
    (2, 13, 13, 3, 30, 3, 1), (3, 9, 11, 6, 130, 3, 1), (1, 20, 20, 8, 16, 3, 1),
    (2, 26, 26, 16, 16, 3, 1), (1, 13, 13, 16, 30, 3, 1), (8, 50, 60, 32, 30, 3, 1),
    (2, 13, 13, 32, 64, 3, 1), (9, 40, 40, 32, 64, 3, 1), (1, 13, 13, 64, 130, 3, 1),
    (16, 26, 26, 128, 256, 3, 1), (2, 9, 11, 64, 40, 1, 0),
)


def stride2_cases():
    """K1's stride-2 cases, in conv_cases' form: yolov3's five stride-2 convs
    at batch 2 (plain and each option) and 16 (plain, asymmetric), odd maps,
    Cin 3 and 6, and every block tile."""
    from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY, ACT_LINEAR, ACT_RELU6
    from yolo_quantization_tpu_torch.tools.kernel_timings import v3_stride2_layers

    cases = []
    for (i, h, w, ci, co, k, pad) in v3_stride2_layers():
        for n, variant in ((2, ""), (16, ""), (16, "asym"), (2, "asym"), (2, "dyn"), (2, "exact"),
                           (2, "int16")):
            name = f"v3_layer{i}_s2_b{n}{'_' + variant if variant else ''}"
            cases.append((name, n, h, w, ci, co, k, pad, ACT_LEAKY, True, False, variant))
    cases += [
        ("s2_odd13", 2, 13, 13, 64, 96, 3, 1, ACT_LEAKY, True, False, ""),
        ("s2_odd13_all", 2, 13, 13, 64, 96, 3, 1, ACT_LEAKY, True, False, "all"),
        ("s2_odd_9x11", 3, 9, 11, 32, 40, 3, 1, ACT_RELU6, False, False, ""),
        ("s2_odd_9x11_all", 3, 9, 11, 32, 40, 3, 1, ACT_LEAKY, True, False, "all"),
        ("s2_cin3", 2, 30, 22, 3, 32, 3, 1, ACT_LINEAR, True, False, ""),
        ("s2_cin3_asym", 2, 30, 22, 3, 32, 3, 1, ACT_LEAKY, True, False, "asym"),
        ("s2_cin6", 3, 17, 21, 6, 40, 3, 1, ACT_RELU6, False, False, ""),
        ("s2_cin6_all", 3, 17, 21, 6, 40, 3, 1, ACT_LEAKY, True, False, "all"),
    ]
    for j, (n, h, w, ci, co, k, pad) in enumerate(STRIDE2_EDGES):
        for variant in ("", "asym"):
            cases.append((f"s2_edge{j}_{variant or 'sym'}", n, h, w, ci, co, k, pad, ACT_LEAKY, True,
                          False, variant))
    return [case + (2,) for case in cases]


def phase_k1(cuda_qconv, qconv, rng, errors):
    from yolo_quantization_tpu_torch.tools.kernel_timings import random_layer

    cases = conv_cases()
    for (name, n, h, w, ci, co, k, pad, act, out_i8, pool, variant, stride) in cases:
        x, wt, bias, m = random_layer(rng, n, h, w, ci, co, k)
        dyn = variant in ("dyn", "all", "all_pow2_m", "parity")
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
                if variant in ("asym", "all", "all_pow2_m", "parity") else None)
        opts = dict(exact_leaky=variant in ("exact", "all", "all_pow2_m", "parity"),
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
            ref = qconv.quantized_conv2d(xt, wt_t, b_t, m_t, zp_t, wzp_t, out_zp, stride=stride,
                                         pad=pad, act=act, symmetric=w_zp is None,
                                         out_i8=out_i8, **opts)
        got = cuda_qconv.quantized_conv2d_cuda(
            xt, wt_t, b_t, m_t, zp_t, stride=stride, pad=pad, act=act, out_zp_static=out_zp,
            fuse_pool=pool, out_i8=out_i8, w_zp=wzp_t, **opts,
        )
        errors.check("qconv", name, got, ref)
        log(f"  {name:24s} x{(n, h, w, ci)} w{(k, k, ci, co)} s{stride} act={act} out_i8={out_i8} "
            f"pool={pool} {variant or 'plain'}: equal")
    return sum(c[-1] == 1 for c in cases), sum(c[-1] == 2 for c in cases)


# K2's tile edges (n, h, w, c, o), by the block tile its launch table gives
# them on a 132-SM card, with partial M and N tiles (as
# tests/test_torch_s2d.py::EDGES)
S2D_TILE_EDGES = (
    # the stem loader (C == 3): 128x64
    (1, 30, 22, 3, 16), (2, 12, 20, 3, 24),
    # the byte gather (other C % 16 != 0): 128x64
    (1, 10, 14, 6, 8), (3, 8, 6, 7, 40),
    # 16-byte copies, N = 4*O <= 64: 128x64, then 64x64 (fewer blocks than SMs)
    (2, 184, 184, 16, 13), (1, 20, 36, 16, 12), (3, 22, 18, 32, 16),
    # N > 64: 128x128, then 64x64
    (2, 200, 160, 16, 40), (4, 120, 100, 48, 33), (1, 10, 6, 64, 20),
)


def s2d_cases():
    """(name, n, h, w, ci, co, act, per-image zp/bias/m, exact_leaky, an
    arbitrary block kernel instead of _s2d_weights')."""
    from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY, ACT_LINEAR, ACT_RELU, ACT_RELU6
    from yolo_quantization_tpu_torch.tools.kernel_timings import S2D_LAYERS, flagship_layers

    cases = []
    for (i, h, w, ci, co, *_rest) in flagship_layers():
        if i not in S2D_LAYERS:
            continue
        for act in (ACT_LINEAR, ACT_LEAKY, ACT_RELU, ACT_RELU6):
            cases.append((f"layer{i}_act{act}", 2, h, w, ci, co, act, False, False, False))
        cases.append((f"layer{i}_dyn_exact", 2, h, w, ci, co, ACT_LEAKY, True, True, False))
        cases.append((f"layer{i}_b16", 16, h, w, ci, co, ACT_RELU6, False, False, False))
        cases.append((f"layer{i}_b16_dyn_exact", 16, h, w, ci, co, ACT_LEAKY, True, True, False))
    cases += [
        ("nonsquare_partial_c5", 2, 30, 22, 5, 24, ACT_LEAKY, True, True, False),
        ("nonsquare_partial_c16", 3, 50, 84, 16, 40, ACT_RELU6, False, False, False),
        ("nonsquare_c32", 1, 36, 20, 32, 64, ACT_LINEAR, True, False, False),
    ]
    for j, (n, h, w, ci, co) in enumerate(S2D_TILE_EDGES):
        cases.append((f"edge{j}", n, h, w, ci, co, ACT_LEAKY, True, True, True))
    return cases


def phase_k2(cuda_s2d, qconv, rng, errors):
    from yolo_quantization_tpu_torch.infer.convert import _s2d_weights
    from yolo_quantization_tpu_torch.tools.kernel_timings import random_layer

    cases = s2d_cases()
    for (name, n, h, w, ci, co, act, dyn, exact, any_w) in cases:
        x, wt, bias, m = random_layer(rng, n, h, w, ci, co, 3)
        w_s2d = _s2d_weights(wt)
        if any_w:  # every tap nonzero: 4x the terms, so a smaller m keeps codes off the clamps
            w_s2d = rng.integers(-127, 128, w_s2d.shape).astype(np.int8)
            m = m / 2
        if dyn:
            bias = rng.integers(-(2**14), 2**14, (n, co)).astype(np.int32)
            m = np.tile(m, (n, 1)) * rng.uniform(0.8, 1.25, (n, 1)).astype(np.float32)
        x_zp = rng.integers(-128, 128, (n,)).astype(np.int32) if dyn else int(rng.integers(-128, 128))
        out_zp = int(rng.integers(0, 256))
        xt, ws_t, b_t, m_t = (torch.from_numpy(a).cuda() for a in (x, w_s2d, bias, m))
        zp_t = torch.from_numpy(x_zp).cuda() if dyn else x_zp
        ref = qconv.s2d_conv_phase_max(qconv.space_to_depth(xt), ws_t, b_t, m_t, zp_t, out_zp,
                                       act=act, exact_leaky=exact)
        got = cuda_s2d.s2d_conv_phase_max_cuda(xt, ws_t, b_t, m_t, zp_t, act=act,
                                               out_zp_static=out_zp, exact_leaky=exact)
        errors.check("s2d_qconv", name, got, ref)
        log(f"  {name:24s} x{(n, h, w, ci)} -> {co} act={act} per_image={dyn} "
            f"exact_leaky={exact}{' any w_s2d' if any_w else ''}: equal")
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
    # B's kernel walks 128-pixel tiles: a P off the tile (not counted above)
    for k, o, p in ((128, 64, 128 * 5407 + 48), (32, 16, 128 * 21 + 16)):
        w, x = probe.case_inputs("b", k, o, p, 11, "cuda")
        errors.check("orientation_b", f"partial tile P={p}", probe.orientation_b(w, x),
                     probe.plain_matmul_i8(w, x))
        log(f"  B P={p} K={k} O={o} (P % 128 = {p % 128}): equal (wrapped int8)")
    return results, launches


def phase_shortcut(cuda_shortcut, shortcut, rng, errors):
    """The shortcut kernel against its plain version on the card."""
    from yolo_quantization_tpu_torch.tools.kernel_timings import v3_shortcut_shapes

    codes = torch.arange(-128, 128, dtype=torch.int8)
    pair_x = codes.repeat_interleave(256).cuda()  # every (x, skip) pair of codes: 65,536
    pair_k = codes.repeat(256).cuda()

    def grid(seed, activation):
        g = np.random.default_rng(seed)
        return shortcut.shortcut_params((float(g.uniform(0.005, 0.05)), int(g.integers(0, 256))),
                                        (float(g.uniform(0.005, 0.05)), int(g.integers(0, 256))),
                                        float(g.uniform(0.01, 0.06)), int(g.integers(0, 256)), activation)

    cases = 0
    for activation in ("linear", "leaky", "relu", "relu6"):
        for seed in range(4):
            k = grid(seed, activation)
            errors.check("shortcut", f"pairs_{activation}_{seed}", cuda_shortcut.int_shortcut_cuda(pair_x, pair_k, k),
                         shortcut.int_shortcut(pair_x, pair_k, k))
            cases += 1
        log(f"  all 65,536 code pairs, {activation}, 4 seeded grids: equal")
    shapes = [(16, h, w, c) for (_, h, w, c) in v3_shortcut_shapes()] + [(1, 1, 3, 5), (3, 7, 11, 13)]
    for j, shape in enumerate(shapes):
        x = torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).cuda()
        skip = torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).cuda()
        k = grid(100 + j, ("linear", "leaky")[j % 2])
        errors.check("shortcut", f"shape{shape}", cuda_shortcut.int_shortcut_cuda(x, skip, k),
                     shortcut.int_shortcut(x, skip, k))
        cases += 1
        log(f"  {shape} ({x.numel()} codes, {x.numel() % 16} in the scalar tail): equal")
    flat = torch.zeros(4096 + 16, dtype=torch.int8, device="cuda")
    try:
        cuda_shortcut.int_shortcut_cuda(flat[1:4097], flat[16:4112], grid(0, "linear"))
    except ValueError as e:
        log(f"  an unaligned view raises ValueError: {e}")
    else:
        raise AssertionError("the shortcut wrapper took an operand off a 16-byte boundary")
    return cases


def engine_configs():
    """name -> (program, options, launches per forward (K1, K2, shortcut)):
    yolov3-tiny's configurations, then yolov3's (``v3``, ``v3-perturbed``)
    as ``tools/profile_engine.py`` builds them."""
    from yolo_quantization_tpu_torch.models.presets import flagship_program, parity_program
    from yolo_quantization_tpu_torch.tools.profile_engine import configurations

    flagship = flagship_program(classes=5, size=416, seed=0)
    return {
        "flagship": (flagship, {}, (13, 0, 0)),
        "s2d": (flagship, dict(use_s2d=True), (10, 3, 0)),
        "parity": (parity_program(classes=5, size=416, seed=0),
                   dict(dynamic_input=True, exact_leaky=True), (13, 0, 0)),
        "int16": (flagship, dict(carrier="int16"), (13, 0, 0)),
        **{name: (program, option, (75, 0, 23))
           for name, (program, option) in configurations(v3=True).items()},
    }


def reset_counts(*wrappers):
    for w in wrappers:
        w.launches = 0


def phase_engines(Engine, counters, rng):
    x = rng.uniform(0, 1, (4, 416, 416, 3)).astype(np.float32)
    x_u8 = rng.integers(0, 256, (4, 416, 416, 3), dtype=np.uint8)
    # the parity engine at batch 16 too: its large layers take K1's 128x128 tile there
    x16 = rng.uniform(0, 1, (16, 416, 416, 3)).astype(np.float32)
    engines, main_launches, int8_outs = {}, {}, {}
    for cname, (program, option, expected) in engine_configs().items():
        eng_gpu = Engine(program, device="cuda", **option)
        eng_cpu = Engine(program, device="cpu", **option)
        engines[cname] = eng_gpu
        if cname.startswith("v3"):  # 33 GMAC an image: the CPU side runs batches of 2
            batches = [("float32", x[:2]), ("uint8", x_u8[:2])]
        else:
            batches = [("float32", x), ("uint8", x_u8)] + ([("float32", x16)] if cname == "parity" else [])
        for name, batch in batches:
            reset_counts(*counters)
            heads_g, outs_g = eng_gpu.raw_heads(batch, return_outputs=True)
            got = tuple(c.launches for c in counters)
            if got != expected:
                raise AssertionError(f"{cname}: (K1, K2, shortcut) launches per forward {got}, "
                                     f"expected {expected}")
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
            log(f"  {cname} {name} batch of {len(batch)}: all {len(outs_g)} layer outputs equal to the CPU "
                f"engine{' and to the int8 engine' if cname == 'int16' else ''}; "
                f"{expected[0]} K1 + {expected[1]} K2 + {expected[2]} shortcut launches")
        # the engine's predict is this configuration's main path
        reset_counts(*counters)
        boxes, obj, cls = eng_gpu.predict(batches[0][1])
        main_launches[cname] = tuple(c.launches for c in counters)
        if main_launches[cname] != expected:
            raise AssertionError(f"{cname} predict launched {main_launches[cname]}, expected {expected}")
        if not (np.isfinite(boxes).all() and np.isfinite(cls).all()
                and (obj >= 0).all() and (obj <= 1).all()):
            raise AssertionError(f"{cname} predict: non-finite boxes or objectness outside [0,1]")
        log(f"  {cname} predict: boxes {boxes.shape} finite, objectness in "
            f"[{obj.min():.4f}, {obj.max():.4f}]; launches K1 {expected[0]}, K2 {expected[1]}, "
            f"shortcut {expected[2]}")
    return engines, main_launches


def phase_flip_size_f1(Engine, engines, rng):
    from yolo_quantization_tpu_torch.eval.f1 import f1_rows

    for cname, n in (("flagship", 2), ("v3", 1)):
        gpu = engines[cname]
        cpu = Engine(gpu.program, device="cpu")
        x = rng.uniform(0, 1, (n, 416, 416, 3)).astype(np.float32)
        for a, b in zip(gpu.predict(x, flip=True), cpu.predict(x, flip=True)):
            np.testing.assert_allclose(a, b, **DECODE_TOL)
        log(f"  {cname} flip TTA: GPU predict(flip=True) agrees with the CPU engine")
        g320, c320 = gpu.at_size(320), cpu.at_size(320)
        if g320 is not gpu.at_size(320) or g320.arrays is not gpu.arrays:
            raise AssertionError("at_size did not cache or share the device arrays")
        x320 = rng.uniform(0, 1, (n, 320, 320, 3)).astype(np.float32)
        for a, b in zip(g320.raw_heads(x320), c320.raw_heads(x320)):
            if not np.array_equal(a, b):
                raise AssertionError(f"{cname} at_size(320): heads differ between GPU and CPU")
        for a, b in zip(g320.predict(x320), c320.predict(x320)):
            np.testing.assert_allclose(a, b, **DECODE_TOL)
        log(f"  {cname} at_size(320): heads bit-equal and detections agree between GPU and CPU")
    gpu, cpu = engines["flagship"], Engine(engines["flagship"].program, device="cpu")
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


def phase_serving(Server, Detection, counters, engine, per_batch, rng, sizes):
    """A Server over ``engine`` answers seeded requests of ``sizes``; each
    batch must launch ``per_batch`` (K1, K2, shortcut) kernels.  Returns the
    launches of the run."""
    images = []
    for i, (h, w) in enumerate(sizes):
        if i % 3 == 1:
            images.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        else:
            images.append(rng.uniform(0, 1, (h, w, 3)).astype(np.float32))
    server = Server(engine, batch_size=(1, 4, 16))
    try:
        reset_counts(*counters)  # count the main path's launches only
        # a lone request (bucket 1), then a burst that batches together
        results = [server.submit(images[0], thresh=0.5, nms=0.45).result(timeout=300)]
        futures = [server.submit(im, thresh=0.5, nms=0.45) for im in images[1:]]
        results += [f.result(timeout=300) for f in futures]
        launches = tuple(c.launches for c in counters)
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
    batches = server.stats["batches"]
    if batches == 0 or launches != tuple(k * batches for k in per_batch):
        raise AssertionError(f"(K1, K2, shortcut) launches {launches} for {batches} batches, "
                             f"expected {per_batch} each")
    log(f"  {len(images)} requests ({sum(im.dtype == np.uint8 for im in images)} uint8) answered; "
        f"{sum(len(r) for r in results)} detections; batches {batches}, "
        f"buckets {server.stats['bucket_hist']}; (K1, K2, shortcut) launches {launches}")
    return launches


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA GPU")
    if argv:
        raise SystemExit(f"chip_smoke: unknown arguments {argv}; see the docstring")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.infer.serving import Detection, Server
    from yolo_quantization_tpu_torch.ops import _build, cuda_qconv, cuda_s2d, cuda_shortcut, qconv, shortcut
    from yolo_quantization_tpu_torch.tools import kernel_timings as timings
    from yolo_quantization_tpu_torch.tools import orientation_probe as probe

    t_start = time.perf_counter()
    # the reference comparisons are integer or float64; state the float32 defaults anyway
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(8, os.cpu_count() or 1))

    log("phase 1: card")
    card = timings.card_identity()
    kind = torch.cuda.get_device_name(0)
    log(f"  nvidia-smi: {card}; torch: {kind}; devices {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    log("phase 2: build")
    libs = _build.LIBRARIES
    t0 = time.perf_counter()
    _build.build_all(libs)
    cuda_qconv.build()
    cuda_s2d.build()
    cuda_shortcut.build()
    probe.build()
    log(f"  {', '.join(f'csrc/{n}.cu' for n in libs)} built in parallel and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in libs:
        log(f"  {name}: nvcc {_build.build_seconds.get(name, 0.0):.2f} s")
        for line in _build.build_log.get(name, "").splitlines():
            if "error" in line:
                log(f"    nvcc: {line.strip()}")
    phase_kernel_report(libs)

    rng = np.random.default_rng(0)
    errors = Errors()
    log("phase 3: K1 (qconv) vs plain version (bit for bit)")
    n1, n2 = phase_k1(cuda_qconv, qconv, rng, errors)
    log(f"  {n1} stride-1 and {n2} stride-2 cases equal")
    log("phase 4: K2 (s2d_qconv) vs plain version (bit for bit)")
    log(f"  {phase_k2(cuda_s2d, qconv, rng, errors)} cases equal")
    log("phase 5: K3 (orientation probe) at the script's sizes vs plain version (bit for bit)")
    probe_results, probe_launches = phase_probe(probe, errors)
    log("phase 5b: the integer shortcut vs plain version (bit for bit)")
    log(f"  {phase_shortcut(cuda_shortcut, shortcut, rng, errors)} cases equal")

    counters = (cuda_qconv, cuda_s2d, cuda_shortcut)
    log("phase 6: engines (yolov3-tiny 416, 5 classes; yolov3 416, 80 classes) GPU vs CPU")
    engines, main_launches = phase_engines(Engine, counters, rng)

    log("phase 7: flip TTA, at_size(320), f1_rows")
    phase_flip_size_f1(Engine, engines, rng)

    log("phase 8: serving")
    launches = phase_serving(Server, Detection, counters, engines["flagship"], (13, 0, 0), rng,
                             [(416, 416), (300, 500), (480, 640), (120, 90), (416, 416), (333, 222),
                              (600, 400), (64, 96), (250, 250), (720, 1280)])
    phase_serving(Server, Detection, counters, engines["v3"], (75, 0, 23), rng,
                  [(416, 416), (480, 640), (120, 90), (333, 222), (720, 1280), (256, 256)])

    log("phase 9: timings")
    k1, k2, k3, sc = timings.time_all(engines, probe_results, card, rng)
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [
        k1.entry("qconv", "yolo_quantization_tpu_torch/csrc/qconv.cu",
                 "yolo_quantization_tpu/ops/pallas_qconv.py:173", launches[0], errors.worst["qconv"]),
        k2.entry("s2d_qconv", "yolo_quantization_tpu_torch/csrc/s2d_qconv.cu",
                 "yolo_quantization_tpu/ops/pallas_qconv.py:356", main_launches["s2d"][1],
                 errors.worst["s2d_qconv"]),
        sc.entry("shortcut", "yolo_quantization_tpu_torch/csrc/shortcut.cu",
                 "yolo_quantization_tpu/infer/engine.py:428-469", main_launches["v3"][2],
                 errors.worst["shortcut"]),
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
    sys.exit(main(sys.argv[1:]))
