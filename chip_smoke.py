#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero.  They run in
this order but for three moves that keep the script inside its time limit:
phase 10 (no kernel of the repo) runs while phase 2's nvcc processes
build; phase 20 (b) trains in a process of its own from the end of phase 2
to the end of phase 14, and phases 12 and 14 run before phase 9, so that
no timed phase (9, 11, 15-19) runs beside it:

  1. card identity (nvidia-smi name and power limit, torch device name);
  2. build the five kernel libraries (csrc/qconv.cu, s2d_qconv.cu,
     gemm_probe.cu, shortcut.cu, spp.cu), one nvcc each, all started together, while
     phase 10 (which launches none of them) runs; print
     each kernel's ptxas registers, spills and static shared memory, and its
     IMMA (int8 mma.sync), IGMMA (int8 wgmma), UTMALDG (a TMA load) and IDP
     (__dp4a) instructions from cuobjdump's SASS; K1's mma.sync
     instantiations, every K2 instantiation and both probe kernels must hold
     IMMA, K1's wgmma instantiations IGMMA and no IMMA, the halo
     instantiations (csrc/halo.cuh's kernel, K1's and K2's) IMMA and
     UTMALDG, and K1's symmetric ones (every design), K2's and orientation_b
     no IDP;
  3. K1 (qconv) vs its plain PyTorch version, bit for bit: every flagship
     conv shape at 416x416, at batch 2 plain and with each reference-engine
     option (asymmetric w_zp, per-image zp and (N,Co) bias/m, exact_leaky,
     the int16 carrier), and at batch 16 (the timed shapes, where the large
     layers take the 128x128 tile) plain, asymmetric and with the parity
     engine's options; fused pool where the plan has it; plus edge cases
     (Co 30/130, Cin 3/6/16, M off every tile, pooled partial tiles, every
     block tile of the launch table, K=1, every activation, ties, uint8 in).
     The yolov2 family's shapes (GEMM K 4,608 / 9,216 / 11,520 at 13x13, the
     passthrough 1x1, the 125-channel head) at batch 2 and 16.  Then stride
     2: yolov3's five stride-2 convs at batch 2 and 16 and with each option,
     odd maps (13 -> 7, 9x11), Cin 3 and 6, every block tile; then
     yolov3's stride-1 shapes from Ci 64 (208x208 to 13x13) at batch 2
     (plain, asymmetric, the parity options) and 16.  Then the halo
     design's edges (Ci 3, 16, 32, 48 at stride 1, 2 and pooled, batch 1
     and 3, odd maps, Co 16, 32, 64) with each option and uint8 input.  Every
     case that K1's wgmma design (Ci % 64 == 0, k 1 or 3) or its halo
     design (3x3 from Ci 3, 16, 32, 48 to Co 16, 32, 64) can run runs in its
     routed design and again forced onto the other, each launch counted
     under the design that ran;
  4. K2 (s2d_qconv) vs its plain version, bit for bit: layers 0, 2, 4 at 416,
     batch 2, every activation, per-image zp/bias/m, exact_leaky, and at
     batch 16 (the timed shapes) plain and with the per-image options;
     non-square maps, and a case per entry of K2's mma.sync tile table with
     partial M and N tiles and an arbitrary (dense) block kernel; every
     structured case the halo design takes runs there and again forced onto
     mma.sync; then the halo design's own cases: layers 0, 2, 4 with four
     distinct phase kernels, and its edges (C 3, 16, 32, 48; O 16, 32, 64;
     tiles past the map's edge) with one and with four;
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
     forward; each engine's predict is a main path with counted launches,
     K1's also by design: 10 wgmma + 3 halo a flagship forward (s2d 10 + 0,
     with its 3 K2 launches on K2's halo design; int16 13 on its own
     kernel), 67 wgmma + 3 halo + 5 mma.sync a yolov3 forward;
  6b. YOLOv4 (608, 80 classes; the benchmark's v4-608-b32-offline
     configuration and its weights and ranges from a seed): K1's mish
     epilogue, bit for bit against the plain conv, on a conv of each design
     that takes one (halo stem and stride 2, wgmma 3x3 at stride 1 and 2
     and 1x1, mma.sync 1x1), each also forced onto mma.sync; spp_kernel
     against maxpool_u8 and the route's requant at (32, 19, 19, 512) and an
     odd map; then the Engine on uint8 batches of 2: 110 K1 (85 wgmma, 3
     halo, 22 mma.sync) + 23 shortcut + 1 spp launches a forward, the heads
     equal to the layer-by-layer forward's (no spp launch) and image 0's to
     the CPU engine's, spp_kernel on layer 107's codes equal to layer 113's,
     predict's launches counted (a main path);
  7. flip TTA and at_size(320) agree between GPU and CPU for yolov3-tiny and
     yolov3, and f1_rows over GPU and CPU predictions gives equal counts;
  8. Servers with the (1, 4, 16) bucket ladder answer seeded requests of
     mixed sizes, float and uint8 — the serving main paths: yolov3-tiny (13
     K1 launches per batch) and yolov3 (75 K1 + 23 shortcut per batch);
  9. timings, printed and not asserted
     (yolo_quantization_tpu_torch/tools/kernel_timings.py, which also runs
     alone): each kernel graph-timed (its device time) beside its eager
     time, its bound, the plain version and torch._int_mm; K1's wgmma convs
     in both designs, in turns; the halo design's convs (the flagship's
     layers 0, 2, 4 at 16, yolov3's 0, 1, 3 at 16 and 64, yolov2's 0, 2 at
     16) in both designs beside their bounds; K1 on yolov3's stride-2 convs and on its
     stride-1 shapes from Ci 64 at batch 16; K2 on layers 0, 2, 4 at 1 and
     16 by design (halo with one and with four slices, mma.sync) beside K1's
     fused stages and both of K2's bounds; the shortcut kernel per
     yolov3 stage; the engines' device forwards;
 10. (run during phase 2's build) the QAT forward and backward, GPU
     against CPU (tools/qat_check.py): TF32 left at PyTorch's default, a
     float conv and its weight gradient must match float64 to float32
     accuracy (TF32 off inside the port);
     yolov3-tiny at 416, batch 4: the whole float-train forward held by its
     loss, then every layer from the CPU's inputs and loss cotangents in the
     float-train, EMA-QAT-train, QAT-eval and learned modes (outputs, range
     updates, batch statistics, gradients; a weight code that differs must
     sit at a rounding tie, and the CPU's pass takes the card's codes);
 11. the Trainer on the card: yolov3-tiny at 416, batch 16, two float, two
     EMA-QAT, one learned-range and one frozen-range step, run twice from
     one seed and equal bit for bit (training is deterministic), a
     checkpoint saved and restored equal; ms per step, images/s and peak memory of the
     float and EMA-QAT phases, and of yolov3 (416, 80 classes, batch 8) in
     EMA-QAT; every loss finite; then tools/profile_train.py's breakdown;
 12. the synthetic accuracy gate of tests/test_accuracy_gate.py through the
     port on the card: 800 steps at 96x96 (float, then QAT), convert, and
     the integer Engine (K1, launches counted) against the fake-quant
     simulation and the float engine: float F1 >= 60, integer >= QAT-sim -
     0.5, integer >= float - 2.5;
 13. (run after phase 8) yolov2-tiny (9 K1 launches a forward: 6 wgmma + 3
     halo) and yolov2 (23: 20 + 2 halo + 1 mma.sync; the reorg passthrough
     as a float route into conv 29), 416, 20
     classes, float32 and uint8 batches of 4: every layer's codes equal to
     the CPU engine's (16 and 32 layers; the region layer's floats within
     rtol 1e-5, atol 1e-6), predict, flip TTA and at_size(320) agree; the
     float programs of yolov1-tiny (448) and darknet19 (224) through the
     Engine and the float forward, GPU vs CPU within float32 tolerance;
 13b. the darknet deployment path: yolov2-tiny's QAT program written with
     save_darknet_weights, its cfg (held as text here) parsed, the file
     loaded with its layout auto-detected, converted, served on K1 (codes
     equal to the in-memory program's at every layer, a second save
     byte-identical), then a Server with the (1, 4, 16) ladder (9 K1
     launches a batch);
 phase 10 also holds yolov2-tiny (416, batch 4) layer by layer, the region
     layer and loss included; phase 11 also times an EMA-QAT yolov2-tiny
     step (416, batch 16), whose steps repeat bit for bit; phase 9 also times
     the yolov2 forwards and K1 on their new shapes;
 14. tests/test_accuracy_gate_v2_v1.py's region gate through the port:
     yolov2-tiny at 96x96, 900 steps with the anchor-prior warm-up crossed,
     convert, K1: float F1 >= 60, integer >= QAT-sim - 0.5;
 15. the command line on the card (yolo_quantization_tpu_torch/cli): the
     native host library must build (its image entry points reported);
     yolov3-tiny at 416, 5 classes, the flagship ranges on seeded weights
     written as a quantized .weights, 48 synthetic JPEG/PNG images of mixed
     sizes with labels; export-program, detect --out (weights and program),
     valid --format voc/coco/imagenet --map, f1, recall, demo over a frames
     directory and (where cv2 imports) a video file, train 3 steps at batch
     16 with QAT from step 1 -> export -> valid --map (the trained program
     on K1); K1 launches must equal 13 x the card forwards; valid on 4
     images on the card equals --device cpu (lines in order within rtol
     1e-5, atol 1e-6; the same AP and mAP); one detect as a subprocess
     (python -m yolo_quantization_tpu_torch.cli); then the card's busy
     share of one valid run under utils/profiling.trace, valid's host
     stages per image and native against numpy letterbox and nms_sort,
     printed with the card's name and power limit;
 16. parallelism (yolo_quantization_tpu_torch/tools/parallel_check.py): on a
     one-rank NCCL group, the Trainer with DDP and with FSDP2 against the
     plain Trainer (yolov3-tiny 416, batch 16, 2 float + 4 EMA-QAT steps),
     params and ranges bit for bit, and their ms per step; an FSDP2
     checkpoint written whole and read back through export; two gloo ranks
     on the one card (8 rows each) against one process on 16 (float steps'
     loss rel 2e-4; the EMA-QAT step's against one process on reversed
     rows), DDP and FSDP2 where gloo carries it; TP: K1 on 2 and 4 channel
     slices of yolov3-tiny and yolov3 (416) concatenated, every layer equal
     to Engine's, K1's time per slice against the whole conv, and
     make_tp_engine on the one-rank group equal to Engine.predict (its K1
     launches counted);
 17. WordTree, classifier, segmenter
     (yolo_quantization_tpu_torch/tools/wordtree_check.py): yolov2-tiny's
     topology at 416 with a region head over a seeded 9,418-node tree (47,115
     channels in the last conv) from cfg text with tree= through a
     quantized .weights, convert and Engine, every integer layer equal to
     the CPU engine's, the region layer, joint probabilities and
     tree_top_probs' nodes against float64 from that head, predict's K1
     launches, decode and tree_top_probs per image; 3 EMA-QAT steps of the
     tree region loss at batch 8, card vs CPU; darknet19 (224, 1000
     classes) under ClassifierTrainer at batch 16, flat and with a
     1,000-leaf tree, card vs CPU, evaluate_top_k; SegmenterTrainer (416,
     21 classes, batch 4), card vs CPU, predict;
 18. the C-parity harness (yolo_quantization_tpu_torch/tools/parity_check.py):
     the flagship topology at 416 with seeded weights calibrated on a seeded
     lossless image, written as an asymmetric .weights file, run by the
     C-exact twin (numpy, on the host; its seconds printed) and by the
     parity engine on K1, static and dynamic input: tier 2 (every u8
     layer within 16 LSB of the twin, TP and TP_FN equal and TP_FP within
     5% at 0.25) must pass; tier 1 needs the reference sources and is
     reported as not run; then tools/crossf1.py short (12 train images at
     96, 150 steps, batch 8, 6 eval images at 416): contract 2 (the
     engine's best F1 >= the QAT simulation's - 0.5) must hold;
 19. the benchmarks: python -m yolo_quantization_tpu_torch.cli bench and
     bench --v3 (their JSON lines), tools/bench_serving.py at four offered
     rates of 4 s each picked from predict's batch-1 and batch-16 rates,
     tools/bench_train.py chip (batch 64, 5 steps), tools/dryrun.py
     (entry() and dryrun_multichip(1) on a one-rank NCCL group); K1's and
     the shortcut's launches counted into the kernels line;
 20. the accuracy loop and the capstone: tools/synthetic_accuracy_loop.py
     as a user runs it (400 steps at 96, convert, K1; |integer F1 - float
     F1| <= 0.5 must hold), then tools/accuracy_capstone.py at the
     flagship's configuration (yolov3-tiny, relu6, 416, 5 classes, batch
     32, multiscale 320/416/512, 200 eval images) at 1500 steps, QAT from
     600 (the tool's 3000 runs alone; CAPSTONE_STEPS says why), in its own
     process (start_flagship_capstone): integer F1
     >= float - 0.5 and >= QAT-sim - 0.5 must hold, every printed loss
     finite, 104 K1 launches; then --bf16, --v3 (75 K1 + 23 shortcut launches a
     batch), --v2, --leaky, --learned (400 steps), --percentile and
     --float-baseline at 40 steps, batch 8, 25 eval images, their
     contracts printed; every record's key sets the JAX script's.

Prints a {"kernels": [...]} JSON line, then the card's nvidia-smi line, and
last {"ok": true, "device": {...}}.  Needs one CUDA device and nvcc; imports
nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
import queue
import re
import subprocess
import sys
import tempfile
import time
import traceback

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
    """IMMA (int8 mma.sync), IGMMA (int8 wgmma), UTMALDG (a TMA tile load)
    and IDP (__dp4a) instructions per kernel in a built library, from
    cuobjdump --dump-sass."""
    from yolo_quantization_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib_path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            fn = m.group(1)
            out[fn] = {"IMMA": 0, "IGMMA": 0, "UTMALDG": 0, "IDP": 0}
        elif fn:
            out[fn]["IMMA"] += bool(re.search(r"\bIMMA\b", line))
            out[fn]["IGMMA"] += bool(re.search(r"\bIGMMA\b", line))
            out[fn]["UTMALDG"] += bool(re.search(r"\bUTMALDG\b", line))
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


def phase_kernel_report(libs) -> tuple[list, list, list]:
    """Print ptxas and SASS facts per kernel; K1's mma.sync instantiations,
    K2's and the probe kernels must run on IMMA, K1's wgmma ones on IGMMA
    with no IMMA, the halo ones (halo.cuh's kernel, in K1's library and in
    K2's) on IMMA fed by TMA (UTMALDG), and K1's symmetric int8 ones (every
    design), K2's and orientation_b must hold no IDP (no product on
    __dp4a).  Returns the K1 wgmma, the K1 halo and the K2 halo
    instantiations' names."""
    from yolo_quantization_tpu_torch.ops import _build

    wgmma, halo, s2d_halo = [], [], []
    for name in libs:
        ptx = ptxas_report(_build.build_log.get(name, ""))
        sass = sass_counts(_build.library_path(name))
        readable = demangle(sass)
        for fn, counts in sass.items():
            info = ptx.get(fn, {})
            regs = info.get("registers", "?")
            log(f"    {name}: {readable[fn]}: {regs} registers, spill stores/loads "
                f"{info.get('spill', '?')} B, static smem {info.get('smem', '?')} B, "
                f"IMMA {counts['IMMA']}, IGMMA {counts['IGMMA']}, UTMALDG {counts['UTMALDG']}, "
                f"IDP {counts['IDP']}")
            if (name in ("s2d_qconv", "gemm_probe") or "qconv_mma" in fn) and counts["IMMA"] == 0:
                raise AssertionError(f"{readable[fn]}: no IMMA instruction")
            if "qconv_wgmma" in fn:
                wgmma.append(readable[fn])
                if counts["IGMMA"] == 0 or counts["IMMA"]:
                    raise AssertionError(f"{readable[fn]}: IGMMA {counts['IGMMA']}, IMMA {counts['IMMA']}; "
                                         "the wgmma design must run on wgmma alone")
            if "halo_kernel" in fn:
                (s2d_halo if name == "s2d_qconv" else halo).append(readable[fn])
                if counts["IMMA"] == 0 or counts["UTMALDG"] == 0:
                    raise AssertionError(f"{readable[fn]}: IMMA {counts['IMMA']}, UTMALDG {counts['UTMALDG']}; "
                                         "the halo design multiplies on mma.sync a halo fetched by TMA")
            if (name == "s2d_qconv" or "orientation_b" in fn) and counts["IDP"]:
                raise AssertionError(f"{readable[fn]}: a product runs on __dp4a")
            # the ASYM flag: the fifth template argument of each design's kernel
            args = re.search(r"(qconv_mma|qconv_wgmma|halo)_kernelI((?:L[a-z]\d+E)+)", fn)
            asym = args and re.findall(r"L[a-z](\d+)E", args.group(2))[4] == "1"
            if args and not asym and counts["IDP"]:
                raise AssertionError(f"{readable[fn]}: a symmetric int8 conv runs __dp4a")
    if not wgmma or not halo or not s2d_halo:
        raise AssertionError(f"K1's build holds {len(wgmma)} wgmma and {len(halo)} halo instantiations, "
                             f"K2's {len(s2d_halo)} halo ones")
    return wgmma, halo, s2d_halo


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


def v2_conv_cases():
    """K1 on the yolov2 family's shapes (GEMM K 4,608 / 9,216 / 11,520 at
    13x13, the passthrough 1x1 at 26x26, the 125-channel head, Co off 16)
    at batch 2 and 16, in conv_cases' form."""
    from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY
    from yolo_quantization_tpu_torch.tools.kernel_timings import v2_layers

    cases = []
    for (name, h, w, ci, co, k, pad, act) in v2_layers():
        for n, variant in ((2, ""), (16, ""), (16, "asym"), (2, "parity")):
            v_act = ACT_LEAKY if variant == "parity" else act
            cases.append((f"{name}_b{n}{'_' + variant if variant else ''}", n, h, w, ci, co, k, pad,
                          v_act, True, False, variant, 1))
    return cases


def v3_conv_cases():
    """K1 on yolov3's stride-1 shapes from Ci 64 (its 13x13, 26x26, 52x52,
    104x104 and 208x208 convs, the wgmma design's), in conv_cases' form: at
    batch 2 plain, asymmetric and with the parity engine's options, at 16
    plain."""
    from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY
    from yolo_quantization_tpu_torch.tools.kernel_timings import v3_layers

    cases = []
    for (h, w, ci, co, k, pad) in v3_layers():
        for n, variant in ((2, ""), (2, "asym"), (2, "parity"), (16, "")):
            cases.append((f"v3_{h}x{ci}_{co}_k{k}_b{n}{'_' + variant if variant else ''}", n, h, w, ci, co,
                          k, pad, ACT_LEAKY, True, False, variant, 1))
    return cases


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


# The halo design's edges (n, h, w, ci, co, stride, fuse_pool), as
# tests/test_torch_qconv_halo.py::HALO_CASES: the models' stem shapes cut in
# height, batch 1 and 3, odd maps, stride 2, every Ci (3, 16, 32, 48) and Co
# (16, 32, 64) it takes, tiles past the map's edge in both directions
HALO_EDGES = (
    (1, 20, 416, 3, 16, 1, True), (3, 14, 64, 3, 32, 1, False), (1, 18, 96, 3, 32, 1, True),
    (3, 9, 48, 3, 16, 2, False), (1, 17, 64, 3, 64, 1, False), (3, 22, 208, 16, 32, 1, True),
    (1, 26, 104, 32, 64, 1, True), (3, 13, 45, 32, 64, 2, False), (1, 21, 37, 32, 64, 1, False),
    (3, 7, 33, 16, 16, 2, False), (2, 6, 34, 16, 64, 1, True), (1, 9, 70, 48, 16, 1, False),
    (3, 10, 66, 48, 32, 1, True), (2, 11, 40, 32, 16, 2, False), (2, 19, 64, 3, 32, 2, False),
)


def halo_cases():
    """The halo design's edges in conv_cases' form, each plain, asymmetric,
    with per-image zero points and (N, Co) bias/m, exact_leaky, uint8 input
    and the parity engine's options."""
    from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY

    cases = []
    for j, (n, h, w, ci, co, stride, pool) in enumerate(HALO_EDGES):
        for variant in ("", "asym", "dyn", "exact", "uint8", "parity"):
            cases.append((f"halo{j}_{variant or 'sym'}", n, h, w, ci, co, 3, 1, ACT_LEAKY, variant != "uint8",
                          pool, variant, stride))
    return cases


def phase_k1(cuda_qconv, qconv, rng, errors, cases=None):
    from yolo_quantization_tpu_torch.tools.kernel_timings import random_layer

    cases = conv_cases() if cases is None else cases
    counts = {}  # cases run by design
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
        # the routed design, then the other one forced on the same inputs where
        # the wgmma or the halo design can run the conv
        design = cuda_qconv.design(ci, k, co, opts["carrier"], pad=pad, w=w)
        choice = cuda_qconv.forcible(ci, k, co, opts["carrier"], pad=pad, w=w)
        other = (choice[1] if design == "mma.sync" else "mma.sync") if choice else None
        for forced in (None, other) if other else (None,):
            reset_counts(cuda_qconv)
            got = cuda_qconv.quantized_conv2d_cuda(
                xt, wt_t, b_t, m_t, zp_t, stride=stride, pad=pad, act=act, out_zp_static=out_zp,
                fuse_pool=pool, out_i8=out_i8, w_zp=wzp_t, _design=forced, **opts,
            )
            ran = forced or design
            if cuda_qconv.design_launches[ran] != 1:
                raise AssertionError(f"{name}: launched {cuda_qconv.design_launches}, expected {ran}")
            errors.check("qconv", f"{name} ({ran})", got, ref)
            counts[ran] = counts.get(ran, 0) + 1
        log(f"  {name:24s} x{(n, h, w, ci)} w{(k, k, ci, co)} s{stride} act={act} out_i8={out_i8} "
            f"pool={pool} {variant or 'plain'}: equal ({design}{' and ' + other + ' forced' if other else ''})")
    return sum(c[-1] == 1 for c in cases), sum(c[-1] == 2 for c in cases), counts


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


# K2's halo design's edges (n, h, w, c, o), as
# tests/test_torch_s2d_halo.py::S2D_HALO_EDGES: the flagship's stem shapes
# cut in height, batch 1 and 3, tiles past the map's edge in both
# directions, every C (3, 16, 32, 48) and O (16, 32, 64) it takes
S2D_HALO_EDGES = (
    (1, 30, 48, 3, 16), (3, 18, 416, 3, 16), (2, 34, 80, 3, 32), (1, 10, 32, 3, 64),
    (2, 26, 208, 16, 32), (1, 14, 66, 16, 16), (3, 12, 104, 32, 64), (1, 22, 38, 32, 32),
    (2, 6, 34, 48, 64), (1, 18, 50, 48, 16),
)


def s2d_cases():
    """(name, n, h, w, ci, co, act, per-image zp/bias/m, exact_leaky, block
    kernel): "s2d" is _s2d_weights' of one 3x3 kernel (as the engine
    converts it; structured, one shared slice), "phases" four phases' own
    kernels (structured, four slices), "any" an arbitrary one (dense)."""
    from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY, ACT_LINEAR, ACT_RELU, ACT_RELU6
    from yolo_quantization_tpu_torch.tools.kernel_timings import S2D_LAYERS, flagship_layers

    cases = []
    for (i, h, w, ci, co, *_rest) in flagship_layers():
        if i not in S2D_LAYERS:
            continue
        for act in (ACT_LINEAR, ACT_LEAKY, ACT_RELU, ACT_RELU6):
            cases.append((f"layer{i}_act{act}", 2, h, w, ci, co, act, False, False, "s2d"))
        cases.append((f"layer{i}_dyn_exact", 2, h, w, ci, co, ACT_LEAKY, True, True, "s2d"))
        cases.append((f"layer{i}_b16", 16, h, w, ci, co, ACT_RELU6, False, False, "s2d"))
        cases.append((f"layer{i}_b16_dyn_exact", 16, h, w, ci, co, ACT_LEAKY, True, True, "s2d"))
    cases += [
        ("nonsquare_partial_c5", 2, 30, 22, 5, 24, ACT_LEAKY, True, True, "s2d"),
        ("nonsquare_partial_c16", 3, 50, 84, 16, 40, ACT_RELU6, False, False, "s2d"),
        ("nonsquare_c32", 1, 36, 20, 32, 64, ACT_LINEAR, True, False, "s2d"),
    ]
    for j, (n, h, w, ci, co) in enumerate(S2D_TILE_EDGES):
        cases.append((f"edge{j}", n, h, w, ci, co, ACT_LEAKY, True, True, "any"))
    return cases


def s2d_halo_cases():
    """The halo design's own cases (drawn from their own generator): the
    flagship's s2d layers with four phase kernels, and S2D_HALO_EDGES with
    one and with four."""
    from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY, ACT_RELU6
    from yolo_quantization_tpu_torch.tools.kernel_timings import S2D_LAYERS, flagship_layers

    cases = []
    for (i, h, w, ci, co, *_rest) in flagship_layers():
        if i in S2D_LAYERS:
            cases.append((f"layer{i}_phases", 2, h, w, ci, co, ACT_RELU6, False, False, "phases"))
            cases.append((f"layer{i}_phases_dyn_exact", 2, h, w, ci, co, ACT_LEAKY, True, True, "phases"))
    for j, (n, h, w, ci, co) in enumerate(S2D_HALO_EDGES):
        for kind in ("s2d", "phases"):
            cases.append((f"halo_edge{j}_{kind}", n, h, w, ci, co, ACT_LEAKY, True, True, kind))
    return cases


def phase_k2(cuda_s2d, qconv, rng, errors, cases):
    """K2 on ``cases`` against the plain version: the structured ones on
    the design they route to and, where the halo design takes them, forced
    onto mma.sync too; the dense ones on mma.sync.  Returns the runs by
    design."""
    from yolo_quantization_tpu_torch.infer.convert import _s2d_weights
    from yolo_quantization_tpu_torch.tools.kernel_timings import random_layer

    runs = {"halo": 0, "mma.sync": 0}
    for (name, n, h, w, ci, co, act, dyn, exact, kind) in cases:
        x, wt, bias, m = random_layer(rng, n, h, w, ci, co, 3)
        w_s2d = _s2d_weights(wt)
        if kind == "any":  # every tap nonzero: 4x the terms, so a smaller m keeps codes off the clamps
            w_s2d = rng.integers(-127, 128, w_s2d.shape).astype(np.int8)
            m = m / 2
        elif kind == "phases":  # phase ph's columns from a 3x3 kernel of its own
            for ph in range(1, 4):
                other = _s2d_weights(rng.integers(-127, 128, wt.shape).astype(np.int8))
                w_s2d[..., ph * co:(ph + 1) * co] = other[..., ph * co:(ph + 1) * co]
        if dyn:
            bias = rng.integers(-(2**14), 2**14, (n, co)).astype(np.int32)
            m = np.tile(m, (n, 1)) * rng.uniform(0.8, 1.25, (n, 1)).astype(np.float32)
        x_zp = rng.integers(-128, 128, (n,)).astype(np.int32) if dyn else int(rng.integers(-128, 128))
        out_zp = int(rng.integers(0, 256))
        xt, ws_t, b_t, m_t = (torch.from_numpy(a).cuda() for a in (x, w_s2d, bias, m))
        zp_t = torch.from_numpy(x_zp).cuda() if dyn else x_zp
        ref = qconv.s2d_conv_phase_max(qconv.space_to_depth(xt), ws_t, b_t, m_t, zp_t, out_zp,
                                       act=act, exact_leaky=exact)
        packed = cuda_s2d.pack_weights(ws_t)
        routed = cuda_s2d.design(ci, co, w=w, structured=packed.dim() == 3)
        if (routed == "halo") != (kind != "any" and cuda_s2d.halo_capable(ci, co, w=w)):
            raise AssertionError(f"K2 {name}: routed to {routed}")
        ran = [routed] + (["mma.sync"] if routed == "halo" else [])
        for design in ran:
            before = dict(cuda_s2d.design_launches)
            got = cuda_s2d.s2d_conv_phase_max_cuda(
                xt, ws_t, b_t, m_t, zp_t, act=act, out_zp_static=out_zp, exact_leaky=exact, w_packed=packed,
                _design="mma.sync" if design != routed else None)
            errors.check("s2d_qconv", f"{name} ({design})", got, ref)
            if cuda_s2d.design_launches[design] != before[design] + 1:
                raise AssertionError(f"K2 {name}: no {design} launch counted")
            runs[design] += 1
        slices = f", {packed.shape[0]} slice(s)" if packed.dim() == 3 else ""
        log(f"  {name:26s} x{(n, h, w, ci)} -> {co} act={act} per_image={dyn} exact_leaky={exact} "
            f"w_s2d {kind}{slices}: equal ({' and '.join(ran)})")
    return runs


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
    """name -> (program, options, launches per forward (K1, K2, shortcut),
    K1's launches by design (wgmma, halo, mma.sync, int16)): yolov3-tiny's
    configurations, then yolov3's (``v3``, ``v3-perturbed``) as
    ``tools/profile_engine.py`` builds them.  wgmma takes the convs from Ci
    64 (the flagship's layers 6-22, 67 of yolov3's 75), halo the narrow 3x3
    stem convs (the flagship's 0, 2, 4; yolov3's 0, 1, 3), mma.sync the 1x1
    convs sent back from wgmma (yolov3's 2, 6, 9, 93 and 105; PERF.md).
    K2 (the ``s2d`` engine's layers 0, 2, 4) runs its halo design alone
    (``K2_SPLIT``)."""
    from yolo_quantization_tpu_torch.models.presets import flagship_program, parity_program
    from yolo_quantization_tpu_torch.tools.profile_engine import configurations

    flagship = flagship_program(classes=5, size=416, seed=0)
    return {
        "flagship": (flagship, {}, (13, 0, 0), (10, 3, 0, 0)),
        "s2d": (flagship, dict(use_s2d=True), (10, 3, 0), (10, 0, 0, 0)),
        "parity": (parity_program(classes=5, size=416, seed=0),
                   dict(dynamic_input=True, exact_leaky=True), (13, 0, 0), (10, 3, 0, 0)),
        "int16": (flagship, dict(carrier="int16"), (13, 0, 0), (0, 0, 0, 13)),
        # each fused conv+pool as K1 then the integer pool: every layer its own output
        "flagship-unfused": (flagship, dict(fuse_pool=False), (13, 0, 0), (10, 3, 0, 0)),
        **{name: (program, option, (75, 0, 23), (67, 3, 5, 0))
           for name, (program, option) in configurations(v3=True).items()},
    }


# K2's launches per forward by design (halo, mma.sync), per configuration
K2_SPLIT = {"s2d": (3, 0)}


def reset_counts(*wrappers):
    for w in wrappers:
        if hasattr(w, "reset_launches"):  # K1: its per-design counts too
            w.reset_launches()
        else:
            w.launches = 0


def design_split(cuda_qconv) -> tuple[int, int, int, int]:
    """K1's launches since the last reset by design: (wgmma, halo, mma.sync,
    int16)."""
    d = cuda_qconv.design_launches
    return d["wgmma"], d["halo"], d["mma.sync"], d["int16"]


def k2_split(cuda_s2d) -> tuple[int, int]:
    """K2's launches since the last reset by design: (halo, mma.sync)."""
    return cuda_s2d.design_launches["halo"], cuda_s2d.design_launches["mma.sync"]


def phase_engines(Engine, counters, rng):
    x = rng.uniform(0, 1, (4, 416, 416, 3)).astype(np.float32)
    x_u8 = rng.integers(0, 256, (4, 416, 416, 3), dtype=np.uint8)
    # the parity engine at batch 16 too: its large layers take K1's 128x128 tile there
    x16 = rng.uniform(0, 1, (16, 416, 416, 3)).astype(np.float32)
    engines, main_launches, int8_outs = {}, {}, {}
    for cname, (program, option, expected, split) in engine_configs().items():
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
            if design_split(counters[0]) != split:
                raise AssertionError(f"{cname}: K1 launches by design (wgmma, halo, mma.sync, int16) "
                                     f"{design_split(counters[0])}, expected {split}")
            if k2_split(counters[1]) != K2_SPLIT.get(cname, (0, 0)):
                raise AssertionError(f"{cname}: K2 launches by design (halo, mma.sync) {k2_split(counters[1])}, "
                                     f"expected {K2_SPLIT.get(cname, (0, 0))}")
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
                f"{expected[0]} K1 ({split[0]} wgmma, {split[1]} halo, {split[2]} mma.sync, {split[3]} int16) + "
                f"{expected[1]} K2 ({K2_SPLIT.get(cname, (0, 0))[0]} halo) + {expected[2]} shortcut launches")
        # the engine's predict is this configuration's main path
        reset_counts(*counters)
        boxes, obj, cls = eng_gpu.predict(batches[0][1])
        main_launches[cname] = tuple(c.launches for c in counters)
        if (main_launches[cname] != expected or design_split(counters[0]) != split
                or k2_split(counters[1]) != K2_SPLIT.get(cname, (0, 0))):
            raise AssertionError(f"{cname} predict launched {main_launches[cname]} (K1 by design "
                                 f"{design_split(counters[0])}, K2 {k2_split(counters[1])}), expected {expected} "
                                 f"({split}, {K2_SPLIT.get(cname, (0, 0))})")
        if not (np.isfinite(boxes).all() and np.isfinite(cls).all()
                and (obj >= 0).all() and (obj <= 1).all()):
            raise AssertionError(f"{cname} predict: non-finite boxes or objectness outside [0,1]")
        log(f"  {cname} predict: boxes {boxes.shape} finite, objectness in "
            f"[{obj.min():.4f}, {obj.max():.4f}]; launches K1 {expected[0]} (wgmma {split[0]}, halo {split[1]}, "
            f"mma.sync {split[2]}, int16 {split[3]}), K2 {expected[1]}, shortcut {expected[2]}")
    return engines, main_launches


# YOLOv4's mish convs, one a design that takes one, at the layers' own
# sizes (as tests/test_torch_yolov4.py::MISH_CASES): (name, routed design,
# Ci, Co, k, stride, H, W)
V4_MISH_CASES = (
    ("layer0 (stem)", "halo", 3, 32, 3, 1, 608, 608),
    ("layer1 (stride 2)", "halo", 32, 64, 3, 2, 608, 608),
    ("layer11 (3x3 stride 2)", "wgmma", 64, 128, 3, 2, 304, 304),
    ("layer16 (3x3)", "wgmma", 64, 64, 3, 1, 152, 152),
    ("layer25 (1x1)", "wgmma", 256, 128, 1, 1, 76, 76),
    ("layer2 (1x1)", "mma.sync", 64, 64, 1, 1, 304, 304),
)
V4_CELL = "v4-608-b32-offline"  # the benchmark's YOLOv4 cell, whose configuration the phase builds
V4_LAUNCHES = (110, 0, 23)  # (K1, K2, shortcut) a v4 forward
V4_SPLIT = (85, 3, 22, 0)  # K1's by design (wgmma, halo, mma.sync, int16)


def phase_v4_kernels(cuda_qconv, cuda_spp, qconv, rng, errors) -> None:
    """K1's mish epilogue in each design against the plain conv, and
    ``spp_kernel`` against the block's layers, on the card, bit for bit."""
    from yolo_quantization_tpu_torch.infer.convert import _nudge_np
    from yolo_quantization_tpu_torch.nn.layers import maxpool_u8, requant_i8

    scale, zp = _nudge_np(-0.29, 7.3)
    lo, table = qconv.mish_table(scale, zp)
    mish = (torch.from_numpy(table).cuda(), lo)
    for name, routed, ci, co, k, stride, h, w in V4_MISH_CASES:
        x = torch.from_numpy(rng.integers(-128, 128, (2, h, w, ci), dtype=np.int8)).cuda()
        wt = torch.from_numpy(rng.integers(-127, 128, (k, k, ci, co), dtype=np.int8)).cuda()
        bias = torch.from_numpy(rng.integers(-4000, 4000, (co,), dtype=np.int32)).cuda()
        # v about 60 output steps wide: below, inside and above the table
        m = torch.from_numpy((rng.uniform(0.5, 1.5, co) * 60 / (74.0**2 * (k * k * ci) ** 0.5))
                             .astype(np.float32)).cuda()
        args = dict(stride=stride, pad=k // 2, act=qconv.ACT_MISH, out_i8=True)
        ref = qconv.quantized_conv2d(x, wt, bias, m, -7, None, zp, symmetric=True, mish=mish, **args)
        design = cuda_qconv.design(ci, k, co, pad=k // 2, w=w)
        if design != routed:
            raise AssertionError(f"v4 mish {name}: routed to {design}, expected {routed}")
        for forced in (None, "mma.sync") if design != "mma.sync" else (None,):
            reset_counts(cuda_qconv)
            got = cuda_qconv.quantized_conv2d_cuda(x, wt, bias, m, -7, out_zp_static=zp, mish=mish,
                                                   _design=forced, **args)
            ran = forced or design
            if cuda_qconv.design_launches[ran] != 1:
                raise AssertionError(f"v4 mish {name}: launched {cuda_qconv.design_launches}, expected {ran}")
            errors.check("qconv", f"v4 mish {name} ({ran})", got, ref)
        codes = ref.to(torch.int64) + 128
        if len(torch.unique(codes)) <= 20 or not (codes == zp).any():
            raise AssertionError(f"v4 mish {name}: the codes do not cover the table's three parts")
        log(f"  mish {name:24s} x(2, {h}, {w}, {ci}) w{(k, k, ci, co)} s{stride}: equal ({design}"
            f"{' and mma.sync forced' if design != 'mma.sync' else ''})")
    branch_sets = (tuple((size, False, 0.9939, 56) for size in (13, 9, 5, 1)),
                   ((1, True, 1.0, 77), (5, False, 1.7, 12), (9, True, 1.0, 77)))
    for shape in ((32, 19, 19, 512), (3, 40, 37, 32)):
        x = torch.from_numpy(rng.integers(-128, 128, shape, dtype=np.int8)).cuda()
        for branches in branch_sets:
            out_zp = branches[-1][3]
            before = cuda_spp.launches
            got = cuda_spp.spp_cuda(x, branches, out_zp)
            if cuda_spp.launches != before + 1:
                raise AssertionError(f"spp {shape}: launched {cuda_spp.launches - before}, expected 1")
            parts = [x if size == 1 else maxpool_u8(x, size, 1, size - 1) for size, *_ in branches]
            ref = torch.cat([p if ident else requant_i8(p, ratio, z, out_zp)
                             for p, (_, ident, ratio, z) in zip(parts, branches)], dim=-1)
            errors.check("spp", f"spp {shape} {[b[0] for b in branches]}", got, ref)
            log(f"  spp_kernel x{shape} pools {[b[0] for b in branches]}: equal to the block's layers")


def v4_engines(Engine, seed: int):
    """The benchmark's YOLOv4 configuration at 608 from ``seed`` (weights
    and ranges as the benchmark makes them), on the card and on the CPU."""
    from portbench import harness, inputs
    from yolo_quantization_tpu_torch.infer.convert import convert
    from yolo_quantization_tpu_torch.models.cfg import parse_cfg

    from pathlib import Path

    _, config = harness.cell_files(Path(__file__).resolve().parent, V4_CELL)
    text = harness.cfg_text(config, 608)
    ref_net = harness.reference(config).parse(text)
    program = convert(parse_cfg(text)[0], inputs.float_params(ref_net, seed, "cpu"),
                      harness.range_rule(config)(ref_net))
    return (Engine(program, max_det=config["max_det"], device="cuda"),
            Engine(program, max_det=config["max_det"], device="cpu"), program)


def phase_v4(Engine, counters, cuda_spp, rng):
    """YOLOv4 at 608 through the Engine on the card: launches by kernel and
    design, the SPP kernel against the block's layers and the heads against
    the CPU engine's.  Returns predict's (K1, shortcut, spp) launches."""
    from yolo_quantization_tpu_torch.infer.engine import spp_plan

    t0 = time.perf_counter()
    eng_gpu, eng_cpu, program = v4_engines(Engine, 2**31 + 17)
    log(f"  built at 608 in {time.perf_counter() - t0:.1f} s")
    x_u8 = rng.integers(0, 256, (2, 608, 608, 3), dtype=np.uint8)

    def counted(what, fn, spp_expected):
        reset_counts(*counters, cuda_spp)
        out = fn()
        got, split = tuple(c.launches for c in counters), design_split(counters[0])
        if got != V4_LAUNCHES or split != V4_SPLIT or cuda_spp.launches != spp_expected:
            raise AssertionError(f"v4 {what}: (K1, K2, shortcut) {got}, K1 by design {split}, spp "
                                 f"{cuda_spp.launches}; expected {V4_LAUNCHES}, {V4_SPLIT}, {spp_expected}")
        return out

    heads = counted("raw_heads", lambda: eng_gpu.raw_heads(x_u8), 1)
    heads_l, outs = counted("raw_heads(return_outputs)",
                            lambda: eng_gpu.raw_heads(x_u8, return_outputs=True), 0)
    for a, b in zip(heads, heads_l):
        if not np.array_equal(a, b):
            raise AssertionError("v4: the fused forward's heads differ from the layer-by-layer forward's")
    block = spp_plan(program)[108]
    got = cuda_spp.spp_cuda(torch.from_numpy(outs[block.base]).cuda(), block.branches, block.out_zp)
    if not np.array_equal(got.cpu().numpy(), outs[block.route]):
        raise AssertionError("v4: spp_kernel differs from the SPP block's layers (108-113)")
    t1 = time.perf_counter()
    heads_c = eng_cpu.raw_heads(x_u8[:1])
    for g, c in zip(heads, heads_c):
        if not np.array_equal(g[:1], c):
            raise AssertionError("v4: the card's heads differ from the CPU engine's")
    log(f"  v4 uint8 batch of 2: heads equal to the layer-by-layer forward's, image 0's to the CPU "
        f"engine's ({time.perf_counter() - t1:.1f} s on the CPU); layers 108-113 equal to one spp_kernel; "
        f"{V4_LAUNCHES[0]} K1 ({V4_SPLIT[0]} wgmma, {V4_SPLIT[1]} halo, {V4_SPLIT[2]} mma.sync) + "
        f"{V4_LAUNCHES[2]} shortcut + 1 spp launches a forward")
    boxes, obj, cls = counted("predict", lambda: eng_gpu.predict(x_u8), 1)
    if not (np.isfinite(boxes).all() and np.isfinite(cls).all() and (obj >= 0).all() and (obj <= 1).all()):
        raise AssertionError("v4 predict: non-finite boxes or objectness outside [0,1]")
    log(f"  v4 predict: boxes {boxes.shape} finite, objectness in [{obj.min():.4f}, {obj.max():.4f}]; "
        f"{time.perf_counter() - t0:.1f} s")
    return V4_LAUNCHES[0], V4_LAUNCHES[2], 1  # predict's: the main path


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


def check_tf32_off(rng) -> None:
    """With TF32 at PyTorch's default (on), the port's float conv and its
    weight gradient must match float64 to float32 accuracy (TF32 products
    carry 10 mantissa bits: about 1e-3 relative), and the default must be
    left as it was."""
    import torch.nn.functional as F

    from yolo_quantization_tpu_torch.nn import layers as L

    x = rng.standard_normal((4, 13, 13, 512)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 512, 256)) * 0.02).astype(np.float32)
    g = rng.standard_normal((4, 13, 13, 256)).astype(np.float32)
    xd, wd = torch.from_numpy(x).double(), torch.from_numpy(w).double().requires_grad_(True)
    ref = L.conv2d(xd, wd, 1, 1)
    ref.backward(torch.from_numpy(g).double())
    xc = torch.from_numpy(x).cuda()
    wc = torch.from_numpy(w).cuda().requires_grad_(True)
    got = L.conv2d(xc, wc, 1, 1)
    got.backward(torch.from_numpy(g).cuda())
    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("the port's conv changed the global TF32 setting")
    rel = lambda a, b: float((a.double().cpu() - b).abs().max() / b.abs().max())  # noqa: E731
    err_y, err_w = rel(got.detach(), ref.detach()), rel(wc.grad, wd.grad)
    with torch.no_grad():
        tf32 = F.conv2d(xc.permute(0, 3, 1, 2), wc.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    log(f"  conv 13x13x512 -> 256 (K = 4608) on the card vs float64: output {err_y:.2e}, weight "
        f"gradient {err_w:.2e} (relative to the largest); a plain F.conv2d with TF32 allowed: "
        f"{rel(tf32, ref.detach()):.2e}")
    if err_y > 1e-5 or err_w > 1e-5:
        raise AssertionError(f"the port's float conv is not float32-accurate on the card "
                             f"({err_y:.2e}, {err_w:.2e}): TF32 is on")


def phase_qat_parity(rng) -> None:
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.nn import graph as G
    from yolo_quantization_tpu_torch.tools import qat_check as Q
    from yolo_quantization_tpu_torch.tools.profile_train import synthetic_batch
    from yolo_quantization_tpu_torch.train.loss import total_loss

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default: the port must turn it off itself
    try:
        check_tf32_off(rng)
        net = zoo.yolov3_tiny(classes=5)
        params = G.params_to_torch(G.init_params_numpy(0, net), "cpu")
        images, truths = synthetic_batch(rng, 4, 416, 5)
        x, t = torch.from_numpy(images), torch.from_numpy(truths)
        # the whole float-train forward and loss (no fake-quant grid to flip;
        # float32 summation differences of 13 layers add up, so the rules
        # hold per layer below and the whole forward is held by its loss)
        out = {}
        for dev in ("cpu", "cuda"):
            heads, _ = G.forward(net, G.params_to_torch(G.params_to_numpy(params), dev), x.to(dev),
                                 Q.MODES["float-train"])
            out[dev] = ([h.cpu().numpy() for h in heads], float(total_loss(heads, t.to(dev), net)[0]))
        close = [round(float(np.mean(np.isclose(a, b, rtol=1e-4, atol=1e-5))), 6)
                 for a, b in zip(out["cuda"][0], out["cpu"][0])]
        losses = {dev: out[dev][1] for dev in out}
        Q.check_share("float-train loss", losses["cuda"], losses["cpu"], rtol=1e-4, atol=0.0, share=1.0)
        log(f"  float-train, whole network: loss {losses['cuda']:.6f} on the card, {losses['cpu']:.6f} on "
            f"the CPU; heads within rtol 1e-4, atol 1e-5 on {close} of their elements")
        qs = Q.calibrated_ranges(net, params, x)
        for name in ("float-train", "ema-qat-train", "qat-eval", "learned"):
            w = Q.compare_devices(net, params, x, t, Q.MODES[name], qs, "cpu", "cuda")
            log(f"  {name}: all {len(net.specs)} layers and the input within the rules "
                f"(smallest close shares: values {w['value']:.6f}, gradients {w['grad']:.6f}; "
                f"largest share of a layer's cotangent zeroed where an ulp decides an output's "
                f"fake-quant differently on the two devices {w['excluded']:.2e}; weight codes at a "
                f"rounding tie that differ {w['code_flips']})")
    finally:
        torch.backends.cudnn.allow_tf32 = False


def _timed_steps(trainer, x, t, steps: int) -> dict:
    """ms per step, images/s and peak memory over ``steps`` steps."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(trainer.step(x, t)["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    losses = [float(v) for v in losses]
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss {losses}")
    return {"ms_per_step": ms, "images_per_s": x.shape[0] * 1e3 / ms,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20, "losses": losses}


def phase_trainer(card: str) -> None:
    import tempfile

    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.tools import profile_train
    from yolo_quantization_tpu_torch.train import checkpoint as ck
    from yolo_quantization_tpu_torch.train.qat import TrainConfig, Trainer, make_train_step

    rng = np.random.default_rng(6)
    net = zoo.yolov3_tiny(classes=5)
    images, truths = profile_train.synthetic_batch(rng, 16, 416, 5)
    x, t = torch.from_numpy(images).cuda(), torch.from_numpy(truths).cuda()
    cfg = TrainConfig(burn_in=0, quant_start_step=2, learned_ranges=True, range_warmup=2, batch_size=16)
    snap = lambda qs: {k: {n: float(v) for n, v in st.items()} for k, st in qs.items()}  # noqa: E731
    frozen = make_train_step(net, cfg, qat=True, freeze_ranges=True)

    def run_plan():
        trainer = Trainer(net, cfg, seed=0)
        plan, losses, ranges = [], [], [snap(trainer.state.quant_state)]
        for kind in ("float", "float", "ema-qat", "ema-qat", "learned"):
            losses.append(float(trainer.step(x, t)["loss"]))
            plan.append(kind)
            ranges.append(snap(trainer.state.quant_state))
        trainer.state, m = frozen(trainer.state, x, t)
        losses.append(float(m["loss"]))
        plan.append("frozen")
        ranges.append(snap(trainer.state.quant_state))
        return trainer, plan, losses, ranges

    trainer, plan, losses, ranges = run_plan()
    again, _, losses2, ranges2 = run_plan()
    differ = [f"{i}/{k}" for i, p in trainer.state.params.items() for k, v in p.items()
              if not torch.equal(again.state.params[i][k], v)]
    if losses2 != losses or ranges2 != ranges or differ:
        raise AssertionError(f"training is not deterministic: a second run from the same seed gives "
                             f"losses {losses2} vs {losses}, params differing at {differ[:6]}")
    del again
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss in {list(zip(plan, losses))}")
    if ranges[2] != ranges[0] or ranges[4] == ranges[2] or ranges[6] != ranges[5]:
        raise AssertionError("ranges: the float steps must leave them, EMA-QAT move them, frozen keep them")
    moved = max(abs(ranges[5][k][n] - ranges[4][k][n]) for k in ranges[4] for n in ("min", "max"))
    if not 0 < moved <= cfg.range_lr + 1e-6:
        raise AssertionError(f"the learned step moved a range by {moved}, not by sign-SGD's {cfg.range_lr}")
    log("  yolov3-tiny 416 batch 16, steps " + ", ".join(f"{k} {v:.4f}" for k, v in zip(plan, losses)))
    log("  a second run of these six steps from the same seed gives the same losses, ranges and "
        "params, bit for bit")
    with tempfile.TemporaryDirectory() as d:
        ck.save_checkpoint(d, trainer.state)
        other = Trainer(net, cfg, seed=1)
        restored = ck.restore_checkpoint(d, other.state)
        if (restored.step, restored.seen) != (trainer.state.step, trainer.state.seen):
            raise AssertionError("checkpoint: step or seen differs")
        for i, p in trainer.state.params.items():
            for k, v in p.items():
                if not torch.equal(restored.params[i][k], v):
                    raise AssertionError(f"checkpoint: params[{i}][{k}] differs after restore")
        if snap(restored.quant_state) != snap(trainer.state.quant_state):
            raise AssertionError("checkpoint: ranges differ after restore")
        a, b = trainer.state.opt_state.state_dict()["state"], restored.opt_state.state_dict()["state"]
        if a.keys() != b.keys() or not all(torch.equal(a[k]["momentum_buffer"], b[k]["momentum_buffer"])
                                           for k in a):
            raise AssertionError("checkpoint: momentum differs after restore")
    log(f"  checkpoint at step {trainer.state.step} saved and restored: params, ranges, momentum, "
        f"step and seen equal")
    rows = []
    for phase, start in (("float", 10**9), ("ema-qat", 0)):
        tr = Trainer(net, TrainConfig(burn_in=0, quant_start_step=start, batch_size=16), seed=0)
        _timed_steps(tr, x, t, 2)  # cuDNN's algorithm choice, the allocator
        rows.append(("yolov3-tiny", 16, phase, _timed_steps(tr, x, t, 5)))
    net3 = zoo.yolov3(classes=80)
    images3, truths3 = profile_train.synthetic_batch(rng, 8, 416, 80)
    x3, t3 = torch.from_numpy(images3).cuda(), torch.from_numpy(truths3).cuda()
    tr3 = Trainer(net3, TrainConfig(burn_in=0, quant_start_step=0, batch_size=8), seed=0)
    first = _timed_steps(tr3, x3, t3, 2)  # the two EMA-QAT steps; the first builds cuDNN's choice
    log(f"  yolov3 416 batch 8, two EMA-QAT steps: losses {first['losses']}")
    rows.append(("yolov3", 8, "ema-qat", _timed_steps(tr3, x3, t3, 3)))
    for model, batch, phase, r in rows:
        log(f"  train {model} 416 batch {batch} {phase}: {r['ms_per_step']:.3f} ms/step, "
            f"{r['images_per_s']:.1f} images/s, peak {r['peak_mib']:.0f} MiB allocated "
            f"(torch.cuda.max_memory_allocated); losses finite; {card}")
    del tr, tr3
    torch.cuda.empty_cache()
    log("  tools/profile_train.py (yolov3-tiny 416, batch 16, EMA-QAT):")
    row = profile_train.breakdown(net, 16, 5)
    log("  " + json.dumps({"card": card, **row}))


CLASS_COLORS = [(245, 80, 50), (60, 220, 90), (70, 110, 245)]


def make_gate_dataset(root: str, n: int = 24, size: int = 96) -> str:
    """tests/test_accuracy_gate.py's synthetic dataset: seeded dark images,
    one large and one small coloured box each, JPEG and darknet labels."""
    from PIL import Image

    rng = np.random.default_rng(11)
    os.makedirs(f"{root}/images", exist_ok=True)
    os.makedirs(f"{root}/labels", exist_ok=True)
    paths = []
    for i in range(n):
        im = (rng.uniform(0, 0.22, (size, size, 3)) * 255).astype(np.uint8)
        labels = []

        def put_box(w, h, cls):
            x = rng.uniform(w / 2, 1 - w / 2)
            y = rng.uniform(h / 2, 1 - h / 2)
            x0, y0 = int((x - w / 2) * size), int((y - h / 2) * size)
            x1, y1 = int((x + w / 2) * size), int((y + h / 2) * size)
            im[y0:y1, x0:x1] = CLASS_COLORS[cls]
            labels.append(f"{cls} {x:.4f} {y:.4f} {w:.4f} {h:.4f}")

        put_box(rng.uniform(0.68, 0.85), rng.uniform(0.68, 0.85), int(rng.integers(3)))
        put_box(rng.uniform(0.16, 0.24), rng.uniform(0.16, 0.24), int(rng.integers(3)))
        p = f"{root}/images/img_{i}.jpg"
        Image.fromarray(im).save(p, quality=97)
        with open(f"{root}/labels/img_{i}.txt", "w") as f:
            f.write("\n".join(labels) + "\n")
        paths.append(p)
    list_file = f"{root}/list.txt"
    with open(list_file, "w") as f:
        f.write("\n".join(paths) + "\n")
    return list_file


def run_gate(Engine, counters, net, steps: int, list_file: str, seen0: int = 0, device=None):
    """Train ``net`` on the gate's dataset (float to 2/5 of the steps, then
    EMA-QAT; ``seen0`` images already seen), convert, and sweep F1 over the
    float engine, the fake-quant simulation and the integer Engine (whose
    launches are counted).  Returns (float, QAT-sim, integer) best rows and
    the launches."""
    from yolo_quantization_tpu_torch.data.loader import BatchLoader
    from yolo_quantization_tpu_torch.data.voc import AugmentConfig, DetectionDataset
    from yolo_quantization_tpu_torch.eval.f1 import f1_sweep
    from yolo_quantization_tpu_torch.infer.convert import convert
    from yolo_quantization_tpu_torch.infer.float_engine import FloatEngine, QatSimEngine
    from yolo_quantization_tpu_torch.nn.graph import params_to_numpy, quant_state_to_numpy
    from yolo_quantization_tpu_torch.train.qat import TrainConfig, Trainer

    cfg = TrainConfig(learning_rate=1e-3, burn_in=20, quant_start_step=steps * 2 // 5,
                      max_batches=steps, batch_size=4)
    trainer = Trainer(net, cfg, seed=3, device=device)
    trainer.state = trainer.state._replace(seen=seen0)
    ds = DetectionDataset(list_file, net.height, net.width, augment=True,
                          aug_cfg=AugmentConfig(jitter=0.08, hue=0.02, saturation=1.1, exposure=1.1))
    loader = BatchLoader(ds, cfg.batch_size, workers=2, pin_memory=trainer.device.type == "cuda")
    t0 = time.perf_counter()
    losses = []
    try:
        for _ in range(steps):
            images, truths = loader.next()
            losses.append(trainer.step(images, truths)["loss"])
    finally:
        loader.close()
    losses = torch.stack(losses).cpu().numpy()
    train_s = time.perf_counter() - t0
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite loss in the gate's training")
    if trainer.state.seen != seen0 + steps * cfg.batch_size:
        raise AssertionError(f"seen {trainer.state.seen} after {steps} steps from {seen0}")
    log(f"  {steps} steps in {train_s:.1f} s (float to step {cfg.quant_start_step}, then EMA-QAT; seen "
        f"{seen0} -> {trainer.state.seen}); loss {losses[0]:.3f} -> {losses[-20:].mean():.3f} (mean of "
        "the last 20)")
    state = trainer.state
    best = lambda rows: max(rows, key=lambda r: r.f1)  # noqa: E731
    float_best = best(f1_sweep(FloatEngine(net, state.params, max_det=64, device=device), list_file))
    qat_best = best(f1_sweep(QatSimEngine(net, state.params, state.quant_state, max_det=64,
                                          device=device), list_file))
    program = convert(net, params_to_numpy(state.params), quant_state_to_numpy(state.quant_state))
    engine = Engine(program, max_det=64, device=device)
    reset_counts(*counters)  # the integer side of this path: K1 only
    int_best = best(f1_sweep(engine, list_file))
    launches = tuple(c.launches for c in counters)
    log(f"  F1: float {float_best.f1:.2f} (thresh {float_best.thresh}), QAT-sim {qat_best.f1:.2f}, "
        f"integer {int_best.f1:.2f} (thresh {int_best.thresh}); (K1, K2, shortcut) launches {launches}")
    if launches[0] == 0 or launches[1:] != (0, 0):
        raise AssertionError(f"the integer engine's F1 sweep launched {launches}, not K1 alone")
    return float_best, qat_best, int_best


def phase_accuracy_gate(Engine, counters, device=None) -> None:
    """The yolov3-tiny gate on ``device`` (the GPU by default; the engines
    and the trainer raise where there is none)."""
    import dataclasses
    import tempfile

    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.nn.graph import YoloSpec

    net = zoo.yolov3_tiny(classes=3, width=96, height=96)
    std = ((10, 14), (23, 27), (37, 58), (81, 82), (135, 169), (344, 319))
    net = dataclasses.replace(net, specs=tuple(
        dataclasses.replace(s, anchors=std) if isinstance(s, YoloSpec) else s for s in net.specs))
    with tempfile.TemporaryDirectory() as root:
        float_best, qat_best, int_best = run_gate(Engine, counters, net, 800, make_gate_dataset(root),
                                                  device=device)
    if float_best.f1 < 60.0:
        raise AssertionError(f"the float engine did not learn the task (F1 {float_best.f1:.2f} < 60)")
    if int_best.f1 < qat_best.f1 - 0.5:
        raise AssertionError(f"integer F1 {int_best.f1:.2f} < QAT-sim {qat_best.f1:.2f} - 0.5")
    if int_best.f1 < float_best.f1 - 2.5:
        raise AssertionError(f"integer F1 {int_best.f1:.2f} < float {float_best.f1:.2f} - 2.5")
    log("  the three bands hold: float >= 60, integer >= QAT-sim - 0.5, integer >= float - 2.5")


def make_v2_gate_dataset(root: str, n: int = 24, size: int = 96) -> str:
    """tests/test_accuracy_gate_v2_v1.py's region-head dataset: seeded dark
    images with one medium coloured box each, JPEG and darknet labels."""
    from PIL import Image

    rng = np.random.default_rng(23)
    os.makedirs(f"{root}/images", exist_ok=True)
    os.makedirs(f"{root}/labels", exist_ok=True)
    paths = []
    for i in range(n):
        im = (rng.uniform(0, 0.22, (size, size, 3)) * 255).astype(np.uint8)
        w, h = rng.uniform(0.4, 0.55), rng.uniform(0.4, 0.55)
        cls = int(rng.integers(3))
        x, y = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
        x0, y0 = int((x - w / 2) * size), int((y - h / 2) * size)
        x1, y1 = int((x + w / 2) * size), int((y + h / 2) * size)
        im[y0:y1, x0:x1] = CLASS_COLORS[cls]
        p = f"{root}/images/img_{i}.jpg"
        Image.fromarray(im).save(p, quality=97)
        with open(f"{root}/labels/img_{i}.txt", "w") as f:
            f.write(f"{cls} {x:.4f} {y:.4f} {w:.4f} {h:.4f}\n")
        paths.append(p)
    list_file = f"{root}/list.txt"
    with open(list_file, "w") as f:
        f.write("\n".join(paths) + "\n")
    return list_file


def phase_v2_gate(Engine, counters, device=None, steps: int = 900) -> None:
    """tests/test_accuracy_gate_v2_v1.py's region gate through the port:
    yolov2-tiny (3 classes, 96x96, anchors (1.4, 1.4) and (2.8, 2.8) grid
    units), 900 steps at batch 4 with ``seen`` seeded at 12,800 - 600, so the
    anchor-prior warm-up runs and ends at step 150; float F1 >= 60 and
    integer >= QAT-sim - 0.5."""
    import tempfile

    from yolo_quantization_tpu_torch.models import zoo

    net = zoo.yolov2_tiny(classes=3, width=96, height=96, anchors=((1.4, 1.4), (2.8, 2.8)))
    with tempfile.TemporaryDirectory() as root:
        float_best, qat_best, int_best = run_gate(Engine, counters, net, steps, make_v2_gate_dataset(root),
                                                  seen0=12800 - 150 * 4, device=device)
    if float_best.f1 < 60.0:
        raise AssertionError(f"the region head did not learn the task (F1 {float_best.f1:.2f} < 60)")
    if int_best.f1 < qat_best.f1 - 0.5:
        raise AssertionError(f"integer F1 {int_best.f1:.2f} < QAT-sim {qat_best.f1:.2f} - 0.5")
    log("  the bands hold: float >= 60, integer >= QAT-sim - 0.5")


# yolov2-tiny-voc.cfg's topology with the quantization fields (20 classes,
# 416x416): the darknet deployment path reads it as text
V2_TINY_CFG = """[net]
batch=64
subdivisions=8
width=416
height=416
channels=3
momentum=0.9
decay=0.0005
learning_rate=0.001
burn_in=1000
max_batches=40200
policy=steps
steps=40000,45000
scales=.1,.1
start_quantization_step=20000
""" + "".join(
    f"[convolutional]\nbatch_normalize=1\nfilters={f}\nsize=3\nstride=1\npad=1\nactivation=leaky\n"
    f"quantized=1\n\n[maxpool]\nsize=2\nstride={st}\nquantized=1\n\n"
    for f, st in ((16, 2), (32, 2), (64, 2), (128, 2), (256, 2), (512, 1))
) + "".join(
    "[convolutional]\nbatch_normalize=1\nfilters=1024\nsize=3\nstride=1\npad=1\nactivation=leaky\n"
    "quantized=1\n\n" for _ in range(2)
) + """[convolutional]
size=1
stride=1
pad=1
filters=125
activation=linear
quantized=1
quant_stop=1

[region]
anchors=1.08,1.19, 3.42,4.41, 6.63,11.38, 9.42,5.11, 16.62,10.52
bias_match=1
classes=20
coords=4
num=5
softmax=1
jitter=.2
rescore=1
object_scale=5
noobject_scale=1
class_scale=1
coord_scale=1
absolute=1
thresh=.6
random=1
"""


def v2_engine_configs(size: int = 416):
    """name -> (program, launches per forward (K1, K2, shortcut), K1's
    launches by design (wgmma, halo, mma.sync, int16))."""
    from yolo_quantization_tpu_torch.models.presets import v2_program, v2_tiny_program

    return {"v2-tiny": (v2_tiny_program(classes=20, size=size, seed=0), (9, 0, 0), (6, 3, 0, 0)),
            "v2": (v2_program(classes=20, size=size, seed=0), (23, 0, 0), (20, 2, 1, 0))}


def compare_layer_outputs(what, net, outs_g, outs_c) -> None:
    """Codes and the dequantized, reorg and route floats bit for bit; the
    region layer's logistic and softmax (device math) within DECODE_TOL."""
    from yolo_quantization_tpu_torch.nn.graph import RegionSpec

    if len(outs_g) != len(outs_c) or len(outs_g) != len(net.specs):
        raise AssertionError(f"{what}: {len(outs_g)} / {len(outs_c)} layer outputs for {len(net.specs)} layers")
    for i, (g, c) in enumerate(zip(outs_g, outs_c)):
        if isinstance(net.specs[i], RegionSpec):
            np.testing.assert_allclose(g, c, **DECODE_TOL, err_msg=f"{what}: region layer {i}")
        elif g.dtype != c.dtype or not np.array_equal(g, c):
            raise AssertionError(f"{what}: layer {i} differs")


def phase_v2_engines(Engine, counters, rng, size: int = 416):
    """yolov2-tiny and yolov2 (416, 20 classes) GPU vs CPU.  Returns the
    CUDA engines."""
    x = rng.uniform(0, 1, (4, size, size, 3)).astype(np.float32)
    x_u8 = rng.integers(0, 256, (4, size, size, 3), dtype=np.uint8)
    engines = {}
    for cname, (program, expected, split) in v2_engine_configs(size).items():
        t0 = time.perf_counter()
        gpu, cpu = Engine(program, device="cuda"), Engine(program, device="cpu")
        engines[cname] = gpu
        for name, batch in (("float32", x), ("uint8", x_u8)):
            reset_counts(*counters)
            heads_g, outs_g = gpu.raw_heads(batch, return_outputs=True)
            got = tuple(c.launches for c in counters)
            if got != expected:
                raise AssertionError(f"{cname}: (K1, K2, shortcut) launches per forward {got}, expected {expected}")
            if size == 416 and design_split(counters[0]) != split:
                raise AssertionError(f"{cname}: K1 launches by design (wgmma, halo, mma.sync, int16) "
                                     f"{design_split(counters[0])}, expected {split}")
            heads_c, outs_c = cpu.raw_heads(batch, return_outputs=True)
            compare_layer_outputs(f"{cname} {name}", program.net, outs_g, outs_c)
            for g, c in zip(heads_g, heads_c):
                np.testing.assert_allclose(g, c, **DECODE_TOL)
            log(f"  {cname} {name} batch of 4: all {len(outs_g)} layer outputs equal to the CPU engine's "
                f"(the region layer within rtol 1e-5, atol 1e-6); {expected[0]} K1 launches ({split[0]} wgmma, "
                f"{split[1]} halo, {split[2]} mma.sync)")
        reset_counts(*counters)
        dets_g = gpu.predict(x)
        if tuple(c.launches for c in counters) != expected:
            raise AssertionError(f"{cname} predict launched {tuple(c.launches for c in counters)}")
        for a, b in zip(dets_g, cpu.predict(x)):
            np.testing.assert_allclose(a, b, **DECODE_TOL)
        boxes, obj, _ = dets_g
        if not (np.isfinite(boxes).all() and (obj >= 0).all() and (obj <= 1).all()):
            raise AssertionError(f"{cname} predict: non-finite boxes or objectness outside [0,1]")
        for a, b in zip(gpu.predict(x[:2], flip=True), cpu.predict(x[:2], flip=True)):
            np.testing.assert_allclose(a, b, **DECODE_TOL)
        g320, c320 = gpu.at_size(320), cpu.at_size(320)
        x320 = rng.uniform(0, 1, (2, 320, 320, 3)).astype(np.float32)
        compare_layer_outputs(f"{cname} at_size(320)", g320.program.net,
                              g320.raw_heads(x320, return_outputs=True)[1],
                              c320.raw_heads(x320, return_outputs=True)[1])
        for a, b in zip(g320.predict(x320), c320.predict(x320)):
            np.testing.assert_allclose(a, b, **DECODE_TOL)
        log(f"  {cname} predict, flip TTA and at_size(320): detections agree with the CPU engine's; "
            f"at_size(320) layers equal ({time.perf_counter() - t0:.1f} s)")
    return engines


def phase_float_programs(Engine, rng, test_device: str = "cuda") -> None:
    """yolov1-tiny (448) and darknet19 (224): the float program through the
    integer Engine and the float forward, GPU against CPU, every layer
    within float32 tolerance."""
    from yolo_quantization_tpu_torch.infer.convert import convert
    from yolo_quantization_tpu_torch.infer.float_engine import FloatEngine
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.nn import graph as G
    from yolo_quantization_tpu_torch.tools import qat_check as Q

    for name, net in (("yolov1-tiny", zoo.yolov1_tiny()), ("darknet19", zoo.darknet19())):
        t0 = time.perf_counter()
        params = G.init_params_numpy(0, net)
        program = convert(net, params, G.init_quant_state(net))
        x = rng.uniform(0, 1, (2, net.height, net.width, 3)).astype(np.float32)
        outs = [Engine(program, device=dev).raw_heads(x, return_outputs=True)[1]
                for dev in (test_device, "cpu")]
        for i, (g, c) in enumerate(zip(*outs)):
            Q.check_share(f"{name} program layer {i}", g, c, rtol=1e-4, atol=1e-5, share=1.0, scaled=True)
        fwd = []
        for dev in (test_device, "cpu"):
            eng = FloatEngine(net, params, device=dev)
            with torch.inference_mode():
                _, aux = G.forward(net, eng.params, torch.from_numpy(x).to(dev), return_outputs=True)
            fwd.append([o.cpu().numpy() for o in aux["outputs"]])
        for i, (g, c) in enumerate(zip(*fwd)):
            Q.check_share(f"{name} float layer {i}", g, c, rtol=1e-4, atol=1e-5, share=1.0, scaled=True)
        log(f"  {name} ({net.height}x{net.width}) float program through Engine and the float forward: all "
            f"{len(net.specs)} layers within rtol 1e-4, atol 1e-5 x max(1, |max|) of the CPU "
            f"({time.perf_counter() - t0:.1f} s)")


def phase_darknet_path(Engine, Server, Detection, counters, rng):
    """The darknet deployment path on the card: yolov2-tiny's QAT program
    (seeded params, synthetic ranges) written with save_darknet_weights, the
    cfg parsed from text, the file loaded (layout auto-detected), converted
    and served through K1.  The in-memory program is converted from the
    ranges as the file's float32 (scale, zero point) fields hold them; a
    second save of that state is byte-identical, and the loaded program's
    codes equal the in-memory program's at every layer.  Returns the
    server's launches."""
    import tempfile

    from yolo_quantization_tpu_torch.infer.convert import convert
    from yolo_quantization_tpu_torch.models import cfg as C
    from yolo_quantization_tpu_torch.models import darknet_weights as D
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.models.presets import v2_quant_state
    from yolo_quantization_tpu_torch.nn.graph import init_params_numpy

    t0 = time.perf_counter()
    net = zoo.yolov2_tiny(classes=20)
    params = init_params_numpy(0, net)
    qs = v2_quant_state(net)
    with tempfile.TemporaryDirectory() as d:
        first, second = os.path.join(d, "first.weights"), os.path.join(d, "yolov2-tiny-voc.weights")
        D.save_darknet_weights(first, net, params, qs, seen=32013)
        held = D.load_darknet_weights(first, net).quant_state
        program = convert(net, params, held)
        D.save_darknet_weights(second, net, params, held, seen=32013)
        with open(first, "rb") as f1, open(second, "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError("save -> load -> save is not byte-identical")
        size = os.path.getsize(second)
        cnet, train_cfg = C.parse_cfg(V2_TINY_CFG)
        if cnet != net:
            raise AssertionError("the cfg text does not parse to zoo.yolov2_tiny(classes=20)")
        ck = D.load_darknet_weights(second, cnet)
        if ck.seen != 32013 or not ck.raw_quant:
            raise AssertionError(f"seen {ck.seen}, quantization blocks {bool(ck.raw_quant)}")
        loaded = convert(cnet, ck.params, ck.quant_state)
    unsnapped = convert(net, params, qs)
    moved = sum(int((program.arrays[i]["m"] != unsnapped.arrays[i]["m"]).sum()) for i in program.arrays)
    eng, ref = Engine(loaded, device="cuda"), Engine(program, device="cpu")
    x = rng.uniform(0, 1, (4, 416, 416, 3)).astype(np.float32)
    reset_counts(*counters)
    _, outs = eng.raw_heads(x, return_outputs=True)
    if tuple(c.launches for c in counters) != (9, 0, 0):
        raise AssertionError(f"the loaded program launched {tuple(c.launches for c in counters)}")
    compare_layer_outputs("darknet path vs the in-memory program", net, outs,
                          ref.raw_heads(x, return_outputs=True)[1])
    log(f"  {size} bytes (quantized layout auto-detected), seen 32013, policy {train_cfg.policy}; "
        f"re-saved byte-identical; all {len(outs)} layers of the loaded program on the card equal the "
        f"in-memory program's (CPU); {moved} requant multipliers differ by float32 rounding between "
        f"the float64 ranges and the file's fields ({time.perf_counter() - t0:.1f} s)")
    return phase_serving(Server, Detection, counters, eng, (9, 0, 0), rng,
                         [(416, 416), (375, 500), (480, 640), (96, 128), (416, 416), (333, 222),
                          (600, 400), (256, 256)])


def phase_v2_qat_parity(rng, size: int = 416, test_device: str = "cuda") -> None:
    """yolov2-tiny (416, 20 classes, batch 4), GPU against CPU: the region
    loss and its gradient from the CPU's head output, then every layer
    (the region layer included) by tools/qat_check.py's rules in the
    float-train, EMA-QAT-train and QAT-eval modes, the loss's warm-up on."""
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.nn import graph as G
    from yolo_quantization_tpu_torch.tools import qat_check as Q
    from yolo_quantization_tpu_torch.tools.profile_train import synthetic_batch
    from yolo_quantization_tpu_torch.train.loss import total_loss

    net = zoo.yolov2_tiny(classes=20, width=size, height=size)
    params = G.params_to_torch(G.init_params_numpy(0, net), "cpu")
    images, truths = synthetic_batch(rng, 4, size, 20)
    x, t = torch.from_numpy(images), torch.from_numpy(truths)
    with torch.no_grad():
        heads, _ = G.forward(net, params, x, Q.MODES["float-train"])
    got = {}
    for dev in ("cpu", test_device):
        h = heads[0].detach().to(dev).requires_grad_(True)
        loss = total_loss([h], t.to(dev), net, seen=12000)[0]
        loss.backward()
        got[dev] = (float(loss.detach()), h.grad.cpu())
    Q.check_share("region loss", got[test_device][0], got["cpu"][0], rtol=1e-5, atol=0.0, share=1.0)
    Q.check_share("region loss gradient", got[test_device][1], got["cpu"][1], **Q.GRAD_TOL, share=1.0)
    log(f"  region loss {got[test_device][0]:.6f} on the card, {got['cpu'][0]:.6f} on the CPU; its "
        "gradient within the gradient rule everywhere")
    qs = Q.calibrated_ranges(net, params, x)
    for name in ("float-train", "ema-qat-train", "qat-eval"):
        w = Q.compare_devices(net, params, x, t, Q.MODES[name], qs, "cpu", test_device, seen=12000)
        log(f"  yolov2-tiny {name}: all {len(net.specs)} layers and the input within the rules "
            f"(smallest close shares: values {w['value']:.6f}, gradients {w['grad']:.6f}; "
            f"cotangent share zeroed {w['excluded']:.2e}; weight codes at a tie that differ "
            f"{w['code_flips']})")


def phase_v2_trainer(card: str, size: int = 416, device: str = "cuda") -> None:
    """An EMA-QAT yolov2-tiny step at 416, batch 16: three steps run twice
    from one seed must be equal bit for bit; then ms per step, images/s and
    peak memory over five."""
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.tools.profile_train import synthetic_batch
    from yolo_quantization_tpu_torch.train.qat import TrainConfig, Trainer

    net = zoo.yolov2_tiny(classes=20, width=size, height=size)
    images, truths = synthetic_batch(np.random.default_rng(7), 16, size, 20)
    x, t = torch.from_numpy(images).to(device), torch.from_numpy(truths).to(device)
    cfg = TrainConfig(burn_in=0, quant_start_step=0, batch_size=16)

    def run():
        tr = Trainer(net, cfg, seed=0, device=device)
        tr.state = tr.state._replace(seen=12800 - 32)  # crosses the warm-up's end
        return tr, [float(tr.step(x, t)["loss"]) for _ in range(3)]

    a, la = run()
    b, lb = run()
    differ = [f"{i}/{k}" for i, p in a.state.params.items() for k, v in p.items()
              if not torch.equal(b.state.params[i][k], v)]
    ranges = all(torch.equal(a.state.quant_state[k][n], b.state.quant_state[k][n])
                 for k in a.state.quant_state for n in ("min", "max"))
    if la != lb or differ or not ranges:
        raise AssertionError(f"yolov2-tiny training is not deterministic: losses {la} vs {lb}, "
                             f"params differing at {differ[:6]}, ranges equal {ranges}")
    log(f"  yolov2-tiny {size} batch 16, three EMA-QAT steps (seen crossing 12,800): losses "
        f"{', '.join(f'{v:.4f}' for v in la)}, equal bit for bit in a second run from the same seed")
    del b
    _timed_steps(a, x, t, 1)
    r = _timed_steps(a, x, t, 5)
    log(f"  train yolov2-tiny {size} batch 16 ema-qat: {r['ms_per_step']:.3f} ms/step, "
        f"{r['images_per_s']:.1f} images/s, peak {r['peak_mib']:.0f} MiB allocated "
        f"(torch.cuda.max_memory_allocated); losses finite; {card}")


def make_cli_dataset(root: str) -> str:
    """A synthetic VOC-style set for phase 15: 48 seeded dark images at
    mixed sizes, one to three coloured boxes each, JPEG and PNG alternately,
    with darknet labels."""
    from PIL import Image

    rng = np.random.default_rng(15)
    sizes = ((416, 416), (375, 500), (480, 640), (333, 222), (600, 400), (256, 256))
    os.makedirs(f"{root}/images", exist_ok=True)
    os.makedirs(f"{root}/labels", exist_ok=True)
    paths = []
    for i in range(48):
        h, w = sizes[i % len(sizes)]
        im = (rng.uniform(0, 0.22, (h, w, 3)) * 255).astype(np.uint8)
        labels = []
        for _ in range(1 + i % 3):
            bw, bh = rng.uniform(0.15, 0.6, 2)
            x, y = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
            cls = int(rng.integers(3))
            im[int((y - bh / 2) * h):int((y + bh / 2) * h), int((x - bw / 2) * w):int((x + bw / 2) * w)] = \
                CLASS_COLORS[cls]
            labels.append(f"{cls} {x:.4f} {y:.4f} {bw:.4f} {bh:.4f}")
        p = f"{root}/images/{i:06d}.{'jpg' if i % 2 == 0 else 'png'}"
        Image.fromarray(im).save(p, **({"quality": 95} if i % 2 == 0 else {}))
        with open(f"{root}/labels/{i:06d}.txt", "w") as f:
            f.write("\n".join(labels) + "\n")
        paths.append(p)
    list_file = f"{root}/list.txt"
    with open(list_file, "w") as f:
        f.write("\n".join(paths) + "\n")
    return list_file


def run_cli(argv: list[str]) -> str:
    """``cli.main.main(argv)`` in this process; returns what it printed."""
    import contextlib
    import io

    from yolo_quantization_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    return buf.getvalue()


def result_rows(path: str) -> list:
    """(image id, numbers) per line of a VOC comp4 file."""
    with open(path) as f:
        return [(ln.split()[0], np.array([float(v) for v in ln.split()[1:]])) for ln in f]


def same_rows(got, want, rtol: float, atol: float) -> bool:
    """The same lines, numbers within (rtol, atol plus each side's %.6f
    rounding); each pixel coordinate is a sum of two decoded terms bounded
    by the row's coordinates, so rtol applies to their sum of magnitudes."""
    if len(got) != len(want):
        return False
    for (gk, gv), (wk, wv) in zip(got, want):
        scale = np.r_[abs(wv[0]), np.full(len(wv) - 1, np.abs(wv[1:]).sum())]
        if gk != wk or (np.abs(gv - wv) > atol + 1e-6 + rtol * scale).any():
            return False
    return True


def time_host_stages(engine, paths, card: str) -> None:
    """write_voc_results' per-image stages timed one by one on this host:
    decode, letterbox, predict (one K1 forward, copy included), NMS and the
    result lines; then native against numpy letterbox and nms_sort on a
    720x1280 image at 416x416."""
    import io

    from yolo_quantization_tpu_torch.data.image import letterbox as np_letterbox
    from yolo_quantization_tpu_torch.data.image import load_image_rgb
    from yolo_quantization_tpu_torch.eval import detect
    from yolo_quantization_tpu_torch.utils import native

    net = engine.program.net
    stages = {"decode": [], "letterbox": [], "predict": [], "nms+write": []}
    sink = io.StringIO()
    t_all = time.perf_counter()
    for p in paths:
        t0 = time.perf_counter()
        im = load_image_rgb(p)
        t1 = time.perf_counter()
        x = native.letterbox(im, net.width, net.height)
        t2 = time.perf_counter()
        boxes, obj, cls = engine.predict(x[None])
        t3 = time.perf_counter()
        h, w, _ = im.shape
        b = detect.correct_boxes(boxes[0], w, h, net.width, net.height)
        probs = native.nms_sort(b, obj[0][:, None] * cls[0], 0.45)
        for k, ci in zip(*np.nonzero(probs > 0.005)):
            sink.write(f"{os.path.basename(p)} {probs[k, ci]:.6f} {b[k, 0]:.6f} {b[k, 1]:.6f} "
                       f"{b[k, 2]:.6f} {b[k, 3]:.6f}\n")
        t4 = time.perf_counter()
        for name, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[name].append(dt * 1e3)
    total = time.perf_counter() - t_all
    log("  valid's host stages per image (ms, median over "
        f"{len(paths)} images of mixed sizes): "
        + ", ".join(f"{k} {np.median(v):.3f}" for k, v in stages.items())
        + f"; {len(paths) / total:.1f} images/s one image at a time; {card}")

    rng = np.random.default_rng(16)
    im = rng.uniform(0, 1, (720, 1280, 3)).astype(np.float32)

    def median_ms(fn, reps=10):
        fn()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    size = (net.width, net.height)  # 416x416
    lb_native, lb_numpy = native.letterbox(im, *size), np_letterbox(im, *size)
    boxes, obj, cls = engine.predict(lb_native[None])
    b = detect.correct_boxes(boxes[0], 1280, 720, *size)
    probs = obj[0][:, None] * cls[0]
    ns_native, ns_numpy = native.nms_sort(b, probs, 0.45), detect.nms_sort_per_class(b, probs, 0.45)
    if np.abs(ns_native - ns_numpy).max() > 1e-6 or np.abs(lb_native - lb_numpy).max() > 1e-4:
        raise AssertionError("the native letterbox or nms_sort disagrees with numpy")
    log(f"  letterbox 720x1280 -> {size[0]}x{size[1]}: native "
        f"{median_ms(lambda: native.letterbox(im, *size)):.3f} ms, "
        f"numpy {median_ms(lambda: np_letterbox(im, *size)):.3f} ms (max |diff| "
        f"{np.abs(lb_native - lb_numpy).max():.2e}); nms_sort of {len(b)} detections x 5 classes: native "
        f"{median_ms(lambda: native.nms_sort(b, probs, 0.45)):.3f} ms, numpy "
        f"{median_ms(lambda: detect.nms_sort_per_class(b, probs, 0.45)):.3f} ms; {card}")


def device_busy_share(label: str, argv: list[str], logdir: str, card: str) -> None:
    """One CLI run under ``utils.profiling.trace``: the share of the traced
    span (first to last event) in which the card ran a kernel or a copy,
    from the union of the trace's CUDA events.  The profiler's own host
    overhead lengthens the span, so the share is a lower bound."""
    from torch.autograd import DeviceType

    from yolo_quantization_tpu_torch.utils import profiling

    with profiling.trace(logdir) as prof:
        run_cli(argv)
        torch.cuda.synchronize()
    events = list(prof.events())
    spans = sorted((e.time_range.start, e.time_range.end) for e in events if e.device_type == DeviceType.CUDA)
    if not spans:
        log(f"  {label} under torch.profiler: the trace holds no CUDA events; device busy share "
            f"not measured; {card}")
        return
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    extent = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    log(f"  {label} under torch.profiler: card busy {busy / 1e3:.3f} ms of a "
        f"{extent / 1e3:.3f} ms traced span ({busy / extent:.4f}; {len(spans)} CUDA events); {card}")


def phase_cli(counters, card: str) -> int:
    """The command line on the card (``cli.main.main`` in this process, and
    once as a user runs it): yolov3-tiny at 416, 5 classes, flagship ranges
    on seeded weights written as a quantized .weights; 48 images, training
    at batch 16.  Every card forward must launch K1 13 times.  Returns the
    phase's K1 launches."""
    import tempfile

    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.infer.serialize import load_program
    from yolo_quantization_tpu_torch.models.darknet_weights import save_darknet_weights
    from yolo_quantization_tpu_torch.models.presets import flagship_network, synthetic_quant_state
    from yolo_quantization_tpu_torch.nn.graph import init_params_numpy
    from yolo_quantization_tpu_torch.utils import native

    t_phase = time.perf_counter()
    if not native.available():
        raise AssertionError("the native host library did not build (a machine with nvcc has g++)")
    log(f"  native host library {os.path.basename(native.load_library()._name)}; image entry points "
        f"(libjpeg/libpng decode, fused augmentation) built: {native.has_image()}")
    model = ["--model", "yolov3-tiny", "--size", "416", "--classes", "5", "--device", "cuda"]
    with tempfile.TemporaryDirectory() as root:
        lst = make_cli_dataset(root)
        paths = open(lst).read().split()
        n = len(paths)
        net = flagship_network(classes=5, size=416)
        weights, program = f"{root}/flagship.weights", f"{root}/flagship.npz"
        save_darknet_weights(weights, net, init_params_numpy(0, net), synthetic_quant_state(net))
        src = ["--weights", weights]
        reset_counts(*counters)
        forwards = 0

        run_cli(["export-program", *model, *src, "--out", program])
        for s in (src, ["--program", program]):
            out = run_cli(["detect", *model, *s, "--image", paths[2], "--thresh", "0.3",
                           "--out", f"{root}/det.png"])
            forwards += 1
            if "predicted in" not in out or not os.path.getsize(f"{root}/det.png"):
                raise AssertionError(f"detect {s[0]} printed {out!r}")
        log(f"  export-program, detect --out from --weights and --program: "
            f"{len(out.splitlines()) - 2} boxes above 0.3")

        maps = {}
        for fmt in ("voc", "coco", "imagenet"):
            t0 = time.perf_counter()
            out = run_cli(["valid", *model, *src, "--test-list", lst, "--format", fmt, "--map",
                           "--out-dir", f"{root}/valid"])
            dt = time.perf_counter() - t0
            forwards += 2 * n  # the writer and voc_map each run every image once
            maps[fmt] = re.search(r"mAP@0.5 = ([\d.]+)", out).group(1)
            log(f"  valid --format {fmt} --map over {n} images: {dt:.2f} s ({2 * n / dt:.1f} forwards/s "
                f"with the host stages), mAP@0.5 {maps[fmt]}")
        if len(set(maps.values())) != 1:
            raise AssertionError(f"mAP differs between the valid runs: {maps}")
        with open(f"{root}/valid/coco_results.json") as f:
            coco = json.load(f)
        if not coco or not all(np.isfinite(d["bbox"]).all() for d in coco):
            raise AssertionError("empty or non-finite COCO results")

        t0 = time.perf_counter()
        out = run_cli(["f1", *model, *src, "--test-list", lst])
        f1_s = time.perf_counter() - t0
        forwards += -(-n // 16)  # f1 runs batches of 16
        best = re.search(r"best: .*", out).group(0)
        out = run_cli(["recall", *model, "--program", program, "--test-list", lst])
        forwards += n
        log(f"  f1 over {n} images at batch 16: {n / f1_s:.1f} images/s ({best}); "
            f"recall: {out.strip()}; {card}")

        demos = [("frames", f"{root}/images", ["--out-dir", f"{root}/demo"])]
        try:
            import cv2  # noqa: F401

            from yolo_quantization_tpu_torch.data.video import synthesize_clip

            demos.append(("video", synthesize_clip(f"{root}/clip.mp4", n_frames=48, size=320),
                          ["--out-video", f"{root}/clip_det.mp4"]))
        except ImportError:
            log("  cv2 does not import here: the video demo is not run")
        for kind, frames, extra in demos:
            out = run_cli(["demo", *model, "--program", program, "--frames", frames, *extra,
                           "--batch-size", "8", "--thresh", "0.3"])
            m = re.search(r"(\d+) frames in ([\d.]+)s \(([\d.]+) fps\), (\d+) batches, avg fill ([\d.]+)", out)
            forwards += int(m.group(4))
            log(f"  demo over a {kind} {'directory' if kind == 'frames' else 'file'}: {m.group(1)} frames, "
                f"{m.group(3)} fps, {m.group(4)} batches of 8, fill {m.group(5)}; {card}")

        # the trained program through K1: train, export, valid
        t0 = time.perf_counter()
        out = run_cli(["train", *model, "--train-list", lst, "--backup-dir", f"{root}/backup",
                       "--batch-size", "16", "--max-batches", "3", "--quant-start", "1"])
        losses = [float(v) for v in re.findall(r"^\d+: loss ([\d.naninf]+)", out, re.M)]
        if len(losses) != 3 or not np.isfinite(losses).all():
            raise AssertionError(f"train printed {out!r}")
        run_cli(["export", *model, "--ckpt", f"{root}/backup", "--out", f"{root}/trained.weights"])
        out = run_cli(["valid", *model, "--weights", f"{root}/trained.weights", "--test-list", lst,
                       "--format", "voc", "--map", "--max-images", "16", "--out-dir", f"{root}/trained"])
        forwards += 2 * min(n, 16)
        if "FLOAT" in out or "mAP@0.5" not in out:
            raise AssertionError(f"the trained program was not served by the integer engine: {out!r}")
        log(f"  train 3 steps at batch 16 (QAT from step 1; losses {', '.join(f'{v:.4f}' for v in losses)}), "
            f"export, valid --map on {min(n, 16)} images through K1: {re.search(r'mAP.*', out).group(0)} "
            f"({time.perf_counter() - t0:.1f} s)")

        # the card against the CPU on the first 4 images
        res = {}
        for dev in ("cuda", "cpu"):
            out = run_cli(["valid", *model, *src, "--test-list", lst, "--format", "voc", "--map",
                           "--max-images", "4", "--out-dir", f"{root}/four_{dev}", "--device", dev])
            res[dev] = ([ln for ln in out.splitlines() if "AP" in ln],
                        [result_rows(f"{root}/four_{dev}/comp4_det_test_class{c}.txt") for c in range(5)])
        forwards += 2 * min(n, 4)
        if res["cuda"][0] != res["cpu"][0]:
            raise AssertionError(f"AP/mAP differ: card {res['cuda'][0]}, CPU {res['cpu'][0]}")
        for c, (g, w) in enumerate(zip(res["cuda"][1], res["cpu"][1])):
            if not same_rows(g, w, **DECODE_TOL):
                raise AssertionError(f"valid on the card and on the CPU differ in class{c}'s file")
        log(f"  valid --map on {min(n, 4)} images, card vs --device cpu: {sum(map(len, res['cuda'][1]))} result lines "
            f"equal within rtol 1e-5, atol 1e-6 in the same order; {res['cuda'][0][-1]} on both")

        launches = tuple(c.launches for c in counters)
        if launches != (13 * forwards, 0, 0):
            raise AssertionError(f"(K1, K2, shortcut) launches {launches} for {forwards} card forwards, "
                                 f"expected {13 * forwards} K1")
        log(f"  {forwards} card forwards, (K1, K2, shortcut) launches {launches}")

        # once as a user runs it
        proc = subprocess.run([sys.executable, "-m", "yolo_quantization_tpu_torch.cli", "detect", *model,
                               *src, "--image", paths[0]], cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0 or "predicted in" not in proc.stdout:
            raise AssertionError(f"python -m yolo_quantization_tpu_torch.cli detect failed:\n{proc.stderr}")
        log(f"  python -m yolo_quantization_tpu_torch.cli detect: exit 0, {proc.stdout.splitlines()[0]}")

        device_busy_share(f"valid --format voc over {n} images",
                          ["valid", *model, *src, "--test-list", lst, "--format", "voc",
                           "--out-dir", f"{root}/traced"], f"{root}/trace", card)
        time_host_stages(Engine(load_program(program), device="cuda"), paths, card)
    log(f"  phase 15: {time.perf_counter() - t_phase:.1f} s")
    return launches[0]


def phase_parity(counters, card: str, workdir: str) -> tuple[int, ...]:
    """Phase 18: tools/parity_check.py at 416, static and dynamic input, on
    one seeded image (tier 2 must pass), then tools/crossf1.py short (12
    train images at 96, 150 steps, batch 8, 6 eval images at 416; contract
    2 must hold).  Returns the (K1, K2, shortcut) launches of the phase."""
    from yolo_quantization_tpu_torch.tools import crossf1, parity_check

    reset_counts(*counters)
    for dynamic in (False, True):
        t0 = time.perf_counter()
        r = parity_check.check(os.path.join(workdir, "parity"), dynamic=dynamic, seed=0)
        mode = "dynamic" if dynamic else "static"
        log(f"  parity_check {mode}: max LSB per u8 layer "
            + ", ".join(f"{i}:{v['max']}" for i, v in r["tier2_engine_lsb"].items())
            + f"; wraps {r['tier2_wraps']}; quant_stop max |d| "
            + ", ".join(f"{i}:{v:.4g}" for i, v in r["tier2_quant_stop_max_abs"].items()))
        log(f"  parity_check {mode}: twin {r['twin_seconds']:.3f} s on the host (step-wise float32 GEMM "
            f"in convs {r['twin_stepwise_convs']}), detections twin / engine "
            f"{r['tier2_det_counts']['twin']} / {r['tier2_det_counts']['engine']}, counts at "
            f"{r['tier2_f1_counts']['twin']['thresh']} twin {r['tier2_f1_counts']['twin']} engine "
            f"{r['tier2_f1_counts']['engine']}; sweep twin "
            f"{[(c['tp'], c['tp_fp']) for c in r['f1_sweep']['twin']]} engine "
            f"{[(c['tp'], c['tp_fp']) for c in r['f1_sweep']['engine']]}; tier 1: {r['tier1']}; "
            f"{time.perf_counter() - t0:.1f} s")
        if not r["tier2_ok"]:
            raise AssertionError(f"parity_check {mode}: tier 2 failed: {json.dumps(r, default=str)[:3000]}")
    t0 = time.perf_counter()
    out = crossf1.run(os.path.join(workdir, "crossf1"), steps=150, train_size=96, batch=8, n_train=12,
                      n_eval=6, device="cuda", tag="smoke", log=lambda m: log(f"    {m}"))
    log(f"  crossf1 (150 steps at 96, batch 8, 6 eval images at 416): {json.dumps(crossf1.summary(out))}")
    log(f"  crossf1: twin {out['twin_c_exact']['seconds']:.3f} s over 6 images, training "
        f"{out['train']['seconds']:.1f} s, all {time.perf_counter() - t0:.1f} s [{card}]")
    if not out["contract2_engine_within_half_point_of_qat_sim"]:
        raise AssertionError("crossf1 contract 2: the engine's best F1 is more than 0.5 under the QAT sim's")
    launches = tuple(c.launches for c in counters)
    if launches[0] == 0 or launches[1:] != (0, 0):
        raise AssertionError(f"phase 18 launched (K1, K2, shortcut) {launches}, not K1 alone")
    log(f"  phase 18: (K1, K2, shortcut) launches {launches}")
    return launches


def phase_bench(counters, card: str) -> tuple[int, ...]:
    """Phase 19: the command line's bench and bench --v3, tools/bench_serving.py
    at four offered rates of about 4 s each (picked from predict's batch-1
    and batch-16 rates), tools/bench_train.py chip (5 steps), and
    tools/dryrun.py (entry() and dryrun_multichip(1) on a one-rank NCCL
    group).  Returns the (K1, K2, shortcut) launches of the phase."""
    from yolo_quantization_tpu_torch.cli.main import main as cli
    from yolo_quantization_tpu_torch.models.presets import flagship_program
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.tools import bench_serving, bench_train, dryrun

    reset_counts(*counters)
    t0 = time.perf_counter()
    cli(["bench"])
    log(f"  bench: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli(["bench", "--v3"])
    log(f"  bench --v3: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine = Engine(flagship_program(), max_det=64)
    images = bench_serving.request_images()
    r1, r16 = bench_serving.predict_rates(engine, images)
    rates = bench_serving.suggest_rates(r1, r16)
    log(f"  serving: predict {r1:.1f} images/s at batch 1, {r16:.1f} at 16 -> offered rates "
        f"{[round(r, 1) for r in rates]}")
    rows = bench_serving.serve_rates(engine, rates, 4.0, log=lambda m: log(f"  {m}"))
    log(bench_serving.table(rows))
    log(f"  serving: {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    bench_train.bench_chip(batch=64, steps=5)
    log(f"  bench_train chip: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fn, args = dryrun.entry()
    heads = fn(*args)
    log(f"  dryrun entry(): heads {[tuple(h.shape) for h in heads]}")
    dryrun.dryrun_multichip(1)
    log(f"  dryrun: {time.perf_counter() - t0:.1f} s")
    launches = tuple(c.launches for c in counters)
    if launches[0] == 0 or launches[2] == 0 or launches[1] != 0:
        raise AssertionError(f"phase 19 launched (K1, K2, shortcut) {launches}")
    log(f"  phase 19: (K1, K2, shortcut) launches {launches}")
    return launches


# phase 20 (c): each other path of the capstone at a short schedule, and its
# integer launches per evaluated batch (K1, K2, shortcut); --learned runs 400
# steps, so its learned-range steps (from quant_start + range_warmup = 360)
# run
CAPSTONE_VARIANTS = (
    (["40", "8", "--bf16"], (13, 0, 0)),
    (["40", "8", "--v3"], (75, 0, 23)),
    (["40", "8", "--v2"], (9, 0, 0)),
    (["40", "8", "--leaky"], (13, 0, 0)),
    (["400", "8", "--learned"], (13, 0, 0)),
    (["40", "8", "--percentile"], (13, 0, 0)),
    (["40", "8", "--float-baseline"], (0, 0, 0)),
)
# phase 20 (b): the flagship capstone's schedule.  The tool's protocol is
# 3000 steps (quantization from 1,200; 262-267 s of training on an H100,
# PERF.md §5); after phases 1-19 (487-610 s in earlier runs) that would put
# the script at or past 15 minutes.  At 1500 steps quantization starts at
# 600, training takes about 139 s, and both halves of the contract are
# still asserted
CAPSTONE_STEPS = 1500


def record_key_sets(name: str) -> tuple[set, set]:
    """The top-level and ``config`` key sets of a record the JAX script wrote."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), name)) as f:
        rec = json.load(f)
    return set(rec), set(rec["config"])


def count_launches(counters, what: str, expected: tuple[int, ...]) -> tuple[int, ...]:
    got = tuple(c.launches for c in counters)
    if got != expected:
        raise AssertionError(f"{what} launched (K1, K2, shortcut) {got}, expected {expected}")
    return got


def run_capstone(args: list[str], workdir: str, say=log) -> dict:
    """tools/accuracy_capstone.py on the card with ``args``, its record in
    ``workdir``, its lines through ``say``: every printed loss finite, the
    record's key sets the JAX script's.  Returns the record and the
    training's peak memory."""
    from yolo_quantization_tpu_torch.tools import accuracy_capstone

    out, info = accuracy_capstone.main(args + [f"--out-dir={workdir}", "--tag=smoke"],
                                       log=lambda m: say(f"    {m}"))
    if not np.isfinite([v for _, v in info["losses"]]).all():
        raise AssertionError(f"capstone {args}: a non-finite loss among the printed {info['losses']}")
    want = record_key_sets("FLOATBASE_V3_r05.json" if "--float-baseline" in args else "ACCURACY_V2_r05.json")
    if (set(out), set(out["config"])) != want:
        raise AssertionError(f"capstone {args}: the record's key sets differ from the JAX script's")
    return out | {"peak_mib": info["peak_mib"]}


def phase_accuracy_loop(counters, card: str) -> tuple[int, ...]:
    """Phase 20 (a): tools/synthetic_accuracy_loop.py at its 400 steps; its
    |integer F1 - float F1| <= 0.5 must hold."""
    from yolo_quantization_tpu_torch.tools import synthetic_accuracy_loop

    reset_counts(*counters)
    t0 = time.perf_counter()
    int_best, float_best = synthetic_accuracy_loop.main(400, "cuda")
    got = count_launches(counters, "the synthetic accuracy loop", (13, 0, 0))  # 16 images: one batch
    log(f"  (a) synthetic_accuracy_loop, 400 steps: integer F1 {int_best.f1:.2f}, float F1 {float_best.f1:.2f}, "
        f"gap {abs(int_best.f1 - float_best.f1):.2f} <= 0.5; {time.perf_counter() - t0:.1f} s [{card}]")
    return got


def _capstone_worker(args: list[str], workdir: str, results) -> None:
    """Phase 20 (b)'s run, in a process of its own: the record, its
    (K1, K2, shortcut) launches, its wall time and its printed lines go
    back through ``results``."""
    lines, t0 = [], time.perf_counter()
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from yolo_quantization_tpu_torch.ops import cuda_qconv, cuda_s2d, cuda_shortcut

        counters = (cuda_qconv, cuda_s2d, cuda_shortcut)
        reset_counts(*counters)
        out = run_capstone(args, workdir, say=lines.append)
        results.put(("ok", out, tuple(c.launches for c in counters), time.perf_counter() - t0, lines))
    except BaseException:
        results.put(("failed", traceback.format_exc(), None, time.perf_counter() - t0, lines))
        raise


def start_flagship_capstone(workdir: str):
    """Phase 20 (b), started in a spawned (daemonic: it ends with the
    script) process as soon as the kernels are built, so that its ~150 s of
    training overlap phases 3-8, 12-14 (correctness and gates, no timings);
    ``finish_flagship_capstone`` collects it before the timed phases."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=_capstone_worker, args=([str(CAPSTONE_STEPS), "32"], workdir, results),
                       daemon=True)
    proc.start()
    return proc, results


def finish_flagship_capstone(handle, card: str) -> tuple[int, ...]:
    """Phase 20 (b)'s result: the capstone at the flagship's configuration
    (yolov3-tiny, relu6, 416, 5 classes, batch 32, multiscale, 200 eval
    images) for CAPSTONE_STEPS steps; both halves of its contract must
    hold."""
    proc, results = handle
    while True:
        try:
            status, out, got, seconds, lines = results.get(timeout=5)
            break
        except queue.Empty:
            if not proc.is_alive():
                raise AssertionError(f"the flagship capstone's process ended (exit code {proc.exitcode}) "
                                     "without a result")
    proc.join(timeout=60)
    if proc.is_alive():
        proc.kill()
        proc.join()
    for line in lines:
        log(line)
    if status != "ok":
        raise AssertionError(f"the flagship capstone failed in its process:\n{out}")
    if got != (13 * 8, 0, 0):  # 8 batches of 25
        raise AssertionError(f"the flagship capstone's integer row launched (K1, K2, shortcut) {got}, "
                             f"expected {(13 * 8, 0, 0)}")
    log(f"  (b) capstone yolov3-tiny relu6 416, {CAPSTONE_STEPS} steps, batch 32, multiscale: float F1 "
        f"{out['float']['f1']}, QAT-sim {out['qat_sim']['f1']}, integer {out['int']['f1']}; gaps "
        f"{out['f1_gap']} / {out['f1_gap_vs_qat_sim']}; train_seconds {out['train_seconds']} (beside phases "
        f"3-14), peak {out['peak_mib']:.1f} MiB; K1 launches {got[0]}; {seconds:.1f} s in its process [{card}]")
    if not (out["within_half_point"] and out["int_within_half_of_qat_sim"]):
        raise AssertionError(f"the flagship capstone's contract failed: {json.dumps(out)}")
    return got


def phase_capstone_variants(counters, card: str, workdir: str) -> tuple[int, ...]:
    """Phase 20 (c): every other capstone path at a short schedule, on the
    card; contracts printed, not asserted."""
    total = np.zeros(3, np.int64)
    for args, per_batch in CAPSTONE_VARIANTS:
        reset_counts(*counters)
        t0 = time.perf_counter()
        out = run_capstone(args + ["--eval-images=25"], workdir)
        total += count_launches(counters, f"capstone {args}", per_batch)
        rows = {k: out[k]["f1"] for k in ("float", "qat_sim", "int") if k in out}
        log(f"  (c) capstone {' '.join(args)}: F1 {rows}; contract (printed, not asserted) "
            f"{out.get('within_half_point')} / {out.get('int_within_half_of_qat_sim')}; train_seconds "
            f"{out['train_seconds']}, peak {out['peak_mib']:.1f} MiB; launches {per_batch}; "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
    return tuple(int(v) for v in total)


def phase_accuracy_capstone(counters, card: str, workdir: str, flagship: tuple[int, ...]) -> tuple[int, ...]:
    """Phase 20: (a) and (c), beside (b)'s launches ``flagship``.  Returns
    the (K1, K2, shortcut) launches of the phase."""
    total = np.array(flagship, np.int64)
    total += phase_accuracy_loop(counters, card)
    total += phase_capstone_variants(counters, card, workdir)
    log(f"  phase 20: (K1, K2, shortcut) launches {tuple(int(v) for v in total)}")
    return tuple(int(v) for v in total)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA GPU")
    if argv:
        raise SystemExit(f"chip_smoke: unknown arguments {argv}; see the docstring")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.infer.serving import Detection, Server
    from yolo_quantization_tpu_torch.ops import (_build, cuda_qconv, cuda_s2d, cuda_shortcut, cuda_spp, qconv,
                                                 shortcut)
    from yolo_quantization_tpu_torch.tools import kernel_timings as timings
    from yolo_quantization_tpu_torch.tools import orientation_probe as probe

    t_start = time.perf_counter()

    def phase(title: str) -> None:  # a phase's header, with the script's elapsed time
        log(f"{title} [{time.perf_counter() - t_start:.1f} s]")

    # the reference comparisons are integer or float64; state the float32 defaults anyway
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(8, os.cpu_count() or 1))

    phase("phase 1: card")
    card = timings.card_identity()
    kind = torch.cuda.get_device_name(0)
    log(f"  nvidia-smi: {card}; torch: {kind}; devices {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    phase("phase 2: build (phase 10, which launches no kernel of the repo, runs meanwhile)")
    libs = _build.LIBRARIES
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        building = pool.submit(_build.build_all, libs)
        phase("phase 10: QAT forward and backward, GPU vs CPU")
        phase_qat_parity(np.random.default_rng(10))
        t1 = time.perf_counter()
        phase_v2_qat_parity(np.random.default_rng(12))
        log(f"  phase 10, yolov2-tiny part: {time.perf_counter() - t1:.1f} s")
        building.result()
    cuda_qconv.build()
    cuda_s2d.build()
    cuda_shortcut.build()
    cuda_spp.build()
    probe.build()
    log(f"  {', '.join(f'csrc/{n}.cu' for n in libs)} built in parallel and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in libs:
        log(f"  {name}: nvcc {_build.build_seconds.get(name, 0.0):.2f} s")
        for line in _build.build_log.get(name, "").splitlines():
            if "error" in line:
                log(f"    nvcc: {line.strip()}")
    wgmma, halo, s2d_halo = phase_kernel_report(libs)
    log(f"  {len(wgmma)} wgmma instantiations of K1, each with IGMMA and no IMMA; {len(halo)} halo "
        f"instantiations of K1 and {len(s2d_halo)} of K2, each with IMMA and UTMALDG (K2's with no IDP)")

    capstone_dir = tempfile.TemporaryDirectory()
    phase("phase 20 (b): the flagship capstone starts in its own process (its result after phase 14)")
    capstone = start_flagship_capstone(capstone_dir.name)

    rng = np.random.default_rng(0)
    errors = Errors()
    phase("phase 3: K1 (qconv) vs plain version (bit for bit)")
    n1, n2, by_design = phase_k1(cuda_qconv, qconv, rng, errors)
    log(f"  {n1} stride-1 and {n2} stride-2 cases equal; runs by design {by_design}")
    # the phases this slice added draw from their own generator, so the
    # earlier phases keep the inputs they had
    rng_v2 = np.random.default_rng(7)
    n3, _, by_design = phase_k1(cuda_qconv, qconv, rng_v2, errors, v2_conv_cases())
    log(f"  {n3} cases on the yolov2 family's shapes equal; runs by design {by_design}")
    n4, _, by_design = phase_k1(cuda_qconv, qconv, np.random.default_rng(11), errors, v3_conv_cases())
    log(f"  {n4} cases on yolov3's stride-1 shapes from Ci 64 equal; runs by design {by_design}")
    n5, n6, by_design = phase_k1(cuda_qconv, qconv, np.random.default_rng(13), errors, halo_cases())
    log(f"  {n5 + n6} cases on the halo design's edges equal; runs by design {by_design}")
    phase("phase 4: K2 (s2d_qconv) vs plain version (bit for bit)")
    runs = phase_k2(cuda_s2d, qconv, rng, errors, s2d_cases())
    log(f"  {len(s2d_cases())} cases equal; runs by design {runs}")
    runs = phase_k2(cuda_s2d, qconv, np.random.default_rng(17), errors, s2d_halo_cases())
    log(f"  {len(s2d_halo_cases())} cases of the halo design (four phase kernels, its edges) equal; runs by "
        f"design {runs}")
    phase("phase 5: K3 (orientation probe) at the script's sizes vs plain version (bit for bit)")
    probe_results, probe_launches = phase_probe(probe, errors)
    phase("phase 5b: the integer shortcut vs plain version (bit for bit)")
    log(f"  {phase_shortcut(cuda_shortcut, shortcut, rng, errors)} cases equal")

    counters = (cuda_qconv, cuda_s2d, cuda_shortcut)
    phase("phase 6: engines (yolov3-tiny 416, 5 classes; yolov3 416, 80 classes) GPU vs CPU")
    engines, main_launches = phase_engines(Engine, counters, rng)

    phase("phase 6b: YOLOv4 (608, 80 classes): mish in K1 by design, spp_kernel, the Engine GPU vs CPU")
    phase_v4_kernels(cuda_qconv, cuda_spp, qconv, np.random.default_rng(19), errors)
    v4_launches = phase_v4(Engine, counters, cuda_spp, np.random.default_rng(23))

    phase("phase 7: flip TTA, at_size(320), f1_rows")
    phase_flip_size_f1(Engine, engines, rng)

    phase("phase 8: serving")
    launches = phase_serving(Server, Detection, counters, engines["flagship"], (13, 0, 0), rng,
                             [(416, 416), (300, 500), (480, 640), (120, 90), (416, 416), (333, 222),
                              (600, 400), (64, 96), (250, 250), (720, 1280)])
    v3_launches = phase_serving(Server, Detection, counters, engines["v3"], (75, 0, 23), rng,
                                [(416, 416), (480, 640), (120, 90), (333, 222), (720, 1280), (256, 256)])

    phase("phase 13: yolov2-tiny and yolov2 engines (416, 20 classes) GPU vs CPU; yolov1-tiny and "
        "darknet19 float programs")
    t0 = time.perf_counter()
    engines.update(phase_v2_engines(Engine, counters, rng_v2))
    phase_float_programs(Engine, rng_v2)
    log(f"  phase 13: {time.perf_counter() - t0:.1f} s")
    phase("phase 13b: the darknet deployment path (.cfg text + .weights -> convert -> Engine -> Server)")
    t0 = time.perf_counter()
    v2_launches = phase_darknet_path(Engine, Server, Detection, counters, rng_v2)
    log(f"  phase 13b: {time.perf_counter() - t0:.1f} s")

    phase("phase 12: the synthetic accuracy gate through the port (QAT -> convert -> K1)")
    phase_accuracy_gate(Engine, counters)
    phase("phase 14: the yolov2-tiny region gate through the port (QAT -> convert -> K1)")
    t0 = time.perf_counter()
    phase_v2_gate(Engine, counters)
    log(f"  phase 14: {time.perf_counter() - t0:.1f} s")
    phase("phase 20 (b): the flagship capstone's result (the timed phases follow)")
    flagship_capstone = finish_flagship_capstone(capstone, card)
    capstone_dir.cleanup()

    phase("phase 9: timings")
    k1, k2, k3, sc, sp = timings.time_all(engines, probe_results, card, rng, v3_batches=(16,))
    timings.time_k1_v2(cuda_qconv, qconv, rng_v2, card)

    phase("phase 11: the Trainer (yolov3-tiny 416 batch 16; yolov3 416 batch 8; yolov2-tiny 416 batch 16)")
    phase_trainer(card)
    t0 = time.perf_counter()
    phase_v2_trainer(card)
    log(f"  phase 11, yolov2-tiny part: {time.perf_counter() - t0:.1f} s")
    phase("phase 15: the command line on the card (yolov3-tiny 416, 5 classes, 48 images)")
    cli_launches = phase_cli(counters, card)
    from yolo_quantization_tpu_torch.tools import parallel_check, wordtree_check

    phase("phase 16: parallelism (one-rank NCCL DDP/FSDP2, two gloo ranks on the card, TP)")
    t0 = time.perf_counter()
    tp_launches = parallel_check.run(card)["launches"]
    log(f"  phase 16: {time.perf_counter() - t0:.1f} s")
    phase("phase 17: the WordTree detector, classifier and segmenter, card vs CPU")
    t0 = time.perf_counter()
    tree_launches = wordtree_check.run(card)["launches"]
    log(f"  phase 17: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as workdir:
        phase("phase 18: the C-parity harness (parity_check static and dynamic, crossf1 short)")
        t0 = time.perf_counter()
        parity_launches = phase_parity(counters, card, workdir)
        log(f"  phase 18: {time.perf_counter() - t0:.1f} s")
    phase("phase 19: the benchmarks (bench, bench --v3, bench_serving, bench_train) and the dry run")
    t0 = time.perf_counter()
    bench_launches = phase_bench(counters, card)
    log(f"  phase 19: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as workdir:
        phase("phase 20: the synthetic accuracy loop and the capstone's other paths (QAT -> convert -> K1)")
        t0 = time.perf_counter()
        capstone_launches = phase_accuracy_capstone(counters, card, workdir, flagship_capstone)
        log(f"  phase 20: {time.perf_counter() - t0:.1f} s")
    log(f"  main-path K1 launches: yolov3-tiny server {launches[0]}, yolov3 server {v3_launches[0]}, "
        f"yolov2-tiny darknet-path server {v2_launches[0]}, command line {cli_launches}, "
        f"TP engine {tp_launches}, WordTree engine {tree_launches}, parity harness {parity_launches[0]}, "
        f"benchmarks and dry run {bench_launches[0]} (shortcut {bench_launches[2]}), accuracy loop and "
        f"capstones {capstone_launches[0]} (shortcut {capstone_launches[2]}), YOLOv4 engine {v4_launches[0]} "
        f"(shortcut {v4_launches[1]}, spp {v4_launches[2]})")
    log(f"  total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [
        k1.entry("qconv", "yolo_quantization_tpu_torch/csrc/qconv.cu",
                 "yolo_quantization_tpu/ops/pallas_qconv.py:173",
                 launches[0] + v3_launches[0] + v2_launches[0] + cli_launches + tp_launches + tree_launches
                 + parity_launches[0] + bench_launches[0] + capstone_launches[0] + v4_launches[0],
                 errors.worst["qconv"]),
        k2.entry("s2d_qconv", "yolo_quantization_tpu_torch/csrc/s2d_qconv.cu",
                 "yolo_quantization_tpu/ops/pallas_qconv.py:356", main_launches["s2d"][1],
                 errors.worst["s2d_qconv"]),
        sc.entry("shortcut", "yolo_quantization_tpu_torch/csrc/shortcut.cu",
                 "yolo_quantization_tpu/infer/engine.py:428-469",
                 main_launches["v3"][2] + bench_launches[2] + capstone_launches[2] + v4_launches[1],
                 errors.worst["shortcut"]),
        sp.entry("spp", "yolo_quantization_tpu_torch/csrc/spp.cu",
                 "yolo_quantization_tpu/nn/layers.py:164", v4_launches[2], errors.worst["spp"]),
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
