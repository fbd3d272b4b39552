"""The C-parity harness: the port's integer engine scored against the
C-exact twin of the compiled reference darknet.

The counterpart of ``scripts/parity_c.py``:

    python -m yolo_quantization_tpu_torch.tools.parity_check [--dynamic] [--seed 0]
        [--image PATH] [--device cuda|cpu] [--out DIR]

1. **Export.**  Random flagship weights (yolov3-tiny, relu6, 5 classes, the
   standard tiny anchors), ranges calibrated by one QAT forward with
   ``update_ranges`` on the letterboxed image, written with
   ``save_darknet_weights``.  The image is a seeded synthetic lossless one
   with labels (``tools/crossf1.py::render_dataset``), unless ``--image``
   names one (its labels, where they exist, beside it).
2. **The twin** (``parity/ctwin.py``) runs the file on the letterboxed CHW
   image: the reference's arithmetic byte for byte.
3. **The engine** runs the same file in parity mode on the device: the
   loaded checkpoint converted as ``models/presets.py::parity_program``
   converts (asymmetric per-channel weights, ``route_rescale=False``) and run
   with ``exact_leaky`` and every layer its own output (``fuse_pool=False``),
   the input quantized with the twin's (scale, zero point), or per image
   in the engine with ``--dynamic``.  K1 runs every conv.
4. **Tier 2**, per u8 layer: the LSB deltas against the twin (max, mean,
   share off by more than 1), with the positions where C wraps mod 256 and
   the engine saturates (|delta| > 128) counted apart; the quant_stop
   dequants; the detections of both decoded by the twin's decode; the
   detector-f1 protocol's counts (``eval/f1.py::f1_rows``, class-agnostic
   NMS 0.1) on both, at ``--thresh`` (0.25, as ``scripts/parity_c.py``)
   and, reported beside it, over the sweep's thresholds 0.1-0.6.  It
   passes when every layer's max LSB is at most 16 (the JAX test's bound)
   and, at ``--thresh``, the engine's TP and TP_FN equal the twin's and its
   TP_FP is within 5% of the twin's.
5. **Tier 1** (the twin against the compiled binary, byte for byte) runs
   only where the reference sources (``REF``) and gcc exist: it builds the
   reference and ``native/parity_shim.c`` under ``build/torch_ref``.
   Elsewhere the verdict says ``"tier1": "not run: reference sources
   absent"`` and tier 2 alone decides ``ok``.

Prints one JSON verdict line; exits 0 only when ``ok`` is true.  Runs on
the GPU unless ``--device cpu`` is given, and raises where there is no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from yolo_quantization_tpu_torch.infer.float_engine import resolve_device

MAX_LSB = 16       # tests/test_parity_c.py's bound on a layer's worst delta
TP_FP_REL = 0.05   # proposals may move with LSB drift near a threshold
DECODE_THRESH = 0.05


def export_checkpoint(net, sized_hwc: np.ndarray, path: str, seed: int = 0, device="cuda"):
    """Seeded random params, ranges from one QAT forward with
    ``update_ranges`` on the image (asymmetric weight fake-quant, the scheme
    the file holds), written as a quantized .weights file.  Returns (params,
    ranges) as numpy."""
    from yolo_quantization_tpu_torch.models.darknet_weights import save_darknet_weights
    from yolo_quantization_tpu_torch.nn.graph import (
        ForwardMode,
        forward,
        init_params_numpy,
        init_quant_state,
        params_to_torch,
        quant_state_to_numpy,
        quant_state_to_torch,
    )

    dev = resolve_device(device, "parity_check")
    params = init_params_numpy(seed, net)
    x = torch.from_numpy(np.ascontiguousarray(sized_hwc, np.float32)[None]).to(dev)
    with torch.no_grad():
        _, aux = forward(net, params_to_torch(params, dev), x,
                         ForwardMode(train=False, qat=True, update_ranges=True, symmetric_w=False),
                         quant_state_to_torch(init_quant_state(net), dev))
    qs = quant_state_to_numpy(aux["quant_state"])
    # the reference's asymmetric per-channel weight codes: the parity
    # engine's conversion of the loaded params gives the same codes
    save_darknet_weights(path, net, params, qs, symmetric_weights=False)
    return params, qs


def run_twin(net, ckpt, sized_chw: np.ndarray):
    """The twin's forward: (result, yolo outputs, seconds)."""
    from yolo_quantization_tpu_torch.nn.graph import YoloSpec
    from yolo_quantization_tpu_torch.parity.ctwin import CTwin

    t0 = time.perf_counter()
    res = CTwin(net, ckpt).forward(sized_chw)
    seconds = time.perf_counter() - t0
    yolo = [tl.f32 for tl, s in zip(res.layers, net.specs) if isinstance(s, YoloSpec)]
    return res, yolo, seconds


def parity_engine(net, ckpt, in_scale, in_zp, dynamic: bool = False, device="cuda"):
    """The loaded checkpoint as the parity engine: ``parity_program``'s
    conversion, the input range the twin's (scale, zero point), every layer
    its own output."""
    from yolo_quantization_tpu_torch.infer.convert import convert
    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.models.darknet_weights import _range_from_scale_zp

    qs = {k: dict(v) for k, v in ckpt.quant_state.items()}
    lo, hi = _range_from_scale_zp(float(in_scale), int(in_zp))
    qs["input"] = {"min": np.float32(lo), "max": np.float32(hi)}
    program = convert(net, ckpt.params, qs, symmetric_weights=False, route_rescale=False)
    # the twin's exact input qp (convert re-nudges the range)
    program.in_scale, program.in_zp = float(in_scale), int(in_zp)
    return Engine(program, device=device, dynamic_input=dynamic, exact_leaky=True, fuse_pool=False)


def lsb_table(twin_res, outputs) -> dict:
    """Per layer the twin holds codes for: the engine's codes (int8 codes
    shifted back to uint8; a quant_stop conv's dequantized floats turned
    back into codes with its scale and zero point) against the twin's.
    |delta| > 128 is a wrap (C narrows mod 256, the engine saturates),
    counted apart from the rounding drift."""
    table = {}
    for i, (tl, y) in enumerate(zip(twin_res.layers, outputs)):
        if tl.u8 is None:
            continue
        y = np.asarray(y)[0].transpose(2, 0, 1)
        if y.dtype == np.int8:
            codes = y.astype(np.int64) + 128
        else:  # a quant_stop conv's dequant: (code - zp) * scale
            codes = np.rint(y.astype(np.float64) / float(tl.act_scale)).astype(np.int64) + tl.act_zp
        d = np.abs(codes - tl.u8.astype(np.int64)).ravel()
        wrap = d > 128
        dd = d[~wrap]
        table[i] = {"kind": tl.kind, "max": int(dd.max()) if dd.size else 0,
                    "mean": float(dd.mean()) if dd.size else 0.0,
                    "frac_gt1": float((dd > 1).mean()) if dd.size else 0.0, "wraps": int(wrap.sum())}
    return table


def quant_stop_report(twin_res, outputs) -> dict:
    """Max |engine - twin| of each quant_stop conv's dequantized floats."""
    out = {}
    for i, (tl, y) in enumerate(zip(twin_res.layers, outputs)):
        if tl.kind == "ConvSpec" and tl.f32 is not None:
            eng = np.asarray(y)[0].transpose(2, 0, 1)
            out[i] = float(np.abs(eng - tl.f32).max())
    return out


def engine_yolo(net, heads) -> list[np.ndarray]:
    """The engine's dequantized NHWC heads through the twin's yolo
    activations, so both detection sets come from one decode."""
    from yolo_quantization_tpu_torch.nn.graph import YoloSpec
    from yolo_quantization_tpu_torch.parity.ctwin import yolo_activations

    specs = [s for s in net.specs if isinstance(s, YoloSpec)]
    out = []
    for h, spec in zip(heads, specs):
        chw = np.asarray(h)[0].transpose(2, 0, 1)
        out.append(yolo_activations(spec, chw.reshape(-1), *chw.shape[1:]))
    return out


def f1_counts(dets: np.ndarray, truths: np.ndarray, thresholds=None) -> list[dict]:
    from yolo_quantization_tpu_torch.eval.f1 import THRESHOLDS, f1_rows

    return [{"thresh": r.thresh, "tp": r.tp, "tp_fp": r.tp_fp, "tp_fn": r.tp_fn}
            for r in f1_rows([(dets[:, :4], dets[:, 4], truths)], thresholds or THRESHOLDS)]


def tier2_verdict(lsb: dict, twin_rows: list[dict], eng_rows: list[dict]) -> bool:
    if not lsb or max(v["max"] for v in lsb.values()) > MAX_LSB:
        return False
    for t, e in zip(twin_rows, eng_rows):
        if (e["tp"], e["tp_fn"]) != (t["tp"], t["tp_fn"]):
            return False
        if abs(e["tp_fp"] - t["tp_fp"]) > TP_FP_REL * max(t["tp_fp"], 1):
            return False
    return True


def read_shim_dumps(dumpdir: str):
    """The shim's dumps: the letterboxed input, input codes, every layer's
    u8 / f32 output and the detections."""
    meta = []
    with open(os.path.join(dumpdir, "meta.txt")) as f:
        for line in f:
            meta.append(int(line.split()[0]))
    sized = np.fromfile(os.path.join(dumpdir, "sized.bin"), np.float32)
    input_u8 = np.fromfile(os.path.join(dumpdir, "input_u8.bin"), np.uint8)
    u8, f32 = {}, {}
    for idx in meta:
        pu8 = os.path.join(dumpdir, f"layer{idx:02d}_u8.bin")
        pf32 = os.path.join(dumpdir, f"layer{idx:02d}_f32.bin")
        if os.path.exists(pu8):
            u8[idx] = np.fromfile(pu8, np.uint8)
        if os.path.exists(pf32):
            f32[idx] = np.fromfile(pf32, np.float32)
    with open(os.path.join(dumpdir, "detections.txt")) as f:
        dets = [[float(v) for v in line.split()] for line in f]
    dets = np.asarray(dets, np.float32) if dets else np.zeros((0, 10), np.float32)
    return sized, input_u8, u8, f32, dets


def run_shim(ref: str, workdir: str, wpath: str, image: str):
    """The compiled reference (``native/parity_shim.c`` linked against its
    objects, built under build/torch_ref) on the image: its dumps."""
    from yolo_quantization_tpu_torch.tools.crossf1 import build_reference, write_cfg

    dumpdir = os.path.join(workdir, "dumps")
    os.makedirs(dumpdir, exist_ok=True)
    subprocess.run([build_reference(ref), write_cfg(workdir, ref), wpath, image, dumpdir,
                    str(DECODE_THRESH), "none"], check=True, capture_output=True, text=True)
    return read_shim_dumps(dumpdir)


def tier1(dumps, twin_res, twin_dets) -> dict:
    """The twin against the compiled binary, both on the binary's
    letterboxed input: input codes, every u8 layer byte for byte, the
    quant_stop floats bit for bit, the detections within 1e-4."""
    _, input_u8, u8_ref, f32_ref, dets_ref = dumps
    pairs = [(i, tl) for i, tl in enumerate(twin_res.layers)]
    exact = {
        "input_u8": bool((twin_res.input_u8.ravel() == input_u8).all()),
        "u8_mismatches": {i: int((tl.u8.ravel() != u8_ref[i]).sum()) for i, tl in pairs
                          if i in u8_ref and tl.u8 is not None and (tl.u8.ravel() != u8_ref[i]).any()},
        "u8_layers_checked": sum(1 for i, tl in pairs if i in u8_ref and tl.u8 is not None),
        "f32_max_abs": max([float(np.abs(tl.f32.ravel() - f32_ref[i]).max()) for i, tl in pairs
                            if i in f32_ref and tl.f32 is not None], default=0.0),
        "det_count_match": len(twin_dets) == len(dets_ref),
    }
    if exact["det_count_match"] and len(twin_dets):
        exact["det_max_abs"] = float(np.abs(twin_dets - dets_ref).max())
    exact["ok"] = bool(exact["input_u8"] and not exact["u8_mismatches"] and exact["f32_max_abs"] == 0.0
                       and exact["det_count_match"] and exact.get("det_max_abs", 0.0) < 1e-4)
    return exact


def check(workdir: str, dynamic: bool = False, seed: int = 0, image: str | None = None,
          device="cuda", thresh: float = 0.25) -> dict:
    """The whole harness on one image; returns the verdict (``ok``)."""
    from yolo_quantization_tpu_torch.data.image import letterbox, load_image_rgb
    from yolo_quantization_tpu_torch.data.voc import label_path_for, read_boxes
    from yolo_quantization_tpu_torch.models.darknet_weights import load_darknet_weights
    from yolo_quantization_tpu_torch.parity.ctwin import yolo_detections_c
    from yolo_quantization_tpu_torch.tools.crossf1 import flagship_net, reference_dir, render_dataset

    dev = resolve_device(device, "parity_check")
    os.makedirs(workdir, exist_ok=True)
    net = flagship_net()
    if image is None:
        list_file = render_dataset(os.path.join(workdir, f"image_{seed}"), 1, seed=1000 + seed)
        with open(list_file) as f:
            image = f.read().split()[0]
    labels = label_path_for(image)
    truths = read_boxes(labels) if os.path.exists(labels) else np.zeros((0, 5), np.float32)
    im = load_image_rgb(image)
    im_h, im_w = im.shape[:2]
    sized_hwc = letterbox(im, net.width, net.height)
    sized_chw = np.ascontiguousarray(sized_hwc.transpose(2, 0, 1))
    wpath = os.path.join(workdir, f"parity_{seed}.weights")
    export_checkpoint(net, sized_hwc, wpath, seed, dev)
    ckpt = load_darknet_weights(wpath, net)
    ref = reference_dir()
    dumps = None
    if ref is not None:
        # the twin and the engine take the reference's letterboxed input, so
        # the layers compare arithmetic, not resize implementations
        dumps = run_shim(ref, workdir, wpath, image)
        letterbox_diff = float(np.abs(sized_chw.ravel() - dumps[0]).max())
        sized_chw = dumps[0].reshape(net.channels, net.height, net.width)
        sized_hwc = np.ascontiguousarray(sized_chw.transpose(1, 2, 0))

    twin_res, twin_yolo, twin_s = run_twin(net, ckpt, sized_chw)
    engine = parity_engine(net, ckpt, twin_res.in_scale, twin_res.in_zp, dynamic, dev)
    heads, outputs = engine.raw_heads(sized_hwc[None], return_outputs=True)

    lsb = lsb_table(twin_res, outputs)
    twin_dets = yolo_detections_c(net, twin_yolo, im_w, im_h, DECODE_THRESH)
    eng_dets = yolo_detections_c(net, engine_yolo(net, heads), im_w, im_h, DECODE_THRESH)
    twin_rows, eng_rows = f1_counts(twin_dets, truths, (thresh,)), f1_counts(eng_dets, truths, (thresh,))
    report = {
        "image": os.path.basename(image), "seed": seed, "dynamic_input": bool(dynamic),
        "device": str(dev), "twin_seconds": round(twin_s, 3),
        "twin_stepwise_convs": twin_res.stepwise_convs,
        "in_scale": float(twin_res.in_scale), "in_zp": int(twin_res.in_zp),
        "tier2_engine_lsb": lsb,
        "tier2_max_lsb": max(v["max"] for v in lsb.values()),
        "tier2_wraps": sum(v["wraps"] for v in lsb.values()),
        "tier2_quant_stop_max_abs": quant_stop_report(twin_res, outputs),
        "tier2_det_counts": {"twin": len(twin_dets), "engine": len(eng_dets)},
        "tier2_f1_counts": {"twin": twin_rows[0], "engine": eng_rows[0]},
        "f1_sweep": {"twin": f1_counts(twin_dets, truths), "engine": f1_counts(eng_dets, truths)},
    }
    report["tier2_ok"] = tier2_verdict(lsb, twin_rows, eng_rows)
    if dumps is None:
        report["tier1"] = "not run: reference sources absent"
        report["ok"] = report["tier2_ok"]
    else:
        report["tier1"] = tier1(dumps, twin_res, twin_dets) | {"letterbox_max_diff": letterbox_diff}
        report["ok"] = bool(report["tier2_ok"] and report["tier1"]["ok"])
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dynamic", action="store_true",
                    help="the engine quantizes the input per image (dynamic_input) instead of "
                         "taking the twin's (scale, zero point)")
    ap.add_argument("--seed", type=int, default=0, help="weights and synthetic image seed")
    ap.add_argument("--thresh", type=float, default=0.25, help="the tier-2 counts' threshold")
    ap.add_argument("--image", help="an image instead of the seeded synthetic one")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "torch_parity"))
    args = ap.parse_args(argv)
    report = check(args.out, args.dynamic, args.seed, args.image, args.device, args.thresh)
    print(json.dumps(report, default=str))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
