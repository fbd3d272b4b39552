"""Float32 conv weight gradients on one GPU: cuDNN against ``weight_grad``.

    python -m yolo_quantization_tpu_torch.tools.weight_grad_check

For every distinct conv shape of a float training forward of yolov3-tiny
(416x416, batch 16) and yolov3 (416x416, batch 8), on seeded random inputs
and cotangents, times three ways to the weight gradient (CUDA events over
10 calls) and holds each against float64:

  cudnn_default        cuDNN's default algorithm (adds partial sums in no
                       fixed order)
  cudnn_deterministic  cuDNN restricted to deterministic algorithms
  weight_grad          ``nn/layers.py::weight_grad``, what training uses

Each entry is (ms, max |err| over the largest |gradient|, share within
``tools/qat_check.py``'s gradient rule: rtol 1e-3, atol 1e-5 scaled by
max(1, largest |gradient|)).  Prints one JSON line per shape and one line
of totals per model.  It measures and changes nothing.
"""

from __future__ import annotations

import json
import sys

import torch

from yolo_quantization_tpu_torch.models import zoo
from yolo_quantization_tpu_torch.nn import graph as G
from yolo_quantization_tpu_torch.nn import layers as L
from yolo_quantization_tpu_torch.tools.kernel_timings import card_identity
from yolo_quantization_tpu_torch.tools.qat_check import MODES

ITERS = 10


def conv_shapes(net, batch: int) -> list[tuple]:
    """(x shape, w shape, stride, pad) of each distinct conv in a forward."""
    seen = []
    conv2d = L.conv2d

    def record(x, w, stride, pad, compute_dtype=None):
        key = (tuple(x.shape), tuple(w.shape), stride, pad)
        if key not in seen:
            seen.append(key)
        return conv2d(x, w, stride, pad, compute_dtype)

    params = G.params_to_torch(G.init_params_numpy(0, net), "cuda")
    L.conv2d = record
    try:
        with torch.no_grad():
            G.forward(net, params, torch.rand(batch, net.height, net.width, 3, device="cuda"),
                      MODES["float-train"])
    finally:
        L.conv2d = conv2d
    return seen


def _time(fn) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def compare(shape, gen: torch.Generator) -> dict:
    xs, ws, stride, pad = shape
    k = ws[0]
    x = torch.randn(xs, device="cuda", generator=gen)
    w = torch.randn(ws, device="cuda", generator=gen) * 0.1
    with L.float32_convs():
        y = L.conv2d(x, w, stride, pad)
    g = torch.randn(y.shape, device="cuda", generator=gen)
    xc, wc, gc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2)

    def cudnn(deterministic: bool, dtype=torch.float32):
        def run():
            with L.float32_convs():
                torch.backends.cudnn.deterministic = deterministic
                gw = torch.ops.aten.convolution_backward(
                    gc.to(dtype), xc.to(dtype), wc.to(dtype), None, [stride] * 2, [pad] * 2, [1, 1],
                    False, [0, 0], 1, [False, True, False])[1]
            return gw.permute(2, 3, 1, 0)
        return run

    def ours():
        with L.float32_convs():
            return L.weight_grad(x, g, k, stride, pad)

    ref = cudnn(True, torch.float64)()
    scale = float(ref.abs().max())
    row = {"x": list(xs), "w": list(ws), "stride": stride}
    for name, fn in (("cudnn_default", cudnn(False)), ("cudnn_deterministic", cudnn(True)),
                     ("weight_grad", ours)):
        got = fn().double()
        err = float((got - ref).abs().max()) / scale
        close = float(torch.isclose(got, ref, rtol=1e-3, atol=1e-5 * max(1.0, scale)).double().mean())
        row[name] = (_time(fn), err, close)
    return row


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("weight_grad_check: needs a CUDA GPU")
    if argv:
        raise SystemExit(f"weight_grad_check: unknown arguments {argv}")
    card = card_identity()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for model, net, batch in (("yolov3-tiny", zoo.yolov3_tiny(classes=5), 16),
                              ("yolov3", zoo.yolov3(classes=80), 8)):
        rows = [compare(s, gen) for s in conv_shapes(net, batch)]
        for row in rows:
            print(json.dumps({"model": model, **row}), flush=True)
        names = ("cudnn_default", "cudnn_deterministic", "weight_grad")
        print(json.dumps({"model": model, "batch": batch, "shapes": len(rows), "card": card,
                          "total_ms": {n: sum(r[n][0] for r in rows) for n in names},
                          "worst_err": {n: max(r[n][1] for r in rows) for n in names},
                          "worst_share": {n: min(r[n][2] for r in rows) for n in names}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
