"""Benchmark: uint8 integer inference throughput and latency on one GPU.

The counterpart of ``bench.py`` and ``scripts/bench_v3.py``:

    python -m yolo_quantization_tpu_torch.tools.bench [--v3] [--batches 128,256]
        [--more-batches 1,16,64] [--size 416] [--chain 20] [--device cuda|cpu]
    python -m yolo_quantization_tpu_torch.cli bench [the same options]

Times the flagship program (yolov3-tiny, 416, 5 classes, relu6, seeded
weights, synthetic ranges), or with ``--v3`` full yolov3 (80 classes, batch
64 by default), as forward (K1 on every conv, the integer shortcut kernel
on yolov3's), head decode and top-k 64 on inputs already on the card:

- ``device_ms_per_batch``: the kernels' own device time summed over
  ``--chain`` (20) back-to-back forwards under torch.profiler, after a
  warm-up, per forward.  The gaps between launches are not in it: where the
  host cannot launch as fast as the card runs (small batches), the card
  waits, and the host chain below is slower than this;
- ``value`` (host-visible images/s): a chain of ``--chain`` forwards ended
  by one scalar fetch, timed on the host clock (the faster of two); the best
  of ``--batches``;
- ``p50_latency_batch1_ms``: host clock around one batch-1 forward ended by
  its scalar fetch, median of ``--chain``; ``device_latency_batch1_ms`` the
  kernels' summed time of one batch-1 forward, as above;
- ``mfu_int8``: 2 x conv MACs (from the conv geometry, as ``bench.py``
  counts them: 2.724 GMAC an image for the flagship, 32.93 for yolov3) x
  device images/s (from the kernel time) over 1,979 int8 TOP/s (H100 SXM,
  dense, 700 W);
- ``vs_baseline`` against the reference's 2.94 images/s (one 416x416 image
  in 0.34 s on its uint8 CPU path, ``BASELINE.md``).

Prints one JSON line with ``bench.py``'s field names.  Runs on the GPU
unless ``--device cpu`` is given (the tests' small runs), and raises where
there is no GPU; a CPU run reports no device metric (those fields are
null).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from yolo_quantization_tpu_torch.infer.float_engine import resolve_device

BASELINE_IMG_PER_SEC = 1.0 / 0.34  # the reference's uint8 CPU path, BASELINE.md
CHAIN = 20  # forwards per timed run
MAX_DET = 64


def conv_macs_per_image(program) -> float:
    """Conv MACs of one image from the graph geometry (quantized and float
    convs), as ``bench.py::conv_macs_per_image`` counts them."""
    from yolo_quantization_tpu_torch.nn.graph import ConvSpec

    net = program.net
    shapes = net.shapes()
    macs = 0
    for i, s in enumerate(net.specs):
        if not isinstance(s, ConvSpec):
            continue
        ih, iw, ic = shapes[i - 1] if i > 0 else (net.height, net.width, net.channels)
        oh, ow, oc = shapes[i]
        macs += oh * ow * oc * s.size * s.size * ic
    return float(macs)


def bench_program(v3: bool = False, size: int = 416):
    from yolo_quantization_tpu_torch.models.presets import flagship_program, v3_program

    return v3_program(classes=80, size=size, seed=0) if v3 else flagship_program(size=size)


def make_run(program, device):
    """run(x) -> (boxes, obj, cls, sum(obj)): the forward, decode and top-k
    of ``Engine.predict`` on a batch already on ``device``."""
    from yolo_quantization_tpu_torch.eval import detect
    from yolo_quantization_tpu_torch.infer.engine import build_forward, device_arrays

    fwd = build_forward(program)
    arrays = device_arrays(program, device)
    net = program.net

    def run(x):
        with torch.inference_mode():
            boxes, obj, cls = detect.top_k_detections(
                *detect.decode_all_heads(fwd(arrays, x), net), MAX_DET)
            return boxes, obj, cls, obj.sum()

    return run


def device_batch(batch: int, size: int, device, seed: int = 0) -> torch.Tensor:
    """Uniform [0, 1) float32 NHWC images made on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((batch, size, size, 3), generator=g, device=device, dtype=torch.float32)


def device_ms(run, x, iters: int = CHAIN) -> float:
    """The kernels' summed device time of one forward, over ``iters``
    back-to-back forwards under torch.profiler: launch gaps excluded."""
    from yolo_quantization_tpu_torch.tools.profile_engine import kernel_time

    return kernel_time(lambda: run(x), iters)[0]


def chain_s(run, x, chain: int = CHAIN) -> float:
    """Host seconds for ``chain`` forwards ended by one scalar fetch."""
    t0 = time.perf_counter()
    out = None
    for _ in range(chain):
        out = run(x)
    float(out[3])
    return time.perf_counter() - t0


def latency_batch1(run, x, iters: int = CHAIN) -> float:
    """Host ms of one batch-1 forward ended by its scalar fetch, median."""
    host = []
    for _ in range(iters):
        t0 = time.perf_counter()
        float(run(x)[3])
        host.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(host)


def card_name(device) -> str:
    if device.type != "cuda":
        return "cpu"
    from yolo_quantization_tpu_torch.tools.kernel_timings import card_identity

    return card_identity()


def bench(v3: bool = False, batches=None, more_batches=None, size: int = 416, device="cuda",
          chain: int = CHAIN) -> dict:
    """The benchmark's result dict (see the module docstring)."""
    from yolo_quantization_tpu_torch.tools.kernel_timings import PEAK_INT8_OPS

    dev = resolve_device(device, "bench")
    cuda = dev.type == "cuda"
    batches = tuple(batches or ((64,) if v3 else (128, 256)))
    more_batches = tuple(more_batches if more_batches is not None else (() if v3 else (1, 16, 64)))
    program = bench_program(v3, size)
    run = make_run(program, dev)
    host_ips, dev_ms = {}, {}
    for batch in sorted(set(batches) | set(more_batches)):
        x = device_batch(batch, size, dev)
        float(run(x)[3])  # warm: first launches, the kernels' attributes
        if cuda:
            dev_ms[batch] = device_ms(run, x, chain)
        host_ips[batch] = chain * batch / min(chain_s(run, x, chain) for _ in range(2))
        del x
    best = max(batches, key=lambda b: host_ips[b])
    x1 = device_batch(1, size, dev)
    p50 = latency_batch1(run, x1, chain)
    dev_lat = device_ms(run, x1, chain) if cuda else None
    macs = conv_macs_per_image(program)
    dev_ips = best / dev_ms[best] * 1e3 if cuda else None
    name = "yolov3-full" if v3 else "yolov3-tiny"
    result = {
        "metric": f"{name} uint8 {size}x{size} inference throughput (1 {'GPU' if cuda else 'CPU'})",
        "value": round(host_ips[best], 1),
        "unit": "images/sec",
        "vs_baseline": round(host_ips[best] / BASELINE_IMG_PER_SEC, 1),
        "batch": best,
        "device_images_per_sec": round(dev_ips, 1) if cuda else None,
        "device_ms_per_batch": round(dev_ms[best], 3) if cuda else None,
        "mfu_int8": round(2.0 * macs * dev_ips / PEAK_INT8_OPS, 4) if cuda else None,
        "conv_gmacs_per_image": round(macs / 1e9, 3),
        "p50_latency_batch1_ms": round(p50, 3),
        "device_latency_batch1_ms": round(dev_lat, 3) if cuda else None,
        "images_per_sec_by_batch": {str(k): round(v, 1) for k, v in sorted(host_ips.items())},
        "device_images_per_sec_by_batch": ({str(k): round(k / v * 1e3, 1) for k, v in sorted(dev_ms.items())}
                                           if cuda else None),
        "conv_path": "k1",
        "device": card_name(dev),
    }
    if v3:
        result["quantized_shortcuts"] = True
    return result


def add_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--v3", action="store_true", help="full yolov3 (80 classes), batch 64 by default")
    ap.add_argument("--batches", help="comma-separated batches that decide `value` (default 128,256; "
                    "64 with --v3)")
    ap.add_argument("--more-batches", help="further batches for images_per_sec_by_batch (default "
                    "1,16,64; none with --v3)")
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--chain", type=int, default=CHAIN,
                    help="forwards per timed run (profiled device time, host chain, batch-1 latency)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _ints(text):
    return None if text is None else tuple(int(v) for v in text.split(",") if v)


def run_args(args) -> dict:
    result = bench(args.v3, _ints(args.batches), _ints(args.more_batches), args.size, args.device,
                   chain=args.chain)
    print(json.dumps(result), flush=True)
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_arguments(ap)
    run_args(ap.parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
