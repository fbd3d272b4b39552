"""Serving benchmark: latency percentiles against an offered load.

The counterpart of ``scripts/bench_serving.py``:

    python -m yolo_quantization_tpu_torch.tools.bench_serving [--rates 50,200,800,3000]
        [--duration 8] [--buckets 1,4,16] [--uint8] [--size 416] [--device cuda|cpu]

Drives ``infer/serving.py::Server`` over the flagship program's ``Engine``
with open-loop Poisson arrivals at each offered rate.  A request's latency
runs from ``submit`` to the moment its future resolves: host letterbox,
batching delay, the host-to-device copy of the batch, the device run, top-k
copy-back and NMS.  It is stamped by a done-callback at completion, not
when the load loop later reads the future (reading them one after another
at the end would credit early completions with the rest of the loop's
time).  Images of three sizes (480x640, 720x960, 416x416) exercise the
letterbox; each server's buckets are warmed first.  Per rate: one JSON line
(p50/p90/p99 ms, the achieved rate, batches, average batch fill, the bucket
histogram), then a markdown table.  ``--rates auto`` picks four rates from
``Engine.predict``'s measured batch-1 and batch-16 rates
(``suggest_rates``), so the ladder fills.  Runs on the GPU unless
``--device cpu`` is given, and raises where there is no GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

from yolo_quantization_tpu_torch.infer.float_engine import resolve_device

SIZES = ((480, 640), (720, 960), (416, 416))


def request_images(seed: int = 1) -> list[np.ndarray]:
    """Seeded float32 [0, 1) images of ``SIZES``."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (h, w, 3)).astype(np.float32) for h, w in SIZES]


def run_load(server, images, rate_hz: float, duration_s: float, seed: int = 0):
    """Open-loop Poisson arrivals at ``rate_hz`` for ``duration_s``; returns
    (latencies in seconds, requests sent).  Each latency is stamped by the
    future's done-callback, on the thread that completes it."""
    rng = np.random.default_rng(seed)
    lat: list[float] = []
    lock = threading.Lock()
    futures = []
    t_end = time.monotonic() + duration_s
    next_t = time.monotonic()
    i = 0

    def stamp(t0):
        def cb(_fut):
            dt = time.monotonic() - t0
            with lock:
                lat.append(dt)
        return cb

    while time.monotonic() < t_end:
        now = time.monotonic()
        if now < next_t:
            time.sleep(min(next_t - now, 0.001))
            continue
        t0 = time.monotonic()
        fut = server.submit(images[i % len(images)], thresh=0.25)
        fut.add_done_callback(stamp(t0))
        futures.append(fut)
        i += 1
        next_t += rng.exponential(1.0 / rate_hz)
    for fut in futures:
        fut.result(timeout=600)
    with lock:
        return np.asarray(lat), i


def warm(server, images, buckets) -> None:
    """One singleton, then a burst per larger bucket."""
    server.submit(images[0]).result(timeout=600)
    for b in buckets[1:]:
        futs = [server.submit(images[i % len(images)]) for i in range(b)]
        for f in futs:
            f.result(timeout=600)


def serve_rates(engine, rates, duration_s: float, buckets=(1, 4, 16), uint8: bool = False,
                images=None, log=print) -> list[dict]:
    """One fresh ``Server`` per offered rate; returns a row per rate."""
    from yolo_quantization_tpu_torch.infer.serving import Server

    images = images if images is not None else request_images()
    rows = []
    for rate in rates:
        server = Server(engine, batch_size=tuple(buckets), max_delay_ms=5.0, uint8_io=uint8)
        try:
            warm(server, images, tuple(buckets))
            server.stats.update(batches=0, images=0, batch_fill_sum=0.0, bucket_hist={})
            lat, n = run_load(server, images, rate, duration_s)
            stats = dict(server.stats)
        finally:
            server.close()
        row = {
            "offered_rate_hz": round(float(rate), 1),
            "completed": int(n),
            "achieved_rate_hz": round(n / duration_s, 1),
            "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
            "p90_ms": round(float(np.percentile(lat, 90)) * 1e3, 3),
            "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
            "batches": stats["batches"],
            "avg_batch_fill": round(stats["batch_fill_sum"] / max(stats["batches"], 1), 3),
            "bucket_hist": {str(k): v for k, v in sorted(stats["bucket_hist"].items())},
            "uint8_io": bool(uint8),
        }
        rows.append(row)
        log(json.dumps(row))
    return rows


def predict_rates(engine, images, reps: int = 10) -> tuple[float, float]:
    """``Engine.predict``'s images/s at batch 1 and 16 on letterboxed
    images (host input in, top-k out), each the best of ``reps`` calls."""
    from yolo_quantization_tpu_torch.utils import native

    net = engine.program.net
    boxed = [native.letterbox(im, net.width, net.height) for im in images]
    out = []
    for b in (1, 16):
        x = np.stack([boxed[i % len(boxed)] for i in range(b)])
        engine.predict(x)
        best = min(_timed(engine.predict, x) for _ in range(reps))
        out.append(b / best)
    return out[0], out[1]


def _timed(fn, x) -> float:
    t0 = time.perf_counter()
    fn(x)
    return time.perf_counter() - t0


def suggest_rates(r1: float, r16: float) -> list[float]:
    """Four offered rates from predict's batch-1 and batch-16 rates: a
    quarter and half of the batch-1 rate (singletons and the 4 bucket), the
    batch-1 rate (4 and 16) and half as much again, capped at half the
    batch-16 rate (the 16 bucket full).  The server's host work (letterbox
    of each request, NMS) keeps its capacity near the batch-1 rate, well
    under the batch-16 one."""
    return [0.25 * r1, 0.5 * r1, r1, min(1.5 * r1, 0.5 * r16)]


def table(rows: list[dict]) -> str:
    lines = ["| offered req/s | achieved | p50 ms | p90 ms | p99 ms | batch fill | buckets |",
             "|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r['offered_rate_hz']} | {r['achieved_rate_hz']} | {r['p50_ms']} | "
                     f"{r['p90_ms']} | {r['p99_ms']} | {r['avg_batch_fill']} | {r['bucket_hist']} |")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rates", default="50,200,800,3000", help="comma-separated req/s, or auto")
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--buckets", default="1,4,16", help="batch bucket ladder")
    ap.add_argument("--uint8", action="store_true", help="stage frames as uint8 codes")
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from yolo_quantization_tpu_torch.infer.engine import Engine
    from yolo_quantization_tpu_torch.models.presets import flagship_program
    from yolo_quantization_tpu_torch.tools.bench import card_name

    dev = resolve_device(args.device, "bench_serving")
    engine = Engine(flagship_program(size=args.size), max_det=64, device=dev)
    images = request_images()
    if args.rates == "auto":
        r1, r16 = predict_rates(engine, images)
        rates = suggest_rates(r1, r16)
        print(json.dumps({"predict_images_per_sec": {"1": round(r1, 1), "16": round(r16, 1)},
                          "rates": [round(r, 1) for r in rates]}), flush=True)
    else:
        rates = [float(r) for r in args.rates.split(",")]
    buckets = tuple(int(b) for b in args.buckets.split(","))
    rows = serve_rates(engine, rates, args.duration, buckets, args.uint8, images,
                       log=lambda m: print(m, flush=True))
    print(f"\n{card_name(dev)}\n" + table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
