"""The program's own profiler ranges in the traced stretch: device time,
launches and the card's idle time attributed to each range name, and the
per-layer readings taken from them.

The program opens a named range around each stage of a request
(``infer/engine.py``: ``engine.predict_async``, ``engine.input``,
``engine.quantize``, ``engine.layers``, ``engine.decode``, ``engine.topk``,
``engine.resolve``, ``engine.wait``, ``engine.copy``); the harness opens
``portbench.submit`` and ``portbench.resolve``.  A device operation
(kernel, copy, memset) belongs to the runtime or driver call that launched
it, matched by ``args.correlation``, and so to every range that encloses
that call on the call's thread.  Only the readings and the report at the
end know the program's names.

``trace.py`` does not call this module yet: its ``traced`` profiles the
thread it starts on (a range opened on a thread started under that
profiler is left out of the trace), and its ``reduce`` returns no
``spans``.  Run it as a tool, from the root of a checkout on the card:

    python3 portbench/spans.py --workload <cell> --seed <n>

builds and warms the cell as a run does, then profiles its traced stretch
(``trace_requests`` requests) twice, first over every thread (``traced``),
then as ``trace.traced`` does, and prints one JSON line: each stretch's
seconds a request and idle share, the readings, the share of device time
under ``engine.*`` ranges, and each range's totals.  One process profiles
every thread once: in a second such profile of one process, the runtime
calls of a thread started under it can carry another thread's id.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import trace  # noqa: E402

LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaGraphLaunch)")
CALLS = {"cuda_runtime", "cuda_driver"}
PROGRAM = "engine."


def traced(fn):
    """``trace.traced`` over every thread of the process: (``fn()``'s
    result, the trace's events)."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    every = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, experimental_config=every) as prof:
        with record_function(trace.STRETCH):
            result = fn()
    return result, _events(prof)


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _length(merged: list) -> float:
    return sum(b - a for a, b in merged)


def _overlap(x: list, y: list) -> float:
    """Length of the intersection of two merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            total += b - a
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def _enclosed(merged: list, ts: np.ndarray) -> np.ndarray:
    """Which of the times ``ts`` fall inside the merged intervals."""
    if not merged or not ts.size:
        return np.zeros(ts.shape, bool)
    starts = np.array([a for a, _ in merged])
    ends = np.array([b for _, b in merged])
    k = np.searchsorted(starts, ts, side="right") - 1
    return (k >= 0) & (ts <= ends[np.maximum(k, 0)])


def reduce(events: list) -> dict:
    """{range name: {"count", "host_s": [each duration], "device_s",
    "launches", "idle_s"}} over every user range in the stretch but the
    stretch itself.  ``device_s`` sums the device operations whose launching
    call lies in a range of that name on the call's thread; ``launches``
    counts the kernel and graph launches there (a graph is one);
    ``idle_s`` is the time the card ran nothing within the union of the
    name's ranges, over every thread."""
    found = [e for e in events if e.get("ph") == "X" and e.get("name") == trace.STRETCH
             and e.get("cat") == "user_annotation"]
    if not found:
        raise ValueError("the trace holds no stretch range")
    t0 = float(found[0]["ts"])
    t1 = t0 + float(found[0]["dur"])
    ranges: dict = {}       # name -> [(start, end, tid)]
    device: dict = {}       # correlation -> seconds of device work it launched
    busy, calls = [], []    # calls: (ts, tid, correlation, a launch)
    for e in events:
        if e.get("ph") != "X":
            continue
        a, d, cat = float(e["ts"]), float(e.get("dur", 0.0)), e.get("cat")
        if cat == "user_annotation" and e.get("name") != trace.STRETCH and a >= t0 and a + d <= t1:
            ranges.setdefault(e["name"], []).append((a, a + d, e.get("tid")))
        elif cat in trace.DEVICE and a >= t0 and a + d <= t1:
            busy.append((a, a + d))
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                device[c] = device.get(c, 0.0) + d
        elif cat in CALLS:
            c = (e.get("args") or {}).get("correlation")
            calls.append((a, e.get("tid"), c, bool(LAUNCH.match(e.get("name", "")))))
    busy = trace._merged(busy)
    by_tid: dict = {}
    for ts, tid, c, launch in calls:
        by_tid.setdefault(tid, []).append((ts, device.get(c, 0.0), launch))
    out = {}
    for name, spans in ranges.items():
        device_us, launches = 0.0, 0
        for tid, rows in by_tid.items():
            mine = trace._merged([(a, b) for a, b, t in spans if t == tid])
            if not mine:
                continue
            ts = np.array([r[0] for r in rows])
            inside = _enclosed(mine, ts)
            device_us += float(np.array([r[1] for r in rows])[inside].sum())
            launches += int(np.array([r[2] for r in rows])[inside].sum())
        union = trace._merged([(a, b) for a, b, _ in spans])
        out[name] = {"count": len(spans), "host_s": [(b - a) * 1e-6 for a, b, _ in spans],
                     "device_s": device_us * 1e-6, "launches": int(launches),
                     "idle_s": (_length(union) - _overlap(union, busy)) * 1e-6}
    return out


# the readings, each from a summary as the harness gives its readers
# (``summary["trace"]`` with ``spans``); None where the program opened no
# ``engine.*`` range


def _spans(summary):
    s = summary["trace"].get("spans") or {}
    return s if any(name.startswith(PROGRAM) for name in s) else None


def quantize_device_us_per_image(summary):
    """Glue ops: device time of ``engine.quantize`` (the input to int8
    codes), in us an image."""
    s, t = _spans(summary), summary["trace"]
    if s is None or not t["images"]:
        return None
    return s.get("engine.quantize", {}).get("device_s", 0.0) / t["images"] * 1e6


def decode_device_us_per_image(summary):
    """Glue ops: device time of ``engine.decode`` and ``engine.topk``, in
    us an image."""
    s, t = _spans(summary), summary["trace"]
    if s is None or not t["images"]:
        return None
    return sum(s.get(n, {}).get("device_s", 0.0)
               for n in ("engine.decode", "engine.topk")) / t["images"] * 1e6


def dispatch_idle_share(summary):
    """Engine: the card's idle time inside ``engine.predict_async`` (the
    enqueue), as a share (%) of the stretch."""
    s, t = _spans(summary), summary["trace"]
    if s is None or "engine.predict_async" not in s or t["window_s"] <= 0:
        return None
    return s["engine.predict_async"]["idle_s"] / t["window_s"] * 100.0


def launches_per_request(summary):
    """Engine: kernel and graph launches inside ``engine.predict_async``,
    a request."""
    s, t = _spans(summary), summary["trace"]
    if s is None or "engine.predict_async" not in s or not t["forwards"]:
        return None
    return s["engine.predict_async"]["launches"] / t["forwards"]


def resolve_copy_ms(summary):
    """Engine: the median host time of ``engine.copy`` (the answer to the
    host), in ms."""
    s = _spans(summary)
    if s is None or not s.get("engine.copy", {}).get("host_s"):
        return None
    return statistics.median(s["engine.copy"]["host_s"]) * 1e3


READINGS = (quantize_device_us_per_image, decode_device_us_per_image, dispatch_idle_share,
            launches_per_request, resolve_copy_ms)
# the accepted readers that read the trace alone, reported beside them
TRACE_READERS = ("device_idle_share", "glue_device_us_per_image", "qconv_roofline",
                 "shortcut_roofline")


def stretch(cell, profiler, requests: int | None = None) -> dict:
    """The summary of one traced stretch of a built ``harness.Cell``, as
    ``harness.run_cell`` runs it (the cell's ``trace_requests`` unless
    ``requests`` says), under ``profiler`` (``trace.traced`` or ``traced``)."""
    from torch.profiler import record_function

    from portbench import harness

    k = requests or int(cell.cell["trace_requests"])

    def traced_submit(frames):
        with record_function("portbench.submit"):
            resolve = cell.submit(frames)

        def traced_resolve():
            with record_function("portbench.resolve"):
                return resolve()
        return traced_resolve

    _, events = profiler(lambda: cell.send(lambda now, sent: sent >= k, harness.nothing,
                                           traced_submit))
    reduced = trace.reduce(events)
    reduced.update(forwards=k, images=k * cell.batch, spans=reduce(events))
    return {"net": cell.net, "batch": cell.batch, "trace": reduced}


def report(summary) -> dict:
    """The line's numbers for one stretch."""
    from portbench import harness

    t = summary["trace"]
    s = t["spans"]
    row = {"window_s": t["window_s"], "s_per_request": t["window_s"] / t["forwards"]}
    for name in TRACE_READERS:
        row[name] = harness.reader(name)(summary)
    for fn in READINGS:
        row[fn.__name__] = fn(summary)
    total = sum(sec for _, sec, _ in t["device_ops"])
    under = sum(v["device_s"] for n, v in s.items() if n in ("engine.predict_async", "engine.resolve"))
    row["engine_device_share"] = under / total * 100.0 if total else None
    row["spans"] = {n: {"count": v["count"], "host_ms_median": statistics.median(v["host_s"]) * 1e3,
                        "device_s": v["device_s"], "launches": v["launches"], "idle_s": v["idle_s"]}
                    for n, v in sorted(s.items())}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell(ROOT, args.workload, args.seed, "cuda")
    line = {"workload": args.workload, "seed": args.seed, "torch": torch.__version__,
            "card": torch.cuda.get_device_name(0)}
    for label, profiler in (("every_thread", traced), ("this_thread", trace.traced)):
        line[label] = report(stretch(cell, profiler))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
