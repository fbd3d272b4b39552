"""The traced stretch: ``torch.profiler`` over a fixed number of requests,
reduced to what the per-layer metrics and the breakdown read.

The trace is the profiler's Chrome trace: device activity (kernels, copies,
memsets) and host activity (operators, CUDA runtime calls, the harness's
own ranges) on one clock, in microseconds.  The stretch is the harness's
``portbench.stretch`` range; every request in it is resolved before it
ends, so the device work it caused lies inside it.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

STRETCH = "portbench.stretch"
DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}


def traced(fn):
    """Run ``fn()`` under the profiler: (its result, the trace's events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(STRETCH):
            result = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return result, events


def _merged(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list, top: int = 10) -> dict:
    """{"window_s", "busy_s", "device_ops": [[name, seconds, count]] (most
    time first), "idle_gaps": [[what the host was doing, seconds]] (most
    first, at most ``top``)} of the stretch."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == STRETCH
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise ValueError("the trace holds no stretch range")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    device, host, ops = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        a, d = float(e["ts"]), float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE and a >= t0 and a + d <= t1:
            device.append((a, a + d))
            total, count = ops.get(e["name"], (0.0, 0))
            ops[e["name"]] = (total + d, count + 1)
        elif e.get("cat") in HOST and e.get("name") != STRETCH:
            host.append((a, a + d, e["name"]))
    merged = _merged(device)
    busy = sum(b - a for a, b in merged)
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    starts = np.array([h[0] for h in host]) if host else np.zeros(0)
    ends = np.array([h[1] for h in host]) if host else np.zeros(0)
    by_label: dict = {}
    for a, b in gaps:
        mid = (a + b) / 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if inside.size:
            k = inside[np.argmin(ends[inside] - starts[inside])]
            label = host[k][2]
        else:
            label = "host between operators"
        by_label[label] = by_label.get(label, 0.0) + (b - a) * 1e-6
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": busy * 1e-6,
        "device_ops": sorted(([name, t * 1e-6, n] for name, (t, n) in ops.items()),
                             key=lambda r: -r[1]),
        "idle_gaps": sorted(([k, v] for k, v in by_label.items()), key=lambda r: -r[1])[:top],
    }
