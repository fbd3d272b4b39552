"""The program's ranges in a trace (``spans.py``): device time, launches
and idle time attributed to each range, on a hand-made trace with two
threads; the readings from it; and on the CPU, the resolving thread's
ranges, which only a profiler over every thread records."""

import pytest

from portbench import harness, spans, trace

SMALL = {"size": 64, "batch": 2, "pool": 2}


def X(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def hand_made():
    """One request: enqueued on thread 1, resolved on thread 2."""
    ua, rt, k = "user_annotation", "cuda_runtime", "kernel"
    return [
        X(trace.STRETCH, ua, 1000.0, 200.0),
        X("portbench.submit", ua, 1000.0, 100.0),
        X("engine.predict_async", ua, 1000.0, 100.0),
        X("engine.quantize", ua, 1005.0, 15.0),
        X("cudaLaunchKernel", rt, 1006.0, 2.0, corr=1),
        X("q", k, 1010.0, 20.0, tid=7, corr=1),
        X("engine.layers", ua, 1020.0, 60.0),
        X("cudaLaunchKernel", rt, 1021.0, 2.0, corr=2),
        X("conv", k, 1030.0, 20.0, tid=7, corr=2),
        X("cudaGraphLaunch", rt, 1030.0, 3.0, corr=3),      # a graph: one launch, two kernels
        X("g1", k, 1050.0, 10.0, tid=7, corr=3),
        X("g2", k, 1060.0, 10.0, tid=7, corr=3),
        X("engine.layers", "gpu_user_annotation", 1030.0, 40.0, tid=7),  # not device work
        X("engine.decode", ua, 1080.0, 10.0),
        X("cuLaunchKernel", "cuda_driver", 1081.0, 2.0, corr=4),
        X("decode", k, 1070.0, 5.0, tid=7, corr=4),
        X("engine.topk", ua, 1090.0, 10.0),
        X("cudaLaunchKernelExC", rt, 1091.0, 2.0, corr=5),
        X("sort", k, 1075.0, 5.0, tid=7, corr=5),
        X("cudaMemsetAsync", rt, 1095.0, 1.0, corr=6),    # device time, not a launch
        X("memset", "gpu_memset", 1080.0, 2.0, tid=7, corr=6),
        X("engine.resolve", ua, 1100.0, 90.0, tid=2),
        X("engine.wait", ua, 1100.0, 50.0, tid=2),
        X("cudaEventSynchronize", rt, 1101.0, 48.0, tid=2, corr=10),
        X("engine.copy", ua, 1150.0, 40.0, tid=2),
        X("cudaMemcpyAsync", rt, 1151.0, 30.0, tid=2, corr=7),
        X("copy", "gpu_memcpy", 1160.0, 10.0, tid=7, corr=7),
        # thread 2 launches while thread 1 is in engine.layers: not its work
        X("cudaLaunchKernel", rt, 1050.0, 2.0, tid=2, corr=8),
        X("other", k, 1170.0, 5.0, tid=7, corr=8),
        X("cudaLaunchKernel", rt, 890.0, 2.0, corr=9),      # before the stretch
        X("early", k, 900.0, 10.0, tid=7, corr=9),
    ]


def summary_of(events, forwards=1, images=4):
    reduced = trace.reduce(events)
    reduced.update(forwards=forwards, images=images, spans=spans.reduce(events))
    return {"trace": reduced}


def test_device_time_launches_and_idle_per_range():
    s = spans.reduce(hand_made())
    assert trace.STRETCH not in s
    want = {  # name: (device us, launches, idle us)
        "engine.predict_async": (72.0, 5, 28.0),
        "portbench.submit": (72.0, 5, 28.0),
        "engine.quantize": (20.0, 1, 5.0),
        "engine.layers": (40.0, 2, 0.0),
        "engine.decode": (5.0, 1, 8.0),      # the memset runs 1080-1082
        "engine.topk": (7.0, 1, 10.0),
        "engine.resolve": (10.0, 0, 75.0),
        "engine.wait": (0.0, 0, 50.0),
        "engine.copy": (10.0, 0, 25.0),
    }
    assert set(s) == set(want)
    for name, (device_us, launches, idle_us) in want.items():
        assert s[name]["count"] == 1, name
        assert s[name]["device_s"] == pytest.approx(device_us * 1e-6), name
        assert s[name]["launches"] == launches, name
        assert s[name]["idle_s"] == pytest.approx(idle_us * 1e-6, abs=1e-12), name
    assert s["engine.copy"]["host_s"] == [pytest.approx(40e-6)]


def test_the_device_annotation_is_not_busy_time():
    r = trace.reduce(hand_made())
    # 1010-1082 and 1160-1175: the gpu_user_annotation adds nothing
    assert r["busy_s"] == pytest.approx(87e-6)


def test_ranges_of_one_name_on_two_threads():
    events = hand_made() + [
        X("engine.copy", "user_annotation", 1176.0, 10.0, tid=3),
        X("cudaMemcpyAsync", "cuda_runtime", 1177.0, 2.0, tid=3, corr=11),
        X("copy", "gpu_memcpy", 1180.0, 4.0, tid=7, corr=11),
    ]
    c = spans.reduce(events)["engine.copy"]
    assert c["count"] == 2
    assert c["device_s"] == pytest.approx(14e-6)
    # the union 1150-1190 holds 1160-1175 and 1180-1184 of device work
    assert c["idle_s"] == pytest.approx(21e-6)


def test_the_readings():
    s = summary_of(hand_made())
    assert spans.quantize_device_us_per_image(s) == pytest.approx(5.0)
    assert spans.decode_device_us_per_image(s) == pytest.approx(3.0)
    assert spans.dispatch_idle_share(s) == pytest.approx(14.0)
    assert spans.launches_per_request(s) == pytest.approx(5.0)
    assert spans.resolve_copy_ms(s) == pytest.approx(0.04)


def test_no_engine_range_reads_nothing():
    events = [e for e in hand_made() if not e["name"].startswith("engine.")]
    s = summary_of(events)
    assert set(s["trace"]["spans"]) == {"portbench.submit"}
    for fn in spans.READINGS:
        assert fn(s) is None, fn.__name__
    # nor without the key, as trace.reduce gives it today
    plain = {"trace": {**trace.reduce(events), "forwards": 1, "images": 4}}
    for fn in spans.READINGS:
        assert fn(plain) is None, fn.__name__


def test_a_trace_without_the_stretch_is_refused():
    with pytest.raises(ValueError):
        spans.reduce([X("k", "kernel", 0.0, 1.0)])


def test_the_resolving_thread_needs_every_thread(root):
    """The offline cell resolves on a thread it starts inside the stretch:
    ``trace.traced`` leaves that thread's ranges out, ``spans.traced``
    records them."""
    cell = harness.Cell(root, "v3-416-b64-offline", 2**31 + 5, "cpu", overrides=SMALL)
    every = spans.stretch(cell, spans.traced, requests=3)["trace"]["spans"]
    for name in ("engine.predict_async", "engine.quantize", "engine.layers", "engine.topk",
                 "engine.resolve", "engine.wait", "engine.copy", "portbench.resolve"):
        assert every[name]["count"] == 3, name
    one = spans.stretch(cell, trace.traced, requests=3)["trace"]["spans"]
    assert one["engine.predict_async"]["count"] == 3
    assert "engine.resolve" not in one and "portbench.resolve" not in one
    s = spans.report(spans.stretch(cell, spans.traced, requests=3))
    assert s["launches_per_request"] == 0  # no card: nothing launched
    assert s["resolve_copy_ms"] > 0
