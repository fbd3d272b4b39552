"""The reduction of a profiler trace, on a hand-made one."""

import pytest

from portbench import trace


def X(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_busy_gaps_and_what_the_host_did():
    events = [
        X(trace.STRETCH, "user_annotation", 1000.0, 100.0),
        X("k1", "kernel", 1010.0, 20.0),
        X("k1", "kernel", 1025.0, 15.0),       # overlaps the first: busy 1010-1040
        X("copy", "gpu_memcpy", 1060.0, 10.0),
        X("k2", "kernel", 1080.0, 10.0),
        X("k0", "kernel", 900.0, 10.0),        # before the stretch: left out
        X("portbench.submit", "user_annotation", 995.0, 50.0),
        X("cudaLaunchKernel", "cuda_runtime", 1000.0, 12.0),
        X("cudaStreamSynchronize", "cuda_runtime", 1045.0, 30.0),
    ]
    r = trace.reduce(events)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(50e-6)
    assert r["device_ops"][0] == ["k1", pytest.approx(35e-6), 2]
    assert {n for n, _, _ in r["device_ops"]} == {"k1", "copy", "k2"}
    gaps = dict(r["idle_gaps"])
    # 1000-1010 under the launch, 1040-1060 and 1070-1080 under the sync,
    # 1090-1100 under nothing the trace holds
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(30e-6)
    assert gaps["host between operators"] == pytest.approx(10e-6)


def test_a_trace_without_the_stretch_is_refused():
    with pytest.raises(ValueError):
        trace.reduce([X("k", "kernel", 0.0, 1.0)])
