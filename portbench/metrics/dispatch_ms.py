"""Engine layer: the median host time of one call to
``Engine.predict_async`` (enqueue only), in ms, over the requests of the
window, which the profiler does not slow."""

from __future__ import annotations

import statistics


def read(summary):
    times = summary["window"]["dispatch_s"]
    return statistics.median(times) * 1e3 if times else None
