"""Shortcut kernel: the shortcuts' least time (two codes read, one
written, at the HBM rate) over the device time of the shortcut kernels,
as a %."""

from __future__ import annotations

import re

from portbench.yardstick import shortcut_least_s

# from tools/profile_engine.py::KERNELS
SHORTCUT = re.compile(r"shortcut_kernel")


def read(summary):
    t = summary["trace"]
    spent = sum(s for name, s, _ in t["device_ops"] if SHORTCUT.search(name))
    if spent <= 0:
        return None
    return shortcut_least_s(summary["net"], summary["batch"]) * t["forwards"] / spent * 100.0
