"""K1 conv kernel (and K2 where a config routes to it): the convs' least
time (``yardstick.conv_least_s``, the same work whatever kernel computes
it) over the device time of the kernels that compute convs, as a %."""

from __future__ import annotations

import re

from portbench.yardstick import conv_least_s

# the conv kernels by their __global__ names, from tools/profile_engine.py::KERNELS
CONV = re.compile(r"qconv_(wgmma|mma|i16)_kernel|halo_kernel.*Params"
                  r"|s2d_mma_kernel|halo_kernel.*HaloConv")


def read(summary):
    t = summary["trace"]
    spent = sum(s for name, s, _ in t["device_ops"] if CONV.search(name))
    if spent <= 0:
        return None
    return conv_least_s(summary["net"], summary["batch"]) * t["forwards"] / spent * 100.0
