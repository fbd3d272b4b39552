"""Glue ops: device time, in us an image, of every device operation that
is neither a conv kernel nor the shortcut kernel: input quantize, route
requant, pools and upsample on codes, dequant, decode, top-k, and the
copies of the answer."""

from __future__ import annotations

import re

# the conv and shortcut kernels, from tools/profile_engine.py::KERNELS
HAND_WRITTEN = re.compile(r"qconv_(wgmma|mma|i16)_kernel|halo_kernel"
                          r"|s2d_mma_kernel|shortcut_kernel")


def read(summary):
    t = summary["trace"]
    if not t["images"] or not t["device_ops"]:
        return None
    spent = sum(s for name, s, _ in t["device_ops"] if not HAND_WRITTEN.search(name))
    return spent / t["images"] * 1e6
