"""Model step: the whole forward, decode and top-k, as a share (%) of the
card's int8 peak: 2 x conv MACs an image (from the geometry) x the images
whose answers reached the host in the window, over the window's seconds."""

from __future__ import annotations

from portbench.yardstick import PEAK_INT8_OPS, conv_macs_per_image


def read(summary):
    w = summary["window"]
    if not w["images"]:
        return None
    return 2.0 * conv_macs_per_image(summary["net"]) * w["images"] / w["seconds"] / PEAK_INT8_OPS * 100.0
