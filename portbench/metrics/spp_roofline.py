"""SPP kernel: each SPP block's least bytes, its input's codes read once
and the route's concatenation written once, at the HBM rate, over the
device time of ``spp_kernel``, as a %.  The bytes come from the reference's
geometry of the config, the same work whatever implements the block; the
function that counts them is here.  None where no such kernel ran (a
program that runs the block layer by layer)."""

from __future__ import annotations

import re

from portbench.yardstick import PEAK_BYTES

SPP = re.compile(r"spp_kernel")


def spp_bytes(net, batch: int) -> float:
    """The least bytes of one forward's SPP blocks at ``batch``: for each
    route over two or more layers whose sources are stride-1 maxpools of
    odd size and the layer they pool (through single-layer routes), the
    pooled layer's codes once and the route's output once."""
    layers = net.layers

    def base(j):
        while layers[j].kind == "route" and len(layers[j].sources) == 1:
            j = layers[j].sources[0]
        return j

    total = 0.0
    for layer in layers:
        if layer.kind != "route" or len(layer.sources) < 2:
            continue
        pools = [j for j in layer.sources if layers[j].kind == "maxpool" and layers[j].stride == 1
                 and layers[j].size % 2 == 1 and layers[j].size >= 3]
        if not pools:
            continue
        bases = {base(j - 1) for j in pools} | {j for j in layer.sources if j not in pools}
        if len(bases) != 1:
            continue
        h, w, c = layers[bases.pop()].out_shape
        oh, ow, oc = layer.out_shape
        total += batch * (h * w * c + oh * ow * oc)
    return float(total)


def read(summary):
    t = summary["trace"]
    spent = sum(s for name, s, _ in t["device_ops"] if SPP.search(name))
    if spent <= 0:
        return None
    return spp_bytes(summary["net"], summary["batch"]) / PEAK_BYTES * t["forwards"] / spent * 100.0
