"""The arithmetic the per-layer metrics share: the card's peaks, the least
time of a piece of work, and the convs' and shortcuts' work from the
geometry of the reference's own reading of a config.

Copied, not imported, from the program's tools so that a change to the
program cannot move it: the peaks and ``bound_s`` from
``tools/kernel_timings.py::bound_ms``, ``conv_macs_per_image`` from
``tools/bench.py``.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM at 700 W: dense int8 tensor-core rate, HBM3
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def bound_s(nbytes: float, ops: float) -> float:
    """Least seconds on the card: the larger of bytes over the HBM rate and
    int8 operations over the tensor-core peak."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_INT8_OPS)


def conv_macs_per_image(net) -> float:
    """Conv MACs of one image: Ho Wo Co k^2 Ci summed over the convs."""
    macs = 0
    for layer in net.layers:
        if layer.kind == "conv":
            oh, ow, oc = layer.out_shape
            macs += oh * ow * oc * layer.size * layer.size * layer.in_shape[2]
    return float(macs)


def _read_elsewhere(net) -> set:
    """Layers whose output a route or a shortcut reads."""
    return {j for layer in net.layers if layer.kind in ("route", "shortcut") for j in layer.sources}


def conv_work(net, batch: int) -> list[tuple[float, float]]:
    """(bytes, int8 operations) of each conv at ``batch``: the input codes,
    the weight codes, the int32 bias and float32 multipliers each read
    once, the output codes written once; where a 2x2/s2 maxpool follows a
    conv whose output nothing else reads, the output counted is the pooled
    one, the least the work needs."""
    others = _read_elsewhere(net)
    out = []
    for i, layer in enumerate(net.layers):
        if layer.kind != "conv":
            continue
        ih, iw, ic = layer.in_shape
        oh, ow, oc = layer.out_shape
        nxt = net.layers[i + 1] if i + 1 < len(net.layers) else None
        if (nxt is not None and nxt.kind == "maxpool" and nxt.size == 2 and nxt.stride == 2
                and i not in others):
            oh, ow, _ = nxt.out_shape
        nbytes = batch * (ih * iw * ic + oh * ow * oc) + layer.size ** 2 * ic * oc + 8 * oc
        macs = layer.out_shape[0] * layer.out_shape[1] * oc * layer.size ** 2 * ic
        out.append((float(nbytes), 2.0 * macs * batch))
    return out


def conv_least_s(net, batch: int) -> float:
    """The convs' least time for one forward at ``batch``, conv by conv."""
    return sum(bound_s(b, o) for b, o in conv_work(net, batch))


def shortcut_least_s(net, batch: int) -> float:
    """The shortcuts' least time for one forward: two codes read and one
    written for each element."""
    return sum(bound_s(3.0 * batch * h * w * c, 0.0)
               for layer in net.layers if layer.kind == "shortcut"
               for (h, w, c) in [layer.out_shape])
