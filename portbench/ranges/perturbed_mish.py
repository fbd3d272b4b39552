"""``perturbed`` ranges (``inputs.ranges``) for a configuration with mish
convs: each mish conv's minimum is mish's own minimum, -0.30884, divided
by that range's growth factor (1 + 0.013 (idx + 1)).  A range learned on
mish outputs never passes below mish's minimum, as one learned on relu6
outputs never passes 6, which ``inputs.py`` treats alike."""

from __future__ import annotations

import numpy as np

from portbench import inputs

MISH_MIN = -0.30884  # min over x of x tanh(softplus(x)), at x = -1.1924


def ranges(net) -> dict:
    out = inputs.ranges(net, "perturbed")
    for idx, key in enumerate(inputs.tracked(net)):
        layer = net.layers[int(key.split("_")[1])]
        if layer.kind == "conv" and layer.activation == "mish":
            grow_lo = np.float32(1.0 + 0.013 * (idx + 1))
            out[key] = {"min": np.float32(np.float32(MISH_MIN) / grow_lo), "max": out[key]["max"]}
    return out
