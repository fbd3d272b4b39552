"""What the benchmark makes from ``--seed`` and hands to both sides: float
weights, activation ranges, and a pool of uint8 frames.

The weight rule is ``models/presets.py``'s seeded init, copied: He-style
scale sqrt(2 / (k^2 Ci)) times a standard normal; here drawn on the device
in two large calls, with seeded BN statistics and biases so that the BN
fold and the bias codes are exercised.  The range rules are the presets'
synthetic ranges (input [0, 1], relu6 convs [0, 6], linear heads [-12, 12],
everything else [-2, 6]) and ``perturbed_quant_state``'s move off those
round values (the idx-th range after the input: min times 1 + 0.013 (idx +
1), max times 1 + 0.017 (idx + 1)), with one change: a relu6 range's
maximum is divided by that factor, since a range learned on relu6 outputs
never passes 6.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LETTERBOX_GRAY = 127
RANGE_RULES = ("synthetic", "perturbed")


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of ``seed``; any integer, large or negative."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, (seed >> 64) & 0xFFFFFFFF]
    words += [ord(ch) for ch in tag]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def float_params(net, seed: int, device) -> dict:
    """{layer: {"w" (k, k, Ci, Co) HWIO, "bias", and with BN "gamma", "mean",
    "var"}} as float32 numpy, drawn on ``device``."""
    convs = [(i, layer) for i, layer in enumerate(net.layers) if layer.kind == "conv"]
    sizes = [layer.size ** 2 * layer.in_shape[2] * layer.filters for _, layer in convs]
    scales = torch.tensor([float(np.sqrt(2.0 / (layer.size ** 2 * layer.in_shape[2])))
                           for _, layer in convs], device=device)
    g = generator(seed, "weights", device)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    flat *= torch.repeat_interleave(scales, torch.tensor(sizes, device=device))
    channels = sum(layer.filters for _, layer in convs)
    u = torch.rand(4, channels, generator=g, device=device)
    w_all = flat.cpu().numpy()
    gamma, beta, mean, var = (0.9 + 0.2 * u[0], 0.2 * (u[1] - 0.5), 0.2 * (u[2] - 0.5),
                              0.8 + 0.4 * u[3])
    vec = torch.stack([gamma, beta, mean, var]).cpu().numpy()
    params, w0, c0 = {}, 0, 0
    for (i, layer), n in zip(convs, sizes):
        co = layer.filters
        p = {"w": w_all[w0:w0 + n].reshape(layer.size, layer.size, layer.in_shape[2], co),
             "bias": vec[1, c0:c0 + co]}
        if layer.batch_normalize:
            p.update(gamma=vec[0, c0:c0 + co], mean=vec[2, c0:c0 + co], var=vec[3, c0:c0 + co])
        params[i] = p
        w0, c0 = w0 + n, c0 + co
    return params


def tracked(net) -> list[str]:
    """The keys of the ranges a quantized program tracks, in layer order:
    every conv's output, every route over more than one layer, every
    shortcut."""
    keys = []
    for i, layer in enumerate(net.layers):
        if (layer.kind in ("conv", "shortcut")
                or (layer.kind == "route" and len(layer.sources) > 1)):
            keys.append(f"act_{i}")
    return keys


def ranges(net, rule: str) -> dict:
    """{"input": ..., "act_i": ...} of {"min", "max"} as float32, by ``rule``:
    ``synthetic`` or ``perturbed``."""
    if rule not in RANGE_RULES:
        raise ValueError(f"unknown range rule {rule!r}")
    out = {"input": {"min": np.float32(0.0), "max": np.float32(1.0)}}
    for idx, key in enumerate(tracked(net)):
        layer = net.layers[int(key.split("_")[1])]
        act = layer.activation if layer.kind == "conv" else None
        lo, hi = {"relu6": (0.0, 6.0), "linear": (-12.0, 12.0)}.get(act, (-2.0, 6.0))
        lo, hi = np.float32(lo), np.float32(hi)
        if rule == "perturbed":
            grow_lo = np.float32(1.0 + 0.013 * (idx + 1))
            grow_hi = np.float32(1.0 + 0.017 * (idx + 1))
            lo = lo * grow_lo
            hi = hi / grow_hi if act == "relu6" else hi * grow_hi
        out[key] = {"min": np.float32(lo), "max": np.float32(hi)}
    return out


def frame_pool(count: int, batch: int, size: int, seed: int, device) -> torch.Tensor:
    """(count, batch, size, size, 3) uint8 frames as a letterbox leaves them:
    a 16:9 picture of smooth random shapes and fine noise, gray bars above
    and below."""
    g = generator(seed, "frames", device)
    n, h = count * batch, (size * 9 // 16) // 2 * 2
    low = torch.randint(0, 256, (n, 3, max(h // 8, 1), max(size // 8, 1)), generator=g,
                        device=device).to(torch.float32)
    picture = F.interpolate(low, size=(h, size), mode="bilinear", align_corners=False)
    picture += torch.randint(-12, 13, (n, 3, h, size), generator=g, device=device)
    canvas = torch.full((n, size, size, 3), LETTERBOX_GRAY, dtype=torch.uint8, device=device)
    top = (size - h) // 2
    canvas[:, top:top + h] = picture.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    return canvas.reshape(count, batch, size, size, 3)
