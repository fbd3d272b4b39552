"""Weight-surgery utilities (darknet's examples/darknet.c toolbox).

The counterpart of ``yolo_quantization_tpu/models/weights_tools.py``:
print_weights, rescale_net, rgbgr_net, normalize_net / denormalize_net,
statistics_net, the filter images and mosaic (``darknet visualize``) and
mkimg.  Host numpy tools over the params dict.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from yolo_quantization_tpu_torch.nn.graph import ConnectedSpec, ConvSpec, NetworkDef

BN_EPS = 1e-6


def print_weights(net: NetworkDef, params, layer_index: int) -> str:
    """Dump a conv layer's kernels (examples/darknet.c:11-28)."""
    p = params[layer_index]
    w = np.asarray(p["w"])  # HWIO
    lines = [f"layer {layer_index}: {w.shape[3]} filters of "
             f"{w.shape[0]}x{w.shape[1]}x{w.shape[2]}"]
    for o in range(min(w.shape[3], 4)):
        lines.append(f"filter {o}: {np.array2string(w[..., o].ravel()[:18], precision=4)}")
    return "\n".join(lines)


def rgbgr_net(net: NetworkDef, params) -> None:
    """Swap the first conv's input channels RGB<->BGR in place
    (examples/darknet.c:45-57) — converts checkpoints trained on BGR images."""
    first = min(i for i, s in enumerate(net.specs) if isinstance(s, ConvSpec))
    w = np.asarray(params[first]["w"])
    params[first]["w"] = w[:, :, ::-1, :].copy()


def rescale_net(net: NetworkDef, params, scale: float) -> None:
    """Scale the first conv's weights/bias (examples/darknet.c:30-43) — used
    to retarget input ranges (e.g. [0,255] vs [0,1] pipelines)."""
    first = min(i for i, s in enumerate(net.specs) if isinstance(s, ConvSpec))
    params[first]["w"] = np.asarray(params[first]["w"]) * scale
    # darknet rescales biases too via rescale_weights(scale, trans)


def normalize_net(net: NetworkDef, params) -> NetworkDef:
    """Add identity batch-norm to every conv/connected layer that lacks it
    (examples/darknet.c:98-122 normalize_net + normalize_layer) so a
    float-trained checkpoint can be fine-tuned WITH batch statistics.

    gamma is seeded as sqrt(var)+eps so gamma/(sqrt(var)+eps) == 1.0 exactly
    in float32 — the layer's output is bit-unchanged until training updates
    the stats (the reference callocs rolling stats to 0 and relies on the
    first forward to fill them; an exact identity is strictly safer).  The
    conv's bias becomes the BN beta, exactly like darknet reuses l.biases.

    Returns the new NetworkDef (specs are immutable here, unlike darknet's
    in-place struct edit); ``params`` is updated in place.  Inverse of
    denormalize_net.
    """
    new_specs = []
    for i, s in enumerate(net.specs):
        if (
            isinstance(s, (ConvSpec, ConnectedSpec))
            and not s.batch_normalize
            and i in params
        ):
            n = np.asarray(params[i]["bias"]).shape[0]
            var = np.ones((n,), np.float32)
            params[i]["gamma"] = (np.sqrt(var) + np.float32(BN_EPS)).astype(np.float32)
            params[i]["mean"] = np.zeros((n,), np.float32)
            params[i]["var"] = var
            new_specs.append(dataclasses.replace(s, batch_normalize=True))
        else:
            new_specs.append(s)
    return dataclasses.replace(net, specs=tuple(new_specs))


def denormalize_net(net: NetworkDef, params) -> None:
    """Fold every conv's BN into its weights and drop the BN stats in place
    (examples/darknet.c:154-186): w' = w*gamma/(sqrt(var)+eps),
    b' = beta - gamma*mean/(sqrt(var)+eps), then gamma=1, mean=0, var=1."""
    for i, s in enumerate(net.specs):
        if isinstance(s, ConvSpec) and s.batch_normalize and i in params:
            p = params[i]
            inv = np.asarray(p["gamma"]) / (np.sqrt(np.asarray(p["var"])) + BN_EPS)
            p["w"] = np.asarray(p["w"]) * inv.reshape(1, 1, 1, -1)
            p["bias"] = np.asarray(p["bias"]) - np.asarray(p["mean"]) * inv
            p["gamma"] = np.ones_like(inv)
            p["mean"] = np.zeros_like(inv)
            p["var"] = np.ones_like(inv)


def get_filter_images(net: NetworkDef, params, layer_index: int) -> np.ndarray:
    """Per-filter images of a conv layer, each normalized to [0,1]
    (get_weights + normalize_image, src/convolutional_layer.c:954-969).

    Returns (n_filters, k, k, in_c) float32.
    """
    w = np.asarray(params[layer_index]["w"], np.float32)  # HWIO
    imgs = np.transpose(w, (3, 0, 1, 2)).copy()           # (O, H, W, I)
    for i in range(imgs.shape[0]):
        lo, hi = imgs[i].min(), imgs[i].max()
        if hi - lo > 1e-12:
            imgs[i] = (imgs[i] - lo) / (hi - lo)
        else:
            imgs[i] = 0.5
    return imgs


def filter_mosaic(
    net: NetworkDef, params, layer_index: int | None = None, border: int = 1
) -> np.ndarray:
    """Collage of a conv layer's filters, the ``darknet visualize`` analog
    (examples/darknet.c:214 -> visualize_network src/network.c:550-562).

    Defaults to the first conv.  Filters with 3 input channels render RGB;
    otherwise the channel-mean renders gray.  Returns uint8 (H, W, 3).
    """
    if layer_index is None:
        layer_index = min(
            i for i, s in enumerate(net.specs) if isinstance(s, ConvSpec)
        )
    imgs = get_filter_images(net, params, layer_index)
    n, k, _, in_c = imgs.shape
    if in_c == 3:
        tiles = imgs
    else:
        tiles = np.repeat(imgs.mean(axis=-1, keepdims=True), 3, axis=-1)
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    cell = k + border
    out = np.full((rows * cell + border, cols * cell + border, 3), 0.2, np.float32)
    for i in range(n):
        r, c = divmod(i, cols)
        y, x = border + r * cell, border + c * cell
        out[y : y + k, x : x + k] = tiles[i]
    return (out * 255.0 + 0.5).astype(np.uint8)


def _ghost_composite(src: np.ndarray, dest: np.ndarray, dx: int, dy: int) -> None:
    """Alpha-blend ``src`` onto ``dest`` at (dx, dy) with a radial alpha that
    peaks at the filter center (ghost_image, src/image.c:380-397)."""
    h, w = src.shape[:2]
    ys = np.arange(h, dtype=np.float32) - h / 2.0 + 0.5
    xs = np.arange(w, dtype=np.float32) - w / 2.0 + 0.5
    max_dist = np.sqrt((-w / 2.0 + 0.5) ** 2)
    dist = np.sqrt(xs[None, :] ** 2 + ys[:, None] ** 2)
    alpha = np.clip(1.0 - dist / max_dist, 0.0, None)[..., None]
    region = dest[dy : dy + h, dx : dx + w]
    region[:] = alpha * src + (1 - alpha) * region


def mkimg(
    net: NetworkDef,
    params,
    h: int,
    w: int,
    num: int,
    seed: int = 0,
    per_image: int = 100,
) -> list[np.ndarray]:
    """Generate ``num`` synthetic images by ghost-compositing random
    first-conv filters onto a 0.5-gray canvas (mkimg, examples/darknet.c:188-213).

    Deviation: the reference also HSV-distorts each stamp
    (random_distort_image) — here stamps get the random 90-degree rotations
    only; distortion belongs to the data pipeline.  Returns float32 HxWx3
    images in [0,1].
    """
    first = min(i for i, s in enumerate(net.specs) if isinstance(s, ConvSpec))
    imgs = get_filter_images(net, params, first)
    if imgs.shape[-1] != 3:
        imgs = np.repeat(imgs.mean(axis=-1, keepdims=True), 3, axis=-1)
    rng = np.random.default_rng(seed)
    out = []
    k = imgs.shape[1]
    for _ in range(num):
        canvas = np.full((h, w, 3), 0.5, np.float32)
        for _ in range(per_image):
            stamp = imgs[rng.integers(0, imgs.shape[0])]
            stamp = np.rot90(stamp, k=int(rng.integers(0, 4)), axes=(0, 1)).copy()
            dx = int(rng.integers(0, w - k))
            dy = int(rng.integers(0, h - k))
            _ghost_composite(stamp, canvas, dx, dy)
        out.append(canvas)
    return out


def statistics_net(net: NetworkDef, params) -> str:
    """Per-layer weight statistics (examples/darknet.c:124-152)."""
    lines = []
    for i in sorted(params):
        p = params[i]
        w = np.asarray(p.get("w", np.zeros(1)))
        lines.append(
            f"layer {i:3d}: weights {w.size:9d}  mean {w.mean():+.5f}  "
            f"std {w.std():.5f}  |max| {np.abs(w).max():.5f}"
        )
        if "gamma" in p:
            g = np.asarray(p["gamma"])
            v = np.asarray(p["var"])
            lines.append(
                f"            bn: gamma mean {g.mean():.5f}, rolling var mean {v.mean():.5f}"
            )
    return "\n".join(lines)
