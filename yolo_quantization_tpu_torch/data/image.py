"""Image decoding and letterboxing with darknet's geometry (numpy).

darknet's bilinear resize samples with align-corners (scale =
(src-1)/(dst-1)); the letterbox places the resized image on a 0.5-gray
canvas.  Decoding goes through PIL; the reference's native libjpeg/libpng
decoder is not ported yet (ROADMAP queue 1.10).
"""

from __future__ import annotations

import numpy as np


def load_image_rgb(path: str) -> np.ndarray:
    """Decode to float32 HWC RGB in [0, 1]."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def resize_bilinear_darknet(im: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """darknet resize_image: align-corners bilinear on HWC float, column pass
    then row pass; the last column/row is copied exactly."""
    h, w, _ = im.shape
    if (w, h) == (out_w, out_h):
        return im.copy()

    def axis_coords(src: int, dst: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if dst == 1 or src == 1:
            idx = np.zeros(dst, np.int64)
            return idx, idx, np.zeros(dst, np.float32)
        x = np.arange(dst, dtype=np.float64) * (src - 1) / (dst - 1)
        ix = np.minimum(x.astype(np.int64), src - 2)
        dx = (x - ix).astype(np.float32)
        return ix, ix + 1, dx

    ix0, ix1, dx = axis_coords(w, out_w)
    part = (1.0 - dx)[None, :, None] * im[:, ix0] + dx[None, :, None] * im[:, ix1]
    iy0, iy1, dy = axis_coords(h, out_h)
    out = (1.0 - dy)[:, None, None] * part[iy0] + dy[:, None, None] * part[iy1]
    return out.astype(np.float32)


def letterbox(im: np.ndarray, net_w: int, net_h: int) -> np.ndarray:
    """Aspect-preserving resize onto a 0.5-gray canvas."""
    h, w, c = im.shape
    new_w, new_h = letterbox_params(w, h, net_w, net_h)
    resized = resize_bilinear_darknet(im, new_w, new_h)
    canvas = np.full((net_h, net_w, c), 0.5, np.float32)
    dy = (net_h - new_h) // 2
    dx = (net_w - new_w) // 2
    canvas[dy : dy + new_h, dx : dx + new_w] = resized
    return canvas


def letterbox_params(w: int, h: int, net_w: int, net_h: int) -> tuple[int, int]:
    """The (new_w, new_h) the letterbox used — needed to invert box coords."""
    if net_w / w < net_h / h:
        return net_w, (h * net_w) // w
    return (w * net_h) // h, net_h
