"""Layer primitives (NHWC): the float layers of QAT training and float
inference, and the integer maxpool and upsample of the engine.

The counterpart of ``yolo_quantization_tpu/nn/layers.py`` (darknet's layer
forwards).  Convolutions take NHWC inputs and HWIO kernels, as the reference
does; ``conv2d`` hands them to ``F.conv2d`` as channels-last views.

Gradients follow the reference's autodiff: a max or min of two equal values
splits the gradient in halves (``torch.maximum``/``torch.minimum``, not
``torch.clamp``, whose gradient passes whole at the bounds), and a float
maxpool window gives a tie's whole gradient to its first element
(``F.max_pool2d`` over a ``-inf``-padded map).

The extended darknet layers of the yolov2/yolov1 models and the classifiers
(connected, softmax, global average pool, dropout, reorg, LRN, L2 norm,
crop, the locally connected conv and the transpose conv) follow.  Their
matmuls and convolutions run in ``float32_convs()`` forward and backward
(TF32 off, deterministic algorithms), and no gradient of theirs is an
atomic scatter: ``reorg`` is a gather whose gradient is the gather by the
inverse permutation.  Dropout and the training crop draw from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-6  # darknet adds eps to sqrt(var), not to var


def _max(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.maximum(x, x.new_tensor(v))


def _min(x: torch.Tensor, v: float) -> torch.Tensor:
    return torch.minimum(x, x.new_tensor(v))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """min(max(x, lo), hi) with the reference's tie gradients."""
    return _min(_max(x, lo), hi)


def activate(x: torch.Tensor, name: str) -> torch.Tensor:
    """The darknet activation library: linear leaky relu relu6 leaky6
    logistic loggy relie ramp tanh elu selu plse stair hardtan lhtan."""
    if name == "linear":
        return x
    if name == "leaky":
        return torch.where(x > 0, x, 0.1 * x)
    if name == "relu":
        return _max(x, 0.0)
    if name == "relu6":
        return clip(x, 0.0, 6.0)
    if name == "leaky6":
        return torch.where(x > 6, x.new_tensor(6.0), torch.where(x > 0, x, 0.1 * x))
    if name == "logistic":
        return torch.sigmoid(x)
    if name == "loggy":
        return 2.0 * torch.sigmoid(x) - 1.0
    if name == "relie":
        return torch.where(x > 0, x, 0.01 * x)
    if name == "ramp":
        return x * (x > 0) + 0.1 * x
    if name == "tanh":
        return torch.tanh(x)
    if name == "elu":
        return torch.where(x >= 0, x, torch.exp(_min(x, 0.0)) - 1.0)
    if name == "selu":
        return torch.where(x >= 0, 1.0507 * x, 1.0507 * 1.6732 * (torch.exp(_min(x, 0.0)) - 1.0))
    if name == "plse":
        return torch.where(x < -4, 0.01 * (x + 4),
                           torch.where(x > 4, 0.01 * (x - 4) + 1.0, 0.125 * x + 0.5))
    if name == "stair":
        n = torch.floor(x)
        return torch.where(n.to(torch.int32) % 2 == 0, torch.floor(x / 2.0),
                           (x - n) + torch.floor(x / 2.0))
    if name == "hardtan":
        return clip(x, -1.0, 1.0)
    if name == "lhtan":
        return torch.where(x < 0, 0.001 * x, torch.where(x > 1, 0.001 * (x - 1) + 1.0, x))
    raise ValueError(f"unknown activation {name!r}")


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN picks only deterministic algorithms inside the block.  Its
    default choice for a weight gradient may sum partial products in an
    order that changes from run to run; the reference's training is a
    fixed function of its seed, and so is this port's."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


@contextlib.contextmanager
def float32_convs():
    """Deterministic convolutions in plain float32 inside the block.  On
    CUDA, PyTorch lets cuDNN run float32 convolutions on TF32 tensor cores by
    default (10-bit mantissa products); here TF32 is off, for the matmuls of
    ``weight_grad`` too.  On the CPU the
    oneDNN convolution accumulates large contractions less accurately than
    the reference's (several times the error at K = 4608); the native im2col
    + GEMM path matches the reference's summation, often bit for bit."""
    flags = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = flags[0].allow_tf32, flags[1].allow_tf32, torch.backends.mkldnn.enabled
    flags[0].allow_tf32 = flags[1].allow_tf32 = False
    torch.backends.mkldnn.enabled = False
    try:
        with deterministic_convs():
            yield
    finally:
        flags[0].allow_tf32, flags[1].allow_tf32, torch.backends.mkldnn.enabled = prev


class _Conv2d(torch.autograd.Function):
    """F.conv2d on operands cast to ``dtype``, output cast to float32, whose
    forward and backward both run in the dtype's scope (``float32_convs`` or
    ``deterministic_convs``): autograd runs the backward after the forward's
    scope has closed, so the backward re-enters it.  The cotangent is cast to
    ``dtype`` and the operands' gradients back to float32, as autodiff of the
    reference's cast-convolve-cast chain does."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, dtype):
        xc, wc = x.to(dtype), w.to(dtype)
        ctx.save_for_backward(xc, wc)
        ctx.conf = (stride, pad, dtype, x.dtype, w.dtype)
        with _conv_scope(dtype):
            return F.conv2d(xc, wc, stride=stride, padding=pad).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pad, dtype, x_dtype, w_dtype = ctx.conf
        # on the card cuDNN's deterministic weight-gradient algorithms sum a
        # stem's N*H*W products in one long chain, far less accurately than
        # its default (which adds partial sums in no fixed order), and no
        # cuDNN algorithm sums a 3x3 layer's as accurately as the chunks of
        # ``weight_grad``: float32 weight gradients there come from it
        own_gw = ctx.needs_input_grad[1] and g.is_cuda and dtype == torch.float32
        with _conv_scope(dtype):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g.to(dtype), x, w, None, [stride, stride], [pad, pad], [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1] and not own_gw, False],
            )
            if own_gw:
                gw = weight_grad(x.permute(0, 2, 3, 1), g.permute(0, 2, 3, 1), w.shape[-1],
                                 stride, pad).permute(3, 2, 0, 1)
        gx = None if gx is None else gx.to(x_dtype)
        gw = None if gw is None else gw.to(w_dtype)
        return gx, gw, None, None, None


def weight_grad(x: torch.Tensor, g: torch.Tensor, k: int, stride: int, pad: int,
                chunk: int = 1024) -> torch.Tensor:
    """The HWIO weight gradient of a k x k conv from its NHWC input ``x`` and
    output cotangent ``g``, deterministic and accurate over long sums: the
    N*Ho*Wo products of each weight are summed in chunks of at most
    ``chunk`` rows (one batched matmul over im2col columns), and the chunks'
    partial sums are added by one reduction.  The chunks also give the
    matmul its parallelism: its output, k*k*Ci x Co, is small."""
    n, ho, wo, co = g.shape
    ci = x.shape[-1]
    if k == 1 and stride == 1 and pad == 0:
        cols = x.reshape(-1, ci)
    else:
        xp = F.pad(x, (0, 0, pad, pad, pad, pad))
        cols = torch.stack([xp[:, ky : ky + (ho - 1) * stride + 1 : stride,
                               kx : kx + (wo - 1) * stride + 1 : stride, :]
                            for ky in range(k) for kx in range(k)], dim=3).reshape(-1, k * k * ci)
    gm = g.reshape(-1, co)
    rows = cols.shape[0]
    if rows <= chunk:
        return (cols.t() @ gm).reshape(k, k, ci, co)
    # the largest chunk in (chunk/2, chunk] that divides the rows, else zero
    # rows appended (they add nothing)
    size = next((c for c in range(chunk, chunk // 2, -1) if rows % c == 0), chunk)
    parts = -(-rows // size)
    if parts * size != rows:
        cols = F.pad(cols, (0, 0, 0, parts * size - rows))
        gm = F.pad(gm, (0, 0, 0, parts * size - rows))
    part = torch.bmm(cols.view(parts, size, -1).transpose(1, 2), gm.view(parts, size, co))
    return part.sum(0).reshape(k, k, ci, co)


def _conv_scope(dtype: torch.dtype):
    return float32_convs() if dtype == torch.float32 else deterministic_convs()


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int,
           compute_dtype: str | None = None) -> torch.Tensor:
    """Float conv, NHWC x HWIO -> NHWC, darknet symmetric padding.

    ``compute_dtype="bfloat16"`` casts both operands to bf16, convolves and
    casts the output to float32 (params stay float32).  Forward and
    backward run in deterministic cuDNN algorithms, the float32 path also in
    ``float32_convs``.
    """
    if compute_dtype in (None, "float32"):
        dtype = torch.float32
    elif compute_dtype == "bfloat16":
        dtype = torch.bfloat16
    else:
        raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")
    y = _Conv2d.apply(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride, pad, dtype)
    return y.permute(0, 2, 3, 1)


def bn_inference_scale_bias(gamma, beta, mean, var):
    """BN running stats folded into a per-channel (scale, bias):
    y = gamma * (x - mean) / (sqrt(var) + eps) + beta."""
    inv = gamma / (torch.sqrt(var) + BN_EPS)
    return inv, beta - mean * inv


def fold_bn_into_weights(w, bias, gamma, beta, mean, var):
    """(w_folded, bias_folded) for conv-then-BN: each HWIO output channel is
    scaled by gamma/(sqrt(var)+eps); darknet's conv bias is BN's beta, so
    ``bias`` is unused."""
    del bias
    inv = gamma / (torch.sqrt(var) + BN_EPS)
    return w * inv.reshape(1, 1, 1, -1), beta - mean * inv


def batch_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance over (N, H, W) of NHWC."""
    mean = torch.mean(x, dim=(0, 1, 2))
    var = torch.var(x, dim=(0, 1, 2), correction=0)
    return mean, var


def maxpool_padding(h: int, size: int, stride: int, pad: int) -> tuple[int, int, int]:
    """darknet maxpool geometry: out = (h + pad - size)//stride + 1, window
    origin offset -pad//2.  Returns (out_h, pad_lo, pad_hi)."""
    out = (h + pad - size) // stride + 1
    pad_lo = pad // 2
    pad_hi = max(0, (out - 1) * stride + size - pad_lo - h)
    return out, pad_lo, pad_hi


def maxpool(x: torch.Tensor, size: int, stride: int, pad: int) -> torch.Tensor:
    """Float maxpool with darknet geometry, padded with -inf (the
    asymmetric pad of a size-2/stride-1 pool included).  Both spatial axes
    take the padding computed from the height, as the reference's does."""
    _, lo, hi = maxpool_padding(x.shape[1], size, stride, pad)
    xp = F.pad(x, (0, 0, lo, hi, lo, hi), value=float("-inf")) if lo or hi else x
    y = F.max_pool2d(xp.permute(0, 3, 1, 2), kernel_size=size, stride=stride)
    return y.permute(0, 2, 3, 1)


def maxpool_u8(x_u8: torch.Tensor, size: int, stride: int, pad: int) -> torch.Tensor:
    """Quantized maxpool on codes (max is scale-invariant).

    Pads with the domain minimum: code 0 for uint8, -128 for the shifted
    int8 representation.  Written as a max over strided views, because
    ``F.max_pool2d`` takes floating types only.
    """
    if x_u8.dtype not in (torch.uint8, torch.int8):
        raise TypeError(f"maxpool_u8 takes uint8/int8 codes, got {x_u8.dtype}")
    init = -128 if x_u8.dtype == torch.int8 else 0
    n, h, w, c = x_u8.shape
    oh, lo_h, hi_h = maxpool_padding(h, size, stride, pad)
    ow, lo_w, hi_w = maxpool_padding(w, size, stride, pad)
    xp = F.pad(x_u8, (0, 0, lo_w, hi_w, lo_h, hi_h), value=init)
    out = None
    for ky in range(size):
        for kx in range(size):
            v = xp[:, ky : ky + (oh - 1) * stride + 1 : stride,
                   kx : kx + (ow - 1) * stride + 1 : stride, :]
            out = v if out is None else torch.maximum(out, v)
    return out.contiguous()


def upsample_nearest(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Nearest-neighbour upsample by an integer stride (any dtype).  Built
    from a broadcast, whose gradient is a sum over each stride x stride
    block; the gradient of ``repeat_interleave`` is an ``index_add_``, which
    adds in no fixed order on CUDA."""
    n, h, w, c = x.shape
    return (x[:, :, None, :, None, :].expand(n, h, stride, w, stride, c)
            .reshape(n, h * stride, w * stride, c))


def route_concat(tensors: list[torch.Tensor]) -> torch.Tensor:
    """Channel concat (darknet [route] over several layers)."""
    return torch.cat(tensors, dim=-1)


def shortcut_add(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Residual add (darknet [shortcut], same shapes)."""
    return x + skip


# ---------------------------------------------------------------------------
# The extended darknet layer set (float only)
# ---------------------------------------------------------------------------


class _Matmul(torch.autograd.Function):
    """a @ b with forward and backward in ``float32_convs()`` (TF32 off on
    the card: autograd runs the backward after the forward's scope)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with float32_convs():
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with float32_convs():
            ga = g @ b.transpose(-1, -2) if ctx.needs_input_grad[0] else None
            gb = a.transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None
        return ga, gb


def connected(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Fully connected layer over every non-batch dim, flattened in NHWC
    order; w is (in_features, out_features)."""
    return _Matmul.apply(x.reshape(x.shape[0], -1), w) + bias


def softmax(x: torch.Tensor, temperature: float = 1.0, groups: int = 1) -> torch.Tensor:
    """darknet's softmax layer: over the flattened (H, W, C) of each image,
    in ``groups`` independent groups."""
    flat = x.reshape(x.shape[0], groups, -1)
    return torch.softmax(flat / temperature, dim=-1).reshape(x.shape)


def global_avgpool(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> (N, 1, 1, C) mean."""
    return torch.mean(x, dim=(1, 2), keepdim=True)


def dropout(x: torch.Tensor, prob: float, generator: torch.Generator | None,
            rows: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """darknet's dropout: at training time each value is kept with
    probability 1 - prob (the mask drawn from ``generator``, which lives on
    x's device) and survivors are scaled by 1/(1 - prob); without a
    generator, or at prob 0, the identity.  ``rows`` = (rank, world): x is
    rank's share of a global batch of world * len(x) rows, and the mask is
    that share of the global batch's mask (every rank's generator draws the
    same numbers)."""
    if generator is None or prob <= 0:
        return x
    rank, world = rows
    n = x.shape[0]
    keep = torch.rand((n * world,) + tuple(x.shape[1:]), generator=generator,
                      device=x.device)[rank * n : (rank + 1) * n] < 1.0 - prob
    return torch.where(keep, x / (1.0 - prob), torch.zeros_like(x))


@functools.lru_cache(maxsize=32)
def _reorg_permutation(h: int, w: int, c: int, stride: int) -> np.ndarray:
    """darknet's reorg as a flat NCHW permutation, out_flat[i] =
    in_flat[perm[i]].  darknet reinterprets the (c, h, w) input buffer as
    (c/s^2, h*s, w*s) and gathers from it; the result is not a
    space-to-depth, and yolov2 checkpoints depend on its exact order."""
    out_c2 = c // (stride * stride)
    k = np.arange(c).reshape(c, 1, 1)
    j = np.arange(h).reshape(1, h, 1)
    i = np.arange(w).reshape(1, 1, w)
    off, c2 = k // out_c2, k % out_c2
    h2 = j * stride + off // stride
    w2 = i * stride + off % stride
    perm = np.empty(c * h * w, np.int64)
    perm[(i + w * (j + h * k)).reshape(-1)] = (w2 + w * stride * (h2 + h * stride * c2)).reshape(-1)
    return perm


@functools.lru_cache(maxsize=64)
def _reorg_index(h: int, w: int, c: int, stride: int, reverse: bool, device: torch.device):
    """The (gather, inverse) index pair on ``device``, built once per shape
    (outside ``inference_mode``: a later training step saves the inverse
    for backward, which an inference tensor cannot be)."""
    perm = _reorg_permutation(h, w, c, stride)
    inv = np.argsort(perm)
    fwd, back = (inv, perm) if reverse else (perm, inv)
    with torch.inference_mode(False):
        return (torch.from_numpy(fwd).to(device), torch.from_numpy(back).to(device))


class _Gather(torch.autograd.Function):
    """x[:, index] along dim 1 for a permutation ``index``; the gradient is
    the gather by the inverse permutation (no scatter)."""

    @staticmethod
    def forward(ctx, x, index, inverse):
        ctx.save_for_backward(inverse)
        return x.index_select(1, index)

    @staticmethod
    def backward(ctx, g):
        (inverse,) = ctx.saved_tensors
        return g.index_select(1, inverse), None, None


def reorg(x: torch.Tensor, stride: int, reverse: bool = False) -> torch.Tensor:
    """darknet [reorg] on NHWC: the flat NCHW gather of
    ``_reorg_permutation`` ((N, H, W, C) -> (N, H/s, W/s, C*s^2)), or with
    ``reverse`` its inverse ((N, H*s, W*s, C/s^2))."""
    n, h, w, c = x.shape
    if reverse:
        out_shape = (n, c // (stride * stride), h * stride, w * stride)
    else:
        out_shape = (n, c * stride * stride, h // stride, w // stride)
    index, inverse = _reorg_index(h, w, c, stride, reverse, x.device)
    flat = x.permute(0, 3, 1, 2).reshape(n, -1)
    return _Gather.apply(flat, index, inverse).reshape(out_shape).permute(0, 2, 3, 1)


def lrn(x: torch.Tensor, size: int, alpha: float, beta: float, kappa: float) -> torch.Tensor:
    """Local response normalization across channels:
    x / (kappa + alpha * sum over the window of x^2)^beta."""
    sq = x * x
    c = x.shape[-1]
    half = size // 2
    padded = F.pad(sq, (half, half))
    window = 0
    for i in range(size):  # summed in the reference's order
        window = window + padded[..., i : i + c]
    return x / (kappa + alpha * window) ** beta


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Channel-wise L2 normalization."""
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def crop(x: torch.Tensor, crop_h: int, crop_w: int, *, train: bool = False,
         generator: torch.Generator | None = None, flip: bool = False) -> torch.Tensor:
    """darknet's crop layer: the centre crop, or at training time (with a
    generator) a random offset and, with ``flip``, a random horizontal flip
    of the whole batch, drawn from ``generator``."""
    n, h, w, c = x.shape
    if train and generator is not None:
        dev = generator.device
        dy = int(torch.randint(0, max(h - crop_h, 0) + 1, (), generator=generator, device=dev))
        dx = int(torch.randint(0, max(w - crop_w, 0) + 1, (), generator=generator, device=dev))
        do_flip = bool(torch.rand((), generator=generator, device=dev) < 0.5)
        out = x[:, dy : dy + crop_h, dx : dx + crop_w, :]
        return out.flip(2) if flip and do_flip else out
    dy, dx = (h - crop_h) // 2, (w - crop_w) // 2
    return x[:, dy : dy + crop_h, dx : dx + crop_w, :]


def _patches(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """(N, Ho*Wo, C*size*size) patches of an NHWC map, each in (c, ky, kx)
    order (channel slowest), from strided views: their gradient is a sum of
    slices, with no scatter."""
    n, h, w, c = x.shape
    oh, ow = (h - size) // stride + 1, (w - size) // stride + 1
    cols = torch.stack([x[:, ky : ky + (oh - 1) * stride + 1 : stride,
                          kx : kx + (ow - 1) * stride + 1 : stride, :]
                        for ky in range(size) for kx in range(size)], dim=-1)
    return cols.reshape(n, oh * ow, c * size * size)


def local_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, size: int,
               stride: int, pad: int) -> torch.Tensor:
    """Locally connected layer (untied weights per output position):
    w (Ho*Wo, size*size*Cin, Cout), bias (Ho*Wo, Cout); zero padding."""
    n, h, wd, _ = x.shape
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    oh, ow = (h + 2 * pad - size) // stride + 1, (wd + 2 * pad - size) // stride + 1
    patches = _patches(x, size, stride).transpose(0, 1)     # (P, N, K)
    out = _Matmul.apply(patches, w).transpose(0, 1) + bias  # (N, P, O)
    return out.reshape(n, oh, ow, -1)


def deconv2d(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """darknet's transpose conv (no padding), as the reference computes it:
    the input dilated by ``stride``, padded by (k - 1, k + s - 2 + max(k - s,
    0) - (k - 1)) and correlated with the HWIO kernel as it is (not
    flipped); out = (in - 1)*s + k for k >= s."""
    n, h, wd, c = x.shape
    k = w.shape[0]
    if stride > 1:
        xd = x.new_zeros((n, (h - 1) * stride + 1, (wd - 1) * stride + 1, c))
        xd[:, ::stride, ::stride, :] = x
    else:
        xd = x
    lo = k - 1
    hi = k + stride - 2 + max(k - stride, 0) - lo
    return conv2d(F.pad(xd, (0, 0, lo, hi, lo, hi)), w, 1, 0)
