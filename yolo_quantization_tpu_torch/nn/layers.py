"""Layer primitives (NHWC): the float layers of QAT training and float
inference, and the integer maxpool and upsample of the engine.

The counterpart of ``yolo_quantization_tpu/nn/layers.py`` (darknet's layer
forwards).  Convolutions take NHWC inputs and HWIO kernels, as the reference
does; ``conv2d`` hands them to ``F.conv2d`` as channels-last views.

Gradients follow the reference's autodiff: a max or min of two equal values
splits the gradient in halves (``torch.maximum``/``torch.minimum``, not
``torch.clamp``, whose gradient passes whole at the bounds), and a float
maxpool window gives a tie's whole gradient to its first element
(``F.max_pool2d`` over a ``-inf``-padded map).  The extended darknet layers
(connected, softmax, reorg, ...) belong to the yolov2/yolov1 models (ROADMAP
queue 1.8).
"""

from __future__ import annotations

import contextlib

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
