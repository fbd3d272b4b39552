"""The port's s2d stem stage (plain version and K2 wrapper) equals the JAX
package's Pallas s2d kernel and its conv -> requant -> maxpool, bit for bit;
the CUDA kernel equals the plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_quantization_tpu.infer.convert import _s2d_weights as j_s2d_weights
from yolo_quantization_tpu.ops import qconv as jqconv
from yolo_quantization_tpu.ops.pallas_qconv import pallas_s2d_conv_phase_max
from yolo_quantization_tpu_torch.infer.convert import _s2d_weights
from yolo_quantization_tpu_torch.ops import cuda_s2d
from yolo_quantization_tpu_torch.ops import qconv as tqconv
from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY, ACT_LINEAR, ACT_RELU, ACT_RELU6

torch.set_num_threads(2)


def _case(rng, n, h, w, ci, co, per_image=False):
    """A random stem stage: NHWC codes, original 3x3 weights, bias, m, zero points."""
    x = rng.integers(-128, 128, (n, h, w, ci)).astype(np.int8)
    w_orig = rng.integers(-127, 128, (3, 3, ci, co)).astype(np.int8)
    shape = (n, co) if per_image else (co,)
    bias = rng.integers(-4000, 4000, shape).astype(np.int32)
    m = rng.uniform(0.002, 0.03, shape).astype(np.float32)
    x_zp = rng.integers(-128, 0, (n,)).astype(np.int32) if per_image else int(rng.integers(-128, 0))
    out_zp = int(rng.integers(0, 32))
    return x, w_orig, bias, m, x_zp, out_zp


def _t(a):
    return torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a


# the shapes of tests/test_pallas_s2d.py
PALLAS_SHAPES = [
    (1, 16, 16, 3, 16, ACT_RELU6),   # conv0-shaped
    (2, 20, 28, 16, 32, ACT_LEAKY),  # conv2-shaped, non-square
    (1, 12, 20, 32, 64, ACT_LINEAR), # conv4-shaped
    (1, 52, 52, 3, 16, ACT_RELU6),   # W2=26 > one row tile case
]


@pytest.mark.parametrize("n,h,w,ci,co,act", PALLAS_SHAPES)
def test_plain_matches_pallas_s2d_kernel(rng, n, h, w, ci, co, act):
    x, w_orig, bias, m, x_zp, out_zp = _case(rng, n, h, w, ci, co)
    w_s2d = _s2d_weights(w_orig)
    np.testing.assert_array_equal(w_s2d, j_s2d_weights(w_orig))
    xs = tqconv.space_to_depth(torch.from_numpy(x))
    got = tqconv.s2d_conv_phase_max(xs, torch.from_numpy(w_s2d), _t(bias), _t(m), x_zp, out_zp,
                                    act=act).numpy()
    want = pallas_s2d_conv_phase_max(
        jnp.asarray(xs.numpy()), jnp.asarray(w_s2d), jnp.asarray(bias), jnp.asarray(m),
        jnp.int32(x_zp), act=act, out_zp_static=out_zp, interpret=True,
    )
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, np.asarray(want))


def test_space_to_depth_matches_the_reference_layout(rng):
    x = rng.integers(-128, 128, (2, 6, 10, 3)).astype(np.int8)
    n, h, w, c = x.shape
    want = x.reshape(n, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5).reshape(
        n, h // 2, w // 2, 4 * c)
    np.testing.assert_array_equal(tqconv.space_to_depth(torch.from_numpy(x)).numpy(), want)
    with pytest.raises(ValueError, match="even"):
        tqconv.space_to_depth(torch.zeros((1, 5, 6, 3), dtype=torch.int8))


@pytest.mark.parametrize("per_image", [False, True])
@pytest.mark.parametrize("act,exact_leaky", [
    (ACT_LINEAR, False), (ACT_LEAKY, False), (ACT_LEAKY, True), (ACT_RELU, False), (ACT_RELU6, False),
])
def test_wrapper_equals_conv_requant_pool(rng, act, exact_leaky, per_image):
    """The K2 wrapper's CPU path equals the original-space conv -> requant ->
    2x2/s2 maxpool of the JAX package, per-image zero points and bias/m
    included, and launches nothing."""
    from yolo_quantization_tpu.nn import layers as jlayers

    n, h, w, ci, co = 2, 10, 14, 6, 8
    x, w_orig, bias, m, x_zp, out_zp = _case(rng, n, h, w, ci, co, per_image)
    before = cuda_s2d.launches
    got = cuda_s2d.s2d_conv_phase_max_cuda(
        torch.from_numpy((x.astype(np.int16) + 128).astype(np.uint8)),  # the same codes, as uint8
        torch.from_numpy(_s2d_weights(w_orig)), _t(bias),
        _t(m), _t(x_zp), act=act, out_zp_static=out_zp, exact_leaky=exact_leaky,
    ).numpy()
    assert cuda_s2d.launches == before
    if per_image:  # the JAX op takes one zero point: run it image by image
        want = np.concatenate([
            np.asarray(jlayers.maxpool_u8(jqconv.quantized_conv2d(
                jnp.asarray(x[i : i + 1]), jnp.asarray(w_orig), jnp.asarray(bias[i : i + 1]),
                jnp.asarray(m[i : i + 1]), jnp.int32(x_zp[i]), jnp.zeros(co, jnp.int32),
                jnp.int32(out_zp), stride=1, pad=1, act=act, symmetric=True, out_i8=True,
                exact_leaky=exact_leaky), 2, 2, 1))
            for i in range(n)
        ])
    else:
        want = np.asarray(jlayers.maxpool_u8(jqconv.quantized_conv2d(
            jnp.asarray(x), jnp.asarray(w_orig), jnp.asarray(bias), jnp.asarray(m),
            jnp.int32(x_zp), jnp.zeros(co, jnp.int32), jnp.int32(out_zp), stride=1, pad=1,
            act=act, symmetric=True, out_i8=True, exact_leaky=exact_leaky), 2, 2, 1))
    np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_bad_shapes():
    x = torch.zeros((1, 6, 6, 3), dtype=torch.int8)
    w = torch.zeros((3, 3, 12, 16), dtype=torch.int8)
    b, m = torch.zeros(4, dtype=torch.int32), torch.ones(4)
    with pytest.raises(ValueError, match="even"):
        cuda_s2d.s2d_conv_phase_max_cuda(x[:, :5], w, b, m, 0)
    with pytest.raises(ValueError, match="does not fit"):
        cuda_s2d.s2d_conv_phase_max_cuda(x, w[:, :, :8], b, m, 0)
    with pytest.raises(ValueError, match="zero points for"):
        cuda_s2d.s2d_conv_phase_max_cuda(x, w, b, m, torch.zeros(2, dtype=torch.int32))


def test_pack_weights_layout():
    w = torch.arange(3 * 3 * 8 * 12, dtype=torch.int32).reshape(3, 3, 8, 12).to(torch.int8)
    p = cuda_s2d.pack_weights(w)
    assert p.shape == (4, 3, 3, 3, 8) and p.is_contiguous()
    for ph in range(4):
        for o in range(3):
            assert torch.equal(p[ph, o], w[..., ph * 3 + o])


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,ci,co,act", PALLAS_SHAPES + [
    (2, 30, 22, 5, 24, ACT_LEAKY), (2, 104, 104, 32, 64, ACT_RELU6),
])
@pytest.mark.parametrize("per_image", [False, True])
def test_cuda_kernel_matches_plain(rng, n, h, w, ci, co, act, per_image):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    x, w_orig, bias, m, x_zp, out_zp = _case(rng, n, h, w, ci, co, per_image)
    args = [torch.from_numpy(x), torch.from_numpy(_s2d_weights(w_orig)), _t(bias), _t(m), _t(x_zp)]
    kw = dict(act=act, out_zp_static=out_zp, exact_leaky=act == ACT_LEAKY)
    ref = cuda_s2d.s2d_conv_phase_max_cuda(*args, **kw)
    before = cuda_s2d.launches
    got = cuda_s2d.s2d_conv_phase_max_cuda(
        *[a.cuda() if isinstance(a, torch.Tensor) else a for a in args], **kw)
    torch.cuda.synchronize()
    assert cuda_s2d.launches == before + 1
    assert torch.equal(got.cpu(), ref)
