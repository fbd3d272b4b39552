"""The port's plain integer conv equals the JAX XLA path and the Pallas kernel,
bit for bit; the CUDA kernel equals the plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_quantization_tpu.nn import layers as jlayers
from yolo_quantization_tpu.ops import qconv as jqconv
from yolo_quantization_tpu.ops.pallas_qconv import pallas_quantized_conv2d
from yolo_quantization_tpu_torch.nn import layers as tlayers
from yolo_quantization_tpu_torch.ops import cuda_qconv
from yolo_quantization_tpu_torch.ops import qconv as tqconv
from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY, ACT_LINEAR, ACT_RELU, ACT_RELU6

torch.set_num_threads(2)


def make_inputs(rng, n=1, h=13, ci=32, co=64, k=3):
    x = rng.integers(0, 256, (n, h, h, ci), dtype=np.uint8)
    w = rng.integers(-127, 128, (k, k, ci, co)).astype(np.int8)
    bias = rng.integers(-(2**14), 2**14, (co,)).astype(np.int32)
    m = rng.uniform(1e-4, 5e-3, (co,)).astype(np.float32)
    return x, w, bias, m


def port_conv(x, w, bias, m, x_zp, out_zp, **kw):
    return tqconv.quantized_conv2d(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
        torch.from_numpy(m), x_zp, None, out_zp, symmetric=True, **kw,
    ).numpy()


# the parametrization of tests/test_pallas_qconv.py, plus the 3-channel stem,
# every activation and both output representations
CASES = [
    (13, 32, 64, 3, 1, ACT_LEAKY, False),
    (13, 256, 30, 1, 0, ACT_LINEAR, False),
    (26, 16, 48, 3, 1, ACT_RELU6, False),
    (20, 8, 130, 3, 1, ACT_LINEAR, False),
    (52, 16, 32, 3, 1, ACT_RELU6, False),
    (72, 8, 16, 3, 1, ACT_LINEAR, False),
    (96, 12, 24, 3, 1, ACT_LEAKY, False),
    (20, 3, 16, 3, 1, ACT_LINEAR, True),
    (20, 3, 16, 3, 1, ACT_LEAKY, False),
    (20, 3, 16, 3, 1, ACT_RELU, True),
    (20, 3, 16, 3, 1, ACT_RELU6, False),
    (13, 16, 40, 1, 0, ACT_RELU, False),
    (13, 32, 64, 3, 1, ACT_RELU6, True),
]


@pytest.mark.parametrize("h,ci,co,k,pad,act,out_i8", CASES)
def test_plain_matches_xla_and_pallas(rng, h, ci, co, k, pad, act, out_i8):
    x, w, bias, m = make_inputs(rng, h=h, ci=ci, co=co, k=k)
    x_zp, out_zp = 7, 111
    got = port_conv(x, w, bias, m, x_zp, out_zp, stride=1, pad=pad, act=act, out_i8=out_i8)
    ref = jqconv.quantized_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), jnp.asarray(m), jnp.int32(x_zp),
        jnp.zeros((co,), jnp.int32), jnp.int32(out_zp),
        stride=1, pad=pad, act=act, symmetric=True, out_i8=out_i8,
    )
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got.dtype == np.asarray(ref).dtype
    if ci >= 8:  # the Pallas kernel's own test range; it pads Ci to 128 lanes
        pal = pallas_quantized_conv2d(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), jnp.asarray(m), jnp.int32(x_zp),
            stride=1, pad=pad, act=act, out_zp_static=out_zp, interpret=True, out_i8=out_i8,
        )
        np.testing.assert_array_equal(got, np.asarray(pal))


@pytest.mark.parametrize("h,ci,act", [(16, 16, ACT_LEAKY), (72, 16, ACT_RELU6), (20, 3, ACT_LINEAR)])
def test_plain_pool_matches_pallas_fuse_pool(rng, h, ci, act):
    x, w, bias, m = make_inputs(rng, h=h, ci=ci, co=32, k=3)
    got = tqconv.quantized_conv2d_pool(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
        torch.from_numpy(m), 5, 100, pad=1, act=act,
    ).numpy()
    if ci >= 8:
        ref = pallas_quantized_conv2d(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), jnp.asarray(m), jnp.int32(5),
            stride=1, pad=1, act=act, out_zp_static=100, fuse_pool=True, interpret=True,
        )
    else:
        conv = jqconv.quantized_conv2d(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), jnp.asarray(m), jnp.int32(5),
            jnp.zeros((32,), jnp.int32), jnp.int32(100), stride=1, pad=1, act=act, symmetric=True,
        )
        ref = jlayers.maxpool_u8(conv, 2, 2, 1)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("stride,pad,k", [(1, 1, 3), (2, 1, 3), (1, 0, 1), (2, 0, 3)])
def test_asymmetric_acc_and_conv_match(rng, stride, pad, k):
    x = rng.integers(-128, 128, (2, 15, 15, 12), dtype=np.int8)
    w = rng.integers(-128, 128, (k, k, 12, 20), dtype=np.int8)
    w_zp = rng.integers(-128, 128, (20,)).astype(np.int32)
    got = tqconv.conv_acc_int32(torch.from_numpy(x), torch.from_numpy(w), -9,
                                torch.from_numpy(w_zp), stride, pad).numpy()
    ref = jqconv.conv_acc_int32(jnp.asarray(x), jnp.asarray(w), jnp.int32(-9),
                                jnp.asarray(w_zp), stride, pad)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert got.dtype == np.int32
    bias = rng.integers(-(2**14), 2**14, (20,)).astype(np.int32)
    m = rng.uniform(1e-5, 1e-3, (20,)).astype(np.float32)
    got = tqconv.quantized_conv2d(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias), torch.from_numpy(m),
        -9, torch.from_numpy(w_zp), 60, stride=stride, pad=pad, act=ACT_LEAKY,
    ).numpy()
    ref = jqconv.quantized_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), jnp.asarray(m), jnp.int32(-9),
        jnp.asarray(w_zp), jnp.int32(60), stride=stride, pad=pad, act=ACT_LEAKY,
    )
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("exact_leaky", [False, True])
@pytest.mark.parametrize("per_image", [False, True])
def test_requant_activate_matches(rng, exact_leaky, per_image):
    acc = rng.integers(-(2**20), 2**20, (2, 5, 5, 24)).astype(np.int32)
    shape = (2, 24) if per_image else (24,)
    bias = rng.integers(-(2**12), 2**12, shape).astype(np.int32)
    # power-of-two multipliers put many values exactly on .5: round-half-even ties
    m = (2.0 ** rng.integers(-14, -8, shape)).astype(np.float32)
    for act in (ACT_LINEAR, ACT_LEAKY, ACT_RELU, ACT_RELU6):
        for out_i8 in (False, True):
            got = tqconv.requant_activate(
                torch.from_numpy(acc), torch.from_numpy(bias), torch.from_numpy(m), 77, act,
                out_i8=out_i8, exact_leaky=exact_leaky,
            ).numpy()
            ref = jqconv.requant_activate(
                jnp.asarray(acc), jnp.asarray(bias), jnp.asarray(m), jnp.int32(77), act,
                out_i8=out_i8, exact_leaky=exact_leaky,
            )
            np.testing.assert_array_equal(got, np.asarray(ref), err_msg=f"act {act} i8 {out_i8}")


def test_u8_to_i8_matches():
    x = np.arange(256, dtype=np.uint8)
    got = tqconv.u8_to_i8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jqconv.u8_to_i8(jnp.asarray(x))))


@pytest.mark.parametrize("h,size,stride,dtype", [
    (13, 2, 1, np.int8), (26, 2, 2, np.int8), (16, 2, 2, np.uint8), (9, 3, 2, np.uint8),
])
def test_maxpool_and_upsample_match(rng, h, size, stride, dtype):
    x = rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max + 1, (2, h, h, 5)).astype(dtype)
    for pad in (size - 1, 0):
        got = tlayers.maxpool_u8(torch.from_numpy(x), size, stride, pad).numpy()
        ref = jlayers.maxpool_u8(jnp.asarray(x), size, stride, pad)
        np.testing.assert_array_equal(got, np.asarray(ref))
        assert tlayers.maxpool_padding(h, size, stride, pad) == jlayers.maxpool_padding(h, size, stride, pad)
    got = tlayers.upsample_nearest(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlayers.upsample_nearest(jnp.asarray(x), 2)))


@pytest.mark.parametrize("fuse_pool", [False, True])
def test_wrapper_on_cpu_runs_the_plain_version(rng, fuse_pool):
    """A CPU tensor takes the plain path and launches nothing."""
    x, w, bias, m = make_inputs(rng, h=16, ci=3, co=16)
    args = [torch.from_numpy(a) for a in (x, w, bias, m)]
    before = cuda_qconv.launches
    got = cuda_qconv.quantized_conv2d_cuda(*args, 4, pad=1, act=ACT_RELU6, out_zp_static=9,
                                           fuse_pool=fuse_pool, out_i8=True)
    if fuse_pool:
        ref = tqconv.quantized_conv2d_pool(*args, 4, 9, pad=1, act=ACT_RELU6, out_i8=True)
    else:
        ref = tqconv.quantized_conv2d(*args, 4, None, 9, pad=1, act=ACT_RELU6, symmetric=True,
                                      out_i8=True)
    assert torch.equal(got, ref)
    got2 = cuda_qconv.quantized_conv2d_cuda(*args, 4, stride=2, pad=1, act=ACT_RELU6, out_zp_static=9)
    assert got2.shape == (1, 8, 8, 16)
    assert torch.equal(got2, tqconv.quantized_conv2d(*args, 4, None, 9, stride=2, pad=1, act=ACT_RELU6,
                                                     symmetric=True))
    assert cuda_qconv.launches == before
    with pytest.raises(ValueError, match="stride 1"):
        cuda_qconv.quantized_conv2d_cuda(*args, 4, stride=2, pad=1, fuse_pool=True)
    with pytest.raises(ValueError, match="stride 3"):
        cuda_qconv.quantized_conv2d_cuda(*args, 4, stride=3, pad=1)
    odd = args[0][:, :15, :15].contiguous()
    with pytest.raises(ValueError, match="even"):
        cuda_qconv.quantized_conv2d_cuda(odd, *args[1:], 4, pad=1, fuse_pool=True)


def _option_inputs(rng, variant, n=2, h=12, ci=6, co=24):
    """Seeded conv inputs for one K1 option: asymmetric weight zero points,
    per-image zero points with (N, Co) bias/m, exact_leaky, or int16."""
    x, w, bias, m = make_inputs(rng, n=n, h=h, ci=ci, co=co)
    kw = dict(act=ACT_LEAKY, exact_leaky=variant in ("exact_leaky", "all"),
              carrier="int16" if variant in ("int16", "all") else "int8")
    w_zp = rng.integers(-128, 128, (co,)).astype(np.int32) if variant in ("asym", "all") else None
    if variant in ("per_image", "all"):
        x_zp = rng.integers(-128, 128, (n,)).astype(np.int32)
        bias = rng.integers(-(2**14), 2**14, (n, co)).astype(np.int32)
        m = rng.uniform(1e-4, 5e-3, (n, co)).astype(np.float32)
    else:
        x_zp = 7
    return x, w, bias, m, x_zp, w_zp, kw


VARIANTS = ["asym", "per_image", "exact_leaky", "int16", "all"]


@pytest.mark.parametrize("fuse_pool", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_wrapper_options_match_jax(rng, variant, fuse_pool):
    """The K1 wrapper's CPU path with each reference-engine option equals the
    JAX package's XLA conv (then maxpool), image by image for per-image
    zero points."""
    x, w, bias, m, x_zp, w_zp, kw = _option_inputs(rng, variant)
    t = lambda a: None if a is None else (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)  # noqa: E731
    got = cuda_qconv.quantized_conv2d_cuda(
        t(x), t(w), t(bias), t(m), t(x_zp), pad=1, out_zp_static=90, fuse_pool=fuse_pool,
        out_i8=True, w_zp=t(w_zp), **kw).numpy()
    wants = []
    for i in range(x.shape[0]):
        per = bias.ndim == 2
        y = jqconv.quantized_conv2d(
            jnp.asarray(x[i : i + 1]), jnp.asarray(w),
            jnp.asarray(bias[i : i + 1] if per else bias), jnp.asarray(m[i : i + 1] if per else m),
            jnp.int32(x_zp[i] if isinstance(x_zp, np.ndarray) else x_zp),
            jnp.asarray(w_zp if w_zp is not None else np.zeros(w.shape[-1], np.int32)),
            jnp.int32(90), stride=1, pad=1, symmetric=w_zp is None, out_i8=True, **kw)
        wants.append(np.asarray(jlayers.maxpool_u8(y, 2, 2, 1) if fuse_pool else y))
    np.testing.assert_array_equal(got, np.concatenate(wants))


def test_int16_carrier_acc_matches_jax(rng):
    x = rng.integers(-128, 128, (2, 9, 9, 12), dtype=np.int8)
    w = rng.integers(-128, 128, (3, 3, 12, 20), dtype=np.int8)
    w_zp = rng.integers(-128, 128, (20,)).astype(np.int32)
    for stride in (1, 2):
        got = tqconv.conv_acc_int32(torch.from_numpy(x), torch.from_numpy(w), 11,
                                    torch.from_numpy(w_zp), stride, 1, carrier="int16").numpy()
        ref = jqconv.conv_acc_int32(jnp.asarray(x), jnp.asarray(w), jnp.int32(11),
                                    jnp.asarray(w_zp), stride, 1, carrier="int16")
        np.testing.assert_array_equal(got, np.asarray(ref))
    with pytest.raises(ValueError, match="carrier"):
        tqconv.conv_acc_int32(torch.from_numpy(x), torch.from_numpy(w), 0, None, 1, 1,
                              symmetric=True, carrier="int4")


def test_pack_weights_layout():
    w = torch.arange(3 * 3 * 5 * 30, dtype=torch.int32).remainder(251).sub(125).to(torch.int8)
    w = w.reshape(3, 3, 5, 30)
    p = cuda_qconv.pack_weights(w)
    assert p.shape == (32, 64) == cuda_qconv.packed_shape(3, 5, 30) and p.is_contiguous()
    # row o, column (ky*3 + kx)*Cin + ci: the HWIO flatten order, K contiguous
    for ky, kx, ci, o in ((0, 0, 0, 0), (1, 2, 4, 7), (2, 2, 4, 29), (2, 1, 3, 13)):
        assert p[o, (ky * 3 + kx) * 5 + ci] == w[ky, kx, ci, o]
    assert torch.equal(p[:30, :45], w.reshape(45, 30).t())
    assert not p[30:].any() and not p[:, 45:].any()  # Co 30 -> 32, K 45 -> 64 with zeros


def _im2col(x_i8, k, pad, x_zp):
    """Numpy im2col of shifted codes (stride 1): rows are output pixels (n,
    y, x), columns the window in HWIO flatten order (ky, kx, ci), padding
    taps at the input zero point, K zero-padded to a multiple of 32."""
    n, h, w, ci = x_i8.shape
    xp = np.full((n, h + 2 * pad, w + 2 * pad, ci), x_zp, np.int64)
    xp[:, pad:pad + h, pad:pad + w] = x_i8
    ho, wo = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    cols = [xp[:, ky:ky + ho, kx:kx + wo] for ky in range(k) for kx in range(k)]
    a = np.concatenate(cols, axis=-1).reshape(n * ho * wo, k * k * ci)
    return np.pad(a, ((0, 0), (0, -a.shape[1] % 32))), (n, ho, wo)


def _wrap_i32(v):
    return ((np.asarray(v, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("ci", [3, 16, 64])
def test_implicit_gemm_matches_jax_conv_acc(rng, ci, k, symmetric):
    """The kernel's GEMM view: the im2col rows times the packed weights,
    minus w_zp[o] times each row's sum (the patchsum, K padding at code 0),
    equals the JAX package's conv_acc_int32."""
    x = rng.integers(-128, 128, (2, 7, 9, ci), dtype=np.int8)
    w = rng.integers(-128, 128, (k, k, ci, 20), dtype=np.int8)
    w_zp = rng.integers(-128, 128, (20,)).astype(np.int32)
    pad, x_zp = k // 2, -37
    a, (n, ho, wo) = _im2col(x, k, pad, x_zp)
    b = cuda_qconv.pack_weights(torch.from_numpy(w)).numpy().astype(np.int64)
    assert b.shape == (32, a.shape[1])
    acc = (a @ b.T)[:, :20]
    assert not (a @ b.T)[:, 20:].any()  # padded output channels hold zero weights
    if not symmetric:
        acc = acc - w_zp.astype(np.int64) * a.sum(axis=1, keepdims=True)
    got = _wrap_i32(acc).reshape(n, ho, wo, 20)
    ref = jqconv.conv_acc_int32(jnp.asarray(x), jnp.asarray(w), jnp.int32(x_zp),
                                jnp.asarray(w_zp), 1, pad, symmetric=symmetric)
    np.testing.assert_array_equal(got, np.asarray(ref))


def _k1_rows_stride(x_i8, k, pad, stride, x_zp):
    """K1's A operand at any stride, element by element as its loaders fill
    it: GEMM row r is output pixel (img, oy, ox) in NHWC order, its window
    origin input pixel (oy * stride, ox * stride); K index kk is tap kk // Ci
    (dy, dx) = divmod(tap, k), channel kk % Ci; a pixel outside the map is
    the zero point, K past k*k*Ci code 0.  Geometry (H + 2 pad - k) //
    stride + 1."""
    n, h, w, ci = x_i8.shape
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    r = np.arange(n * ho * wo)
    img, rem = np.divmod(r, ho * wo)
    oy, ox = np.divmod(rem, wo)
    k_real = k * k * ci
    kk = np.arange(k_real + -k_real % 32)
    tap, c = np.divmod(np.minimum(kk, k_real - 1), ci)
    dy, dx = np.divmod(tap, k)
    iy = (oy * stride)[:, None] + dy[None, :] - pad
    ix = (ox * stride)[:, None] + dx[None, :] - pad
    inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    vals = x_i8[img[:, None], np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1), c[None, :]].astype(np.int64)
    a = np.where(inside, vals, x_zp)
    a[:, kk >= k_real] = 0
    return a, (n, ho, wo)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("ci", [3, 16, 64])
@pytest.mark.parametrize("h,w,k,pad", [(13, 13, 3, 1), (9, 11, 3, 1), (8, 10, 3, 1), (7, 6, 1, 0)])
def test_stride2_rows_match_jax_conv_acc(rng, h, w, k, pad, ci, symmetric):
    """K1's stride-2 row -> pixel map times the packed weights, minus w_zp[o]
    times the row sum (the ASYM patchsum, padding taps included), equals the
    JAX package's conv_acc_int32 at stride 2; odd maps give darknet's odd
    outputs (13 -> 7)."""
    x = rng.integers(-128, 128, (2, h, w, ci), dtype=np.int8)
    wt = rng.integers(-128, 128, (k, k, ci, 20), dtype=np.int8)
    w_zp = rng.integers(-128, 128, (20,)).astype(np.int32)
    x_zp = -37
    a, (n, ho, wo) = _k1_rows_stride(x, k, pad, 2, x_zp)
    assert (ho, wo) == ((h + 2 * pad - k) // 2 + 1, (w + 2 * pad - k) // 2 + 1)
    b = cuda_qconv.pack_weights(torch.from_numpy(wt)).numpy().astype(np.int64)
    acc = (a @ b.T)[:, :20]
    if not symmetric:
        acc = acc - w_zp.astype(np.int64) * a.sum(axis=1, keepdims=True)
    got = _wrap_i32(acc).reshape(n, ho, wo, 20)
    ref = jqconv.conv_acc_int32(jnp.asarray(x), jnp.asarray(wt), jnp.int32(x_zp),
                                jnp.asarray(w_zp), 2, pad, symmetric=symmetric)
    np.testing.assert_array_equal(got, np.asarray(ref))
    # at stride 1 the same map is the im2col above
    np.testing.assert_array_equal(_k1_rows_stride(x, k, pad, 1, x_zp)[0], _im2col(x, k, pad, x_zp)[0])


@pytest.mark.parametrize("n,h,w", [(2, 6, 10), (1, 14, 6), (3, 4, 4)])
def test_pooled_row_order_matches_maxpool(rng, n, h, w):
    """fuse_pool's GEMM row order: row 8q + w of each 32-row group is pixel q
    (dy = q // 2, dx = q % 2) of pooled window w; the max over a window's
    four rows is the JAX 2x2/s2 maxpool of the conv, partial last group
    included."""
    x = rng.integers(-128, 128, (n, h, w, 16), dtype=np.int8)
    wt = rng.integers(-128, 128, (3, 3, 16, 8), dtype=np.int8)
    acc = np.asarray(jqconv.conv_acc_int32(jnp.asarray(x), jnp.asarray(wt), jnp.int32(5),
                                           jnp.zeros((8,), jnp.int32), 1, 1, symmetric=True))
    ph, pw = h // 2, w // 2
    windows = n * ph * pw
    rows = 32 * -(-windows // 8)
    r = np.arange(rows)
    win, q = (r // 32) * 8 + r % 8, (r // 8) % 4
    valid = win < windows
    img, rem = np.divmod(win[valid], ph * pw)
    py, px = np.divmod(rem, pw)
    gemm = acc[img, 2 * py + q[valid] // 2, 2 * px + q[valid] % 2]
    pooled = np.full((windows, 8), np.iinfo(np.int32).min, np.int32)
    np.maximum.at(pooled, win[valid], gemm)
    ref = np.asarray(jlayers.maxpool_u8(jnp.asarray(acc), 2, 2, 1))
    np.testing.assert_array_equal(pooled.reshape(n, ph, pw, 8), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("h,ci,co,k,pad,act,out_i8", CASES)
@pytest.mark.parametrize("fuse_pool", [False, True])
def test_cuda_kernel_matches_plain(rng, h, ci, co, k, pad, act, out_i8, fuse_pool):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    if fuse_pool and (h + 2 * pad - k + 1) % 2:
        pytest.skip("fuse_pool needs even conv output dims")
    x, w, bias, m = make_inputs(rng, n=2, h=h, ci=ci, co=co, k=k)
    args = [torch.from_numpy(a) for a in (x, w, bias, m)]
    if fuse_pool:
        ref = tqconv.quantized_conv2d_pool(*args, 7, 111, pad=pad, act=act, out_i8=out_i8)
    else:
        ref = tqconv.quantized_conv2d(*args, 7, None, 111, pad=pad, act=act, symmetric=True,
                                      out_i8=out_i8)
    before = cuda_qconv.launches
    got = cuda_qconv.quantized_conv2d_cuda(*[a.cuda() for a in args], 7, pad=pad, act=act,
                                           out_zp_static=111, fuse_pool=fuse_pool, out_i8=out_i8)
    torch.cuda.synchronize()
    assert cuda_qconv.launches == before + 1
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse_pool", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("ci", [3, 64])
def test_cuda_kernel_options_match_plain(rng, variant, fuse_pool, ci):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    x, w, bias, m, x_zp, w_zp, kw = _option_inputs(rng, variant, h=18, ci=ci, co=40)
    args = [None if a is None else torch.from_numpy(np.asarray(a)) for a in (x, w, bias, m, x_zp, w_zp)]
    call = dict(pad=1, out_zp_static=90, fuse_pool=fuse_pool, out_i8=False, **kw)
    ref = cuda_qconv.quantized_conv2d_cuda(*args[:5], w_zp=args[5], **call)
    cu = [None if a is None else a.cuda() for a in args]
    got = cuda_qconv.quantized_conv2d_cuda(*cu[:5], w_zp=cu[5], **call)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)


# shapes at the kernel's tile edges, by the block tile the launch table
# gives them on a 132-SM card: Co 30 and 130 (padded and partial N tiles),
# Ci 3 and 6, 16, 32 and 64, M not a multiple of the tile, pooled layers
# whose last 32-row group is partial
EDGES = [
    # n, h, w, ci, co, k, pad, fuse_pool
    # the byte gather (Ci % 16 != 0): 128x32 and 128x16
    (1, 7, 9, 3, 30, 3, 1, False),
    (2, 10, 6, 3, 130, 3, 1, True),
    (3, 9, 11, 6, 30, 3, 1, False),
    (1, 6, 14, 6, 130, 3, 1, True),
    (2, 9, 13, 3, 16, 3, 1, False),
    # the pooled 3-channel stem's window loader: 512x16
    (3, 10, 14, 3, 16, 3, 1, True),
    # 16-byte copies, Co <= 16: 128x16
    (2, 26, 26, 16, 16, 3, 1, True),
    # Co <= 32: 64x32 (fewer blocks than SMs at 128x32), then 128x32
    (2, 13, 13, 16, 30, 1, 0, False),
    (3, 22, 18, 16, 30, 3, 1, True),
    (6, 50, 60, 16, 30, 3, 1, False),
    # Co <= 64: 64x64, then 128x64
    (9, 20, 20, 16, 64, 3, 1, False),
    (2, 12, 12, 32, 64, 3, 1, True),
    (27, 22, 30, 32, 64, 3, 1, True),
    # Co > 64: 64x64, then 128x128
    (1, 11, 5, 16, 130, 3, 1, False),
    (1, 5, 3, 64, 130, 3, 1, False),
    (13, 26, 26, 32, 130, 1, 0, False),
    (7, 42, 58, 16, 130, 3, 1, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("asym", [False, True])
@pytest.mark.parametrize("n,h,w,ci,co,k,pad,fuse_pool", EDGES)
def test_cuda_kernel_tile_edges(rng, n, h, w, ci, co, k, pad, fuse_pool, asym):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    x = rng.integers(-128, 128, (n, h, w, ci), dtype=np.int8)
    wt = rng.integers(-128, 128, (k, k, ci, co), dtype=np.int8)
    bias = rng.integers(-(2**14), 2**14, (co,)).astype(np.int32)
    m = (rng.uniform(0.5, 2.0, (co,)) * 40.0 / (np.sqrt(k * k * ci) * 5300.0)).astype(np.float32)
    w_zp = rng.integers(-128, 128, (co,)).astype(np.int32) if asym else None
    args = [torch.from_numpy(a) for a in (x, wt, bias, m)]
    zp_t = None if w_zp is None else torch.from_numpy(w_zp)
    call = dict(pad=pad, act=ACT_LEAKY, out_zp_static=77, fuse_pool=fuse_pool, out_i8=True)
    ref = cuda_qconv.quantized_conv2d_cuda(*args, -45, w_zp=zp_t, **call)
    got = cuda_qconv.quantized_conv2d_cuda(*[a.cuda() for a in args], -45,
                                           w_zp=None if zp_t is None else zp_t.cuda(), **call)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_cuda_kernel_rejects_unaligned_input():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the alignment check guards the kernel only)")
    n, h, w, ci, co = 1, 6, 6, 16, 16
    flat = torch.zeros(n * h * w * ci + 16, dtype=torch.int8, device="cuda")
    x = flat[1:1 + n * h * w * ci].view(n, h, w, ci)  # contiguous, one byte off
    wt = torch.zeros((3, 3, ci, co), dtype=torch.int8, device="cuda")
    bias = torch.zeros(co, dtype=torch.int32, device="cuda")
    m = torch.ones(co, dtype=torch.float32, device="cuda")
    with pytest.raises(ValueError, match="16-byte boundary"):
        cuda_qconv.quantized_conv2d_cuda(x, wt, bias, m, 0, pad=1)


# K1 at stride 2 (n, h, w, ci, co, k, pad) by loader and by the block tile
# the launch table gives them on a 132-SM card: the byte gather (Ci 3, 6,
# 8), 16-byte copies through L1 (Ci <= 32) and not (Ci 64, 128), each N
# tile, M off the tile, odd maps (13 -> 7), 1x1 at stride 2
STRIDE2_EDGES = [
    (2, 13, 13, 3, 30, 3, 1), (3, 9, 11, 6, 130, 3, 1), (1, 20, 20, 8, 16, 3, 1),
    (2, 26, 26, 16, 16, 3, 1), (1, 13, 13, 16, 30, 3, 1), (8, 50, 60, 32, 30, 3, 1),
    (2, 13, 13, 32, 64, 3, 1), (9, 40, 40, 32, 64, 3, 1), (1, 13, 13, 64, 130, 3, 1),
    (16, 26, 26, 128, 256, 3, 1), (2, 9, 11, 64, 40, 1, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["", "asym", "all"])
@pytest.mark.parametrize("n,h,w,ci,co,k,pad", STRIDE2_EDGES)
def test_cuda_kernel_stride2_matches_plain(rng, n, h, w, ci, co, k, pad, variant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    x = rng.integers(-128, 128, (n, h, w, ci), dtype=np.int8)
    wt = rng.integers(-128, 128, (k, k, ci, co), dtype=np.int8)
    m_scale = 40.0 / (np.sqrt(k * k * ci) * 5300.0)
    if variant == "all":  # per-image zero point and bias/m, exact_leaky, the int16 carrier
        x_zp = torch.from_numpy(rng.integers(-128, 128, (n,)).astype(np.int32))
        bias = rng.integers(-(2**14), 2**14, (n, co)).astype(np.int32)
        m = (rng.uniform(0.5, 2.0, (n, co)) * m_scale).astype(np.float32)
        opts = dict(exact_leaky=True, carrier="int16")
    else:
        x_zp = -45
        bias = rng.integers(-(2**14), 2**14, (co,)).astype(np.int32)
        m = (rng.uniform(0.5, 2.0, (co,)) * m_scale).astype(np.float32)
        opts = {}
    w_zp = torch.from_numpy(rng.integers(-128, 128, (co,)).astype(np.int32)) if variant else None
    args = [torch.from_numpy(a) for a in (x, wt, bias, m)]
    call = dict(stride=2, pad=pad, act=ACT_LEAKY, out_zp_static=77, out_i8=True, **opts)
    ref = cuda_qconv.quantized_conv2d_cuda(*args, x_zp, w_zp=w_zp, **call)
    cu = lambda t: t.cuda() if isinstance(t, torch.Tensor) else t  # noqa: E731
    before = cuda_qconv.launches
    got = cuda_qconv.quantized_conv2d_cuda(*[cu(a) for a in args], cu(x_zp), w_zp=cu(w_zp), **call)
    torch.cuda.synchronize()
    assert cuda_qconv.launches == before + 1
    assert got.shape == ref.shape == (n, (h + 2 * pad - k) // 2 + 1, (w + 2 * pad - k) // 2 + 1, co)
    assert torch.equal(got.cpu(), ref)
