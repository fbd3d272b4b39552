"""The port's quantization core and float layer primitives against the JAX
package's, on the CPU: the fake-quant ops bit for bit in value, mask and
x-gradient (the learned form's range gradients within rtol=1e-6),
nudge/quantize/dequantize/ema_update bit for bit, the LR schedule's float32
value for all seven policies over steps 0-2000, the activations, the float
conv, the BN folds and the float maxpool's tie gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_quantization_tpu.core import quant as jq
from yolo_quantization_tpu.nn import layers as JL
from yolo_quantization_tpu.train import qat as jqat
from yolo_quantization_tpu_torch.core import quant as tq
from yolo_quantization_tpu_torch.nn import layers as TL
from yolo_quantization_tpu_torch.train import qat as tqat

torch.set_num_threads(2)


def _x(rng, n=4096, scale=3.0):
    """Seeded values with grid points, exact .5 ties and values outside the
    range [-1.5, 2.5] of RANGES' first entry mixed in."""
    x = rng.uniform(-scale, scale, n).astype(np.float32)
    step = np.float32(4.0 / 255)
    x[: n // 8] = (rng.integers(-400, 400, n // 8) * step).astype(np.float32)            # on a grid
    x[n // 8 : n // 4] = ((rng.integers(-400, 400, n // 8) + 0.5) * step).astype(np.float32)  # ties
    x[-8:] = [-100.0, 100.0, -1.5, 2.5, 0.0, -0.0, 1e-30, -1e-30]
    return x


RANGES = [(-1.5, 2.5), (0.0, 6.0), (-2.0, 0.0), (0.0, 0.0), (-0.37, 1e-3), (1.0, 4.0), (-7.1, -2.0)]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("lo,hi", RANGES)
def test_nudge_quantize_dequantize_bit_equal(lo, hi):
    rng = np.random.default_rng(0)
    x = _x(rng)
    jqp = jq.nudge_min_max(jnp.float32(lo), jnp.float32(hi))
    tqp = tq.nudge_min_max(torch.tensor(lo), torch.tensor(hi))
    assert _bits(jqp.scale) == _bits(tqp.scale.numpy())
    assert int(jqp.zero_point) == int(tqp.zero_point)
    jcodes = np.asarray(jq.quantize(jnp.asarray(x), jqp))
    tcodes = tq.quantize(torch.from_numpy(x), tqp).numpy()
    np.testing.assert_array_equal(tcodes, jcodes)
    np.testing.assert_array_equal(_bits(tq.dequantize(torch.from_numpy(tcodes), tqp).numpy()),
                                  _bits(jq.dequantize(jnp.asarray(jcodes), jqp)))


def test_per_channel_quantize_and_nudge():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.3, (3, 3, 5, 7)).astype(np.float32)
    lo, hi = w.min(axis=(0, 1, 2)), w.max(axis=(0, 1, 2))
    jqp = jq.nudge_min_max(jnp.asarray(lo), jnp.asarray(hi))
    tqp = tq.nudge_min_max(torch.from_numpy(lo), torch.from_numpy(hi))
    assert tqp.per_channel and jqp.per_channel
    np.testing.assert_array_equal(tqp.zero_point.numpy(), np.asarray(jqp.zero_point))
    np.testing.assert_array_equal(
        tq.quantize(torch.from_numpy(w), tqp, channel_axis=3).numpy(),
        np.asarray(jq.quantize(jnp.asarray(w), jqp, channel_axis=3)))


def _jax_vjp(fn, *args, g):
    out, vjp = jax.vjp(fn, *args)
    return out, vjp(g)


@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("kind", ["fake_quant", "fake_quant_learned"])
def test_fake_quant_value_mask_and_gradients(kind, lo, hi):
    rng = np.random.default_rng(2)
    x = _x(rng)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jout, jgrads = _jax_vjp(getattr(jq, kind), jnp.asarray(x), jnp.float32(lo), jnp.float32(hi),
                            g=jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    lt, ht = torch.tensor(lo, requires_grad=True), torch.tensor(hi, requires_grad=True)
    out = getattr(tq, kind)(xt, lt, ht)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_bits(out.detach().numpy()), _bits(jout))
    # the x-gradient is g or 0: the straight-through mask, exactly
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgrads[0]))
    if kind == "fake_quant_learned":
        np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jgrads[1]), rtol=1e-6)
        np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jgrads[2]), rtol=1e-6)
    else:
        assert lt.grad is None and ht.grad is None


def test_fake_quant_learned_reference_semantics():
    x = torch.tensor([-5.0, 0.5, 2.0, 9.0, 12.0], requires_grad=True)
    lo, hi = torch.tensor(-2.0, requires_grad=True), torch.tensor(8.0, requires_grad=True)
    torch.sum(tq.fake_quant_learned(x, lo, hi) * torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])).backward()
    assert x.grad.tolist() == [0.0, 2.0, 3.0, 0.0, 0.0]
    assert float(lo.grad) == 1.0 and float(hi.grad) == 9.0


@pytest.mark.parametrize("shape", [(3, 3, 16, 8), (1, 1, 64, 30), (3, 3, 3, 5)])
def test_weight_fake_quants(shape):
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.2, shape).astype(np.float32)
    w[..., 0] = 0.0                     # an all-zero channel: scale 1
    w[0, 0, 0, 1] = np.float32(-2.54)   # absmax 2.54: scale 0.02, ties at odd hundredths
    w[1 % shape[0], 0, 0, 1] = np.float32(0.05)
    g = rng.standard_normal(shape).astype(np.float32)
    jout, (jg,) = _jax_vjp(jq.fake_quant_symmetric_per_channel, jnp.asarray(w), g=jnp.asarray(g))
    wt = torch.from_numpy(w).requires_grad_(True)
    out = tq.fake_quant_symmetric_per_channel(wt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_bits(out.detach().numpy()), _bits(jout))
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jg))
    lo, hi = w.min(axis=(0, 1, 2)), w.max(axis=(0, 1, 2))
    jout, jgs = _jax_vjp(jq.fake_quant_per_channel, jnp.asarray(w), jnp.asarray(lo), jnp.asarray(hi),
                         g=jnp.asarray(g))
    wt.grad = None
    out = tq.fake_quant_per_channel(wt, torch.from_numpy(lo), torch.from_numpy(hi))
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(_bits(out.detach().numpy()), _bits(jout))
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(jgs[0]))


@pytest.mark.parametrize("state,batch", [
    ((0.0, 0.0), (-0.7, 3.1)),      # unseen: adopts the batch
    ((-1.2, 4.5), (-0.7, 3.1)),
    ((0.0, 6.0), (0.0, 5.999)),
    ((-1e-3, 0.0), (-2.0, 1e-7)),
])
def test_ema_update_bit_equal(state, batch):
    j = jq.ema_update(*(jnp.float32(v) for v in state + batch))
    t = tq.ema_update(*(torch.tensor(v) for v in state + batch))
    for a, b in zip(j, t):
        assert _bits(a) == _bits(b.numpy())


def test_requantize_and_multiplier_helpers():
    rng = np.random.default_rng(4)
    m = rng.uniform(1e-4, 1.5, 64)
    m0, sh = tq.quantize_multiplier(m)
    jm0, jsh = jq.quantize_multiplier(m)
    np.testing.assert_array_equal(m0, jm0)
    np.testing.assert_array_equal(sh, jsh)
    acc = rng.integers(-(2**24), 2**24, (64,)).astype(np.int32)
    np.testing.assert_array_equal(tq.requantize_fixed_np(acc, m0, sh), jq.requantize_fixed_np(acc, jm0, jsh))
    mf = m.astype(np.float32)
    np.testing.assert_array_equal(tq.requantize_float(torch.from_numpy(acc), torch.from_numpy(mf)).numpy(),
                                  np.asarray(jq.requantize_float(jnp.asarray(acc), jnp.asarray(mf))))


POLICIES = [
    dict(policy="constant", burn_in=100),
    dict(policy="step", lr_step=500, lr_scale=0.5, burn_in=30),
    dict(policy="steps", lr_steps=(100, 1000), lr_scales=(0.1, 0.1), burn_in=50),
    dict(policy="exp", gamma=0.9999, burn_in=10),
    dict(policy="poly", max_batches=1500, power=4.0, burn_in=1000),
    dict(policy="random", power=2.0, burn_in=20, learning_rate=0.1),
    dict(policy="sig", gamma=0.01, lr_step=1000, burn_in=0),
]


@pytest.mark.parametrize("cfg", POLICIES, ids=[c["policy"] for c in POLICIES])
def test_lr_schedule_equals_jax_steps_0_to_2000(cfg):
    """The reference's float32 rate, bit for bit: its pow is the C library's
    powf, its exp XLA's own, and ``random`` a Threefry draw per step."""
    jlr = jqat.lr_schedule(jqat.TrainConfig(**cfg))
    tlr = tqat.lr_schedule(tqat.TrainConfig(**cfg))
    steps = np.arange(2001)
    want = np.asarray(jax.vmap(lambda s: jlr(s))(jnp.asarray(steps, jnp.int32)))
    eager = np.asarray([jlr(jnp.int32(s)) for s in steps[::50]], np.float32)
    got = np.asarray([tlr(int(s)) for s in steps], np.float32)
    assert tlr(0) == 0.0 or cfg["burn_in"] == 0
    # the un-jitted reference, bit for bit
    np.testing.assert_array_equal(_bits(got[::50]), _bits(eager))
    # the whole range against the vectorized reference (XLA may fuse its
    # float32 ops under vmap: a few ulps)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_lr_schedule_every_step_bit_equal_to_unjitted_reference():
    """All seven policies at every step 0-2000 against the un-jitted
    reference (one policy at a time is slow: eager calls)."""
    for cfg in POLICIES:
        jlr = jqat.lr_schedule(jqat.TrainConfig(**cfg))
        tlr = tqat.lr_schedule(tqat.TrainConfig(**cfg))
        steps = range(0, 2001, 7) if cfg["policy"] not in ("random", "sig") else range(2001)
        got = np.asarray([tlr(s) for s in steps], np.float32)
        want = np.asarray([float(jlr(jnp.int32(s))) for s in steps], np.float32)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=cfg["policy"])


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="LR policy"):
        tqat.lr_schedule(tqat.TrainConfig(policy="cosine"))


ACTIVATIONS = ["linear", "leaky", "relu", "relu6", "leaky6", "logistic", "loggy", "relie",
               "ramp", "tanh", "elu", "selu", "plse", "stair", "hardtan", "lhtan"]


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activations_match_jax(name):
    """Values within float32 ulps of the output scale (XLA's and PyTorch's
    tanh, exp and sigmoid approximations differ by up to ~1e-6), gradients
    likewise; the clamp-family ties (x on a bound)
    split their gradient in halves in both."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-8, 8, 2000), [0.0, 6.0, -1.0, 1.0, -4.0, 4.0, 2.0, -3.0]])
    x = x.astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jout, (jg,) = _jax_vjp(lambda v: JL.activate(v, name), jnp.asarray(x), g=jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = TL.activate(xt, name)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=2e-6, atol=2e-6)


def test_unknown_activation_raises():
    with pytest.raises(ValueError):
        TL.activate(torch.zeros(2), "swish")


@pytest.mark.parametrize("shape,k,stride,dtype", [
    ((2, 17, 13, 3), 3, 1, "float32"), ((2, 16, 16, 8), 3, 2, "float32"),
    ((1, 9, 9, 32), 1, 1, "float32"), ((2, 12, 12, 16), 3, 1, "bfloat16"),
])
def test_conv2d_and_gradients_match_jax(shape, k, stride, dtype):
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    w = (rng.standard_normal((k, k, shape[-1], 12)) * 0.2).astype(np.float32)
    pad = k // 2
    jout, vjp = jax.vjp(lambda a, b: JL.conv2d(a, b, stride, pad, dtype), jnp.asarray(x), jnp.asarray(w))
    g = rng.standard_normal(jout.shape).astype(np.float32)
    jgx, jgw = vjp(jnp.asarray(g))
    xt, wt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    out = TL.conv2d(xt, wt, stride, pad, dtype)
    out.backward(torch.from_numpy(g))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **tol)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), **tol)
    assert out.dtype == torch.float32


@pytest.mark.parametrize("shape,k,stride,chunk", [
    ((2, 17, 13, 3), 3, 1, 4096), ((2, 17, 13, 3), 3, 1, 64), ((1, 1, 37, 4), 3, 1, 16),
    ((2, 16, 16, 8), 3, 2, 32), ((1, 9, 9, 32), 1, 1, 16),
])
def test_weight_grad_matches_jax(shape, k, stride, chunk):
    """The chunked weight gradient the card's float32 convs use: one matmul,
    chunks that divide the rows (442 = 13 x 34, 128, 81) and a prime count
    of rows (37) padded with zero rows."""
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    w = (rng.standard_normal((k, k, shape[-1], 12)) * 0.2).astype(np.float32)
    pad = k // 2
    jout, vjp = jax.vjp(lambda b: JL.conv2d(jnp.asarray(x), b, stride, pad), jnp.asarray(w))
    g = rng.standard_normal(jout.shape).astype(np.float32)
    (jgw,) = vjp(jnp.asarray(g))
    got = TL.weight_grad(torch.from_numpy(x), torch.from_numpy(g), k, stride, pad, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-5)


def test_float32_convs_scope_restores_flags():
    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,  # noqa: E731
                     torch.backends.mkldnn.enabled, torch.backends.cudnn.deterministic)
    before = flags()
    with TL.float32_convs():
        assert flags() == (False, False, False, True)
    assert flags() == before
    with TL.deterministic_convs():
        assert torch.backends.cudnn.deterministic
    assert flags() == before


def test_bn_folds_and_batch_stats_match_jax():
    rng = np.random.default_rng(7)
    w = rng.normal(0, 0.3, (3, 3, 4, 6)).astype(np.float32)
    gamma, beta = rng.uniform(0.5, 1.5, 6).astype(np.float32), rng.normal(0, 0.2, 6).astype(np.float32)
    mean, var = rng.normal(0, 0.5, 6).astype(np.float32), rng.uniform(0.01, 2, 6).astype(np.float32)
    args = [gamma, beta, mean, var]
    for a, b in zip(JL.bn_inference_scale_bias(*map(jnp.asarray, args)),
                    TL.bn_inference_scale_bias(*map(torch.from_numpy, args))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(JL.fold_bn_into_weights(jnp.asarray(w), None, *map(jnp.asarray, args)),
                    TL.fold_bn_into_weights(torch.from_numpy(w), None, *map(torch.from_numpy, args))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    x = rng.normal(1.0, 2.0, (3, 11, 9, 6)).astype(np.float32)
    for a, b in zip(JL.batch_stats(jnp.asarray(x)), TL.batch_stats(torch.from_numpy(x))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5)


@pytest.mark.parametrize("h,size,stride", [(12, 2, 2), (13, 2, 1), (9, 3, 2), (7, 2, 2)])
def test_float_maxpool_tie_gradients_match_jax(h, size, stride):
    """Values on a coarse grid (many ties in a window): JAX's reduce_window
    max gives a tie's whole gradient to one element, F.max_pool2d too; the
    size-2/stride-1 pool pads its far edge with -inf."""
    rng = np.random.default_rng(8)
    x = (rng.integers(-3, 4, (2, h, h + 1, 3)) * 0.25).astype(np.float32)
    pad = size - 1
    jout, vjp = jax.vjp(lambda v: JL.maxpool(v, size, stride, pad), jnp.asarray(x))
    g = rng.standard_normal(jout.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = TL.maxpool(xt, size, stride, pad)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
