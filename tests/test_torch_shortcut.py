"""The port's integer shortcut equals the JAX engine's, bit for bit: the plain
version on every pair of int8 codes against the JAX engine's expression run
un-jitted, and whole engines against the JAX ``build_forward``; under
``jax.jit`` XLA contracts that expression into an FMA, pinned below; the
CUDA kernel equals the plain version on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_quantization_tpu.infer import convert as jconvert
from yolo_quantization_tpu.infer import engine as jengine
from yolo_quantization_tpu.nn import graph as jgraph
from yolo_quantization_tpu_torch.infer import engine as tengine
from yolo_quantization_tpu_torch.infer.convert import convert
from yolo_quantization_tpu_torch.models import presets as tpresets
from yolo_quantization_tpu_torch.nn import graph as tgraph
from yolo_quantization_tpu_torch.ops import cuda_shortcut, shortcut
from yolo_quantization_tpu_torch.ops.qconv import ACTIVATION_BY_NAME

torch.set_num_threads(2)

ACTIVATIONS = ["linear", "leaky", "relu", "relu6"]
CODES = np.arange(-128, 128, dtype=np.int8)
# every pair of int8 codes: 65,536
PAIR_X, PAIR_K = (a.ravel() for a in np.meshgrid(CODES, CODES, indexing="ij"))


def seeded_params(seed: int, activation: str):
    """Operand grids (scale, uint8 zero point) and an output grid, as the
    converter's cfg holds them, from a seed."""
    rng = np.random.default_rng(seed)
    qp_x = (float(rng.uniform(0.005, 0.05)), int(rng.integers(0, 256)))
    qp_k = (float(rng.uniform(0.005, 0.05)), int(rng.integers(0, 256)))
    return qp_x, qp_k, float(rng.uniform(0.01, 0.06)), int(rng.integers(0, 256)), activation


def jax_expression(x, skip, qp_x, qp_k, out_scale, out_zp, activation):
    """The integer branch of the shortcut in
    yolo_quantization_tpu/infer/engine.py::build_forward, as written there."""
    ra = qp_x[0] / out_scale
    rb = qp_k[0] / out_scale
    cst = -(qp_x[1] - 128) * ra - (qp_k[1] - 128) * rb
    t = (
        x.astype(jnp.float32) * jnp.float32(ra)
        + skip.astype(jnp.float32) * jnp.float32(rb)
        + jnp.float32(cst)
    )
    if activation == "leaky":
        t = jnp.where(t < 0, t * jnp.float32(0.1), t)
    elif activation == "relu":
        t = jnp.maximum(t, 0.0)
    elif activation == "relu6":
        t = jnp.clip(t, 0.0, jnp.float32(6.0 / out_scale))
    return jnp.clip(jnp.round(t) + (out_zp - 128), -128, 127).astype(jnp.int8)


def plain(params):
    k = shortcut.shortcut_params(*params)
    return shortcut.int_shortcut(torch.from_numpy(PAIR_X), torch.from_numpy(PAIR_K), k).numpy()


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("seed", range(4))
def test_plain_matches_jax_on_every_code_pair(seed, activation):
    params = seeded_params(seed, activation)
    want = np.asarray(jax_expression(jnp.asarray(PAIR_X), jnp.asarray(PAIR_K), *params))
    np.testing.assert_array_equal(plain(params), want)


def test_params_are_float64_then_float32():
    qp_x, qp_k, so, zo, _ = seeded_params(3, "relu6")
    k = shortcut.shortcut_params(qp_x, qp_k, so, zo, "relu6")
    ra, rb = qp_x[0] / so, qp_k[0] / so
    assert k.ra == float(np.float32(ra)) and k.rb == float(np.float32(rb))
    assert k.cst == float(np.float32(-(qp_x[1] - 128) * ra - (qp_k[1] - 128) * rb))
    assert k.cap == float(np.float32(6.0 / so)) and k.act == ACTIVATION_BY_NAME["relu6"]
    assert shortcut.shortcut_params(qp_x, qp_k, so, zo, "leaky").cap == 0.0
    with pytest.raises(ValueError, match="activation"):
        shortcut.shortcut_params(qp_x, qp_k, so, zo, "logistic")


def test_jit_contracts_the_expression_into_an_fma():
    """Under jax.jit on the CPU, XLA's backend computes fma(x, ra, skip*rb) +
    cst, one rounding fewer than the engine's expression run op by op (and
    than the port).  Only values near .5 ties move, by one code: the jitted
    JAX engine is no bit-exact reference, the un-jitted one is."""
    moved = 0
    for seed in range(40):
        params = seeded_params(seed, "linear")
        qp_x, qp_k, so, _, _ = params
        ra, rb = np.float32(qp_x[0] / so), np.float32(qp_k[0] / so)
        cst = np.float32(-(qp_x[1] - 128) * (qp_x[0] / so) - (qp_k[1] - 128) * (qp_k[0] / so))
        f = lambda x, k: x.astype(jnp.float32) * ra + k.astype(jnp.float32) * rb + cst  # noqa: E731
        jitted = np.asarray(jax.jit(f)(jnp.asarray(PAIR_X), jnp.asarray(PAIR_K)))
        xf, kf = PAIR_X.astype(np.float32), PAIR_K.astype(np.float32)
        # x*ra is exact in float64 (8 x 24 bits), and so is its sum with the
        # float32 skip*rb: one rounding to float32 is a correctly rounded fma
        fma = (xf.astype(np.float64) * np.float64(ra) + (kf * rb).astype(np.float64)).astype(np.float32)
        np.testing.assert_array_equal(jitted, fma + cst)
        np.testing.assert_array_equal(np.asarray(f(jnp.asarray(PAIR_X), jnp.asarray(PAIR_K))),
                                      (xf * ra + kf * rb) + cst)
        codes_jit = np.asarray(jax.jit(jax_expression, static_argnums=(2, 3, 4, 5, 6))(
            jnp.asarray(PAIR_X), jnp.asarray(PAIR_K), *params))
        diff = np.abs(codes_jit.astype(np.int32) - plain(params).astype(np.int32))
        assert diff.max() <= 1
        moved += int(diff.any())
    assert moved > 0  # the contraction does move codes for some grids


def _ladder_net(G, shortcut_act):
    """conv -> (1x1 conv -> 3x3 conv -> shortcut) x 2, as
    tests/test_int_shortcut.py, with a stride-2 conv between the rungs."""
    c = lambda f, k, stride=1: G.ConvSpec(  # noqa: E731
        filters=f, size=k, stride=stride, pad=1 if k == 3 else 0, activation="leaky")
    specs = (
        c(16, 3), c(8, 1), c(16, 3), G.ShortcutSpec(index=0, activation=shortcut_act),
        c(16, 3, stride=2), c(8, 1), c(16, 3), G.ShortcutSpec(index=4, activation=shortcut_act),
    )
    return G.NetworkDef(specs=specs, width=32, height=32)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_engine_shortcuts_match_jax(activation):
    """Whole engines through the JAX engine's own shortcut: every layer
    bit-equal un-jitted; jitted, the shortcut codes within one of the port's."""
    tnet, jnet = _ladder_net(tgraph, activation), _ladder_net(jgraph, activation)
    params = tgraph.init_params_numpy(2, tnet)
    qs = tpresets.perturbed_quant_state(tpresets.synthetic_quant_state(tnet))
    jp, tp = jconvert.convert(jnet, params, qs), convert(tnet, params, qs)
    x = np.random.default_rng(5).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    fwd = jengine.build_forward(jp, return_outputs=True)
    _, jouts = fwd(jax.device_put(jp.arrays), jnp.asarray(x))
    _, touts = tengine.build_forward(tp, return_outputs=True)(tengine.device_arrays(tp, "cpu"),
                                                             torch.from_numpy(x))
    for i, (a, b) in enumerate(zip(jouts, touts)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"layer {i}")
    _, jit_outs = jax.jit(fwd)(jax.device_put(jp.arrays), jnp.asarray(x))
    for i in (3, 7):
        # jit rewrites other float arithmetic too (the input quantization's
        # division), so the port's shortcut takes the jitted run's operands
        c = tp.cfg[i]
        k = shortcut.shortcut_params(*c.in_scales, c.out_scale, c.out_zp, activation)
        port = shortcut.int_shortcut(torch.from_numpy(np.array(jit_outs[i - 1])),
                                     torch.from_numpy(np.array(jit_outs[c.spec.index])), k)
        got = np.asarray(jit_outs[i]).astype(np.int32)
        assert np.abs(got - port.numpy().astype(np.int32)).max() <= 1, i


def test_wrapper_on_cpu_runs_the_plain_version():
    params = seeded_params(9, "leaky")
    k = shortcut.shortcut_params(*params)
    x, s = torch.from_numpy(PAIR_X[:1000].copy()), torch.from_numpy(PAIR_K[:1000].copy())
    before = cuda_shortcut.launches
    assert torch.equal(cuda_shortcut.int_shortcut_cuda(x, s, k), shortcut.int_shortcut(x, s, k))
    assert cuda_shortcut.launches == before
    with pytest.raises(ValueError, match="shapes"):
        cuda_shortcut.int_shortcut_cuda(x, s[:999], k)
    with pytest.raises(ValueError, match="int8"):
        cuda_shortcut.int_shortcut_cuda(x.to(torch.int16), s, k)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_shortcut.int_shortcut_cuda(x.reshape(10, 100).t(), s.reshape(10, 100).t(), k)


# the five yolov3 stage shapes (one shortcut of each stage) at batch 16
V3_STAGES = [(16, 208, 208, 64), (16, 104, 104, 128), (16, 52, 52, 256), (16, 26, 26, 512),
             (16, 13, 13, 1024)]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the shortcut kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_cuda_kernel_matches_plain_on_every_code_pair(activation):
    _needs_card()
    for seed in range(8):
        params = seeded_params(seed, activation)
        k = shortcut.shortcut_params(*params)
        x, s = torch.from_numpy(PAIR_X), torch.from_numpy(PAIR_K)
        before = cuda_shortcut.launches
        got = cuda_shortcut.int_shortcut_cuda(x.cuda(), s.cuda(), k)
        torch.cuda.synchronize()
        assert cuda_shortcut.launches == before + 1
        assert torch.equal(got.cpu(), shortcut.int_shortcut(x, s, k))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", V3_STAGES + [(1, 1, 3, 5), (3, 7, 11, 13)])
def test_cuda_kernel_matches_plain_at_v3_shapes(shape):
    """The stage shapes, and lengths that are not a multiple of 16 (the
    scalar tail)."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    x = torch.randint(-128, 128, shape, dtype=torch.int8, device="cuda", generator=gen)
    s = torch.randint(-128, 128, shape, dtype=torch.int8, device="cuda", generator=gen)
    k = shortcut.shortcut_params(*seeded_params(shape[-1], "leaky"))
    got = cuda_shortcut.int_shortcut_cuda(x, s, k)
    assert torch.equal(got, shortcut.int_shortcut(x, s, k))


@pytest.mark.cuda
def test_cuda_kernel_rejects_unaligned_operands():
    _needs_card()
    flat = torch.zeros(4096 + 16, dtype=torch.int8, device="cuda")
    k = shortcut.shortcut_params(*seeded_params(1, "linear"))
    with pytest.raises(ValueError, match="16-byte boundary"):
        cuda_shortcut.int_shortcut_cuda(flat[1:4097], flat[16:4112], k)
