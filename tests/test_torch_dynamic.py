"""The port's dynamic-input arithmetic equals the JAX engine's: C round,
per-image (scale, zero point), per-image quantization and the float32
rebuild of layer 0's bias."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_quantization_tpu.infer import engine as jengine
from yolo_quantization_tpu_torch.infer import engine as tengine

torch.set_num_threads(2)


def test_round_half_away_matches():
    v = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49999997, -0.49999997, 3.0, -7.25,
                  8388607.5, -8388607.5, 1e9, 0.0, -0.0], np.float32)
    v = np.concatenate([v, np.random.default_rng(0).uniform(-300, 300, 1000).astype(np.float32)])
    got = tengine._round_half_away(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jengine._round_half_away(jnp.asarray(v))))
    np.testing.assert_array_equal(got[:6], [1, 2, 3, -1, -2, -3])


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.0, 9.0), (0.2, 0.7), (-1.0, -0.1)])
def test_dynamic_input_qp_and_codes_match(lo, hi):
    """Bit-equal to the JAX function as written; under jit XLA's CPU backend
    turns x/255 into a reciprocal multiply, so there the bound is the one of
    tests/test_dynamic_input.py: scale within one ulp, zero point within 1."""
    x = np.random.default_rng(7).uniform(lo, hi, (4, 32, 32, 3)).astype(np.float32)
    scale, zp = tengine._dynamic_input_qp(torch.from_numpy(x))
    j_scale, j_zp = jengine._dynamic_input_qp(jnp.asarray(x))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale))
    np.testing.assert_array_equal(zp.numpy(), np.asarray(j_zp))
    jit_scale, jit_zp = jax.jit(jengine._dynamic_input_qp)(x)
    assert np.all(np.abs(scale.numpy() - np.asarray(jit_scale)) <= np.spacing(np.asarray(jit_scale)))
    assert np.all(np.abs(zp.numpy() - np.asarray(jit_zp)) <= 1)
    codes = tengine._quantize_input_dynamic(torch.from_numpy(x), scale, zp).numpy()
    j_codes = jengine._quantize_input_dynamic(jnp.asarray(x), j_scale, j_zp)
    assert codes.dtype == np.int8
    np.testing.assert_array_equal(codes, np.asarray(j_codes))


def test_dyn_bias_rebuild_is_float32_arithmetic():
    """The per-image bias correction -zx*wsum + K*zx*w_zp is evaluated in
    float32, as the reference does: its products exceed 2^24, where integer
    arithmetic gives other biases."""
    rng = np.random.default_rng(3)
    o = 64
    a = {
        "w_scale": torch.from_numpy(rng.uniform(1e-3, 1e-2, o).astype(np.float32)),
        "bias_f": torch.from_numpy(rng.uniform(-2, 2, o).astype(np.float32)),
        "wsum_i32": torch.from_numpy(rng.integers(-300_000, 300_000, o).astype(np.int32)),
        "w_zp": torch.from_numpy(rng.integers(-128, 128, o).astype(np.int32)),
        "out_scale_f": torch.tensor(0.05, dtype=torch.float32),
    }
    scale = torch.tensor([0.0039, 0.011], dtype=torch.float32)
    zp = torch.tensor([3.0, 201.0], dtype=torch.float32)
    k = 3 * 3 * 1024
    bias, m = tengine._dyn_bias_m(a, False, k, scale, zp)
    an = {n: v.numpy() for n, v in a.items()}
    denom = scale.numpy()[:, None] * an["w_scale"][None, :]
    bias_q = np.asarray(jengine._round_half_away(jnp.asarray(an["bias_f"][None, :] / denom)))
    zx = zp.numpy()[:, None] - np.float32(128.0)
    corr = -zx * an["wsum_i32"].astype(np.float32) + np.float32(k) * zx * an["w_zp"].astype(np.float32)
    np.testing.assert_array_equal(bias.numpy(), (bias_q + corr).astype(np.int32))
    np.testing.assert_array_equal(m.numpy(), denom / an["out_scale_f"])
    zx_i = zx.astype(np.int64)
    exact = bias_q.astype(np.int64) - zx_i * an["wsum_i32"] + k * zx_i * an["w_zp"]
    assert (exact != bias.numpy()).any()  # the trap is real at these magnitudes


def test_dynamic_input_needs_its_ingredients():
    from yolo_quantization_tpu_torch.models.presets import flagship_program

    prog = flagship_program(size=64)
    del prog.arrays[0]["wsum_i32"]
    with pytest.raises(ValueError, match="re-run convert"):
        tengine.build_forward(prog, dynamic_input=True)
