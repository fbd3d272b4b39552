"""The port's GEMM-orientation probe equals the JAX probe kernels' formula:
int8 dot products with int32 accumulation, narrowed to int8 with XLA's wrap."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from yolo_quantization_tpu_torch.tools import orientation_probe as probe

torch.set_num_threads(2)


def jax_dot_i8(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The Pallas probe kernels' body: dot_general with int32 preference,
    then astype(int8)."""
    return np.asarray(lax.dot_general(
        jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.int8))


def test_narrowing_wraps_like_xla():
    v = np.array([128, 200, -129, 255, 256, -300, 127, -128], np.int32)
    want = np.asarray(jnp.asarray(v).astype(jnp.int8))
    np.testing.assert_array_equal(want[:3], [-128, -56, 127])
    np.testing.assert_array_equal(torch.from_numpy(v).to(torch.int8).numpy(), want)
    # K = 128 on ones sums to 128, which wraps to -128
    ones = torch.ones((4, 128), dtype=torch.int8)
    assert probe.orientation_a(ones, torch.ones((128, 16), dtype=torch.int8)).unique().tolist() == [-128]
    assert probe.orientation_b(torch.ones((16, 128), dtype=torch.int8), ones.T.contiguous()) \
        .unique().tolist() == [-128]


@pytest.mark.parametrize("scale", [2048])
def test_cases_match_jax_formula(scale):
    """The script's four cases at 1/scale of their rows, seeded random codes."""
    seen = []
    before = dict(probe.launches)
    for name, orientation, k, o, p, args, out in probe.run_cases("cpu", scale=scale):
        a, b = (t.numpy() for t in args)
        want = jax_dot_i8(a, b)
        assert out.dtype == torch.int8
        assert out.shape == ((p, o) if orientation == "a" else (o, p))
        np.testing.assert_array_equal(out.numpy(), want, err_msg=name)
        assert (np.abs(a.astype(np.int64) @ b.astype(np.int64)) > 127).any()  # wraps happen
        seen.append((orientation, k, o))
    assert seen == [("a", 32, 16), ("a", 128, 64), ("b", 32, 16), ("b", 128, 64)]
    assert probe.launches == before


def test_shape_rules():
    probe._check_shapes(8, 32, 16, "b")
    probe._check_shapes(8, 128, 64, "a")
    for bad in ((8, 30, 16, "a"), (8, 32, 24, "a"), (6, 32, 16, "b"), (8, 512, 16, "a"),
                (8, 36, 16, "a"), (8, 32, 80, "a")):
        with pytest.raises(ValueError, match="probe kernel shapes"):
            probe._check_shapes(*bad)
    with pytest.raises(ValueError, match="orientation_a"):
        probe.orientation_a(torch.zeros((4, 8), dtype=torch.int8), torch.zeros((4, 16), dtype=torch.int8))


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    before = dict(probe.launches)
    for name, _, _, _, _, args, out in probe.run_cases("cuda", scale=16):
        assert torch.equal(out.cpu(), probe.plain_matmul_i8(*[a.cpu() for a in args])), name
    assert probe.launches == {k: v + 2 for k, v in before.items()}


@pytest.mark.cuda
def test_cuda_kernel_rejects_unaligned_operand():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the alignment check guards the kernel only)")
    x = torch.zeros(64 * 32 + 16, dtype=torch.int8, device="cuda")[1:64 * 32 + 1].view(64, 32)
    w = torch.zeros((32, 16), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="16-byte boundary"):
        probe.orientation_a(x, w)
