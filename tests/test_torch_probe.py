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
    probe._check_shapes(16, 32, 16, "b")
    probe._check_shapes(8, 128, 64, "a")
    probe._check_shapes(2768896 // 4, 128, 64, "b")
    for bad in ((8, 30, 16, "a"), (8, 32, 24, "a"), (6, 32, 16, "b"), (8, 512, 16, "a"),
                (8, 36, 16, "a"), (8, 32, 80, "a"), (8, 32, 16, "b"), (24, 32, 16, "b"),
                (16, 36, 16, "b"), (16, 32, 80, "b")):
        with pytest.raises(ValueError, match="probe kernel shapes"):
            probe._check_shapes(*bad)
    with pytest.raises(ValueError, match="orientation_a"):
        probe.orientation_a(torch.zeros((4, 8), dtype=torch.int8), torch.zeros((4, 16), dtype=torch.int8))


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: result byte i is byte (s >> 4i) & 7 of y:x."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _b_k_order(j: int) -> int:
    """csrc/gemm_probe.cu::b_k_order."""
    return 2 * (j >> 2) + (j & 1) + ((j & 2) << 2)


def _orientation_b_emulated(w: np.ndarray, x: np.ndarray) -> np.ndarray:
    """orientation_b as the kernel computes it, lane by lane: x tiles as
    stored, read with the b16 ldmatrix.trans (lane (g, t) of matrix j gets
    rows 2t, 2t+1 at pixel pair g), split by __byte_perm into even- and
    odd-pixel words of 4 K-bytes; w's copy with K in b_k_order; the m16n8k32
    products; each thread's columns 2t, 2t+1 of the two tiles stored as one
    word of pixels 4t .. 4t+3."""
    (o, k), p = w.shape, x.shape[1]
    xu = x.view(np.uint8).astype(np.int64)
    ws = np.stack([w[:, k0 + (j & ~15) + _b_k_order(j & 15)]
                   for k0 in range(0, k, 32) for j in range(32)], axis=1).astype(np.int64)
    out = np.zeros((o, p), np.int64)
    for p0 in range(0, p, 16):  # one group of 16 pixels: an even and an odd n8 tile
        acc = {"even": np.zeros((o, 8), np.int64), "odd": np.zeros((o, 8), np.int64)}
        for k0 in range(0, k, 32):
            frag = {"even": np.zeros((32, 8), np.int64), "odd": np.zeros((32, 8), np.int64)}
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                r = []
                for j in range(4):
                    def elem(row):  # b16 element (row, g) of matrix j
                        kk = k0 + 8 * j + row
                        return int(xu[kk, p0 + 2 * g] | xu[kk, p0 + 2 * g + 1] << 8)
                    r.append(elem(2 * t) | elem(2 * t + 1) << 16)
                words = {"even": (_byte_perm(r[0], r[1], 0x6420), _byte_perm(r[2], r[3], 0x6420)),
                         "odd": (_byte_perm(r[0], r[1], 0x7531), _byte_perm(r[2], r[3], 0x7531))}
                for tile, (b0, b1) in words.items():  # B fragment: column g, K 4t.. and 16+4t..
                    for e in range(4):
                        frag[tile][4 * t + e, g] = (b0 >> (8 * e)) & 0xFF
                        frag[tile][16 + 4 * t + e, g] = (b1 >> (8 * e)) & 0xFF
            for tile in acc:
                b = (frag[tile] + 128) % 256 - 128
                acc[tile] += ws[:, k0:k0 + 32] @ b
        for t in range(4):  # thread (g, t)'s word: pixels 4t .. 4t+3
            for e, (tile, col) in enumerate((("even", 2 * t), ("odd", 2 * t),
                                              ("even", 2 * t + 1), ("odd", 2 * t + 1))):
                out[:, p0 + 4 * t + e] = acc[tile][:, col]
    return ((out + 128) % 256 - 128).astype(np.int8)


def test_b_k_order_is_a_permutation():
    assert sorted(_b_k_order(j) for j in range(16)) == list(range(16))
    assert [_b_k_order(4 * 2 + e) for e in range(4)] == [4, 5, 12, 13]  # lane t = 2


@pytest.mark.parametrize("k,o,p", [(32, 16, 48), (64, 32, 32), (128, 64, 16)])
def test_orientation_b_fragments_match_jax(rng, k, o, p):
    """K3b's byte transpose and column permutation reproduce x's columns as
    K-contiguous words: the emulated kernel equals the JAX probe formula."""
    w = rng.integers(-128, 128, (o, k), dtype=np.int8)
    x = rng.integers(-128, 128, (k, p), dtype=np.int8)
    np.testing.assert_array_equal(_orientation_b_emulated(w, x), jax_dot_i8(w, x))


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    before = dict(probe.launches)
    for name, _, _, _, _, args, out in probe.run_cases("cuda", scale=16):
        assert torch.equal(out.cpu(), probe.plain_matmul_i8(*[a.cpu() for a in args])), name
    assert probe.launches == {k: v + 2 for k, v in before.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("k,o,p", [(32, 16, 128 * 37 + 16), (128, 64, 128 * 5 + 80), (64, 48, 16)])
def test_cuda_orientation_b_partial_tile(k, o, p):
    """P not a multiple of the kernel's 128-pixel tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    w, x = probe.case_inputs("b", k, o, p, 7, "cuda")
    got = probe.orientation_b(w, x)
    assert torch.equal(got.cpu(), probe.plain_matmul_i8(w.cpu(), x.cpu()))


@pytest.mark.cuda
def test_cuda_kernel_rejects_unaligned_operand():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the alignment check guards the kernel only)")
    x = torch.zeros(64 * 32 + 16, dtype=torch.int8, device="cuda")[1:64 * 32 + 1].view(64, 32)
    w = torch.zeros((32, 16), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="16-byte boundary"):
        probe.orientation_a(x, w)
    xb = torch.zeros(32 * 64 + 16, dtype=torch.int8, device="cuda")[1:32 * 64 + 1].view(32, 64)
    with pytest.raises(ValueError, match="16-byte boundary"):
        probe.orientation_b(torch.zeros((16, 32), dtype=torch.int8, device="cuda"), xb)
