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
    """B of the implicit GEMM: K = w_s2d's flatten order, and output slot
    ph*O + o at column 16*(o//4) + 8*(ph//2) + 2*(o%4) + ph%2, O padded to
    4 and K to 32 with zeros."""
    c, o = 5, 5
    w = torch.arange(3 * 3 * 4 * c * 4 * o, dtype=torch.int32).remainder(251).sub(125).to(torch.int8)
    w = w.reshape(3, 3, 4 * c, 4 * o)
    p = cuda_s2d.pack_weights(w)
    assert p.shape == (32, 192) == cuda_s2d.packed_shape(c, o) and p.is_contiguous()
    flat = w.reshape(36 * c, 4 * o)
    seen = set()
    for ph in range(4):
        for ch in range(o):
            col = _b_column(ch, ph)
            assert torch.equal(p[col, :36 * c], flat[:, ph * o + ch])
            seen.add(col)
    assert not p[sorted(set(range(32)) - seen)].any()  # channels 5..7: zero columns
    assert not p[:, 36 * c:].any()  # K 180 -> 192 with zeros


def _b_column(o, ph):
    return 16 * (o // 4) + 8 * (ph // 2) + 2 * (o % 4) + ph % 2


def _s2d_rows(x, x_zp):
    """Numpy im2col of the s2d GEMM: rows are output blocks (n, by, bx),
    column k = tap*4C + (qy*2+qx)*C + c holds pixel (2by-2+2dy+qy,
    2bx-2+2dx+qx, c) for tap = dy*3 + dx, the zero point outside the map, K
    zero-padded to a multiple of 32."""
    n, h, w, c = x.shape
    xp = np.full((n, h + 4, w + 4, c), x_zp, np.int64)
    xp[:, 2:h + 2, 2:w + 2] = x
    cols = [xp[:, 2 * dy + qy:2 * dy + qy + h:2, 2 * dx + qx:2 * dx + qx + w:2]
            for dy in range(3) for dx in range(3) for qy in range(2) for qx in range(2)]
    a = np.concatenate(cols, axis=-1).reshape(n * (h // 2) * (w // 2), 36 * c)
    return np.pad(a, ((0, 0), (0, -a.shape[1] % 32)))


def _loader_rows(x, x_zp):
    """The rows as s2d_qconv.cu's A loader for this C builds them: kStem
    (C == 3) from 9 16-bit words per patch row, kVec (C % 16 == 0) in
    16-byte chunks of one pixel, kByte with its (c, q, dx, dy) walk."""
    n, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    k_real, k_pad = 36 * c, -(-36 * c // 32) * 32
    u8 = x.view(np.uint8).astype(np.int64)
    zp = x_zp & 0xFF
    rows = np.zeros((n * h2 * w2, k_pad), np.int64)
    for r in range(len(rows)):
        img, by, bx = r // (h2 * w2), r % (h2 * w2) // w2, r % w2
        iy0, ix0 = 2 * by, 2 * bx

        def pixel(ry, rx, ch):
            iy, ix = iy0 + ry, ix0 + rx
            return u8[img, iy, ix, ch] if 0 <= iy < h and 0 <= ix < w else zp

        if c == 3:
            flat = u8.reshape(n, h, w * 3)
            u = np.zeros((6, 9), np.int64)
            for pr in range(6):
                iy = iy0 - 2 + pr
                for j in range(9):
                    if 0 <= iy < h and 0 <= bx + j // 3 - 1 < w2:
                        b0 = (2 * bx - 2) * 3 + 2 * j
                        u[pr, j] = flat[img, iy, b0] | flat[img, iy, b0 + 1] << 8
                    else:
                        u[pr, j] = zp * 0x0101
            for k in range(108):
                tap, q, ch = k // 12, k % 12 // 3, k % 3
                pr, bb = 2 * (tap // 3) + q // 2, (2 * (tap % 3) + q % 2) * 3 + ch
                rows[r, k] = u[pr, bb // 2] >> (8 * (bb % 2)) & 0xFF
        elif c % 16 == 0:
            for kk in range(0, k_real, 16):
                tap, s = divmod(kk, 4 * c)
                q, ch = divmod(s, c)
                ry, rx = 2 * (tap // 3) + (q >> 1) - 2, 2 * (tap % 3) + (q & 1) - 2
                rows[r, kk:kk + 16] = [pixel(ry, rx, ch + i) for i in range(16)]
        else:
            for kb in range(0, k_pad, 32):
                tap, s = divmod(kb, 4 * c)
                q, ch = divmod(s, c)
                dy, dx = divmod(tap, 3)
                for b in range(32):
                    if kb + b < k_real:
                        rows[r, kb + b] = pixel(2 * dy + (q >> 1) - 2, 2 * dx + (q & 1) - 2, ch)
                    ch = 0 if ch + 1 == c else ch + 1
                    q = q if ch else 0 if q == 3 else q + 1
                    dx = dx if ch or q else 0 if dx == 2 else dx + 1
                    dy = dy if ch or q or dx else dy + 1
    return (rows + 128) % 256 - 128  # the uint8 lanes back to shifted int8 codes


@pytest.mark.parametrize("c,o", [(3, 16), (3, 6), (5, 24), (6, 3), (16, 32), (32, 9)])
def test_implicit_gemm_phase_max_matches_jax(rng, c, o):
    """K2's GEMM view: each loader's rows times the packed B, and the max
    over the 4 columns a thread holds for channel 4*group + t (columns 2t,
    2t+1 of the group's two n8 tiles), equal the JAX conv over the
    space-to-depth input maxed over the phase groups; for an arbitrary block
    kernel, not only _s2d_weights' (whose structural zeros the kernel
    multiplies anyway)."""
    n, h, w, x_zp = 2, 6, 10, -37
    x = rng.integers(-128, 128, (n, h, w, c), dtype=np.int8)
    w_s2d = rng.integers(-128, 128, (3, 3, 4 * c, 4 * o), dtype=np.int8)
    a = _loader_rows(x, x_zp)
    np.testing.assert_array_equal(a, _s2d_rows(x, x_zp))
    b = cuda_s2d.pack_weights(torch.from_numpy(w_s2d)).numpy().astype(np.int64)
    assert b.shape == cuda_s2d.packed_shape(c, o) and b.shape[1] == a.shape[1]
    gemm = a @ b.T
    got = np.zeros((len(a), o), np.int64)
    for group in range(b.shape[0] // 16):
        for t in range(4):
            if 4 * group + t < o:
                cols = 16 * group + np.array([2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t])
                got[:, 4 * group + t] = gemm[:, cols].max(axis=1)
    xs = tqconv.space_to_depth(torch.from_numpy(x)).numpy()
    acc = np.asarray(jqconv.conv_acc_int32(jnp.asarray(xs), jnp.asarray(w_s2d), jnp.int32(x_zp),
                                           jnp.zeros((4 * o,), jnp.int32), 1, 1, symmetric=True))
    want = np.max(acc.reshape(n, h // 2, w // 2, 4, o), axis=3)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


# the flagship's s2d stem layers 0, 2 and 4 at batch 16, the timed shapes
STEM_B16 = [(16, 416, 416, 3, 16, ACT_RELU6), (16, 208, 208, 16, 32, ACT_RELU6),
            (16, 104, 104, 32, 64, ACT_RELU6)]
# shapes that reach each entry of the kernel's tile table on a 132-SM card,
# with partial M and N tiles
EDGES = [
    # n, h, w, c, o
    # the stem loader (C == 3): 128x64
    (1, 30, 22, 3, 16), (2, 12, 20, 3, 24),
    # the byte gather (other C % 16 != 0): 128x64
    (2, 30, 22, 5, 24), (1, 10, 14, 6, 8), (3, 8, 6, 7, 40),
    # 16-byte copies, N = 4*O <= 64: 128x64, then 64x64 (fewer blocks than SMs)
    (2, 184, 184, 16, 16), (2, 184, 184, 16, 13), (1, 20, 36, 16, 12), (3, 22, 18, 32, 16),
    # N > 64: 128x128, then 64x64
    (2, 208, 208, 16, 32), (2, 200, 160, 16, 40), (4, 120, 100, 48, 33),
    (1, 36, 20, 32, 64), (1, 10, 6, 64, 20),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,ci,co,act", PALLAS_SHAPES + STEM_B16 + [
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,ci,co", EDGES)
def test_cuda_kernel_tile_edges(rng, n, h, w, ci, co):
    """Every tile of the launch table, with an arbitrary block kernel (the
    kernel does not rely on _s2d_weights' zeros) and per-image options."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    x, _, bias, m, x_zp, out_zp = _case(rng, n, h, w, ci, co, per_image=True)
    w_s2d = rng.integers(-128, 128, (3, 3, 4 * ci, 4 * co), dtype=np.int8)
    m = (m / 6).astype(np.float32)  # the block kernel's 4x taps: keep codes off the clamps
    args = [torch.from_numpy(a) for a in (x, w_s2d, bias, m, x_zp)]
    kw = dict(act=ACT_LEAKY, out_zp_static=out_zp, exact_leaky=True)
    ref = cuda_s2d.s2d_conv_phase_max_cuda(*args, **kw)
    got = cuda_s2d.s2d_conv_phase_max_cuda(*[a.cuda() for a in args], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_cuda_kernel_rejects_unaligned_input():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the alignment check guards the kernel only)")
    n, h, w, c, o = 1, 6, 6, 16, 8
    flat = torch.zeros(n * h * w * c + 16, dtype=torch.int8, device="cuda")
    x = flat[1:1 + n * h * w * c].view(n, h, w, c)  # contiguous, one byte off
    w_s2d = torch.zeros((3, 3, 4 * c, 4 * o), dtype=torch.int8, device="cuda")
    bias = torch.zeros(o, dtype=torch.int32, device="cuda")
    m = torch.ones(o, dtype=torch.float32, device="cuda")
    with pytest.raises(ValueError, match="16-byte boundary"):
        cuda_s2d.s2d_conv_phase_max_cuda(x, w_s2d, bias, m, 0)
