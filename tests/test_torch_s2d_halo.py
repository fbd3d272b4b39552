"""K2's halo design (``csrc/halo.cuh::halo_kernel`` with one B slice per
phase, launched by ``csrc/s2d_qconv.cu``): the structured/dense decision of
``cuda_s2d.pack_weights`` and its per-phase layout against ``_s2d_weights``;
the design's index arithmetic emulated in numpy (K1's halo tile from
``tests/test_torch_qconv_halo.py``: TMA's fetch, the zero-point fill, the
in-place reads; here with one B slice per output phase, applied per
fragment with the other dx's rows zeroed, then the phase max) and held
against the JAX package's Pallas s2d kernel in interpret mode and its conv,
requant and maxpool; the bank groups of the reads; the admission rule
against the s2d engine's route; on the card the design against the plain
version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_qconv_halo import (
    WARPS,
    bank_ways,
    fetch,
    fill_border,
    gather_rows,
    halo_offsets,
    tile_mi,
    tile_rows,
    tiles_of,
)
from yolo_quantization_tpu.infer.convert import _s2d_weights as j_s2d_weights
from yolo_quantization_tpu.nn import layers as jlayers
from yolo_quantization_tpu.ops import qconv as jqconv
from yolo_quantization_tpu.ops.pallas_qconv import pallas_s2d_conv_phase_max
from yolo_quantization_tpu_torch.infer.convert import _s2d_weights
from yolo_quantization_tpu_torch.ops import cuda_s2d
from yolo_quantization_tpu_torch.ops import qconv as tqconv
from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY, ACT_LINEAR, ACT_RELU, ACT_RELU6

torch.set_num_threads(2)


def phased_s2d(kernels):
    """A structured block kernel whose output phase ph (py*2+px) is the
    3x3 kernel ``kernels[ph]``: phase ph's columns of ``_s2d_weights``
    (JAX's) of that kernel."""
    o = kernels[0].shape[3]
    w = np.zeros_like(j_s2d_weights(kernels[0]))
    for ph, k in enumerate(kernels):
        w[..., ph * o:(ph + 1) * o] = j_s2d_weights(k)[..., ph * o:(ph + 1) * o]
    return w


def weights(rng, ci, co, distinct):
    """A structured block kernel: one 3x3 kernel's (distinct=False, as the
    engine converts it) or four phases' own."""
    ks = [rng.integers(-127, 128, (3, 3, ci, co)).astype(np.int8) for _ in range(4 if distinct else 1)]
    return phased_s2d(ks * (4 // len(ks)))


def test_pack_weights_decides_structured_or_dense(rng):
    """_s2d_weights' output packs as one shared slice, four phases' own
    kernels as four slices, and one stray nonzero outside the pattern (or
    channels the halo design does not take) as the dense operand."""
    ci, co = 16, 32
    w = rng.integers(-127, 128, (3, 3, ci, co)).astype(np.int8)
    one = cuda_s2d.pack_weights(torch.from_numpy(_s2d_weights(w)))
    assert tuple(one.shape) == cuda_s2d.phases_shape(ci, co, 1) == (1, 32, 160)
    four = cuda_s2d.pack_weights(torch.from_numpy(weights(rng, ci, co, True)))
    assert tuple(four.shape) == cuda_s2d.phases_shape(ci, co, 4)
    assert tuple(cuda_s2d.pack_phases(torch.from_numpy(_s2d_weights(w)), share=False).shape) == (4, 32, 160)
    structured = _s2d_weights(w)
    mask = np.zeros(structured.shape, bool)
    for k in range(4):
        mask |= phased_s2d([w * 0 + 1 if i == k else w * 0 for i in range(4)]) != 0
    assert mask.sum() == 4 * 9 * ci * co  # 9 taps of C x O a phase: a quarter of the block kernel
    for by, bx, s, col in [(0, 0, 0, 0), (2, 1, 63, 127), tuple(int(v) for v in np.argwhere(~mask)[77])]:
        if mask[by, bx, s, col]:
            continue
        stray = structured.copy()
        stray[by, bx, s, col] = 1
        kernels, ok = cuda_s2d.phase_kernels(torch.from_numpy(stray))
        assert not ok
        dense = cuda_s2d.pack_weights(torch.from_numpy(stray))
        assert tuple(dense.shape) == cuda_s2d.packed_shape(ci, co)
        np.testing.assert_array_equal(dense.numpy(), cuda_s2d.pack_dense(torch.from_numpy(stray)).numpy())
        with pytest.raises(ValueError, match="outside"):
            cuda_s2d.pack_phases(torch.from_numpy(stray))
    for c, o in [(16, 24), (8, 16), (64, 32), (3, 128)]:  # structured, channels off the halo rule
        w_s2d = _s2d_weights(rng.integers(-127, 128, (3, 3, c, o), dtype=np.int8))
        assert tuple(cuda_s2d.pack_weights(torch.from_numpy(w_s2d)).shape) == cuda_s2d.packed_shape(c, o)


@pytest.mark.parametrize("ci,co", [(3, 16), (16, 32), (32, 64), (48, 16)])
def test_phase_slices_hold_each_phase_kernel(rng, ci, co):
    """Slice ph is phase ph's 3x3 kernel packed as K1 packs one: row o,
    column (u*3 + v)*C + c, K = 9C zero-padded to 32."""
    ks = [rng.integers(-127, 128, (3, 3, ci, co)).astype(np.int8) for _ in range(4)]
    b = cuda_s2d.pack_weights(torch.from_numpy(phased_s2d(ks))).numpy()
    k_pad = -(-9 * ci // 32) * 32
    assert b.shape == (4, co, k_pad)
    for ph, k in enumerate(ks):
        np.testing.assert_array_equal(b[ph, :, :9 * ci], k.reshape(9 * ci, co).T)
        assert not b[ph, :, 9 * ci:].any()
    kernels, ok = cuda_s2d.phase_kernels(torch.from_numpy(phased_s2d(ks)))
    assert ok and all(np.array_equal(kernels[ph].numpy(), k) for ph, k in enumerate(ks))


def emulate_s2d(x, w_s2d, x_zp):
    """The phase-max accumulators as the halo design forms them: per tile
    K1's fetch, zero-point fill and A rows in the pooled order; m16 tile mi
    (its pixels' dy = mi % 2) multiplied by slices (dy, 0) and (dy, 1) of
    ``pack_weights``, each with the A rows of the other dx zeroed (row g of
    a fragment has dx g / 4, row 8 + g the other), into one accumulator;
    then each thread's max over its four rows.  (N, H/2, W/2, O) int64."""
    n, h, w, ci = x.shape
    b = cuda_s2d.pack_weights(torch.from_numpy(w_s2d)).numpy().astype(np.int64)
    phases, co = b.shape[0], b.shape[1]
    mi = tile_mi(co, 1)
    th = 2 * mi
    _, r, py, px = tile_rows(True, mi)
    g, upper = r % 8, (r % 16) >= 8  # the row's lane group, and whether it is row 8 + g of its fragment
    dy = (r // 16) % 2
    out = np.full((n, h // 2, w // 2, co), np.iinfo(np.int64).min, np.int64)
    for img, y0, x0 in tiles_of(n, h, w, th):
        buf = fetch(x, img, y0, x0, 1, th, ci == 3)
        fill_border(buf, h, w, y0, x0, 1, th, x_zp[img], ci)
        a = gather_rows(buf, ci, 1, th, py, px)
        acc = np.zeros((len(a), co), np.int64)
        for ph in range(4):
            keep = (dy == ph >> 1) & (((g >> 2) == (ph & 1)) != upper)
            acc += (a * keep[:, None]) @ b[ph % phases].T
        for wp in range(WARPS):
            for u in range(mi // 2):
                for gg in range(8):
                    held = [16 * mi * wp + 32 * u + k for k in (gg, gg + 8, 16 + gg, 24 + gg)]
                    y, xx = y0 // 2 + 2 * u + (gg >> 2), x0 // 2 + 4 * wp + (gg & 3)
                    if y < h // 2 and xx < w // 2:
                        out[img, y, xx] = acc[held].max(axis=0)
    return out


def jax_phase_max(x, w_s2d, x_zp):
    """The JAX conv over the space-to-depth input, maxed over the phases."""
    xs = tqconv.space_to_depth(torch.from_numpy(x)).numpy()
    co = w_s2d.shape[3] // 4
    acc = np.concatenate([
        np.asarray(jqconv.conv_acc_int32(jnp.asarray(xs[i:i + 1]), jnp.asarray(w_s2d), jnp.int32(x_zp[i]),
                                         jnp.zeros((4 * co,), jnp.int32), 1, 1, symmetric=True))
        for i in range(len(x))])
    return acc.reshape(*acc.shape[:3], 4, co).max(axis=3)


@pytest.mark.parametrize("n,h,w,ci,co,act,distinct", [
    (2, 10, 48, 3, 16, ACT_RELU6, False), (1, 20, 32, 3, 16, ACT_LEAKY, True),
    (2, 6, 34, 16, 32, ACT_LEAKY, False), (1, 8, 36, 16, 32, ACT_LINEAR, True),
    (1, 6, 40, 32, 64, ACT_RELU, True), (1, 4, 32, 48, 16, ACT_RELU6, True),
])
def test_halo_emulation_matches_pallas_s2d(rng, n, h, w, ci, co, act, distinct):
    """The emulated design's phase-max accumulators equal the JAX package's
    conv over the space-to-depth input, per-image zero points included, and
    through the epilogue its Pallas s2d kernel (interpret mode, one image
    and zero point at a time) and, with exact_leaky, its conv -> requant ->
    maxpool.  Tiles past the map's edge, one shared and four own phase
    kernels, C 3/16/32/48."""
    x = rng.integers(-128, 128, (n, h, w, ci), dtype=np.int8)
    w_s2d = weights(rng, ci, co, distinct)
    x_zp = rng.integers(-128, 128, (n,)).astype(np.int32)
    got = emulate_s2d(x, w_s2d, x_zp)
    np.testing.assert_array_equal(got, jax_phase_max(x, w_s2d, x_zp))
    bias = rng.integers(-4000, 4000, (co,)).astype(np.int32)
    m = rng.uniform(0.0005, 0.004, (co,)).astype(np.float32)
    out_zp = int(rng.integers(0, 32))
    codes = tqconv.requant_activate(torch.from_numpy(got).to(torch.int32), torch.from_numpy(bias),
                                    torch.from_numpy(m), out_zp, act, out_i8=True).numpy()
    xs = tqconv.space_to_depth(torch.from_numpy(x)).numpy()
    for i in range(n):
        want = pallas_s2d_conv_phase_max(
            jnp.asarray(xs[i:i + 1]), jnp.asarray(w_s2d), jnp.asarray(bias), jnp.asarray(m),
            jnp.int32(x_zp[i]), act=act, out_zp_static=out_zp, interpret=True)
        np.testing.assert_array_equal(codes[i:i + 1], np.asarray(want))
    if act == ACT_LEAKY and not distinct:  # darknet's double-rounded leaky, against conv -> requant -> pool
        exact = tqconv.requant_activate(torch.from_numpy(got).to(torch.int32), torch.from_numpy(bias),
                                        torch.from_numpy(m), out_zp, act, out_i8=True, exact_leaky=True).numpy()
        w3 = cuda_s2d.phase_kernels(torch.from_numpy(w_s2d))[0][0].numpy()
        for i in range(n):
            want = jlayers.maxpool_u8(jqconv.quantized_conv2d(
                jnp.asarray(x[i:i + 1]), jnp.asarray(w3), jnp.asarray(bias), jnp.asarray(m), jnp.int32(x_zp[i]),
                jnp.zeros(co, jnp.int32), jnp.int32(out_zp), stride=1, pad=1, act=act, symmetric=True,
                out_i8=True, exact_leaky=True), 2, 2, 1)
            np.testing.assert_array_equal(exact[i:i + 1], np.asarray(want))


def test_fragment_masks_select_each_rows_phase():
    """In every m16 tile of the pooled tile the rows a slice keeps are the
    rows whose pixel has that slice's phase, each row kept by exactly one
    of the tile's two slices and no tile's row by another dy's slice."""
    for co in (16, 32, 64):
        mi = tile_mi(co, 1)
        _, r, py, px = tile_rows(True, mi)
        g, upper, dy = r % 8, (r % 16) >= 8, (r // 16) % 2
        kept = np.zeros(len(r), int)
        for ph in range(4):
            keep = (dy == ph >> 1) & (((g >> 2) == (ph & 1)) != upper)
            assert ((py[keep] % 2) * 2 + px[keep] % 2 == ph).all()
            kept += keep
        assert (kept == 1).all()


@pytest.mark.parametrize("ci", [16, 32, 48])
def test_bank_groups_of_the_reads(ci):
    """The A reads are K1's pooled ones (8 distinct bank groups a phase);
    every B slice's ldmatrix rows (pitch K_pad + 16, an odd number of
    chunks) too.  Rows regrouped by phase, the alternative to the fragment
    masks, would put 8 same-phase pixels (an even number of pixels apart)
    on 4 groups: 2-way on every A read."""
    for co in (16, 32, 64):
        mt = tile_mi(co, 1)
        _, _, py, px = tile_rows(True, mt)
        for start in range(0, 64 * mt, 8):
            for off in halo_offsets(ci, 1, py[start:start + 8], px[start:start + 8]):
                if off is not None:
                    assert bank_ways(off) == 1
        stride = -(-9 * ci // 32) * 32 + 16
        for ph in range(4):
            for first in range(0, co, 8):
                assert bank_ways([(ph * co + first + i) * stride for i in range(8)]) == 1
        # 8 windows (4 wide, 2 tall, as a pooled phase reads them) at one phase
        wy, wx = np.divmod(np.arange(8), 4)
        for q in range(4):
            for off in halo_offsets(ci, 1, 2 * wy + q // 2, 2 * wx + q % 2):
                if off is not None:
                    assert bank_ways(off) == 2


def s2d_layers():
    """(layer, input width, C, O, w_s2d) of the flagship's s2d-converted
    convs at 416."""
    from yolo_quantization_tpu_torch.models.presets import flagship_program
    from yolo_quantization_tpu_torch.tools.kernel_timings import flagship_layers

    program = flagship_program(classes=5, size=416, seed=0)
    widths = {i: w for (i, h, w, *_rest) in flagship_layers()}
    return [(i, widths[i], program.arrays[i]["w_s2d"].shape[2] // 4, program.arrays[i]["w_s2d"].shape[3] // 4,
             program.arrays[i]["w_s2d"])
            for i, c in enumerate(program.cfg) if c.kind == "qconv" and c.s2d_pool]


def test_admission_rule_takes_the_s2d_engines_convs():
    """The flagship at 416 with use_s2d: layers 0, 2 and 4 (C 3, 16, 32 to
    O 16, 32, 64 at widths 416, 208, 104) are structured, share one slice,
    and route to the halo design; the rule's edges as qconv.cu's halo rule
    for K1's pooled 3x3 convs."""
    layers = s2d_layers()
    assert [(i, w, c, o) for i, w, c, o, _ in layers] == [(0, 416, 3, 16), (2, 208, 16, 32), (4, 104, 32, 64)]
    for i, w, c, o, ws in layers:
        packed = cuda_s2d.pack_weights(torch.from_numpy(ws))
        assert tuple(packed.shape) == cuda_s2d.phases_shape(c, o, 1)
        assert cuda_s2d.design(c, o, w=w, structured=True) == "halo"
        assert cuda_s2d.forcible(c, o, w=w) == ("mma.sync", "halo")
    assert cuda_s2d.halo_capable(3, 16, w=416) and not cuda_s2d.halo_capable(3, 16, w=424)
    assert cuda_s2d.halo_capable(48, 64, w=30) and not cuda_s2d.halo_capable(64, 64, w=32)
    assert not cuda_s2d.halo_capable(16, 24, w=32) and not cuda_s2d.halo_capable(5, 16, w=32)
    assert cuda_s2d.design(16, 32, w=32, structured=False) == "mma.sync"
    assert cuda_s2d.forcible(6, 8, w=32) == ()


def test_forced_design_is_checked(rng):
    """``_design`` takes "mma.sync" or "halo" on a conv the halo design can
    run, and raises elsewhere; on the CPU it runs the plain version."""
    x = torch.from_numpy(rng.integers(-128, 128, (1, 6, 32, 16), dtype=np.int8))
    ws = torch.from_numpy(weights(rng, 16, 32, False))
    b, m = torch.zeros(32, dtype=torch.int32), torch.full((32,), 0.001)
    want = cuda_s2d.s2d_conv_phase_max_cuda(x, ws, b, m, 3)
    for forced in ("mma.sync", "halo"):
        assert torch.equal(cuda_s2d.s2d_conv_phase_max_cuda(x, ws, b, m, 3, _design=forced), want)
    with pytest.raises(ValueError, match="forced"):
        cuda_s2d.s2d_conv_phase_max_cuda(x, ws, b, m, 3, _design="wgmma")
    x6 = torch.zeros((1, 6, 32, 6), dtype=torch.int8)
    with pytest.raises(ValueError, match="cannot run"):
        cuda_s2d.s2d_conv_phase_max_cuda(x6, torch.zeros((3, 3, 24, 32), dtype=torch.int8), b, m, 3,
                                         _design="halo")


def test_reset_launches_zeroes_both_counts():
    cuda_s2d.launches = 3
    cuda_s2d.design_launches["halo"] = 2
    cuda_s2d.reset_launches()
    assert cuda_s2d.launches == 0 and cuda_s2d.design_launches == {"halo": 0, "mma.sync": 0}


# the halo design's edges on the card (n, h, w, ci, co): the flagship's stem
# shapes cut in height, batch 1 and 3, tiles past the map's edge in both
# directions, every C (3, 16, 32, 48) and O (16, 32, 64) it takes
S2D_HALO_EDGES = [
    (1, 30, 48, 3, 16), (3, 18, 416, 3, 16), (2, 34, 80, 3, 32), (1, 10, 32, 3, 64),
    (2, 26, 208, 16, 32), (1, 14, 66, 16, 16), (3, 12, 104, 32, 64), (1, 22, 38, 32, 32),
    (2, 6, 34, 48, 64), (1, 18, 50, 48, 16),
]


def _card_case(rng, n, h, w, ci, co, distinct):
    x = rng.integers(-128, 128, (n, h, w, ci), dtype=np.int8)
    w_s2d = weights(rng, ci, co, distinct)
    bias = rng.integers(-4000, 4000, (n, co)).astype(np.int32)
    m = rng.uniform(0.0005, 0.004, (n, co)).astype(np.float32)
    x_zp = rng.integers(-128, 128, (n,)).astype(np.int32)
    return [torch.from_numpy(a) for a in (x, w_s2d, bias, m, x_zp)]


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [None, "mma.sync"])
@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("n,h,w,ci,co", S2D_HALO_EDGES)
def test_cuda_halo_matches_plain(rng, n, h, w, ci, co, distinct, forced):
    """Routed to halo (one shared or four own slices) or forced onto
    mma.sync, bit for bit against the plain version, with per-image zero
    points, bias and m and exact_leaky."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    args = _card_case(rng, n, h, w, ci, co, distinct)
    kw = dict(act=ACT_LEAKY, out_zp_static=int(rng.integers(0, 64)), exact_leaky=True)
    ref = cuda_s2d.s2d_conv_phase_max_cuda(*args, **kw)
    cuda_s2d.reset_launches()
    got = cuda_s2d.s2d_conv_phase_max_cuda(*[a.cuda() for a in args], _design=forced, **kw)
    torch.cuda.synchronize()
    assert cuda_s2d.design_launches == {"halo": 0 if forced else 1, "mma.sync": 1 if forced else 0}
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_cuda_halo_in_a_captured_graph(rng):
    """The design's TMA map is a kernel parameter: a captured graph replays
    it, and the replay equals the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    args = _card_case(rng, 2, 32, 64, 3, 16, True)
    ref = cuda_s2d.s2d_conv_phase_max_cuda(*args, act=ACT_RELU6)
    dev = [a.cuda() for a in args]
    packed = cuda_s2d.pack_weights(dev[1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_s2d.s2d_conv_phase_max_cuda(*dev, act=ACT_RELU6, w_packed=packed)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cuda_s2d.s2d_conv_phase_max_cuda(*dev, act=ACT_RELU6, w_packed=packed)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), ref)
