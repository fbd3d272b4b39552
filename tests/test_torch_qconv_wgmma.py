"""K1's wgmma design (``csrc/qconv.cu::qconv_wgmma_kernel``): its index
arithmetic emulated in numpy and held against the JAX package's integer conv,
the route rule against the models' layers, and on the card both designs
against the plain version at every entry of the wgmma tile table."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_quantization_tpu.nn import layers as jlayers
from yolo_quantization_tpu.ops import qconv as jqconv
from yolo_quantization_tpu_torch.models import zoo
from yolo_quantization_tpu_torch.nn.graph import ConvSpec
from yolo_quantization_tpu_torch.ops import cuda_qconv
from yolo_quantization_tpu_torch.ops import qconv as tqconv
from yolo_quantization_tpu_torch.ops.qconv import ACT_LEAKY, ACT_RELU6

torch.set_num_threads(2)



def wrow_pixel(r, n, ho, wo, pool):
    """``qconv.cu::wrow_pixel`` over an array of GEMM rows: (valid, img, oy,
    ox).  With pool, row 64 mt + 16 w + 8 h + g of each 128-row group is
    pixel (dy, dx) = (mt, h) of window 32 * group + 8 w + g."""
    if pool:
        rr = r & 127
        win = (r >> 7) * 32 + ((rr >> 4) & 3) * 8 + (rr & 7)
        pw, phw = wo // 2, (ho // 2) * (wo // 2)
        valid = win < n * phw
        img, rem = np.divmod(np.minimum(win, n * phw - 1), phw)
        py, px = np.divmod(rem, pw)
        return valid, img, 2 * py + (rr >> 6), 2 * px + ((rr >> 3) & 1)
    valid = r < n * ho * wo
    img, rem = np.divmod(np.minimum(r, n * ho * wo - 1), ho * wo)
    oy, ox = np.divmod(rem, wo)
    return valid, img, oy, ox


def swizzle(r, c, bk):
    """The shared layouts (``hopper.cuh``): 16-byte chunk c of row r lies at
    chunk c ^ ((r >> 1) & 3) of the row in the 64-byte swizzle (64-byte
    slabs), at c ^ (r & 7) in the 128-byte one (128-byte slabs)."""
    return c ^ (r & 7) if bk == 128 else c ^ ((r >> 1) & 3)


def slab_bytes(ci, pool):
    """The K slab ``launch_wgmma_bk`` picks: 128 channels where Ci allows,
    64 with the fused pool."""
    return 128 if ci % 128 == 0 and not pool else 64


def producer_slabs(x, k, pad, stride, x_zp_img, bm, pool, bk, m0=0):
    """The A tiles the producer warpgroup writes for the block at row m0,
    slab by slab, as the kernel does: thread pt fills 16-byte chunk pt % C
    (C = bk / 16) of rows pt // C + (128 / C) i at its swizzled place,
    walking (dy, dx, c0) slab by slab; a pixel outside the map gets the
    image's zero point.  Returns the shared bytes (nk, bm, bk) as laid out,
    the rows' validity and each slab's B column (where TMA reads the packed
    weights)."""
    n, h, w, ci = x.shape
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    chunks, nk = bk // 16, k * k * ci // bk
    rpp = 128 // chunks
    smem = np.full((nk, bm, bk), -1, np.int64)
    valid_rows = np.zeros(bm, bool)
    b_cols = []
    dy = dx = c0 = 0
    for kt in range(nk):
        b_cols.append((dy * k + dx) * ci + c0)
        flat = smem[kt].reshape(-1)
        for pt in range(128):
            chunk, r0 = pt % chunks, pt // chunks
            dst = r0 * bk + (swizzle(r0, chunk, bk) << 4)
            for i in range(bm // rpp):
                r = r0 + rpp * i
                assert swizzle(r, chunk, bk) == swizzle(r0, chunk, bk)  # the pass keeps the swizzle
                valid, img, oy, ox = (int(v) for v in wrow_pixel(np.array(m0 + r), n, ho, wo, pool))
                valid_rows[r] = valid
                iy = oy * stride - pad + dy if valid else -(2**29)
                ix = ox * stride - pad + dx
                at = dst + i * rpp * bk
                if 0 <= iy < h and 0 <= ix < w:
                    flat[at:at + 16] = x[img, iy, ix, c0 + 16 * chunk:c0 + 16 * chunk + 16]
                else:
                    flat[at:at + 16] = x_zp_img[img]
        c0 += bk
        if c0 == ci:
            c0, dx = 0, dx + 1
            if dx == k:
                dx, dy = 0, dy + 1
    return smem, valid_rows, b_cols


def descriptor_rows(smem, bk):
    """What the wgmma descriptors read from the swizzled stages: logical row r,
    K bytes 0 .. bk-1 of each slab (chunk c at its swizzled place),
    concatenated over the slabs: the A operand (bm, K)."""
    nk, bm, _ = smem.shape
    r = np.arange(bm)[:, None]
    cols = np.arange(bk)[None, :]
    phys = swizzle(r, cols // 16, bk) * 16 + cols % 16
    return np.concatenate([smem[kt][r, phys] for kt in range(nk)], axis=1)


def quad_patchsums(smem, bk):
    """ASYM's patchsum as the consumers take it: thread tq of a quad sums
    physical chunks tq, tq + 4, ... of each of its rows in every slab; the
    shuffles add the quad's four sums."""
    return sum(smem[:, :, 16 * c:16 * c + 16].sum(axis=(0, 2)) for tq in range(4)
               for c in range(tq, bk // 16, 4))


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("n,h,w,ci,k,pad,stride,pool", [
    (2, 7, 9, 64, 3, 1, 1, False), (1, 13, 13, 128, 3, 1, 2, False), (2, 5, 6, 64, 1, 0, 1, False),
    (1, 9, 11, 64, 1, 0, 2, False), (2, 4, 4, 256, 3, 1, 1, False), (1, 10, 7, 128, 3, 1, 2, False),
    (2, 6, 10, 64, 3, 1, 1, True), (1, 14, 6, 128, 3, 1, 1, True), (2, 4, 4, 192, 1, 0, 1, True),
])
def test_producer_gather_matches_jax_conv_acc(rng, n, h, w, ci, k, pad, stride, pool, symmetric):
    """The producer's slab walk and swizzled stores (64- or 128-byte slabs;
    the pooled row order with the fused pool), read back through the
    descriptors' layout and multiplied by the packed weights at the slabs'
    B columns, minus w_zp[o] times the quad's patchsum of the staged bytes:
    each row equals the JAX package's conv_acc_int32 at its pixel, with a
    per-image zero point, at stride 1 and 2."""
    x = rng.integers(-128, 128, (n, h, w, ci), dtype=np.int8)
    wt = rng.integers(-128, 128, (k, k, ci, 24), dtype=np.int8)
    w_zp = rng.integers(-128, 128, (24,)).astype(np.int32)
    x_zp = rng.integers(-128, 128, (n,)).astype(np.int32)
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    rows = 4 * n * (ho // 2) * (wo // 2) if pool else n * ho * wo
    bm = 128 * -(-rows // 128)
    bk = slab_bytes(ci, pool)
    smem, valid, b_cols = producer_slabs(x, k, pad, stride, x_zp, bm, pool=pool, bk=bk)
    assert (smem >= -128).all()  # every byte of every slab written
    a = descriptor_rows(smem, bk)
    b = cuda_qconv.pack_weights(torch.from_numpy(wt)).numpy().astype(np.int64)
    assert b.shape[1] == a.shape[1] == k * k * ci  # Ci % 64 == 0: no K padding
    b = np.concatenate([b[:, c:c + bk] for c in b_cols], axis=1)  # TMA's boxes, slab by slab
    acc = (a @ b.T)[:, :24]
    if not symmetric:
        acc = acc - w_zp.astype(np.int64) * quad_patchsums(smem, bk)[:, None]
    got = ((acc + 2**31) % 2**32 - 2**31).astype(np.int32)[valid]
    want = np.concatenate([
        np.asarray(jqconv.conv_acc_int32(jnp.asarray(x[i:i + 1]), jnp.asarray(wt), jnp.int32(x_zp[i]),
                                         jnp.asarray(w_zp), stride, pad, symmetric=symmetric))
        for i in range(n)])
    _, img, oy, ox = wrow_pixel(np.arange(bm)[valid], n, ho, wo, pool=pool)
    np.testing.assert_array_equal(got, want[img, oy, ox])


@pytest.mark.parametrize("n,h,w", [(2, 6, 10), (1, 14, 6), (3, 4, 4), (1, 26, 26)])
def test_wgmma_pooled_rows_match_maxpool(rng, n, h, w):
    """The pooled row order under wgmma's accumulator layout: thread (warp w,
    g) of a warpgroup holds rows 16 w + g and 16 w + g + 8 of its two m64
    tiles; maxed, they equal the JAX 2x2/s2 maxpool of conv_acc_int32 at
    window 32 * group + 8 w + g, the partial last tile included, and every
    window is held by exactly one thread."""
    x = rng.integers(-128, 128, (n, h, w, 64), dtype=np.int8)
    wt = rng.integers(-128, 128, (3, 3, 64, 8), dtype=np.int8)
    acc = np.asarray(jqconv.conv_acc_int32(jnp.asarray(x), jnp.asarray(wt), jnp.int32(5),
                                           jnp.zeros((8,), jnp.int32), 1, 1, symmetric=True))
    windows = n * (h // 2) * (w // 2)
    rows = 128 * -(-4 * windows // 128)
    pooled = np.full((windows, 8), np.iinfo(np.int32).min, np.int64)
    seen = np.zeros(windows, int)
    for group in range(rows // 128):
        for warp in range(4):
            for g in range(8):
                held = [group * 128 + 64 * mt + 16 * warp + 8 * hh + g for mt in (0, 1) for hh in (0, 1)]
                valid, img, oy, ox = wrow_pixel(np.array(held), n, h, w, pool=True)
                win = group * 32 + 8 * warp + g
                assert valid.all() == (win < windows) and valid.any() == valid.all()
                if win >= windows:
                    continue
                seen[win] += 1
                pooled[win] = acc[img, oy, ox].max(axis=0)
    assert (seen == 1).all()
    ref = np.asarray(jlayers.maxpool_u8(jnp.asarray(acc), 2, 2, 1))
    np.testing.assert_array_equal(pooled.reshape(n, h // 2, w // 2, 8), ref)


@pytest.mark.parametrize("bk", [64, 128])
def test_swizzled_chunks_cover_each_row(bk):
    """A row's chunks land on distinct places of the row, and the quads'
    patchsum reads (chunks tq, tq + 4) cover each physical chunk once."""
    chunks = bk // 16
    for r in range(256):
        assert sorted(swizzle(r, c, bk) for c in range(chunks)) == list(range(chunks))
    assert sorted(c for tq in range(4) for c in range(tq, chunks, 4)) == list(range(chunks))


def conv_inputs(net):
    """(layer, ci, k, stride, pad, input width) of every conv of a network,
    Ci and the width from the layer that feeds it."""
    shapes = net.shapes()
    out = []
    for i, s in enumerate(net.specs):
        if isinstance(s, ConvSpec):
            _, w, ci = shapes[i - 1] if i else (net.height, net.width, 3)
            out.append((i, ci, s.size, s.stride, s.pad, w))
    return out


# per model: wgmma convs, the halo design's (the narrow 3x3 stem convs), and
# the mma.sync ones: the 1x1 convs sent back after the H100 ran them slower
# on wgmma (Ci <= 128; yolov3's 255-channel heads with Ci <= 512)
ROUTES = {
    "yolov3_tiny": (10, (0, 2, 4), ()),
    "yolov3": (67, (0, 1, 3), (2, 6, 9, 93, 105)),
    "yolov2_tiny": (6, (0, 2, 4), ()),
    "yolov2": (20, (0, 2), (5,)),
}


@pytest.mark.parametrize("model", sorted(ROUTES))
def test_route_rule_by_model(model):
    """``design``, the wrapper's mirror of the kernel's route rule, sends the
    models' convs where the three designs say: the int8 convs with Ci a
    multiple of 64 to wgmma (the flagship's layers 6-22, yolov3's stride-2
    convs from Ci 64), but for the 1x1 convs sent back to mma.sync; the
    narrow 3x3 stem convs (Ci 3, 16, 32) to the halo design; the int16
    carrier to its own kernel."""
    wgmma, halo, mma = ROUTES[model]
    net = getattr(zoo, model)(**({"classes": 5} if model == "yolov3_tiny" else {}), width=416, height=416)
    shapes = net.shapes()
    convs = conv_inputs(net)
    routes = {i: cuda_qconv.design(ci, k, net.specs[i].filters, pad=pad, w=w) for i, ci, k, _, pad, w in convs}
    assert sorted(i for i, r in routes.items() if r == "mma.sync") == list(mma)
    assert sorted(i for i, r in routes.items() if r == "halo") == list(halo)
    assert sum(r == "wgmma" for r in routes.values()) == wgmma
    for i, ci, k, stride, pad, w in convs:
        co = shapes[i][2]
        sent_back = k == 1 and (ci <= 128 or (co > 128 and co % 16 and ci <= 512))
        narrow = k == 3 and ci in (3, 16, 32) and co <= 64
        want = "halo" if narrow else "wgmma" if ci % 64 == 0 and not sent_back else "mma.sync"
        assert routes[i] == want, (i, ci, k, stride)
        assert cuda_qconv.design(ci, k, co, "int16", pad=pad, w=w) == "int16"
    if model == "yolov3_tiny":
        assert sorted(i for i, r in routes.items() if r == "wgmma") == [6, 8, 10, 12, 13, 14, 15, 18, 21, 22]
    if model == "yolov3":
        assert [ci for i, ci, k, s, _, _ in convs if s == 2] == [32, 64, 128, 256, 512]
        assert [routes[i] for i, ci, k, s, _, _ in convs if s == 2] == ["halo"] + ["wgmma"] * 4


def test_forced_design_is_checked(rng):
    """``_design`` forces either design, only on a conv the wgmma design (or
    the halo design) can run; on the CPU the plain version runs whatever the
    design."""
    x = torch.from_numpy(rng.integers(-128, 128, (1, 6, 6, 64), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (3, 3, 64, 16), dtype=np.int8))
    b, m = torch.zeros(16, dtype=torch.int32), torch.full((16,), 1e-3)
    before = cuda_qconv.launches
    want = tqconv.quantized_conv2d(x, w, b, m, 0, None, 0, pad=1, symmetric=True)
    for forced in ("mma.sync", "wgmma"):
        assert torch.equal(cuda_qconv.quantized_conv2d_cuda(x, w, b, m, 0, pad=1, _design=forced), want)
    assert cuda_qconv.launches == before
    with pytest.raises(ValueError, match="may be forced"):
        cuda_qconv.quantized_conv2d_cuda(x, w, b, m, 0, pad=1, _design="int16")
    with pytest.raises(ValueError, match="cannot run"):  # Ci 8: mma.sync's alone
        cuda_qconv.quantized_conv2d_cuda(x[..., :8].contiguous(), w[:, :, :8].contiguous(), b, m, 0,
                                         pad=1, _design="mma.sync")
    with pytest.raises(ValueError, match="cannot run"):
        cuda_qconv.quantized_conv2d_cuda(x, w, b, m, 0, pad=1, carrier="int16", _design="wgmma")


def test_reset_launches():
    cuda_qconv.design_launches["wgmma"] += 1
    cuda_qconv.reset_launches()
    assert cuda_qconv.launches == 0 and set(cuda_qconv.design_launches.values()) == {0}


# The wgmma tile table on a 132-SM card (qconv.cu::launch_wgmma_tile), each
# entry with a partial M tile, Co off the N tile where it can be (the 1x1
# convs from Ci 64 route to mma.sync and reach the table forced):
# (n, h, w, ci, co, k, pad, stride, fuse_pool)
WGMMA_EDGES = [
    # the fused pool, one warpgroup of two m64 tiles: N 32, 64, 128 (Co 130: a
    # second N tile past Co_pad, filled by TMA with zeros)
    (2, 10, 14, 64, 30, 3, 1, 1, True),
    (3, 12, 10, 64, 64, 3, 1, 1, True),
    (2, 26, 26, 128, 130, 3, 1, 1, True),
    # Co <= 32: 128 x 32 where the grid fills the card, else 64 x 32 (Co 16:
    # the box has more rows than Co_pad)
    (40, 26, 26, 64, 30, 1, 0, 1, False),
    (2, 13, 13, 64, 16, 3, 1, 1, False),
    # Co > 64 where a 64 x 128 grid fills the card: 64 x 128
    (16, 26, 26, 128, 256, 3, 1, 1, False),
    (16, 13, 13, 256, 512, 3, 1, 1, False),
    (8, 25, 25, 64, 130, 3, 1, 1, False),
    # else 128 x 64 from a GEMM depth of 512 or where its grid fills the card
    (2, 13, 13, 512, 256, 3, 1, 1, False),
    (40, 13, 13, 128, 64, 3, 1, 1, False),
    (16, 52, 52, 64, 64, 1, 0, 1, False),
    # else 64 x 64
    (2, 9, 11, 64, 130, 1, 0, 1, False),
    (2, 20, 20, 64, 64, 1, 0, 1, False),
    # stride 2: 64 x 64 at yolov3's 26 -> 13, odd maps, 1x1
    (16, 26, 26, 128, 256, 3, 1, 2, False),
    (4, 21, 17, 64, 96, 3, 1, 2, False),
    (2, 9, 11, 64, 40, 1, 0, 2, False),
]


def _edge_inputs(rng, n, h, w, ci, co, k, variant):
    x = rng.integers(-128, 128, (n, h, w, ci), dtype=np.int8)
    wt = rng.integers(-128, 128, (k, k, ci, co), dtype=np.int8)
    m_scale = 40.0 / (np.sqrt(k * k * ci) * 5300.0)
    per_image = variant == "all"
    shape = (n, co) if per_image else (co,)
    bias = rng.integers(-(2**14), 2**14, shape).astype(np.int32)
    m = (rng.uniform(0.5, 2.0, shape) * m_scale).astype(np.float32)
    x_zp = torch.from_numpy(rng.integers(-128, 128, (n,)).astype(np.int32)) if per_image else -45
    w_zp = torch.from_numpy(rng.integers(-128, 128, (co,)).astype(np.int32)) if variant else None
    return [torch.from_numpy(a) for a in (x, wt, bias, m)], x_zp, w_zp


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [None, "wgmma", "mma.sync"])
@pytest.mark.parametrize("variant", ["", "asym", "all"])
@pytest.mark.parametrize("n,h,w,ci,co,k,pad,stride,fuse_pool", WGMMA_EDGES)
def test_cuda_both_designs_match_plain(rng, n, h, w, ci, co, k, pad, stride, fuse_pool, variant, forced):
    """Each entry of the wgmma tile table, routed, forced onto wgmma and
    forced onto mma.sync, equals the plain version bit for bit: symmetric,
    asymmetric, and with a per-image zero point, (N, Co) bias/m and
    exact_leaky."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    args, x_zp, w_zp = _edge_inputs(rng, n, h, w, ci, co, k, variant)
    call = dict(stride=stride, pad=pad, act=ACT_LEAKY, out_zp_static=77, out_i8=True,
                fuse_pool=fuse_pool, exact_leaky=variant == "all")
    ref = cuda_qconv.quantized_conv2d_cuda(*args, x_zp, w_zp=w_zp, **call)
    cu = lambda t: t.cuda() if isinstance(t, torch.Tensor) else t  # noqa: E731
    cuda_qconv.reset_launches()
    got = cuda_qconv.quantized_conv2d_cuda(*[cu(a) for a in args], cu(x_zp), w_zp=cu(w_zp), _design=forced,
                                           **call)
    torch.cuda.synchronize()
    ran = forced or cuda_qconv.design(ci, k, co, pad=pad, w=w)
    assert cuda_qconv.design_launches == {"wgmma": int(ran == "wgmma"), "halo": 0,
                                          "mma.sync": int(ran == "mma.sync"), "int16": 0}
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_cuda_wgmma_in_a_captured_graph(rng):
    """The weights' TMA map is cached per (pointer, shape, box): a CUDA graph
    of wgmma launches replays to the eager result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    args, x_zp, _ = _edge_inputs(rng, 4, 13, 13, 256, 512, 3, "")
    x, wt, bias, m = (a.cuda() for a in args)
    wp = cuda_qconv.pack_weights(wt)
    call = dict(pad=1, act=ACT_RELU6, out_i8=True, w_packed=wp)
    eager = cuda_qconv.quantized_conv2d_cuda(x, wt, bias, m, x_zp, **call)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_qconv.quantized_conv2d_cuda(x, wt, bias, m, x_zp, **call)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cuda_qconv.quantized_conv2d_cuda(x, wt, bias, m, x_zp, **call)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
