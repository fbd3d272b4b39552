"""K1's halo design (``csrc/qconv.cu::qconv_halo_kernel``): its index
arithmetic emulated in numpy (the tiles and their halos, TMA's fetch, the
border's zero-point fill, the (row, tap) -> halo offsets that ``ldmatrix``
reads, the 3-channel rows built with word loads and byte permutes) and held
against the JAX package's integer conv and maxpool; the route rule against
the models' layers; on the card the design against the plain version."""

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

TW = 32  # qconv.cu::kHaloTW: a tile's width in output pixels
WARPS = 4
LEAD = 13  # HaloTile::STEM_LEAD: Ci = 3's first code lies 13 bytes past a 16-byte boundary


def tile_mi(co, s):
    """``HaloTile<S, NT>::MI``: m16 tiles a warp, 64 accumulators a thread
    (NT = Co / 8), at most 4 at stride 2; a tile is TH = 2 MI rows."""
    return min(16 // (co // 8), 4 if s == 2 else 8)


def halo_dims(s, th):
    """``HaloTile``: (rows, pixels) of a tile's halo, and Ci = 3's bytes a
    row uses and takes (from the 16-byte boundary below the first, rounded
    up to 16)."""
    hh, hw = (th - 1) * s + 3, (TW - 1) * s + 3
    return hh, hw, 3 * hw, -(-(LEAD + 3 * hw) // 16) * 16


def pitch(ci):
    """``halo_layout``'s bytes a halo pixel: an odd number of 16-byte chunks."""
    return ci if (ci // 16) % 2 else ci + 16


def row_pixel(warp, r, pool, mi):
    """``halo_row_pixel`` over arrays of rows r (0 .. 16 mi - 1) of a warp."""
    u, rr = r >> 5, r & 31
    if pool:
        a, j = rr >> 3, rr & 7
        wy = j >> 2
        q = a ^ wy
        return 4 * u + 2 * wy + (q >> 1), 8 * warp + 2 * (j & 3) + (q & 1)
    return (mi // 2) * warp + u, rr


def tile_rows(pool, mi):
    """(warp, row, py, px) of a tile's 64 mi GEMM rows."""
    warp, r = np.divmod(np.arange(64 * mi), 16 * mi)
    py, px = row_pixel(warp, r, pool, mi)
    return warp, r, py, px


def tiles_of(n, ho, wo, th):
    """``launch_halo``'s tiles in walk order: (img, y0, x0)."""
    tx, ty = -(-wo // TW), -(-ho // th)
    return [(img, y * th, x * TW) for img in range(n) for y in range(ty) for x in range(tx)]


def fetch(x, img, y0, x0, s, th, stem):
    """What TMA writes into a halo buffer: the map folds N and H, so rows
    above or below the image are the neighbouring image's (zeros past the
    tensor), columns past the map zeros, and the pitch past Ci zeros."""
    n, h, w, ci = x.shape
    hh, hw, _, row = halo_dims(s, th)
    row0, col0 = img * h + y0 * s - 1, x0 * s - 1
    if stem:
        start = 3 * col0 - LEAD
        assert start % 16 == 0  # TMA's box starts on a 16-byte boundary
        flat = x.reshape(n * h, w * 3).astype(np.int64)
        buf = np.zeros((hh, row), np.int64)
        for hy in range(hh):
            for b in range(row):
                if 0 <= row0 + hy < n * h and 0 <= start + b < 3 * w:
                    buf[hy, b] = flat[row0 + hy, start + b]
        return buf
    flat = x.reshape(n * h, w, ci).astype(np.int64)
    buf = np.zeros((hh, hw, pitch(ci)), np.int64)
    for hy in range(hh):
        for hx in range(hw):
            if 0 <= row0 + hy < n * h and 0 <= col0 + hx < w:
                buf[hy, hx, :ci] = flat[row0 + hy, col0 + hx]
    return buf


def fill_border(buf, h, w, y0, x0, s, th, zp, ci):
    """The kernel's zero-point fill, loop for loop: every halo byte (Ci = 3)
    or pixel whose input coordinate lies outside the map gets the image's
    zero-point code."""
    hh, hw, used, _ = halo_dims(s, th)
    iy0, ix0 = y0 * s - 1, x0 * s - 1
    if not (iy0 < 0 or ix0 < 0 or iy0 + hh > h or ix0 + hw > w):
        return 0
    filled = 0
    if ci == 3:
        for idx in range(hh * used):
            hy, b = divmod(idx, used)
            if not (0 <= iy0 + hy < h and 0 <= ix0 + b // 3 < w):
                buf[hy, LEAD + b] = zp
                filled += 1
    else:
        for cell in range(hh * hw):
            hy, hx = divmod(cell, hw)
            if not (0 <= iy0 + hy < h and 0 <= ix0 + hx < w):
                buf[hy, hx, :ci] = zp
                filled += 1
    return filled


def funnelshift_r(lo, hi, sh):
    return ((hi << 32 | lo) >> (sh & 31)) & 0xFFFFFFFF


def byte_perm(x, y, sel):
    both = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(both[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def stem_rows(buf, py, px, s, th):
    """The Ci = 3 rows as each lane builds them: three aligned words of each
    of halo rows py s + dy, funnel-shifted to the window's first byte, the
    three runs of 9 codes joined by byte permutes, 5 bytes of K padding."""
    _, _, _, row = halo_dims(s, th)
    flat = (buf & 0xFF).reshape(-1)
    out = np.zeros((len(py), 32), np.int64)
    for i, (y, x) in enumerate(zip(py.tolist(), px.tolist())):
        first = LEAD + x * s * 3
        off = y * s * row + (first & ~3)
        sh = (first & 3) * 8
        assert (first & ~3) + 12 <= row  # the three words lie inside the row
        r = []
        for dy in range(3):
            w = [int(sum(int(flat[off + dy * row + 4 * k + b]) << (8 * b) for b in range(4))) for k in range(3)]
            r.append([funnelshift_r(w[0], w[1], sh), funnelshift_r(w[1], w[2], sh), w[2] >> sh])
        words = [r[0][0], r[0][1], byte_perm(r[0][2], r[1][0], 0x6540), byte_perm(r[1][0], r[1][1], 0x6543),
                 byte_perm(byte_perm(r[1][1], r[1][2], 0x0043), r[2][0], 0x5410),
                 byte_perm(r[2][0], r[2][1], 0x5432), byte_perm(r[2][1], r[2][2], 0x0432) & 0x00FFFFFF, 0]
        out[i] = [(wd >> (8 * b)) & 0xFF for wd in words for b in range(4)]
    return (out + 128) % 256 - 128  # the bytes as int8 codes


def halo_offsets(ci, s, py, px):
    """The ldmatrix row addresses of K chunk j (16 bytes): offsets into the
    halo buffer, None for K padding (the zero chunk)."""
    hw = (TW - 1) * s + 3
    k_pad = -(-9 * ci // 32) * 32
    out = []
    for j in range(k_pad // 16):
        if j >= 9 * ci // 16:
            out.append(None)
            continue
        tap, c = divmod(16 * j, ci)
        dy, dx = divmod(tap, 3)
        out.append(((py * s + dy) * hw + px * s + dx) * pitch(ci) + c)
    return out


def gather_rows(buf, ci, s, th, py, px):
    """The A operand the kernel multiplies for rows at tile pixels (py, px):
    Ci = 3 from the lanes' built rows, else read in place at
    ``halo_offsets``."""
    if ci == 3:
        return stem_rows(buf, py, px, s, th)
    flat = buf.reshape(-1)
    chunks = [np.zeros((len(py), 16), np.int64) if off is None else flat[off[:, None] + np.arange(16)]
              for off in halo_offsets(ci, s, py, px)]
    return np.concatenate(chunks, axis=1)


def emulate_acc(x, wt, x_zp, w_zp, s, pool):
    """Every tile's int32 accumulators as the kernel forms them: fetch, fill,
    gather, the packed weights, minus w_zp[o] times the row sum of the A
    bytes (ASYM's patchsum).  Returns {(img, oy, ox): acc row}, and per
    pooled window the four rows a thread holds."""
    n, h, w, ci = x.shape
    co = wt.shape[3]
    mi = tile_mi(co, s)
    th = 2 * mi
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    b = cuda_qconv.pack_weights(torch.from_numpy(wt)).numpy().astype(np.int64)[:co]
    _, _, py, px = tile_rows(pool, mi)
    got, windows = {}, {}
    for img, y0, x0 in tiles_of(n, ho, wo, th):
        buf = fetch(x, img, y0, x0, s, th, ci == 3)
        fill_border(buf, h, w, y0, x0, s, th, x_zp[img], ci)
        a = gather_rows(buf, ci, s, th, py, px)
        acc = a @ b.T - (0 if w_zp is None else w_zp[None, :].astype(np.int64) * a.sum(1, keepdims=True))
        acc = (acc + 2**31) % 2**32 - 2**31
        for i in range(64 * mi):
            if y0 + py[i] < ho and x0 + px[i] < wo:
                got[img, y0 + py[i], x0 + px[i]] = acc[i]
        if pool:  # thread (warp, g), group u: rows 32 u + g, + 8, + 16, + 24 of the warp
            for warp in range(WARPS):
                for u in range(mi // 2):
                    for g in range(8):
                        held = [16 * mi * warp + 32 * u + r for r in (g, g + 8, 16 + g, 24 + g)]
                        key = (img, y0 // 2 + 2 * u + (g >> 2), x0 // 2 + 4 * warp + (g & 3))
                        if key[1] < ho // 2 and key[2] < wo // 2:
                            windows[key] = acc[held].max(axis=0)
    return got, windows


def jax_acc(x, wt, x_zp, w_zp, s):
    return np.concatenate([
        np.asarray(jqconv.conv_acc_int32(
            jnp.asarray(x[i:i + 1]), jnp.asarray(wt), jnp.int32(x_zp[i]),
            jnp.zeros((wt.shape[3],), jnp.int32) if w_zp is None else jnp.asarray(w_zp), s, 1,
            symmetric=w_zp is None))
        for i in range(x.shape[0])])


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("n,h,w,ci,co,s,pool", [
    (2, 7, 48, 3, 16, 1, False), (2, 10, 32, 3, 32, 1, True), (1, 9, 48, 3, 16, 2, False),
    (2, 6, 35, 16, 32, 1, False), (2, 8, 36, 16, 16, 1, True), (1, 11, 40, 32, 64, 2, False),
    (1, 5, 33, 32, 64, 1, False), (1, 20, 34, 32, 16, 1, True), (1, 5, 33, 48, 16, 1, False),
    (1, 19, 32, 3, 32, 2, False),
])
def test_halo_gather_matches_jax_conv_acc(rng, n, h, w, ci, co, s, pool, symmetric):
    """Fetch, border fill with a per-image zero point, the in-place reads
    (or Ci = 3's built rows), the packed weights and the patchsum give, at
    every output pixel of every tile, the JAX package's conv_acc_int32; the
    pooled threads' four rows give its 2x2/s2 maxpool.  Odd maps, stride 2,
    tiles past the map's edge, Ci 3/16/32/48."""
    x = rng.integers(-128, 128, (n, h, w, ci), dtype=np.int8)
    wt = rng.integers(-128, 128, (3, 3, ci, co), dtype=np.int8)
    w_zp = None if symmetric else rng.integers(-128, 128, (co,)).astype(np.int32)
    x_zp = rng.integers(-128, 128, (n,)).astype(np.int32)
    got, windows = emulate_acc(x, wt, x_zp, w_zp, s, pool)
    want = jax_acc(x, wt, x_zp, w_zp, s)
    assert len(got) == want.shape[0] * want.shape[1] * want.shape[2]  # every pixel once
    for (img, oy, ox), row in got.items():
        np.testing.assert_array_equal(row, want[img, oy, ox], err_msg=f"pixel {(img, oy, ox)}")
    if pool:
        ref = np.asarray(jlayers.maxpool_u8(jnp.asarray(want), 2, 2, 1))
        assert len(windows) == ref.shape[0] * ref.shape[1] * ref.shape[2]
        for (img, wy, wx), row in windows.items():
            np.testing.assert_array_equal(row, ref[img, wy, wx])


@pytest.mark.parametrize("pool,co,s", [(False, 16, 1), (False, 32, 1), (False, 64, 1), (False, 16, 2),
                                        (False, 64, 2), (True, 16, 1), (True, 32, 1), (True, 64, 1)])
def test_tile_rows_cover_the_tile(pool, co, s):
    """A tile's 64 MI rows are its TH x 32 pixels (TH = 16, 8, 4 for Co 16,
    32, 64; at most 8 at stride 2), each once; with the pool a thread's rows
    32 u + g, + 8, + 16, + 24 are one window's four pixels, and each window
    of the tile's TH / 2 x 16 is held by one thread."""
    mi = tile_mi(co, s)
    assert mi * (co // 8) == 16 or (s == 2 and mi == 4)  # 64 accumulators a thread, or fewer at stride 2
    warp, r, py, px = tile_rows(pool, mi)
    assert sorted(zip(py.tolist(), px.tolist())) == [(y, x) for y in range(2 * mi) for x in range(TW)]
    if pool:
        seen = set()
        for wp in range(WARPS):
            for u in range(mi // 2):
                for g in range(8):
                    rows = [16 * mi * wp + 32 * u + k for k in (g, g + 8, 16 + g, 24 + g)]
                    pix = {(int(py[i]), int(px[i])) for i in rows}
                    wins = {(y // 2, x // 2) for y, x in pix}
                    assert len(pix) == 4 and len(wins) == 1
                    assert wins == {(2 * u + (g >> 2), 4 * wp + (g & 3))}
                    seen |= wins
        assert len(seen) == 16 * mi


@pytest.mark.parametrize("co", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 2])
def test_halo_extent_covers_every_tap(s, co):
    """Every tap of every row of a tile lies inside its halo, whose origin
    is input pixel (y0 s - 1, x0 s - 1); the last row and column are read."""
    mi = tile_mi(co, s)
    hh, hw, _, _ = halo_dims(s, 2 * mi)
    _, _, py, px = tile_rows(False, mi)
    iy = py[:, None] * s + np.arange(3)[None, :]
    ix = px[:, None] * s + np.arange(3)[None, :]
    assert iy.min() == 0 and iy.max() == hh - 1 and ix.min() == 0 and ix.max() == hw - 1


def bank_ways(addrs):
    """Most 16-byte addresses of one 8-lane ldmatrix phase in one of the 8
    bank groups (distinct addresses only: equal ones broadcast)."""
    groups = {}
    for a in set(int(v) for v in addrs):
        groups.setdefault((a // 16) % 8, set()).add(a)
    return max(len(v) for v in groups.values())


@pytest.mark.parametrize("ci", [16, 32, 48])
@pytest.mark.parametrize("s,pool,ways", [(1, False, 1), (1, True, 1), (2, False, 2)])
def test_ldmatrix_phases_bank_conflicts(ci, s, pool, ways):
    """With an odd pitch, the 8 rows of every ldmatrix phase (lanes 8i ..
    8i + 7 of a warp's m16 tile) fall on distinct bank groups at stride 1,
    pooled or not; at stride 2 two rows share a group (from 2- to 4-way at
    Ci 32 with the plain 32-byte pitch)."""
    mt = tile_mi(16, s)
    warp, r, py, px = tile_rows(pool, mt)
    worst = 0
    for wp in range(WARPS):
        for mi in range(mt):
            rows = np.arange(16 * mt * wp + 16 * mi, 16 * mt * wp + 16 * mi + 16)
            for off in halo_offsets(ci, s, py[rows], px[rows]):
                if off is not None:
                    worst = max(worst, bank_ways(off[:8]), bank_ways(off[8:]))
    assert worst == ways
    if ci == 32 and s == 2:  # the pitch's doing: the plain 32-byte pitch is 4-way there
        plain = ((py[:8] * s) * ((TW - 1) * s + 3) + px[:8] * s) * 32
        assert bank_ways(plain) == 4


def conv_inputs(net):
    """(layer, ci, k, pad, input width) of every conv of a network."""
    shapes = net.shapes()
    out = []
    for i, sp in enumerate(net.specs):
        if isinstance(sp, ConvSpec):
            h, w, ci = shapes[i - 1] if i else (net.height, net.width, 3)
            out.append((i, ci, sp.size, sp.pad, w))
    return out


# per model: the convs on the halo design (3x3 from Ci 3, 16, 32), on wgmma,
# and on mma.sync (the 1x1 convs sent back from wgmma)
ROUTES = {
    "yolov3_tiny": ((0, 2, 4), 10, ()),
    "yolov3": ((0, 1, 3), 67, (2, 6, 9, 93, 105)),
    "yolov2_tiny": ((0, 2, 4), 6, ()),
    "yolov2": ((0, 2), 20, (5,)),
}


@pytest.mark.parametrize("model", sorted(ROUTES))
def test_halo_route_by_model(model):
    """``design`` sends each model's bytes-bound 3x3 convs to the halo
    design: the flagship's and yolov2-tiny's layers 0, 2, 4, yolov3's 0, 1
    (stride 2) and 3, yolov2's 0 and 2, and nothing else; at 320 and 608
    too (every darknet width is a multiple of 32)."""
    halo, wgmma, mma = ROUTES[model]
    for size in (416, 320, 608):
        net = getattr(zoo, model)(**({"classes": 5} if model == "yolov3_tiny" else {}), width=size, height=size)
        routes = {i: cuda_qconv.design(ci, k, net.specs[i].filters, pad=pad, w=w)
                  for i, ci, k, pad, w in conv_inputs(net)}
        assert sorted(i for i, r in routes.items() if r == "halo") == list(halo)
        assert sorted(i for i, r in routes.items() if r == "mma.sync") == list(mma)
        assert sum(r == "wgmma" for r in routes.values()) == wgmma


def test_halo_rule_edges():
    """The rule's edges: Ci 3 needs W * 3 % 16 == 0 (TMA's row stride), the
    others Ci % 16 == 0 up to 48; Co 16, 32 or 64; 3x3, pad 1; the int8
    carrier; never a conv that wgmma can run."""
    ok = dict(pad=1, w=416)
    assert cuda_qconv.design(3, 3, 16, **ok) == "halo"
    assert cuda_qconv.design(3, 3, 16, pad=1, w=40) == "mma.sync"   # 120 bytes a row
    assert cuda_qconv.design(3, 3, 16, pad=1, w=48) == "halo"
    assert cuda_qconv.design(48, 3, 64, **ok) == "halo"
    for ci, k, co, pad in ((8, 3, 16, 1), (64, 3, 64, 1), (32, 3, 30, 1), (32, 3, 128, 1), (32, 1, 64, 0),
                           (32, 3, 64, 0), (6, 3, 16, 1), (16, 3, 48, 1)):
        assert cuda_qconv.design(ci, k, co, pad=pad, w=416) != "halo", (ci, k, co, pad)
    assert cuda_qconv.design(32, 3, 64, "int16", **ok) == "int16"
    assert cuda_qconv.forcible(32, 3, 64, "int8", **ok) == ("mma.sync", "halo")
    assert cuda_qconv.forcible(64, 3, 64, "int8", **ok) == ("mma.sync", "wgmma")
    assert cuda_qconv.forcible(8, 3, 64, "int8", **ok) == ()


def test_forced_halo_is_checked(rng):
    """``_design`` forces halo or mma.sync where the halo rule admits the
    conv, and raises elsewhere; on the CPU the plain version runs whatever
    the design, and nothing is counted."""
    x = torch.from_numpy(rng.integers(-128, 128, (1, 6, 32, 16), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (3, 3, 16, 32), dtype=np.int8))
    b, m = torch.zeros(32, dtype=torch.int32), torch.full((32,), 1e-3)
    cuda_qconv.reset_launches()
    want = tqconv.quantized_conv2d(x, w, b, m, 0, None, 0, pad=1, symmetric=True)
    for forced in ("mma.sync", "halo"):
        assert torch.equal(cuda_qconv.quantized_conv2d_cuda(x, w, b, m, 0, pad=1, _design=forced), want)
    assert cuda_qconv.launches == 0
    with pytest.raises(ValueError, match="cannot run"):
        cuda_qconv.quantized_conv2d_cuda(x, w, b, m, 0, pad=1, _design="wgmma")
    with pytest.raises(ValueError, match="cannot run"):  # Co 30: off the 16-byte rows
        cuda_qconv.quantized_conv2d_cuda(x, w[..., :30].contiguous(), b[:30], m[:30], 0, pad=1, _design="halo")
    with pytest.raises(ValueError, match="cannot run"):
        cuda_qconv.quantized_conv2d_cuda(x, w, b, m, 0, pad=1, carrier="int16", _design="halo")


def test_reset_launches_zeroes_halo():
    cuda_qconv.design_launches["halo"] += 2
    cuda_qconv.reset_launches()
    assert cuda_qconv.design_launches == {"wgmma": 0, "halo": 0, "mma.sync": 0, "int16": 0}


# The halo design's cases on the card: (n, h, w, ci, co, stride, fuse_pool):
# the models' shapes cut in height, batch 1 and 3, odd maps, stride 2, every
# Ci and Co it takes (each tile height), partial tiles in both directions
HALO_CASES = [
    (1, 20, 416, 3, 16, 1, True),   # flagship / yolov2-tiny layer 0, rows cut
    (3, 14, 64, 3, 32, 1, False),   # yolov3 layer 0
    (1, 18, 96, 3, 32, 1, True),    # yolov2 layer 0
    (3, 9, 48, 3, 16, 2, False),    # Ci 3 at stride 2, odd rows
    (1, 17, 64, 3, 64, 1, False),
    (3, 22, 208, 16, 32, 1, True),  # flagship layer 2
    (1, 26, 104, 32, 64, 1, True),  # flagship layer 4, yolov2 layer 2
    (3, 13, 45, 32, 64, 2, False),  # yolov3 layer 1, odd map
    (1, 21, 37, 32, 64, 1, False),  # yolov3 layer 3, odd map
    (3, 7, 33, 16, 16, 2, False),
    (2, 6, 34, 16, 64, 1, True),
    (1, 9, 70, 48, 16, 1, False),
    (3, 10, 66, 48, 32, 1, True),
    (2, 11, 40, 32, 16, 2, False),  # Co 16 at stride 2: 8-row tiles
    (2, 19, 64, 3, 32, 2, False),
]


def _halo_inputs(rng, n, h, w, ci, co, variant):
    x = rng.integers(-128, 128, (n, h, w, ci), dtype=np.int8)
    wt = rng.integers(-128, 128, (3, 3, ci, co), dtype=np.int8)
    per_image = variant in ("dyn", "parity")
    shape = (n, co) if per_image else (co,)
    bias = rng.integers(-(2**14), 2**14, shape).astype(np.int32)
    m = (rng.uniform(0.5, 2.0, shape) * 40.0 / (np.sqrt(9 * ci) * 5300.0)).astype(np.float32)
    x_zp = torch.from_numpy(rng.integers(-128, 128, (n,)).astype(np.int32)) if per_image else -45
    w_zp = torch.from_numpy(rng.integers(-128, 128, (co,)).astype(np.int32)) if variant in ("asym", "parity") \
        else None
    return [torch.from_numpy(a) for a in (x, wt, bias, m)], x_zp, w_zp


@pytest.mark.cuda
@pytest.mark.parametrize("forced", [None, "mma.sync"])
@pytest.mark.parametrize("variant", ["", "asym", "dyn", "exact", "uint8", "parity"])
@pytest.mark.parametrize("n,h,w,ci,co,stride,fuse_pool", HALO_CASES)
def test_cuda_halo_matches_plain(rng, n, h, w, ci, co, stride, fuse_pool, variant, forced):
    """Each case, routed onto the halo design and forced onto mma.sync, equals
    the plain version bit for bit: symmetric, asymmetric, per-image zero
    point and (N, Co) bias/m, exact_leaky, uint8 input codes, and the parity
    engine's options together."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    args, x_zp, w_zp = _halo_inputs(rng, n, h, w, ci, co, variant)
    if variant == "uint8":  # the same bytes as uint8 codes, shifted by the wrapper
        args[0] = args[0].view(torch.uint8)
    call = dict(stride=stride, pad=1, act=ACT_LEAKY, out_zp_static=77, out_i8=variant != "uint8",
                fuse_pool=fuse_pool, exact_leaky=variant in ("exact", "parity"))
    ref = cuda_qconv.quantized_conv2d_cuda(*args, x_zp, w_zp=w_zp, **call)
    cu = lambda t: t.cuda() if isinstance(t, torch.Tensor) else t  # noqa: E731
    dev = [cu(a) for a in args]
    cuda_qconv.reset_launches()
    got = cuda_qconv.quantized_conv2d_cuda(*dev, cu(x_zp), w_zp=cu(w_zp), _design=forced, **call)
    torch.cuda.synchronize()
    ran = forced or "halo"
    assert cuda_qconv.design_launches == {"wgmma": 0, "halo": int(ran == "halo"),
                                          "mma.sync": int(ran == "mma.sync"), "int16": 0}
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("ci,co,stride,pool", [(3, 16, 1, True), (32, 64, 2, False)])
def test_cuda_halo_in_a_captured_graph(rng, ci, co, stride, pool):
    """The input's TMA map is a kernel parameter, cached per (pointer,
    shape, box): a CUDA graph of halo launches replays to the eager result,
    also after the input's contents change in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    args, x_zp, _ = _halo_inputs(rng, 2, 24, 64, ci, co, "")
    x, wt, bias, m = (a.cuda() for a in args)
    call = dict(stride=stride, pad=1, act=ACT_RELU6, out_i8=True, fuse_pool=pool,
                w_packed=cuda_qconv.pack_weights(wt))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_qconv.quantized_conv2d_cuda(x, wt, bias, m, x_zp, **call)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cuda_qconv.quantized_conv2d_cuda(x, wt, bias, m, x_zp, **call)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, cuda_qconv.quantized_conv2d_cuda(x, wt, bias, m, x_zp, **call))
        x.copy_(torch.from_numpy(rng.integers(-128, 128, tuple(x.shape), dtype=np.int8)).cuda())
