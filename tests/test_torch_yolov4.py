"""YOLOv4 in the port: the cfg's parse, mish's table epilogue, ``scale_x_y``
in the decode and the SPP block, held against the benchmark's plain
reference (``portbench/reference/yolov4.py``, loaded as the harness loads
it) on the CPU at 64x64; ``-m cuda`` holds K1's mish epilogue in each
design to the plain version and ``spp_kernel`` to the block's layers bit
for bit."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import compare, harness, inputs  # noqa: E402
from yolo_quantization_tpu_torch.eval import detect  # noqa: E402
from yolo_quantization_tpu_torch.infer import serialize  # noqa: E402
from yolo_quantization_tpu_torch.infer.convert import _nudge_np, convert  # noqa: E402
from yolo_quantization_tpu_torch.infer.engine import Engine, fusion_plan, spp_plan  # noqa: E402
from yolo_quantization_tpu_torch.models import presets  # noqa: E402
from yolo_quantization_tpu_torch.models.cfg import parse_cfg  # noqa: E402
from yolo_quantization_tpu_torch.nn import graph as G  # noqa: E402
from yolo_quantization_tpu_torch.nn import layers as L  # noqa: E402
from yolo_quantization_tpu_torch.ops import cuda_qconv, cuda_s2d, cuda_spp, qconv  # noqa: E402

torch.set_num_threads(2)

CELL = "v4-608-b32-offline"
SIZE = 64
SEED = 2**31 + 17


@pytest.fixture(scope="module")
def v4():
    """(config, reference, .cfg text at 64, its reference network, weights,
    ranges, two frames) of the v4 cell, from one seed."""
    _, config = harness.cell_files(ROOT, CELL)
    # the module itself, loaded as harness.reference loads it: its helpers too
    ref = harness.load_file("reference", config["reference"], harness.REFERENCE_FUNCTIONS, "reference")
    text = harness.cfg_text(config, SIZE)
    net = ref.parse(text)
    weights = inputs.float_params(net, SEED, "cpu")
    ranges = harness.range_rule(config)(net)
    frames = inputs.frame_pool(1, 2, SIZE, SEED, "cpu")[0]
    return config, ref, text, net, weights, ranges, frames


@pytest.fixture(scope="module")
def program(v4):
    _, _, text, _, weights, ranges, _ = v4
    return convert(parse_cfg(text)[0], weights, ranges)


@pytest.fixture(scope="module")
def engine(program):
    return Engine(program, max_det=100, device="cpu")


def test_the_cfg_parses_as_published(v4):
    config, ref = v4[0], v4[1]
    text = harness.cfg_text(config, 608)
    net, _ = parse_cfg(text)
    kinds = [type(s).__name__ for s in net.specs]
    assert len(kinds) == 162
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "ConvSpec": 110, "ShortcutSpec": 23, "RouteSpec": 21, "MaxPoolSpec": 3,
        "UpsampleSpec": 2, "YoloSpec": 3}
    convs = [s for s in net.specs if isinstance(s, G.ConvSpec)]
    assert [s.activation for s in convs[:72]] == ["mish"] * 72
    assert {s.activation for s in convs[72:]} == {"leaky", "linear"}
    heads = [(i, s.scale_x_y, s.mask) for i, s in enumerate(net.specs) if isinstance(s, G.YoloSpec)]
    assert heads == [(139, 1.2, (0, 1, 2)), (150, 1.1, (3, 4, 5)), (161, 1.05, (6, 7, 8))]
    assert [i for i, s in enumerate(net.specs) if isinstance(s, G.ConvSpec) and s.quant_stop] == [138, 149, 160]
    shapes = net.shapes()
    macs = sum(shapes[i][0] * shapes[i][1] * shapes[i][2] * s.size ** 2 * (shapes[i - 1][2] if i else 3)
               for i, s in enumerate(net.specs) if isinstance(s, G.ConvSpec))
    assert round(macs / 1e9, 2) == 64.19
    assert shapes[113] == (19, 19, 2048)
    assert [layer.out_shape for layer in ref.parse(text).layers] == shapes
    # the training-only [yolo] keys are read and unused
    assert "iou_loss=ciou" in config["cfg"] and "nms_kind=greedynms" in config["cfg"]


def test_scale_x_y_keeps_the_spec_exchangeable(tmp_path, program):
    """scale_x_y is no field: a spec's fields and dict are the reference
    package's; equality takes it in; a saved program keeps it where it is
    not 1 and writes nothing new where it is."""
    a = G.YoloSpec((0, 1), ((1.0, 2.0), (3.0, 4.0)), 5)
    b = G.YoloSpec((0, 1), ((1.0, 2.0), (3.0, 4.0)), 5, scale_x_y=1.2)
    assert [f.name for f in dataclasses.fields(b)] == ["mask", "anchors", "classes"]
    assert a.scale_x_y == 1.0 and b.scale_x_y == 1.2 and a != b and hash(a) != hash(b)
    assert a == G.YoloSpec((0, 1), ((1.0, 2.0), (3.0, 4.0)), 5)
    assert "scale_x_y" not in serialize._spec_to_json(a)
    assert serialize._spec_from_json(serialize._spec_to_json(b)) == b


def test_mish_float_is_darknets():
    x = torch.linspace(-19.99, 19.99, 40001, dtype=torch.float64)
    expected = x * torch.tanh(torch.log1p(torch.exp(x)))
    np.testing.assert_allclose(L.activate(x, "mish").numpy(), expected.numpy(), rtol=1e-14, atol=1e-300)
    # past the threshold: x above, and below darknet's exp(x) for softplus,
    # which log1p(exp(x)) meets to e^x / 2 relative
    big = torch.tensor([25.0, -25.0], dtype=torch.float64)
    np.testing.assert_allclose(L.activate(big, "mish").numpy(), [25.0, -25.0 * np.tanh(np.exp(-25.0))],
                               rtol=1e-10)


@pytest.mark.parametrize("lo,hi", [(-0.3088, 6.0), (-0.25, 7.9), (-0.30884 / 2.4, 16.3), (-0.29, 1.1),
                                   (-0.31, 40.0)])
def test_mish_table_against_the_reference(v4, lo, hi):
    """The program's codes equal the reference's for every pre-activation
    on a fine grid, lie within 1 of round(mish(v S) / S) + zp, and are zp
    below the table and clamp(r + zp) above it."""
    ref = v4[1]
    s, zp = _nudge_np(lo, hi)
    t_lo, table = qconv.mish_table(s, zp)
    assert 0 < len(table) < 2000 and table.dtype == np.uint8
    acc = torch.arange(-16 * 4000, 16 * 2000, dtype=torch.int32).reshape(1, 1, -1, 1)
    m = torch.tensor([1.0 / 16], dtype=torch.float32)  # v = acc / 16, exact
    got = qconv.requant_activate(acc, torch.zeros(1, dtype=torch.int32), m, zp, qconv.ACT_MISH,
                                 mish=(torch.from_numpy(table), t_lo)).reshape(-1).numpy().astype(np.int64)
    v = acc.reshape(-1).numpy() / 16.0
    r = np.round(v)
    want = ref.mish_codes(torch.from_numpy(r).to(torch.float32), s, zp).numpy().astype(np.int64)
    np.testing.assert_array_equal(got, want)
    exact = np.clip(np.round(ref.mish(v * s) / s) + zp, 0, 255)
    assert np.abs(got - exact).max() <= 1
    assert (got[r < t_lo] == zp).all()
    assert (got[r >= t_lo + len(table)] == np.clip(r[r >= t_lo + len(table)] + zp, 0, 255)).all()
    # tightest: the first entry breaks the rule below, the last the rule above
    assert table[0] != zp and table[-1] != min(t_lo + len(table) - 1 + zp, 255)
    shifted = qconv.requant_activate(acc, torch.zeros(1, dtype=torch.int32), m, zp, qconv.ACT_MISH,
                                     out_i8=True, mish=(torch.from_numpy(table), t_lo))
    np.testing.assert_array_equal(shifted.reshape(-1).numpy().astype(np.int64) + 128, got)


def test_engine_against_the_reference(v4, engine):
    """Every head code equal; every detection within the decode's rounding
    of a reference candidate."""
    _, ref, _, net, weights, ranges, frames = v4
    program = ref.convert(net, weights, ranges, "cpu")
    ours = engine.raw_heads(frames)
    theirs = ref.heads(program, frames)
    dequant = [program.layers[i].dequant for i, layer in enumerate(net.layers)
               if layer.kind == "conv" and layer.quant_stop]
    for a, b, (s, z) in zip(ours, theirs, dequant):
        codes_a = np.round(a.astype(np.float64) / s) + z
        codes_b = np.round(b.numpy() / s) + z
        np.testing.assert_array_equal(codes_a, codes_b)
        assert len(np.unique(codes_a)) > 20
    boxes, obj, cls = engine.predict(frames)
    rows = np.concatenate([boxes, obj[..., None], cls], axis=-1).astype(np.float64)
    cands = ref.candidates(program, frames, 100, compare.TIE)
    for n in range(frames.shape[0]):
        assert compare.image_gap(rows[n], cands[n]) < 1e-5


def test_scale_x_y_decode(v4):
    """The program's float32 decode against the reference's float64 one,
    each head with its scale_x_y; at s = 1 the formula of every other head,
    bit for bit."""
    _, ref, text, rnet, *_ = v4
    net, _ = parse_cfg(text)
    shapes = net.shapes()
    gen = torch.Generator().manual_seed(5)
    heads = [torch.rand((2, *shapes[i]), generator=gen) * 8 - 4
             for i, s in enumerate(net.specs) if isinstance(s, G.YoloSpec)]
    boxes, obj, cls = detect.decode_all_heads(heads, net)
    rb, ro, rc = ref.decode([h.to(torch.float64) for h in heads], rnet)
    np.testing.assert_allclose(boxes.numpy(), rb.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(obj.numpy(), ro.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(cls.numpy(), rc.numpy(), rtol=1e-6, atol=1e-7)
    raw, anchors = heads[0], detect.head_anchors(net, "cpu")[0]
    b1, _, _ = detect.decode_head(raw, anchors, 80, SIZE, SIZE, 1.0)
    r = raw.reshape(2, 8, 8, 3, 85)
    cols = torch.arange(8, dtype=torch.float32).reshape(1, 1, 8, 1)
    rows = torch.arange(8, dtype=torch.float32).reshape(1, 8, 1, 1)
    assert torch.equal(b1[..., 0], ((torch.sigmoid(r[..., 0]) + cols) / 8).reshape(2, -1))
    assert torch.equal(b1[..., 1], ((torch.sigmoid(r[..., 1]) + rows) / 8).reshape(2, -1))
    b12, _, _ = detect.decode_head(raw, anchors, 80, SIZE, SIZE, 1.2)
    assert not torch.equal(b1, b12) and torch.equal(b1[..., 2:], b12[..., 2:])


def test_the_spp_plan(program):
    plan = spp_plan(program)
    assert list(plan) == [108]
    block = plan[108]
    assert (block.base, block.route) == (107, 113)
    assert [b[0] for b in block.branches] == [13, 9, 5, 1]
    assert all(len(b) == 4 for b in block.branches)
    assert spp_plan(presets.flagship_program(size=SIZE)) == {}
    assert spp_plan(presets.v3_program(size=SIZE)) == {}


def test_the_spp_block_equals_its_layers(engine, v4):
    """Off the card the block runs layer by layer in both forwards, and the
    kernel's wrapper refuses the CPU and branches it cannot take before any
    launch (``test_spp_kernel_on_the_card`` holds the kernel to the layers)."""
    frames = v4[6]
    fused = engine.raw_heads(frames)
    heads, outputs = engine.raw_heads(frames, return_outputs=True)
    for a, b in zip(fused, heads):
        np.testing.assert_array_equal(a, b)
    assert outputs[113].shape[-1] == 4 * outputs[107].shape[-1]
    x = torch.randint(-128, 128, (2, 7, 9, 32), dtype=torch.int8, generator=torch.Generator().manual_seed(3))
    branches = ((13, False, 0.77, 140), (1, True, 1.0, 90), (5, False, 1.31, 60), (9, True, 1.0, 90))
    before = cuda_spp.launches
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        cuda_spp.spp_cuda(x, branches, 90)
    with pytest.raises(ValueError, match="multiple of 16"):
        cuda_spp.spp_cuda(x[..., :8], branches, 90)
    with pytest.raises(ValueError, match="odd"):
        cuda_spp.spp_cuda(x, ((4, True, 1.0, 0),), 90)
    assert cuda_spp.launches == before


def test_mish_stays_off_the_fused_pool_and_k2():
    text = ("[net]\nwidth=32\nheight=32\nchannels=3\n[convolutional]\nbatch_normalize=1\nfilters=16\n"
            "size=3\nstride=1\npad=1\nactivation=mish\nquantized=1\n[maxpool]\nsize=2\nstride=2\n"
            "quantized=1\n[convolutional]\nfilters=18\nsize=1\nstride=1\npad=1\nactivation=linear\n"
            "quantized=1\nquant_stop=1\n[yolo]\nmask=0\nanchors=10,14\nclasses=1\n")
    net, _ = parse_cfg(text)
    ranges = {k: {"min": -0.3, "max": 6.0} for k in G.init_quant_state(net)}
    prog = convert(net, G.init_params_numpy(0, net), {**ranges, "input": {"min": 0.0, "max": 1.0}})
    assert fusion_plan(prog) == set() and not prog.cfg[0].s2d_pool
    assert prog.cfg[0].act == qconv.ACT_MISH
    x = torch.zeros((1, 32, 32, 3), dtype=torch.int8)
    a = prog.arrays[0]
    w, b, m = (torch.from_numpy(np.asarray(a[k])) for k in ("w_i8", "bias_i32", "m"))
    table = (torch.from_numpy(a["mish_table"]), int(a["mish_lo"]))
    with pytest.raises(ValueError, match="fuse_pool cannot take mish"):
        cuda_qconv.quantized_conv2d_cuda(x, w, b, m, -128, pad=1, act=qconv.ACT_MISH, fuse_pool=True,
                                         mish=table)
    with pytest.raises(ValueError, match="needs its table"):
        cuda_qconv.quantized_conv2d_cuda(x, w, b, m, -128, pad=1, act=qconv.ACT_MISH)
    ws = torch.zeros((3, 3, 12, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="K2"):
        cuda_s2d.s2d_conv_phase_max_cuda(x, ws, b, m, -128, act=qconv.ACT_MISH)


def test_a_saved_program_keeps_its_tables(tmp_path, program, engine, v4):
    path = tmp_path / "v4.npz"
    serialize.save_program(str(path), program)
    loaded = serialize.load_program(str(path))
    mish = [i for i, c in enumerate(program.cfg) if c.act == qconv.ACT_MISH and c.kind == "qconv"]
    assert len(mish) == 72
    for i in mish:
        np.testing.assert_array_equal(loaded.arrays[i]["mish_table"], program.arrays[i]["mish_table"])
        assert int(loaded.arrays[i]["mish_lo"]) == int(program.arrays[i]["mish_lo"])
    assert [s.scale_x_y for s in loaded.net.specs if isinstance(s, G.YoloSpec)] == [1.2, 1.1, 1.05]
    frames = v4[6]
    for a, b in zip(Engine(loaded, max_det=100, device="cpu").raw_heads(frames), engine.raw_heads(frames)):
        np.testing.assert_array_equal(a, b)


def test_the_float_and_qat_forwards_run(v4):
    text = v4[2]
    net, _ = parse_cfg(text)
    params = G.params_to_torch(G.init_params_numpy(1, net), "cpu")
    x = torch.rand((1, SIZE, SIZE, 3), generator=torch.Generator().manual_seed(1))
    heads, _ = G.forward(net, params, x)
    assert [tuple(h.shape) for h in heads] == [(1, 8, 8, 255), (1, 4, 4, 255), (1, 2, 2, 255)]
    assert all(torch.isfinite(h).all() for h in heads)
    qs = {k: {"min": torch.tensor(-0.3), "max": torch.tensor(6.0)} for k in G.init_quant_state(net)}
    qs["input"] = {"min": torch.tensor(0.0), "max": torch.tensor(1.0)}
    heads_q, _ = G.forward(net, params, x, G.ForwardMode(qat=True), quant_state=qs)
    assert all(torch.isfinite(h).all() for h in heads_q)


# ---- on the card ----


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# (Ci, Co, k, stride, H, W): a case for each design that takes a v4 conv
MISH_CASES = {
    "halo_stem": (3, 32, 3, 1, 64, 64),
    "halo_s2": (32, 64, 3, 2, 64, 64),
    "wgmma_3x3": (64, 128, 3, 1, 38, 38),
    "wgmma_s2": (128, 256, 3, 2, 38, 38),
    "wgmma_1x1": (512, 256, 1, 1, 19, 19),
    "mma_1x1": (64, 32, 1, 1, 76, 76),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MISH_CASES))
@pytest.mark.parametrize("out_i8", [False, True])
def test_k1_mish_on_the_card(case, out_i8):
    _cuda()
    ci, co, k, stride, h, w = MISH_CASES[case]
    gen = torch.Generator().manual_seed(ci * co + k)
    x = torch.randint(-128, 128, (3, h, w, ci), dtype=torch.int8, generator=gen)
    wt = torch.randint(-127, 128, (k, k, ci, co), dtype=torch.int8, generator=gen)
    bias = torch.randint(-4000, 4000, (co,), dtype=torch.int32, generator=gen)
    # v about 60 output steps wide: below, inside and above the table
    m = ((torch.rand(co, generator=gen) + 0.5) * 60 / (74.0 ** 2 * (k * k * ci) ** 0.5)).to(torch.float32)
    s, zp = _nudge_np(-0.29, 7.3)
    lo, table = qconv.mish_table(s, zp)
    args = dict(stride=stride, pad=k // 2, act=qconv.ACT_MISH, out_zp_static=zp, out_i8=out_i8)
    want = cuda_qconv.quantized_conv2d_cuda(x, wt, bias, m, -7, mish=(torch.from_numpy(table), lo), **args)
    dev = [t.cuda() for t in (x, wt, bias, m)]
    designs = (None,) + cuda_qconv.forcible(ci, k, co, "int8", pad=k // 2, w=w)
    routed = cuda_qconv.design(ci, k, co, pad=k // 2, w=w)
    assert routed == {"halo": "halo", "wgmma": "wgmma", "mma": "mma.sync"}[case.split("_")[0]]
    for forced in designs:
        got = cuda_qconv.quantized_conv2d_cuda(*dev, -7, mish=(torch.from_numpy(table).cuda(), lo),
                                               _design=forced, **args)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (case, forced)
    codes = want.to(torch.int64) + (128 if out_i8 else 0)
    assert len(torch.unique(codes)) > 20 and (codes == zp).any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 19, 19, 512), (4, 13, 13, 512), (3, 40, 37, 32), (2, 2, 2, 16)])
def test_spp_kernel_on_the_card(shape):
    _cuda()
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randint(-128, 128, shape, dtype=torch.int8, generator=gen)
    for branches, zp in ((((13, False, 0.9939, 56), (9, False, 0.9939, 56), (5, False, 0.9939, 56),
                           (1, False, 0.9939, 56)), 56),
                         (((1, True, 1.0, 77), (5, False, 1.7, 12), (9, True, 1.0, 77)), 77)):
        parts = [x if k == 1 else L.maxpool_u8(x, k, 1, k - 1) for k, *_ in branches]
        want = torch.cat([p if ident else L.requant_i8(p, r, z, zp)
                          for p, (_, ident, r, z) in zip(parts, branches)], dim=-1)
        before = cuda_spp.launches
        got = cuda_spp.spp_cuda(x.cuda(), branches, zp)
        torch.cuda.synchronize()
        assert cuda_spp.launches == before + 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_v4_engine_on_the_card(v4, program, engine):
    """The v4 program on the card at 64: every head bit for bit against the
    CPU engine (which runs the SPP block layer by layer), one spp_kernel a
    forward, and an enqueue that never waits."""
    _cuda()
    frames = v4[6]
    card = Engine(program, max_det=100)
    card.predict(frames)
    before = cuda_spp.launches
    for a, b in zip(card.raw_heads(frames), engine.raw_heads(frames)):
        np.testing.assert_array_equal(a, b)
    assert cuda_spp.launches == before + 1
    x = frames.cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        resolve = card.predict_async(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got, want = resolve(), engine.predict(frames)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
