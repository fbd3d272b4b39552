"""The port's C-exact twin (``parity/ctwin.py``) against the JAX twin, and
the port's parity harness (``tools/parity_check.py``) against the JAX
engine scored by the JAX twin, on the CPU.

The twin's C-exact steps bit for bit on seeded arrays: the dynamic input
qp and codes, the float32 doubling loop of the requant multiplier, the
step-wise float32 GEMM on operands whose partials pass 2^24, and a conv in
each of ``_conv``'s two branches.  Then yolov3-tiny's topology at 64x64 (5
classes, the standard tiny anchors) from one ``.weights`` file the port
writes and both packages load: every u8 layer, the quant_stop floats and
``yolo_detections_c``'s rows equal.  The port's CPU engine scored by the
port's twin gives the tier-2 LSB table and F1 counts the JAX engine (the
un-jitted ``build_forward``, the same conversion) scored by the JAX twin
gives, statically and with ``dynamic_input``."""

import numpy as np
import pytest
import torch

from yolo_quantization_tpu.infer import convert as jconvert
from yolo_quantization_tpu.infer import engine as jengine
from yolo_quantization_tpu.models import darknet_weights as jdw
from yolo_quantization_tpu.models import zoo as jzoo
from yolo_quantization_tpu.nn import graph as JG
from yolo_quantization_tpu.parity import ctwin as jtwin
from yolo_quantization_tpu_torch.data.image import letterbox, load_image_rgb
from yolo_quantization_tpu_torch.data.voc import label_path_for, read_boxes
from yolo_quantization_tpu_torch.models import darknet_weights as tdw
from yolo_quantization_tpu_torch.nn import graph as TG
from yolo_quantization_tpu_torch.parity import ctwin as ttwin
from yolo_quantization_tpu_torch.tools import crossf1, parity_check

torch.set_num_threads(2)

SIZE = 64


def test_dynamic_input_qp_and_codes_match_jax():
    rng = np.random.default_rng(0)
    cases = [rng.uniform(0, 1, (3, 16, 16)), rng.uniform(-0.3, 2.5, (3, 9, 7)),
             rng.normal(0, 3, (3, 8, 8)), np.full((3, 4, 4), 0.5), rng.uniform(-2, -0.1, (3, 5, 5))]
    for x in cases:
        x = x.astype(np.float32)
        js, jz = jtwin.dynamic_input_qp(x)
        ts, tz = ttwin.dynamic_input_qp(x)
        assert np.float32(js).tobytes() == np.float32(ts).tobytes() and jz == tz
        np.testing.assert_array_equal(ttwin.quantize_input_c(x, ts, tz), jtwin.quantize_input_c(x, js, jz))
    # C's round: half away from zero
    np.testing.assert_array_equal(ttwin._c_round([-2.5, -0.5, 0.5, 1.5, 2.5]), [-3, -1, 1, 2, 3])


def test_quant_multiplier_matches_jax():
    rng = np.random.default_rng(1)
    ms = np.concatenate([rng.uniform(1e-6, 1, 400), 10.0 ** rng.uniform(-9, -1, 200),
                         [0.5, np.nextafter(np.float32(1), np.float32(0)), 0.25, 1e-3]]).astype(np.float32)
    for m in ms:
        assert ttwin.quant_multiplier_c(m) == jtwin.quant_multiplier_c(m), m
    for bad in (0.0, 1.0, -0.5):
        with pytest.raises(ValueError):
            ttwin.quant_multiplier_c(np.float32(bad))


@pytest.mark.parametrize("alpha", [1.0, -1.0])
def test_stepwise_gemm_rounds_as_jax_past_2_24(alpha):
    """Partials of 200-255 codes over K = 700 pass 2^24 (up to 4.6e7), where
    the float32 accumulator rounds on each step: the result differs from the
    exact product, and equals the JAX twin's bit for bit."""
    rng = np.random.default_rng(2)
    a = rng.integers(200, 256, (6, 700)).astype(np.int64)
    b = rng.integers(200, 256, (700, 37)).astype(np.uint8)
    c0 = rng.integers(-1000, 1000, (6, 37)).astype(np.int64) if alpha < 0 else np.zeros((6, 37), np.int64)
    got = ttwin._gemm_u8_f32acc(a, b, alpha, c0)
    np.testing.assert_array_equal(got, jtwin._gemm_u8_f32acc(a, b, alpha, c0))
    exact = c0 + alpha * (a @ b.astype(np.int64)).astype(np.int64)
    assert np.abs(exact).max() > 2**24 and (got != exact).any()


def _conv_case(stepwise: bool):
    """A 3x3 conv of 64 channels (K = 576) on 6x6 codes: in the step-wise
    branch, codes of 200-255 push GEMM1's partials past 2^24; in the exact
    branch, codes under 60 keep both GEMMs below it."""
    rng = np.random.default_rng(3 + stepwise)
    hi = 256 if stepwise else 60
    lo = 200 if stepwise else 0
    n, c = 24, 64
    x = rng.integers(lo, hi, (c, 6, 6)).astype(np.uint8)
    raw = {0: {"weights_u8": rng.integers(lo, hi, (n, c, 3, 3)).astype(np.uint8),
               "weight_zps": rng.integers(lo, hi, n).astype(np.uint8),
               "weight_scales": rng.uniform(1e-3, 5e-3, n).astype(np.float32),
               "activ_scale": np.float32(0.05), "activ_zp": np.uint8(7)}}
    params = {0: {"bias": rng.normal(0, 1, n).astype(np.float32), "gamma": rng.uniform(0.5, 2, n).astype(np.float32),
                  "mean": rng.normal(0, 1, n).astype(np.float32), "var": rng.uniform(0.5, 2, n).astype(np.float32),
                  "w": np.zeros((3, 3, c, n), np.float32)}}
    return x, raw, params, n, c


@pytest.mark.parametrize("stepwise", [False, True], ids=["exact", "stepwise"])
def test_conv_branches_match_jax(stepwise):
    x, raw, params, n, c = _conv_case(stepwise)
    spec_kw = dict(filters=n, size=3, pad=1, activation="leaky", quant_stop=True)
    out = {}
    for G, twin, dw in ((TG, ttwin, tdw), (JG, jtwin, jdw)):
        net = G.NetworkDef(specs=(G.ConvSpec(**spec_kw),), width=6, height=6, channels=c)
        ckpt = dw.DarknetCheckpoint(params=params, quant_state={}, seen=0, raw_quant=raw)
        out[G] = twin.CTwin(net, ckpt)._conv(net.specs[0], raw[0], x, (c, 6, 6), np.float32(0.02), 3,
                                             np.float32(0.05), 7, 0)
    u8, f32, took_stepwise = out[TG]
    assert took_stepwise == stepwise
    np.testing.assert_array_equal(u8, out[JG][0])
    assert f32.tobytes() == out[JG][1].tobytes()
    assert len(np.unique(u8)) > 20  # the epilogue spreads over the code range


@pytest.fixture(scope="module")
def parity_file(tmp_path_factory):
    """yolov3-tiny's topology at 64x64 (5 classes, standard tiny anchors):
    seeded weights calibrated on a rendered image, written by the port."""
    root = str(tmp_path_factory.mktemp("parity"))
    image = open(crossf1.render_dataset(root, 1, seed=5, canvas=96)).read().split()[0]
    tnet = crossf1.flagship_net(SIZE)
    jnet = jzoo.yolov3_tiny(classes=5, anchors=crossf1.STD_TINY_ANCHORS, width=SIZE, height=SIZE)
    im = load_image_rgb(image)
    sized = letterbox(im, SIZE, SIZE)
    path = f"{root}/p.weights"
    parity_check.export_checkpoint(tnet, sized, path, seed=3, device="cpu")
    return tnet, jnet, path, im, sized, read_boxes(label_path_for(image))


@pytest.fixture(scope="module")
def twins(parity_file):
    tnet, jnet, path, im, sized, _ = parity_file
    chw = np.ascontiguousarray(sized.transpose(2, 0, 1))
    tck, jck = tdw.load_darknet_weights(path, tnet), jdw.load_darknet_weights(path, jnet)
    return (ttwin.CTwin(tnet, tck).forward(chw), jtwin.CTwin(jnet, jck).forward(chw), tck, jck)


def test_twin_equals_jax_twin_at_every_layer(parity_file, twins):
    tnet, jnet, _, im, _, _ = parity_file
    t, j, _, _ = twins
    assert np.float32(t.in_scale).tobytes() == np.float32(j.in_scale).tobytes() and t.in_zp == j.in_zp
    np.testing.assert_array_equal(t.input_u8, j.input_u8)
    n_u8 = n_f32 = 0
    for i, (a, b) in enumerate(zip(t.layers, j.layers)):
        assert (a.kind, a.shape, a.act_zp) == (b.kind, b.shape, b.act_zp), i
        assert (a.u8 is None) == (b.u8 is None) and (a.f32 is None) == (b.f32 is None), i
        if a.u8 is not None:
            np.testing.assert_array_equal(a.u8, b.u8, err_msg=f"layer {i}")
            n_u8 += 1
        if a.f32 is not None:
            assert a.f32.tobytes() == b.f32.tobytes(), i
            n_f32 += 1
    assert n_u8 == 22 and n_f32 == 4  # 13 convs, 6 pools, 2 routes, the upsample; 2 quant_stop + 2 yolo
    yolo_t = [tl.f32 for tl, s in zip(t.layers, tnet.specs) if isinstance(s, TG.YoloSpec)]
    yolo_j = [tl.f32 for tl, s in zip(j.layers, jnet.specs) if isinstance(s, JG.YoloSpec)]
    h, w = im.shape[:2]
    dt = ttwin.yolo_detections_c(tnet, yolo_t, w, h, 0.05)
    dj = jtwin.yolo_detections_c(jnet, yolo_j, w, h, 0.05)
    assert len(dt) > 0 and dt.tobytes() == dj.tobytes()


def _jax_engine_outputs(jnet, jck, twin_res, sized, dynamic):
    """The JAX engine in the harness's configuration, un-jitted."""
    qs = {k: dict(v) for k, v in jck.quant_state.items()}
    lo, hi = jdw._range_from_scale_zp(float(twin_res.in_scale), int(twin_res.in_zp))
    qs["input"] = {"min": np.float32(lo), "max": np.float32(hi)}
    program = jconvert.convert(jnet, jck.params, qs, symmetric_weights=False, route_rescale=False)
    program.in_scale, program.in_zp = float(twin_res.in_scale), int(twin_res.in_zp)
    fwd = jengine.build_forward(program, return_outputs=True, dynamic_input=dynamic, exact_leaky=True)
    heads, outputs = fwd(program.arrays, sized[None])
    return [np.asarray(h) for h in heads], [np.asarray(o) for o in outputs]


def _jax_engine_yolo(jnet, heads):
    """The JAX engine's heads through the JAX twin's yolo activations."""
    specs = [s for s in jnet.specs if isinstance(s, JG.YoloSpec)]
    out = []
    for h, spec in zip(heads, specs):
        chw = h[0].transpose(2, 0, 1)
        out.append(jtwin.CTwin.__new__(jtwin.CTwin)._yolo(spec, chw.reshape(-1), *chw.shape[1:]))
    return out


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_engine_lsb_table_and_f1_counts_equal_jax(parity_file, twins, dynamic):
    tnet, jnet, _, im, sized, truths = parity_file
    t, j, tck, jck = twins
    engine = parity_check.parity_engine(tnet, tck, t.in_scale, t.in_zp, dynamic, "cpu")
    theads, touts = engine.raw_heads(sized[None], return_outputs=True)
    jheads, jouts = _jax_engine_outputs(jnet, jck, j, sized, dynamic)
    tlsb, jlsb = parity_check.lsb_table(t, touts), parity_check.lsb_table(j, jouts)
    assert tlsb == jlsb and len(tlsb) == 22
    h, w = im.shape[:2]
    yolo = lambda res, net: [tl.f32 for tl, s in zip(res.layers, net.specs) if type(s).__name__ == "YoloSpec"]  # noqa: E731
    port = [ttwin.yolo_detections_c(tnet, yolo(t, tnet), w, h, 0.05),
            ttwin.yolo_detections_c(tnet, parity_check.engine_yolo(tnet, theads), w, h, 0.05)]
    ref = [jtwin.yolo_detections_c(jnet, yolo(j, jnet), w, h, 0.05),
           jtwin.yolo_detections_c(jnet, _jax_engine_yolo(jnet, jheads), w, h, 0.05)]
    for a, b in zip(port, ref):
        assert a.tobytes() == b.tobytes()
    for thresholds in (None, (0.25,)):
        assert ([parity_check.f1_counts(d, truths, thresholds) for d in port]
                == [parity_check.f1_counts(d, truths, thresholds) for d in ref])
    assert [r["tp_fn"] for r in parity_check.f1_counts(port[0], truths)] == [len(truths)] * 6


def test_check_runs_end_to_end_on_the_cpu(tmp_path):
    """``check`` at the flagship's 416 on the CPU (``device="cpu"``): the
    verdict's layers, the stated absence of tier 1 (no reference sources)
    and ``ok`` decided by tier 2 alone."""
    report = parity_check.check(str(tmp_path), dynamic=True, seed=1, device="cpu")
    assert report["tier1"] == "not run: reference sources absent"
    assert report["ok"] == report["tier2_ok"]
    assert set(report["tier2_engine_lsb"]) == {i for i in range(23) if i != 16}
    assert report["tier2_f1_counts"]["twin"]["tp_fn"] == report["tier2_f1_counts"]["engine"]["tp_fn"]
    assert report["twin_seconds"] > 0 and set(report["tier2_quant_stop_max_abs"]) == {15, 22}



def test_crossf1_writes_the_parity_engines_weight_codes(tmp_path):
    """The .weights file of crossf1 holds the asymmetric per-channel codes
    of the parity engine that the twin's rows are compared with."""
    from yolo_quantization_tpu_torch.infer.convert import convert

    crossf1.run(str(tmp_path), steps=1, train_size=32, batch=1, n_train=1, n_eval=1, device="cpu",
                phase="train", log=lambda m: None)
    net = crossf1.flagship_net()
    ckpt = tdw.load_darknet_weights(str(tmp_path / "crossf1.weights"), net)
    program = convert(net, ckpt.params, ckpt.quant_state, symmetric_weights=False, route_rescale=False)
    convs = [i for i, raw in ckpt.raw_quant.items() if "weights_u8" in raw]
    assert len(convs) == 13
    for i in convs:
        a = program.arrays[i]
        np.testing.assert_array_equal(ckpt.raw_quant[i]["weight_zps"], a["w_zp_u8"])
        w_u8 = (a["w_i8"].astype(np.int16) + 128).astype(np.uint8).transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(ckpt.raw_quant[i]["weights_u8"], w_u8)
    assert any(np.any(ckpt.raw_quant[i]["weight_zps"] != 128) for i in convs)
