"""The yolov2/yolov1 family through the port against the JAX package, on
the CPU: the zoo builders, ``convert``'s layer kinds and the fusion plan,
the integer engine's codes at every layer of full-width yolov2-tiny (96x96)
and yolov2 (64x64) bit-equal to the un-jitted JAX engine, the region and
detection decodes (rtol 1e-6, atol 1e-7), ``nms_sort_per_class``, the
approximate top-k (the exact one), and the yolov1-tiny and darknet19 float
programs and the float / fake-quant engines within float tolerance.  The
losses and train steps are in ``test_torch_v2_train.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_quantization_tpu.eval import detect as jdetect
from yolo_quantization_tpu.infer import convert as jconvert
from yolo_quantization_tpu.infer import engine as jengine
from yolo_quantization_tpu.infer import float_engine as jfe
from yolo_quantization_tpu.models import zoo as jzoo
from yolo_quantization_tpu.nn import graph as JG
from yolo_quantization_tpu_torch.eval import detect as tdetect
from yolo_quantization_tpu_torch.infer import engine as tengine
from yolo_quantization_tpu_torch.infer import float_engine as tfe
from yolo_quantization_tpu_torch.infer.convert import convert
from yolo_quantization_tpu_torch.models import presets as tpresets
from yolo_quantization_tpu_torch.models import zoo as tzoo
from yolo_quantization_tpu_torch.nn import graph as TG

torch.set_num_threads(2)

DECODE_TOL = dict(rtol=1e-6, atol=1e-7)
FLOAT_TOL = dict(rtol=1e-4, atol=1e-5)
MODELS = {  # name -> (builder kwargs at test size, K1 launches per forward at any size)
    "yolov2_tiny": (dict(width=96, height=96), 9),
    "yolov2": (dict(width=64, height=64), 23),
    "yolov1_tiny": (dict(classes=3, side=3, width=192, height=192), 0),
    "darknet19": (dict(classes=10, width=64, height=64), 0),
}


def spec_rows(net):
    return [(type(s).__name__, dataclasses.asdict(s)) for s in net.specs], (net.width, net.height,
                                                                            net.channels)


@pytest.mark.parametrize("name", list(MODELS))
def test_builders_and_convert_match_jax(name):
    """Specs field for field, ``convert``'s per-layer kinds, scales and
    arrays bit for bit (v2 under ``presets.v2_quant_state``), the fusion plan
    and the K1 launches it implies."""
    kw, k1 = MODELS[name]
    tnet, jnet = getattr(tzoo, name)(**kw), getattr(jzoo, name)(**kw)
    assert spec_rows(tnet) == spec_rows(jnet)
    assert tnet.shapes() == jnet.shapes() and tnet.output_domains() == jnet.output_domains()
    params = TG.init_params_numpy(0, tnet)
    qs = tpresets.v2_quant_state(tnet)
    tp, jp = convert(tnet, params, qs), jconvert.convert(jnet, params, qs)
    for i, (a, b) in enumerate(zip(tp.cfg, jp.cfg)):
        assert (a.kind, a.out_scale, a.out_zp, a.act, a.quant_stop, a.in_scales, a.branches) == \
            (b.kind, b.out_scale, b.out_zp, b.act, b.quant_stop, b.in_scales, b.branches), i
    assert tp.arrays.keys() == jp.arrays.keys()
    for i in tp.arrays:
        assert tp.arrays[i].keys() == jp.arrays[i].keys()
        for k in tp.arrays[i]:
            np.testing.assert_array_equal(tp.arrays[i][k], jp.arrays[i][k], err_msg=f"{i}.{k}")
    kinds = [c.kind for c in tp.cfg]
    assert kinds.count("qconv") == k1
    plan = tengine.fusion_plan(tp)
    if name == "yolov2_tiny":
        assert plan == {0, 2, 4, 6, 8}  # pool 11 (2x2, stride 1) stays on maxpool_u8
    elif name == "yolov2":
        assert plan == {0, 2, 6, 10}    # pool 17 not: route 25 reads conv 16
        assert kinds[25:30] == ["route", "qconv", "simple", "route_f32", "qconv"]
        assert tp.cfg[29].in_scales[0] is not None  # the float -> quant boundary
    else:
        assert "qconv" not in kinds and "fconv" in kinds


@pytest.fixture(scope="module")
def v2_programs():
    """name -> (JAX program, port program) from the same seeded params and
    ``presets.v2_quant_state`` (equal: ``test_builders_and_convert_match_jax``)."""
    out = {}
    for name, size, build in (("yolov2_tiny", 96, tpresets.v2_tiny_program),
                              ("yolov2", 64, tpresets.v2_program)):
        jnet = getattr(jzoo, name)(width=size, height=size)
        qs = tpresets.v2_quant_state(getattr(tzoo, name)(width=size, height=size))
        out[name] = (jconvert.convert(jnet, JG.init_params_numpy(0, jnet), qs), build(size=size))
    return out


@pytest.mark.parametrize("name,dtype", [("yolov2_tiny", "float32"), ("yolov2_tiny", "uint8"),
                                        ("yolov2", "float32")])
def test_integer_engine_every_layer_matches_jax(v2_programs, name, dtype):
    """Every layer's output of the unfused engine (the reference's XLA
    layout) equals the un-jitted JAX engine's: int8 codes, the dequantized
    head and yolov2's float reorg and route bit for bit, the region layer's
    logistic and softmax (XLA's and torch's differ by ulps) and the fused
    engine's heads and detections within the decode tolerance."""
    jp, tp = v2_programs[name]
    rng = np.random.default_rng(7)
    shape = (2, tp.net.height, tp.net.width, 3)
    x = rng.uniform(0, 1, shape).astype(np.float32) if dtype == "float32" else \
        rng.integers(0, 256, shape, dtype=np.uint8)
    jheads, jouts = jengine.build_forward(jp, return_outputs=True)(jax.device_put(jp.arrays),
                                                                   jnp.asarray(x))
    eng = tengine.Engine(tp, max_det=48, device="cpu", fuse_pool=False)
    heads, outs = eng.raw_heads(x, return_outputs=True)
    assert len(outs) == len(tp.cfg)
    for i, (a, b) in enumerate(zip(jouts, outs)):
        assert b.dtype == np.asarray(a).dtype, i
        if isinstance(tp.net.specs[i], TG.RegionSpec):
            np.testing.assert_allclose(b, np.asarray(a), **DECODE_TOL, err_msg=f"layer {i}")
        else:
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=f"layer {i}")
    fused = tengine.Engine(tp, max_det=48, device="cpu")
    for a, b in zip(jheads, fused.raw_heads(x)):
        np.testing.assert_allclose(b, np.asarray(a), **DECODE_TOL)
    jdets = jdetect.top_k_detections(*jdetect.decode_all_heads(jheads, jp.net), max_det=48)
    for a, b in zip(jdets, fused.predict(x)):
        np.testing.assert_allclose(b, np.asarray(a), **DECODE_TOL)


def test_flip_at_size_and_approx_on_a_region_head(v2_programs):
    """flip TTA keeps a region head unflipped, as the reference's; at_size
    and the approximate top-k (the exact one) equal the JAX engine's."""
    jp, tp = v2_programs["yolov2_tiny"]
    x = np.random.default_rng(8).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jeng = jengine.Engine(jp, max_det=32).at_size(64)
    eng = tengine.Engine(tp, max_det=32, device="cpu", approx_topk=True).at_size(64)
    for a, b in zip(jeng.raw_heads(x), eng.raw_heads(x)):
        np.testing.assert_allclose(b, a, **DECODE_TOL)
    for flip in (False, True):
        heads = jengine.build_forward(jeng.program)(jax.device_put(jp.arrays), jnp.asarray(x))
        jdets = jdetect.top_k_detections(*jdetect.decode_all_heads(heads, jeng.program.net), max_det=32)
        for a, b in zip(jdets, eng.predict(x, flip=flip)):
            np.testing.assert_allclose(b, np.asarray(a), **DECODE_TOL)


@pytest.mark.parametrize("sqrt,softmax", [(True, False), (False, True)])
def test_decodes_and_nms_sort_match_jax(sqrt, softmax):
    rng = np.random.default_rng(9)
    rs = dict(anchors=((1.08, 1.19), (3.42, 4.41), (6.63, 11.38)), classes=3, num=3, softmax=softmax)
    ds = dict(classes=3, num=2, side=3, sqrt=sqrt, softmax=softmax)
    region_raw = rng.standard_normal((2, 5, 4, 3 * 8)).astype(np.float32)
    det_raw = rng.uniform(-0.2, 1.0, (2, 9 * (3 + 2 * 5))).astype(np.float32)
    outs = {}
    for G, cast, D in ((JG, jnp.asarray, jdetect), (TG, torch.from_numpy, tdetect)):
        rspec, dspec = G.RegionSpec(**rs), G.DetectionSpec(**ds)
        r = G.apply_simple_layer(rspec, None, cast(region_raw))
        d = G.apply_simple_layer(dspec, None, cast(det_raw))
        net = G.NetworkDef(specs=(rspec, dspec), width=160, height=128)
        outs[G] = [np.asarray(t) for t in D.decode_all_heads([r, d], net)]
        outs[G] += [np.asarray(t) for t in D.top_k_detections(*D.decode_all_heads([r, d], net),
                                                                max_det=40, approx=True)]
    for a, b in zip(outs[JG], outs[TG]):
        np.testing.assert_allclose(b, a, **DECODE_TOL)
    boxes, obj, cls = outs[TG][3][0], outs[TG][4][0], outs[TG][5][0]
    probs = obj[:, None] * cls
    for thresh in (0.3, 0.45, 0.7):
        np.testing.assert_array_equal(tdetect.nms_sort_per_class(boxes, probs, thresh),
                                      jdetect.nms_sort_per_class(boxes, probs, thresh))


@pytest.mark.parametrize("name", ["yolov1_tiny", "darknet19"])
def test_float_programs_and_engines_match_jax(name):
    """The float programs (every conv ``fconv``, the connected / dropout /
    detection or avgpool / softmax tail ``simple``) through the integer
    engine, and the float engine, against the JAX package's: every layer
    within float tolerance, detections too."""
    kw, _ = MODELS[name]
    tnet, jnet = getattr(tzoo, name)(**kw), getattr(jzoo, name)(**kw)
    params = TG.init_params_numpy(2, tnet)
    tp = convert(tnet, params, TG.init_quant_state(tnet))
    jp = jconvert.convert(jnet, params, JG.init_quant_state(jnet))
    x = np.random.default_rng(14).uniform(0, 1, (2, tnet.height, tnet.width, 3)).astype(np.float32)
    jheads, jouts = jengine.build_forward(jp, return_outputs=True)(jax.device_put(jp.arrays), jnp.asarray(x))
    heads, outs = tengine.Engine(tp, device="cpu").raw_heads(x, return_outputs=True)
    for i, (a, b) in enumerate(zip(jouts, outs)):
        np.testing.assert_allclose(b, np.asarray(a), **FLOAT_TOL, err_msg=f"layer {i}")
    fheads = tfe.FloatEngine(tnet, params, device="cpu").raw_heads(x)
    jfheads = jfe.FloatEngine(jnet, params).raw_heads(x)
    assert len(fheads) == len(jfheads) == len(heads) == (1 if name == "yolov1_tiny" else 0)
    for a, b in zip(jfheads, fheads):
        np.testing.assert_allclose(b, np.asarray(a), **FLOAT_TOL)
    if name == "yolov1_tiny":
        jdets = jdetect.top_k_detections(*jdetect.decode_all_heads(jheads, jnet), max_det=18)
        for a, b in zip(jdets, tengine.Engine(tp, max_det=18, device="cpu").predict(x)):
            np.testing.assert_allclose(b, np.asarray(a), **FLOAT_TOL)


def test_float_and_qat_sim_engines_run_yolov2_tiny():
    """FloatEngine on yolov2-tiny against the JAX engine: predict, with flip,
    and at another size against the reference's engine built at that size.
    QatSimEngine against the port's own engine built at each size: a whole
    fake-quant forward is not reproducible across implementations (an ulp
    of a conv output moves a code, ``tools/qat_check.py``), and its layers
    are held to the reference's one by one in ``test_torch_qat.py``."""
    def nets(size):
        return (tzoo.yolov2_tiny(classes=3, width=size, height=size),
                jzoo.yolov2_tiny(classes=3, width=size, height=size))

    net, jnet = nets(64)
    net96, jnet96 = nets(96)
    params = TG.init_params_numpy(6, net)
    qs = tpresets.v2_quant_state(net)
    x = np.random.default_rng(15).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    x96 = np.random.default_rng(16).uniform(0, 1, (1, 96, 96, 3)).astype(np.float32)
    feng = tfe.FloatEngine(net, params, max_det=24, device="cpu")
    qeng = tfe.QatSimEngine(net, params, qs, max_det=24, device="cpu")
    cases = [(feng.predict(x), jfe.FloatEngine(jnet, params, max_det=24).predict(x)),
             (feng.predict(x, flip=True), jfe.FloatEngine(jnet, params, max_det=24).predict(x, flip=True)),
             (feng.at_size(96).predict(x96), jfe.FloatEngine(jnet96, params, max_det=24).predict(x96)),
             (qeng.at_size(96).predict(x96),
              tfe.QatSimEngine(net96, params, qs, max_det=24, device="cpu").predict(x96))]
    for got, want in cases:
        for a, b in zip(want, got):
            np.testing.assert_allclose(b, np.asarray(a), **FLOAT_TOL)
    heads = qeng.raw_heads(x)
    assert heads[0].shape == (2, 2, 2, 5 * 8)
    boxes, obj, cls = qeng.predict(x)
    assert boxes.shape == (2, 20, 4) and np.isfinite(boxes).all() and (0 <= obj).all() and (obj <= 1).all()
