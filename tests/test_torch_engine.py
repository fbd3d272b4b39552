"""The port's integer engine equals the JAX engine: int8 codes at every layer,
dequantized heads bit for bit, decoded detections within float tolerance."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_quantization_tpu.infer import engine as jengine
from yolo_quantization_tpu.models import presets as jpresets
from yolo_quantization_tpu_torch.eval import detect as tdetect
from yolo_quantization_tpu_torch.infer import engine as tengine
from yolo_quantization_tpu_torch.infer.convert import convert
from yolo_quantization_tpu_torch.models import presets as tpresets
from yolo_quantization_tpu_torch.nn import graph as G
from yolo_quantization_tpu_torch.ops import cuda_qconv, cuda_s2d

torch.set_num_threads(2)

SIZE = 64
# Decoded boxes/obj/cls are sigmoid/exp of bit-equal dequantized heads; XLA's
# and PyTorch's CPU sigmoid and exp differ by a few ulps, hence the tolerance.
DECODE_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def programs():
    return jpresets.flagship_program(size=SIZE), tpresets.flagship_program(size=SIZE)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(5)
    return {
        "float32": rng.uniform(0, 1, (3, SIZE, SIZE, 3)).astype(np.float32),
        "uint8": rng.integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8),
    }


def test_fusion_plan_is_the_four_stem_pools(programs):
    _, tp = programs
    assert tengine.fusion_plan(tp) == {0, 2, 4, 6}


def test_route20_requantizes_both_branches(programs):
    """Under synthetic ranges route 20 mixes relu6 [0,6] branches into a
    [-2,6] grid: neither branch is an identity copy (ratio 6/8)."""
    _, tp = programs
    c = tp.cfg[20]
    assert c.kind == "route" and len(c.branches) == 2
    for identity, ratio, _ in c.branches:
        assert not identity
        assert ratio == pytest.approx(0.75, rel=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_every_layer_matches_jax(programs, images, dtype):
    """The unfused layout (fuse_pool=False) against the reference's XLA
    path: every slot its own layer's output."""
    jp, tp = programs
    x = images[dtype]
    jheads, jouts = jengine.build_forward(jp, use_pallas=False, return_outputs=True)(
        jax.device_put(jp.arrays), jnp.asarray(x))
    theads, touts = tengine.build_forward(tp, return_outputs=True, fuse_pool=False)(
        tengine.device_arrays(tp, "cpu"), torch.from_numpy(x))
    assert len(jouts) == len(touts) == len(tp.cfg)
    for i, got in enumerate(touts):
        ref = np.asarray(jouts[i])
        assert got.numpy().dtype == ref.dtype, i
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"layer {i}")
    assert len(jheads) == len(theads) == 2
    for a, b in zip(jheads, theads):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.fixture(scope="module")
def parity_programs():
    """The C-binary parity configuration: leaky yolov3-tiny, asymmetric
    weights, raw-byte route concat, from the same seeded weights."""
    from yolo_quantization_tpu.infer.convert import convert as jconvert
    from yolo_quantization_tpu.models import zoo as jzoo
    from yolo_quantization_tpu.nn.graph import init_params_numpy

    net = jzoo.yolov3_tiny(classes=5, activation="leaky", width=SIZE, height=SIZE)
    jp = jconvert(net, init_params_numpy(0, net), jpresets.synthetic_quant_state(net),
                  symmetric_weights=False, route_rescale=False)
    return jp, tpresets.parity_program(size=SIZE)


CONFIGS = {
    "s2d": dict(use_s2d=True),
    "s2d_dynamic": dict(use_s2d=True, dynamic_input=True),
    "parity": dict(dynamic_input=True, exact_leaky=True),
    "int16": dict(carrier="int16"),
}


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_options_match_jax_layer_by_layer(programs, parity_programs, images, config, dtype):
    """Per-layer int8 codes and heads bit-equal to the JAX engine's under
    each option set; decoded boxes within float tolerance."""
    from yolo_quantization_tpu.eval import detect as jdetect

    jp, tp = parity_programs if config == "parity" else programs
    option = CONFIGS[config]
    x = images[dtype]
    jheads, jouts = jengine.build_forward(jp, return_outputs=True, **option)(
        jax.device_put(jp.arrays), jnp.asarray(x))
    # unfused (the reference's XLA layout); the s2d layers hold the pooled
    # tensor in both engines
    theads, touts = tengine.build_forward(tp, return_outputs=True, fuse_pool=False, **option)(
        tengine.device_arrays(tp, "cpu"), torch.from_numpy(x))
    s2d = {i for i, c in enumerate(tp.cfg) if c.s2d_pool} if option.get("use_s2d") else set()
    if config == "s2d":
        assert s2d == {0, 2, 4}
    assert len(jouts) == len(touts) == len(tp.cfg)
    for i, got in enumerate(touts):
        ref = np.asarray(jouts[i])
        assert got.numpy().dtype == ref.dtype, i
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"layer {i}")
    for a, b in zip(jheads, theads):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jd = jdetect.decode_all_heads(jheads, jp.net)
    td = tdetect.decode_all_heads(theads, tp.net)
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **DECODE_TOL)


def test_predict_and_nms_match_jax(programs, images):
    jp, tp = programs
    x = images["float32"]
    jb, jo, jc = jengine.Engine(jp, max_det=64).predict(x)
    tb, to, tc = tengine.Engine(tp, max_det=64, device="cpu").predict(x)
    # top-k values and order (ties: lower index first, as lax.top_k)
    np.testing.assert_allclose(to, jo, **DECODE_TOL)
    np.testing.assert_allclose(tb, jb, **DECODE_TOL)
    np.testing.assert_allclose(tc, jc, **DECODE_TOL)
    for i in range(x.shape[0]):
        kj, kt = jo[i] > 0.5, to[i] > 0.5
        _, oj, _ = tdetect.nms_obj(jb[i][kj], jo[i][kj], jc[i][kj], 0.45)
        _, ot, _ = tdetect.nms_obj(tb[i][kt], to[i][kt], tc[i][kt], 0.45)
        assert (oj > 0.5).sum() == (ot > 0.5).sum()


def test_decode_matches_jax(programs, images):
    from yolo_quantization_tpu.eval import detect as jdetect

    jp, tp = programs
    heads = tengine.Engine(tp, device="cpu").raw_heads(images["float32"])
    jd = jdetect.decode_all_heads([jnp.asarray(h) for h in heads], jp.net)
    td = tdetect.decode_all_heads([torch.from_numpy(h) for h in heads], tp.net)
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **DECODE_TOL)
    jk = jdetect.top_k_detections(*jd, max_det=100)
    tk = tdetect.top_k_detections(*[torch.from_numpy(np.array(a)) for a in jd], max_det=100)
    for a, b in zip(jk, tk):  # same inputs: top-k values and gathers are exact
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_top_k_ties_keep_lower_index_first():
    obj = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]])
    boxes = torch.arange(6, dtype=torch.float32).reshape(1, 6, 1).expand(1, 6, 4).contiguous()
    cls = boxes[..., :2].contiguous()
    b, v, _ = tdetect.top_k_detections(boxes, obj, cls, max_det=4)
    assert b[0, :, 0].tolist() == [1.0, 3.0, 0.0, 2.0]
    ref = jax.lax.top_k(jnp.asarray(obj.numpy()), 4)
    assert np.asarray(ref[1])[0].tolist() == [1, 3, 0, 2]


def test_raw_heads_and_outputs(programs, images):
    _, tp = programs
    eng = tengine.Engine(tp, device="cpu")
    heads, outs = eng.raw_heads(images["uint8"], return_outputs=True)
    np.testing.assert_array_equal(heads[0], eng.raw_heads(images["uint8"])[0])
    assert len(outs) == len(tp.cfg) and outs[0].dtype == np.int8
    with pytest.raises(ValueError, match="letterbox"):
        eng.predict(np.zeros((1, 32, 32, 3), np.float32))


def test_cpu_engine_counts_no_kernel_launches(programs, images):
    _, tp = programs
    before = cuda_qconv.launches, cuda_s2d.launches
    tengine.Engine(tp, device="cpu", use_s2d=True).predict(images["float32"])
    assert (cuda_qconv.launches, cuda_s2d.launches) == before


def _small_net(extra):
    """conv(s2) -> conv -> [extra] -> head conv -> yolo, at 32x32."""
    specs = (
        G.ConvSpec(8, 3, stride=2, pad=1, activation="leaky"),
        G.ConvSpec(8, 3, pad=1, activation="relu6"),
        *extra,
        G.ConvSpec(3 * 7, 1, pad=0, activation="linear", batch_normalize=False, quant_stop=True),
        G.YoloSpec(mask=(0, 1, 2), anchors=((10, 14), (23, 27), (37, 58)), classes=2),
    )
    return G.NetworkDef(specs=specs, width=32, height=32)


def _program(net, symmetric=True):
    qs = G.init_quant_state(net)
    qs["input"] = {"min": np.float32(0.0), "max": np.float32(1.0)}
    for k in qs:
        if k != "input":
            qs[k] = {"min": np.float32(-3.0), "max": np.float32(6.0)}
    return convert(net, G.init_params_numpy(1, net), qs, symmetric_weights=symmetric)


@pytest.mark.parametrize("symmetric", [True, False])
def test_cpu_engine_runs_stride2_and_asymmetric_convs(symmetric):
    """Off the kernel's coverage the CPU engine runs the plain conv; it
    matches the JAX engine."""
    from yolo_quantization_tpu.infer.serialize import load_program as jload
    from yolo_quantization_tpu_torch.infer.serialize import save_program

    prog = _program(_small_net(()), symmetric)
    x = np.random.default_rng(2).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        save_program(os.path.join(d, "p.npz"), prog)
        jp = jload(os.path.join(d, "p.npz"))
    jh = jengine.build_forward(jp)(jax.device_put(jp.arrays), jnp.asarray(x))
    th = tengine.build_forward(prog)(tengine.device_arrays(prog, "cpu"), torch.from_numpy(x))
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _jax_predict(jp, x, max_det, **option):
    """The JAX engine's heads (un-jitted, so XLA's division is not turned
    into a reciprocal multiply) decoded and top-k'd as Engine.predict does."""
    from yolo_quantization_tpu.eval import detect as jdetect

    heads = jengine.build_forward(jp, **option)(jax.device_put(jp.arrays), jnp.asarray(x))
    return heads, jdetect.top_k_detections(*jdetect.decode_all_heads(heads, jp.net), max_det=max_det)


@pytest.mark.parametrize("option", [
    dict(use_s2d=True),
    dict(carrier="int16"),
    dict(dynamic_input=True),
    dict(exact_leaky=True),
])
def test_options_of_the_slice_match_jax(programs, images, option):
    """Each engine option the reference has runs on the CPU engine: heads
    bit-equal to the JAX engine's, detections within float tolerance."""
    jp, tp = programs
    x = images["uint8"]
    eng = tengine.Engine(tp, max_det=32, device="cpu", **option)
    jheads, jdets = _jax_predict(jp, x, 32, **option)
    for a, b in zip(jheads, eng.raw_heads(x)):
        np.testing.assert_array_equal(b, np.asarray(a))
    for a, b in zip(jdets, eng.predict(x)):
        np.testing.assert_allclose(b, np.asarray(a), **DECODE_TOL)


def test_options_outside_the_slice_raise(programs, images):
    """``approx_topk`` runs the exact stable top-k (the reference's
    approximate top-k is a TPU primitive), so its detections equal the JAX
    engine's exact ones; s2d on the int16 carrier raises."""
    jp, tp = programs
    x = images["float32"]
    _, jdets = _jax_predict(jp, x, 32)
    eng = tengine.Engine(tp, max_det=32, device="cpu", approx_topk=True)
    exact = tengine.Engine(tp, max_det=32, device="cpu").predict(x)
    for a, b, c in zip(jdets, eng.predict(x), exact):
        np.testing.assert_allclose(b, np.asarray(a), **DECODE_TOL)
        np.testing.assert_array_equal(b, c)
    with pytest.raises(ValueError, match="carrier"):
        tengine.Engine(tp, device="cpu", use_s2d=True, carrier="int16")


def test_flip_tta_matches_jax(programs, images):
    """predict(flip=True) averages the yolo heads over the mirrored batch,
    as the JAX engine does."""
    from yolo_quantization_tpu.eval import detect as jdetect

    jp, tp = programs
    x = images["float32"]
    jb, jo, jc = jengine.Engine(jp, max_det=32).predict(x, flip=True)
    tb, to, tc = tengine.Engine(tp, max_det=32, device="cpu").predict(x, flip=True)
    np.testing.assert_allclose(to, jo, **DECODE_TOL)
    np.testing.assert_allclose(tb, jb, **DECODE_TOL)
    np.testing.assert_allclose(tc, jc, **DECODE_TOL)
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((2, 5, 7, 30)).astype(np.float32) for _ in range(2))
    got = tdetect.flip_average_head(torch.from_numpy(a), torch.from_numpy(b), 5).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jdetect.flip_average_head(jnp.asarray(a), jnp.asarray(b), 5)))


def test_at_size_matches_jax(programs, images):
    """at_size shares the device arrays, caches per size, and runs the same
    program at another resolution as the JAX engine's at_size."""
    jp, tp = programs
    eng = tengine.Engine(tp, max_det=32, device="cpu")
    e96 = eng.at_size(96)
    assert e96 is eng.at_size(96) and eng.at_size(SIZE) is eng and e96.arrays is eng.arrays
    with pytest.raises(ValueError, match="multiple of 32"):
        eng.at_size(100)
    x = np.random.default_rng(3).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    jb, jo, jc = jengine.Engine(jp, max_det=32).at_size(96).predict(x)
    tb, to, tc = e96.predict(x)
    np.testing.assert_allclose(to, jo, **DECODE_TOL)
    np.testing.assert_allclose(tb, jb, **DECODE_TOL)
    np.testing.assert_allclose(tc, jc, **DECODE_TOL)


def test_engine_runs_on_cuda_unless_asked(programs):
    _, tp = programs
    if torch.cuda.is_available():
        assert tengine.Engine(tp).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tengine.Engine(tp)


def test_raw_heads_outputs_run_the_engine_options(programs, images, monkeypatch):
    """raw_heads(return_outputs=True) runs the engine's own configuration:
    with use_s2d the s2d stem kernel fills layer 0's slot with the pooled
    tensor, and with dynamic_input the codes are the per-image ones."""
    _, tp = programs
    calls = []
    real = tengine.cuda_s2d.s2d_conv_phase_max_cuda
    monkeypatch.setattr(tengine.cuda_s2d, "s2d_conv_phase_max_cuda",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = images["float32"]
    eng = tengine.Engine(tp, device="cpu", use_s2d=True)
    heads, outs = eng.raw_heads(x, return_outputs=True)
    assert len(calls) == 3  # layers 0, 2 and 4
    assert outs[0].shape == (3, SIZE // 2, SIZE // 2, 16)
    np.testing.assert_array_equal(outs[0], outs[1])
    dyn = tengine.Engine(tp, device="cpu", dynamic_input=True)
    heads_d, outs_d = dyn.raw_heads(x, return_outputs=True)
    np.testing.assert_array_equal(heads_d[0], dyn.raw_heads(x)[0])
    assert not np.array_equal(outs_d[0], outs[0])


def test_npz_program_runs_k1_only_under_use_s2d(programs, images, monkeypatch, tmp_path):
    """save_program drops s2d_pool, as the reference's does: a loaded program
    runs every conv on K1 even with use_s2d, with the same codes."""
    from yolo_quantization_tpu_torch.infer.serialize import load_program, save_program

    _, tp = programs
    save_program(str(tmp_path / "p.npz"), tp)
    loaded = load_program(str(tmp_path / "p.npz"))
    assert not any(c.s2d_pool for c in loaded.cfg) and "w_s2d" in loaded.arrays[0]
    calls = []
    real = tengine.cuda_s2d.s2d_conv_phase_max_cuda
    monkeypatch.setattr(tengine.cuda_s2d, "s2d_conv_phase_max_cuda",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = images["uint8"]
    got = tengine.Engine(loaded, device="cpu", use_s2d=True).raw_heads(x)
    assert not calls
    for a, b in zip(got, tengine.Engine(tp, device="cpu", use_s2d=True).raw_heads(x)):
        np.testing.assert_array_equal(a, b)
    assert len(calls) == 3


@pytest.mark.parametrize("extra,kind", [
    ((G.AvgPoolSpec(),), "simple"),
    ((G.DropoutSpec(),), "simple"),
    ((G.ActivationSpec("tanh"),), "simple"),
])
def test_layer_kinds_outside_the_slice_raise(extra, kind):
    """The extended float layers (the ``simple`` kind) run in the engine
    since the yolov2/yolov1 slice: every layer equals the JAX engine's
    (float layers within float tolerance), the heads likewise."""
    from yolo_quantization_tpu.infer.serialize import load_program as jload
    from yolo_quantization_tpu_torch.infer.serialize import save_program

    prog = _program(_small_net(extra))
    assert any(c.kind == kind for c in prog.cfg)
    x = np.random.default_rng(4).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        save_program(os.path.join(d, "p.npz"), prog)
        jp = jload(os.path.join(d, "p.npz"))
    jh, jout = jengine.build_forward(jp, return_outputs=True)(jax.device_put(jp.arrays), jnp.asarray(x))
    th, tout = tengine.build_forward(prog, return_outputs=True)(tengine.device_arrays(prog, "cpu"),
                                                                torch.from_numpy(x))
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.numpy().astype(np.float32), np.asarray(a).astype(np.float32),
                                   rtol=1e-5, atol=1e-5)
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)


def test_region_head_decode_raises():
    """A region head decodes as the JAX package's does; a WordTree region
    head raises naming the queue item of ``core/tree.py``."""
    from yolo_quantization_tpu.eval import detect as jdetect
    from yolo_quantization_tpu.nn import graph as JG

    out = np.random.default_rng(0).uniform(-1, 1, (2, 3, 4, 2 * 7)).astype(np.float32)
    jnet = JG.NetworkDef(specs=(JG.RegionSpec(anchors=((1, 1), (2, 3)), classes=2, num=2),),
                         width=32, height=32)
    net = G.NetworkDef(specs=(G.RegionSpec(anchors=((1, 1), (2, 3)), classes=2, num=2),),
                       width=32, height=32)
    for a, b in zip(jdetect.decode_all_heads([jnp.asarray(out)], jnet),
                    tdetect.decode_all_heads([torch.from_numpy(out)], net)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **DECODE_TOL)
    tree_net = G.NetworkDef(specs=(G.RegionSpec(anchors=((1, 1),), classes=2, num=1, tree="t"),),
                            width=32, height=32)
    with pytest.raises(NotImplementedError, match="queue 1.12"):
        tdetect.decode_all_heads([torch.zeros(1, 1, 1, 7)], tree_net)


@pytest.mark.cuda
def test_cuda_engine_matches_cpu_engine(programs, images):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the conv kernel has no CPU mode)")
    _, tp = programs
    gpu = tengine.Engine(tp, device="cuda")
    cpu = tengine.Engine(tp, device="cpu")
    for x in images.values():
        before = cuda_qconv.launches
        hg, og = gpu.raw_heads(x, return_outputs=True)
        assert cuda_qconv.launches - before == 13
        hc, oc = cpu.raw_heads(x, return_outputs=True)
        for a, b in zip(og + hg, oc + hc):
            np.testing.assert_array_equal(a, b)
    # layer 0 is a stride-2 conv: K1 runs it on the card
    prog = _program(_small_net(()))
    x = np.random.default_rng(4).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    before = cuda_qconv.launches
    hg, og = tengine.Engine(prog, device="cuda").raw_heads(x, return_outputs=True)
    assert cuda_qconv.launches - before == 3
    hc, oc = tengine.Engine(prog, device="cpu").raw_heads(x, return_outputs=True)
    for a, b in zip(og + hg, oc + hc):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(CONFIGS))
def test_cuda_engine_options_match_cpu_engine(programs, parity_programs, images, config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    _, tp = parity_programs if config == "parity" else programs
    option = CONFIGS[config]
    gpu = tengine.Engine(tp, device="cuda", **option)
    cpu = tengine.Engine(tp, device="cpu", **option)
    k2 = 3 if option.get("use_s2d") else 0
    for x in images.values():
        before = cuda_qconv.launches, cuda_s2d.launches
        hg, og = gpu.raw_heads(x, return_outputs=True)
        assert (cuda_qconv.launches - before[0], cuda_s2d.launches - before[1]) == (13 - k2, k2)
        hc, oc = cpu.raw_heads(x, return_outputs=True)
        for a, b in zip(og + hg, oc + hc):
            np.testing.assert_array_equal(a, b)
