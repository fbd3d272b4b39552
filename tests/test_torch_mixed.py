"""Mixed float/quant graphs (darknet's per-layer quantized=0) through the
port's integer engine against the JAX package's, on the CPU; and the
engine's unfused layout (``fuse_pool=False``), every layer's own output,
against the JAX engine's XLA path.

The mixed nets run every float kind ``convert`` emits: the float conv, the
float -> quant boundary before a quantized conv, the float maxpool, the
float route (int8 and float branches), the float shortcut (float operands,
and an int8 operand with a float one) and the dequant -> add -> requant
shortcut of an activation the integer kernel does not take.  Every integer
layer before the first float layer is bit-equal to the JAX engine; later
int8 codes are within one of JAX's on at least 99.9% of elements (a float
conv's ulp can move a code across a rounding boundary), float outputs within
rtol=1e-4, atol=1e-5 on 99.9%, and the detections within PERF.md §2's
decode tolerance wherever the heads are bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_v3 import narrow_v3
from yolo_quantization_tpu.eval import detect as jdetect
from yolo_quantization_tpu.infer import convert as jconvert
from yolo_quantization_tpu.infer import engine as jengine
from yolo_quantization_tpu.models import presets as jpresets
from yolo_quantization_tpu.nn import graph as JG
from yolo_quantization_tpu_torch.eval import detect as tdetect
from yolo_quantization_tpu_torch.infer import engine as tengine
from yolo_quantization_tpu_torch.infer.convert import convert
from yolo_quantization_tpu_torch.models import presets as tpresets
from yolo_quantization_tpu_torch.nn import graph as TG
from yolo_quantization_tpu_torch.ops import cuda_qconv, cuda_shortcut
from yolo_quantization_tpu_torch.tools import qat_check as Q

torch.set_num_threads(2)

ANCHORS = ((10, 14), (23, 27), (37, 58))
DECODE_TOL = dict(rtol=1e-6, atol=1e-7)


def mixed_net(G):
    """tests/test_mixed_graphs.py's net: quant conv -> pool -> FLOAT conv ->
    quant conv -> head."""
    return G.NetworkDef(specs=(
        G.ConvSpec(filters=8, activation="relu6", quantized=True),
        G.MaxPoolSpec(2, 2),
        G.ConvSpec(filters=12, activation="leaky", quantized=False),
        G.ConvSpec(filters=16, activation="relu6", quantized=True),
        G.ConvSpec(filters=3 * 9, size=1, pad=0, activation="linear", batch_normalize=False,
                   quantized=True, quant_stop=True),
        G.YoloSpec(mask=(0, 1, 2), anchors=ANCHORS, classes=4),
    ), width=64, height=64)


def all_kinds_net(G):
    """Every float kind of the integer engine in one net (32x32)."""
    f = lambda n, act="leaky", q=True, k=3: G.ConvSpec(  # noqa: E731
        filters=n, size=k, pad=k // 2, activation=act, quantized=q)
    return G.NetworkDef(specs=(
        f(8, "relu6"),                                  # 0  qconv            u8
        f(8, q=False),                                  # 1  fconv (dequant)  f32
        G.MaxPoolSpec(2, 2),                            # 2  float maxpool    f32
        f(8),                                           # 3  qconv, boundary  u8
        f(8),                                           # 4  qconv            u8
        G.ShortcutSpec(index=3, activation="logistic"),  # 5  dequant-add-requant  u8
        G.RouteSpec(layers=(2, 5)),                     # 6  route_f32        f32
        f(16, q=False),                                 # 7  fconv            f32
        G.ShortcutSpec(index=6, activation="linear"),   # 8  shortcut_f32     f32
        f(16, "relu6"),                                 # 9  qconv, boundary  u8
        G.ShortcutSpec(index=8, activation="leaky"),    # 10 shortcut_f32 (u8 + f32)
        G.ConvSpec(filters=3 * 7, size=1, pad=0, activation="linear", batch_normalize=False,
                   quant_stop=True),                    # 11 head, boundary   f32
        G.YoloSpec(mask=(0, 1, 2), anchors=ANCHORS, classes=2),
    ), width=32, height=32)


NETS = {"mixed": mixed_net, "all_kinds": all_kinds_net}
KINDS = {
    "mixed": ["qconv", "maxpool", "fconv", "qconv", "qconv", "yolo"],
    "all_kinds": ["qconv", "fconv", "maxpool", "qconv", "qconv", "shortcut", "route_f32", "fconv",
                  "shortcut_f32", "qconv", "shortcut_f32", "qconv", "yolo"],
}


@pytest.fixture(scope="module")
def programs():
    out = {}
    for name, build in NETS.items():
        tnet, jnet = build(TG), build(JG)
        params = TG.init_params_numpy(2, tnet)
        x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, tnet.height, tnet.width, 3))
                             .astype(np.float32))
        qs = TG.quant_state_to_numpy(Q.calibrated_ranges(tnet, TG.params_to_torch(params, "cpu"), x))
        out[name] = (jconvert.convert(jnet, params, qs), convert(tnet, params, qs), x.numpy())
    return out


@pytest.mark.parametrize("name", list(NETS))
def test_mixed_engine_layers_match_jax(programs, name):
    jp, tp, x = programs[name]
    assert [c.kind for c in tp.cfg] == [c.kind for c in jp.cfg] == KINDS[name]
    jh, jo = jengine.build_forward(jp, return_outputs=True)(jax.device_put(jp.arrays), jnp.asarray(x))
    th, to = tengine.build_forward(tp, return_outputs=True, fuse_pool=False)(
        tengine.device_arrays(tp, "cpu"), torch.from_numpy(x))
    first_float = next(i for i, c in enumerate(tp.cfg) if c.kind in ("fconv", "route_f32", "shortcut_f32"))
    for i, (a, b) in enumerate(zip(jo, to)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, i
        if i < first_float:
            np.testing.assert_array_equal(b, a, err_msg=f"layer {i} ({tp.cfg[i].kind})")
        elif a.dtype == np.int8:
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1 and np.mean(d == 0) >= 0.999, (i, tp.cfg[i].kind, d.max(), np.mean(d == 0))
        else:
            Q.check_share(f"layer {i} ({tp.cfg[i].kind})", b, a, **Q.VALUE_TOL)
    for k, (a, b) in enumerate(zip(jh, th)):
        Q.check_share(f"head {k}", b, np.asarray(a), **Q.VALUE_TOL)


@pytest.mark.parametrize("name", list(NETS))
def test_mixed_engine_detections_match_jax(programs, name):
    jp, tp, x = programs[name]
    jh = jengine.build_forward(jp)(jax.device_put(jp.arrays), jnp.asarray(x))
    eng = tengine.Engine(tp, max_det=32, device="cpu")
    th = eng.raw_heads(x)
    jd = jdetect.top_k_detections(*jdetect.decode_all_heads(jh, jp.net), max_det=32)
    td = eng.predict(x)
    if all(np.array_equal(a, np.asarray(b)) for a, b in zip(th, jh)):
        for a, b in zip(jd, td):
            np.testing.assert_allclose(b, np.asarray(a), **DECODE_TOL)
    else:  # a code moved by one: the decoded heads within the value rule
        for a, b in zip(jdetect.decode_all_heads(jh, jp.net),
                        tdetect.decode_all_heads([torch.from_numpy(h) for h in th], tp.net)):
            Q.check_share("decoded", b.numpy(), np.asarray(a), **Q.VALUE_TOL)


def test_mixed_engine_tracks_the_qat_simulation(programs):
    """The float layers' engine stays within a few output steps of the
    fake-quant forward QAT optimized (tests/test_mixed_graphs.py's bound)."""
    from yolo_quantization_tpu_torch.infer.float_engine import QatSimEngine

    _, tp, x = programs["mixed"]
    params = TG.init_params_numpy(2, tp.net)
    qs = TG.quant_state_to_numpy(Q.calibrated_ranges(tp.net, TG.params_to_torch(params, "cpu"),
                                                     torch.from_numpy(x)))
    sim = QatSimEngine(tp.net, params, qs, device="cpu").raw_heads(x)
    got = tengine.Engine(tp, device="cpu").raw_heads(x)
    assert np.abs(sim[0] - got[0]).max() <= 3.5 * tp.cfg[4].out_scale


def test_cpu_mixed_engine_launches_no_kernel(programs):
    _, tp, x = programs["all_kinds"]
    before = cuda_qconv.launches, cuda_shortcut.launches
    tengine.Engine(tp, device="cpu").predict(x)
    assert (cuda_qconv.launches, cuda_shortcut.launches) == before


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_unfused_flagship_every_slot_equals_jax(dtype):
    """fuse_pool=False: each planned conv+pool runs as the conv kernel and
    the integer pool, and every slot holds its own layer's output, as the
    JAX engine's XLA path (use_pallas=False) gives them."""
    jp, tp = jpresets.flagship_program(size=64), tpresets.flagship_program(size=64)
    rng = np.random.default_rng(4)
    x = (rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32) if dtype == "float32"
         else rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    jh, jo = jengine.build_forward(jp, use_pallas=False, return_outputs=True)(
        jax.device_put(jp.arrays), jnp.asarray(x))
    eng = tengine.Engine(tp, device="cpu", fuse_pool=False)
    th, to = eng.raw_heads(x, return_outputs=True)
    assert len(to) == len(jo) == 24
    for i, (a, b) in enumerate(zip(jo, to)):
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=f"layer {i}")
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(b, np.asarray(a))
    # the fused layout's heads are the same
    for a, b in zip(tengine.Engine(tp, device="cpu").raw_heads(x), th):
        np.testing.assert_array_equal(a, b)


def test_unfused_narrow_v3_every_slot_equals_jax():
    jnet, tnet = narrow_v3(JG), narrow_v3(TG)
    params = TG.init_params_numpy(4, tnet)
    qs = tpresets.perturbed_quant_state(tpresets.synthetic_quant_state(tnet))
    jp, tp = jconvert.convert(jnet, params, qs), convert(tnet, params, qs)
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jh, jo = jengine.build_forward(jp, use_pallas=False, return_outputs=True)(
        jax.device_put(jp.arrays), jnp.asarray(x))
    th, to = tengine.build_forward(tp, return_outputs=True, fuse_pool=False)(
        tengine.device_arrays(tp, "cpu"), torch.from_numpy(x))
    for i, (a, b) in enumerate(zip(jo, to)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"layer {i}")
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.cuda
def test_cuda_mixed_and_unfused_engines_match_cpu(programs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the conv kernel has no CPU mode)")
    for name in NETS:
        _, tp, x = programs[name]
        hg, og = tengine.Engine(tp, device="cuda").raw_heads(x, return_outputs=True)
        hc, oc = tengine.Engine(tp, device="cpu").raw_heads(x, return_outputs=True)
        for i, (a, b) in enumerate(zip(og, oc)):
            if a.dtype == np.int8:
                d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert d.max() <= 1 and np.mean(d == 0) >= 0.999, (name, i)
            else:
                Q.check_share(f"{name} layer {i}", a, b, **Q.VALUE_TOL)
    tp = tpresets.flagship_program(size=64)
    x = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    before = cuda_qconv.launches
    hg, og = tengine.Engine(tp, device="cuda", fuse_pool=False).raw_heads(x, return_outputs=True)
    assert cuda_qconv.launches - before == 13
    hc, oc = tengine.Engine(tp, device="cpu", fuse_pool=False).raw_heads(x, return_outputs=True)
    for a, b in zip(og + hg, oc + hc):
        np.testing.assert_array_equal(a, b)
