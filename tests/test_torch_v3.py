"""yolov3 in the port equals yolov3 in the JAX package: the zoo builder, and
the integer engine on a narrow darknet53-shaped net at every layer
(stride-2 convs and integer shortcuts included) against the JAX package's
un-jitted ``build_forward``, bit for bit; decoded detections within float
tolerance.  Full-width yolov3 is in ``test_torch_v3_full.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_quantization_tpu.eval import detect as jdetect
from yolo_quantization_tpu.infer import convert as jconvert
from yolo_quantization_tpu.infer import engine as jengine
from yolo_quantization_tpu.models import zoo as jzoo
from yolo_quantization_tpu.nn import graph as jgraph
from yolo_quantization_tpu_torch.eval import detect as tdetect
from yolo_quantization_tpu_torch.infer import engine as tengine
from yolo_quantization_tpu_torch.infer.convert import convert
from yolo_quantization_tpu_torch.models import presets as tpresets
from yolo_quantization_tpu_torch.models import zoo as tzoo
from yolo_quantization_tpu_torch.nn import graph as tgraph
from yolo_quantization_tpu_torch.ops import cuda_qconv, cuda_shortcut

torch.set_num_threads(2)

SIZE = 64
# sigmoid/exp of bit-equal heads differ by ulps between XLA and PyTorch
DECODE_TOL = dict(rtol=1e-6, atol=1e-7)


def narrow_v3(G, classes=3, shortcut_act="linear", size=SIZE):
    """A darknet53-shaped net at widths 8-32, built from either package's
    graph module ``G``: a stem, three residual stages opened by stride-2
    convs, and yolov3's three-scale head with its routes and upsamples."""
    c = lambda f, k, stride=1: G.ConvSpec(  # noqa: E731
        filters=f, size=k, stride=stride, pad=1 if k == 3 else 0, activation="leaky")
    head = lambda: G.ConvSpec(  # noqa: E731
        filters=3 * (5 + classes), size=1, pad=0, activation="linear",
        batch_normalize=False, quant_stop=True)
    s = [c(8, 3)]                                        # 0: 64^2 x 8

    def stage(f, repeats):
        s.append(c(f, 3, stride=2))
        for _ in range(repeats):
            s.extend([c(f // 2, 1), c(f, 3)])
            s.append(G.ShortcutSpec(index=len(s) - 3, activation=shortcut_act))

    stage(16, 1)                                         # 1-4: 32^2 x 16
    stage(32, 2)                                         # 5-11: 16^2 x 32
    stage(32, 1)                                         # 12-15: 8^2 x 32
    yolo = lambda mask: G.YoloSpec(mask=mask, anchors=jzoo.COCO_V3_ANCHORS, classes=classes)  # noqa: E731
    s += [c(16, 1), head(), yolo((6, 7, 8))]             # 16-18
    s += [G.RouteSpec(layers=(16,)), c(8, 1), G.UpsampleSpec(2),
          G.RouteSpec(layers=(21, 11)), c(16, 3), head(), yolo((3, 4, 5))]   # 19-25
    s += [G.RouteSpec(layers=(23,)), c(8, 1), G.UpsampleSpec(2),
          G.RouteSpec(layers=(28, 4)), c(16, 3), head(), yolo((0, 1, 2))]    # 26-32
    return G.NetworkDef(specs=tuple(s), width=size, height=size)


def programs_pair(shortcut_act="linear", perturbed=False, symmetric=True, classes=3):
    """The narrow net converted by each package from the same seeded weights
    and (perturbed) synthetic ranges."""
    tnet = narrow_v3(tgraph, classes, shortcut_act)
    jnet = narrow_v3(jgraph, classes, shortcut_act)
    params = tgraph.init_params_numpy(4, tnet)
    qs = tpresets.synthetic_quant_state(tnet)
    if perturbed:
        qs = tpresets.perturbed_quant_state(qs)
    return (jconvert.convert(jnet, params, qs, symmetric_weights=symmetric),
            convert(tnet, params, qs, symmetric_weights=symmetric))


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    return {
        "float32": rng.uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32),
        "uint8": rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8),
    }


def run_both(jp, tp, x, **option):
    """(JAX heads, JAX layer outputs), (port heads, port layer outputs); the
    JAX engine un-jitted (jit rewrites its float arithmetic, see
    tests/test_torch_shortcut.py)."""
    jh, jo = jengine.build_forward(jp, return_outputs=True, **option)(
        jax.device_put(jp.arrays), jnp.asarray(x))
    th, to = tengine.build_forward(tp, return_outputs=True, **option)(
        tengine.device_arrays(tp, "cpu"), torch.from_numpy(x))
    return (jh, jo), (th, to)


def assert_layers_equal(tp, jout, tout):
    (jh, jo), (th, to) = jout, tout
    fused = tengine.fusion_plan(tp)
    assert len(jo) == len(to) == len(tp.cfg)
    for i, got in enumerate(to):
        # a fused conv emits its pooled output, the reference's layer i+1
        ref = np.asarray(jo[i + 1] if i in fused else jo[i])
        assert got.numpy().dtype == ref.dtype, i
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"layer {i} ({tp.cfg[i].kind})")
    assert len(jh) == len(th)
    for a, b in zip(jh, th):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_yolov3_specs_match_jax():
    jn, tn = jzoo.yolov3(classes=80, width=416, height=416), tzoo.yolov3(classes=80, width=416, height=416)
    assert tzoo.COCO_V3_ANCHORS == jzoo.COCO_V3_ANCHORS
    assert len(tn.specs) == 107
    assert [(type(s).__name__, dataclasses.asdict(s)) for s in tn.specs] == \
        [(type(s).__name__, dataclasses.asdict(s)) for s in jn.specs]
    assert (tn.width, tn.height, tn.channels) == (jn.width, jn.height, jn.channels)
    assert tn.shapes() == jn.shapes() and tn.output_domains() == jn.output_domains()
    assert [i for i, s in enumerate(tn.specs) if getattr(s, "stride", 1) == 2
            and isinstance(s, tgraph.ConvSpec)] == [1, 5, 12, 37, 62]
    assert sum(isinstance(s, tgraph.ShortcutSpec) for s in tn.specs) == 23


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("perturbed", [False, True])
def test_narrow_v3_every_layer_matches_jax(images, perturbed, symmetric, dtype):
    jp, tp = programs_pair(perturbed=perturbed, symmetric=symmetric)
    kinds = [c.kind for c in tp.cfg]
    assert kinds.count("shortcut") == 4 and [c.spec.stride for c in tp.cfg if c.kind == "qconv"].count(2) == 3
    if perturbed:  # the shortcuts' ratios are off 1: their rounding is exercised
        assert all(abs(c.in_scales[0][0] / c.out_scale - 1) > 1e-3 for c in tp.cfg if c.kind == "shortcut")
    assert_layers_equal(tp, *run_both(jp, tp, images[dtype]))


@pytest.mark.parametrize("option", [
    dict(dynamic_input=True), dict(exact_leaky=True), dict(carrier="int16"),
    dict(dynamic_input=True, exact_leaky=True),
])
def test_narrow_v3_options_match_jax(images, option):
    jp, tp = programs_pair(perturbed=True, symmetric=False)
    assert_layers_equal(tp, *run_both(jp, tp, images["uint8"], **option))


@pytest.mark.parametrize("shortcut_act", ["leaky", "relu", "relu6"])
def test_narrow_v3_shortcut_activations_match_jax(images, shortcut_act):
    jp, tp = programs_pair(shortcut_act=shortcut_act, perturbed=True)
    assert_layers_equal(tp, *run_both(jp, tp, images["float32"]))


def test_narrow_v3_detections_match_jax(images):
    jp, tp = programs_pair(perturbed=True)
    x = images["float32"]
    heads = jengine.build_forward(jp)(jax.device_put(jp.arrays), jnp.asarray(x))
    jdets = jdetect.top_k_detections(*jdetect.decode_all_heads(heads, jp.net), max_det=32)
    eng = tengine.Engine(tp, max_det=32, device="cpu")
    for a, b in zip(heads, eng.raw_heads(x)):
        np.testing.assert_array_equal(b, np.asarray(a))
    for a, b in zip(jdets, eng.predict(x)):
        np.testing.assert_allclose(b, np.asarray(a), **DECODE_TOL)
    jd = jdetect.decode_all_heads(heads, jp.net)
    td = tdetect.decode_all_heads([torch.from_numpy(np.asarray(h)) for h in heads], tp.net)
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **DECODE_TOL)


def test_cpu_v3_engine_launches_no_kernel(images):
    _, tp = programs_pair()
    before = cuda_qconv.launches, cuda_shortcut.launches
    tengine.Engine(tp, device="cpu").predict(images["float32"], flip=True)
    assert (cuda_qconv.launches, cuda_shortcut.launches) == before
