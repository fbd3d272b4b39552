"""The region and detection losses and the yolov2-tiny / yolov1-tiny train
steps against the JAX package on the CPU: ``region_head_loss`` with ``seen``
below and above 12,800, rescore on and off and two truths in one cell,
``encode_detection_truth`` bit for bit and ``detection_head_loss`` (sqrt,
rescore, forced, random, the four scales): losses within rtol 1e-5 and
gradients within rtol 1e-4 of the un-jitted JAX value and gradient; the
random predictor's draw bit-equal to the reference's PRNG; one float step
of each model within rtol 1e-4 of the un-jitted JAX step.  (Split from
``test_torch_v2.py`` so each file stays near a minute on one worker.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _assert_states_match, _run_steps, make_truths
from yolo_quantization_tpu.models import zoo as jzoo
from yolo_quantization_tpu.nn import graph as JG
from yolo_quantization_tpu.train import loss as jloss
from yolo_quantization_tpu_torch.models import presets as tpresets
from yolo_quantization_tpu_torch.models import zoo as tzoo
from yolo_quantization_tpu_torch.nn import graph as TG
from yolo_quantization_tpu_torch.train import loss as tloss

torch.set_num_threads(2)


# two truths in one cell: (0.51, 0.52) and (0.53, 0.50) share cell (1, 1) of
# a 3x3 grid and, with these sizes, its best anchor
REGION_TRUTHS = [(0.51, 0.52, 0.30, 0.28, 1.0), (0.53, 0.50, 0.31, 0.30, 3.0),
                 (0.15, 0.80, 0.10, 0.12, 0.0), (0.85, 0.20, 0.60, 0.50, 2.0)]


@pytest.mark.parametrize("seen", [12000, 13000])
@pytest.mark.parametrize("rescore", [True, False])
def test_region_loss_and_gradient_match_jax(seen, rescore):
    rng = np.random.default_rng(10 + seen % 7)
    anchors = ((0.9, 1.1), (2.0, 1.6), (3.1, 3.3))
    spec_kw = dict(anchors=anchors, classes=4, num=3, softmax=True)
    raw = rng.standard_normal((2, 3, 3, 3 * 9)).astype(np.float32)
    truths = make_truths(2, REGION_TRUTHS)
    kw = dict(ignore_thresh=0.5, object_scale=5.0, noobject_scale=1.0, class_scale=1.0,
              coord_scale=1.0, rescore=rescore)

    def jf(r):
        out = JG.apply_simple_layer(JG.RegionSpec(**spec_kw), None, r)
        return jloss.region_head_loss.__wrapped__(out, jnp.asarray(truths), anchors, 4, seen=seen, **kw)

    (jl, jst), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(raw))
    rt = torch.tensor(raw, requires_grad=True)
    out = TG.apply_simple_layer(TG.RegionSpec(**spec_kw), None, rt)
    tl, tst = tloss.region_head_loss(out, torch.from_numpy(truths), anchors, 4, seen=seen, **kw)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert int(tst["obj_count"]) == int(jst["obj_count"]) < 8  # two of the 8 truths share a slot
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("opts", [
    dict(sqrt=True, rescore=True),
    dict(sqrt=False, rescore=False, forced=True),
    dict(sqrt=True, rescore=True, random=True, seen=640),
    dict(sqrt=True, random=True, seen=64000),
], ids=["sqrt-rescore", "forced", "random", "random-after"])
def test_detection_truth_and_loss_match_jax(opts):
    rng = np.random.default_rng(12)
    side, classes, num = 3, 3, 2
    scales = dict(object_scale=1.5, noobject_scale=0.5, class_scale=1.2, coord_scale=5.0)
    truths = make_truths(2, [(0.1, 0.1, 0.3, 0.4, 1.0), (0.12, 0.15, 0.2, 0.2, 2.0),  # one cell
                             (0.7, 0.5, 0.004, 0.3, 0.0), (0.5, 0.9, 0.5, 0.15, 2.0)])
    tg = tloss.encode_detection_truth(torch.from_numpy(truths), side, classes)
    jg = jloss.encode_detection_truth.__wrapped__(jnp.asarray(truths), side, classes)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    out = rng.uniform(-0.3, 1.0, (2, side * side * (classes + num * 5))).astype(np.float32)
    kw = dict(**opts, **scales)

    def jf(o):
        return jloss.detection_head_loss.__wrapped__(o, jg, classes, num, side, **kw)

    (jl, _), jgrad = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(out))
    ot = torch.tensor(out, requires_grad=True)
    tl, _ = tloss.detection_head_loss(ot, tg, classes, num, side, **kw)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    np.testing.assert_allclose(ot.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-6)


def test_reference_randint_is_bit_equal():
    for seen, shape, num in ((0, (2, 9), 2), (640, (4, 49), 2), (63999, (3, 5), 3), (12345, (7,), 5)):
        want = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(17), jnp.int32(seen)),
                                  shape, 0, num)
        np.testing.assert_array_equal(tloss._reference_randint(seen, shape, num), np.asarray(want))


@pytest.mark.parametrize("name", ["yolov2_tiny", "yolov1_tiny"])
def test_train_step_matches_jax(name):
    """One float-phase step against the un-jitted JAX step (whose eager
    dispatch compiles each of its several hundred ops, 20-30 s a model):
    yolov2-tiny at 64x64 with the anchor-prior warm-up on, yolov1-tiny at
    192x192 (side 3) with the steps policy; the loss within rtol 1e-4, the
    updated params and BN statistics within the train tests' rule.  SGD: Adam's
    g/sqrt(v) turns the float32 summation noise of a near-zero gradient
    into a full-size step (4 of yolov1-tiny's 1.2 M conv weights)."""
    kw = dict(classes=3, width=64, height=64) if name == "yolov2_tiny" else \
        dict(classes=3, side=3, width=192, height=192)
    tnet, jnet = getattr(tzoo, name)(**kw), getattr(jzoo, name)(**kw)
    params = TG.init_params_numpy(4, tnet)
    rng = np.random.default_rng(13)
    images = rng.uniform(0, 1, (2, tnet.height, tnet.width, 3)).astype(np.float32)
    truths = make_truths(2, [(0.3, 0.35, 0.3, 0.4, 1.0), (0.7, 0.6, 0.5, 0.45, 2.0)])
    qs = tpresets.v2_quant_state(tnet)
    cfg = dict(policy="steps", lr_steps=(1,), lr_scales=(0.1,)) if name == "yolov1_tiny" else {}
    jstate, tstate, metrics = _run_steps(tnet, jnet, params, qs, images, truths, "float", steps=1, **cfg)
    _assert_states_match(jstate, tstate, metrics)
