"""The port's QAT forward and backward against the JAX package's, on the CPU.

A whole QAT forward cannot be held element by element against another
implementation: an ulp in a conv output moves a fake-quant code by one step
now and then, and later layers carry it on (the JAX package's own jitted
and eager forwards disagree on most head elements in the QAT training
modes, and one ulp in the input moves many head elements of its jitted
forward; ``test_reference_itself_diverges_in_qat_training`` pins
that).  So
every layer runs in both packages (the JAX side jitted, as its training
runs) from the same inputs (the port's own forward's) and the same
cotangent (the gradient of the yolo loss with
respect to the layer's output in that forward, zero where the output sits
on an activation's kink), and each side's output, range update,
batch statistics and gradients are held to the rules of
``tools/qat_check.py``: values within rtol=1e-4, atol=1e-5 on at least
99.9% of elements and within one step of the layer's grid, ranges and batch
statistics within rtol=1e-5 (atol 1e-6 of the largest, for means that
cancel to near zero), gradients within rtol=1e-3 and atol=1e-5 (times the
tensor's largest magnitude where that exceeds 1) on 99.9%.  The float-train forward and the QAT-eval forward of a net without
batch statistics are also compared whole.  Nets: yolov3-tiny at 96x96, the
narrow darknet53 of ``test_torch_v3.py`` at 64x64 (stride 2 and shortcuts)
and ``mixed_net`` (float conv, float -> quant boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_v3 import narrow_v3
from yolo_quantization_tpu.core import quant as jq
from yolo_quantization_tpu.models import zoo as jzoo
from yolo_quantization_tpu.nn import graph as JG
from yolo_quantization_tpu.nn import layers as JL
from yolo_quantization_tpu.train.loss import total_loss as jtotal_loss
from yolo_quantization_tpu_torch.models import zoo as tzoo
from yolo_quantization_tpu_torch.nn import graph as TG
from yolo_quantization_tpu_torch.tools import qat_check as Q
from yolo_quantization_tpu_torch.train.loss import MAX_BOXES
from yolo_quantization_tpu_torch.train.loss import total_loss as ttotal_loss

torch.set_num_threads(2)

ANCHORS = ((10, 14), (23, 27), (37, 58))


def mixed_net(G):
    """tests/test_mixed_graphs.py's net: quant conv -> pool -> FLOAT conv ->
    quant conv (float -> quant boundary) -> head."""
    return G.NetworkDef(
        specs=(
            G.ConvSpec(filters=8, activation="relu6", quantized=True),
            G.MaxPoolSpec(2, 2),
            G.ConvSpec(filters=12, activation="leaky", quantized=False),
            G.ConvSpec(filters=16, activation="relu6", quantized=True),
            G.ConvSpec(filters=3 * 9, size=1, pad=0, activation="linear",
                       batch_normalize=False, quantized=True, quant_stop=True),
            G.YoloSpec(mask=(0, 1, 2), anchors=ANCHORS, classes=4),
        ),
        width=64, height=64,
    )


NETS = {
    "tiny": (lambda G: (jzoo if G is JG else tzoo).yolov3_tiny(classes=5, width=96, height=96), 96),
    "narrow_v3": (lambda G: narrow_v3(G), 64),
    "mixed": (mixed_net, 64),
}
# the narrow darknet53's cases are in test_torch_qat_v3.py (each file stays
# under 40 s on one worker)
HERE = ("tiny", "mixed")
MODES = ("float-train", "ema-qat-train", "qat-eval", "learned", "frozen")


def jax_mode(mode: TG.ForwardMode) -> JG.ForwardMode:
    return JG.ForwardMode(**{f: getattr(mode, f) for f in mode.__dataclass_fields__})


def jax_layer(net, i, p, x, outputs, mode, qs):
    """Layer i of the JAX package's forward (the body of its layer loop),
    from given inputs: (y, range updates, batch statistics)."""
    s = net.specs[i]
    key = f"act_{i}"
    upd, stats = {}, None

    def track(v, k):
        lo, hi = qs[k]["min"], qs[k]["max"]
        if mode.update_ranges:
            lo, hi = jq.ema_update(lo, hi, *JG._batch_range(v, mode.range_stat))
            upd[k] = {"min": lo, "max": hi}
        return JG._act_fq(mode)(v, lo, hi)

    if isinstance(s, JG.ConvSpec):
        if mode.qat and f"in_{i}" in qs:
            x = track(x, f"in_{i}")
        y, stats, new = JG._conv_forward(s, p, x, mode, qs.get(key) if qs else None)
        if qs is not None and key in qs and new is not qs[key]:
            upd[key] = new
    elif isinstance(s, JG.MaxPoolSpec):
        y = JL.maxpool(x, s.size, s.stride, s.padding)
    elif isinstance(s, JG.UpsampleSpec):
        y = JL.upsample_nearest(x, s.stride)
    elif isinstance(s, JG.RouteSpec):
        y = JL.route_concat([outputs[j] for j in s.layers])
        if mode.qat and key in qs:
            y = track(y, key)
    elif isinstance(s, JG.ShortcutSpec):
        y = JL.activate(JL.shortcut_add(x, outputs[s.index]), s.activation)
        if mode.qat and key in qs:
            y = track(y, key)
    else:
        y = x
    return y, upd, stats


def jax_layer_passes(jnet, tnet, params, x0, outputs, mode, qs, cots):
    """``qat_check.layer_pass``'s dict for every layer of the JAX package's
    forward, each from the given inputs: one jitted function runs all the
    layers side by side (no layer reads another's result) and their VJPs
    with the given cotangents."""
    jm = jax_mode(mode)
    n = len(tnet.specs)
    reads = [Q.layer_inputs(tnet, i) for i in range(n)]
    as_j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    trainable = [{k: as_j(v) for k, v in params.get(i, {}).items() if k in TG.TRAINABLE} for i in range(n)]
    fixed = [{k: as_j(v) for k, v in params.get(i, {}).items() if k not in TG.TRAINABLE} for i in range(n)]
    xs = [as_j(x0 if i == 0 else outputs[i - 1]) for i in range(n)]
    rd = [[as_j(outputs[j]) for j in reads[i]] for i in range(n)]
    qs_j = {k: {m: as_j(v) for m, v in st.items()} for k, st in qs.items()} if qs else None
    # a copy of the ranges per layer, so each layer's range gradients stay apart
    qs_diff = [qs_j if mode.learned_ranges else {} for _ in range(n)]

    def f(tr, xs, rd, qd):
        ys, aux = [], []
        for i in range(n):
            outs_all = [None] * i
            for j, o in zip(reads[i], rd[i]):
                outs_all[j] = o
            y, upd, stats = jax_layer(jnet, i, {**tr[i], **fixed[i]}, xs[i], outs_all, jm,
                                      qd[i] if mode.learned_ranges else qs_j)
            ys.append(y)
            aux.append({"upd": upd, "stats": stats})
        return ys, aux

    @jax.jit
    def run(tr, xs, rd, qd, cts):
        ys, vjp, aux = jax.vjp(f, tr, xs, rd, qd, has_aux=True)
        return ys, vjp(cts), aux

    ys, (g_tr, g_x, g_rd, g_qs), aux = run(trainable, xs, rd, qs_diff, [as_j(c) for c in cots])
    passes = []
    for i in range(n):
        grads = {f"p.{k}": np.asarray(v) for k, v in g_tr[i].items()}
        grads["x"] = np.asarray(g_x[i])
        grads.update({f"out{j}": np.asarray(g) for j, g in zip(reads[i], g_rd[i])})
        for k, st in (g_qs[i] or {}).items():
            for m, v in st.items():
                grads[f"{k}.{m}"] = np.asarray(v)
        ranges = {k: {m: np.asarray(v) for m, v in st.items()} for k, st in aux[i]["upd"].items()}
        stats = {} if aux[i]["stats"] is None else {i: tuple(np.asarray(t) for t in aux[i]["stats"])}
        passes.append({"y": np.asarray(ys[i]), "ranges": ranges, "bn_stats": stats, "grads": grads})
    return passes


def _truths(batch):
    t = np.zeros((batch, MAX_BOXES, 5), np.float32)
    t[:, 0] = (0.5, 0.5, 0.4, 0.4, 1.0)
    t[:, 1] = (0.3, 0.6, 0.15, 0.2, 2.0)
    t[:, 2] = (0.7, 0.3, 0.6, 0.5, 0.0)
    return t


def _setup(name, seed=0, batch=2):
    build, size = NETS[name]
    tnet, jnet = build(TG), build(JG)
    params = TG.params_to_torch(TG.init_params_numpy(seed, tnet), "cpu")
    x = torch.from_numpy(np.random.default_rng(seed + 1).uniform(0, 1, (batch, size, size, 3))
                         .astype(np.float32))
    return tnet, jnet, params, x


def calibrate(name):
    tnet, jnet, params, x = _setup(name)
    return tnet, jnet, params, x, Q.calibrated_ranges(tnet, params, x)


@pytest.fixture(scope="module")
def calibrated():
    """Per net: params, input and ranges calibrated by one EMA forward."""
    return {name: calibrate(name) for name in HERE}


def check_every_layer(tnet, jnet, params, x, qs, mode_name):
    """Every layer of both packages from the port's inputs and the loss's
    cotangents, held to qat_check's rules."""
    mode = Q.MODES[mode_name]
    qs_in = qs if mode.qat else None
    x0, outputs, cots = Q.reference_pass(tnet, params, x, mode, qs_in, "cpu",
                                         torch.from_numpy(_truths(x.shape[0])))
    cots = [Q.kink_safe_cotangent(tnet, i, y, c) for i, (y, c) in enumerate(zip(outputs, cots))]
    worst = {"value": 1.0, "grad": 1.0}
    checked = {"ranges": 0, "bn": 0, "grads": 0}
    refs = jax_layer_passes(jnet, tnet, params, x0, outputs, mode, qs_in, cots)
    for i, ref in enumerate(refs):
        x_in = x0 if i == 0 else outputs[i - 1]
        got = Q.layer_pass(tnet, i, params, x_in, outputs, mode, qs_in, cots[i], "cpu")
        # JAX differentiates every input, the port only those that reach the output
        ref["grads"] = {k: v for k, v in ref["grads"].items() if k in got["grads"] or np.any(v)}
        shares = Q.check_pass(tnet, i, mode, got, ref, qs_in)
        worst = {k: min(worst[k], shares[k]) for k in worst}
        checked["ranges"] += len(ref["ranges"])
        checked["bn"] += len(ref["bn_stats"])
        checked["grads"] += len(ref["grads"])
    if mode.update_ranges:
        assert checked["ranges"] > 0
    if mode.train:
        assert checked["bn"] > 0
    assert checked["grads"] > 0
    assert worst["value"] >= Q.SHARE and worst["grad"] >= Q.SHARE


@pytest.mark.parametrize("mode_name", MODES)
@pytest.mark.parametrize("net_name", HERE)
def test_every_layer_matches_jax(calibrated, net_name, mode_name):
    check_every_layer(*calibrated[net_name], mode_name)


def test_input_fake_quant_and_range_update_match_jax(calibrated):
    tnet, jnet, params, x, qs = calibrated["tiny"]
    for name in ("ema-qat-train", "qat-eval", "learned"):
        mode = Q.MODES[name]
        qt = dict(qs)
        got = TG.input_forward(x, mode, qt)
        jm = jax_mode(mode)
        lo, hi = jnp.asarray(qs["input"]["min"].numpy()), jnp.asarray(qs["input"]["max"].numpy())
        xj = jnp.asarray(x.numpy())
        if jm.update_ranges:
            lo, hi = jq.ema_update(lo, hi, jnp.min(xj), jnp.max(xj))
            np.testing.assert_array_equal(qt["input"]["max"].numpy(), np.asarray(hi))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(JG._act_fq(jm)(xj, lo, hi)))


def _whole(net_name, mode_name, qs_fresh=False):
    tnet, jnet, params, x = _setup(net_name)
    mode = Q.MODES[mode_name]
    qs_np = TG.init_quant_state(tnet)
    pn = TG.params_to_numpy(params)
    jh, jaux = jax.jit(lambda p, x: JG.forward(jnet, p, x, jax_mode(mode), qs_np if mode.qat else None))(
        jax.tree.map(jnp.asarray, pn), jnp.asarray(x.numpy()))
    th, taux = TG.forward(tnet, params, x, mode, TG.quant_state_to_torch(qs_np, "cpu") if mode.qat else None)
    return (jh, jaux), (th, taux)


def check_whole_float_train(net_name):
    """No fake-quant grid to flip: the heads within the value rule and the
    loss within rtol=1e-4.  (Batch statistics are held per layer: through a
    whole forward the summation differences of earlier layers add up.)"""
    (jh, jaux), (th, taux) = _whole(net_name, "float-train")
    assert jaux["bn_stats"].keys() == taux["bn_stats"].keys()
    for k, (a, b) in enumerate(zip(jh, th)):
        Q.check_share(f"head {k}", b, np.asarray(a), **Q.VALUE_TOL)
    tnet = NETS[net_name][0](TG)
    jnet = NETS[net_name][0](JG)
    truths = _truths(th[0].shape[0])
    jl = float(jtotal_loss(jh, jnp.asarray(truths), jnet)[0])
    tl = float(ttotal_loss(th, torch.from_numpy(truths), tnet)[0])
    assert tl == pytest.approx(jl, rel=1e-4)


@pytest.mark.parametrize("net_name", HERE)
def test_whole_float_train_forward_matches_jax(net_name):
    check_whole_float_train(net_name)


def test_reference_itself_diverges_in_qat_training():
    """Why the QAT training modes are compared layer by layer: in the JAX
    package's own jitted EMA-QAT-train forward of yolov3-tiny, moving every
    input value by one ulp moves more than 0.1% of the head elements beyond
    the value rule (fake-quant codes flip, and later layers
    and the batch statistics carry the flips on)."""
    net = jzoo.yolov3_tiny(classes=5, width=96, height=96)
    p = jax.tree.map(jnp.asarray, JG.init_params_numpy(0, net))
    x = np.random.default_rng(1).uniform(0.25, 0.75, (2, 96, 96, 3)).astype(np.float32)
    x2 = np.nextafter(x, np.float32(1.0))
    mode = JG.ForwardMode(train=True, qat=True, update_ranges=True)
    qs = JG.init_quant_state(net)
    fwd = jax.jit(lambda p, x: JG.forward(net, p, x, mode, qs)[0])
    a_heads, b_heads = fwd(p, jnp.asarray(x)), fwd(p, jnp.asarray(x2))
    with pytest.raises(AssertionError, match="of elements within"):
        for k, (a, b) in enumerate(zip(a_heads, b_heads)):
            Q.check_share(f"head {k}", np.asarray(b), np.asarray(a), **Q.VALUE_TOL)


def test_bf16_forward_tracks_jax_bf16():
    """bf16 conv operands: the port's loss within the JAX package's own
    bf16 tolerance (rel 0.02, tests/test_train.py) of JAX's bf16 loss and
    of its own float32 loss; outputs stay float32."""
    tnet, jnet, params, x = _setup("tiny")
    qs = Q.calibrated_ranges(tnet, params, x)
    truths = np.zeros((2, MAX_BOXES, 5), np.float32)
    truths[:, 0] = (0.5, 0.5, 0.4, 0.4, 0.0)
    losses = {}
    for dt in ("float32", "bfloat16"):
        mode = TG.ForwardMode(train=True, qat=True, update_ranges=True, compute_dtype=dt)
        th, _ = TG.forward(tnet, params, x, mode, qs)
        assert all(h.dtype == torch.float32 for h in th)
        losses[dt] = float(ttotal_loss(th, torch.from_numpy(truths), tnet)[0])
    qs_np = TG.quant_state_to_numpy(qs)
    jmode = JG.ForwardMode(train=True, qat=True, update_ranges=True, compute_dtype="bfloat16")
    jh, _ = jax.jit(lambda p, x: JG.forward(jnet, p, x, jmode, qs_np))(
        jax.tree.map(jnp.asarray, TG.params_to_numpy(params)), jnp.asarray(x.numpy()))
    jl = float(jtotal_loss(jh, jnp.asarray(truths), jnet)[0])
    assert np.isfinite(losses["bfloat16"])
    assert losses["bfloat16"] == pytest.approx(jl, rel=0.02)
    assert losses["bfloat16"] == pytest.approx(losses["float32"], rel=0.02)


def test_simple_layers_raise_naming_the_roadmap():
    """The extended float layers run in the forward (the yolov2/yolov1
    slice) and equal the JAX forward; a WordTree softmax raises naming the
    queue item of ``core/tree.py``."""
    net = TG.NetworkDef(specs=(TG.ConvSpec(4), TG.AvgPoolSpec()), width=8, height=8)
    jnet = JG.NetworkDef(specs=(JG.ConvSpec(4), JG.AvgPoolSpec()), width=8, height=8)
    params_np = TG.init_params_numpy(0, net)
    x = np.random.default_rng(0).uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    _, aux = TG.forward(net, TG.params_to_torch(params_np, "cpu"), torch.from_numpy(x), TG.ForwardMode(),
                        return_outputs=True)
    jp = jax.tree.map(jnp.asarray, params_np)
    jy0 = JG._conv_forward(jnet.specs[0], jp[0], jnp.asarray(x), JG.ForwardMode(), None)[0]
    jy1 = JG.apply_simple_layer(jnet.specs[1], None, jy0)
    for got, want in zip(aux["outputs"], (jy0, jy1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    tree = TG.NetworkDef(specs=(TG.ConvSpec(4), TG.SoftmaxSpec(tree="t")), width=8, height=8)
    with pytest.raises(NotImplementedError, match="queue 1.12"):
        TG.forward(tree, TG.params_to_torch(TG.init_params_numpy(0, tree), "cpu"),
                   torch.zeros(1, 8, 8, 3), TG.ForwardMode())


def test_qat_forward_requires_quant_state():
    net = tzoo.yolov3_tiny(classes=2, width=32, height=32)
    params = TG.params_to_torch(TG.init_params_numpy(0, net), "cpu")
    with pytest.raises(ValueError, match="quant_state"):
        TG.forward(net, params, torch.zeros(1, 32, 32, 3), TG.ForwardMode(qat=True))


def test_params_and_ranges_round_trip_numpy():
    net = tzoo.yolov3_tiny(classes=2, width=32, height=32)
    pn = TG.init_params_numpy(0, net)
    pt = TG.params_to_torch(pn, "cpu", requires_grad=True)
    assert pt[0]["w"].requires_grad and not pt[0]["mean"].requires_grad
    back = TG.params_to_numpy(pt)
    for i in pn:
        for k in pn[i]:
            np.testing.assert_array_equal(back[i][k], pn[i][k])
    qs = TG.init_quant_state(net, (0.0, 1.0))
    assert TG.quant_state_to_numpy(TG.quant_state_to_torch(qs, "cpu")) == qs
