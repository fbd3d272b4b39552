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
    # the port's mode adds the data-parallel group, which JAX's step takes from its mesh
    return JG.ForwardMode(**{f: getattr(mode, f) for f in JG.ForwardMode.__dataclass_fields__})


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
    slice) and equal the JAX forward; a WordTree softmax too."""
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
    from yolo_quantization_tpu.core.tree import parse_tree as jparse
    from yolo_quantization_tpu_torch.core.tree import parse_tree

    lines = ["a -1", "b -1", "c 0", "d 0"]
    tree = TG.NetworkDef(specs=(TG.ConvSpec(4), TG.SoftmaxSpec(tree=parse_tree(lines))), width=8, height=8)
    heads, aux = TG.forward(tree, TG.params_to_torch(params_np, "cpu"), torch.from_numpy(x), TG.ForwardMode(),
                            return_outputs=True)
    want = JG.apply_simple_layer(JG.SoftmaxSpec(tree=jparse(lines)), None, jy0)
    np.testing.assert_allclose(aux["outputs"][1].numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


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


def test_fake_quant_safe_cotangent_holds_an_element_moved_across_the_range_edge():
    """A conv output that sits exactly on the nudged range's upper edge,
    moved above it by one ulp on the tested side: the straight-through gate
    closes there, which moves its pixel's input gradient and (learned mode)
    the max gradient, so the gradient rule fails on that element alone.
    With the cotangent zeroed where the two sides' gates differ, the same
    cotangent on both, the rule holds, and one element was excluded; more
    such elements than the rule's own 1 - SHARE raise."""
    net = TG.NetworkDef(specs=(TG.ConvSpec(filters=4, size=1, pad=0, activation="linear",
                                           batch_normalize=False),), width=32, height=32)
    params = TG.params_to_torch(TG.init_params_numpy(0, net), "cpu")
    with torch.no_grad():
        params[0]["w"][..., 0] = torch.tensor([1.0, 0.0, 0.0])  # channel 0 copies input channel 0
        params[0]["bias"].zero_()
    qs = {"act_0": {"min": torch.tensor(-1.3), "max": torch.tensor(0.9)}}
    qp = Q.nudge_min_max(qs["act_0"]["min"], qs["act_0"]["max"])
    edge = ((Q.QUANT_MAX - qp.zero_point).to(torch.float32) * qp.scale).item()
    above = float(np.nextafter(np.float32(edge), np.float32(np.inf)))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 32, 32, 3)).astype(np.float32))
    x[0, 1, 2, 0] = edge
    moved = x.clone()
    moved[0, 1, 2, 0] = above
    cot = torch.from_numpy(rng.standard_normal((1, 32, 32, 4)).astype(np.float32))
    mode = Q.MODES["learned"]

    def passes(c):
        return (Q.layer_pass(net, 0, params, moved, [], mode, qs, c, "cpu"),
                Q.layer_pass(net, 0, params, x, [], mode, qs, c, "cpu"))

    with pytest.raises(AssertionError, match="grad"):
        Q.check_pass(net, 0, mode, *passes(cot), qs)
    ref, test = (Q.fake_quant_inputs(net, 0, params, v, [], mode, qs, "cpu") for v in (x, moved))
    assert ref["act"][0][0, 1, 2, 0].item() == edge and test["act"][0][0, 1, 2, 0].item() > edge
    torch.testing.assert_close(ref["w"], test["w"], rtol=0, atol=0)
    assert Q.weight_code_flips(ref, test, mode.symmetric_w) == 0
    safe, share = Q.fake_quant_safe_cotangent(ref, test, cot)
    assert share == 1 / cot.numel() and safe[0, 1, 2, 0] == 0
    torch.testing.assert_close(safe[cot != safe], torch.zeros(1))
    shares = Q.check_pass(net, 0, mode, *passes(safe), qs)
    assert shares["grad"] == 1.0
    assert Q.fake_quant_inputs(net, 0, params, x, [], Q.MODES["float-train"], qs, "cpu") == \
        {"act": None, "w": None}
    many_x, many = x.clone(), x.clone()
    many_x[0, 5, :8, 0], many[0, 5, :8, 0] = edge, above
    ref, test = (Q.fake_quant_inputs(net, 0, params, v, [], mode, qs, "cpu") for v in (many_x, many))
    with pytest.raises(AssertionError, match="an ulp decides"):
        Q.fake_quant_safe_cotangent(ref, test, cot)


def test_weight_code_flipped_at_a_tie_is_held_to_it_and_moves_no_gradient():
    """A weight exactly at a rounding tie of its channel's grid, moved below
    it by one ulp on the tested side, takes the next code down: the input
    gradient through it then fails the rule.  ``weight_code_flips`` counts
    that code as one at a tie, and with the tested side's fake-quantized
    weights in the reference's pass every output and gradient holds, with
    nothing excluded.  A code one step off where no tie is, raises;
    differences of the scale by ulps are not flips."""
    net = TG.NetworkDef(specs=(TG.ConvSpec(filters=4, size=3, pad=1, activation="linear",
                                           batch_normalize=False),), width=8, height=8)
    params = TG.params_to_torch(TG.init_params_numpy(0, net), "cpu")
    scale = 2.0 ** -7
    with torch.no_grad():
        params[0]["w"][..., 2] = torch.clamp(params[0]["w"][..., 2], -60 * scale, 60 * scale)
        params[0]["w"][0, 0, 0, 2] = 127 * scale  # channel 2's grid step is exactly 2**-7
        params[0]["w"][1, 1, 1, 2] = 3.5 * scale  # a tie: rounds half to even, code 4
    moved = {0: {k: v.clone() for k, v in params[0].items()}}
    with torch.no_grad():
        moved[0]["w"][1, 1, 1, 2] = float(np.nextafter(np.float32(3.5 * scale), np.float32(0)))
    qs = {"act_0": {"min": torch.tensor(-50.0), "max": torch.tensor(50.0)}}
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    mode = Q.MODES["learned"]
    ref, test = (Q.fake_quant_inputs(net, 0, p, x, [], mode, qs, "cpu") for p in (params, moved))
    assert (ref["w"][1][1, 1, 1, 2].item(), test["w"][1][1, 1, 1, 2].item()) == (4 * scale, 3 * scale)
    assert Q.weight_code_flips(ref, test, mode.symmetric_w) == 1
    safe, share = Q.fake_quant_safe_cotangent(ref, test, cot)
    assert share == 0.0
    got = Q.layer_pass(net, 0, moved, x, [], mode, qs, safe, "cpu")
    with pytest.raises(AssertionError, match="layer 0"):
        Q.check_pass(net, 0, mode, got, Q.layer_pass(net, 0, params, x, [], mode, qs, safe, "cpu"), qs)
    want = Q.layer_pass(net, 0, params, x, [], mode, qs, safe, "cpu", weights=test["w"][1])
    assert Q.check_pass(net, 0, mode, got, want, qs) == {"value": 1.0, "grad": 1.0}
    step = Q.weight_step(ref["w"][0], mode.symmetric_w)
    off = ref["w"][1].clone()
    off[2, 2, 0, 1] += step[1]
    with pytest.raises(AssertionError, match="off a rounding tie"):
        Q.weight_code_flips(ref, {"act": None, "w": (ref["w"][0], off)}, mode.symmetric_w)
    ulps = {"act": None, "w": (ref["w"][0], ref["w"][1] * (1 + 2.0 ** -22))}
    assert Q.weight_code_flips(ref, ulps, mode.symmetric_w) == 0
