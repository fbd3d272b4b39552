"""WordTree (``core/tree.py``) through the port against the JAX package on
the CPU, mirroring ``tests/test_tree_v1.py``: parsing (groups, children,
leaves, depth), ``change_leaves``, the grouped softmax and its gradient,
``hierarchy_predictions``, the greedy decode, the hierarchical cross
entropy; the tree softmax layer, the region head's tree softmax in every
forward mode, its decode (joint path probabilities) and ``tree_top_probs``,
the tree region loss and its gradient; a ``tree=`` cfg; and a WordTree
region detector through the integer engine, every layer against the
un-jitted JAX engine.  Tolerances: the grouped softmax and its gradient
within rtol 1e-5 / 1e-4 (XLA's and torch's exp differ by ulps, and the
segment sums add in other orders), joint probabilities and decodes within
rtol 1e-5, the loss within rtol 1e-5 and its gradient within rtol 1e-4,
integer codes bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import make_truths
from yolo_quantization_tpu.core import tree as jtree
from yolo_quantization_tpu.eval import detect as jdetect
from yolo_quantization_tpu.infer import convert as jconvert
from yolo_quantization_tpu.infer import engine as jengine
from yolo_quantization_tpu.models import cfg as jcfg
from yolo_quantization_tpu.nn import graph as JG
from yolo_quantization_tpu.train import loss as jloss
from yolo_quantization_tpu_torch.core import tree as ttree
from yolo_quantization_tpu_torch.eval import detect as tdetect
from yolo_quantization_tpu_torch.infer import engine as tengine
from yolo_quantization_tpu_torch.infer.convert import convert
from yolo_quantization_tpu_torch.models import cfg as tcfg
from yolo_quantization_tpu_torch.models import presets as tpresets
from yolo_quantization_tpu_torch.nn import graph as TG
from yolo_quantization_tpu_torch.train import loss as tloss

torch.set_num_threads(2)

SOFTMAX_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
DECODE_TOL = dict(rtol=1e-5, atol=1e-7)

# test_tree_v1.py's tree: animal, vehicle, plant; animal -> {dog, cat};
# dog -> {poodle, husky}; vehicle -> {car}
TREE_LINES = ["animal -1", "vehicle -1", "plant -1", "dog 0", "cat 0", "car 1", "poodle 3", "husky 3"]
# a seeded tree with groups of 1 to 8 siblings, four levels deep
BIG_LINES = tpresets.synthetic_tree_lines(nodes=300, max_depth=4, seed=3)


def trees(lines):
    return jtree.parse_tree(lines), ttree.parse_tree(lines)


@pytest.mark.parametrize("lines", [TREE_LINES, BIG_LINES], ids=["small", "seeded"])
def test_parse_matches_jax(lines):
    jt, tt = trees(lines)
    assert (tt.n, tt.groups, tt.max_depth, tt.names) == (jt.n, jt.groups, jt.max_depth, jt.names)
    for name in ("parent", "group", "group_offset", "group_size", "child", "leaf", "depth"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name), err_msg=name)
    np.testing.assert_array_equal(tt.path_matrix, jt.path_matrix)
    np.testing.assert_array_equal(tt.sibling_matrix, jt.sibling_matrix)
    assert repr(tt) == repr(jt)


def test_change_leaves_and_the_small_tree():
    _, tt = trees(TREE_LINES)
    np.testing.assert_array_equal(tt.group, [0, 0, 0, 1, 1, 2, 3, 3])
    np.testing.assert_array_equal(tt.child, [1, 2, -1, 3, -1, -1, -1, -1])
    t2 = tt.change_leaves(["dog", "plant"])
    np.testing.assert_array_equal(t2.leaf, [False, False, True, True, False, False, False, False])
    assert t2 != tt and hash(t2) != hash(tt) and tt == ttree.parse_tree(TREE_LINES)
    with pytest.raises(ValueError, match="parents before children"):
        ttree.HierarchyTree(np.array([1, -1]))


@pytest.mark.parametrize("lines,temperature", [(TREE_LINES, 1.0), (BIG_LINES, 1.0), (BIG_LINES, 0.7)],
                         ids=["small", "seeded", "seeded-temperature"])
def test_softmax_tree_and_gradient_match_jax(lines, temperature):
    jt, tt = trees(lines)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, tt.n)) * 3).astype(np.float32)
    w = rng.standard_normal((2, 5, tt.n)).astype(np.float32)
    jy, jvjp = jax.vjp(lambda v: jtree.softmax_tree(v, jt, temperature), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = ttree.softmax_tree(xt, tt, temperature)
    y.backward(torch.from_numpy(w))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **SOFTMAX_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jvjp(jnp.asarray(w))[0]), **GRAD_TOL)
    for g in range(tt.groups):  # each group sums to 1
        o, s = tt.group_offset[g], tt.group_size[g]
        np.testing.assert_allclose(y.detach().numpy()[..., o:o + s].sum(-1), 1.0, rtol=1e-5)


def test_softmax_tree_backward_adds_through_no_scatter():
    """The gradient's graph holds gathers only (``_Take``), no index_add or
    scatter, whose atomics add in no fixed order on the card."""
    _, tt = trees(BIG_LINES)
    x = torch.randn(3, tt.n, generator=torch.Generator().manual_seed(0), requires_grad=True)
    y = ttree.softmax_tree(x, tt)
    names, todo, seen = set(), [y.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    assert not any("Index" in n or "Scatter" in n for n in names), names
    assert "_TakeBackward" in names


@pytest.mark.parametrize("only_leaves", [False, True])
def test_hierarchy_predictions_match_jax(only_leaves):
    jt, tt = trees(BIG_LINES)
    p = np.random.default_rng(1).uniform(0.05, 1.0, (3, 4, tt.n)).astype(np.float32)
    got = ttree.hierarchy_predictions(torch.from_numpy(p), tt, only_leaves).numpy()
    np.testing.assert_allclose(got, np.asarray(jtree.hierarchy_predictions(jnp.asarray(p), jt, only_leaves)),
                               rtol=1e-6)


def test_host_decode_matches_jax():
    for lines in (TREE_LINES, BIG_LINES):
        jt, tt = trees(lines)
        rng = np.random.default_rng(2)
        for _ in range(30):
            p = rng.uniform(0, 1, (tt.n,)).astype(np.float32)
            for thresh in (0.1, 0.4, 0.9):
                assert ttree.hierarchy_top_prediction(p, tt, thresh) == \
                    jtree.hierarchy_top_prediction(p, jt, thresh)
            c = int(rng.integers(0, tt.n))
            assert ttree.get_hierarchy_probability(p, tt, c) == jtree.get_hierarchy_probability(p, jt, c)


def test_hierarchy_cross_entropy_and_gradient_match_jax():
    jt, tt = trees(BIG_LINES)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((6, tt.n)).astype(np.float32)
    labels = np.nonzero(tt.leaf)[0][rng.integers(0, tt.leaf.sum(), 6)]
    jl, jg = jax.value_and_grad(lambda v: jnp.mean(jtree.hierarchy_cross_entropy(v, jnp.asarray(labels), jt)))(
        jnp.asarray(z))
    zt = torch.tensor(z, requires_grad=True)
    tl = torch.mean(ttree.hierarchy_cross_entropy(zt, torch.from_numpy(labels), tt))
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jg), **GRAD_TOL)


def region_specs(tt, jt, num=2):
    kw = dict(anchors=((1.0, 1.0), (2.0, 2.0), (3.0, 1.5))[:num], classes=tt.n, num=num, softmax=False)
    return TG.RegionSpec(tree=tt, **kw), JG.RegionSpec(tree=jt, **kw)


def test_tree_layers_forward_decode_and_top_probs_match_jax():
    """The tree softmax layer (with temperature) and the region head's tree
    softmax, its decode to joint path probabilities and ``tree_top_probs``
    (each detection's node and objectness)."""
    jt, tt = trees(BIG_LINES)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, 1, tt.n)).astype(np.float32)
    for ts, js in ((TG.SoftmaxSpec(tree=tt, temperature=0.5), JG.SoftmaxSpec(tree=jt, temperature=0.5)),):
        np.testing.assert_allclose(TG.apply_simple_layer(ts, None, torch.from_numpy(x)).numpy(),
                                   np.asarray(JG.apply_simple_layer(js, None, jnp.asarray(x))), **SOFTMAX_TOL)
    ts, js = region_specs(tt, jt)
    r = rng.standard_normal((2, 3, 3, 2 * (5 + tt.n))).astype(np.float32)
    tout = TG.apply_simple_layer(ts, None, torch.from_numpy(r))
    jout = JG.apply_simple_layer(js, None, jnp.asarray(r))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **SOFTMAX_TOL)
    tdec = tdetect.decode_region_head(tout, ts)
    jdec = jdetect.decode_region_head(jout, js)
    for a, b in zip(jdec, tdec):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **DECODE_TOL)
    cls, obj = tdec[2][0].numpy(), tdec[1][0].numpy()
    for thresh in (0.0, 0.5):
        got = tdetect.tree_top_probs(cls, obj, tt, thresh)
        want = jdetect.tree_top_probs(cls, obj, jt, thresh)
        np.testing.assert_array_equal(got, want)
        assert ((got > 0).sum(-1) <= 1).all()
    assert (tdetect.tree_top_probs(cls, obj, tt, 0.0) > 0).sum() == obj.shape[0]


@pytest.mark.parametrize("mode", ["float-train", "qat-train", "eval"])
def test_region_tree_head_in_every_forward_mode(mode):
    """A conv into a tree region head through ``forward``: the head's
    output equals the JAX forward's on the same conv output."""
    jt, tt = trees(TREE_LINES)
    ts, js = region_specs(tt, jt, num=1)
    net = TG.NetworkDef(specs=(TG.ConvSpec(filters=5 + tt.n, size=1, pad=0, activation="linear",
                                           batch_normalize=False, quant_stop=True), ts), width=8, height=8)
    m = {"float-train": TG.ForwardMode(train=True), "qat-train": TG.ForwardMode(train=True, qat=True,
                                                                                update_ranges=True),
         "eval": TG.ForwardMode()}[mode]
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (2, 8, 8, 3)).astype(np.float32))
    params = TG.params_to_torch(TG.init_params_numpy(0, net), "cpu")
    qs = TG.quant_state_to_torch(TG.init_quant_state(net), "cpu")
    heads, aux = TG.forward(net, params, x, m, qs, return_outputs=True)
    conv_out = aux["outputs"][0].detach().numpy()
    np.testing.assert_allclose(heads[0].detach().numpy(),
                               np.asarray(JG.apply_simple_layer(js, None, jnp.asarray(conv_out))),
                               **SOFTMAX_TOL)


# two truths of one image share a slot (the later one's rows stay); two
# truths carry ancestors' labels (a group's parent node as the class)
TREE_TRUTHS = [(0.41, 0.42, 0.20, 0.20, 6.0), (0.43, 0.40, 0.21, 0.19, 7.0),
               (0.80, 0.20, 0.30, 0.35, 3.0), (0.15, 0.85, 0.60, 0.50, 5.0)]


@pytest.mark.parametrize("seen", [None, 13000])
def test_region_tree_loss_and_gradient_match_jax(seen):
    """``region_head_loss(tree=...)`` through ``total_loss`` and directly:
    the hierarchical targets and mask, the loss and its gradient."""
    jt, tt = trees(TREE_LINES)
    ts, js = region_specs(tt, jt)
    rng = np.random.default_rng(6)
    raw = rng.standard_normal((2, 4, 4, 2 * (5 + tt.n))).astype(np.float32)
    truths = make_truths(2, TREE_TRUTHS)

    def jf(r):
        out = JG.apply_simple_layer(js, None, r)
        return jloss.region_head_loss.__wrapped__(out, jnp.asarray(truths), js.anchors, tt.n, tree=jt,
                                                  seen=seen)

    (jl, jst), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(raw))
    rt = torch.tensor(raw, requires_grad=True)
    out = TG.apply_simple_layer(ts, None, rt)
    tl, tst = tloss.region_head_loss(out, torch.from_numpy(truths), ts.anchors, tt.n, tree=tt, seen=seen)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert int(tst["obj_count"]) == int(jst["obj_count"])
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(jg), **GRAD_TOL)
    # the class gradient touches only the truths' path groups
    cls_g = rt.grad.numpy().reshape(2, 4, 4, 2, 5 + tt.n)[..., 5:]
    touched = set(np.nonzero(np.abs(cls_g).sum((0, 1, 2, 3)))[0])
    assert touched <= set(np.nonzero(tt.sibling_matrix[[6, 7, 3, 5]].any(0))[0])
    tnet = TG.NetworkDef(specs=(ts,), width=128, height=128)
    total, _ = tloss.total_loss([out.detach()], torch.from_numpy(truths), tnet, seen=seen)
    assert float(total) == pytest.approx(float(jl) / 2, rel=1e-5)


def test_tree_cfg_option_matches_jax(tmp_path):
    """``tree=`` in a [region] and a [softmax] section, relative to the
    cfg's directory, as the JAX importer reads it."""
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "t.tree").write_text("\n".join(TREE_LINES) + "\n")
    text = ("[net]\nwidth=64\nheight=64\n[convolutional]\nfilters=26\nsize=1\nactivation=linear\n"
            "[region]\nanchors=1,1,2,2\nclasses=8\nnum=2\ntree=data/t.tree\n"
            "[softmax]\ntree=data/t.tree\n")
    tnet, _ = tcfg.parse_cfg(text, base_dir=str(tmp_path))
    jnet, _ = jcfg.parse_cfg(text, base_dir=str(tmp_path))
    for ts, js in zip(tnet.specs[1:], jnet.specs[1:]):
        assert ts.tree == ttree.parse_tree(TREE_LINES)
        np.testing.assert_array_equal(ts.tree.parent, js.tree.parent)
        assert ts.tree.names == js.tree.names


def test_wordtree_detector_through_the_integer_engine_matches_jax():
    """yolov2-tiny's topology at 64x64 with a region head over the seeded
    300-node tree (5 x 305 channels in the last conv): every layer of the
    unfused engine equals the un-jitted JAX engine's (codes bit for bit, the
    tree softmax within the softmax tolerance), the fused engine's
    detections within the decode tolerance."""
    jt, tt = trees(BIG_LINES)
    size = 64
    tnet = TG.NetworkDef(tuple(TG.RegionSpec(**{**s.__dict__, "classes": tt.n, "tree": tt})
                               if isinstance(s, TG.RegionSpec) else
                               (TG.ConvSpec(**{**s.__dict__, "filters": 5 * (5 + tt.n)}) if i == 14 else s)
                               for i, s in enumerate(tpresets.zoo.yolov2_tiny(width=size, height=size).specs)),
                         width=size, height=size)
    jnet = JG.NetworkDef(tuple(JG.RegionSpec(**{**s.__dict__, "tree": jt}) if isinstance(s, TG.RegionSpec)
                               else getattr(JG, type(s).__name__)(**s.__dict__) for s in tnet.specs),
                         width=size, height=size)
    params, qs = TG.init_params_numpy(0, tnet), tpresets.v2_quant_state(tnet)
    tp, jp = convert(tnet, params, qs), jconvert.convert(jnet, params, qs)
    x = np.random.default_rng(8).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    jheads, jouts = jengine.build_forward(jp, return_outputs=True)(jax.device_put(jp.arrays), jnp.asarray(x))
    heads, outs = tengine.Engine(tp, max_det=32, device="cpu", fuse_pool=False).raw_heads(
        x, return_outputs=True)
    for i, (a, b) in enumerate(zip(jouts, outs)):
        if isinstance(tnet.specs[i], TG.RegionSpec):
            np.testing.assert_allclose(b, np.asarray(a), **SOFTMAX_TOL, err_msg=f"layer {i}")
        else:
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=f"layer {i}")
    jdets = jdetect.top_k_detections(*jdetect.decode_all_heads(jheads, jp.net), max_det=32)
    for a, b in zip(jdets, tengine.Engine(tp, max_det=32, device="cpu").predict(x)):
        np.testing.assert_allclose(b, np.asarray(a), **DECODE_TOL)


def test_tables_an_engine_cached_serve_a_training_step():
    """Index tables cached across calls (the grouped softmax's packing, the
    tree's ancestor table, reorg's permutation) are made outside
    ``inference_mode`` even when an engine's forward makes them first, so a
    later training step can save them for backward."""
    from yolo_quantization_tpu_torch.nn import layers as TL

    tt = ttree.parse_tree(["p -1", "q -1", "r 1", "s 1", "t 1"])  # a tree no other test caches
    with torch.inference_mode():
        ttree.softmax_tree(torch.zeros(2, tt.n), tt)
        ttree.path_rows(tt, torch.zeros(2, dtype=torch.int64))
        TL.reorg(torch.zeros(1, 6, 10, 12), 2)
    x = torch.randn(2, tt.n, generator=torch.Generator().manual_seed(1), requires_grad=True)
    (ttree.softmax_tree(x, tt) * ttree.path_rows(tt, torch.tensor([2, 4]))).sum().backward()
    y = torch.randn(1, 6, 10, 12, generator=torch.Generator().manual_seed(2), requires_grad=True)
    TL.reorg(y, 2).sum().backward()
    assert x.grad is not None and torch.equal(y.grad, torch.ones_like(y))
