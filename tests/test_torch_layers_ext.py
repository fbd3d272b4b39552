"""The extended float layers of the yolov2/yolov1 models and the
classifiers (``nn/layers.py``, ``nn/graph.py::apply_simple_layer``) against
the JAX package on the CPU: every layer's forward within rtol 1e-5 / atol
1e-6 and its gradient (the VJP of a seeded cotangent into the input and the
params) within rtol 1e-4 / atol 1e-6 of the reference's; reorg both ways
bit-equal; dropout and crop at evaluation equal to the reference's and at
training time by their own rules; the region and detection forwards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_quantization_tpu.nn import graph as JG
from yolo_quantization_tpu.nn import layers as JL
from yolo_quantization_tpu_torch.nn import graph as TG
from yolo_quantization_tpu_torch.nn import layers as TL

torch.set_num_threads(2)

FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _specs(G):
    """name -> (spec, input shape (N, H, W, C)); the params come from
    ``init_params_numpy`` of a one-layer net, then BN stats are moved off
    the identity so the folds are exercised."""
    return {
        "connected": (G.ConnectedSpec(outputs=7, activation="leaky"), (2, 3, 3, 4)),
        "connected_bn": (G.ConnectedSpec(outputs=6, activation="linear", batch_normalize=True),
                         (2, 2, 3, 5)),
        "softmax": (G.SoftmaxSpec(), (2, 1, 1, 10)),
        "softmax_groups_temp": (G.SoftmaxSpec(groups=3, temperature=0.7), (2, 2, 2, 6)),
        "avgpool": (G.AvgPoolSpec(), (2, 5, 3, 4)),
        "dropout_eval": (G.DropoutSpec(probability=0.5), (2, 3, 3, 4)),
        "crop_eval": (G.CropSpec(crop_height=3, crop_width=4, flip=True), (2, 6, 7, 3)),
        "local": (G.LocalSpec(filters=5, size=3, stride=1, pad=1, activation="leaky"), (2, 5, 4, 3)),
        "local_s2_nopad": (G.LocalSpec(filters=4, size=3, stride=2, pad=0, activation="linear"),
                           (2, 7, 7, 2)),
        "deconv": (G.DeconvSpec(filters=4, size=3, stride=2, activation="leaky"), (2, 4, 3, 3)),
        "deconv_bn": (G.DeconvSpec(filters=3, size=2, stride=2, activation="linear",
                                   batch_normalize=True), (2, 3, 4, 5)),
        "deconv_k_lt_s": (G.DeconvSpec(filters=2, size=2, stride=3, activation="linear"), (1, 3, 3, 2)),
        "reorg": (G.ReorgSpec(stride=2), (2, 4, 6, 8)),
        "reorg_reverse": (G.ReorgSpec(stride=2, reverse=True), (2, 3, 2, 16)),
        "lrn": (G.LRNSpec(size=5, alpha=0.01, beta=0.75, kappa=2.0), (2, 3, 3, 7)),
        "l2norm": (G.L2NormSpec(), (2, 3, 3, 6)),
        "logistic": (G.LogisticSpec(), (2, 3, 3, 4)),
        "activation_selu": (G.ActivationSpec(activation="selu"), (2, 3, 3, 4)),
        "batchnorm": (G.BatchNormSpec(), (2, 3, 3, 5)),
        "region_softmax": (G.RegionSpec(anchors=((1.0, 1.5), (2.0, 2.5)), classes=3, num=2),
                           (2, 3, 4, 16)),
        "region_logistic": (G.RegionSpec(anchors=((1.0, 1.5), (2.0, 2.5)), classes=3, num=2,
                                         softmax=False), (2, 3, 3, 16)),
        "detection": (G.DetectionSpec(classes=3, num=2, side=2), (2, 1, 1, 2 * 2 * (3 + 2 * 5))),
        "detection_softmax": (G.DetectionSpec(classes=3, num=2, side=2, softmax=True),
                              (2, 1, 1, 2 * 2 * (3 + 2 * 5))),
    }


def _case(name, seed=0):
    rng = np.random.default_rng(seed)
    spec_j, shape = _specs(JG)[name]
    spec_t, _ = _specs(TG)[name]
    n, h, w, c = shape
    params = JG.init_params_numpy(seed, JG.NetworkDef((spec_j,), width=w, height=h, channels=c)).get(0)
    if params is not None:
        for k in params:
            params[k] = params[k] + rng.uniform(-0.2, 0.2, params[k].shape).astype(np.float32)
        if "var" in params:
            params["var"] = rng.uniform(0.5, 2.0, params["var"].shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    if isinstance(spec_j, (JG.ConnectedSpec, JG.DetectionSpec)) and name.startswith("detection"):
        x = x.reshape(n, -1)
    return spec_j, spec_t, params, x, rng


def _jax_vjp(spec, params, x, rng):
    """The reference's output, a seeded cotangent of its shape, and the VJP."""
    def f(x_, p_):
        return JG.apply_simple_layer(spec, p_, x_, train=False)

    shape = jax.eval_shape(f, x, params).shape
    cot = rng.standard_normal(shape).astype(np.float32)
    # one compiled program per case: op-by-op dispatch compiles every op
    y, (gx, gp) = jax.jit(lambda x_, p_, c_: (f(x_, p_), jax.vjp(f, x_, p_)[1](c_)))(x, params, cot)
    return np.asarray(y), cot, np.asarray(gx), {k: np.asarray(v) for k, v in (gp or {}).items()}


def _torch_vjp(spec, params, x, cot):
    xt = torch.tensor(x, requires_grad=True)
    pt = ({k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
          if params is not None else None)
    y = TG.apply_simple_layer(spec, pt, xt, train=False)
    y.backward(torch.from_numpy(cot))
    grads = {k: v.grad.numpy() for k, v in (pt or {}).items() if v.grad is not None}
    return y.detach().numpy(), xt.grad.numpy(), grads


@pytest.mark.parametrize("name", list(_specs(TG)))
def test_layer_forward_and_gradient_match_jax(name):
    spec_j, spec_t, params, x, rng = _case(name)
    y_j, cot, gx_j, gp_j = _jax_vjp(spec_j, params, x, rng)
    y_t, gx_t, gp_t = _torch_vjp(spec_t, params, x, cot)
    assert y_t.shape == y_j.shape
    np.testing.assert_allclose(y_t, y_j, **FWD_TOL)
    np.testing.assert_allclose(gx_t, gx_j, **GRAD_TOL)
    for k, g in gp_j.items():
        if k in ("mean", "var") or not np.any(g):
            continue  # BN running statistics are not trained
        np.testing.assert_allclose(gp_t[k], g, **GRAD_TOL, err_msg=f"grad of {k}")
    if name.startswith("reorg"):
        np.testing.assert_array_equal(y_t, y_j)  # a permutation: bit-equal
        np.testing.assert_array_equal(gx_t, gx_j)


@pytest.mark.parametrize("shape,stride,reverse", [
    ((2, 26, 26, 64), 2, False),   # yolov2's passthrough at 416
    ((1, 6, 9, 18), 3, False),
    ((2, 13, 13, 256), 2, True),
    ((1, 4, 5, 36), 3, True),
])
def test_reorg_is_the_reference_permutation(shape, stride, reverse):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = TL.reorg(torch.from_numpy(x), stride, reverse).numpy()
    np.testing.assert_array_equal(got, np.asarray(JL.reorg(jnp.asarray(x), stride, reverse)))
    perm = TL._reorg_permutation(*shape[1:], stride)
    np.testing.assert_array_equal(perm, JL._reorg_permutation(*shape[1:], stride))


def test_dropout_at_training_time_follows_its_rules():
    x = torch.ones((4, 16, 16, 32))
    g = torch.Generator().manual_seed(5)
    y = TL.dropout(x, 0.3, g)
    kept = y != 0
    assert y.shape == x.shape
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    np.testing.assert_allclose(y[kept].numpy(), np.float32(1.0) / np.float32(0.7), rtol=1e-7)
    # seeded: one generator state, one mask; a second draw differs
    y2 = TL.dropout(x, 0.3, torch.Generator().manual_seed(5))
    assert torch.equal(y, y2)
    assert not torch.equal(y, TL.dropout(x, 0.3, g))
    # the identity without a generator, at prob 0 and at evaluation
    assert torch.equal(TL.dropout(x, 0.3, None), x)
    assert torch.equal(TL.dropout(x, 0.0, g), x)
    spec = TG.DropoutSpec(probability=0.3)
    assert torch.equal(TG.apply_simple_layer(spec, None, x, train=False, generator=g), x)
    # its gradient is the mask times the scale
    xr = x.clone().requires_grad_(True)
    TL.dropout(xr, 0.3, torch.Generator().manual_seed(5)).sum().backward()
    assert torch.equal(xr.grad, y)


def test_crop_at_training_time_is_a_window():
    x = torch.arange(2 * 9 * 11 * 3, dtype=torch.float32).reshape(2, 9, 11, 3)
    seen = set()
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        for flip in (False, True):
            y = TL.crop(x, 5, 6, train=True, generator=g, flip=flip)
            assert y.shape == (2, 5, 6, 3)
            # locate the window by its first element
            v = int(y[0, 0, 0, 0]) // 3 if not flip else None
            windows = [(dy, dx) for dy in range(5) for dx in range(6)
                       if torch.equal(y, x[:, dy:dy + 5, dx:dx + 6])
                       or (flip and torch.equal(y, x[:, dy:dy + 5, dx:dx + 6].flip(2)))]
            assert len(windows) == 1, (flip, v)
            seen.add(windows[0])
    assert len(seen) > 5  # the offsets vary
    # evaluation (and no generator): the centre crop, as the reference's
    np.testing.assert_array_equal(TL.crop(x, 5, 6).numpy(),
                                  np.asarray(JL.crop(jnp.asarray(x.numpy()), 5, 6)))


def test_tree_specs_raise_naming_the_queue():
    """The WordTree softmax and region specs run and equal the JAX layers
    (the full cases are in ``test_torch_tree.py``)."""
    from yolo_quantization_tpu.core.tree import parse_tree as jparse
    from yolo_quantization_tpu_torch.core.tree import parse_tree

    lines = ["a -1", "b -1", "c 0", "d 0", "e 0"]
    x = np.random.default_rng(0).standard_normal((2, 1, 1, 10)).astype(np.float32)
    for ts, js in ((TG.SoftmaxSpec(tree=parse_tree(lines)), JG.SoftmaxSpec(tree=jparse(lines))),
                   (TG.RegionSpec(anchors=((1, 1),), num=1, classes=5, tree=parse_tree(lines)),
                    JG.RegionSpec(anchors=((1, 1),), num=1, classes=5, tree=jparse(lines)))):
        xs = x[..., :5] if isinstance(ts, TG.SoftmaxSpec) else x
        np.testing.assert_allclose(TG.apply_simple_layer(ts, None, torch.from_numpy(xs)).numpy(),
                                   np.asarray(JG.apply_simple_layer(js, None, jnp.asarray(xs))),
                                   rtol=1e-5, atol=1e-7)


def test_simple_layers_run_in_every_forward_mode():
    """A float net of extended layers through ``forward`` in every mode
    (QAT modes included: these layers carry no fake-quant) against the
    reference's forward."""
    def net(G):
        return G.NetworkDef(specs=(
            G.ConvSpec(filters=8, quantized=False),
            G.ReorgSpec(stride=2),
            G.LRNSpec(size=3, alpha=0.01),
            G.ConnectedSpec(outputs=12, activation="leaky", batch_normalize=True),
            G.DropoutSpec(probability=0.5),
            G.ConnectedSpec(outputs=2 * 2 * (2 + 2 * 5)),
            G.DetectionSpec(classes=2, num=2, side=2, softmax=True),
        ), width=8, height=8)

    jnet, tnet = net(JG), net(TG)
    params = JG.init_params_numpy(3, jnet)
    x = np.random.default_rng(3).uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    qs = JG.init_quant_state(jnet)
    for mode in (dict(), dict(train=True), dict(train=True, qat=True, update_ranges=True),
                 dict(qat=True)):
        heads_j, _ = JG.forward(jnet, params, jnp.asarray(x), JG.ForwardMode(**mode), qs)
        heads_t, _ = TG.forward(tnet, TG.params_to_torch(params, "cpu"), torch.from_numpy(x),
                                TG.ForwardMode(**mode), TG.quant_state_to_torch(qs, "cpu"))
        assert len(heads_t) == 1
        np.testing.assert_allclose(heads_t[0].detach().numpy(), np.asarray(heads_j[0]),
                                   rtol=1e-4, atol=1e-5, err_msg=str(mode))
    # with a generator, the training forward drops half the connected outputs
    g = torch.Generator().manual_seed(0)
    _, aux = TG.forward(tnet, TG.params_to_torch(params, "cpu"), torch.from_numpy(x),
                        TG.ForwardMode(train=True), return_outputs=True, generator=g)
    dropped = float((aux["outputs"][4] == 0).float().mean())
    assert 0.2 < dropped < 0.8
