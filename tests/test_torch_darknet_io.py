"""darknet ``.cfg`` / ``.weights`` I/O and the weight tools through the port
against the JAX package, on the CPU, from inline cfg text and seeded
weights (no reference checkout): ``parse_cfg`` gives the reference's specs
and ``TrainConfig`` for yolov2-tiny-voc, yolov2-voc, tiny-yolo v1 and
darknet19 and for a cfg holding every section kind; a file written by
JAX's ``save_darknet_weights`` loads in the port with params, ranges,
``seen`` and the raw quantization blocks bit-equal, and the port writes
files byte-identical to JAX's (quantized and float layouts); ``convert``
after a load equals JAX's bit for bit; the loaded ranges re-nudge to the
stored zero points, and to the stored scales within one float32 ulp;
``weights_tools`` equals JAX's."""

import dataclasses

import numpy as np
import pytest
import torch

from yolo_quantization_tpu.infer import convert as jconvert
from yolo_quantization_tpu.models import cfg as jcfg
from yolo_quantization_tpu.models import darknet_weights as jdw
from yolo_quantization_tpu.models import weights_tools as jwt
from yolo_quantization_tpu.models import zoo as jzoo
from yolo_quantization_tpu.nn import graph as JG
from yolo_quantization_tpu_torch.core.quant import nudge_min_max
from yolo_quantization_tpu_torch.infer.convert import convert
from yolo_quantization_tpu_torch.models import cfg as tcfg
from yolo_quantization_tpu_torch.models import darknet_weights as tdw
from yolo_quantization_tpu_torch.models import presets as tpresets
from yolo_quantization_tpu_torch.models import weights_tools as twt
from yolo_quantization_tpu_torch.models import zoo as tzoo
from yolo_quantization_tpu_torch.nn import graph as TG

torch.set_num_threads(2)


def _conv(filters, size=3, act="leaky", bn=1, quantized=1, extra=""):
    return (f"[convolutional]\nbatch_normalize={bn}\nfilters={filters}\nsize={size}\nstride=1\n"
            f"pad=1\nactivation={act}\nquantized={quantized}\n{extra}\n")


def _pool(stride=2, quantized=1):
    return f"[maxpool]\nsize=2\nstride={stride}\nquantized={quantized}\n\n"


NET = ("[net]\nbatch=64\nsubdivisions=8\nwidth={w}\nheight={w}\nchannels=3\nmomentum=0.9\n"
       "decay=0.0005\nlearning_rate=0.001\nburn_in=1000\nmax_batches=40200\npolicy=steps\n"
       "steps=40000,45000\nscales=.1,.1\nstart_quantization_step=20000\n{extra}\n")

V2_TINY_ANCHORS = "1.08,1.19, 3.42,4.41, 6.63,11.38, 9.42,5.11, 16.62,10.52"
V2_ANCHORS = "1.3221,1.73145, 3.19275,4.00944, 5.05587,8.09892, 9.47112,4.84053, 11.2364,10.0071"
REGION = ("[region]\nanchors={a}\nbias_match=1\nclasses=20\ncoords=4\nnum=5\nsoftmax=1\njitter=.2\n"
          "rescore=1\nobject_scale=5\nnoobject_scale=1\nclass_scale=1\ncoord_scale=1\nabsolute=1\n"
          "thresh=.6\nrandom=1\n")
HEAD = _conv(125, 1, "linear", bn=0, extra="quant_stop=1")


def yolov2_tiny_cfg(width=416) -> str:
    """yolov2-tiny-voc.cfg's topology with the quantization fields."""
    body = "".join(_conv(f) + _pool() for f in (16, 32, 64, 128, 256))
    body += _conv(512) + _pool(stride=1) + _conv(1024) + _conv(1024) + HEAD
    return NET.format(w=width, extra="") + body + REGION.format(a=V2_TINY_ANCHORS)


def yolov2_cfg(width=416) -> str:
    """yolov2-voc.cfg's topology (passthrough route -9, reorg, route -1,-4)."""
    body = _conv(32) + _pool() + _conv(64) + _pool()
    body += _conv(128) + _conv(64, 1) + _conv(128) + _pool()
    body += _conv(256) + _conv(128, 1) + _conv(256) + _pool()
    body += _conv(512) + _conv(256, 1) + _conv(512) + _conv(256, 1) + _conv(512) + _pool()
    body += _conv(1024) + _conv(512, 1) + _conv(1024) + _conv(512, 1) + _conv(1024)
    body += _conv(1024) + _conv(1024)
    body += "[route]\nlayers=-9\nquantized=1\n\n" + _conv(64, 1) + "[reorg]\nstride=2\n\n"
    body += "[route]\nlayers=-1,-4\nquantized=1\n\n" + _conv(1024) + HEAD
    return NET.format(w=width, extra="") + body + REGION.format(a=V2_ANCHORS)


def yolov1_tiny_cfg() -> str:
    """tiny-yolo v1's topology (float, adam, the v1 loss weights)."""
    body = "".join(_conv(f, quantized=0) + _pool() for f in (16, 32, 64, 128, 256, 512))
    body += _conv(1024, quantized=0) * 3
    body += "[connected]\noutput=256\nactivation=linear\n\n[connected]\noutput=4096\nactivation=leaky\n\n"
    body += "[dropout]\nprobability=.5\n\n[connected]\noutput=1470\nactivation=linear\n\n"
    body += ("[detection]\nclasses=20\ncoords=4\nrescore=1\nside=7\nnum=2\nsoftmax=0\nsqrt=1\n"
             "jitter=.2\nobject_scale=1\nnoobject_scale=.5\nclass_scale=1\ncoord_scale=5\n")
    return NET.format(w=448, extra="adam=1\nB1=.9\nB2=.999") + body


def darknet19_cfg() -> str:
    body = _conv(32, quantized=0) + _pool() + _conv(64, quantized=0) + _pool()
    for f, k in ((128, 3), (64, 1), (128, 3)):
        body += _conv(f, k, quantized=0)
    body += _pool()
    for f, k in ((256, 3), (128, 1), (256, 3)):
        body += _conv(f, k, quantized=0)
    body += _pool()
    for f, k in ((512, 3), (256, 1), (512, 3), (256, 1), (512, 3)):
        body += _conv(f, k, quantized=0)
    body += _pool()
    for f, k in ((1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3)):
        body += _conv(f, k, quantized=0)
    body += _conv(1000, 1, "linear", bn=0, quantized=0) + "[avgpool]\n\n[softmax]\ngroups=1\n"
    return "[net]\nwidth=224\nheight=224\nchannels=3\npolicy=poly\npower=4\nmax_batches=800000\n" + body


EVERY_SECTION = """[network]
width=64
height=48
channels=3
batch=16
learning_rate=0.01
policy=sig
gamma=0.5
step=100
adam=0
input_calibration=0, 1.5
[convolutional]
filters=8
size=3
stride=2
padding=1
activation=relu6
quantized=1
[maxpool]
size=3
stride=1
padding=1
[upsample]
stride=2
quantized=1
first_time=1
[route]
layers=-1,0
quantized=1
first_time=1
[shortcut]
from=-3
activation=leaky
[yolo]
mask=0,2
anchors=10,14, 23,27, 37,58
classes=4
[region]
anchors=1,2, 3,4
classes=3
num=2
[detection]
classes=2
num=3
side=5
forced=1
random=1
[connected]
output=10
batch_normalize=1
activation=tanh
[softmax]
groups=2
temperature=0.5
[avgpool]
[dropout]
probability=0.25
[crop]
crop_height=5
crop_width=6
flip=1
[local]
filters=4
size=3
stride=1
pad=1
activation=elu
[deconvolutional]
filters=3
size=2
stride=2
batch_normalize=1
activation=ramp
[reorg]
stride=2
reverse=1
[normalization]
size=3
alpha=0.001
beta=0.5
kappa=2
[lrn]
size=7
[l2norm]
[logistic]
[activation]
activation=plse
[batchnorm]
"""

CFGS = {"yolov2_tiny": yolov2_tiny_cfg, "yolov2": yolov2_cfg, "yolov1_tiny": yolov1_tiny_cfg,
        "darknet19": darknet19_cfg}


def spec_rows(net):
    return ([(type(s).__name__, dataclasses.asdict(s)) for s in net.specs],
            (net.width, net.height, net.channels))


def train_cfg_dict(tc):
    d = dataclasses.asdict(tc)
    d.pop("donate_state", None)  # a JAX buffer-donation switch the port has no use for
    return d


@pytest.mark.parametrize("name", list(CFGS) + ["every_section"])
def test_parse_cfg_matches_jax(name):
    text = EVERY_SECTION if name == "every_section" else CFGS[name]()
    tnet, ttc = tcfg.parse_cfg(text)
    jnet, jtc = jcfg.parse_cfg(text)
    assert spec_rows(tnet) == spec_rows(jnet)
    tfields = train_cfg_dict(ttc)
    assert tfields == {k: v for k, v in train_cfg_dict(jtc).items() if k in tfields}
    assert set(train_cfg_dict(jtc)) - set(tfields) == set()
    if name != "every_section":
        # the cfg text is the zoo builder's topology
        assert spec_rows(tnet) == spec_rows(getattr(tzoo, name)())


def test_load_cfg_reads_the_file(tmp_path):
    path = tmp_path / "yolov2-tiny-voc.cfg"
    path.write_text(yolov2_tiny_cfg())
    assert spec_rows(tcfg.load_cfg(str(path))[0]) == spec_rows(tzoo.yolov2_tiny())


def test_tree_option_raises_naming_the_queue():
    text = "[net]\nwidth=32\nheight=32\n[softmax]\ntree=data/9k.tree\n"
    with pytest.raises(NotImplementedError, match="queue 1.12"):
        tcfg.parse_cfg(text)


def _trained_like_state(net, seed):
    """Ranges off the synthetic rationals, as EMA tracking leaves them."""
    rng = np.random.default_rng(seed)
    qs = TG.init_quant_state(net)
    qs["input"] = {"min": np.float32(0.0), "max": np.float32(rng.uniform(0.9, 1.1))}
    for k in qs:
        if k != "input":
            qs[k] = {"min": np.float32(rng.uniform(-4, -0.5)), "max": np.float32(rng.uniform(3, 9))}
    return qs


def _params(net, seed):
    """Seeded params with BN statistics off the identity."""
    rng = np.random.default_rng(seed + 1)
    params = TG.init_params_numpy(seed, net)
    for p in params.values():
        for k in ("gamma", "mean"):
            if k in p:
                p[k] = p[k] + rng.uniform(-0.3, 0.3, p[k].shape).astype(np.float32)
        if "var" in p:
            p["var"] = rng.uniform(0.5, 2.0, p["var"].shape).astype(np.float32)
    return params


def _assert_checkpoints_equal(a, b):
    assert a.seen == b.seen
    assert a.params.keys() == b.params.keys()
    for i in a.params:
        assert a.params[i].keys() == b.params[i].keys()
        for k in a.params[i]:
            np.testing.assert_array_equal(a.params[i][k], b.params[i][k], err_msg=f"{i}.{k}")
            assert a.params[i][k].dtype == b.params[i][k].dtype
    assert a.quant_state.keys() == b.quant_state.keys()
    for k in a.quant_state:
        for n in ("min", "max"):
            x, y = a.quant_state[k][n], b.quant_state[k][n]
            assert x == y and np.asarray(x).dtype == np.asarray(y).dtype, (k, n)
    assert a.raw_quant.keys() == b.raw_quant.keys()
    for i in a.raw_quant:
        for k in a.raw_quant[i]:
            np.testing.assert_array_equal(a.raw_quant[i][k], b.raw_quant[i][k], err_msg=f"{i}.{k}")


@pytest.mark.parametrize("model,state", [("yolov2_tiny", "synthetic"), ("yolov2_tiny", "trained"),
                                         ("yolov2_tiny", "float"), ("yolov1_tiny", "float")])
def test_weights_files_cross_both_ways(tmp_path, model, state):
    """JAX's file loads in the port bit-equal (auto-detected layout), the
    port's file is byte-identical to JAX's, and ``convert`` of the loaded
    checkpoint equals JAX's (quantized layouts)."""
    kw = dict(width=96, height=96) if model == "yolov2_tiny" else dict(classes=3, side=3, width=192,
                                                                       height=192)
    tnet, jnet = getattr(tzoo, model)(**kw), getattr(jzoo, model)(**kw)
    params = _params(tnet, 3)
    qs = {"synthetic": tpresets.v2_quant_state, "trained": lambda n: _trained_like_state(n, 4),
          "float": lambda n: None}[state](tnet)
    jpath, tpath = str(tmp_path / "jax.weights"), str(tmp_path / "port.weights")
    jdw.save_darknet_weights(jpath, jnet, params, qs, seen=123456789012)
    tdw.save_darknet_weights(tpath, tnet, params, qs, seen=123456789012)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    got, want = tdw.load_darknet_weights(jpath, tnet), jdw.load_darknet_weights(jpath, jnet)
    _assert_checkpoints_equal(got, want)
    assert got.seen == 123456789012 and bool(got.raw_quant) == (qs is not None)
    if qs is not None:
        tp = convert(tnet, got.params, got.quant_state)
        jp = jconvert.convert(jnet, want.params, want.quant_state)
        assert (tp.in_scale, tp.in_zp) == (jp.in_scale, jp.in_zp)
        for a, b in zip(tp.cfg, jp.cfg):
            assert (a.kind, a.out_scale, a.out_zp, a.in_scales) == (b.kind, b.out_scale, b.out_zp,
                                                                     b.in_scales)
        for i in tp.arrays:
            for k in tp.arrays[i]:
                np.testing.assert_array_equal(tp.arrays[i][k], jp.arrays[i][k], err_msg=f"{i}.{k}")
        # and the port's loaded ranges load back into JAX's format unchanged
        tdw.save_darknet_weights(tpath, tnet, got.params, got.quant_state, seen=got.seen)
        _assert_checkpoints_equal(jdw.load_darknet_weights(tpath, jnet), tdw.load_darknet_weights(tpath, tnet))


def test_extended_layers_float_layout_crosses_both_ways(tmp_path):
    """connected (with BN), local, deconv (with BN) and batchnorm blocks."""
    def net(G):
        return G.NetworkDef(specs=(
            G.ConvSpec(filters=6, quantized=False), G.LocalSpec(filters=4, size=3, pad=1),
            G.DeconvSpec(filters=3, size=2, stride=2, batch_normalize=True), G.BatchNormSpec(),
            G.MaxPoolSpec(2, 2, quantized=False),
            G.ConnectedSpec(outputs=5, batch_normalize=True), G.ConnectedSpec(outputs=7),
        ), width=8, height=8)

    tnet, jnet = net(TG), net(JG)
    params = _params(tnet, 5)
    jpath, tpath = str(tmp_path / "jax.weights"), str(tmp_path / "port.weights")
    jdw.save_darknet_weights(jpath, jnet, params, seen=7)
    tdw.save_darknet_weights(tpath, tnet, params, seen=7)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    _assert_checkpoints_equal(tdw.load_darknet_weights(jpath, tnet), jdw.load_darknet_weights(jpath, jnet))


def test_size_mismatch_raises(tmp_path):
    net = tzoo.yolov2_tiny(width=64, height=64)
    path = str(tmp_path / "w.weights")
    tdw.save_darknet_weights(path, net, _params(net, 1), tpresets.v2_quant_state(net))
    other = tzoo.yolov2_tiny(classes=3, width=64, height=64)
    with pytest.raises(ValueError, match="matches neither"):
        tdw.load_darknet_weights(path, other)
    with pytest.raises(ValueError, match="trailing bytes"):
        tdw.load_darknet_weights(path, tzoo.yolov2_tiny(classes=19, width=64, height=64), quantized=True)


def test_loaded_ranges_renudge_to_the_stored_fields(tmp_path):
    """The inverse nudge, min = -zp*s and max = (255 - zp)*s in float32:
    re-nudging gives back every stored zero point; the stored scale for the
    synthetic ranges' grids bit for bit (so save -> load -> save is
    byte-identical there), and within one float32 ulp for arbitrary scales,
    where the reference's formula, which the port keeps so its loads equal
    the reference's, misses the stored scale by an ulp about a quarter of
    the time."""
    rng = np.random.default_rng(0)
    scale = rng.uniform(1e-4, 0.2, 4000).astype(np.float32)
    zp = rng.integers(0, 256, 4000)
    lo, hi = zip(*(tdw._range_from_scale_zp(s, int(z)) for s, z in zip(scale, zp)))
    qp = nudge_min_max(torch.tensor(np.array(lo, np.float32)), torch.tensor(np.array(hi, np.float32)))
    np.testing.assert_array_equal(qp.zero_point.numpy(), zp)
    ulps = np.abs(qp.scale.numpy().view(np.int32).astype(np.int64) - scale.view(np.int32))
    assert ulps.max() <= 1
    net = tzoo.yolov2_tiny(width=64, height=64)
    params = _params(net, 2)
    first, second = str(tmp_path / "a.weights"), str(tmp_path / "b.weights")
    tdw.save_darknet_weights(first, net, params, tpresets.v2_quant_state(net))
    ck = tdw.load_darknet_weights(first, net)
    for i, raw in ck.raw_quant.items():
        if "activ_scale" in raw and f"act_{i}" in ck.quant_state:
            st = ck.quant_state[f"act_{i}"]
            got = nudge_min_max(torch.tensor(st["min"]), torch.tensor(st["max"]))
            assert float(got.scale) == float(raw["activ_scale"]) and int(got.zero_point) == raw["activ_zp"]
    tdw.save_darknet_weights(second, net, ck.params, ck.quant_state)
    assert open(first, "rb").read() == open(second, "rb").read()


def test_weights_tools_match_jax():
    def net(G):
        return G.NetworkDef(specs=(G.ConvSpec(filters=6), G.ConvSpec(filters=4, batch_normalize=False),
                                   G.ConnectedSpec(outputs=3)), width=8, height=8)

    tnet, jnet = net(TG), net(JG)
    base = _params(tnet, 7)
    copy = lambda: {i: {k: v.copy() for k, v in p.items()} for i, p in base.items()}  # noqa: E731

    def same(a, b):
        assert a.keys() == b.keys()
        for i in a:
            assert a[i].keys() == b[i].keys()
            for k in a[i]:
                np.testing.assert_array_equal(a[i][k], b[i][k], err_msg=f"{i}.{k}")

    assert twt.print_weights(tnet, base, 0) == jwt.print_weights(jnet, base, 0)
    assert twt.statistics_net(tnet, base) == jwt.statistics_net(jnet, base)
    for fn in ("rgbgr_net", "denormalize_net"):
        a, b = copy(), copy()
        getattr(twt, fn)(tnet, a)
        getattr(jwt, fn)(jnet, b)
        same(a, b)
    a, b = copy(), copy()
    twt.rescale_net(tnet, a, 0.5)
    jwt.rescale_net(jnet, b, 0.5)
    same(a, b)
    a, b = copy(), copy()
    assert spec_rows(twt.normalize_net(tnet, a)) == spec_rows(jwt.normalize_net(jnet, b))
    same(a, b)
    np.testing.assert_array_equal(twt.get_filter_images(tnet, base, 0), jwt.get_filter_images(jnet, base, 0))
    np.testing.assert_array_equal(twt.filter_mosaic(tnet, base), jwt.filter_mosaic(jnet, base))
    np.testing.assert_array_equal(twt.filter_mosaic(tnet, base, 1), jwt.filter_mosaic(jnet, base, 1))
    for a, b in zip(twt.mkimg(tnet, base, 16, 20, 2, seed=3, per_image=5),
                    jwt.mkimg(jnet, base, 16, 20, 2, seed=3, per_image=5)):
        np.testing.assert_array_equal(a, b)
