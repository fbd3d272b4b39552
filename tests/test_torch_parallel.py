"""The port's parallel package in one process, against the port's engine
and trainer and the JAX package (the process-group cases are in
``test_torch_distributed.py``):

- tensor parallelism with every slice run here (``tp_forward`` without a
  group): the codes of every layer equal ``Engine``'s bit for bit at 64x64
  over 2 and 4 shards, fused and unfused, with the parity engine's options
  (asymmetric weights, ``dynamic_input``, ``exact_leaky``) and the int16
  carrier; the dequantized heads equal the JAX ``run_tp``'s on the
  conftest's 8 virtual devices bit for bit, and the detections its
  ``make_tp_engine``'s within the decode tolerance (XLA's and torch's
  sigmoid and exp differ by ulps); a rank's slice of the arrays equals the
  JAX shard on that rank's device; layers whose channels do not divide are
  reported and run whole;
- FSDP's ``_leaf_spec`` and ``shard_report`` equal to JAX's;
- ``NetParams``: the module's forward equals the forward over the params
  dict bit for bit; BN statistics are buffers;
- one process is the global batch: the statistics of ``parallel/mesh.py``
  without a group equal ``nn/layers.py``'s, and a too-large or uneven
  split raises.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from yolo_quantization_tpu.models import presets as jpresets
from yolo_quantization_tpu.parallel import fsdp as jfsdp
from yolo_quantization_tpu.parallel import mesh as jmesh
from yolo_quantization_tpu.parallel import tp as jtp
from yolo_quantization_tpu_torch.eval import detect
from yolo_quantization_tpu_torch.infer.engine import Engine
from yolo_quantization_tpu_torch.models import presets, zoo
from yolo_quantization_tpu_torch.nn import graph as TG
from yolo_quantization_tpu_torch.nn import layers as L
from yolo_quantization_tpu_torch.parallel import fsdp, mesh as pmesh, tp

torch.set_num_threads(2)

DECODE_TOL = dict(rtol=1e-6, atol=1e-7)
CONFIGS = {
    "flagship": (presets.flagship_program, {}),
    "unfused": (presets.flagship_program, dict(fuse_pool=False)),
    "parity": (presets.parity_program, dict(dynamic_input=True, exact_leaky=True)),
    "int16": (presets.flagship_program, dict(carrier="int16")),
}


def images(n=2, size=64, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_tp_slices_equal_engine_at_every_layer(config, world):
    build, options = CONFIGS[config]
    program = build(classes=5, size=64)
    x = images()
    heads, outs = Engine(program, device="cpu", **options).raw_heads(x, return_outputs=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fwd = tp.tp_forward(program, world, "cpu", return_outputs=True, **options)
    # the 30-channel heads (15, 22) do not split 4 ways
    assert [("[15, 22]" in str(w.message)) for w in caught] == ([True] if world == 4 else [])
    with torch.inference_mode():
        theads, touts = fwd(torch.from_numpy(x))
    for i, (a, b) in enumerate(zip(outs, touts)):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=f"layer {i}")
    for a, b in zip(heads, theads):
        np.testing.assert_array_equal(b.numpy(), a)


def test_tp_matches_jax_run_tp_and_make_tp_engine():
    """JAX's TP over its 8 virtual devices (2 data x 4 model) and the port's
    4 slices in one process, from the same seeded program."""
    program = presets.flagship_program(classes=3, size=96)
    jprogram = jpresets.flagship_program(classes=3, size=96)
    x = images(4, 96, seed=5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jheads, _ = jtp.run_tp(jprogram, x, n_model=4)
        fwd = tp.tp_forward(program, 4, "cpu")
        jpredict, _ = jtp.make_tp_engine(jprogram, n_model=4, n_data=2, max_det=64)
    with torch.inference_mode():
        heads = fwd(torch.from_numpy(x))
        dets = detect.top_k_detections(*detect.decode_all_heads(heads, program.net), 64)
    for a, b in zip(jheads, heads):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jpredict(x), dets):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **DECODE_TOL)


def test_shard_arrays_equal_jax_shards():
    program = presets.flagship_program(classes=5, size=64)
    mesh = jmesh.make_mesh(n_data=2, n_model=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jarrays = jtp.shard_arrays_tp(program.arrays, mesh)
        layers = tp.sharded_convs(program.arrays, 4)
    assert layers == {i for i, c in enumerate(program.cfg) if c.kind == "qconv"} - {15, 22}
    devices = mesh.devices[0]  # data row 0: model ranks 0..3
    for r in range(4):
        with pytest.warns(UserWarning, match=r"conv layers \[15, 22\] .* REPLICATED"):
            mine = tp.shard_arrays_tp(program.arrays, r, 4)
        for i in layers:
            for name in ("w_i8", "bias_i32", "m", "w_zp", "w_scale"):
                shard = next(s for s in jarrays[i][name].addressable_shards if s.device == devices[r])
                np.testing.assert_array_equal(mine[i][name], np.asarray(shard.data), err_msg=f"{r} {i} {name}")
        np.testing.assert_array_equal(mine[15]["w_i8"], program.arrays[15]["w_i8"])


def test_tp_rejects_s2d():
    with pytest.raises(ValueError, match="use_s2d"):
        tp.tp_forward(presets.flagship_program(classes=5, size=64), 2, "cpu", use_s2d=True)


@pytest.mark.parametrize("axis", [2, 8])
def test_shard_report_and_leaf_spec_match_jax(axis):
    net = zoo.yolov3_tiny(classes=2, width=96, height=96)
    params = TG.init_params_numpy(0, net)
    want = jfsdp.shard_report(jmesh.make_mesh(n_data=axis), params)
    assert fsdp.shard_report(TG.params_to_torch(params, "cpu"), axis) == want
    for shape in [(3, 3, 16, 32), (1, 1, 30, 30), (7,), (16,), (100, 40), (5, 3), (2, 2), ()]:
        spec = jfsdp._leaf_spec(np.zeros(shape), axis)
        dim = fsdp._leaf_spec(shape, axis)
        assert (spec == jax.sharding.PartitionSpec()) == (dim is None)
        if dim is not None:
            assert tuple(spec)[dim] == "data"


def test_net_params_module_is_the_params_dict():
    net = zoo.yolov3_tiny(classes=2, width=64, height=64)
    params = TG.params_to_torch(TG.init_params_numpy(0, net), "cpu")
    module = TG.NetParams(net, params)
    assert {n.split(".")[-1] for n, _ in module.named_buffers()} == {"mean", "var"}
    assert {n.split(".")[-1] for n, _ in module.named_parameters()} == {"w", "bias", "gamma"}
    assert list(module) == list(params) and module.keys() == params.keys() and 0 in module
    assert module.get(1) is None and set(module[0]) == set(params[0])
    x = torch.from_numpy(images())
    mode = TG.ForwardMode(train=True)
    a, aux_a = module(x, mode)
    b, aux_b = TG.forward(net, params, x, mode)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    for i in aux_a["bn_stats"]:
        assert all(torch.equal(u, v) for u, v in zip(aux_a["bn_stats"][i], aux_b["bn_stats"][i]))


def test_one_process_is_the_global_batch():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 5, 6, 3)).astype(np.float32))
    for a, b in zip(pmesh.batch_stats(x, None), L.batch_stats(x)):
        assert torch.equal(a, b)
    assert [float(v) for v in pmesh.batch_minmax(x, None)] == [float(x.min()), float(x.max())]
    flat = x.reshape(-1)
    assert torch.equal(pmesh.strided_sample(flat, None), flat[:: max(len(flat) // 65536, 1)])
    assert pmesh.rank_world(None) == (0, 1) and torch.equal(pmesh.shard_batch(None, x), x)
    assert torch.equal(pmesh.global_mean(x, None), x)
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    assert torch.equal(L.dropout(x, 0.5, gen()), L.dropout(x, 0.5, gen(), (0, 1)))


def test_too_few_devices_raise():
    """No CPU fallback: without a card the rank's device raises unless the
    CPU is asked for; a state without a mesh cannot be sharded."""
    assert pmesh.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            pmesh.rank_device()
    else:
        with pytest.raises(RuntimeError, match="does not exist"):
            pmesh.rank_device(f"cuda:{torch.cuda.device_count()}")
    with pytest.raises(ValueError, match="fsdp needs a device mesh"):
        pmesh.data_parallel(None, None, fsdp=True)


@pytest.mark.cuda
def test_cuda_tp_slices_equal_engine():
    """On the card: K1 on 2 and 4 channel slices, concatenated, equals the
    single-device engine at every layer (yolov3-tiny 416, batch 2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    program = presets.flagship_program(classes=5, size=416)
    x = images(2, 416)
    _, outs = Engine(program, device="cuda").raw_heads(x, return_outputs=True)
    for world in (2, 4):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fwd = tp.tp_forward(program, world, "cuda", return_outputs=True)
        with torch.inference_mode():
            _, touts = fwd(torch.from_numpy(x).cuda())
        for i, (a, b) in enumerate(zip(outs, touts)):
            np.testing.assert_array_equal(b.cpu().numpy(), a, err_msg=f"{world} layer {i}")
