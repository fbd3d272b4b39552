"""Tensor parallelism: quantized conv output channels sharded over the
mesh's ``model`` dimension.

The counterpart of ``yolo_quantization_tpu/parallel/tp.py``.  Each rank
holds a slice of every quantized conv's output channels (the HWIO weights
and every per-channel vector of the epilogue) and runs K1
(``ops/cuda_qconv.py``) on it; the slices are joined along channels right
after the conv, before any consumer that reads them all (the next conv, a
route, a shortcut, a head).  The codes equal the single-device
``Engine``'s bit for bit: each channel's accumulation, epilogue and fused
2x2 pool depend on that channel's weights alone, K1 pads each slice's
channels to 16 as it pads a whole layer's, and ``dynamic_input``'s
per-image bias and multiplier are rebuilt from the slice's ingredients.
Layers whose channels the shard count does not divide run whole on every
rank, with a warning, as the JAX version replicates them.  Float convs of
mixed graphs are not K1's and run whole.

The join is a zero-padded all-reduce of the codes (``parallel/mesh.py::
gather_cat``); ``tp_forward`` without a group runs every slice in one
process and concatenates them.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from yolo_quantization_tpu_torch.infer.engine import build_forward, device_arrays
from yolo_quantization_tpu_torch.parallel import mesh as pmesh

# per-output-channel arrays of a quantized conv (the JAX set, plus the
# per-channel ingredients of dynamic_input's per-image rebuild)
_CHANNEL_SHARDED = {"w_i8", "bias_i32", "m", "w_zp", "out_zp", "m0", "m_shift",
                    "w_scale", "w_zp_u8", "bias_f32", "bias_f", "wsum_i32"}


def sharded_convs(arrays, world: int) -> set[int]:
    """The quantized convs (the layers with ``w_i8``) of a program's arrays
    whose output channels split over ``world`` shards; the others are
    reported and run whole."""
    if world == 1:
        return set()
    convs = sorted(i for i, layer in arrays.items() if "w_i8" in layer)
    whole = [i for i in convs if arrays[i]["w_i8"].shape[3] % world]
    if whole:
        warnings.warn(
            f"TP: conv layers {whole} have output channels not divisible by {world} shards; "
            "their weights are REPLICATED, not sharded: pick a divisor for full TP", stacklevel=2)
    return set(convs) - set(whole)


def shard_arrays_tp(arrays, rank: int, world: int):
    """Rank's slice of a program's arrays: the output channels [rank * c,
    (rank + 1) * c) of the HWIO weights and of every per-channel vector of
    each conv ``sharded_convs`` splits; everything else whole."""
    return _slice(arrays, rank, world, sharded_convs(arrays, world))


def _slice(arrays, rank: int, world: int, layers: set[int]):
    out = {}
    for i, layer in arrays.items():
        if i not in layers:
            out[i] = layer
            continue
        co = layer["w_i8"].shape[3]
        cs = co // world
        sl = slice(rank * cs, (rank + 1) * cs)
        out[i] = {}
        for name, a in layer.items():
            a = np.asarray(a)
            if name == "w_i8":
                a = a[..., sl]
            elif name in _CHANNEL_SHARDED and a.ndim == 1 and a.shape[0] == co:
                a = a[sl]
            out[i][name] = a
    return out


def tp_forward(program, world: int, device, group=None, return_outputs: bool = False, **options):
    """fn(x) -> heads (and every layer's whole output with
    ``return_outputs``), the engine's forward with each sharded conv run on
    its channel slices.  With ``group`` (the mesh's ``model`` dimension, of
    ``world`` ranks) this rank runs its slice and the slices are gathered;
    without one every slice runs here, one after another.  ``options`` are
    ``build_forward``'s (``use_s2d`` excepted: K2's phase columns do not
    slice)."""
    if options.get("use_s2d"):
        raise ValueError("tensor parallelism runs K1 only: use_s2d is not supported")
    layers = sharded_convs(program.arrays, world)
    ranks = [pmesh.rank_world(group)[0]] if group is not None else range(world)
    arrays = {r: device_arrays(dataclasses.replace(
        program, arrays=_slice(program.arrays, r, world, layers)), device) for r in ranks}
    mine = arrays[ranks[0]]

    def shard(i, run):
        if i not in layers:
            return run(mine[i])
        if group is None:
            return torch.cat([run(arrays[r][i]) for r in ranks], dim=-1)
        return pmesh.gather_cat(run(mine[i]), group, dim=-1)

    fwd = build_forward(program, return_outputs, shard=shard, **options)
    return lambda x: fwd(mine, x)


def run_tp(program, x, n_model: int | None = None, device=None):
    """The program's heads (numpy) on the current process group, conv
    channels sharded over a mesh of ``n_model`` model ranks (every rank by
    default), the whole batch on each; returns (heads, mesh)."""
    from yolo_quantization_tpu_torch.parallel.distributed import global_mesh

    dev = pmesh.rank_device(device)
    mesh = global_mesh(n_model or torch.distributed.get_world_size(), dev)
    fwd = tp_forward(program, mesh["model"].size(), dev, mesh.get_group("model"))
    with torch.inference_mode():
        heads = fwd(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev))
        return [h.cpu().numpy() for h in heads], mesh


def make_tp_engine(program, n_model: int | None = None, n_data: int | None = None,
                   max_det: int = 64, device=None, **options):
    """The engine's whole program (integer forward, head decode and top-k,
    as ``Engine.predict``) with conv channels sharded over the mesh's
    ``model`` dimension and the batch over its ``data`` dimension.  Returns
    (predict, mesh); predict(images) -> (boxes, obj, cls) numpy for the
    whole batch on every rank, bit-equal to the single-device ``Engine``."""
    from yolo_quantization_tpu_torch.eval import detect
    from yolo_quantization_tpu_torch.parallel.distributed import global_mesh

    dev = pmesh.rank_device(device)
    world = torch.distributed.get_world_size()
    n_model = n_model or world
    if n_data is not None and n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} ranks; the world has {world}")
    mesh = global_mesh(n_model, dev)
    fwd = tp_forward(program, n_model, dev, mesh.get_group("model"), **options)
    data = mesh.get_group("data")
    anchors = detect.head_anchors(program.net, dev)

    def predict(images):
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(pmesh.shard_batch(data, images))).to(dev)
            boxes, obj, cls = detect.top_k_detections(
                *detect.decode_all_heads(fwd(x), program.net, anchors), max_det)
            return tuple(pmesh.gather_cat(t, data).cpu().numpy() for t in (boxes, obj, cls))

    return predict, mesh
