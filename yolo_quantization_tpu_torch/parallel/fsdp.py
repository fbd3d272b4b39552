"""Sharded parameters and optimizer state for training (FSDP2).

The counterpart of ``yolo_quantization_tpu/parallel/fsdp.py``: parameters
and optimizer state shard over the mesh's ``data`` dimension (ZeRO-3
style), and the train step is unchanged.  ``torch.distributed.fsdp.
fully_shard`` turns the params module's parameters into DTensors, gathers
them whole around the forward and backward, and reduce-scatters the
gradients, so the update runs on each rank's shard.  A leaf shards on the
dimension the JAX rule (``_leaf_spec``) names: a conv kernel's output
channels, a vector's only dimension, a connected layer's outputs; where
that dimension does not divide, FSDP2 splits the first one (padding the
last shard).  The BN rolling statistics are buffers and stay whole: every
rank updates them with the global batch's statistics.

``shard_report`` counts bytes by the JAX rule, so it reads as the JAX
package's report on the same parameters.  Checkpoints of a sharded state
are written whole by rank 0 (``train/checkpoint.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import Shard, distribute_tensor


def _leaf_spec(shape, axis_size: int) -> int | None:
    """The dimension a leaf shards on under the JAX rule, None where it
    replicates: a 4-D (HWIO) kernel its O, a vector its only dimension, a
    2-D (in, out) connected weight its out; each only when divisible by (and
    at least) the axis size."""
    shape = tuple(shape)
    if len(shape) == 4 and shape[3] % axis_size == 0 and shape[3] >= axis_size:
        return 3
    if len(shape) == 1 and shape[0] % axis_size == 0 and shape[0] >= axis_size:
        return 0
    if len(shape) == 2 and shape[1] % axis_size == 0 and shape[1] >= axis_size:
        return 1
    return None


def shard_state(mesh, state):
    """The TrainState with its params module sharded by FSDP2 over the
    mesh's ``data`` dimension, and its optimizer rebuilt over the sharded
    parameters (any momentum it holds sharded alike).  The step calls the
    module itself, whose hooks gather the parameters."""
    from torch.distributed.fsdp import fully_shard

    data = mesh["data"]
    axis = data.size()
    module = state.params
    old = list(module.parameters())

    def placement(p):
        dim = _leaf_spec(p.shape, axis)
        return Shard(dim) if dim is not None else None

    fully_shard(module, mesh=data, shard_placement_fn=placement)
    new = dict(zip(map(id, old), module.parameters()))
    opt = state.opt_state
    groups = [{**{k: v for k, v in g.items() if k != "params"}, "params": [new[id(p)] for p in g["params"]]}
              for g in opt.param_groups]
    sharded = type(opt)(groups, **opt.defaults)
    for p_old, st in opt.state.items():
        p = new[id(p_old)]
        sharded.state[p] = {k: distribute_tensor(v, p.device_mesh, p.placements)
                            if torch.is_tensor(v) and v.shape == p.shape else v for k, v in st.items()}
    return state._replace(opt_state=sharded, model=module)


def shard_report(params, axis: int) -> dict:
    """Bytes the JAX rule shards and replicates over ``axis`` ranks (the
    mesh's ``data`` dimension), over every leaf of ``params`` (BN statistics
    included): {"sharded_bytes", "replicated_bytes", "sharded_fraction"},
    so a caller can see that the model is really distributed and not
    replicated by channel counts the mesh does not divide."""
    sharded = replicated = 0
    for p in params.values():
        for v in p.values():
            nbytes = int(np.prod(v.shape)) * v.element_size()
            if _leaf_spec(v.shape, axis) is None:
                replicated += nbytes
            else:
                sharded += nbytes
    total = sharded + replicated
    return {"sharded_bytes": int(sharded), "replicated_bytes": int(replicated),
            "sharded_fraction": sharded / total if total else 0.0}
