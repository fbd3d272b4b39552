"""The counterpart of ``__graft_entry__.py`` (``tools/dryrun.py``) on the
CPU: ``entry(device="cpu")``'s heads equal the JAX ``entry()``'s, and
``dryrun_multichip`` over gloo on the CPU holds the JAX dry run's bands
(loss within 5e-3 relative, parameter checksum within 1e-5, TP heads bit
for bit) on one rank in this process and on two worker processes."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from yolo_quantization_tpu_torch.tools import dryrun

torch.set_num_threads(2)


def test_entry_heads_equal_jax_entry():
    fn, args = dryrun.entry(device="cpu")
    heads = fn(*args)
    jfn, jargs = jentry.entry()
    jheads = jax.jit(jfn)(*jargs)
    assert len(heads) == len(jheads) == 2
    for h, j in zip(heads, jheads):
        assert tuple(h.shape) == tuple(j.shape) and h.shape[0] == 1
        np.testing.assert_array_equal(h.numpy(), np.asarray(j))


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip_over_gloo_holds_the_jax_bands(n, capsys):
    out = dryrun.dryrun_multichip(n, backend="gloo")
    assert out["world"] == n and out["tp_model_ranks"] == n and out["tp_max_abs_diff"] == 0
    for kind in ("dp", "fsdp"):
        assert abs(out[f"loss_{kind}"] - out["loss_1"]) <= dryrun.LOSS_REL * max(abs(out["loss_1"]), 1.0)
        assert abs(out[f"checksum_{kind}"] - out["checksum_1"]) <= dryrun.CHECKSUM_REL * out["checksum_1"]
    assert out["fsdp_sharded_fraction"] > 0.99
    assert f"dryrun_multichip({n}) over gloo: ok" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="nccl or gloo"):
        dryrun.dryrun_multichip(2, backend="mpi")
