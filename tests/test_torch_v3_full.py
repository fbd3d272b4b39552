"""Full-width yolov3 (darknet53, 80 classes) at 64x64: the port's engine
equals the JAX package's un-jitted ``build_forward`` at all 107 layers, bit
for bit, detections within float tolerance, and its ``.npz`` loads in either
package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_program import assert_programs_equal
from test_torch_v3 import DECODE_TOL, SIZE, assert_layers_equal, run_both
from yolo_quantization_tpu.eval import detect as jdetect
from yolo_quantization_tpu.infer import convert as jconvert
from yolo_quantization_tpu.infer import serialize as jser
from yolo_quantization_tpu.models import presets as jpresets
from yolo_quantization_tpu.models import zoo as jzoo
from yolo_quantization_tpu.nn import graph as jgraph
from yolo_quantization_tpu_torch.infer import engine as tengine
from yolo_quantization_tpu_torch.infer import serialize as tser
from yolo_quantization_tpu_torch.models import presets as tpresets

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def full_v3():
    """Full-width yolov3 (80 classes) at 64x64 from each package's builder."""
    jnet = jzoo.yolov3(classes=80, width=SIZE, height=SIZE)
    params = jgraph.init_params_numpy(0, jnet)
    jp = jconvert.convert(jnet, params, jpresets.synthetic_quant_state(jnet))
    tp = tpresets.v3_program(classes=80, size=SIZE, seed=0)
    x = np.random.default_rng(11).uniform(0, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    return jp, tp, x, run_both(jp, tp, x)


def test_full_v3_every_layer_matches_jax(full_v3):
    jp, tp, _, (jout, tout) = full_v3
    assert len(tp.cfg) == 107 and tengine.fusion_plan(tp) == set()
    assert_layers_equal(tp, jout, tout)


def test_full_v3_detections_match_jax(full_v3):
    jp, tp, x, ((jh, _), _) = full_v3
    jdets = jdetect.top_k_detections(*jdetect.decode_all_heads(jh, jp.net), max_det=64)
    for a, b in zip(jdets, tengine.Engine(tp, max_det=64, device="cpu").predict(x)):
        np.testing.assert_allclose(b, np.asarray(a), **DECODE_TOL)


def test_v3_npz_round_trips_both_ways(full_v3, tmp_path):
    jp, tp, _, _ = full_v3
    tser.save_program(str(tmp_path / "port.npz"), tp)
    jser.save_program(str(tmp_path / "jax.npz"), jp)
    assert_programs_equal(jser.load_program(str(tmp_path / "port.npz")), tp)
    assert_programs_equal(jp, tser.load_program(str(tmp_path / "jax.npz")))
