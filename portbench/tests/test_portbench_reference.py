"""The reference against the program on the CPU, at small sizes: the same
network from the same .cfg text, the same integer codes in every head.
Each cell's configuration is read by its own reference, as the harness
resolves it, and built by the program with its own options."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import harness, inputs, system
from portbench.reference import darknet_cfg, model
from portbench.tests.conftest import CELLS

ZOO = {"yolov3-tiny-channelwise": "yolov3_tiny", "yolov3-coco80": "yolov3"}


@pytest.mark.parametrize("cell", CELLS)
def test_cfg_reads_as_the_zoo_builds_it(root, cell):
    """The reference reads every layer's shape as the program does, and
    the program reads the .cfg as its model zoo builds it, where the zoo
    has the model."""
    from yolo_quantization_tpu_torch.models import zoo
    from yolo_quantization_tpu_torch.models.cfg import parse_cfg

    _, config = harness.cell_files(root, cell)
    text = harness.cfg_text(config, config["size"])
    net, _ = parse_cfg(text)
    if config["name"] in ZOO:
        assert net == getattr(zoo, ZOO[config["name"]])()
    ref = harness.reference(config).parse(text)
    assert [layer.out_shape for layer in ref.layers] == net.shapes()


@pytest.mark.parametrize("cell", CELLS)
def test_head_codes_equal_the_program(root, cell):
    """Every code of every head, reference against ``Engine(device="cpu")``,
    at 64x64 on two frames, weights and ranges from one seed."""
    _, config = harness.cell_files(root, cell)
    ref = harness.reference(config)
    text = harness.cfg_text(config, 64)
    net = ref.parse(text)
    weights = inputs.float_params(net, 17, "cpu")
    ranges = harness.range_rule(config)(net)
    frames = inputs.frame_pool(1, 2, 64, 17, "cpu")[0]
    engine = system.engine(config, text, weights, ranges, "cpu")
    program = ref.convert(net, weights, ranges, "cpu")
    ours = ref.heads(program, frames)
    theirs = engine.raw_heads(frames)
    heads = [program.layers[i].dequant for i, layer in enumerate(net.layers)
             if layer.kind == "conv" and layer.quant_stop]
    assert len(ours) == len(theirs) == len(heads)
    for a, b, (s, z) in zip(ours, theirs, heads):
        codes_a = np.round(a.numpy() / s) + z
        codes_b = np.round(b.astype(np.float64) / s) + z
        assert np.array_equal(codes_a, codes_b)
        assert len(np.unique(codes_a)) > 20  # the heads are not saturated


def test_ranges_are_off_the_round_values(root):
    _, config = harness.cell_files(root, "tiny416-b128-closed")
    net = darknet_cfg.parse(harness.cfg_text(config, 416))
    r = inputs.ranges(net, "perturbed")
    assert r["input"] == {"min": 0.0, "max": 1.0}
    relu6 = [r[f"act_{i}"]["max"] for i, layer in enumerate(net.layers)
             if layer.kind == "conv" and layer.activation == "relu6"]
    assert all(0 < m < 6 for m in relu6) and len(set(relu6)) == len(relu6)
    assert r["act_20"]["min"] < -2.0 and r["act_20"]["max"] > 6.0  # the route over two layers


def test_inputs_follow_the_seed():
    net = darknet_cfg.parse("[net]\nwidth=32\nheight=32\n[convolutional]\nbatch_normalize=1\n"
                            "filters=4\nsize=3\npad=1\nactivation=leaky\nquantized=1\n")
    a, b = inputs.float_params(net, 2**33 + 5, "cpu"), inputs.float_params(net, 2**33 + 5, "cpu")
    c = inputs.float_params(net, 2**33 + 6, "cpu")
    assert all(np.array_equal(a[0][k], b[0][k]) for k in a[0])
    assert not np.array_equal(a[0]["w"], c[0]["w"])
    f = inputs.frame_pool(2, 3, 32, 7, "cpu")
    assert f.shape == (2, 3, 32, 32, 3) and f.dtype == torch.uint8
    assert torch.equal(f, inputs.frame_pool(2, 3, 32, 7, "cpu"))
    assert not torch.equal(f[0], f[1])


def test_candidates_hold_the_top_k(root):
    _, config = harness.cell_files(root, "tiny416-b128-closed")
    net = darknet_cfg.parse(harness.cfg_text(config, 64))
    weights = inputs.float_params(net, 3, "cpu")
    program = model.convert(net, weights, inputs.ranges(net, "perturbed"), "cpu")
    frames = inputs.frame_pool(1, 2, 64, 3, "cpu")[0]
    rows = model.candidates(program, frames, 20, 1e-5)
    boxes, obj, cls = model.answers(program, frames, 20)
    for n in range(2):
        assert rows[n].shape[0] >= 20 and rows[n].shape[1] == 4 + 1 + 5
        assert np.allclose(np.sort(rows[n][:, 4])[::-1][:20], obj[n], rtol=1e-6)
    assert dataclasses.is_dataclass(program)
