"""The port's command line, in-process on the CPU (``--device cpu``), as a
user runs it: train -> export / export-program -> detect, f1, recall,
valid, weights-tool and demo; the same ``.weights`` file through the JAX
package's CLI gives the same ``valid`` files, mAP and ``detect`` boxes; the
parser has the JAX parser's subcommands and options (plus ``--device``,
and ``bench``'s own); ``bench`` runs (``tools/bench.py``)."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_native import jax_binding_whole
from test_torch_valid import assert_same_rows, make_dataset, read_rows
from yolo_quantization_tpu_torch.cli.main import build_parser, main

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def jax_binding():
    """The JAX binding holds the whole native library (``test_torch_native``)."""
    with jax_binding_whole():
        yield
MODEL = ["--model", "yolov3-tiny", "--size", "64", "--classes", "5"]
CPU = [*MODEL, "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two QAT steps through the CLI (ranges frozen after the first, the
    multiscale schedule on), then the checkpoint exported both ways."""
    root = str(tmp_path_factory.mktemp("cli"))
    lst = make_dataset(root, n=4)
    backup = os.path.join(root, "backup")
    main(["train", *CPU, "--train-list", lst, "--backup-dir", backup, "--batch-size", "2",
          "--max-batches", "2", "--workers", "2", "--quant-start", "0",
          "--freeze-ranges-after", "1", "--multiscale"])
    weights, program = os.path.join(root, "m.weights"), os.path.join(root, "m.npz")
    main(["export", *CPU, "--ckpt", backup, "--out", weights])
    main(["export-program", *CPU, "--ckpt", backup, "--out", program])
    return root, lst, backup, weights, program


def test_train_and_export(trained, capsys):
    root, lst, backup, weights, program = trained
    assert sorted(os.listdir(backup)) == ["2"]
    assert os.path.getsize(weights) > 1000 and os.path.getsize(program) > 1000
    main(["export-program", *CPU, "--weights", weights, "--out", os.path.join(root, "w.npz")])
    assert "wrote integer program" in capsys.readouterr().out
    from yolo_quantization_tpu_torch.models.darknet_weights import load_darknet_weights
    from yolo_quantization_tpu_torch.models.zoo import yolov3_tiny

    ck = load_darknet_weights(weights, yolov3_tiny(classes=5, width=64, height=64))
    assert ck.seen == 4 and ck.raw_quant  # two steps of two images, quantized layout


def test_detect_from_each_weight_source(trained, capsys):
    root, lst, backup, weights, program = trained
    image = open(lst).read().split()[0]
    printed = []
    for src in (["--weights", weights], ["--ckpt", backup], ["--program", program]):
        out = os.path.join(root, f"det_{src[0][2:]}.png")
        main(["detect", *CPU, *src, "--image", image, "--thresh", "0.3", "--out", out])
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].startswith(f"{image}: predicted in") and f"wrote {out}" in lines[-1]
        printed.append(lines[1:-1])
        assert os.path.getsize(out) > 100
    assert printed[0] == printed[1] == printed[2] and printed[0]


def test_f1_recall_weights_tool_and_demo(trained, capsys):
    root, lst, backup, weights, program = trained
    main(["f1", *CPU, "--program", program, "--test-list", lst,
          "--out", os.path.join(root, "f1.txt")])
    out = capsys.readouterr().out
    assert "thresh 0.1" in out and "best:" in out
    assert len(open(os.path.join(root, "f1.txt")).read().splitlines()) == 6
    main(["f1", *CPU, "--program", program, "--test-list", lst, "--max-images", "2",
          "--eval-size", "96"])
    assert "best:" in capsys.readouterr().out
    main(["recall", *CPU, "--weights", weights, "--test-list", lst])
    assert re.search(r"recall [\d.]+%  avg IoU [\d.]+%  RPs/img [\d.]+  truths 7", capsys.readouterr().out)
    main(["weights-tool", *CPU, "--weights", weights, "--op", "stats"])
    assert "layer   0" in capsys.readouterr().out
    main(["weights-tool", *CPU, "--weights", weights, "--op", "print", "--layer", "0"])
    assert capsys.readouterr().out.strip()
    frames = os.path.join(root, "images")
    out_dir = os.path.join(root, "demo_out")
    main(["demo", *CPU, "--program", program, "--frames", frames, "--out-dir", out_dir,
          "--batch-size", "2", "--thresh", "0.3"])
    assert re.search(r"^4 frames in .* batches, avg fill", capsys.readouterr().out, re.M)
    assert sorted(os.listdir(out_dir)) == sorted(os.listdir(frames))


def _run_valid(fn, extra, weights, lst, out_dir, capsys):
    for fmt in ("voc", "coco", "imagenet"):
        fn(["valid", *MODEL, *extra, "--weights", weights, "--test-list", lst, "--format", fmt,
            "--out-dir", out_dir, *(["--map"] if fmt == "voc" else [])])
    printed = capsys.readouterr().out
    return [(m.group(1), float(m.group(2))) for m in re.finditer(r"AP (\S+): ([\d.]+)", printed)], \
        float(re.search(r"mAP@0.5 = ([\d.]+)", printed).group(1))


def test_valid_and_detect_match_the_jax_cli(trained, capsys):
    """A .weights file the port wrote, through both CLIs."""
    from test_torch_valid import coco_rows

    from yolo_quantization_tpu.cli.main import main as jmain

    root, lst, backup, weights, program = trained
    res = {}
    for name, fn, extra in (("jax", jmain, []), ("torch", main, ["--device", "cpu"])):
        res[name] = _run_valid(fn, extra, weights, lst, os.path.join(root, f"valid_{name}"), capsys)
    assert [a for a, _ in res["torch"][0]] == [a for a, _ in res["jax"][0]]
    for (_, a), (_, b) in zip(res["torch"][0], res["jax"][0]):
        assert abs(a - b) <= 0.01  # printed in percent to 2 decimals
    assert abs(res["torch"][1] - res["jax"][1]) <= 0.01
    n = 0
    for c in range(5):
        got = read_rows(os.path.join(root, "valid_torch", f"comp4_det_test_class{c}.txt"), 1)
        want = read_rows(os.path.join(root, "valid_jax", f"comp4_det_test_class{c}.txt"), 1)
        assert_same_rows(got, want)
        n += len(got)
    assert n > 20
    assert_same_rows(read_rows(os.path.join(root, "valid_torch", "imagenet-detection.txt"), 2),
                     read_rows(os.path.join(root, "valid_jax", "imagenet-detection.txt"), 2))
    assert_same_rows(coco_rows(os.path.join(root, "valid_torch", "coco_results.json")),
                     coco_rows(os.path.join(root, "valid_jax", "coco_results.json")))
    image = open(lst).read().split()[0]
    boxes = {}
    for name, fn, extra in (("jax", jmain, []), ("torch", main, ["--device", "cpu"])):
        fn(["detect", *MODEL, *extra, "--weights", weights, "--image", image, "--thresh", "0.3"])
        boxes[name] = capsys.readouterr().out.splitlines()[1:]
    assert boxes["torch"] == boxes["jax"] and boxes["torch"]


def _options(parser):
    subs = next(a for a in parser._actions if a.dest == "command").choices
    return {name: {s for a in sp._actions for s in a.option_strings} for name, sp in subs.items()}


def test_parser_has_the_jax_subcommands_and_options():
    from yolo_quantization_tpu.cli.main import build_parser as jbuild_parser

    got, want = _options(build_parser()), _options(jbuild_parser())
    assert set(got) == set(want) == {"train", "detect", "f1", "export", "export-program", "recall",
                                     "valid", "weights-tool", "demo", "bench"}
    bench_options = {"--v3", "--batches", "--more-batches", "--size", "--chain", "--device"}
    for name in want:
        extra = {"--device"} if name != "bench" else bench_options
        assert got[name] == want[name] | extra, name
    subs = next(a for a in build_parser()._actions if a.dest == "command").choices
    for name in ("export", "export-program", "detect"):
        ckpt = next(a for a in subs[name]._actions if "--ckpt" in a.option_strings)
        assert "checkpoint directory" in ckpt.help  # the port's, not Orbax


@pytest.mark.parametrize("argv,item", [
    (["train", *CPU, "--data-parallel"], "DP over 1 devices (cpu)"),
    (["train", *CPU, "--fsdp"], "FSDP over 1 devices: 100.0% of param bytes sharded"),
    (["bench"], "1.13"),
])
def test_unported_parts_exit_naming_the_roadmap(argv, item, trained, tmp_path, capsys):
    """Every part is ported now.  ``bench`` (ROADMAP 1.13) no longer exits
    naming its item: it runs, here on the CPU at 64x64, and prints
    ``bench.py``'s JSON line (``tests/test_torch_bench.py`` holds its
    fields).  ``train --data-parallel`` and ``--fsdp``: without torchrun
    the process group is this one process, which trains two steps, prints
    the JAX CLI's lines (the FSDP report too), checkpoints and leaves no
    group behind (the two-rank cases are in ``test_torch_distributed.py``)."""
    if argv[0] == "bench":
        main([*argv, "--device", "cpu", "--size", "64", "--batches", "2", "--more-batches", "", "--chain", "2"])
        out = capsys.readouterr().out
        assert f"ROADMAP queue {item}" not in out
        line = json.loads(out.strip().splitlines()[-1])
        assert line["conv_path"] == "k1" and line["batch"] == 2 and line["device"] == "cpu"
        return
    import torch.distributed as dist

    _, lst, _, _, _ = trained
    main([*argv, "--train-list", lst, "--backup-dir", str(tmp_path), "--batch-size", "2",
          "--max-batches", "2", "--workers", "2", "--quant-start", "1"])
    out = capsys.readouterr().out
    assert item in out and "2: loss" in out and "training done" in out, out
    assert sorted(os.listdir(tmp_path)) == ["2"] and not dist.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the failure where there is no GPU")
def test_the_gpu_is_the_default_device(trained):
    _, lst, _, weights, _ = trained
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["detect", *MODEL, "--weights", weights, "--image", open(lst).read().split()[0]])


def test_entry_point_runs_with_jax_blocked():
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['yolo_quantization_tpu'] = None\n"
            "sys.argv = ['cli', '--help']\n"
            "runpy.run_module('yolo_quantization_tpu_torch.cli', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=120)
    assert proc.returncode == 0, proc.stderr
    for sub in ("train", "detect", "valid", "demo", "bench"):
        assert sub in proc.stdout
    proc = subprocess.run([sys.executable, "-m", "yolo_quantization_tpu_torch.cli", "--help"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "export-program" in proc.stdout
