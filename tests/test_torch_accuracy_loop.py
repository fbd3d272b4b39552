"""The port's synthetic accuracy loop (``tools/synthetic_accuracy_loop.py``)
against ``examples/synthetic_accuracy_loop.py``, on the CPU.

The dataset is the example's byte for byte (JPEGs, label files, list
file).  The loop runs its stages at 4 steps (2 float, 2 EMA-QAT) and prints
the example's lines in the example's formats; at 4 steps the F1s are
noise, so the 0.5 check of ``main`` is exercised with given rows.  The
400-step loop, whose check must hold, runs on the card (``chip_smoke.py``
phase 20).
"""

import ast
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from yolo_quantization_tpu_torch.eval.f1 import F1Row
from yolo_quantization_tpu_torch.tools import synthetic_accuracy_loop as L

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "synthetic_accuracy_loop.py"


@pytest.fixture(scope="module")
def example():
    """The JAX example as a module, its ``main`` not run."""
    spec = importlib.util.spec_from_file_location("jax_synthetic_accuracy_loop", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def print_formats(path: Path) -> list[str]:
    """The source of every f-string a module prints, in order."""
    tree = ast.parse(path.read_text())
    return [ast.unparse(node.args[0]) for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "print"
            and node.args and isinstance(node.args[0], ast.JoinedStr)]


def tree_bytes(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_make_dataset_writes_the_examples_bytes(example, tmp_path):
    ours = L.make_dataset(str(tmp_path / "port"))
    theirs = example.make_dataset(str(tmp_path / "jax"))
    got, want = tree_bytes(tmp_path / "port"), tree_bytes(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 2 * 16 + 1
    for name in want:
        if name != "list.txt":
            assert got[name] == want[name], name
    # the list file names each set's own paths, in the same order
    assert Path(ours).read_text() == Path(theirs).read_text().replace(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_prints_the_examples_lines():
    want = print_formats(EXAMPLE)
    got = print_formats(Path(L.__file__))
    assert len(want) == 4 and got == want


def test_the_loop_runs_its_stages_on_the_cpu(tmp_path, capsys):
    list_file = L.make_dataset(str(tmp_path))
    trainer = L.train(list_file, 4, "cpu")
    assert trainer.state.step == 4 and trainer.cfg.quant_start_step == 2
    assert (trainer.net.width, trainer.net.height) == (96, 96) and trainer.cfg.batch_size == 4
    int_best, float_best = L.evaluate(trainer, list_file)
    gap = L.quantization_cost(int_best, float_best)
    assert isinstance(int_best, F1Row) and isinstance(float_best, F1Row)
    assert int_best.tp_fn == float_best.tp_fn == 16  # one truth per image
    assert gap == abs(int_best.f1 - float_best.f1)
    lines = capsys.readouterr().out.strip().splitlines()
    num = r"\d+\.\d"
    assert re.fullmatch(r"step 0: loss -?\d+\.\d{3} \(\d+s\)", lines[0]), lines[0]
    assert re.fullmatch(rf"integer engine: recall {num} precision {num} F1 {num}", lines[1]), lines[1]
    assert re.fullmatch(rf"float engine:   recall {num} precision {num} F1 {num}", lines[2]), lines[2]
    assert re.fullmatch(r"quantization F1 cost: \d+\.\d{2} \(target: <= 0\.5, BASELINE\.md\)", lines[3]), lines[3]
    assert len(lines) == 4


@pytest.mark.parametrize("f1s,passes", [((80.0, 80.4), True), ((80.0, 80.6), False), ((80.6, 80.0), False)])
def test_main_checks_the_gap_both_ways(monkeypatch, f1s, passes):
    """|integer - float| <= 0.5, as the example's ``abs``; main returns both
    rows."""
    def row(f1):  # tp / (tp_fp + tp_fn) / 2 = f1 / 100
        return F1Row(0.5, int(f1 * 10), 1000, 1000, 0.5)

    monkeypatch.setattr(L, "make_dataset", lambda root: str(Path(root) / "list.txt"))
    monkeypatch.setattr(L, "train", lambda list_file, steps, device: None)
    monkeypatch.setattr(L, "evaluate", lambda trainer, list_file: (row(f1s[0]), row(f1s[1])))
    if passes:
        int_best, float_best = L.main(4, "cpu")
        assert (int_best.f1, float_best.f1) == pytest.approx(f1s)
    else:
        with pytest.raises(AssertionError, match="more than 0.5 F1"):
            L.main(4, "cpu")


def test_the_loop_raises_without_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        L.train(L.make_dataset(str(tmp_path)), 1, "cuda")
