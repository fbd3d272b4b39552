"""A configuration brings its own reference, range rule and program options
as files, found by name: on the CPU, at small sizes, in a copy of the
benchmark (``harness.HERE`` pointed at it) or a run from one."""

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import harness, inputs, system
from portbench.reference import darknet_cfg, model

TINY = "tiny416-b128-closed"

# the default reference with every reference box moved by 0.01 of the width
SHIFTED = '''
from portbench.reference import darknet_cfg, model

parse, convert, heads, answers = darknet_cfg.parse, model.convert, model.heads, model.answers


def candidates(program, frames, max_det, tie, block=16):
    rows = model.candidates(program, frames, max_det, tie, block)
    for r in rows:
        r[:, 0] += 0.01
    return rows
'''

# every function but candidates
PARTIAL = '''
from portbench.reference import darknet_cfg, model

parse, convert, heads, answers = darknet_cfg.parse, model.convert, model.heads, model.answers
'''

# rebinds a function of the default reference
REBINDS = SHIFTED + '''
model.decode = None
'''

# perturbed ranges, halved
HALVED = '''
from portbench import inputs


def ranges(net):
    return {k: {"min": v["min"] / 2, "max": v["max"] / 2}
            for k, v in inputs.ranges(net, "perturbed").items()}
'''


class Copy:
    """A copy of the benchmark and BENCHMARK.json under ``root``, with
    pieces added as files."""

    def __init__(self, repo, root):
        self.root = root
        shutil.copytree(repo / "portbench", root / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__", "tests"))
        self.manifest = json.loads((repo / "BENCHMARK.json").read_text())
        self.write_manifest()

    def write_manifest(self):
        (self.root / "BENCHMARK.json").write_text(json.dumps(self.manifest))

    def add(self, folder: str, name: str, text: str):
        (self.root / "portbench" / folder / name).write_text(text)

    def add_cell(self, name: str, **config_keys) -> str:
        """A copy of the tiny cell and its configuration, named ``name``, the
        configuration given ``config_keys``; in BENCHMARK.json with
        ``latency_p95_ms``."""
        base = self.root / "portbench"
        cell = json.loads((base / f"workloads/{TINY}.json").read_text())
        config = json.loads((base / f"configs/{cell['config']}.json").read_text())
        config.update(name=name, **config_keys)
        cell.update(config=name, traffic=f"{name}-closed", why=f"{name}, added as files")
        self.add("configs", f"{name}.json", json.dumps(config))
        self.add("workloads", f"{name}.json", json.dumps(cell))
        self.manifest["configs"].append({"name": name, "source": config["source"],
                                         "file": f"portbench/configs/{name}.json",
                                         "reduced": [], "why": cell["why"]})
        self.manifest["workloads"].append({"name": name, "config": name, "traffic": cell["traffic"],
                                           "chips": 1, "why": cell["why"]})
        for m in self.manifest["end_to_end"] + self.manifest["per_layer"]:
            if TINY in m.get("workloads", []):
                m["workloads"].append(name)
        self.write_manifest()
        return name


@pytest.fixture
def copy(root, tmp_path, monkeypatch):
    c = Copy(root, tmp_path)
    monkeypatch.setattr(harness, "HERE", tmp_path / "portbench")
    return c


@pytest.fixture
def engine_calls(monkeypatch):
    """Every call of ``system.engine``; the spy builds nothing."""
    calls = []

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        raise AssertionError("the program was built")
    monkeypatch.setattr(system, "engine", spy)
    return calls


def bindings():
    return {m.__name__: dict(vars(m)) for m in (darknet_cfg, model)}


def test_no_reference_key_is_the_default_itself(root):
    _, config = harness.cell_files(root, TINY)
    assert "reference" not in config
    ref = harness.reference(config)
    assert ref.parse is darknet_cfg.parse
    assert ref.convert is model.convert
    assert ref.heads is model.heads
    assert ref.candidates is model.candidates
    assert ref.answers is model.answers
    assert ref.answer_count is harness.yolo_answer_count


def test_a_reference_added_as_files_judges_the_cell(root, tmp_path):
    """A configuration naming a reference that moves every box by 0.01:
    the run reads a ``det_gap`` of 0.01 and ``correct`` false, so ``judge``
    took the named module."""
    c = Copy(root, tmp_path)
    c.add("reference", "shifted.py", SHIFTED)
    cell = c.add_cell("tiny-shifted", reference="shifted")
    code = ("import sys, time, json; sys.path[:0] = [sys.argv[1], sys.argv[2]];"
            "from pathlib import Path; from portbench import harness;"
            f"r = harness.run_cell(Path(sys.argv[1]), {cell!r}, 5, 1.0, False, 'cpu',"
            " time.perf_counter(), overrides={'size': 64, 'batch': 2, 'pool': 2});"
            "print(json.dumps({**r, 'harness': harness.__file__}))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(root)],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result.pop("harness").startswith(str(tmp_path))
    assert result["failed"] == 0 and result["sampled"] > 0
    # 0.01 less the program's own rounding, below 1e-6
    assert result["checks"]["det_gap"]["value"] >= 0.01 - 1e-6
    assert not result["correct"]


@pytest.mark.parametrize("module", [None, "partial"])
def test_a_missing_reference_stops_the_run_before_the_build(copy, engine_calls, module):
    name = "absent" if module is None else module
    if module is not None:
        copy.add("reference", f"{module}.py", PARTIAL)
    cell = copy.add_cell(f"tiny-{name}", reference=name)
    with pytest.raises(SystemExit, match=f"portbench/reference/{name}.py") as stop:
        harness.run_cell(copy.root, cell, 5, 1.0, False, "cpu", time.perf_counter(),
                         overrides={"size": 64, "batch": 2, "pool": 2})
    assert ("is missing" if module is None else "has no candidates") in str(stop.value)
    assert engine_calls == []


def test_options_reach_the_program(root, monkeypatch):
    """``convert`` and ``engine`` reach the program's entry points as given,
    beside ``weights`` (here the asymmetric scheme) and ``max_det``."""
    from yolo_quantization_tpu_torch.infer import convert as convert_module
    from yolo_quantization_tpu_torch.infer import engine as engine_module

    _, config = harness.cell_files(root, TINY)
    config.update(weights="asymmetric_per_channel_uint8", convert={"route_rescale": False},
                  engine={"dynamic_input": True, "exact_leaky": True})
    seen = {}

    def convert_spy(net, params, ranges, **kwargs):
        seen["convert"] = kwargs
        return "program"

    def engine_spy(program, **kwargs):
        seen["engine"] = (program, kwargs)
    monkeypatch.setattr(convert_module, "convert", convert_spy)
    monkeypatch.setattr(engine_module, "Engine", engine_spy)
    text = harness.cfg_text(config, 64)
    system.engine(config, text, {}, {}, "cpu")
    assert seen["convert"] == {"route_rescale": False, "symmetric_weights": False}
    assert seen["engine"] == ("program", {"max_det": config["max_det"], "device": "cpu",
                                          "dynamic_input": True, "exact_leaky": True})


def test_options_build_the_program(root):
    """The same options, taken by the program itself."""
    _, config = harness.cell_files(root, TINY)
    config.update(engine={"exact_leaky": True, "fuse_pool": False})
    text = harness.cfg_text(config, 64)
    net = darknet_cfg.parse(text)
    engine = system.engine(config, text, inputs.float_params(net, 3, "cpu"),
                           inputs.ranges(net, config["ranges"]), "cpu")
    assert engine.options["exact_leaky"] is True and engine.options["fuse_pool"] is False


@pytest.mark.parametrize("keys", [{"convert": {"symmetric_weights": False}},
                                  {"engine": {"max_det": 7}},
                                  {"engine": ["dynamic_input"]},
                                  {"weights": "per_tensor_int4"}])
def test_an_option_set_elsewhere_is_refused(copy, keys):
    """By ``cell_files``, naming the configuration's file, and by
    ``system.engine`` before it reads the .cfg."""
    cell = copy.add_cell("tiny-clash", **keys)
    with pytest.raises(SystemExit, match="portbench/configs/tiny-clash.json"):
        harness.cell_files(copy.root, cell)
    _, config = harness.cell_files(copy.root, TINY)
    with pytest.raises(ValueError):
        system.engine({**config, **keys}, "not a cfg", {}, {}, "cpu")


def test_a_range_rule_added_as_files_is_picked_up(copy):
    copy.add("ranges", "halved.py", HALVED)
    cell, config = harness.cell_files(copy.root, copy.add_cell("tiny-halved", ranges="halved"))
    ref = harness.reference(config)
    _, _, net, _, ranges, _ = harness.cell_inputs(ref, cell, config, 5, "cpu",
                                                  {"size": 64, "batch": 2, "pool": 2})
    perturbed = inputs.ranges(net, "perturbed")
    assert ranges.keys() == perturbed.keys()
    for key, r in ranges.items():
        assert r == {"min": perturbed[key]["min"] / 2, "max": perturbed[key]["max"] / 2}
        assert isinstance(r["min"], np.float32)
    with pytest.raises(SystemExit, match="portbench/ranges/absent.py is missing"):
        harness.cell_files(copy.root, copy.add_cell("tiny-absent", ranges="absent"))


def test_a_named_reference_rebinds_nothing(copy):
    """Loading a named reference leaves every name of ``darknet_cfg`` and
    ``model`` bound as before; a module that rebinds one is refused and the
    binding restored."""
    before = bindings()
    copy.add("reference", "shifted.py", SHIFTED)
    ref = harness.reference({"reference": "shifted"})
    assert ref.candidates is not model.candidates and ref.parse is darknet_cfg.parse
    after = bindings()
    assert after.keys() == before.keys()
    for name in before:
        assert after[name].keys() == before[name].keys()
        assert all(after[name][k] is v for k, v in before[name].items()), name
    copy.add("reference", "rebinds.py", REBINDS)
    with pytest.raises(SystemExit, match=r"portbench/reference/rebinds.py rebinds .*decode"):
        harness.reference({"reference": "rebinds"})
    assert model.decode is before[model.__name__]["decode"]
