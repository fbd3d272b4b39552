"""BENCHMARK.json against the forms its readers rely on, and every piece found by
name."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture
def manifest(root):
    return json.loads((root / "BENCHMARK.json").read_text())


def test_keys_names_and_units(manifest):
    assert set(manifest) == KEYS
    names = [m["name"] for group in ("configs", "workloads", "end_to_end", "per_layer")
             for m in manifest[group]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in manifest["workloads"]]:
        assert NAME.match(n), n
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in manifest["workloads"]] + [c["source"] for c in manifest["configs"]]
                 + [m["layer"] for m in manifest["per_layer"]] + manifest["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_piece_is_found_by_name(root, manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for w in manifest["workloads"]:
        cell, config = harness.cell_files(root, w["name"])
        assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"] and cell["why"] == w["why"]
        assert (root / "portbench" / "traffic" / f"{cell['traffic_kind']}.py").exists()
        assert "setup_s" in {m["name"] for m in harness.metrics_of(manifest, "end_to_end", w["name"])}
        assert harness.metrics_of(manifest, "per_layer", w["name"])
    for c in manifest["configs"]:
        config = json.loads((root / c["file"]).read_text())
        assert config["name"] == c["name"] and config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
    for m in manifest["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in e2e


def test_a_cell_added_as_files_is_picked_up(root, manifest, tmp_path):
    """A new cell needs its workload file and its entry in BENCHMARK.json,
    nothing else: run it on the CPU from a copy of the benchmark."""
    shutil.copytree(root / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cell = json.loads((root / "portbench/workloads/tiny416-b128-closed.json").read_text())
    cell.update(traffic="offline-b2", traffic_kind="offline",
                params={"batch": 2, "pool": 2, "in_flight": 2}, why="a cell added as files")
    (tmp_path / "portbench/workloads/tiny-added.json").write_text(json.dumps(cell))
    manifest["workloads"].append({"name": "tiny-added", "config": cell["config"],
                                  "traffic": "offline-b2", "chips": 1, "why": cell["why"]})
    for m in manifest["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append("tiny-added")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = ("import sys, time, json; sys.path[:0] = [sys.argv[1], sys.argv[2]];"
            "from pathlib import Path; from portbench import harness;"
            "r = harness.run_cell(Path(sys.argv[1]), 'tiny-added', 5, 1.0, False, 'cpu',"
            " time.perf_counter(), overrides={'size': 64});"
            "print(json.dumps({**r, 'harness': harness.__file__}))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(root)], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result.pop("harness").startswith(str(tmp_path))
    assert result["correct"] and result["metrics"]["images_per_s"]["value"] > 0
    assert set(result["metrics"]) == {"images_per_s", "setup_s"}


def test_run_refuses_without_a_card(root):
    """The command exits non-zero and prints no result where there is no
    CUDA card (this sandbox has none)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tiny416-b128-closed",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_without_the_program(root, tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, the
    command fails and prints no result."""
    shutil.copytree(root / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tiny416-b128-closed",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_end_to_end_metrics_count_the_window():
    from portbench.record import Request

    t0 = 100.0
    records = [Request(i, 0, 8, t0 + i, t0 + i + 0.1, t0 + i + 0.5 + 0.01 * i, None)
               for i in range(20)]
    # answers back by t0 + 10: requests 0..9 (request 9 is back at t0 + 9.59)
    assert harness.images_per_s(records, t0, 10.0) == 8 * 10 / 10.0
    # nearest rank: the 19th of 20 latencies, 0.5 + 0.18 s
    assert harness.latency_p95_ms(records, t0, 10.0) == pytest.approx(680.0)
    failed = records[:19] + [records[19]._replace(error="boom")]
    assert harness.latency_p95_ms(failed, t0, 10.0) == pytest.approx(680.0)
    assert harness.latency_p95_ms(failed[:10] + [r._replace(error="x") for r in failed[10:]],
                                  t0, 10.0) == float("inf")
