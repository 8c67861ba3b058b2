"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to files of its own."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert (manifest.ROOT / BENCH["command"][1]).is_file()
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda e: e["name"])
def test_config_resolves(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("perfbench/configs/")
    data = manifest.config(BENCH, cfg["name"])
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert callable(manifest.case_module(data["case"]).make)
    for key in cfg["reduced"]:
        assert NAME.match(key)
        assert data[key] != data["published"][key]
    assert data["limits"] and all(v > 0 for v in data["limits"].values())
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    manifest.config(BENCH, cell["config"])
    loop = manifest.traffic(cell["traffic"])["loop"]
    assert callable(manifest.loop_module(loop).make)
    e2e = {m["name"] for m in manifest.end_to_end(BENCH, cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.per_layer(BENCH, cell["name"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


@pytest.mark.parametrize("metric", METRICS, ids=lambda e: e["name"])
def test_metric_has_a_reader(metric):
    assert callable(manifest.reader(metric["name"]))
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda e: e["name"])
def test_end_to_end_bounds(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_per_layer_moves_what_its_cells_report(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    for cell in metric["workloads"]:
        reported = {m["name"] for m in manifest.end_to_end(BENCH, cell)}
        assert metric["moves"] in reported


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (manifest.ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"| {layer} |" in perf


def test_a_new_cell_is_found_by_name(tmp_path):
    """A cell that only adds entries resolves through the same lookups."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "m2head.cg50-like", "chips": 1,
                               "config": "hpcg-27pt.64", "traffic": "cg50",
                               "why": "x"})
    bench["per_layer"].append({"name": "setup_s", "unit": "s",
                               "better": "lower", "source": "host_clock",
                               "layer": "x", "moves": "setup_s"})
    names = [m["name"] for m in manifest.per_layer(bench, "m2head.cg50-like")]
    assert names == ["setup_s"]
    assert [m["name"] for m in manifest.end_to_end(
        bench, "m2head.cg50-like")] == ["device_mib", "setup_s"]


TAGGED_LOOP = """
from perfbench.loops.calls import Calls


class Tagged(Calls):
    def run(self, subject, seconds):
        return dict(super().run(subject, seconds), loop="tagged")


make = Tagged
"""

RUN_TAGGED = """
import json, sys
sys.path[:0] = ['.', sys.argv[1]]
from perfbench import harness, manifest
b = manifest.load()
cfg = dict(manifest.config(b, 'mamba2-130m.head'), d_model=64,
           padded_vocab_size=600)
out = harness.run_cell('m2head.tagged', 5, 0.2, False, device='cpu',
                       bench=b, config=cfg, log=lambda *a: None)
print(json.dumps({'correct': out['correct'], 'loop': out['run'].get('loop'),
                  'metrics': sorted(out['metrics'])}))
"""


def test_a_new_loop_is_found_by_name(tmp_path):
    """A mix that names a loop module of its own runs from a copy of the
    benchmark in which that module, the mix and the cell were only added."""
    shutil.copytree(manifest.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "perfbench" / "loops" / "tagged.py").write_text(TAGGED_LOOP)
    mix = dict(manifest.traffic("b64.cold"), loop="tagged", batch=8,
               batches=4, flush_mib=1)
    (tmp_path / "perfbench" / "traffic" / "tagged.json").write_text(
        json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "m2head.tagged", "chips": 1,
                               "config": "mamba2-130m.head",
                               "traffic": "tagged", "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "-c", RUN_TAGGED, str(manifest.ROOT / "src")],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "loop": "tagged",
                   "metrics": ["setup_s"]}
