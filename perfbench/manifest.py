"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names its configuration and its traffic
mix. The configuration's entry names its JSON file, and that file names
its case, ``cases/<case>.py``. The mix is ``traffic/<name>.json``, whose
``"loop"`` names the code that drives the subject, ``loops/<loop>.py``.
A metric, end to end or per layer, is read by ``metrics/<name>.py``, whose
``read(run)`` returns a number or None. Adding a configuration, a mix, a
metric or a cell adds files and entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(manifest: dict, name: str) -> dict:
    return _by_name(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str) -> dict:
    """The configuration's file, as run."""
    entry = _by_name(manifest["configs"], name, "config")
    return json.loads((ROOT / entry["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def case_module(name: str):
    return importlib.import_module(f"perfbench.cases.{name}")


def loop_module(name: str):
    return importlib.import_module(f"perfbench.loops.{name}")


def reader(metric: str):
    """``read(run)`` of ``metrics/<metric>.py`` (loaded by path: a metric's
    name may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _reports(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(manifest: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics a cell reports."""
    return [m for m in manifest["end_to_end"] if _reports(m, cell_name)]


def per_layer(manifest: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    that list no cells and move an end-to-end metric the cell reports."""
    moves = {m["name"] for m in end_to_end(manifest, cell_name)}
    return [m for m in manifest["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]
