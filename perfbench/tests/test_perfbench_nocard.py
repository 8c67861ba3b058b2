"""The command refuses to run without the card, and without the port."""

import json
import shutil
import subprocess
import sys

import pytest

from perfbench import manifest

CMD = manifest.load()["command"]


def _run(cwd):
    return subprocess.run(
        [sys.executable, *CMD[1:], "--workload", "hpcg27.cg50", "--seed",
         str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def _no_result(out) -> bool:
    for line in out.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_a_run_without_a_card_exits_nonzero(no_card):
    out = _run(manifest.ROOT)
    assert out.returncode != 0 and _no_result(out)
    assert "CUDA" in out.stderr


def test_a_run_with_only_the_benchmark_exits_nonzero(tmp_path):
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and _no_result(out)
