"""What decides ``correct``, at sizes a test run holds, on the CPU: the
port's run passes, the control (the reference in the next lower
precision) fails, and so does a run whose timed path is broken
underneath. The harness's look for a card is skipped (``device="cpu"``);
the rest of a run is the command's. On the card, the control at each
cell's own size (``gpu``-marked)."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness, manifest

BENCH = manifest.load()
HEAD = dict(manifest.config(BENCH, "mamba2-130m.head"), d_model=64,
            padded_vocab_size=600)
HEAD_MIX = dict(manifest.traffic("b64.cold"), batch=8, batches=4,
                flush_mib=1)
HPCG = dict(manifest.config(BENCH, "hpcg-27pt.64"), nx=12, ny=12, nz=12)
HPCG_MIX = dict(manifest.traffic("cg50"), iterations=10)
CASES = {"m2head.b64.cold": (HEAD, HEAD_MIX), "hpcg27.cg50": (HPCG, HPCG_MIX)}


def _run(cell, subject="program", seed=2 ** 31 + 3):
    cfg, mix = CASES[cell]
    return harness.run_cell(cell, seed, 0.2, False, device="cpu",
                            bench=BENCH, config=cfg, traffic=mix,
                            subject=subject, log=lambda *a: None)


@pytest.mark.parametrize("cell", sorted(CASES))
def test_the_port_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and set(out["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("cell", sorted(CASES))
def test_the_control_is_not_correct(cell):
    out = _run(cell, subject="control")
    assert not out["correct"], out["checks"]


def _spmm_faults():
    last = []

    def unchanged(y):
        """The output of the first call handed back by every later one."""
        if not last:
            last.append(y.clone())
        return last[0].clone()

    def altered(y):
        y[7, 3] = -y[7, 3]
        return y

    def half_left_out(y):
        y[:, y.shape[1] // 2:] = 0
        return y
    return {"altered": altered, "half_left_out": half_left_out,
            "unchanged": unchanged}


def _spmv_faults():
    def altered(y):
        y[y.shape[0] // 2] *= 1 + 1e-6
        return y
    return {"altered": altered}


@pytest.mark.parametrize("fault", sorted(_spmm_faults()))
def test_a_broken_multiply_is_not_correct(monkeypatch, fault):
    from repro_torch.kernels import ops
    spmm, broken = ops.spmm, _spmm_faults()[fault]     # a fresh fault a test
    monkeypatch.setattr(ops, "spmm", lambda *a, **k: broken(spmm(*a, **k)))
    assert not _run("m2head.b64.cold")["correct"]


@pytest.mark.parametrize("fault", ["altered", "unchanged"])
def test_a_broken_solver_step_is_not_correct(monkeypatch, fault):
    from repro_torch.kernels import ops
    spmv = ops.spmv
    if fault == "unchanged":
        def broken(mat, v, *a, **k):
            return v.clone()                # the state handed back as is
    else:
        def broken(*a, **k):
            return _spmv_faults()["altered"](spmv(*a, **k))
    monkeypatch.setattr(ops, "spmv", broken)
    assert not _run("hpcg27.cg50")["correct"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CASES))
def test_the_control_fails_at_the_cells_size_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "perfbench/control.py", "--workload", cell,
         "--seeds", "11", "12", "13", "--seconds", "1"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert len(rows) == 3 and not any(r["correct"] for r in rows)
