"""The JAX package's last entry-point arguments in the port: ``tile_mode``
and ``vmem_budget`` on the SpMM entries, ``tile_mode`` on the sharded SpMM
and the registry's runners, and the dry-run's ``--save-hlo``.

* Every keyword the reference's ``ops.spmm`` / ``sell_spmm`` /
  ``rgcsr_spmm`` / ``bcsr_spmm``, ``shard_ops.shard_spmm``,
  ``FormatSpec.spmm_runner`` / ``spmm`` / ``shard_runner`` and
  ``dryrun.run_cell`` take (but ``interpret``, the JAX package's own) is a
  keyword of the port's counterpart.
* Every ``tile_mode``, and a ``vmem_budget`` that forces 1, 2 and 8 column
  tiles of a batch of 8 (recorded in ``kernels.col_tiles``), gives bitwise
  the default result, through the ops entries, the sharded SpMM and every
  registered format's runners; a budget never tiles wider than the
  kernels' widest tile.
* An unknown ``tile_mode`` raises ``ValueError`` with the reference's
  message, wherever it is taken.
* The dry-run writes a smoke cell's op trace on a fake (2, 2) group (in a
  subprocess: no pytest worker holds a process group), and the trace's
  collective lines count exactly the record's collectives.
"""

import gzip
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core.csr_dtans import encode_matrix
from repro_torch.kernels import bcsr_spmv as BC
from repro_torch.kernels import ops, rgcsr_spmv as RG, sell_spmv as SE
from repro_torch.kernels import shard_ops, tiling
from repro_torch.launch import dryrun
from repro_torch.sparse import registry
from repro_torch.sparse.bcsr import BCSR
from repro_torch.sparse.formats import CSR
from repro_torch.sparse.rgcsr import RGCSR

B = 8
FORMATS = ("dtans", "sell", "rgcsr", "bcsr")


def _matrix(dtype) -> CSR:
    rng = np.random.default_rng(28)
    d = rng.standard_normal((70, 40)) * (rng.random((70, 40)) < 0.2)
    return CSR.from_dense(np.round(d, 1).astype(dtype))


_PACKS: dict = {}


def packs(dtype) -> dict:
    """fmt -> (its SpMM entry, a pack of `_matrix`, the matrix)."""
    key = np.dtype(dtype).name
    if key not in _PACKS:
        a = _matrix(dtype)
        _PACKS[key] = {
            "dtans": (ops.spmm, encode_matrix(a, lane_width=32), a),
            "sell": (ops.sell_spmm, SE.pack_sell(a, 32), a),
            "rgcsr": (ops.rgcsr_spmm, RG.pack_rgcsr(RGCSR.from_csr(a, 8)),
                      a),
            "bcsr": (ops.bcsr_spmm, BC.pack_bcsr(BCSR.from_csr(a, (2, 2))),
                     a)}
    return _PACKS[key]


def _device(fmt, pk):
    if fmt == "dtans":
        from repro_torch.kernels.pack import to_device
        return to_device(ops.get_packed(pk), "cpu")
    mod = {"sell": SE, "rgcsr": RG, "bcsr": BC}[fmt]
    return mod.to_device(pk, "cpu")


def _budget(fmt, d, bt: int) -> int:
    """Shared-memory bytes of a tile of ``bt`` columns of ``d``'s SpMM (0:
    none, below a column's)."""
    item = d.dtype.itemsize
    if bt == 0:
        return 0
    if fmt == "dtans":
        T = int(d.tab_symbol.shape[0])
        return (tiling.spmm_fixed_bytes(T, d.lane_width, item, d.params)
                + bt * tiling.unit_rows(d.lane_width) * item)
    return tiling.padded_geometry(d.rows, d.shape[1], B, bt, item).smem


def test_the_references_keywords_are_the_ports():
    from repro.kernels import ops as r_ops
    from repro.kernels import shard_ops as r_shard
    from repro.launch import dryrun as r_dryrun
    from repro.sparse import registry as r_reg
    pairs = [(r_ops.spmm, ops.spmm), (r_ops.sell_spmm, ops.sell_spmm),
             (r_ops.rgcsr_spmm, ops.rgcsr_spmm),
             (r_ops.bcsr_spmm, ops.bcsr_spmm),
             (r_shard.shard_spmm, shard_ops.shard_spmm),
             (r_dryrun.run_cell, dryrun.run_cell)]
    for name in ("spmm_runner", "spmm", "shard_runner"):
        for fmt in registry.format_names():
            pairs.append((getattr(r_reg.get_format(fmt), name),
                          getattr(registry.get_format(fmt), name)))
    for ref, port in pairs:
        want = {p.name for p in inspect.signature(ref).parameters.values()
                if p.kind == p.KEYWORD_ONLY} - {"interpret"}
        have = set(inspect.signature(port).parameters)
        assert want <= have, (port.__qualname__, want - have)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fmt", FORMATS)
def test_tile_modes_and_budgets_give_the_default_bits(fmt, dtype):
    fn, pk, a = packs(dtype)[fmt]
    d = _device(fmt, pk)
    X = np.random.default_rng(7).standard_normal((a.shape[1], B)).astype(
        dtype)
    want = fn(pk, X, device="cpu")
    np.testing.assert_allclose(want.numpy(), a.to_dense() @ X,
                               rtol=1e-4 if dtype == np.float32 else 1e-12,
                               atol=1e-5)
    for mode in tiling.TILE_MODES:
        assert torch.equal(fn(pk, X, device="cpu", tile_mode=mode), want)
    hist = obs.default_registry().histogram("kernels.col_tiles")
    for bt, tiles in ((B, 1), (B // 2, 2), (0, B)):
        before = (hist.count, hist.total)
        got = fn(pk, X, device="cpu", vmem_budget=_budget(fmt, d, bt),
                 tile_mode="loop")
        assert (hist.count - before[0], hist.total - before[1]) == \
            (1, tiles), (fmt, bt)
        assert torch.equal(got, want), (fmt, bt)
    # ``bn`` wins over a budget, as in the reference
    before = (hist.count, hist.total)
    got = fn(pk, X, device="cpu", bn=2, vmem_budget=1 << 30)
    assert (hist.count - before[0], hist.total - before[1]) == (1, 4)
    assert torch.equal(got, want)


def test_a_budget_never_tiles_wider_than_the_kernels():
    for L in (32, 128, 992):
        for item in (4, 8):
            widest = tiling.dtans_widest_bn(L, 1, item)
            assert tiling.dtans_budget_bn(L, 1, item, 1 << 40) == widest
            assert tiling.dtans_budget_bn(L, 1, item, 0) == 1
            assert tiling.dtans_spmm_tile(L, 1, 4096, item,
                                          budget=1 << 40) == widest
    for item, slab in ((4, 64), (8, 32)):
        assert tiling.padded_budget_bn(4096, 30, 512, item, 1 << 40) == slab
        assert tiling.padded_spmm_tile(4096, 30, 512, item,
                                       budget=1 << 40) == slab
        assert tiling.padded_budget_bn(4096, 30, 512, item, 0) == 1
    # slices past the SpMM kernel's width run by columns whatever the budget
    assert tiling.dtans_spmm_tile(1024, 1, 64, 4, budget=1 << 40) == 1


def _plans():
    a = _matrix(np.float32)
    return a, {fmt: registry.get_format(fmt).shard(
        a, 2, **({"lane_width": 32} if fmt == "dtans" else {}))
        for fmt in ("dtans", "sell", "rgcsr", "bcsr", "csr")}


def test_shard_spmm_and_the_registry_runners_take_tile_mode():
    a, plans = _plans()
    X = np.random.default_rng(9).standard_normal((a.shape[1], B)).astype(
        np.float32)
    for fmt, plan in plans.items():
        want = shard_ops.shard_spmm(plan, X, device="cpu")
        spec = registry.get_format(fmt)
        for mode in tiling.TILE_MODES:
            assert torch.equal(shard_ops.shard_spmm(
                plan, X, device="cpu", bn=3, tile_mode=mode), want), fmt
            assert torch.equal(spec.shard_runner(
                plan, X, device="cpu", tile_mode=mode)(), want), fmt
    for fmt in registry.format_names():
        spec = registry.get_format(fmt)
        packed = spec.pack(a)
        want = spec.spmm_runner(packed, X, device="cpu")()
        for mode in tiling.TILE_MODES:
            got = spec.spmm_runner(packed, X, device="cpu", bn=3,
                                   tile_mode=mode)()
            assert torch.equal(got, want), (fmt, mode)
            assert torch.equal(spec.spmm(a, X, device="cpu",
                                         tile_mode=mode), want), (fmt, mode)


def test_an_unknown_tile_mode_raises_as_the_references():
    from repro.kernels.tiling import resolve_tile_mode
    with pytest.raises(ValueError) as ref:
        resolve_tile_mode("rows", False)
    a, plans = _plans()
    X = np.ones((a.shape[1], B), np.float32)
    calls = [lambda fmt=fmt: packs(np.float32)[fmt][0](
        packs(np.float32)[fmt][1], X, device="cpu", tile_mode="rows")
        for fmt in FORMATS]
    calls.append(lambda: shard_ops.shard_spmm(plans["dtans"], X,
                                              device="cpu",
                                              tile_mode="rows"))
    for fmt in registry.format_names():
        spec = registry.get_format(fmt)
        calls += [lambda spec=spec: spec.spmm_runner(
                      spec.pack(a), X, device="cpu", tile_mode="rows"),
                  lambda spec=spec: spec.spmm(a, X, device="cpu",
                                              tile_mode="rows")]
    calls += [lambda spec=registry.get_format(f), p=p: spec.shard_runner(
        p, X, device="cpu", tile_mode="rows") for f, p in plans.items()]
    for call in calls:
        with pytest.raises(ValueError) as got:
            call()
        assert str(got.value) == str(ref.value)


# one smoke cell's sharded step on a fake (2, 2) group, its op trace saved
_SAVE_HLO = """
import json, sys
from repro_torch import configs
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.config import ShapeConfig

shape = ShapeConfig("tp_train", 16, 4, "train")
rec = run_cell("smollm-135m", shape.name, "2x2", sys.argv[1], verbose=False,
               cfg=configs.get_smoke("smollm-135m"), shape=shape,
               mesh=MeshShape(("data", "model"), (2, 2)), save_hlo=True)
print(json.dumps(rec))
"""


def test_save_hlo_writes_the_counted_steps_op_trace(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        ["src"] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", _SAVE_HLO, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and "sharded_error" not in rec, rec
    path = rec["ops_file"]
    assert os.path.basename(path) == "smollm-135m__tp_train__2x2.ops.txt.gz"
    with gzip.open(path, "rt") as f:
        lines = f.read().splitlines()
    assert lines[1] == "# op\tshapes\tdtypes\tflops\tbytes\tcollective\t" \
                       "group\ttimes"
    ops_ = [line.split("\t") for line in lines[2:]]
    assert all(len(o) == 8 for o in ops_)
    counts = {k: 0 for k in rec["collectives"]["counts"]}
    for o in ops_:
        if o[5] != "-":
            counts[o[5]] += int(o[7])
            assert o[6] in ("data", "model"), o
    assert counts == rec["collectives"]["counts"]
    assert sum(counts.values()) > 0
    assert sum(int(o[7]) for o in ops_) == rec["counted_ops"]
    flops = sum(float(o[3]) * int(o[7]) for o in ops_)
    assert flops == pytest.approx(rec["flops_per_device"], rel=1e-9)


def test_the_dry_runs_command_line_takes_save_hlo(tmp_path, capsys):
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--arch", "smollm-135m", "--shape", "long_500k",
                     "--out", str(tmp_path), "--save-hlo"])
    assert exit_.value.code == 0          # a skipped cell writes no trace
    rec = json.loads((tmp_path / "smollm-135m__long_500k__single.json")
                     .read_text())
    assert rec["status"] == "skipped" and "ops_file" not in rec
