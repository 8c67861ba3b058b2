"""The port's dry-run, op counter and roofline against the reference's.

* `roofline.model_flops` equals the reference's exactly for every
  `ARCH_IDS` x `SHAPES` x kind, and `steps.cell_is_skipped` equals it for
  every cell.
* `op_cost.analyze` counts exactly 2 M N K for one matrix product and L
  times that for an L-layer stack (a Python loop); the reference's
  `hlo_cost.analyze` counts the same functions (its stack a `lax.scan`)
  within its own test's 5%.
* Every smoke config's cells, at reduced shapes (as the reference's
  `tests/test_dryrun.py` cuts them), on fake process groups of (4, 2)
  and (16, 16) come out ``ok`` or ``skipped``, their sharded steps
  counted (``"reckoned": false``), with a valid ``dominant`` term and no
  dtype leak, and their per-device parameter bytes equal those that the
  reference's specs give its parameter tree on the same mesh shape.
* The sharded step counted on a fake process group (in subprocesses, so
  no pytest worker holds a process group): the smoke cells' collectives
  equal a 4-rank gloo group's; a ``dp_only`` train cell counts its
  gradient all-reduce; a train cell whose heads do not divide the model
  axis runs sharded; full-width smollm-135m decode_32k runs on the
  production (16, 16) group; a failed sharded step keeps the reckoning.
"""

import functools
import math

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import roofline as R
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.op_cost import analyze
from repro_torch.launch.steps import DP_ONLY_ARCHS, TRAIN_KNOBS, \
    cell_is_skipped
from repro_torch.models.config import SHAPES, ShapeConfig

MESHES = {"4x2": (4, 2), "16x16": (16, 16)}
SMOKE_SHAPES = {"train_4k": ShapeConfig("train_4k", 64, 8, "train"),
                "prefill_32k": ShapeConfig("prefill_32k", 64, 8, "prefill"),
                "decode_32k": ShapeConfig("decode_32k", 128, 8, "decode"),
                "long_500k": ShapeConfig("long_500k", 256, 1, "decode")}


def test_model_flops_and_skips_equal_the_reference():
    from repro import configs as rconfigs
    from repro.launch.roofline import model_flops as ref_flops
    from repro.launch.steps import cell_is_skipped as ref_skip
    from repro.models.config import SHAPES as RSHAPES
    assert list(SHAPES) == list(RSHAPES)
    for arch in configs.ARCH_IDS:
        for name, shape in SHAPES.items():
            assert (shape.seq_len, shape.global_batch, shape.kind) == (
                RSHAPES[name].seq_len, RSHAPES[name].global_batch,
                RSHAPES[name].kind)
            assert cell_is_skipped(arch, name) == ref_skip(arch, name)
            for kind in ("train", "prefill", "decode"):
                assert R.model_flops(configs.get(arch), shape, kind) == \
                    ref_flops(rconfigs.get(arch), RSHAPES[name], kind)


def test_roofline_terms_on_the_h100():
    r = R.Roofline.from_costs(flops=R.PEAK_FLOPS, hbm_bytes=R.HBM_BW / 2,
                              coll_bytes=R.LINK_BW / 4)
    assert (r.compute_s, r.memory_s, r.collective_s) == \
        pytest.approx((1.0, 0.5, 0.25))
    assert r.dominant == "compute" and r.bound_s == pytest.approx(1.0)
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert R.HBM_PER_CHIP == 80 * 2 ** 30


def _stack(x, ws):
    for w in ws:
        x = torch.tanh(x @ w)
    return x


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_op_cost_counts_matmul_flops_exactly(device):
    M_, K_, N_ = 64, 256, 32
    a = torch.ones((M_, K_), device=device)
    b = torch.ones((K_, N_), device=device)
    _, c = analyze(torch.matmul, a, b)
    assert c.flops == 2 * M_ * N_ * K_
    assert c.bytes == (M_ * K_ + K_ * N_ + M_ * N_) * 4
    L, n = 7, 32
    ws = [torch.ones((n, n), device=device) for _ in range(L)]
    _, c = analyze(_stack, torch.ones((n, n), device=device), ws)
    assert c.flops == L * 2 * n ** 3
    assert not c.f64_ops
    _, c = analyze(torch.matmul, a.double(), b.double())
    assert c.f64_ops == {"aten.mm"}


def test_hlo_walker_counts_the_same_functions():
    import jax
    import jax.numpy as jnp
    from repro.launch.hlo_cost import analyze as hlo_analyze
    a = jax.ShapeDtypeStruct((64, 256), jnp.float32)
    b = jax.ShapeDtypeStruct((256, 32), jnp.float32)
    text = jax.jit(lambda x, y: x @ y).lower(a, b).compile().as_text()
    want = 2 * 64 * 256 * 32
    assert abs(hlo_analyze(text).flops - want) / want < 0.05
    L, n = 7, 32

    def scan(x, stack):
        def body(c, w):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, stack)[0]
    text = jax.jit(scan).lower(
        jax.ShapeDtypeStruct((n, n), jnp.float32),
        jax.ShapeDtypeStruct((L, n, n), jnp.float32)).compile().as_text()
    want = L * 2 * n ** 3
    assert abs(hlo_analyze(text).flops - want) / want < 0.05
    _, c = analyze(_stack, torch.ones((n, n)),
                   [torch.ones((n, n)) for _ in range(L)])
    assert c.flops == want


@functools.lru_cache(maxsize=None)
def _ref_param_bytes(arch, mesh_dims, kind) -> int:
    """Per-device parameter bytes of the reference's smoke parameter tree
    under its own specs on a ``FakeMesh`` of ``mesh_dims``."""
    import jax
    from repro import configs as rconfigs
    from repro.launch.sharding import ShardingRules as RRules
    from repro.models import api as rapi
    cfg = rconfigs.get_smoke(arch)
    sizes = dict(zip(("data", "model"), mesh_dims))
    mesh = type("FakeMesh", (), {"shape": sizes,
                                 "axis_names": ("data", "model")})()
    rules = RRules(cfg, mesh, fsdp=TRAIN_KNOBS[arch].get("fsdp"),
                   dp_only=arch in DP_ONLY_ARCHS and kind != "decode")
    shapes = jax.eval_shape(functools.partial(rapi.init_params, cfg),
                            jax.random.PRNGKey(0))
    total = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        shape = list(leaf.shape)
        for d, entry in enumerate(rules.param_spec(path, leaf)):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    shape[d] //= sizes[a]
        total += math.prod(shape) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_smoke_cells_run_on_a_mesh_shape(arch, mesh, fake_group):
    """`run_cell` of each smoke cell on a fake group of the mesh's shape
    (`_SWEEP`, run by the ``fake_group`` fixture): counted, not reckoned."""
    dims = MESHES[mesh]
    sweep = fake_group[2][mesh]
    for name, shape in SMOKE_SHAPES.items():
        rec = sweep[f"{arch} {name}"]
        assert rec["status"] in ("ok", "skipped"), rec.get("traceback")
        if rec["status"] == "skipped":
            assert cell_is_skipped(arch, name)
            continue
        assert "sharded_error" not in rec, (name,
                                            rec.get("sharded_traceback"))
        assert rec["collectives"]["reckoned"] is False, name
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        assert not rec["dtype_leak"], rec["f64_ops"]
        assert rec["flops_per_device"] > 0 and rec["chips"] == math.prod(dims)
        assert rec["memory"]["param_bytes"] == \
            _ref_param_bytes(arch, dims, shape.kind), name
        assert rec["memory"]["fits_hbm"]


# --- the sharded step counted on a fake process group --------------------------

# each run in a process of its own, so that no pytest worker holds a
# process group. `_SWEEP`: every smoke cell on a fake group of one of
# `MESHES` (its name, dims and `SMOKE_SHAPES` as JSON in argv[1]).
_SWEEP = """
import json, sys
from repro_torch import configs
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.config import ShapeConfig

mesh, dims, shapes = json.loads(sys.argv[1])
out = {}
for arch in configs.ARCH_IDS:
    for name, (seq, batch, kind) in shapes.items():
        out[f"{arch} {name}"] = run_cell(
            arch, name, mesh, None, verbose=False,
            cfg=configs.get_smoke(arch),
            shape=ShapeConfig(name, seq, batch, kind),
            mesh=MeshShape(("data", "model"), tuple(dims)))
print(json.dumps(out))
"""

# `_FAKE_GROUP`: rank 0's share of each of `torch_tp_ranks.CELLS` on a fake
# (2, 2) group, and the full-width smollm-135m decode_32k cell on the
# production (16, 16) one
_FAKE_GROUP = """
import json, sys
sys.path.insert(0, "tests")
from torch_tp_ranks import CELLS
from repro_torch import configs
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.config import ShapeConfig

out = {}
for arch, kind, dp_only in CELLS + (("mamba2-130m", "train", None),):
    shape = ShapeConfig(f"tp_{kind}", 16, 4, kind)
    out[f"{arch} {kind} {dp_only}"] = run_cell(
        arch, shape.name, "2x2", None, verbose=False,
        cfg=configs.get_smoke(arch), shape=shape,
        mesh=MeshShape(("data", "model"), (2, 2)), dp_only=dp_only)
out["full"] = run_cell("smollm-135m", "decode_32k", "single", None,
                       verbose=False)
# 4 heads on an 8-way model axis
shape = ShapeConfig("tp_train", 16, 4, "train")
out["uneven"] = run_cell("granite-moe-3b-a800m", shape.name, "2x8", None,
                         verbose=False,
                         cfg=configs.get_smoke("granite-moe-3b-a800m"),
                         shape=shape,
                         mesh=MeshShape(("data", "model"), (2, 8)))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_group():
    """The fake group's records (`_FAKE_GROUP`, in a subprocess), the same
    cells' counts on a 4-rank gloo group (`torch_tp_ranks.run_cells`) and
    the smoke cells' records by mesh (`_SWEEP`, a subprocess a mesh), all
    run at once."""
    import json
    import os
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import mesh as M
    import torch_tp_ranks as R
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        ["src"] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    shapes = {n: (s.seq_len, s.global_batch, s.kind)
              for n, s in SMOKE_SHAPES.items()}
    scripts = {None: [_FAKE_GROUP]} | {
        m: [_SWEEP, json.dumps([m, dims, shapes])]
        for m, dims in MESHES.items()}

    def run(args):
        proc = subprocess.run([sys.executable, "-c", *args], env=env,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return json.loads(proc.stdout.strip().splitlines()[-1])

    with ThreadPoolExecutor(1 + len(scripts)) as pool:
        gloo = pool.submit(M.spawn, 4, R.run_cells, device_type="cpu",
                           shape=(2, 2), axes=("data", "model"),
                           timeout_s=300.0)
        runs = {k: pool.submit(run, a) for k, a in scripts.items()}
        sweep = {m: runs[m].result() for m in MESHES}
        return runs[None].result(), gloo.result()[0], sweep


def test_fake_group_counts_the_gloo_groups_collectives(fake_group):
    """`run_cell` counts the smoke cells' sharded steps (smollm train,
    prefill, decode; the FSDP train cells of yi-9b, granite-moe and
    zamba2, which failed in the embedding's lookup before) on a
    fake (2, 2) group: ``"reckoned": false``, and every collective count
    equal to the same cells' on a 4-rank gloo group (decode and prefill 5
    all-reduces, as `test_cells_run_sharded_on_a_real_mesh`)."""
    from torch_tp_ranks import CELLS
    records, gloo, _ = fake_group
    for arch, kind, dp_only in CELLS:
        rec = records[f"{arch} {kind} {dp_only}"]
        assert rec["status"] == "ok" and "sharded_error" not in rec, rec
        coll = rec["collectives"]
        assert coll["reckoned"] is False
        assert coll["counts"] == gloo[f"{arch} {kind}"], (arch, kind)
        assert coll["reckoning"]["reckoned"] is True
    assert records["smollm-135m decode False"]["collectives"]["counts"][
        "all-reduce"] == 5


def test_a_dp_only_train_cell_counts_its_gradient_all_reduce(fake_group):
    """mamba2-130m trains data-parallel only: its gradients come back as
    partial sums over both mesh axes (the batch is split over both), and
    the step brings each to its replicated parameter's placement, two
    all-reduces a gradient tensor; before, the optimizer took the partial
    sums as they were and nothing was counted."""
    records, _, _ = fake_group
    rec = records["mamba2-130m train None"]
    assert rec["status"] == "ok" and "sharded_error" not in rec, rec
    cfg = configs.get_smoke("mamba2-130m")
    from repro_torch.models import api
    n = sum(1 for _ in api.build_model(
        cfg, generator=None, device="meta").parameters())
    assert rec["collectives"]["counts"]["all-reduce"] >= 2 * n


def test_heads_that_do_not_divide_the_model_axis_train_sharded(
        fake_group):
    """A train cell whose 4 heads do not divide the 8-way model axis runs
    its sharded step (its backward failed in DTensor's view before
    attention merged its heads by `merge_dims`)."""
    records, _, _ = fake_group
    rec = records["uneven"]
    assert rec["status"] == "ok" and "sharded_error" not in rec, \
        rec.get("sharded_error")
    assert rec["collectives"]["reckoned"] is False


def test_a_production_cell_runs_on_a_fake_group(fake_group):
    """Full-width smollm-135m decode_32k on the production (16, 16) fake
    group, on meta tensors: counted, 2 all-reduces a layer and the
    vocab-parallel embedding's, per-device flops below one device's whole
    step."""
    records, _, _ = fake_group
    rec = records["full"]
    assert rec["status"] == "ok" and "sharded_error" not in rec, rec
    assert rec["chips"] == 256 and rec["collectives"]["reckoned"] is False
    cfg = configs.get("smollm-135m")
    assert rec["collectives"]["counts"]["all-reduce"] == 2 * cfg.n_layers + 1
    assert 0 < rec["flops_per_device"] < rec["model_flops_global"]


def test_a_failed_sharded_step_keeps_the_reckoning(monkeypatch):
    """Where the sharded step fails on the fake group, the record keeps
    the figures reckoned from one device's share, says so, and carries
    the failure (here a stand-in for a fault; no process group opens)."""
    from repro_torch.launch import dryrun

    def fail(*args, **kwargs):
        raise RuntimeError("sharded step failed")
    monkeypatch.setattr(dryrun, "_counted", fail)
    shape = SMOKE_SHAPES["decode_32k"]
    kw = dict(cfg=configs.get_smoke("smollm-135m"), shape=shape,
              mesh=MeshShape(("data", "model"), (4, 2)), verbose=False)
    rec = run_cell("smollm-135m", "decode_32k", "4x2", None, **kw)
    assert rec["status"] == "ok"
    assert rec["sharded_error"] == "RuntimeError: sharded step failed"
    assert rec["collectives"]["reckoned"] is True
    # one device's unsharded share, divided by the 2-way model axis
    from repro_torch.launch.steps import build_cell
    cell = build_cell("smollm-135m", "decode_32k", kw["mesh"],
                      cfg=kw["cfg"], shape=shape)
    costs, _ = cell.run()
    assert rec["flops_per_device"] == costs.flops / 2
    assert rec["hbm_bytes_per_device"] == costs.bytes / 2
    reckoned, _ = dryrun._collectives(cell)
    assert rec["collectives"]["counts"] == dict(reckoned.coll_counts)
