"""The port's dry-run, op counter and roofline against the reference's.

* `roofline.model_flops` equals the reference's exactly for every
  `ARCH_IDS` x `SHAPES` x kind, and `steps.cell_is_skipped` equals it for
  every cell.
* `op_cost.analyze` counts exactly 2 M N K for one matrix product and L
  times that for an L-layer stack (a Python loop); the reference's
  `hlo_cost.analyze` counts the same functions (its stack a `lax.scan`)
  within its own test's 5%.
* Every smoke config's cells, at reduced shapes (as the reference's
  `tests/test_dryrun.py` cuts them), on `MeshShape` (4, 2) and (16, 16)
  come out ``ok`` or ``skipped`` with a valid ``dominant`` term and no
  dtype leak, and their per-device parameter bytes equal those that the
  reference's specs give its parameter tree on the same mesh shape.
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
def test_smoke_cells_run_on_a_mesh_shape(arch, mesh):
    dims = MESHES[mesh]
    for name, shape in SMOKE_SHAPES.items():
        rec = run_cell(arch, name, mesh, None, verbose=False,
                       cfg=configs.get_smoke(arch), shape=shape,
                       mesh=MeshShape(("data", "model"), dims))
        assert rec["status"] in ("ok", "skipped"), rec.get("traceback")
        if rec["status"] == "skipped":
            assert cell_is_skipped(arch, name)
            continue
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        assert not rec["dtype_leak"], rec["f64_ops"]
        assert rec["flops_per_device"] > 0 and rec["chips"] == math.prod(dims)
        assert rec["memory"]["param_bytes"] == \
            _ref_param_bytes(arch, dims, shape.kind), name
        assert rec["memory"]["fits_hbm"]
