"""The port's row-sharded path (`repro_torch.kernels.shard_ops`,
`repro_torch.launch.mesh`, the ``mesh=`` / ``n_shards=`` knobs of
``ops``, ``FormatSpec.shard_runner``, ``select`` and ``SparseLinear``)
against its own single-device runners and the JAX package.

* The loop path: every registered format, the ``empty_rows`` /
  ``powerlaw`` / ``regular`` matrices of `test_spmv_conformance.CORPUS`
  in float64, shards {1, 2, 4}, B {1, 8}: bitwise the port's own
  single-device runner, and within rtol 1e-12 of the reference's
  `spmv_gold` / jnp oracles; the kernel-backed families also in float32
  (bitwise, rtol 1e-4).
* The collective path: one gloo group of 2 ranks and one of 4, spawned
  once each for the module; every loop case of that shard count runs in
  the group, bitwise the loop path on every rank, and each rank holds its
  own shard and no other.
* ``ops.spmv`` / ``spmm`` with ``n_shards=`` and ``mesh=``, the plan cache,
  the refusals, the all-zero and zero-row matrices; ``select(mesh=)``
  against the reference's under its 4-device mesh (decision, cache key,
  leaderboard) and regret 0 against the port's oracle; a sharded
  ``SparseLinear``; the obs counters against the reference's.

Interpret-mode Pallas runs once, for the reference's collective pass in
the obs test.
"""

import functools
import pickle

import numpy as np
import pytest
import torch
from test_spmv_conformance import CORPUS

from repro import obs as r_obs
from repro.autotune import DecisionCache as RDecisionCache
from repro.autotune import clear_memo as r_clear_memo
from repro.autotune import select as r_select
from repro.core.csr_dtans import spmv_gold as r_spmv_gold
from repro.core.params import PAPER
from repro.kernels import shard_ops as r_shard_ops
from repro.kernels.bcsr_spmv import bcsr_spmv_ref
from repro.kernels.rgcsr_spmv import rgcsr_spmv_ref
from repro.kernels.sell_spmv import sell_spmv_ref
from repro.serving.sparse_linear import SparseLinear as RSparseLinear
from repro.sparse import registry as R
from repro.sparse.formats import CSR as RCSR
from repro.sparse.random_graphs import banded, erdos_renyi, stencil_2d

import torch_shard_ranks
from repro_torch import autotune as A
from repro_torch import obs
from repro_torch.core.csr_dtans import encode_matrix
from repro_torch.kernels import ops, shard_ops
from repro_torch.launch import mesh as M
from repro_torch.serving.sparse_linear import SparseLinear
from repro_torch.sparse import registry as P
from repro_torch.sparse.formats import CSR
from repro_torch.sparse.shard import shard_boundaries

SHARDS = (1, 2, 4)
BATCHES = (1, 8)
CASES = ("empty_rows", "powerlaw", "regular")
FORMATS = tuple(s.name for s in P.iter_formats())
#: the formats whose packs have a shard adapter (the collective path)
KERNEL_FORMATS = ("sell", "rgcsr", "dtans", "rgcsr_dtans", "bcsr",
                  "bcsr_dtans")
RTOL = {np.float32: 1e-4, np.float64: 1e-12}
GROUPS = (2, 4)


@functools.lru_cache(maxsize=None)
def _case(name: str, dtype=np.float64) -> tuple:
    d = CORPUS[name]().astype(dtype)
    return CSR.from_dense(d), RCSR.from_dense(d)


def _rhs(a, b: int, dtype=np.float64) -> np.ndarray:
    rng = np.random.default_rng(42)
    return rng.standard_normal((a.shape[1], b)).astype(dtype)


@functools.lru_cache(maxsize=None)
def _plan(fmt: str, case: str, k: int, dtype=np.float64):
    spec = P.get_format(fmt)
    return spec.shard(_case(case, dtype)[0], k, **spec.conformance_knobs)


@functools.lru_cache(maxsize=None)
def _single(fmt: str, case: str, b: int, dtype=np.float64) -> torch.Tensor:
    """The port's single-device truth: the format's own pack through its
    runner (B == 1) or SpMM runner, rows (m, B)."""
    spec = P.get_format(fmt)
    a = _case(case, dtype)[0]
    x = _rhs(a, b, dtype)
    packed = spec.pack(a, **spec.conformance_knobs)
    if b == 1:
        y = spec.runner(packed, x[:, 0], device="cpu")()
        return torch.as_tensor(y).reshape(-1)[:a.shape[0]][:, None]
    y = spec.spmm_runner(packed, x, device="cpu")()
    return torch.as_tensor(y).reshape(-1, b)[:a.shape[0]]


def _r_column(fmt: str, ra, packed, x) -> np.ndarray:
    m = ra.shape[0]
    if fmt in ("dense", "csr", "coo"):
        return np.asarray(R.get_format(fmt).runner(packed, x)())
    if fmt == "sell":
        y = sell_spmv_ref(packed.indices, packed.values, x)
    elif fmt == "rgcsr":
        y = rgcsr_spmv_ref(packed.deltas, packed.values, packed.nnz, x)
    elif fmt == "bcsr":
        y = bcsr_spmv_ref(packed.block_cols, packed.values, x)
    else:
        y = r_spmv_gold(packed, x)
    return np.asarray(y).reshape(-1)[:m]


@functools.lru_cache(maxsize=None)
def _reference(fmt: str, case: str, b: int, dtype=np.float64) -> np.ndarray:
    """The JAX package's y = A X through `spmv_gold` (entropy formats, on
    the reference's own encode) or its jnp oracles, column by column."""
    spec = R.get_format(fmt)
    ra = _case(case, dtype)[1]
    kn = spec.normalize_knobs(spec.conformance_knobs)
    art = (spec._artifact(ra, params=PAPER, artifacts=None, **kn)
           if spec.decodes else spec.pack(ra, **kn))
    x = _rhs(ra, b, dtype)
    return np.stack([_r_column(fmt, ra, art, x[:, j]) for j in range(b)],
                    axis=-1)


def _close(got: torch.Tensor, want: np.ndarray, dtype) -> None:
    got = got.numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * scale)


# ---------------------------------------------------------------------------
# (a) the loop path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", BATCHES, ids=[f"B{b}" for b in BATCHES])
@pytest.mark.parametrize("n_shards", SHARDS, ids=[f"S{k}" for k in SHARDS])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", CASES)
def test_loop_bitwise_single_device(case, fmt, n_shards, batch):
    a = _case(case)[0]
    x = _rhs(a, batch)
    plan = _plan(fmt, case, n_shards)
    want = _single(fmt, case, batch)
    got = shard_ops.shard_spmm(plan, x, device="cpu")
    assert torch.equal(got, want), (fmt, n_shards, batch)
    run = P.get_format(fmt).shard_runner(plan, x, device="cpu")
    assert torch.equal(run(), want)
    if batch == 1:
        assert torch.equal(shard_ops.shard_spmv(plan, x[:, 0], device="cpu"),
                           want[:, 0])
        assert torch.equal(P.get_format(fmt).shard_runner(
            plan, x[:, 0], device="cpu")(), want[:, 0])
    _close(got, _reference(fmt, case, batch), np.float64)


@pytest.mark.parametrize("batch", BATCHES, ids=[f"B{b}" for b in BATCHES])
@pytest.mark.parametrize("n_shards", SHARDS, ids=[f"S{k}" for k in SHARDS])
@pytest.mark.parametrize("fmt", KERNEL_FORMATS)
@pytest.mark.parametrize("case", CASES)
def test_loop_bitwise_single_device_f32(case, fmt, n_shards, batch):
    """The head's dtype, on the families that run a kernel."""
    f32 = np.float32
    a = _case(case, f32)[0]
    got = shard_ops.shard_spmm(_plan(fmt, case, n_shards, f32),
                               _rhs(a, batch, f32), device="cpu")
    assert got.dtype == torch.float32
    assert torch.equal(got, _single(fmt, case, batch, f32))
    _close(got, _reference(fmt, case, batch, f32), f32)


@pytest.mark.parametrize("fmt", FORMATS)
def test_loop_tiled_and_pipelined_bitwise(fmt):
    """A ragged explicit tile (bn=24 of B=64) and ``pipeline=True`` give
    the untiled sharded pass's bits, which are the single-device ones."""
    spec = P.get_format(fmt)
    a = _case("powerlaw")[0]
    x = _rhs(a, 64)
    plan = _plan(fmt, "powerlaw", 2)
    base = shard_ops.shard_spmm(plan, x, device="cpu")
    assert torch.equal(shard_ops.shard_spmm(plan, x, device="cpu", bn=24),
                       base)
    if spec.decodes:
        assert torch.equal(shard_ops.shard_spmm(plan, x, device="cpu",
                                                bn=24, pipeline=True), base)
    one = spec.spmm_runner(spec.pack(a, **spec.conformance_knobs), x,
                           device="cpu")()
    assert torch.equal(base, torch.as_tensor(one).reshape(-1, 64)[:60])


def test_loop_adds_y_and_checks_shapes():
    a = _case("regular")[0]
    plan = _plan("dtans", "regular", 2)
    x = _rhs(a, 3)
    y0 = np.arange(a.shape[0] * 3, dtype=np.float64).reshape(-1, 3)
    got = shard_ops.shard_spmm(plan, x, y0, device="cpu")
    assert torch.equal(got, shard_ops.shard_spmm(plan, x, device="cpu")
                       + torch.as_tensor(y0))
    with pytest.raises(ValueError, match="shape"):
        shard_ops.shard_spmm(plan, x[:, 0], device="cpu")
    with pytest.raises(ValueError, match="rows"):
        shard_ops.shard_spmm(plan, x[1:], device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        shard_ops.shard_spmv(plan, x, device="cpu")
    assert shard_ops.shard_spmm(plan, x[:, :0], device="cpu").shape == \
        (a.shape[0], 0)


def test_loop_on_a_card_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    plan = _plan("dtans", "regular", 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        shard_ops.shard_spmm(plan, _rhs(_case("regular")[0], 2))


def test_host_plan_drops_device_tensors_only():
    plan = _plan("sell", "regular", 2)
    shard_ops.upload(plan, "cpu")
    assert all(getattr(p, "_device_cache", None) for p in plan.shards)
    bare = shard_ops.host_plan(plan)
    assert not any(getattr(p, "_device_cache", None) for p in bare.shards)
    assert all(getattr(p, "_device_cache", None) for p in plan.shards)
    assert bare.boundaries == plan.boundaries
    for p, q in zip(plan.shards, bare.shards):
        assert q.indices is p.indices and q.values is p.values


# ---------------------------------------------------------------------------
# (b) the collective path: process groups of 2 and 4 ranks
# ---------------------------------------------------------------------------

_SUITE_FORMATS = ("csr", "coo", "sell", "rgcsr", "bcsr")


def _f32(a):
    return a.__class__(a.indptr, a.indices, a.values.astype(np.float32),
                       a.shape)


@functools.lru_cache(maxsize=None)
def _suite() -> dict:
    """`tests/test_shard_selection.py`'s suite, as (port, reference)."""
    rng = np.random.default_rng(7)
    mats = {"stencil": stencil_2d(40), "banded": banded(2500, 6),
            "er": erdos_renyi(1500, 10, rng),
            "er_big": erdos_renyi(8000, 100, rng),
            "tiny": erdos_renyi(120, 5, rng)}
    out = {}
    for name, ra in mats.items():
        ra = _f32(ra)
        out[name] = (CSR(ra.indptr, ra.indices, ra.values, ra.shape), ra)
    return out


def _weight() -> np.ndarray:
    return np.random.default_rng(3).standard_normal((24, 70)).astype(
        np.float32)


def _acts() -> np.ndarray:
    return np.random.default_rng(4).standard_normal((5, 24)).astype(
        np.float32)


def _jobs(k: int) -> list:
    """(key, plan, x) of every loop case at shard count ``k``."""
    jobs = []
    for case in CASES:
        for b in BATCHES:
            for fmt in FORMATS:
                a = _case(case)[0]
                jobs.append(((case, fmt, b, "f64"), _plan(fmt, case, k),
                             _rhs(a, b)))
            for fmt in KERNEL_FORMATS:
                a = _case(case, np.float32)[0]
                jobs.append(((case, fmt, b, "f32"),
                             _plan(fmt, case, k, np.float32),
                             _rhs(a, b, np.float32)))
    return jobs


def _zero_row_csr() -> CSR:
    return CSR(indptr=np.zeros(1, np.int64), indices=np.zeros(0, np.int64),
               values=np.zeros(0, np.float64), shape=(0, 30))


@functools.lru_cache(maxsize=None)
def _group(k: int) -> dict:
    """Spawns one gloo group of ``k`` ranks and runs every task in it
    (`torch_shard_ranks.group_body`); the ranks' results, rank 0 first."""
    jobs = _jobs(k)
    spec = P.get_format("dtans")
    a = _case("powerlaw")[0]
    other = 2 if k == 4 else 4
    tasks = {
        "jobs": [(shard_ops.host_plan(p), x) for _, p, x in jobs],
        "mat": encode_matrix(a, lane_width=16), "x": _rhs(a, 8),
        "other_plan": shard_ops.host_plan(_plan("dtans", "regular", other)),
        "degenerate": [
            (spec.shard(_case("empty")[0], k, **spec.conformance_knobs),
             _rhs(_case("empty")[0], 3)),
            (spec.shard(_zero_row_csr(), k, **spec.conformance_knobs),
             np.ones((30, 3)))],
        "suite": ({name: pa for name, (pa, _) in _suite().items()}
                  if k == 4 else {}),
        "formats": _SUITE_FORMATS,
        "w": _weight(), "acts": _acts(),
        "obs_plan": shard_ops.host_plan(_plan("sell", "regular", k)),
        "obs_x": _rhs(_case("regular")[0], 3)}
    ranks = M.spawn(k, torch_shard_ranks.group_body, tasks,
                    device_type="cpu", timeout_s=120.0)
    return {"keys": [key for key, _, _ in jobs], "ranks": ranks}


def _loop_cases():
    for k in GROUPS:
        for case in CASES:
            for fmt in FORMATS:
                for b in BATCHES:
                    yield k, case, fmt, b, "f64"
            for fmt in KERNEL_FORMATS:
                for b in BATCHES:
                    yield k, case, fmt, b, "f32"


@pytest.mark.parametrize("k,case,fmt,batch,dt", list(_loop_cases()),
                         ids=[f"R{k}-{c}-{f}-B{b}-{d}"
                              for k, c, f, b, d in _loop_cases()])
def test_collective_bitwise_loop(k, case, fmt, batch, dt):
    """Every rank's result is bitwise the loop path's; a rank of a
    kernel-backed family uploads its own shard and no other (the others
    run the loop, on every rank, and hold nothing on a device)."""
    g = _group(k)
    i = g["keys"].index((case, fmt, batch, dt))
    dtype = np.float64 if dt == "f64" else np.float32
    want = _single(fmt, case, batch, dtype).numpy()
    plan = _plan(fmt, case, k, dtype)
    for r, res in enumerate(g["ranks"]):
        job = res["jobs"][i]
        assert res["rank"] == r and res["k"] == k
        assert job["y"].dtype == want.dtype
        assert np.array_equal(job["y"], want), (r, fmt, case, batch)
        if fmt in KERNEL_FORMATS:
            rows = plan.boundaries[r + 1] - plan.boundaries[r]
            assert job["uploaded"] == [j == r and rows > 0
                                       for j in range(k)]
        else:
            assert not any(job["uploaded"])


def test_spawn_reports_a_failing_rank():
    with pytest.raises(Exception, match="rank 1 fails"):
        M.spawn(2, torch_shard_ranks.fail_on_rank, 1, device_type="cpu")


@pytest.mark.parametrize("k", GROUPS)
def test_mesh_axes_in_a_group(k):
    """A (data, model) debug mesh over the group's ranks reports its axes;
    the production mesh (16 x 16) refuses a group of k ranks."""
    for res in _group(k)["ranks"]:
        assert res["axes"] == (("data",), 2, k // 2)
        assert "need 256 ranks" in res["production"]


def test_mesh_helpers_default_to_the_card():
    """`spawn` and `make_debug_mesh` build CUDA meshes unless asked for the
    CPU, and without a card they raise before any rank starts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        M.spawn(2, torch_shard_ranks.fail_on_rank, 1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        M.make_debug_mesh()


def test_meshes_need_a_process_group():
    with pytest.raises(RuntimeError, match="need 512 ranks"):
        M.make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(RuntimeError, match="need 4 ranks"):
        M.make_debug_mesh(device_type="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        M.data_axis_size(object())
    with pytest.raises(ValueError, match="at least 1 rank"):
        M.spawn(0, torch_shard_ranks.fail_on_rank, 0)


# ---------------------------------------------------------------------------
# (c) ops.spmv / spmm with n_shards= / mesh=
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", SHARDS, ids=[f"S{k}" for k in SHARDS])
def test_ops_n_shards_bitwise_unsharded(n_shards):
    a = _case("powerlaw")[0]
    mat = encode_matrix(a, lane_width=16)
    x = _rhs(a, 8)
    assert torch.equal(ops.spmm(mat, x, n_shards=n_shards, device="cpu"),
                       ops.spmm(mat, x, device="cpu"))
    assert torch.equal(ops.spmv(mat, x[:, 0], n_shards=n_shards,
                                device="cpu"),
                       ops.spmv(mat, x[:, 0], device="cpu"))
    assert torch.equal(ops.spmm(mat, x[:, :1], n_shards=n_shards,
                                device="cpu"),
                       ops.spmv(mat, x[:, 0], device="cpu")[:, None])


@pytest.mark.parametrize("k", GROUPS)
def test_ops_mesh_bitwise_unsharded(k):
    for res in _group(k)["ranks"]:
        o = res["ops"]
        assert np.array_equal(o["spmm"], o["spmm_1"])
        assert np.array_equal(o["spmv"], o["spmv_1"])


def test_ops_shard_plan_cached_on_object():
    a = _case("regular")[0]
    mat = encode_matrix(a, lane_width=16)
    p2 = ops.get_shard_plan(mat, 2)
    assert ops.get_shard_plan(mat, 2) is p2
    assert ops.get_shard_plan(mat, 4) is not p2
    ops.spmm(mat, _rhs(a, 2), n_shards=2, device="cpu")
    assert ops.get_shard_plan(mat, 2) is p2
    assert p2.boundaries == shard_boundaries(a.shape[0], 2, 16)


def test_ops_refusals():
    a = _case("regular")[0]
    mat = encode_matrix(a, lane_width=16)
    x = _rhs(a, 2)
    with pytest.raises(TypeError, match="CSRdtANS"):
        ops.spmm(ops.get_packed(mat), x, n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="n_shards"):
        ops.spmm(mat, x, n_shards=0, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        ops.spmv(mat, x[:, 0], mesh=object(), device="cpu")


@pytest.mark.parametrize("k", GROUPS)
def test_mesh_of_another_shard_count_raises(k):
    for res in _group(k)["ranks"]:
        assert "model axis" in res["mismatch"], res["mismatch"]


def test_all_zero_and_zero_row_matrices_loop():
    spec = P.get_format("dtans")
    empty = _case("empty")[0]              # 20 x 30, no nonzeros
    for k in SHARDS:
        got = shard_ops.shard_spmm(spec.shard(empty, k,
                                              **spec.conformance_knobs),
                                   _rhs(empty, 3), device="cpu")
        assert got.shape == (20, 3) and not got.any()
        assert shard_boundaries(0, k) == (0,) * (k + 1)
        got = shard_ops.shard_spmm(spec.shard(_zero_row_csr(), k,
                                              **spec.conformance_knobs),
                                   np.ones((30, 3)), device="cpu")
        assert got.shape == (0, 3)


@pytest.mark.parametrize("k", GROUPS)
def test_all_zero_and_zero_row_matrices_collective(k):
    for res in _group(k)["ranks"]:
        zero, rowless = res["degenerate"]
        assert zero.shape == (20, 3) and not zero.any()
        assert rowless.shape == (0, 3)


# ---------------------------------------------------------------------------
# (d) select(mesh=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", GROUPS)
def test_shard_counts_sweep_the_mesh(k):
    assert _group(k)["ranks"][0]["shard_counts"] == \
        {2: (1, 2), 4: (1, 2, 4)}[k]
    assert A.shard_counts(n_shards=3) == (3,)
    assert A.shard_counts() == (1,)


@pytest.mark.parametrize("name", ["stencil", "banded", "er", "er_big",
                                  "tiny"])
def test_select_under_a_mesh_equals_the_reference(name, make_model_mesh):
    """Every rank's decision, cache key and leaderboard equal the
    reference's `select(mesh=make_model_mesh(4))`, and the pick has regret
    0 against the port's exhaustive oracle at shards (1, 2, 4)."""
    pa, ra = _suite()[name]
    cache = RDecisionCache(path=None)
    r_clear_memo()
    want = r_select(ra, warm=False, mesh=make_model_mesh(4),
                    formats=_SUITE_FORMATS, cache=cache)
    want_keys = sorted(cache._load())
    for res in _group(4)["ranks"]:
        got, keys = res["select"][name]
        assert got == want.to_dict()
        assert keys == want_keys
    dec = A.Decision.from_dict(got)
    times = A.oracle_times(pa, warm=False, formats=_SUITE_FORMATS,
                           n_shards=(1, 2, 4), machine=A.V5E)
    key = (dec.config_name if dec.n_shards == 1
           else f"{dec.config_name}@S{dec.n_shards}")
    assert times[key] / min(times.values()) - 1.0 <= 1e-12, (name, key)


def test_select_rejects_measure_with_shards():
    with pytest.raises(ValueError, match="measure"):
        A.select(_suite()["tiny"][0], n_shards=2, measure=True, budget=1,
                 cache=A.DecisionCache(path=None))


# ---------------------------------------------------------------------------
# (e) SparseLinear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", (2, 4))
def test_sparse_linear_n_shards_bitwise_unsharded(n_shards):
    w = _weight()
    one = SparseLinear.from_dense(w, lane_width=16, device="cpu")
    sl = SparseLinear.from_dense(w, lane_width=16, n_shards=n_shards,
                                 device="cpu")
    assert sl.n_shards == n_shards and sl.plan.n_shards == n_shards
    assert sl.mesh is None and one.plan is None
    assert all(getattr(p, "_device_cache", None) for p in sl.plan.shards)
    x = torch.as_tensor(_acts())
    for xb in (x, x[:1], x[:, None, :]):
        assert torch.equal(sl.apply(xb), one.apply(xb))
    # the whole matrix is encoded only when asked for, as the unsharded
    # layer's
    assert sl.mat is None and sl.packed is None
    assert sl.compressed_bytes == one.compressed_bytes
    assert np.array_equal(sl.mat.stream, one.mat.stream)
    assert torch.equal(sl.apply_dense_reference(x),
                       one.apply_dense_reference(x))


@pytest.mark.parametrize("n_shards", (None, 4))
def test_sparse_linear_to_moves_a_host_layer(n_shards):
    """A layer built on the host survives a pickle (a worker process's
    result) and `to` is where `from_dense` ends: the layer on the device
    asked for, bitwise, its whole matrix still encoded on demand; a card
    request without a card raises."""
    w = _weight()
    sl = SparseLinear.from_dense(w, lane_width=16, n_shards=n_shards,
                                 device="cpu")
    back = pickle.loads(pickle.dumps(sl))
    assert back.to("cpu") is back and back.device == torch.device("cpu")
    x = torch.as_tensor(_acts())
    assert torch.equal(back.apply(x), sl.apply(x))
    assert back.compressed_bytes == sl.compressed_bytes
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            back.to("cuda")
        assert back.device == torch.device("cpu")


@pytest.mark.parametrize("n_shards", (2, 4))
def test_sparse_linear_auto_picks_the_references_config(n_shards):
    w = _weight()
    sl = SparseLinear.from_dense(w, auto=True, n_shards=n_shards,
                                 autotune_machine=A.V5E,
                                 autotune_cache=A.DecisionCache(path=None),
                                 device="cpu")
    r_clear_memo()
    ref = RSparseLinear.from_dense(w, auto=True, n_shards=n_shards,
                                   autotune_cache=RDecisionCache(path=None))
    assert sl.decision.to_dict() == ref.decision.to_dict()
    assert sl.decision.n_shards == n_shards
    x = torch.as_tensor(_acts())
    want = ops.spmm(sl.whole(), x.T.contiguous(), device="cpu").T
    assert torch.equal(sl.apply(x), want)


@pytest.mark.parametrize("k", GROUPS)
def test_sparse_linear_under_a_mesh(k):
    """Each rank encodes the shards but not the whole matrix, uploads only
    its own shard, and serves bitwise the unsharded layer; ``n_shards``
    other than the mesh's ``"model"`` dim refuses when the layer is
    built."""
    w = _weight()
    want = SparseLinear.from_dense(w, device="cpu").apply(
        torch.as_tensor(_acts())).numpy()
    for r, res in enumerate(_group(k)["ranks"]):
        lay = res["layer"]
        assert lay["n_shards"] == k
        assert lay["uploaded"] == [j == r for j in range(k)]
        assert not lay["whole_encoded"]
        assert np.array_equal(lay["y"], want)
        assert f"holds {k} ranks" in res["layer_mismatch"]


def test_sparse_linear_refusals():
    w = _weight()
    with pytest.raises(ValueError, match="n_shards"):
        SparseLinear.from_dense(w, n_shards=0, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        SparseLinear.from_dense(w, mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# (f) the obs contract
# ---------------------------------------------------------------------------

def _metrics(registry) -> dict:
    snap = registry.snapshot()
    return {kind: {k: v for k, v in snap[kind].items()
                   if k.startswith("kernels.")}
            for kind in ("counters", "histograms")}


def test_loop_pass_metrics_equal_the_references():
    a, ra = _case("regular")
    x = _rhs(a, 3)
    rspec = R.get_format("csr")
    rplan = rspec.shard(ra, 2, **rspec.conformance_knobs)
    r_obs.default_registry().reset()
    r_shard_ops.shard_spmm(rplan, x)
    obs.default_registry().reset()
    shard_ops.shard_spmm(_plan("csr", "regular", 2), x, device="cpu")
    assert _metrics(obs.default_registry()) == \
        _metrics(r_obs.default_registry())
    assert obs.default_registry().counter("kernels.shard_passes").value == 1


@pytest.mark.parametrize("k", GROUPS)
def test_collective_pass_metrics_equal_the_references(k, make_model_mesh):
    ra = _case("regular")[1]
    rspec = R.get_format("sell")
    rplan = rspec.shard(ra, k, **rspec.conformance_knobs)
    r_obs.default_registry().reset()
    r_shard_ops.shard_spmm(rplan, _rhs(ra, 3), mesh=make_model_mesh(k))
    want = _metrics(r_obs.default_registry())
    assert want["counters"]["kernels.collectives.psum"] == 1
    for res in _group(k)["ranks"]:
        assert res["metrics"] == want
