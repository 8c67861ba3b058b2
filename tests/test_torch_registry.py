"""The port's format registry (`repro_torch.sparse.registry`) against the
JAX package's (`repro.sparse.registry`).

Exact, for every registered format on small seeded matrices: the names
and flags, knob grids, config-name round trips, artifact keys, byte
counts (exact, estimated, constructed), cost terms, candidates and shard
plans (boundaries, sizes and every array of every shard's pack).

The runners run on ``device="cpu"`` (the kernels' plain torch versions;
csr / coo as a torch scatter-add, dense as ``torch.matmul``) and must
match the reference's oracles — `spmv_gold`, the jnp `*_spmv_ref`, and
its XLA scatter-add / dense runners — at rtol 1e-12 (f64) and 1e-4
(f32), SpMV and SpMM alike; the per-column SpMM fallback a third-party
format gets must agree with the fused path. Interpret-mode Pallas never
runs here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.csr_dtans import spmv_gold as r_spmv_gold
from repro.core.params import PAPER
from repro.kernels.bcsr_spmv import bcsr_spmv_ref
from repro.kernels.rgcsr_spmv import rgcsr_spmv_ref
from repro.kernels.sell_spmv import sell_spmv_ref
from repro.autotune import fingerprint as r_fingerprint
from repro.sparse import registry as R
from repro.sparse.formats import CSR as RCSR
from repro.sparse.random_graphs import block_sparse, stencil_2d

from repro_torch.autotune import fingerprint
from repro_torch.core.csr_dtans import CSRdtANS
from repro_torch.kernels import ops
from repro_torch.sparse import registry as P
from repro_torch.sparse.formats import CSR

RTOL = {np.float32: 1e-4, np.float64: 1e-12}


def _quantized(m, n, density, dtype, seed):
    rng = np.random.default_rng(seed)
    d = np.round(rng.standard_normal((m, n)) * 4) / 4
    d[rng.random((m, n)) >= density] = 0
    return d.astype(dtype)


def _empty_rows():
    rng = np.random.default_rng(3)
    d = rng.standard_normal((70, 50))
    d[rng.random(d.shape) >= 0.2] = 0
    d[5:20] = 0
    return d


# Small matrices in the spirit of the JAX tests' corpora: a regular
# stencil (f64), a quantized NN-like weight (f32), a block-structured one
# (f32, the case BCSR exists for), escape-heavy random values with empty
# rows (f64).
MATRICES = {
    "stencil-f64": lambda: stencil_2d(12).to_dense(),
    "quantized-f32": lambda: _quantized(150, 120, 0.15, np.float32, 1),
    "blocked-f32": lambda: block_sparse(
        64, 64, (4, 4), 0.1, np.random.default_rng(5)).to_dense()
    .astype(np.float32),
    "empty-rows-f64": _empty_rows,
}

_CACHE: dict = {}


def _mats(name):
    """(port CSR, reference CSR, port fingerprint, reference fingerprint,
    port artifacts, reference artifacts) of one matrix, built once."""
    if name not in _CACHE:
        d = MATRICES[name]()
        a, ra = CSR.from_dense(d), RCSR.from_dense(d)
        _CACHE[name] = (a, ra, fingerprint(a), r_fingerprint(ra), {}, {})
    return _CACHE[name]


FORMATS = R.format_names()


def test_same_formats_flags_and_domains():
    assert P.format_names() == FORMATS
    for f in FORMATS:
        p, r = P.get_format(f), R.get_format(f)
        assert (p.selectable, p.decodes) == (r.selectable, r.decodes)
        assert p.knob_domains == r.knob_domains
        assert p.named_knobs == r.named_knobs
        assert p.conformance_knobs == r.conformance_knobs
        assert p.default_knobs() == r.default_knobs()
    for kw in ({}, {"selectable": True}, {"decodes": True},
               {"selectable": True, "decodes": False}):
        assert P.format_names(**kw) == R.format_names(**kw)
    assert P.DTANS_LANE_WIDTHS == R.DTANS_LANE_WIDTHS
    assert P.BCSR_DTANS_MAX_FILL == R.BCSR_DTANS_MAX_FILL


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_knob_grid_names_and_keys(fmt, name):
    *_, fp, rfp, _, _ = _mats(name)
    p, r = P.get_format(fmt), R.get_format(fmt)
    grid = p.knob_grid(fp)
    assert grid == r.knob_grid(rfp)
    assert p.knob_grid() == r.knob_grid()
    for kn in grid:
        cfg = p.encode_knobs(kn)
        assert cfg == r.encode_knobs(kn)
        assert p.decode_knobs(cfg) == r.decode_knobs(cfg)
        assert p.normalize_knobs(p.decode_knobs(cfg)) == kn
        assert p.artifact_key(kn) == r.artifact_key(kn)
        assert p.interleave_width(kn) == r.interleave_width(kn)
        assert p.shard_unit(kn) == r.shard_unit(kn)


@pytest.mark.parametrize("cfg", [
    "rgcsr_dtans[G=8,shared]", "dtans[w=32,split]", "bcsr[B=4x4]", "sell",
    "rgcsr[G=4]", "bcsr_dtans[B=2x2,shared]", "csr"])
def test_config_strings_round_trip(cfg):
    spec, kn = P.parse_config(cfg)
    r_spec, r_kn = R.parse_config(cfg)
    assert (spec.name, kn) == (r_spec.name, r_kn)
    assert spec.encode_knobs(kn) == cfg
    assert P.parse_config("rgcsr_dtans[G=8,shared]")[1] == {
        "group_size": 8, "shared_table": True}


def _estimate(spec, fp, kn):
    try:
        return spec.nbytes_estimate(fp, **kn)
    except NotImplementedError:
        return "none"


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_sizes_cost_terms_and_candidates(fmt, name):
    a, ra, fp, rfp, arts, r_arts = _mats(name)
    p, r = P.get_format(fmt), R.get_format(fmt)
    for kn in p.knob_grid():
        assert p.nbytes_exact(fp, **kn) == r.nbytes_exact(rfp, **kn)
        assert _estimate(p, fp, kn) == _estimate(r, rfp, kn)
        assert dataclasses.asdict(p.cost_terms(fp, **kn)) == \
            dataclasses.asdict(r.cost_terms(rfp, **kn))
    for kn in p.knob_grid(fp):
        assert p.nbytes_constructed(a, artifacts=arts, **kn) == \
            r.nbytes_constructed(ra, artifacts=r_arts, **kn)
    if p.selectable:
        assert p.candidates(fp) == r.candidates(rfp)


def _same_pack(got, want):
    """Every field of a pack (a dataclass of numpy arrays, a CSR or a
    dense array) equal, dtypes included."""
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got, want)
        return
    if dataclasses.is_dataclass(want) and not isinstance(want, type):
        for f in dataclasses.fields(want):
            _same_pack(getattr(got, f.name), getattr(want, f.name))
        return
    if isinstance(want, RCSR):
        for f in ("indptr", "indices", "values"):
            _same_pack(getattr(got, f), getattr(want, f))
        assert tuple(got.shape) == tuple(want.shape)
        return
    assert got == want


@pytest.mark.parametrize("n_shards", [1, 3])
@pytest.mark.parametrize("fmt", FORMATS)
def test_shard_plans_byte_equal(fmt, n_shards):
    a, ra, *_ = _mats("empty-rows-f64")
    p, r = P.get_format(fmt), R.get_format(fmt)
    kn = p.normalize_knobs(p.conformance_knobs)
    got, want = p.shard(a, n_shards, **kn), r.shard(ra, n_shards, **kn)
    for f in ("fmt", "knobs", "n_shards", "unit", "boundaries",
              "shard_nbytes", "shape", "dtype"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.total_nbytes == want.total_nbytes
    for g, w in zip(got.shards, want.shards):
        _same_pack(g, w)


def test_shard_runner_waits_on_a6():
    a, *_ = _mats("stencil-f64")
    spec = P.get_format("sell")
    plan = spec.shard(a, 2)
    with pytest.raises(NotImplementedError, match="A6"):
        spec.shard_runner(plan, np.ones(a.shape[1]), device="cpu")


def _oracle(fmt, ra, r_packed, x):
    """The reference's y = A x for one rhs column, as numpy."""
    m = ra.shape[0]
    if fmt in ("dense", "csr", "coo"):
        return np.asarray(R.get_format(fmt).runner(r_packed, x)())
    if fmt == "sell":
        y = sell_spmv_ref(r_packed.indices, r_packed.values, x)
    elif fmt == "rgcsr":
        y = rgcsr_spmv_ref(r_packed.deltas, r_packed.values, r_packed.nnz,
                           x)
    elif fmt == "bcsr":
        y = bcsr_spmv_ref(r_packed.block_cols, r_packed.values, x)
    else:
        raise AssertionError(fmt)
    return np.asarray(y).reshape(-1)[:m]


def _close(got, want, dtype):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * scale)


@pytest.mark.parametrize("name", ["stencil-f64", "quantized-f32",
                                  "blocked-f32"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_runners_on_cpu_match_the_reference_oracles(fmt, name):
    a, ra, _, _, arts, r_arts = _mats(name)
    p, r = P.get_format(fmt), R.get_format(fmt)
    kn = p.normalize_knobs(p.conformance_knobs)
    dtype = a.values.dtype.type
    rng = np.random.default_rng(7)
    X = rng.standard_normal((a.shape[1], 3)).astype(dtype)
    packed = p.pack(a, artifacts=arts, **kn)
    if p.decodes:
        r_mat = r._artifact(ra, params=PAPER, artifacts=r_arts, **kn)
        want = np.stack([r_spmv_gold(r_mat, X[:, b]) for b in range(3)],
                        axis=-1)
    else:
        r_packed = r.pack(ra, **kn)
        want = np.stack([_oracle(fmt, ra, r_packed, X[:, b])
                         for b in range(3)], axis=-1)
    _close(p.runner(packed, X[:, 0], device="cpu")(), want[:, 0], dtype)
    _close(p.spmm_runner(packed, X, device="cpu")(), want, dtype)
    _close(p.spmv(a, X[:, 1], device="cpu", **kn), want[:, 1], dtype)
    _close(p.spmm(a, X, device="cpu", bn=2, **kn), want, dtype)


def test_runner_uploads_pack_and_rhs_when_built():
    a, *_ = _mats("quantized-f32")
    spec = P.get_format("dtans")
    packed = spec.pack(a, lane_width=32)
    assert getattr(packed, "_device_cache", None) is None
    x = np.ones(a.shape[1], dtype=np.float32)
    run = spec.runner(packed, x, device="cpu")
    assert "cpu" in packed._device_cache       # uploaded before any call
    assert torch.equal(run(), run())


@pytest.mark.parametrize("fmt", ["sell", "rgcsr", "bcsr"])
def test_pipeline_only_for_decoding_formats(fmt):
    a, *_ = _mats("stencil-f64")
    spec = P.get_format(fmt)
    with pytest.raises(ValueError, match="pipeline"):
        spec.spmm_runner(spec.pack(a), np.ones((a.shape[1], 2)),
                         device="cpu", pipeline=True)


class _ByColumns:
    """Mixin: a third-party format without a fused SpMM kernel."""

    spmm_fn = None


@pytest.mark.parametrize("fmt", ["sell", "rgcsr", "bcsr", "dtans",
                                 "bcsr_dtans"])
def test_per_column_fallback_agrees_with_the_fused_path(fmt):
    a, _, _, _, arts, _ = _mats("blocked-f32")
    base = type(P.get_format(fmt))
    spec = type("Cols", (_ByColumns, base), {"name": f"{fmt}_cols"})()
    kn = spec.normalize_knobs(spec.conformance_knobs)
    packed = base().pack(a, artifacts=arts, **kn)
    X = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (a.shape[1], 5)).astype(np.float32))
    fused = base().spmm_runner(packed, X, device="cpu")()
    cols = spec.spmm_runner(packed, X, device="cpu")()
    assert cols.shape == fused.shape == (a.shape[0], 5)
    assert torch.equal(cols, fused)


class ToyDiagSpec(P.FormatSpec):
    """A format registered here, in a test: the main diagonal only."""

    name = "toy_diag"
    knob_domains = {"stride": (1, 2)}

    def nbytes_exact(self, fp, *, stride=1):
        return fp.nnz * fp.value_bytes + 8 * stride

    def nbytes_constructed(self, a, *, params=None, artifacts=None,
                           stride=1):
        return a.nnz * a.values.dtype.itemsize + 8 * stride

    def cost_terms(self, fp, *, stride=1):
        return P.CostTerms(lockstep=float(fp.nnz))

    def pack(self, a, *, params=None, artifacts=None, stride=1):
        return torch.as_tensor(np.diagonal(a.to_dense()).copy())

    def runner(self, packed, x, *, device="cpu"):
        x = torch.as_tensor(np.asarray(x), dtype=packed.dtype)
        return lambda: packed * x[:packed.shape[0]]


@pytest.fixture
def toy_spec():
    from repro_torch.autotune import clear_memo
    spec = P.register(ToyDiagSpec())
    try:
        yield spec
    finally:
        P.unregister("toy_diag")
        clear_memo()


def test_a_format_registered_in_a_test_joins_the_sweep(toy_spec):
    from repro_torch.autotune import DecisionCache, candidates, select
    from repro_torch.autotune.measure import spmv_runner
    a = CSR.from_dense(np.diag(np.arange(1.0, 7.0)))
    assert "toy_diag" in P.format_names(selectable=True)
    names = {c.config_name for c in candidates(fingerprint(a))}
    assert {"toy_diag", "toy_diag[stride=2]"} <= names
    dec = select(a, formats=("toy_diag", "csr"),
                 cache=DecisionCache(path=None))
    assert dec.fmt in ("toy_diag", "csr")
    Y = spmv_runner(a, "toy_diag", batch=2, device="cpu",
                    x=np.ones((6, 2)))()
    assert torch.equal(Y, torch.as_tensor(np.arange(1.0, 7.0))[:, None]
                       .expand(6, 2))


def test_dtans_pack_is_cached_on_the_artifact():
    a, _, _, _, arts, _ = _mats("quantized-f32")
    spec = P.get_format("rgcsr_dtans")
    p1 = spec.pack(a, artifacts=arts, group_size=8)
    p2 = spec.pack(a, artifacts=arts, group_size=8)
    assert p1 is p2
    mat = arts[spec.artifact_key({"group_size": 8})]
    assert isinstance(mat, CSRdtANS) and ops.get_packed(mat) is p1
