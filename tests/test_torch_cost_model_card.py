"""The card's cost model (`repro_torch.autotune.cost_model.CardModel`, the
`H100` default) against the port's kernels.

* Under `H100`, `candidate_time`'s column tiles and launches
  (`FormatSpec.kernel_passes`) are what the kernels run: ``kernels.col_tiles``
  of one `ops` pass and the wrappers each pass calls (a wrapper call is one
  launch on the card), at the head's shape (49152 x 576, few nonzeros a
  row) in f32 and f64, B in {1, 4, 8, 64, 512, 8192}, lane widths 32, 128
  and 1024 (past the SpMM kernel: one SpMV launch a column), and for the
  SELL / RGCSR / BCSR and csr / coo / dense runners.
* The per-launch term is charged once a launch (B of them by columns, one
  a shard sharded); the fused decode kernels' contraction is priced at its
  own coefficient.
* A `CardModel` round-trips through `to_dict` / `model_from_dict` and
  `save_profile` / `load_profile`; its signature changes with any
  constant; a reference-shaped profile still loads as a `MachineModel`.
* A `MachineModel` with the card's constants prices every candidate to the
  JAX package's float (its tile rule, no launch term), as `V5E` does.
* `fit_card` recovers a model from its own rows; `calibrate` on a
  `CardModel` base runs on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import autotune as A
from repro_torch import obs
from repro_torch.autotune import cost_model, measure
from repro_torch.core.csr_dtans import encode_matrix
from repro_torch.kernels import ops, tiling
from repro_torch.kernels.pack import to_device
from repro_torch.sparse import registry
from repro_torch.sparse.formats import CSR

BATCHES = (1, 4, 8, 64, 512, 8192)
RUN_BATCHES = (1, 4, 8, 64, 512)      # passes run on the CPU's plain path
ROWS, COLS = 49152, 576               # the head's shape


def _head_shaped(dtype, nnz_per_row: int = 1) -> CSR:
    """A matrix of the head's shape, ``nnz_per_row`` entries a row."""
    rng = np.random.default_rng(3)
    rows = np.repeat(np.arange(ROWS), nnz_per_row)
    cols = rng.integers(0, COLS, size=rows.size)
    vals = np.round(rng.standard_normal(rows.size), 1) + 0.05
    return CSR.from_coo(rows, cols, vals.astype(dtype), (ROWS, COLS))


_ENC: dict = {}


def head(dtype) -> tuple:
    """(the head-shaped matrix, its fingerprint, encodes by lane width)."""
    key = np.dtype(dtype).name
    if key not in _ENC:
        a = _head_shaped(dtype)
        _ENC[key] = (a, A.fingerprint(a),
                     {L: encode_matrix(a, lane_width=L)
                      for L in (32, 128, 1024)})
    return _ENC[key]


class _Calls:
    """Counts the calls of the dtANS wrappers `ops` launches through."""

    def __init__(self, monkeypatch):
        self.n = {"dtans_spmv": 0, "dtans_spmm": 0}
        for name in self.n:
            fn = getattr(ops, name)
            monkeypatch.setattr(ops, name, self._count(name, fn))

    def _count(self, name, fn):
        def wrapper(*args, **kwargs):
            self.n[name] += 1
            return fn(*args, **kwargs)
        return wrapper


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("L", [32, 128, 1024])
def test_dtans_tiles_and_launches_are_the_kernels(L, dtype, monkeypatch):
    a, fp, enc = head(dtype)
    spec = registry.get_format("dtans")
    mat = enc[L]
    hist = obs.default_registry().histogram("kernels.col_tiles")
    calls = _Calls(monkeypatch)
    rng = np.random.default_rng(L)
    item = np.dtype(dtype).itemsize
    for B in BATCHES:
        kp = spec.kernel_passes(fp, B, lane_width=L, shared_table=True)
        tiles, launches = kp.tiles, kp.launches
        assert kp.kernel == "dtans"
        if B == 1:
            assert (tiles, launches) == (1, 1)
        dm = to_device(ops.get_packed(mat), "cpu")
        assert kp.units == tiling.geometry(dm.n_slices, L, 1, item).units
        by_columns = L > tiling.MAX_SPMM_LANE_WIDTH
        assert tiling.spmm_by_columns(L, 1, item) == by_columns
        if B not in RUN_BATCHES or (by_columns and B > 64):
            # the pass's tile, as `ops.spmm` resolves it, without running it
            bn = tiling.dtans_spmm_tile(L, 1, B, item)
            assert tiles == tiling.n_tiles(B, bn)
            assert launches == (B if by_columns else 1)
            continue
        X = torch.as_tensor(rng.standard_normal((COLS, B)).astype(dtype))
        before = (dict(calls.n), hist.count, hist.total)
        ops.spmm(mat, X, device="cpu")
        n = {k: v - before[0][k] for k, v in calls.n.items()}
        assert n["dtans_spmv"] + n["dtans_spmm"] == launches, (B, n)
        if B > 1:
            assert (hist.count - before[1], hist.total - before[2]) == \
                (1, tiles), B
        if by_columns:
            assert (tiles, launches, n["dtans_spmv"]) == (B, B, B)
        elif B > 1:
            assert n["dtans_spmm"] == 1
    # the f32 head at B=64 runs one tile (the reference's rule priced 2, C5)
    if dtype == np.float32:
        assert spec.kernel_passes(fp, 64, lane_width=128).tiles == 1
        assert cost_model._n_col_tiles(COLS, 0, 64, 4,
                                       A.H100.vmem_bytes) == 2


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_padded_and_plain_passes_are_the_kernels(dtype):
    a, fp, _ = head(dtype)
    hist = obs.default_registry().histogram("kernels.col_tiles")
    rng = np.random.default_rng(5)
    for fmt, knobs in (("sell", {}), ("rgcsr", {"group_size": 8}),
                       ("bcsr", {"block_shape": (2, 2)})):
        spec = registry.get_format(fmt)
        packed = spec.pack(a, **knobs)
        for B in BATCHES:
            kp = spec.kernel_passes(fp, B, **knobs)
            tiles = kp.tiles
            assert (kp.kernel, kp.launches) == ("padded", 1)
            if B == 1:
                assert tiles == 1
                continue
            assert tiles == tiling.n_tiles(
                B, tiling.padded_bn(B, np.dtype(dtype).itemsize))
            if B > 512:
                continue
            X = rng.standard_normal((COLS, B)).astype(dtype)
            before = (hist.count, hist.total)
            spec.spmm_runner(packed, X, device="cpu")()
            assert (hist.count - before[0], hist.total - before[1]) == \
                (1, tiles), (fmt, B)
    for fmt, kernel, launches in (("csr", "scatter", 4),
                                  ("coo", "scatter", 4), ("dense", "", 1)):
        for B in BATCHES:
            kp = registry.get_format(fmt).kernel_passes(fp, B)
            assert (kp.kernel, kp.tiles, kp.launches) == (kernel, 1,
                                                          launches)


def test_the_launch_term_is_charged_once_a_launch():
    a, fp, _ = head(np.float32)
    cost = dataclasses.replace(A.H100, launch_s=0.0)
    # (the kernels' own fixed costs a launch, beside ``launch_s``, are
    # charged the same way: `card_terms`' launch counts)
    for fmt, knobs in (("dtans", {"lane_width": 32}),
                       ("dtans", {"lane_width": 1024}),
                       ("rgcsr_dtans", {"group_size": 8}),
                       ("sell", {}), ("bcsr", {"block_shape": (4, 4)}),
                       ("csr", {}), ("coo", {}), ("dense", {})):
        spec = registry.get_format(fmt)
        for B in BATCHES:
            for k in (1, 2, 4):
                launches = spec.kernel_passes(fp, B, **knobs).launches
                kw = dict(warm=True, batch=B, n_shards=k, **knobs)
                with_ = A.candidate_time(fp, fmt, 10 ** 6, machine=A.H100,
                                         **kw)
                without = A.candidate_time(fp, fmt, 10 ** 6, machine=cost,
                                           **kw)
                assert with_ - without == pytest.approx(
                    launches * k * A.H100.launch_s, rel=1e-9), (fmt, B, k)
    # by columns, B launches and B decodes of the matrix
    spec = registry.get_format("dtans")
    kp = spec.kernel_passes(fp, 64, lane_width=1024)
    assert (kp.tiles, kp.launches) == (64, 64)
    terms = dict(zip(cost_model.CARD_TERMS, A.card_terms(
        fp, "dtans", 10 ** 6, batch=64, n_shards=2, lane_width=1024)))
    assert terms["launches"] == terms["decode_launches"] == 128
    assert terms["decode_chain"] == 128 * fp.row_nnz_max


def test_each_kernel_contracts_at_its_own_coefficient():
    """The fused dtANS kernels at ``fused_ops_per_elem``; the padded SpMM
    whose x slab is staged (the head's 576 columns) at
    ``spmv_ops_per_elem``, the padded SpMV (x through L1) at
    ``unstaged_ops_per_elem``."""
    a, fp, _ = head(np.float32)
    h = A.H100
    twice = {f: dataclasses.replace(h, **{f: 2 * getattr(h, f)})
             for f in ("fused_ops_per_elem", "spmv_ops_per_elem",
                       "unstaged_ops_per_elem")}

    def moved(fmt, B, field, **knobs):
        def t(m):
            return A.candidate_time(fp, fmt, 10 ** 6, warm=True, batch=B,
                                    machine=m, **knobs)
        return t(twice[field]) > t(h)
    for B in (1, 64):
        assert moved("dtans", B, "fused_ops_per_elem", lane_width=32)
        assert not moved("dtans", B, "spmv_ops_per_elem", lane_width=32)
    assert registry.get_format("sell").kernel_passes(fp, 64).staged
    assert moved("sell", 64, "spmv_ops_per_elem")
    assert not moved("sell", 64, "unstaged_ops_per_elem")
    assert moved("sell", 1, "unstaged_ops_per_elem")
    assert not moved("sell", 1, "spmv_ops_per_elem")
    assert not moved("sell", 64, "fused_ops_per_elem")


def test_card_model_round_trips_and_signs_every_constant(tmp_path):
    h = A.H100
    assert isinstance(h, A.CardModel) and h.name == "h100"
    assert A.model_from_dict(h.to_dict()) == h
    assert type(A.model_from_dict(A.V5E.to_dict())) is A.MachineModel
    path = tmp_path / "profiles.json"
    A.save_profile(h, path=path)
    fitted = dataclasses.replace(h, name="h100-fitted", launch_s=7e-6)
    A.save_profile(fitted, path=path)
    assert A.load_profile("h100", path=path) == h
    assert A.load_profile("h100-fitted", path=path) == fitted
    sigs = {h.signature()}
    for f in dataclasses.fields(h):
        if f.name == "name":
            continue
        v = getattr(h, f.name)
        other = dataclasses.replace(h, **{f.name: v * 1.5 + 1})
        assert other.signature() not in sigs, f.name
        sigs.add(other.signature())
    with pytest.raises(ValueError, match="unknown MachineModel fields"):
        A.MachineModel.from_dict(h.to_dict())


def test_a_machine_model_prices_as_the_reference():
    from repro.autotune import MachineModel as RMachineModel
    from repro.autotune import candidate_time as r_candidate_time
    from repro.autotune import fingerprint as r_fingerprint
    from repro.sparse.formats import CSR as RCSR
    a, fp, _ = head(np.float32)
    ra = RCSR(a.indptr, a.indices, a.values, a.shape)
    rfp = r_fingerprint(ra)
    fields = {f.name for f in dataclasses.fields(A.MachineModel)}
    consts = {k: v for k, v in A.H100.to_dict().items() if k in fields}
    port, ref = A.MachineModel(**consts), RMachineModel(**consts)
    for fmt, knobs in (("dtans", {"lane_width": 128}), ("sell", {}),
                       ("rgcsr_dtans", {"group_size": 4}), ("csr", {})):
        for B in (1, 64, 512):
            for k in (1, 4):
                kw = dict(warm=True, batch=B, n_shards=k, **knobs)
                assert A.candidate_time(fp, fmt, 10 ** 6, machine=port,
                                        **kw) == \
                    r_candidate_time(rfp, fmt, 10 ** 6, machine=ref, **kw)


def test_fit_card_recovers_a_model_from_its_rows():
    rng = np.random.default_rng(0)
    truth = dataclasses.replace(
        A.H100, cache_bw=9e12, spmv_ops_per_elem=30, row_seq_penalty=40,
        unstaged_ops_per_elem=90, fused_ops_per_elem=70,
        decode_ops_per_nnz=600, spmm_unit_s=1e-8, launch_s=2e-6,
        decode_launch_s=5e-6, spmm_launch_s=6e-6, decode_chain_s=1e-7,
        padded_chain_s=1.3e-7, scatter_ops_per_nnz=35)
    n = len(cost_model.CARD_TERMS)
    rows = rng.random((80, n)) * np.array(
        [1e8, 5e7] + [1e8] * 5 + [3e4, 8, 8, 8, 300, 300, 1e7])
    rows *= rng.random((80, n)) < 0.6          # sparse rows, as passes are
    t = np.array([truth.seconds(r) for r in rows])
    got = measure.fit_card(rows, t, np.ones(len(t)), A.H100)
    for f in ("cache_bw", "spmv_ops_per_elem", "row_seq_penalty",
              "unstaged_ops_per_elem", "fused_ops_per_elem",
              "decode_ops_per_nnz", "spmm_unit_s", "launch_s",
              "decode_launch_s", "spmm_launch_s", "decode_chain_s",
              "padded_chain_s", "scatter_ops_per_nnz"):
        assert getattr(got, f) == pytest.approx(getattr(truth, f),
                                                rel=1e-6), f
    assert got.hbm_bw == A.H100.hbm_bw
    assert [got.seconds(r) for r in rows] == pytest.approx(t, rel=1e-9)


def test_calibrate_fits_a_card_model_on_the_cpu():
    mats = {k: v for k, v in measure._calibration_suite(small=True).items()
            if k in ("er", "nn")}
    res = A.calibrate(mats, base=A.H100, device="cpu", repeats=1,
                      configs=("csr", "sell", "dtans[w=32,shared]"),
                      batches=(1, 4))
    m = res.model
    assert isinstance(m, A.CardModel) and m.name == "h100-calibrated"
    assert (m.hbm_bw, m.vmem_bytes, m.ici_bw, m.vpu_rate) == (
        A.H100.hbm_bw, A.H100.vmem_bytes, A.H100.ici_bw, A.H100.vpu_rate)
    assert len(res.points) == 2 * 3 * 2
    assert all(p.launches == (4 if p.fmt == "csr" else 1)
               for p in res.points)
    assert all(len(p.terms) == len(cost_model.CARD_TERMS)
               for p in res.points)
    assert all(np.isfinite(p.modeled_after) and p.modeled_after >= 0
               for p in res.points)
    assert np.isfinite(res.err_after)
