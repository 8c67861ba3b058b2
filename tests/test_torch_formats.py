"""The port's uncompressed comparators (SELL, RGCSR) and RGCSR-dtANS against
the JAX package.

Packs, RGCSR fields, byte counts, the RGCSR-dtANS golden and the random
generators must be equal to the reference's; the ops run on the CPU (their
kernels' plain versions) and must agree with the reference's jnp oracles
within its tolerances (rtol 1e-4 f32, 1e-12 f64). The port's own contracts
(column tiles, SpMM at B=1, each SpMM column against SpMV) hold bitwise.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from repro.core.rgcsr_dtans import encode_rgcsr_matrix as r_encode_rgcsr
from repro.kernels import ops as r_ops
from repro.kernels.pack import pack_matrix as r_pack
from repro.kernels.ref import spmv_ref as r_spmv_ref
from repro.kernels.rgcsr_spmv import pack_rgcsr as r_pack_rgcsr
from repro.kernels.rgcsr_spmv import rgcsr_spmv_ref
from repro.kernels.sell_spmv import pack_sell as r_pack_sell
from repro.kernels.sell_spmv import sell_spmv_ref
from repro.sparse import random_graphs as r_graphs
from repro.sparse import rgcsr as r_rgcsr
from repro.sparse.formats import CSR as RCSR
from repro.sparse.formats import all_format_nbytes as r_all_format_nbytes

from repro_torch import convert, obs
from repro_torch.core.rgcsr_dtans import RGCSRdtANS, encode_rgcsr_matrix
from repro_torch.kernels import ops, padded
from repro_torch.kernels import rgcsr_spmv as RG
from repro_torch.kernels import sell_spmv as SE
from repro_torch.kernels.pack import pack_matrix
from repro_torch.sparse import random_graphs, rgcsr
from repro_torch.sparse.formats import CSR, all_format_nbytes

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "bitstream_rgcsr_stencil6_f64_G8.json")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _random_dense(m, n, density, dtype, seed, quantized=False):
    rng = _rng(seed)
    d = rng.standard_normal((m, n)).astype(dtype)
    if quantized:
        d = np.round(d * 2) / 2
    d[rng.random((m, n)) >= density] = 0
    return d


# The matrices of tests/test_kernels.py::_CASES, as dense arrays.
CASES = {
    "stencil-f64": lambda: r_graphs.stencil_2d(16).to_dense(),
    "er-f64": lambda: r_graphs.erdos_renyi(200, 6, _rng(1)).to_dense(),
    "banded-f32": lambda: r_graphs.banded(150, 4).to_dense().astype(
        np.float32),
    "random-f64": lambda: _random_dense(90, 70, 0.3, np.float64, 2),
    "random-f32": lambda: _random_dense(90, 70, 0.3, np.float32, 3),
    "quantized-f32": lambda: _random_dense(120, 80, 0.2, np.float32, 4,
                                           quantized=True),
    "tall-skinny": lambda: _random_dense(400, 9, 0.5, np.float64, 5),
    "wide": lambda: _random_dense(9, 400, 0.4, np.float64, 6),
    "empty-rows": lambda: np.diag(np.r_[np.zeros(10), np.arange(1.0, 11.0)]),
}

SELL_L = (16, 32, 128)
RGCSR_G = (4, 8, 16, 32)
CONFIGS = [("sell", L) for L in SELL_L] + [("rgcsr", G) for G in RGCSR_G]


@functools.lru_cache(maxsize=None)
def _dense(case):
    return CASES[case]()


@functools.lru_cache(maxsize=None)
def _packs(case, fmt, rows):
    """(reference pack, port pack) of one case in one format."""
    d = _dense(case)
    if fmt == "sell":
        return (r_pack_sell(RCSR.from_dense(d), lane_width=rows),
                SE.pack_sell(CSR.from_dense(d), lane_width=rows))
    return (r_pack_rgcsr(r_rgcsr.RGCSR.from_csr(RCSR.from_dense(d), rows)),
            RG.pack_rgcsr(rgcsr.RGCSR.from_csr(CSR.from_dense(d), rows)))


ENTRY = {"sell": (ops.sell_spmv, ops.sell_spmm),
         "rgcsr": (ops.rgcsr_spmv, ops.rgcsr_spmm)}
PACK_FIELDS = {"sell": ("indices", "values"),
               "rgcsr": ("deltas", "values", "nnz")}


def _oracle(fmt, rp, x):
    """The reference's jnp oracle, flattened to the matrix's rows."""
    if fmt == "sell":
        y = sell_spmv_ref(rp.indices, rp.values, x)
    else:
        y = rgcsr_spmv_ref(rp.deltas, rp.values, rp.nnz, x)
    return np.asarray(y).reshape(-1)[:rp.shape[0]]


def _rtol(d):
    return 1e-12 if d.dtype == np.float64 else 1e-4


def _atol(d):
    """Floor for rows whose sum cancels, where two summation orders differ
    by a few ulps of the terms: the reference's own (tests/test_rgcsr.py,
    tests/test_kernels.py::TestSellKernel), 1e-5 for f32 and none for f64."""
    return 1e-30 if d.dtype == np.float64 else 1e-5


def _x(d, seed, *cols):
    return _rng(seed).standard_normal((d.shape[1], *cols)).astype(d.dtype)


def _cfg_id(c):
    return f"{c[0]}-{c[1]}"


# ---------------------------------------------------------------------------
# byte equality with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", CONFIGS, ids=_cfg_id)
@pytest.mark.parametrize("case", list(CASES))
def test_pack_byte_equal(case, cfg):
    rp, p = _packs(case, *cfg)
    for f in PACK_FIELDS[cfg[0]]:
        got, want = getattr(p, f), getattr(rp, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert tuple(p.shape) == tuple(rp.shape)


@pytest.mark.parametrize("G", RGCSR_G)
@pytest.mark.parametrize("case", list(CASES))
def test_rgcsr_fields_and_sizes_equal(case, G):
    d = _dense(case)
    r = rgcsr.RGCSR.from_csr(CSR.from_dense(d), G)
    rr = r_rgcsr.RGCSR.from_csr(RCSR.from_dense(d), G)
    for f in ("group_ptr", "local_indptr", "delta_indices", "values"):
        np.testing.assert_array_equal(getattr(r, f), getattr(rr, f),
                                      err_msg=f)
        assert getattr(r, f).dtype == getattr(rr, f).dtype, f
    assert r.nbytes == rr.nbytes
    assert r.nbytes == rgcsr.rgcsr_nbytes_exact(r.row_nnz(), G,
                                                d.dtype.itemsize)
    assert rgcsr.max_group_nnz(r.row_nnz(), G) == r.max_group_nnz
    a = CSR.from_dense(d)
    back = r.to_csr()
    np.testing.assert_array_equal(back.indptr, a.indptr)
    np.testing.assert_array_equal(back.indices, a.indices)
    x = _x(d, 3)
    np.testing.assert_array_equal(r.spmv(x), rr.spmv(x))


@pytest.mark.parametrize("case", list(CASES))
def test_all_format_nbytes_equal(case):
    d = _dense(case)
    got = all_format_nbytes(CSR.from_dense(d))
    assert got == r_all_format_nbytes(RCSR.from_dense(d))
    assert list(got) == ["csr", "coo", "sell"] + [
        f"rgcsr[G={g}]" for g in rgcsr.RGCSR_GROUP_SIZES]


def test_rgcsr_dtans_reproduces_golden():
    with open(GOLDEN) as f:
        want = json.load(f)
    a = random_graphs.stencil_2d(6)
    m = encode_rgcsr_matrix(a, group_size=8, shared_table=True)
    rm = r_encode_rgcsr(r_graphs.stencil_2d(6), group_size=8,
                        shared_table=True)
    assert isinstance(m, RGCSRdtANS) and m.group_size == want["group_size"]
    assert m.nbytes == want["nbytes"] == rm.nbytes
    assert m.n_groups == rm.n_groups and m.row_len_bytes == rm.row_len_bytes
    assert m.lane_width == want["lane_width"]
    assert list(m.shape) == want["shape"]
    assert np.dtype(m.dtype).name == want["dtype"]
    assert m.row_nnz.tolist() == want["row_nnz"]
    assert m.stream.tolist() == want["stream"]
    assert m.slice_offsets.tolist() == want["slice_offsets"]
    assert [e.tolist() for e in m.esc_streams] == want["esc_streams"]
    assert m.esc_offsets.tolist() == want["esc_offsets"]
    assert m.pattern.tolist() == want["pattern"]
    for t, wt in zip(m.tables, want["tables"]):
        for f in ("esc_first", "esc_base", "esc_raw_bits", "used_slots",
                  "K", "M"):
            assert int(getattr(t, f)) == wt[f], f


GENERATORS = {
    "erdos_renyi": lambda g: g.erdos_renyi(300, 5, _rng(7)),
    "watts_strogatz": lambda g: g.watts_strogatz(200, 3, 0.2, _rng(8)),
    "barabasi_albert": lambda g: g.barabasi_albert(120, 3, _rng(9)),
    "stencil_2d": lambda g: g.stencil_2d(9),
    "stencil_2d-f32": lambda g: g.stencil_2d(7, dtype=np.float32),
    "banded": lambda g: g.banded(100, 5, rng=_rng(10)),
    "block_sparse": lambda g: g.block_sparse(12, 10, (2, 3), 0.2, _rng(11)),
}


@pytest.mark.parametrize("gen", list(GENERATORS))
def test_random_graphs_equal(gen):
    got, want = GENERATORS[gen](random_graphs), GENERATORS[gen](r_graphs)
    assert tuple(got.shape) == tuple(want.shape)
    for f in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype


# ---------------------------------------------------------------------------
# ops against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [("sell", 16), ("sell", 128), ("rgcsr", 4),
                                 ("rgcsr", 32)], ids=_cfg_id)
@pytest.mark.parametrize("case", list(CASES))
def test_ops_vs_reference_oracle(case, cfg):
    """spmv and every spmm column against the jnp oracle; y accumulates."""
    fmt, _ = cfg
    d = _dense(case)
    rp, p = _packs(case, *cfg)
    one, many = ENTRY[fmt]
    x = _x(d, 12)
    got = one(p, x, device="cpu")
    assert got.dtype == (torch.float64 if d.dtype == np.float64
                         else torch.float32)
    np.testing.assert_allclose(got.numpy(), _oracle(fmt, rp, x),
                               rtol=_rtol(d), atol=_atol(d))
    X = _x(d, 13, 3)
    Y = many(p, X, device="cpu", bn=2).numpy()
    for b in range(3):
        np.testing.assert_allclose(Y[:, b], _oracle(fmt, rp, X[:, b]),
                                   rtol=_rtol(d), atol=_atol(d))
    y0 = _rng(14).standard_normal((d.shape[0], 3)).astype(d.dtype)
    np.testing.assert_allclose(many(p, X, y0, device="cpu").numpy(),
                               d @ X + y0, rtol=_rtol(d), atol=1e-6)
    np.testing.assert_allclose(one(p, x, y0[:, 0], device="cpu").numpy(),
                               d @ x + y0[:, 0], rtol=_rtol(d), atol=1e-6)


@pytest.mark.parametrize("case", ["random-f32", "random-f64"])
@pytest.mark.parametrize("cfg", [("sell", 16), ("rgcsr", 8)], ids=_cfg_id)
def test_ops_vs_reference_interpret_kernels(case, cfg):
    """Against the reference's own entry points, Pallas in interpret mode."""
    fmt, _ = cfg
    d = _dense(case)
    rp, p = _packs(case, *cfg)
    one, many = ENTRY[fmt]
    r_one, r_many = ((r_ops.sell_spmv, r_ops.sell_spmm) if fmt == "sell"
                     else (r_ops.rgcsr_spmv, r_ops.rgcsr_spmm))
    x, X = _x(d, 15), _x(d, 16, 4)
    y0 = _rng(17).standard_normal(d.shape[0]).astype(d.dtype)
    np.testing.assert_allclose(one(p, x, y0, device="cpu").numpy(),
                               np.asarray(r_one(rp, x, y0)),
                               rtol=_rtol(d), atol=_atol(d))
    np.testing.assert_allclose(many(p, X, device="cpu", bn=3).numpy(),
                               np.asarray(r_many(rp, X, bn=3)),
                               rtol=_rtol(d), atol=_atol(d))


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", CONFIGS, ids=_cfg_id)
@pytest.mark.parametrize("case", ["er-f64", "random-f32", "empty-rows"])
def test_schedules_bitwise(case, cfg):
    """B=1 spmm is spmv; tiles (bn 1, 24) are the untiled result; every
    spmm column is the spmv of that column."""
    fmt, _ = cfg
    d = _dense(case)
    _, p = _packs(case, *cfg)
    one, many = ENTRY[fmt]
    X = _x(d, 18, 30)
    untiled = many(p, X, device="cpu")
    for bn in (1, 24):
        assert torch.equal(many(p, X, device="cpu", bn=bn), untiled)
    for b in (0, 7, 29):
        assert torch.equal(untiled[:, b], one(p, X[:, b], device="cpu"))
    assert torch.equal(many(p, X[:, :1], device="cpu")[:, 0],
                       one(p, X[:, 0], device="cpu"))


@pytest.mark.parametrize("fmt", list(ENTRY))
def test_empty_batch_and_rhs_shape_checks(fmt):
    d = _dense("random-f32")
    _, p = _packs("random-f32", fmt, 16)
    one, many = ENTRY[fmt]
    out = many(p, np.zeros((d.shape[1], 0), d.dtype), device="cpu")
    assert tuple(out.shape) == (d.shape[0], 0)
    y0 = np.ones((d.shape[0], 0), d.dtype)
    assert tuple(many(p, np.zeros((d.shape[1], 0), d.dtype), y0,
                      device="cpu").shape) == (d.shape[0], 0)
    with pytest.raises(ValueError):
        many(p, np.zeros(d.shape[1], d.dtype), device="cpu")
    with pytest.raises(ValueError):
        many(p, np.zeros((d.shape[1] + 1, 2), d.dtype), device="cpu")
    with pytest.raises(ValueError):
        one(p, np.zeros((d.shape[1], 2), d.dtype), device="cpu")
    with pytest.raises(ValueError, match="bn"):
        many(p, np.zeros((d.shape[1], 3), d.dtype), device="cpu", bn=0)


@pytest.mark.parametrize("shape", [(0, 5), (6, 0), (7, 4)],
                         ids=["no-rows", "no-columns", "all-zero"])
@pytest.mark.parametrize("cfg", [("sell", 4), ("rgcsr", 4)], ids=_cfg_id)
def test_degenerate_shapes(cfg, shape):
    """S = 0, and packs of only padding (Wg = 1): zeros of the right shape,
    as the reference's oracle gives."""
    fmt, rows = cfg
    d = np.zeros(shape, np.float32)
    rp, p = (
        (r_pack_sell(RCSR.from_dense(d), rows),
         SE.pack_sell(CSR.from_dense(d), rows)) if fmt == "sell" else
        (r_pack_rgcsr(r_rgcsr.RGCSR.from_csr(RCSR.from_dense(d), rows)),
         RG.pack_rgcsr(rgcsr.RGCSR.from_csr(CSR.from_dense(d), rows))))
    for f in PACK_FIELDS[fmt]:
        np.testing.assert_array_equal(getattr(p, f), getattr(rp, f))
    one, many = ENTRY[fmt]
    x = np.ones(shape[1], np.float32)
    assert torch.equal(one(p, x, device="cpu"), torch.zeros(shape[0]))
    assert torch.equal(many(p, np.ones((shape[1], 3), np.float32),
                            device="cpu"), torch.zeros(shape[0], 3))


@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("cfg", [("sell", 16), ("rgcsr", 4)], ids=_cfg_id)
def test_nonfinite_x0_does_not_leak_through_padding(cfg, bad):
    """Column 0 is empty, so padding (index -1 / delta 0, clipped to 0) is
    the only reader of x[0]: a masked term is a select, as in the oracle."""
    fmt, rows = cfg
    d = _random_dense(50, 12, 0.4, np.float64, 19)
    d[:, 0] = 0
    d[7] = 0
    a = CSR.from_dense(d)
    if fmt == "sell":
        rp = r_pack_sell(RCSR.from_dense(d), rows)
        p = SE.pack_sell(a, rows)
    else:
        rp = r_pack_rgcsr(r_rgcsr.RGCSR.from_csr(RCSR.from_dense(d), rows))
        p = RG.pack_rgcsr(rgcsr.RGCSR.from_csr(a, rows))
    one, many = ENTRY[fmt]
    x = _x(d, 20)
    x[0] = bad
    want = _oracle(fmt, rp, x)
    assert np.isfinite(want).all()
    got = one(p, x, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-30)
    X = np.stack([x, -x], axis=1)
    assert np.isfinite(many(p, X, device="cpu", bn=1).numpy()).all()


@pytest.mark.parametrize("fmt", list(ENTRY))
def test_counters_and_device_bytes(fmt):
    """One pass records once under the reference's kind names, with the
    device tensors' bytes; a CPU pass launches no kernel."""
    d = _dense("random-f64")
    _, p = _packs("random-f64", fmt, 8)
    mod, one, many = (SE, *ENTRY["sell"]) if fmt == "sell" else \
        (RG, *ENTRY["rgcsr"])
    dm = mod.to_device(p, "cpu")
    assert mod.to_device(p, "cpu") is dm
    want = sum(int(t.nbytes) for t in vars(dm).values()
               if isinstance(t, torch.Tensor))
    assert dm.nbytes == want
    reg = obs.default_registry()
    names = [f"kernels.{fmt}_spmv_calls", f"kernels.{fmt}_spmm_calls",
             "kernels.matrix_bytes", "kernels.decode_invocations"]
    before = {k: reg.counter(k).value for k in names}
    launched = dict(mod.launches)
    one(p, _x(d, 21), device="cpu")
    many(p, _x(d, 22, 5), device="cpu", bn=2)
    many(p, _x(d, 23, 1), device="cpu")          # B=1: one spmv pass
    after = {k: reg.counter(k).value - before[k] for k in names}
    assert after == {names[0]: 2, names[1]: 1, names[2]: 3 * dm.nbytes,
                     names[3]: 0}
    assert mod.launches == launched


def test_interleaved_layout():
    a = np.arange(3 * 5 * 4).reshape(3, 5, 4)           # S=3, rows=5, Wg=4
    t = padded.interleave(a, -1)
    assert t.shape == (1, 4, 32) and t.flags.c_contiguous
    tt = torch.from_numpy(t)
    for w in range(4):
        np.testing.assert_array_equal(padded.position(tt, w, 15).numpy(),
                                      a.reshape(15, 4)[:, w])
    assert (t[0, :, 15:] == -1).all()
    assert padded.interleave(np.zeros((0, 4, 1)), 0).shape == (0, 1, 32)


def test_values_other_than_f32_f64_refused():
    d = _random_dense(10, 8, 0.5, np.float32, 24).astype(np.float16)
    ps = SE.pack_sell(CSR.from_dense(d), 8)
    with pytest.raises(TypeError, match="float32 or float64"):
        SE.to_device(ps, "cpu")


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, ps = _packs("random-f32", "sell", 16)
    _, pr = _packs("random-f32", "rgcsr", 4)
    x = np.ones(70, np.float32)
    for fn, p in ((ops.sell_spmv, ps), (ops.rgcsr_spmv, pr)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(p, x)
    for fn, p in ((ops.sell_spmm, ps), (ops.rgcsr_spmm, pr)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(p, x[:, None].repeat(2, 1), device="cuda")


# ---------------------------------------------------------------------------
# RGCSR-dtANS through the existing ops, and carrying packs across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,G", [("random-f32", 8), ("empty-rows", 4),
                                    ("stencil-f64", 32)])
def test_rgcsr_dtans_through_ops(case, G):
    d = _dense(case)
    m = encode_rgcsr_matrix(CSR.from_dense(d), group_size=G)
    rm = r_encode_rgcsr(RCSR.from_dense(d), group_size=G)
    assert m.nbytes == rm.nbytes and m.lane_width == G
    np.testing.assert_array_equal(m.stream, rm.stream)
    x, X = _x(d, 25), _x(d, 26, 3)
    want = np.asarray(r_spmv_ref(r_pack(rm), x))
    np.testing.assert_allclose(ops.spmv(m, x, device="cpu").numpy(), want,
                               rtol=_rtol(d), atol=_atol(d))
    Y = ops.spmm(m, X, device="cpu").numpy()
    for b in range(3):
        np.testing.assert_allclose(
            Y[:, b], np.asarray(r_spmv_ref(r_pack(rm), X[:, b])),
            rtol=_rtol(d), atol=_atol(d))
    assert pack_matrix(m).lane_width == G


@pytest.mark.parametrize("cfg", [("sell", 32), ("rgcsr", 8)], ids=_cfg_id)
def test_convert_round_trip(cfg):
    """A JAX pack carried across is the port's pack byte for byte, and
    serves the same result."""
    fmt, _ = cfg
    d = _dense("banded-f32")
    rp, p = _packs("banded-f32", *cfg)
    to_arrays, from_arrays = (
        (convert.packed_sell_to_arrays, convert.packed_sell_from_arrays)
        if fmt == "sell" else
        (convert.packed_rgcsr_to_arrays, convert.packed_rgcsr_from_arrays))
    arrays = to_arrays(rp)
    assert all(isinstance(v, np.ndarray) for v in arrays.values())
    q = from_arrays(arrays, device="cpu")
    assert type(q) is type(p)
    for f in PACK_FIELDS[fmt]:
        got, want = getattr(q, f), getattr(p, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert q.shape == tuple(p.shape)
    one, many = ENTRY[fmt]
    X = _x(d, 27, 4)
    assert torch.equal(many(q, X, device="cpu"), many(p, X, device="cpu"))
    assert torch.equal(one(q, X[:, 0], device="cpu"),
                       one(p, X[:, 0], device="cpu"))
    assert to_arrays(q).keys() == arrays.keys()
