"""The port's blocked path (BCSR, BCSR-dtANS and the fused shared-column
contraction) against the JAX package.

BCSR fields, byte counts, `block_fill_csr`, the packs and the BCSR-dtANS
golden must be equal to the reference's; the ops run on the CPU (their
kernels' plain versions) and must agree with the reference's jnp oracle
and its interpret-mode Pallas entry points within its tolerances (rtol 1e-4
f32, 1e-12 f64: the reference sums over (W, c) in no stated order, the port
w-major then j). The port's own contracts hold bitwise: column tiles, SpMM
at B=1, each SpMM column against SpMV, and the fused contraction against
the generic one.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from repro.core.bcsr_dtans import encode_bcsr_matrix as r_encode_bcsr
from repro.kernels import ops as r_ops
from repro.kernels.bcsr_spmv import bcsr_spmv_ref
from repro.kernels.bcsr_spmv import pack_bcsr as r_pack_bcsr
from repro.kernels.pack import pack_matrix as r_pack
from repro.kernels.ref import spmv_ref as r_spmv_ref
from repro.serving.sparse_linear import SparseLinear as RSparseLinear
from repro.sparse import bcsr as r_bcsr
from repro.sparse import random_graphs as r_graphs
from repro.sparse.formats import CSR as RCSR

from repro_torch import convert, obs
from repro_torch.core.bcsr_dtans import BCSRdtANS, encode_bcsr_matrix
from repro_torch.core.csr_dtans import CSRdtANS, encode_matrix
from repro_torch.kernels import bcsr_spmv as BC
from repro_torch.kernels import dtans_spmv as K
from repro_torch.kernels import ops, padded
from repro_torch.kernels.pack import pack_matrix, to_device
from repro_torch.sparse import bcsr, random_graphs
from repro_torch.sparse.formats import CSR

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "bitstream_bcsr_stencil6_f64_B2x2.json")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _random_dense(m, n, density, dtype, seed):
    """Small integers, as tests/test_bcsr.py::_random_csr makes them."""
    rng = _rng(seed)
    d = rng.integers(-3, 4, size=(m, n)).astype(dtype)
    d[rng.random((m, n)) >= density] = 0
    return d


# The matrices of tests/test_bcsr.py, as dense arrays.
CASES = {
    "er-f64": lambda: r_graphs.erdos_renyi(100, 6, _rng(1)).to_dense(),
    "stencil-f64": lambda: r_graphs.stencil_2d(15).to_dense(),
    "zeros": lambda: np.zeros((8, 9)),
    "diag": lambda: np.diag(np.r_[np.zeros(5), np.arange(1.0, 7.0)]),
    "ones-wide": lambda: np.ones((3, 41)),
    "random-f32": lambda: _random_dense(66, 43, 0.15, np.float32, 5),
    "block-sparse-f32": lambda: r_graphs.block_sparse(
        9, 7, (2, 3), 0.3, _rng(2), dtype=np.float32).to_dense(),
}
SHAPES = bcsr.BCSR_BLOCK_SHAPES


@functools.lru_cache(maxsize=None)
def _dense(case):
    return CASES[case]()


@functools.lru_cache(maxsize=None)
def _formats(case, bs):
    """(reference BCSR, port BCSR, reference pack, port pack)."""
    d = _dense(case)
    rb = r_bcsr.BCSR.from_csr(RCSR.from_dense(d), bs)
    b = bcsr.BCSR.from_csr(CSR.from_dense(d), bs)
    return rb, b, r_pack_bcsr(rb), BC.pack_bcsr(b)


def _rtol(d):
    return 1e-12 if d.dtype == np.float64 else 1e-4


def _atol(d):
    """Floor for rows whose sum cancels (the reference's own, as in
    tests/test_torch_formats.py): 1e-5 for f32, none for f64."""
    return 1e-30 if d.dtype == np.float64 else 1e-5


def _x(d, seed, *cols):
    return _rng(seed).standard_normal((d.shape[1], *cols)).astype(d.dtype)


def _oracle(rp, x):
    """The reference's jnp oracle, flattened to the matrix's rows."""
    y = bcsr_spmv_ref(rp.block_cols, rp.values, x)
    return np.asarray(y).reshape(-1)[:rp.shape[0]]


def _bs_id(bs):
    return f"{bs[0]}x{bs[1]}"


# ---------------------------------------------------------------------------
# host formats: equal to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs", SHAPES, ids=_bs_id)
@pytest.mark.parametrize("case", list(CASES))
def test_bcsr_fields_and_sizes_equal(case, bs):
    d = _dense(case)
    rb, b, _, _ = _formats(case, bs)
    for f in ("block_ptr", "block_cols", "values"):
        got, want = getattr(b, f), getattr(rb, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (b.n_blocks, b.n_block_rows, b.nnz_stored, b.nbytes) == \
        (rb.n_blocks, rb.n_block_rows, rb.nnz_stored, rb.nbytes)
    a = CSR.from_dense(d)
    nb = bcsr.count_nonempty_blocks(a.indptr, a.indices, a.shape, bs)
    assert nb == b.n_blocks == r_bcsr.count_nonempty_blocks(
        a.indptr, a.indices, a.shape, bs)
    assert b.nbytes == bcsr.bcsr_nbytes_exact(nb, d.shape[0], bs,
                                              d.dtype.itemsize)
    np.testing.assert_array_equal(b.to_dense(), d)
    back = b.to_csr()
    np.testing.assert_array_equal(back.indptr, a.indptr)
    np.testing.assert_array_equal(back.indices, a.indices)
    x = _x(d, 3)
    np.testing.assert_array_equal(b.spmv(x), rb.spmv(x))


@pytest.mark.parametrize("bs", SHAPES, ids=_bs_id)
@pytest.mark.parametrize("case", list(CASES))
def test_block_fill_csr_equal(case, bs):
    d = _dense(case)
    got = bcsr.block_fill_csr(CSR.from_dense(d), bs)
    want = r_bcsr.block_fill_csr(RCSR.from_dense(d), bs)
    for f in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    np.testing.assert_array_equal(got.to_dense(), d)


@pytest.mark.parametrize("bs", SHAPES, ids=_bs_id)
@pytest.mark.parametrize("case", list(CASES))
def test_pack_bcsr_byte_equal(case, bs):
    _, _, rp, p = _formats(case, bs)
    for f in ("block_cols", "values"):
        got, want = getattr(p, f), getattr(rp, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert tuple(p.shape) == tuple(rp.shape)
    assert tuple(p.block_shape) == tuple(rp.block_shape)


def test_bcsr_dtans_reproduces_golden():
    with open(GOLDEN) as f:
        want = json.load(f)
    m = encode_bcsr_matrix(random_graphs.stencil_2d(6), block_shape=(2, 2),
                           shared_table=True)
    rm = r_encode_bcsr(r_graphs.stencil_2d(6), block_shape=(2, 2),
                       shared_table=True)
    assert isinstance(m, BCSRdtANS) and isinstance(m, CSRdtANS)
    assert list(m.block_shape) == want["block_shape"]
    assert m.n_blocks == want["n_blocks"] == rm.n_blocks
    assert m.nbytes == want["nbytes"] == rm.nbytes
    assert m.block_count_bytes == rm.block_count_bytes
    assert m.n_block_rows == rm.n_block_rows
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


@functools.lru_cache(maxsize=None)
def _bcsr_dtans(case, bs):
    """(reference matrix, port matrix) of one case encoded as BCSR-dtANS."""
    d = _dense(case)
    return (r_encode_bcsr(RCSR.from_dense(d), block_shape=bs),
            encode_bcsr_matrix(CSR.from_dense(d), block_shape=bs))


DTANS_CASES = [("random-f32", (2, 2)), ("random-f32", (4, 4)),
               ("stencil-f64", (2, 2)), ("stencil-f64", (4, 2)),
               ("block-sparse-f32", (2, 4)), ("diag", (8, 8))]
DTANS_IDS = [f"{c}-{_bs_id(bs)}" for c, bs in DTANS_CASES]


@pytest.mark.parametrize("case,bs", DTANS_CASES, ids=DTANS_IDS)
def test_bcsr_dtans_encode_and_pack_equal(case, bs):
    rm, m = _bcsr_dtans(case, bs)
    assert m.nbytes == rm.nbytes and m.n_blocks == rm.n_blocks
    assert m.lane_width == bs[0] and tuple(m.block_shape) == bs
    np.testing.assert_array_equal(m.stream, rm.stream)
    np.testing.assert_array_equal(m.row_nnz, rm.row_nnz)
    rp, p = r_pack(rm), pack_matrix(m)
    assert p.shared_cols and rp.shared_cols
    for f in ("stream", "esc", "ns", "nnz", "row_valid", "tab_symbol",
              "tab_digit", "tab_base", "tab_is_esc"):
        np.testing.assert_array_equal(getattr(p, f), getattr(rp, f),
                                      err_msg=f)
    assert p.max_nseg == rp.max_nseg


# ---------------------------------------------------------------------------
# BCSR ops against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs", SHAPES, ids=_bs_id)
@pytest.mark.parametrize("case", ["er-f64", "random-f32", "ones-wide",
                                  "block-sparse-f32"])
def test_bcsr_ops_vs_reference_oracle(case, bs):
    """spmv and every spmm column against the jnp oracle; y accumulates."""
    d = _dense(case)
    _, _, rp, p = _formats(case, bs)
    x = _x(d, 12)
    got = ops.bcsr_spmv(p, x, device="cpu")
    assert got.dtype == (torch.float64 if d.dtype == np.float64
                         else torch.float32)
    np.testing.assert_allclose(got.numpy(), _oracle(rp, x), rtol=_rtol(d),
                               atol=_atol(d))
    X = _x(d, 13, 3)
    Y = ops.bcsr_spmm(p, X, device="cpu", bn=2).numpy()
    for b in range(3):
        np.testing.assert_allclose(Y[:, b], _oracle(rp, X[:, b]),
                                   rtol=_rtol(d), atol=_atol(d))
    y0 = _rng(14).standard_normal((d.shape[0], 3)).astype(d.dtype)
    np.testing.assert_allclose(ops.bcsr_spmm(p, X, y0, device="cpu").numpy(),
                               d @ X + y0, rtol=_rtol(d), atol=1e-5)
    np.testing.assert_allclose(
        ops.bcsr_spmv(p, x, y0[:, 0], device="cpu").numpy(),
        d @ x + y0[:, 0], rtol=_rtol(d), atol=1e-5)


@pytest.mark.parametrize("bs", [(2, 2), (4, 2)], ids=_bs_id)
@pytest.mark.parametrize("case", ["random-f32", "er-f64"])
def test_bcsr_ops_vs_reference_interpret_kernels(case, bs):
    """Against the reference's own entry points, Pallas in interpret mode."""
    d = _dense(case)
    _, _, rp, p = _formats(case, bs)
    x, X = _x(d, 15), _x(d, 16, 4)
    y0 = _rng(17).standard_normal(d.shape[0]).astype(d.dtype)
    np.testing.assert_allclose(ops.bcsr_spmv(p, x, y0, device="cpu").numpy(),
                               np.asarray(r_ops.bcsr_spmv(rp, x, y0)),
                               rtol=_rtol(d), atol=_atol(d))
    np.testing.assert_allclose(ops.bcsr_spmm(p, X, device="cpu", bn=3).numpy(),
                               np.asarray(r_ops.bcsr_spmm(rp, X, bn=3)),
                               rtol=_rtol(d), atol=_atol(d))


@pytest.mark.parametrize("bs", SHAPES, ids=_bs_id)
@pytest.mark.parametrize("case", ["er-f64", "random-f32", "diag"])
def test_bcsr_schedules_bitwise(case, bs):
    """B=1 spmm is spmv; tiles (bn 1, 24) are the untiled result; every
    spmm column is the spmv of that column."""
    d = _dense(case)
    _, _, _, p = _formats(case, bs)
    X = _x(d, 18, 30)
    untiled = ops.bcsr_spmm(p, X, device="cpu")
    for bn in (1, 24):
        assert torch.equal(ops.bcsr_spmm(p, X, device="cpu", bn=bn), untiled)
    for b in (0, 7, 29):
        assert torch.equal(untiled[:, b],
                           ops.bcsr_spmv(p, X[:, b], device="cpu"))
    assert torch.equal(ops.bcsr_spmm(p, X[:, :1], device="cpu")[:, 0],
                       ops.bcsr_spmv(p, X[:, 0], device="cpu"))


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_bcsr_edge_cells_multiply_last_x(bad):
    """The mask is the block column only, as in the reference: a real
    block's cells past column n - 1 hold 0 and multiply x[n - 1], so a
    non-finite x[n - 1] gives NaN exactly where the reference's does. A
    padded slot is a select: a non-finite x[0] reaches no row when no
    block covers column 0."""
    d = _random_dense(21, 11, 0.3, np.float64, 19)   # 11 = 2 * 4 + 3
    d[:, :4] = 0                                     # no block covers 0
    d[3, 10] = 2.0
    d[12] = 0
    for bs in ((2, 2), (4, 4), (2, 4)):
        rb = r_bcsr.BCSR.from_csr(RCSR.from_dense(d), bs)
        rp = r_pack_bcsr(rb)
        p = BC.pack_bcsr(bcsr.BCSR.from_csr(CSR.from_dense(d), bs))
        x = _x(d, 20)
        x[-1] = bad
        want = _oracle(rp, x)
        got = ops.bcsr_spmv(p, x, device="cpu").numpy()
        assert not np.isfinite(want).all()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-30)
        x = _x(d, 21)
        x[0] = bad
        want = _oracle(rp, x)
        assert np.isfinite(want).all()
        np.testing.assert_allclose(ops.bcsr_spmv(p, x, device="cpu").numpy(),
                                   want, rtol=1e-12, atol=1e-30)
        X = np.stack([x, -x], axis=1)
        assert np.isfinite(ops.bcsr_spmm(p, X, device="cpu",
                                         bn=1).numpy()).all()


def test_bcsr_empty_batch_and_rhs_shape_checks():
    d = _dense("random-f32")
    _, _, _, p = _formats("random-f32", (4, 4))
    out = ops.bcsr_spmm(p, np.zeros((d.shape[1], 0), d.dtype), device="cpu")
    assert tuple(out.shape) == (d.shape[0], 0)
    y0 = np.ones((d.shape[0], 0), d.dtype)
    assert tuple(ops.bcsr_spmm(p, np.zeros((d.shape[1], 0), d.dtype), y0,
                               device="cpu").shape) == (d.shape[0], 0)
    with pytest.raises(ValueError):
        ops.bcsr_spmm(p, np.zeros(d.shape[1], d.dtype), device="cpu")
    with pytest.raises(ValueError):
        ops.bcsr_spmm(p, np.zeros((d.shape[1] + 1, 2), d.dtype),
                      device="cpu")
    with pytest.raises(ValueError):
        ops.bcsr_spmv(p, np.zeros((d.shape[1], 2), d.dtype), device="cpu")
    with pytest.raises(ValueError, match="bn"):
        ops.bcsr_spmm(p, np.zeros((d.shape[1], 3), d.dtype), device="cpu",
                      bn=0)


@pytest.mark.parametrize("shape", [(0, 5), (6, 0), (7, 4)],
                         ids=["no-rows", "no-columns", "all-zero"])
def test_bcsr_degenerate_shapes(shape):
    """No block rows, no columns, and a pack of only padding (W = 1):
    zeros of the right shape, as the reference's oracle gives."""
    d = np.zeros(shape, np.float32)
    rp = r_pack_bcsr(r_bcsr.BCSR.from_csr(RCSR.from_dense(d), (4, 2)))
    p = BC.pack_bcsr(bcsr.BCSR.from_csr(CSR.from_dense(d), (4, 2)))
    for f in ("block_cols", "values"):
        np.testing.assert_array_equal(getattr(p, f), getattr(rp, f))
    x = np.ones(shape[1], np.float32)
    assert torch.equal(ops.bcsr_spmv(p, x, device="cpu"),
                       torch.zeros(shape[0]))
    assert torch.equal(ops.bcsr_spmm(p, np.ones((shape[1], 3), np.float32),
                                     device="cpu"), torch.zeros(shape[0], 3))


def test_bcsr_counters_and_device_bytes():
    """One pass records once under the reference's kind names, with the
    device tensors' bytes; a CPU pass launches no kernel."""
    d = _dense("er-f64")
    _, _, _, p = _formats("er-f64", (2, 4))
    db = BC.to_device(p, "cpu")
    assert BC.to_device(p, "cpu") is db
    assert db.nbytes == int(db.block_cols.nbytes + db.values.nbytes
                            + db.stops.nbytes)
    reg = obs.default_registry()
    names = ["kernels.bcsr_spmv_calls", "kernels.bcsr_spmm_calls",
             "kernels.matrix_bytes", "kernels.decode_invocations"]
    before = {k: reg.counter(k).value for k in names}
    launched = dict(BC.launches)
    ops.bcsr_spmv(p, _x(d, 21), device="cpu")
    ops.bcsr_spmm(p, _x(d, 22, 5), device="cpu", bn=2)
    ops.bcsr_spmm(p, _x(d, 23, 1), device="cpu")          # B=1: one spmv
    after = {k: reg.counter(k).value - before[k] for k in names}
    assert after == {names[0]: 2, names[1]: 1, names[2]: 3 * db.nbytes,
                     names[3]: 0}
    assert BC.launches == launched


def test_bcsr_device_layout():
    """Row i of block row s holds its W tiles' row i side by side, stored
    in chunks of 32 rows; the block columns stay (S, W)."""
    _, _, _, p = _formats("random-f32", (4, 2))
    db = BC.to_device(p, "cpu")
    S, W, r, c = p.values.shape
    assert tuple(db.values.shape) == (-(-S * r // 32), W * c, 32)
    for w in range(W):
        for j in range(c):
            np.testing.assert_array_equal(
                padded.position(db.values, w * c + j, S * r).numpy(),
                p.values[:, w, :, j].reshape(-1))
    np.testing.assert_array_equal(db.block_cols.numpy(), p.block_cols)


def test_bcsr_values_other_than_f32_f64_refused():
    d = _random_dense(10, 8, 0.5, np.float32, 24).astype(np.float16)
    pb = BC.pack_bcsr(bcsr.BCSR.from_csr(CSR.from_dense(d), (2, 2)))
    with pytest.raises(TypeError, match="float32 or float64"):
        BC.to_device(pb, "cpu")


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, _, _, p = _formats("random-f32", (2, 2))
    _, m = _bcsr_dtans("random-f32", (2, 2))
    x = np.ones(43, np.float32)
    for call in (lambda: ops.bcsr_spmv(p, x),
                 lambda: ops.bcsr_spmm(p, x[:, None].repeat(2, 1)),
                 lambda: ops.spmv(m, x, fused=True),
                 lambda: ops.spmm(m, x[:, None].repeat(2, 1), device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# the fused BCSR-dtANS contraction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,bs", DTANS_CASES, ids=DTANS_IDS)
def test_fused_vs_reference_oracle_and_generic(case, bs):
    """``fused=None`` follows the pack (fused), ``fused=False`` runs the
    generic contraction: bitwise equal, and within the reference's
    tolerance of its jnp oracle."""
    d = _dense(case)
    rm, m = _bcsr_dtans(case, bs)
    x, X = _x(d, 25), _x(d, 26, 5)
    fused = ops.spmv(m, x, device="cpu")
    assert torch.equal(fused, ops.spmv(m, x, device="cpu", fused=True))
    assert torch.equal(fused, ops.spmv(m, x, device="cpu", fused=False))
    np.testing.assert_allclose(fused.numpy(),
                               np.asarray(r_spmv_ref(r_pack(rm), x)),
                               rtol=_rtol(d), atol=_atol(d))
    Y = ops.spmm(m, X, device="cpu")
    assert torch.equal(Y, ops.spmm(m, X, device="cpu", fused=False))
    assert torch.equal(ops.spmm(m, X, device="cpu", bn=2), Y)
    assert torch.equal(ops.spmm(m, X[:, :1], device="cpu")[:, 0],
                       ops.spmv(m, X[:, 0], device="cpu"))
    np.testing.assert_allclose(Y.numpy(), d @ X, rtol=_rtol(d), atol=1e-5)


@pytest.mark.parametrize("case,bs", [("random-f32", (2, 2)),
                                     ("stencil-f64", (4, 2))],
                         ids=["random-f32-2x2", "stencil-f64-4x2"])
def test_fused_vs_reference_interpret_kernels(case, bs):
    """Against the reference's fused entry points (``fused=True``),
    Pallas in interpret mode."""
    d = _dense(case)
    rm, m = _bcsr_dtans(case, bs)
    rp = r_pack(rm)
    x, X = _x(d, 27), _x(d, 28, 3)
    np.testing.assert_allclose(
        ops.spmv(m, x, device="cpu", fused=True).numpy(),
        np.asarray(r_ops.spmv(rp, x, fused=True)), rtol=_rtol(d),
        atol=_atol(d))
    np.testing.assert_allclose(
        ops.spmm(m, X, device="cpu", fused=True).numpy(),
        np.asarray(r_ops.spmm(rp, X, fused=True)), rtol=_rtol(d),
        atol=_atol(d))


@pytest.mark.parametrize("kind", ["spmv", "spmm"])
def test_fused_plain_gathers_lane_zero_columns(kind):
    """The fused plain version gathers at lane 0's columns: on a pack whose
    lanes hold different columns it differs from the generic one, so the
    flag really reaches the contraction."""
    d = _random_dense(40, 30, 0.3, np.float64, 29)
    dm = to_device(pack_matrix(encode_bcsr_matrix(CSR.from_dense(d),
                                                  (2, 2))), "cpu")
    gm = to_device(pack_matrix(encode_matrix(CSR.from_dense(d),
                                             lane_width=2)), "cpu")
    x = torch.as_tensor(_x(d, 30))
    if kind == "spmv":
        same = K.dtans_spmv_plain(dm, x, shared_cols=True)
        assert torch.equal(same, K.dtans_spmv_plain(dm, x))
        assert not torch.equal(K.dtans_spmv_plain(gm, x, shared_cols=True),
                               K.dtans_spmv_plain(gm, x))
    else:
        X = torch.stack([x, 2 * x], dim=1)
        same = K.dtans_spmm_plain(dm, X, shared_cols=True)
        assert torch.equal(same, K.dtans_spmm_plain(dm, X))
        assert not torch.equal(K.dtans_spmm_plain(gm, X, shared_cols=True),
                               K.dtans_spmm_plain(gm, X))


# ---------------------------------------------------------------------------
# carrying BCSR-dtANS layers and BCSR packs across
# ---------------------------------------------------------------------------

def test_convert_bcsr_dtans_layer_keeps_its_blocks():
    """A JAX `SparseLinear` over a `BCSRdtANS` comes across as one: its
    pack keeps ``shared_cols`` and serves the fused result."""
    d = _dense("block-sparse-f32")
    rm, _ = _bcsr_dtans("block-sparse-f32", (2, 4))
    rsl = RSparseLinear(mat=rm, packed=r_pack(rm), d_in=d.shape[1],
                        d_out=d.shape[0], dense_bytes=d.nbytes,
                        baseline_bytes=0)
    arrays = convert.sparse_linear_to_arrays(rsl)
    assert all(isinstance(v, np.ndarray) for v in arrays.values())
    sl = convert.sparse_linear_from_arrays(arrays, device="cpu")
    assert isinstance(sl.mat, BCSRdtANS)
    assert tuple(sl.mat.block_shape) == (2, 4)
    assert sl.mat.n_blocks == rm.n_blocks and sl.mat.nbytes == rm.nbytes
    assert sl.packed.shared_cols
    np.testing.assert_array_equal(sl.mat.stream, rm.stream)
    x = _rng(31).standard_normal((3, d.shape[1])).astype(np.float32)
    got = sl.apply(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(rsl.apply(x)),
                               rtol=1e-4, atol=1e-5)
    assert convert.sparse_linear_to_arrays(sl).keys() == arrays.keys()


def test_convert_csr_dtans_layer_stays_plain():
    d = _dense("random-f32")
    rsl = RSparseLinear.from_dense(d.T, sparsity=0.5, lane_width=16)
    sl = convert.sparse_linear_from_arrays(
        convert.sparse_linear_to_arrays(rsl), device="cpu")
    assert type(sl.mat) is CSRdtANS and not sl.packed.shared_cols
    assert "block_shape" not in convert.sparse_linear_to_arrays(sl)


def test_convert_packed_bcsr_round_trip():
    """A JAX `PackedBCSR` carried across is the port's pack byte for byte,
    and serves the same result."""
    d = _dense("er-f64")
    _, _, rp, p = _formats("er-f64", (4, 2))
    arrays = convert.packed_bcsr_to_arrays(rp)
    assert all(isinstance(v, np.ndarray) for v in arrays.values())
    q = convert.packed_bcsr_from_arrays(arrays, device="cpu")
    assert type(q) is type(p)
    for f in ("block_cols", "values"):
        got, want = getattr(q, f), getattr(p, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert q.shape == tuple(p.shape) and q.block_shape == (4, 2)
    X = _x(d, 32, 4)
    assert torch.equal(ops.bcsr_spmm(q, X, device="cpu"),
                       ops.bcsr_spmm(p, X, device="cpu"))
    assert convert.packed_bcsr_to_arrays(q).keys() == arrays.keys()
