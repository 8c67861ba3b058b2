"""The host side of the BCSR kernels' redesign and of the dtANS SpMM's
repairs, on the CPU.

The BCSR SpMV (`csrc/bcsr_spmv.cu::bcsr_spmv_kernel`, four lanes a row,
x staged in shared memory up to 48 KB) and SpMM
(`padded_rows.cuh::spmm_warp_kernel` on `tiling.padded_geometry`, a block
row's rows reading x together where r divides 32) stop each block row at
its `stops` entry. This file holds what can be checked without a card:
`block_stops` against the block columns, the geometry and default tiles,
every plain SpMM column bitwise the plain SpMV of that column, and that
skipping every position past a block row's stop gives the plain version's
bits (a hypothesis property). The kernels themselves are held against
their plain versions on the card (`tests/test_torch_gpu.py`).

The dtANS SpMM serves what its kernel refuses: lane widths past
`tiling.MAX_SPMM_LANE_WIDTH` by one SpMV launch a column
(`tiling.spmm_by_columns`), and tiles wider than a block's shared memory
holds cut to `tiling.dtans_widest_bn`. Both are held here against the JAX
package's jnp oracle (`repro.kernels.ref.spmv_ref`, column by column), at
the reference's tolerances (rtol 1e-4 f32, 1e-12 f64).
"""

import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro.core.csr_dtans import encode_matrix as r_encode
from repro.kernels.pack import pack_matrix as r_pack
from repro.kernels.ref import spmv_ref as r_spmv_ref
from repro.sparse.formats import CSR as RCSR

from repro_torch import obs
from repro_torch.core.csr_dtans import encode_matrix
from repro_torch.kernels import bcsr_spmv as BC
from repro_torch.kernels import dtans_spmv as K
from repro_torch.kernels import ops, padded, tiling
from repro_torch.kernels.pack import pack_matrix, to_device
from repro_torch.sparse.bcsr import BCSR, BCSR_BLOCK_SHAPES
from repro_torch.sparse.formats import CSR

RTOL = {np.float32: 1e-4, np.float64: 1e-12}


def _dense(m, n, density, dtype, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)).astype(dtype)
    d[rng.random((m, n)) >= density] = 0
    return d


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


# ---------------------------------------------------------------------------
# stops
# ---------------------------------------------------------------------------

def _stops_by_loop(block_cols: np.ndarray) -> np.ndarray:
    out = np.zeros(block_cols.shape[0], dtype=np.int32)
    for s, row in enumerate(block_cols):
        for w in range(row.size):
            if row[w] >= 0:
                out[s] = w + 1
    return out


@pytest.mark.parametrize("bs", BCSR_BLOCK_SHAPES, ids=str)
def test_stops_end_each_block_row_at_its_last_real_slot(bs):
    """On a matrix with empty block rows and rows of every length: the
    device matrix's stops are one past each block row's last real slot,
    0 for an empty one; every slot from there on is padding; its bytes
    count in `DeviceBCSR.nbytes`."""
    d = _dense(97, 61, 0.12, np.float32, 50)
    d[16:40] = 0
    pb = BC.pack_bcsr(BCSR.from_csr(CSR.from_dense(d), bs))
    db = BC.to_device(pb, "cpu")
    stops = db.stops.numpy()
    assert db.stops.dtype == torch.int32 and stops.shape == (
        pb.block_cols.shape[0],)
    np.testing.assert_array_equal(stops, _stops_by_loop(pb.block_cols))
    np.testing.assert_array_equal(stops, (pb.block_cols >= 0).sum(axis=1))
    assert (stops == 0).any() and stops.max() == pb.block_cols.shape[1]
    for s, stop in enumerate(stops):
        assert (pb.block_cols[s, stop:] < 0).all()
    assert db.nbytes == int(db.block_cols.nbytes + db.values.nbytes
                            + 4 * len(stops))


def test_stops_of_a_hand_made_pack():
    """-1 may stand before real slots (the stop is past the last real one,
    wherever the -1s lie), and a block row may be padding only."""
    bc = np.array([[0, -1, 3, -1],
                   [-1, -1, -1, -1],
                   [1, 2, 3, 4],
                   [-1, -1, -1, 5],
                   [5, -1, -1, -1]], dtype=np.int32)
    np.testing.assert_array_equal(BC.block_stops(bc), [3, 0, 4, 4, 1])
    assert BC.block_stops(bc).dtype == np.int32
    assert BC.block_stops(np.zeros((0, 3), np.int32)).shape == (0,)
    np.testing.assert_array_equal(BC.block_stops(np.zeros((2, 0), np.int32)),
                                  [0, 0])


# ---------------------------------------------------------------------------
# geometry and default tiles
# ---------------------------------------------------------------------------

def test_bcsr_entries_take_their_geometry():
    """The BCSR SpMM launches the padded warp kernel on
    `tiling.padded_geometry`: on the head as 2x2 (49,152 rows) at B = 64
    one 64-column slab of two columns a lane, 12 warps a block, 128
    blocks."""
    g = tiling.padded_geometry(49152, 576, 64, 64, 4)
    assert (g.bw, g.cols_per_lane, g.warps, g.blocks) == (32, 2, 12, 128)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bcsr_ops_record_the_default_tile_count(dtype):
    """`ops.bcsr_spmm` with ``bn=None`` takes `tiling.padded_bn`'s tile
    (ceil(B / 64) tiles at f32, ceil(B / 32) at f64, one within a slab); an
    explicit ``bn`` is honoured, with no limit on the tile count; the
    result is bitwise the untiled one and within tolerance of the dense
    product."""
    d = _dense(70, 30, 0.3, dtype, 51)
    pb = BC.pack_bcsr(BCSR.from_csr(CSR.from_dense(d), (4, 2)))
    hist = obs.default_registry().histogram("kernels.col_tiles")
    rng = np.random.default_rng(52)
    f32 = dtype == np.float32
    for B, bn, tiles in ((20, None, 1), (64, None, 1 if f32 else 2),
                         (100, None, 2 if f32 else 4),
                         (512, None, 8 if f32 else 16), (64, 8, 8),
                         (300, 1, 300)):
        X = rng.standard_normal((30, B)).astype(dtype)
        before = (hist.count, hist.total)
        got = ops.bcsr_spmm(pb, X, device="cpu", bn=bn)
        assert (hist.count - before[0], hist.total - before[1]) == (1, tiles)
        assert torch.equal(got, ops.bcsr_spmm(pb, X, device="cpu", bn=B))
        np.testing.assert_allclose(got.numpy(), d @ X, rtol=RTOL[dtype],
                                   atol=1e-5)


@pytest.mark.parametrize("n", [70, 13000], ids=["x-staged", "x-via-L1"])
@pytest.mark.parametrize("bs", [(2, 2), (3, 2)], ids=str)
def test_plain_spmm_columns_are_the_spmv_bits(bs, n):
    """Every column of the plain BCSR SpMM is bitwise the plain SpMV of
    that column, for x that the SpMV kernel stages (70 rows) and x wider
    than its 48 KB of staging (13,000 f32 rows, read through L1), with
    r = 2 (rows of a block row read x together in the SpMM) and r = 3
    (each row reads its own); the cells near the last column reach
    x[n - 1]."""
    d = _dense(40, n, 12 / n, np.float32, 53)
    d[::3, n - 1] = 1.5
    pb = BC.pack_bcsr(BCSR.from_csr(CSR.from_dense(d), bs))
    db = BC.to_device(pb, "cpu")
    X = torch.from_numpy(np.random.default_rng(54).standard_normal(
        (n, 5)).astype(np.float32))
    got = BC.bcsr_spmm_plain(db, X)
    for b in range(5):
        col = X[:, b].contiguous()
        assert torch.equal(_bits(got[..., b]), _bits(BC.bcsr_spmv_plain(
            db, col)))
    np.testing.assert_allclose(got.reshape(-1, 5)[:40].numpy(),
                               d @ X.numpy(), rtol=RTOL[np.float32],
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the kernels' arithmetic: skipping every position past a block row's stop
# ---------------------------------------------------------------------------

def _stopped_contract(db, x: torch.Tensor) -> torch.Tensor:
    """The BCSR kernels' order: acc = +0; for each position w of a row
    before its block row's stop, if the slot is real acc = acc + val * x;
    nothing past the stop."""
    r, c = db.block_shape
    n = x.shape[0]
    end = db.stops.repeat_interleave(r) * c                   # (R,)
    acc = torch.zeros((db.rows, x.shape[1]), dtype=x.dtype)
    for w, (col, mask, val) in enumerate(BC._terms(db)):
        live = (mask & (w < end))[:, None]
        t = val[:, None] * x[col.clamp(0, n - 1)]
        acc = torch.where(live, acc + t, acc)
    return acc


SPECIALS = (-0.0, float("inf"), float("-inf"), float("nan"))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), m=st.integers(1, 50),
       n=st.integers(3, 14), density=st.floats(0.0, 1.0),
       f64=st.booleans(), bs=st.sampled_from(list(BCSR_BLOCK_SHAPES)
                                              + [(3, 2), (32, 1)]),
       holes=st.integers(0, 3), special=st.sampled_from(SPECIALS),
       B=st.integers(1, 4))
def test_skipping_positions_past_the_stop_is_adding_zero(
        seed, m, n, density, f64, bs, holes, special, B):
    """On random BCSR packs with -1 slots punched before real ones, signed
    zeros and negative products in x, and -0.0, +-inf or NaN in the x rows
    only padded slots read: stopping each block row at its stop and
    skipping its masked slots gives `padded.contract`'s bits (every slot
    walked, +0 for a masked one)."""
    dtype = np.float64 if f64 else np.float32
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)).astype(dtype)
    d[rng.random((m, n)) >= density] = 0
    d[:, :bs[1]] = 0                    # block column 0: padded slots only
    pb = BC.pack_bcsr(BCSR.from_csr(CSR.from_dense(d), bs))
    for _ in range(holes):              # -1 before a real slot
        s = rng.integers(pb.block_cols.shape[0])
        w = rng.integers(pb.block_cols.shape[1])
        pb.block_cols[s, w] = -1
        pb.values[s, w] = 0
    db = BC.to_device(pb, "cpu")
    x = rng.standard_normal((n, B)).astype(dtype)
    x[rng.random((n, B)) < 0.3] = 0.0
    x[rng.random((n, B)) < 0.3] = -0.0
    x[0] = special
    X = torch.from_numpy(x)
    want = padded.contract(BC._terms(db), X, db.rows)
    got = _stopped_contract(db, X)
    assert torch.equal(_bits(got), _bits(want))
    assert bool(torch.isfinite(got).all())


# ---------------------------------------------------------------------------
# the dtANS SpMM's repairs: the tile cap and lane widths past 992
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("n_tables", [1, 2])
@pytest.mark.parametrize("L", [1, 32, 128, 992, 1024])
def test_widest_tile_is_the_widest_plan_that_fits(L, n_tables, itemsize):
    """`dtans_widest_bn` is the widest tile whose `smem_plan` fits a block
    beside the kernels' static shared memory: its plan fits, one column
    more does not; every lane width keeps at least one column."""
    room = tiling.MAX_SMEM_BYTES - tiling.STATIC_SMEM_BYTES
    bn = tiling.dtans_widest_bn(L, n_tables, itemsize)
    assert bn >= 1
    assert tiling.smem_plan(n_tables, L, itemsize, bn=bn)["total"] <= room
    assert tiling.smem_plan(n_tables, L, itemsize, bn=bn + 1)["total"] > room
    if L <= tiling.MAX_SPMM_LANE_WIDTH:
        K.check_plan(tiling.smem_plan(n_tables, L, itemsize, bn=bn)["total"])


def test_widest_tile_at_the_issue_widths():
    assert tiling.dtans_widest_bn(128, 1, 4) == 335
    assert tiling.dtans_widest_bn(128, 1, 8) == 163
    assert tiling.dtans_widest_bn(992, 1, 4) == 23


def test_resolved_tile_is_cut_to_the_widest():
    """An explicit ``bn`` wider than ``widest``, or one covering the batch
    when the batch is wider, resolves to ``widest``; narrower ones and a
    batch that fits stay; the kernel's own choice is cut alike."""
    def pick(B, bn, widest, choose=lambda B: None):
        return ops.resolve_bn(B, bn, choose, widest)
    assert pick(512, 512, 335) == 335
    assert pick(400, None, 335) == 335
    assert pick(400, 1000, 335) == 335
    assert pick(400, 100, 335) == 100
    assert pick(300, 400, 335) is None
    assert pick(300, None, 335) is None
    assert pick(600, None, 335, lambda B: 64) == 64
    assert pick(600, None, 20, lambda B: 64) == 20
    assert pick(600, 7, None) == 7
    with pytest.raises(ValueError, match="bn must be >= 1"):
        pick(4, 0, 335)


def test_lane_widths_past_992_run_by_columns():
    """The route choice: the SpMM kernel takes lane widths up to
    `MAX_SPMM_LANE_WIDTH` (992); wider ones, to 1024, go by columns."""
    assert tiling.MAX_SPMM_LANE_WIDTH == 992
    for L in (1, 32, 128, 512, 991, 992):
        assert not tiling.spmm_by_columns(L)
    for L in (993, 1000, 1023, 1024):
        assert tiling.spmm_by_columns(L)


def _oracle_columns(d, L, X, shared_table=True):
    """The jnp oracle column by column on the reference's own encode."""
    rp = r_pack(r_encode(RCSR.from_dense(d), lane_width=L,
                         shared_table=shared_table))
    return np.stack([np.asarray(r_spmv_ref(rp, X[:, b]))
                     for b in range(X.shape[1])], axis=1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmm_at_lane_width_1024_vs_oracle(dtype):
    """`ops.spmm` at L = 1024 and B = 3: bitwise the plain SpMM and the
    plain SpMV column by column, within tolerance of the jnp oracle; the
    pass records one tile a column."""
    d = _dense(1100, 40, 0.1, dtype, 53)
    pm = pack_matrix(encode_matrix(CSR.from_dense(d), lane_width=1024))
    dm = to_device(pm, "cpu")
    X = np.random.default_rng(54).standard_normal((40, 3)).astype(dtype)
    hist = obs.default_registry().histogram("kernels.col_tiles")
    before = (hist.count, hist.total)
    got = ops.spmm(pm, X, device="cpu")
    assert (hist.count - before[0], hist.total - before[1]) == (1, 3)
    Xt = torch.from_numpy(X)
    want = K.dtans_spmm_plain(dm, Xt).reshape(-1, 3)[:1100]
    assert torch.equal(_bits(got), _bits(want))
    for b in range(3):
        assert torch.equal(got[:, b], ops.spmv(pm, X[:, b], device="cpu"))
    np.testing.assert_allclose(got.numpy(), _oracle_columns(d, 1024, X),
                               rtol=RTOL[dtype], atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spmm_with_an_overwide_tile_vs_oracle(dtype):
    """An explicit ``bn=400`` over B = 400 at L = 128, wider than a
    block's shared memory holds, is cut to `dtans_widest_bn` (2 tiles):
    bitwise the untiled plain SpMM, within tolerance of the jnp oracle."""
    d = _dense(200, 30, 0.2, dtype, 55)
    pm = pack_matrix(encode_matrix(CSR.from_dense(d), lane_width=128))
    dm = to_device(pm, "cpu")
    X = np.random.default_rng(56).standard_normal((30, 400)).astype(dtype)
    hist = obs.default_registry().histogram("kernels.col_tiles")
    before = (hist.count, hist.total)
    got = ops.spmm(pm, X, device="cpu", bn=400)
    widest = tiling.dtans_widest_bn(128, 1, np.dtype(dtype).itemsize)
    assert widest < 400
    assert (hist.count - before[0], hist.total - before[1]) == (
        1, -(-400 // widest))
    want = K.dtans_spmm_plain(dm, torch.from_numpy(X)).reshape(-1, 400)[:200]
    assert torch.equal(_bits(got), _bits(want))
    np.testing.assert_allclose(got.numpy(), _oracle_columns(d, 128, X),
                               rtol=RTOL[dtype], atol=1e-5)
