"""The host side of the SELL / RGCSR SpMV redesign, on the CPU.

The SELL and RGCSR SpMV (`csrc/padded_rows.cuh::spmv_lanes_kernel`) run
four lanes a row, lane t taking positions w = t (mod 4), and stop each row
at its last real entry: SELL at `sell_spmv.row_stops` (one past the last
index >= 0, computed at upload), RGCSR at its count. The warp walks to the
longest stop of its 8 rows, a lane past its own row's stop adds +0, and
each step's four products reach the row's sum in position order through
warp shuffles. An RGCSR lane's column is the row's carry plus the
inclusive scan of the step's deltas across the four lanes, a lane at or
past the count scanning 0. The SELL SpMM (`spmm_warp_kernel`) stops each
32-row chunk at its longest row's stop.

This file holds what can be checked without a card: `row_stops` against
the pack for every SELL slice height the format registry uses, that the
kernels' arithmetic (emulated here lane by lane and step by step) gives
the plain versions' bits (a hypothesis property), and that the plain
versions equal the JAX package's jnp oracles (`sell_spmv_ref`,
`rgcsr_spmv_ref`) on hand-made packs that no matrix packs to: -1 holes
before real entries, deltas past the count, int32 running sums past 2^31.
Tolerances are the reference's, rtol 1e-4 (f32) and 1e-12 (f64). The
kernels themselves are held against their plain versions on the card
(`tests/test_torch_gpu.py`).
"""

import numpy as np
import pytest
import torch

from hand_made_packs import (HAND_LENGTHS, HAND_MADE, hand_made_rgcsr,
                             hand_made_sell)
from hypothesis_compat import given, settings, st
from repro.kernels.rgcsr_spmv import rgcsr_spmv_ref
from repro.kernels.sell_spmv import sell_spmv_ref
from repro.sparse.registry import SellSpec

from repro_torch.kernels import padded
from repro_torch.kernels import rgcsr_spmv as RG
from repro_torch.kernels import sell_spmv as SE
from repro_torch.sparse.formats import CSR
from repro_torch.sparse.rgcsr import RGCSR

RTOL = {np.float32: 1e-4, np.float64: 1e-12}
LANES, UNROLL = 4, 4        # csrc/padded_rows.cuh: LANES, LANES_UNROLL
# The format registry's SELL slice heights (its knob domain and its
# conformance height), and chip_smoke.py's widest.
SELL_HEIGHTS = sorted({*SellSpec.knob_domains["slice_height"],
                       SellSpec.conformance_knobs["slice_height"], 128})


def _dense(m, n, density, dtype, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)).astype(dtype)
    d[rng.random((m, n)) >= density] = 0
    return d


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


# ---------------------------------------------------------------------------
# row_stops
# ---------------------------------------------------------------------------

def _stops_by_loop(indices: np.ndarray) -> np.ndarray:
    flat = indices.reshape(-1, indices.shape[-1])
    out = np.zeros(flat.shape[0], dtype=np.int32)
    for r, row in enumerate(flat):
        for w in range(row.size):
            if row[w] >= 0:
                out[r] = w + 1
    return out


@pytest.mark.parametrize("L", SELL_HEIGHTS)
def test_row_stops_end_each_row_at_its_last_real_index(L):
    """On a matrix with empty rows and rows of every length: the device
    matrix's stops are one past each row's last real index, 0 for an
    empty row and for the rows that round the last slice up; every later
    position is padding; their bytes count in `DeviceSELL.nbytes`."""
    d = _dense(203, 45, 0.15, np.float32, 70)
    d[30:70] = 0
    ps = SE.pack_sell(CSR.from_dense(d), L)
    ds = SE.to_device(ps, "cpu")
    stops = ds.stops.numpy()
    assert ds.stops.dtype == torch.int32 and stops.shape == (ds.rows,)
    np.testing.assert_array_equal(stops, _stops_by_loop(ps.indices))
    np.testing.assert_array_equal(stops[:203], (d != 0).sum(axis=1))
    assert (stops[203:] == 0).all() and (stops[30:70] == 0).all()
    flat = ps.indices.reshape(ds.rows, -1)
    assert stops.max() == flat.shape[1]
    for r, stop in enumerate(stops):
        assert (flat[r, stop:] < 0).all()
    assert ds.nbytes == int(ds.indices.nbytes + ds.values.nbytes
                            + 4 * ds.rows)


def test_row_stops_of_hand_made_packs():
    """-1 may stand before real indices (the stop is past the last real
    one, wherever the -1s lie), and a row may be padding only."""
    idx = np.array([[[0, -1, 3, -1],
                     [-1, -1, -1, -1],
                     [1, 2, 3, 4]],
                    [[-1, -1, -1, 5],
                     [5, -1, -1, -1],
                     [-1, 7, -1, -1]]], dtype=np.int32)
    np.testing.assert_array_equal(SE.row_stops(idx), [3, 0, 4, 4, 1, 2])
    assert SE.row_stops(idx).dtype == np.int32
    assert SE.row_stops(np.zeros((0, 4, 3), np.int32)).shape == (0,)
    ps = hand_made_sell(np.float32)
    np.testing.assert_array_equal(SE.row_stops(ps.indices),
                                  _stops_by_loop(ps.indices))
    holes = [r for r in range(ps.indices.shape[0] * 16)
             if (ps.indices.reshape(-1, 12)[r, :SE.row_stops(
                 ps.indices)[r]] < 0).any()]
    assert holes, "the hand-made pack has -1 holes before real indices"


# ---------------------------------------------------------------------------
# the SpMV kernel's arithmetic, lane by lane
# ---------------------------------------------------------------------------

def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 it wraps to."""
    return ((v + 2**31) % 2**32) - 2**31


def _row_stops(dm) -> torch.Tensor:
    """(R,) int64: where the kernels stop each row."""
    wg = dm.values.shape[1]
    if isinstance(dm, SE.DeviceSELL):
        return dm.stops.long().clamp(0, wg)
    return dm.nnz.long().clamp(0, wg)


def _walk(stops: torch.Tensor, rows: int) -> torch.Tensor:
    """(R,): how far each row's group of ``rows`` rows walks, the longest
    stop among them (`__reduce_max_sync`)."""
    R = stops.shape[0]
    pad = torch.zeros(-(-R // rows) * rows, dtype=stops.dtype)
    pad[:R] = stops
    return pad.reshape(-1, rows).max(dim=1).values.repeat_interleave(
        rows)[:R]


def _lanes_spmv(dm, x: torch.Tensor) -> torch.Tensor:
    """The SpMV kernel's order for x (n,): rows in warps of 32 / LANES;
    steps of LANES positions, lane t holding position w0 + t, loaded only
    before its row's stop; the warp walks UNROLL steps at a time up to the
    longest stop of its rows. SELL: the column is the stored index, real
    where >= 0. RGCSR: the column is the row's carry plus the inclusive
    scan of the step's deltas (0 at or past the stop) up to the lane,
    wrapping as int32, and the carry takes the step's total. Each step's
    LANES products (0 where masked) are added to the row's sum in lane
    order."""
    R, n = dm.rows, x.shape[0]
    wg = dm.values.shape[1]
    sell = isinstance(dm, SE.DeviceSELL)
    words = dm.indices if sell else dm.deltas
    stops = _row_stops(dm)
    walk = _walk(stops, 32 // LANES)
    acc = torch.zeros(R, dtype=x.dtype)
    carry = torch.zeros(R, dtype=torch.int64)
    end = int(walk.max()) if R else 0
    for w0 in range(0, end, LANES * UNROLL):
        for u in range(UNROLL):
            ws = [w0 + u * LANES + t for t in range(LANES)]
            inn = [w < stops for w in ws]
            word = [padded.position(words, w, R).long() * i if w < wg
                    else torch.zeros(R, dtype=torch.int64)
                    for w, i in zip(ws, inn)]
            val = [padded.position(dm.values, w, R) if w < wg
                   else torch.zeros(R, dtype=x.dtype) for w in ws]
            if sell:
                cols = word
                ok = [i & (c >= 0) for i, c in zip(inn, cols)]
            else:
                scan = torch.stack(word).cumsum(dim=0)     # lanes 0..T-1
                cols = [_wrap32(carry + s) for s in scan]
                carry = _wrap32(carry + scan[-1])
                ok = inn
            for c, m, v, w in zip(cols, ok, val, ws):
                p = torch.where(m, v * x[c.clamp(0, n - 1)], 0)
                acc = torch.where(w < walk, acc + p, acc)
    return acc


def _chunk_spmm(dm, X: torch.Tensor) -> torch.Tensor:
    """The SpMM kernel's order for X (n, B): each chunk of 32 rows walks
    to its longest row's stop; a masked term is skipped."""
    n = X.shape[0]
    walk = _walk(_row_stops(dm), 32)
    terms = SE._terms(dm) if isinstance(dm, SE.DeviceSELL) else RG._terms(dm)
    acc = torch.zeros((dm.rows, X.shape[1]), dtype=X.dtype)
    for w, (col, mask, val) in enumerate(terms):
        live = (mask & (w < walk))[:, None]
        acc = torch.where(live, acc + val[:, None] * X[col.clamp(0, n - 1)],
                          acc)
    return acc


SPECIALS = (-0.0, float("inf"), float("-inf"), float("nan"))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), m=st.integers(1, 80),
       n=st.integers(3, 14), density=st.floats(0.0, 1.0),
       f64=st.booleans(), rows=st.sampled_from([4, 8, 16, 32, 128]),
       holes=st.integers(0, 6), special=st.sampled_from(SPECIALS),
       B=st.integers(1, 4))
def test_stopping_each_row_gives_the_plain_bits(seed, m, n, density, f64,
                                                rows, holes, special, B):
    """On random SELL packs with -1 holes (nonzero values) punched before
    real entries, and random RGCSR packs with nonzero deltas and values
    past every count, with signed zeros in x and -0.0, +-inf or NaN in the
    x row only padding reads: the SpMV kernel's order (`_lanes_spmv`) and
    the SpMM's (`_chunk_spmm`) give `padded.contract`'s bits (every
    position walked, +0 for a masked one)."""
    dtype = np.float64 if f64 else np.float32
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)).astype(dtype)
    d[rng.random((m, n)) >= density] = 0
    d[:, 0] = 0                         # only padding reads x[0]
    a = CSR.from_dense(d)
    ps = SE.pack_sell(a, rows)
    flat = ps.indices.reshape(-1, ps.indices.shape[-1])
    for _ in range(holes):              # -1 before a real index
        r = rng.integers(flat.shape[0])
        w = rng.integers(flat.shape[1])
        flat[r, w] = -1
        ps.values.reshape(flat.shape)[r, w] = 1.5
    pr = RG.pack_rgcsr(RGCSR.from_csr(a, rows))
    past = np.arange(pr.deltas.shape[2]) >= pr.nnz[..., None]
    pr.deltas[past] = rng.integers(-5, 6, int(past.sum()))
    pr.values[past] = 2.5
    x = rng.standard_normal((n, B)).astype(dtype)
    x[rng.random((n, B)) < 0.3] = 0.0
    x[rng.random((n, B)) < 0.3] = -0.0
    x[0] = special
    X = torch.from_numpy(x)
    for dm in (SE.to_device(ps, "cpu"), RG.to_device(pr, "cpu")):
        terms = SE._terms if isinstance(dm, SE.DeviceSELL) else RG._terms
        want = padded.contract(terms(dm), X, dm.rows)
        got = _chunk_spmm(dm, X)
        assert torch.equal(_bits(got), _bits(want))
        assert bool(torch.isfinite(got).all())
        for b in range(B):
            got = _lanes_spmv(dm, X[:, b])
            assert torch.equal(_bits(got), _bits(want[:, b]))


# ---------------------------------------------------------------------------
# hand-made packs against the JAX package's oracles
# ---------------------------------------------------------------------------

def test_hand_made_rgcsr_sums_wrap_within_the_count():
    """The wrapping pack runs rows 3 and 4 past 2^31 before their counts
    (4 and 5 entries) end, and comes back in range: the int32 running sum
    of row 3 is 5, < 0, < 0, 13; of row 4 3, > 13, < 0, 12."""
    pr = hand_made_rgcsr(np.float32, 13, 62, True)
    cols = np.cumsum(pr.deltas.reshape(-1, 12).astype(np.int64), axis=1)
    cols = ((cols + 2**31) % 2**32) - 2**31
    assert list(pr.nnz.reshape(-1)[3:5]) == [4, 5]
    assert cols[3, 0] == 5 and cols[3, 1] < 0 and cols[3, 3] == 13
    assert cols[4, 1] > 13 and cols[4, 2] < 0 and cols[4, 3] == 12
    assert (np.abs(pr.deltas.reshape(-1, 12)[~(np.arange(12) < pr.nnz
                                               .reshape(-1, 1))]) > 0).any()
    assert HAND_LENGTHS[:6] == (0, 1, LANES - 1, LANES, LANES + 1,
                                2 * LANES + 1)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kind", list(HAND_MADE))
def test_hand_made_packs_vs_oracle(kind, dtype):
    """The plain SpMV equals the JAX package's jnp oracle on the hand-made
    pack (rtol 1e-4 f32, 1e-12 f64), and the kernels' order gives its
    bits."""
    pk = HAND_MADE[kind](dtype, 13)
    sell = kind == "sell"
    dm = (SE if sell else RG).to_device(pk, "cpu")
    plain = SE.sell_spmv_plain if sell else RG.rgcsr_spmv_plain
    rng = np.random.default_rng(71)
    for _ in range(3):
        x = rng.standard_normal(13).astype(dtype)
        got = plain(dm, torch.from_numpy(x))
        want = np.asarray(sell_spmv_ref(pk.indices, pk.values, x) if sell
                          else rgcsr_spmv_ref(pk.deltas, pk.values, pk.nnz,
                                              x))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[dtype],
                                   atol=RTOL[dtype] * scale)
        xt = torch.from_numpy(x)
        assert torch.equal(_bits(_lanes_spmv(dm, xt)),
                           _bits(got.reshape(-1)))
        assert torch.equal(_bits(_chunk_spmm(dm, xt[:, None])[:, 0]),
                           _bits(got.reshape(-1)))
