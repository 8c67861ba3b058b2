"""The host side of the SELL / RGCSR SpMM kernel, on the CPU.

The CUDA kernel (`csrc/padded_rows.cuh::spmm_warp_kernel`) takes its
launch geometry from `tiling.padded_geometry`: one warp per chunk of 32
rows and slab of columns, lanes mapped to columns, ``32 / bw`` row groups
a warp for narrow slabs, accumulators in registers. This file holds what
can be checked without a card: every (row, column) of the result is owned
by exactly one (block, warp, lane, accumulator) of that geometry, for
every batch from 1 to 600 and the tile widths the kernels meet; the
accumulators stay within the register budget; the default tile
(`tiling.padded_bn`) is what `ops` records; and the kernel's arithmetic,
which skips a masked term where the plain version adds +0, gives the same
bits (a hypothesis property on torch CPU tensors). The kernel itself is
held against its plain version on the card (`tests/test_torch_gpu.py`).

This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro_torch import obs
from repro_torch.kernels import ops, padded, tiling
from repro_torch.kernels import rgcsr_spmv as RG
from repro_torch.kernels import sell_spmv as SE
from repro_torch.sparse.formats import CSR
from repro_torch.sparse.rgcsr import RGCSR

BNS = (None, 1, 4, 8, 24, 32, 40, 64)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _owned(g: tiling.PaddedGeometry, R: int, B: int):
    """The (row, column) each (block, warp, lane, j, c) of the launch
    writes, as the kernel indexes: block b takes slab b // bps and chunks
    (b % bps) * warps + warp; lane (grp, bl) owns rows grp * bw + j of the
    chunk at columns c0 + c * bw + bl of the slab, c0 = tile * bt + s *
    slab; nothing past R, past the tile's end or past the slab's width.
    Returns the flat indices row * B + column of every owned cell."""
    bps = -(-g.chunks // g.warps)
    blk = np.arange(g.blocks)[:, None, None, None, None]
    warp = np.arange(g.warps)[None, :, None, None, None]
    lane = np.arange(tiling.WARP)[None, None, :, None, None]
    j = np.arange(g.bw)[None, None, None, :, None]
    c = np.arange(g.cols_per_lane)[None, None, None, None, :]
    slab, chunk = blk // bps, (blk % bps) * g.warps + warp
    tile, s = slab // g.slabs_per_tile, slab % g.slabs_per_tile
    c0 = tile * g.bt + s * g.slab
    tend = np.minimum((tile + 1) * g.bt, B)
    sw = np.minimum(g.slab, tend - c0)
    grp, bl = lane // g.bw, lane % g.bw
    row = chunk * tiling.WARP + grp * g.bw + j
    off = c * g.bw + bl
    ok = (chunk < g.chunks) & (row < R) & (off < sw)
    row, col, ok = np.broadcast_arrays(row, c0 + off, ok)
    return (row * B + col)[ok]


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("bn", BNS, ids=[str(b) for b in BNS])
def test_every_cell_has_one_owner(bn, itemsize):
    """For B = 1..600: every (row, column) of the result has exactly one
    owning lane and accumulator; bw is a power of two <= 32; a lane's
    accumulators stay within `PADDED_ACC_WORDS` registers; the grid covers
    every (tile, slab, chunk) once. R = 75 rows (3 chunks, the last
    ragged) beside x of 50 rows."""
    R, n = 75, 50
    for B in range(1, 601):
        bt = padded.tile_width(B, bn, most_tiles=None)
        g = tiling.padded_geometry(R, n, B, bt, itemsize)
        assert g.bw & (g.bw - 1) == 0 and 1 <= g.bw <= tiling.WARP
        assert g.acc_words(itemsize) <= tiling.PADDED_ACC_WORDS
        assert g.tiles == -(-B // bt) and g.chunks == 3
        assert g.blocks == g.tiles * g.slabs_per_tile * -(-3 // g.warps)
        assert g.slabs_per_tile * g.slab >= bt
        cells = _owned(g, R, B)
        assert cells.size == R * B, (B, bn)
        assert np.unique(cells).size == R * B, (B, bn)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
def test_narrow_tiles_fill_the_warp(itemsize):
    """A tile of 2..16 columns rounds up to a power of two bw and puts
    32 / bw row groups in the warp, so at B = 4 and 8 no lane idles."""
    for B, bw in ((2, 2), (3, 4), (4, 4), (5, 8), (8, 8), (9, 16),
                  (16, 16), (17, 32), (33, 32)):
        g = tiling.padded_geometry(49152, 576, B, B, itemsize)
        assert (g.bw, g.row_groups) == (bw, 32 // bw)
    for B in (4, 8):
        assert tiling.padded_geometry(64, 576, B, B, itemsize).bw == B


def test_head_geometry():
    """The SmolLM-135M head (49152 rows, x of 576 rows, f32): a tile of 64
    columns is one slab of two columns a lane, its x columns (147,456 B)
    staged in shared memory beside the warps' row buffers (256 B each),
    one block an SM: at B = 64 the 1,536 chunks take 12 warps a block, 128
    blocks, one wave on 132 SMs; B = 512 (8 tiles of 64) takes 16. A tile
    of 4 puts 8 row groups in a warp and stages 4 columns."""
    g = tiling.padded_geometry(49152, 576, 64, 64, 4)
    assert (g.bw, g.cols_per_lane, g.warps, g.stage) == (32, 2, 12, True)
    assert g.smem == 576 * 64 * 4 + 12 * 256 <= tiling.MAX_SMEM_BYTES
    assert (g.chunks, g.tiles, g.slabs_per_tile, g.blocks) == \
        (1536, 1, 1, 128)
    g = tiling.padded_geometry(49152, 576, 512, 64, 4)
    assert (g.tiles, g.slabs_per_tile, g.warps, g.blocks) == (8, 1, 16, 768)
    g = tiling.padded_geometry(49152, 576, 4, 4, 4)
    assert (g.bw, g.row_groups, g.warps, g.stage) == (4, 8, 8, True)
    assert g.smem == 576 * 4 * 4 + 8 * 256
    g = tiling.padded_geometry(49152, 576, 64, 64, 8)     # f64: one column
    assert (g.cols_per_lane, g.warps, g.slab, g.stage) == (1, 8, 32, True)
    # two columns a lane never take fewer than 8 warps
    assert tiling.padded_geometry(64, 576, 64, 64, 4).warps == 8


def test_x_is_staged_wherever_it_fits():
    """Two columns a lane only where the 64-column slab fits a block's
    shared memory; else one column a lane, its slab staged where it fits
    and read through L1 beyond (shared memory then holds only the row
    buffers)."""
    top = tiling.MAX_SMEM_BYTES
    two = (top - 16 * 256) // (64 * 4)         # largest n for 2 a lane
    assert tiling.padded_geometry(64, two, 64, 64, 4).cols_per_lane == 2
    g = tiling.padded_geometry(64, two + 1, 64, 64, 4)
    assert (g.cols_per_lane, g.warps, g.stage) == (1, 8, True)
    one = (top - 8 * 256) // (32 * 4)          # largest n to stage 32
    assert tiling.padded_geometry(64, one, 64, 64, 4).stage
    g = tiling.padded_geometry(64, one + 1, 64, 64, 4)
    assert (g.cols_per_lane, g.stage, g.smem) == (1, False, 8 * 256)
    assert tiling.padded_rows_bytes(8) == 2 * tiling.padded_rows_bytes(4)
    g = tiling.padded_geometry(64, 576, 64, 64, 4, stage=False)
    assert (g.stage, g.smem) == (False, g.warps * 256)


def test_geometry_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="accumulator budget"):
        tiling.padded_geometry(64, 10, 64, 64, 8, cols_per_lane=2)
    with pytest.raises(ValueError, match="accumulator budget"):
        tiling.padded_geometry(64, 10, 8, 8, 4, cols_per_lane=2)
    with pytest.raises(ValueError, match="warps"):
        tiling.padded_geometry(64, 10, 8, 8, 4,
                               warps=tiling.PADDED_MAX_WARPS + 1)
    with pytest.raises(ValueError, match="does not fit"):
        tiling.padded_geometry(64, 10**6, 64, 32, 4, stage=True)
    with pytest.raises(ValueError, match="bt >= 1"):
        tiling.padded_geometry(64, 10, 8, 0, 4)
    assert tiling.padded_geometry(64, 10, 64, 64, 4,
                                  cols_per_lane=2).slab == 64


def test_flat_grid_takes_more_tiles_than_grid_y():
    """The flat grid has no 65,535-tile limit: bn = 1 over 70,000 columns
    is one launch of 70,000 blocks, by default; a caller's own limit
    (``most_tiles``) still refuses more tiles."""
    assert padded.tile_width(70000, 1) == 1
    assert padded.tile_width(70000, 1, most_tiles=None) == 1
    assert tiling.padded_geometry(32, 8, 70000, 1, 4).blocks == 70000
    with pytest.raises(ValueError, match="exceed the grid"):
        padded.tile_width(70000, 1, most_tiles=65535)


# ---------------------------------------------------------------------------
# default tiles
# ---------------------------------------------------------------------------

def test_padded_bn():
    """The widest slab (64 columns at f32, 32 at f64), or None when the
    batch fits one."""
    for itemsize, slab in ((4, 64), (8, 32)):
        assert tiling.padded_bn(1, itemsize) is None
        assert tiling.padded_bn(slab, itemsize) is None
        assert tiling.padded_bn(slab + 1, itemsize) == slab
        assert tiling.padded_bn(512, itemsize) == slab


def _packs(dtype):
    rng = np.random.default_rng(40)
    d = rng.standard_normal((70, 30)).astype(dtype)
    d[rng.random(d.shape) >= 0.3] = 0
    a = CSR.from_dense(d)
    return d, SE.pack_sell(a, 16), RG.pack_rgcsr(RGCSR.from_csr(a, 4))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fmt", ["sell", "rgcsr"])
def test_ops_record_the_default_tile_count(fmt, dtype):
    """`ops.sell_spmm` / `rgcsr_spmm` with ``bn=None`` take
    `tiling.padded_bn`'s tile: ``kernels.col_tiles`` records ceil(B / 64)
    at f32 and ceil(B / 32) at f64, 1 for a batch within one slab; an
    explicit ``bn`` is honoured. The result is bitwise the untiled one
    either way."""
    d, ps, pr = _packs(dtype)
    fn, pk = (ops.sell_spmm, ps) if fmt == "sell" else (ops.rgcsr_spmm, pr)
    hist = obs.default_registry().histogram("kernels.col_tiles")
    rng = np.random.default_rng(41)
    f32 = dtype == np.float32
    for B, bn, tiles in ((20, None, 1), (64, None, 1 if f32 else 2),
                         (100, None, 2 if f32 else 4),
                         (512, None, 8 if f32 else 16), (64, 8, 8),
                         (64, 64, 1)):
        X = rng.standard_normal((30, B)).astype(dtype)
        before = (hist.count, hist.total)
        got = fn(pk, X, device="cpu", bn=bn)
        assert (hist.count - before[0], hist.total - before[1]) == (1, tiles)
        untiled = fn(pk, X, device="cpu", bn=B)
        assert torch.equal(got, untiled), (B, bn)
        np.testing.assert_allclose(got.numpy(), d @ X,
                                   rtol=1e-4 if dtype == np.float32
                                   else 1e-12, atol=1e-5)


# ---------------------------------------------------------------------------
# the kernel's arithmetic: skipping a masked term is adding +0
# ---------------------------------------------------------------------------

def _skip_contract(terms, x: torch.Tensor, R: int) -> torch.Tensor:
    """The kernel's order: acc = +0; for w: if mask: acc = acc + val * x."""
    n = x.shape[0]
    acc = torch.zeros((R, x.shape[1]), dtype=x.dtype)
    for col, mask, val in terms:
        t = val[:, None] * x[col.clamp(0, n - 1)]
        acc = torch.where(mask[:, None], acc + t, acc)
    return acc


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


SPECIALS = (-0.0, float("inf"), float("-inf"), float("nan"))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), m=st.integers(1, 70),
       n=st.integers(2, 12), density=st.floats(0.0, 1.0),
       f64=st.booleans(), rows=st.sampled_from([4, 8, 16, 32]),
       special=st.sampled_from(SPECIALS), B=st.integers(1, 5))
def test_skipping_masked_terms_is_adding_zero(seed, m, n, density, f64, rows,
                                              special, B):
    """On random SELL and RGCSR packs (column 0 empty, so that only
    padding reads x[0]), with -0.0, +-inf or NaN in x[0], signed zeros
    elsewhere in x and negative values whose products give -0: the
    kernel's "skip a masked term" and `padded.contract`'s "add +0" give
    the same bits."""
    dtype = np.float64 if f64 else np.float32
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)).astype(dtype)
    d[rng.random((m, n)) >= density] = 0
    d[:, 0] = 0
    a = CSR.from_dense(d)
    x = rng.standard_normal((n, B)).astype(dtype)
    x[rng.random((n, B)) < 0.3] = 0.0
    x[rng.random((n, B)) < 0.3] = -0.0
    x[0] = special
    X = torch.from_numpy(x)
    for dm in (SE.to_device(SE.pack_sell(a, rows), "cpu"),
               RG.to_device(RG.pack_rgcsr(RGCSR.from_csr(a, rows)), "cpu")):
        terms = SE._terms(dm) if isinstance(dm, SE.DeviceSELL) \
            else RG._terms(dm)
        want = padded.contract(terms, X, dm.rows)
        terms = SE._terms(dm) if isinstance(dm, SE.DeviceSELL) \
            else RG._terms(dm)
        got = _skip_contract(terms, X, dm.rows)
        assert torch.equal(_bits(got), _bits(want))
        assert bool(torch.isfinite(got).all())
