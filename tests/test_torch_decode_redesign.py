"""The decode-only kernel's host side: its geometry and shared-memory plan
(`tiling.decode_geometry`, `tiling.smem_plan` with ``stage=``), and the
plain decode on the packs whose shapes the staged kernel's edges meet.

The kernel (`csrc/dtans_decode.cu`) stages ``stage`` segments of each
warp's 32 rows in shared memory and writes them out as whole sectors. Its
plan must fit a block at every lane width the kernels take, its C entry
counts the plan as `_c_need` below does, and its output is the plain
decode's: the last tests hold that one against the reference's jnp oracle
`repro.kernels.ref.decode_ref` on packs with odd segment counts, counts
that are no multiple of the tile, and lanes of no segment. Runs with no
GPU.
"""

import functools

import numpy as np
import pytest
import torch

from repro.core.csr_dtans import encode_matrix as r_encode
from repro.kernels.pack import pack_matrix as r_pack
from repro.kernels.ref import decode_ref as r_decode_ref
from repro.sparse.formats import CSR as RCSR

from repro_torch.core.csr_dtans import encode_matrix
from repro_torch.kernels import ops, tiling
from repro_torch.kernels import dtans_decode as DD
from repro_torch.kernels.pack import pack_matrix, to_device
from repro_torch.sparse.formats import CSR

# chip_smoke.py's sweep widths (packed narrow slices, one warp, 2 to 32
# warps) and their neighbours.
SWEEP_L = (1, 3, 4, 8, 31, 32, 33, 40, 64, 100, 128, 256, 1024)
NEAR_L = sorted({L + d for L in SWEEP_L for d in (-1, 0, 1)
                 if 1 <= L + d <= 1024})
KINDS = [(T, item) for T in (1, 2) for item in (4, 8)]
KIND_IDS = [f"T{T}-{'f32' if item == 4 else 'f64'}" for T, item in KINDS]


def _a16(v: int) -> int:
    return (v + 15) // 16 * 16


def _c_need(T: int, uw: int, upb: int, ks: int, item: int) -> int:
    """``dtans_decode_smem_need`` of csrc/dtans_decode.cu, written out from
    the C: tables_bytes + upb * unit_bytes + upb * uw * stage_bytes."""
    tables = _a16(T * 4096 * 12)
    window = _a16(2 * 3 * uw * 32 * 4)
    exchange = _a16(2 * uw * 2 * 8) + _a16(2 * uw * 4)
    stage = 32 * ks * 4 * (4 + item)
    return tables + upb * (window + exchange) + upb * uw * stage


def _blocks_per_sm(threads: int, smem: int) -> int:
    """Blocks an H100 SM holds: by threads (2,048) and shared memory
    (233,472 B, 1 KB reserved a block)."""
    return max(1, min(2048 // threads, 233472 // (smem + 1024)))


@pytest.mark.parametrize("T,item", KINDS, ids=KIND_IDS)
def test_every_lane_width_has_a_plan_that_fits(T, item):
    """Every lane width 1..1024 gets a tile of 2 segments a warp whose plan
    fits the 232,448 bytes a block may opt in to."""
    assert tiling.DECODE_STAGE == 2
    for L in range(1, 1025):
        g = tiling.decode_geometry(10, L, T, item)
        upb = g.units_per_block
        assert g.smem == _c_need(T, tiling.unit_warps(L), upb, 2, item)
        assert g.smem <= tiling.MAX_SMEM_BYTES == 232448, (L, g)


@pytest.mark.parametrize("T,item", KINDS, ids=KIND_IDS)
@pytest.mark.parametrize("L", NEAR_L)
def test_plan_is_the_sum_of_its_parts_and_the_c_count(L, T, item):
    """At every tile depth the experiments time, the plan's total is its
    parts' sum and the C count's formula; the decode geometry launches the
    SpMV kernel's units and threads with the plan at `DECODE_STAGE`."""
    spmv = tiling.geometry(50, L, T, item)
    uw, upb = tiling.unit_warps(L), spmv.units_per_block
    for ks in (2, 4, 8):
        plan = tiling.smem_plan(T, L, item, units_per_block=upb, stage=ks)
        assert plan["total"] == sum(v for k, v in plan.items()
                                    if k != "total")
        assert plan["stage"] == upb * uw * tiling.stage_bytes(ks, item)
        assert plan["total"] == _c_need(T, uw, upb, ks, item)
        assert plan["total"] % 16 == 0
    g = tiling.decode_geometry(50, L, T, item)
    assert g.smem == tiling.smem_plan(T, L, item, units_per_block=upb,
                                      stage=2)["total"]
    assert (g.group, g.unit_warps, g.slices_per_unit, g.units,
            g.units_per_block, g.threads, g.consumer_warps) == (
        spmv.group, spmv.unit_warps, spmv.slices_per_unit, spmv.units,
        spmv.units_per_block, spmv.threads, 0)


@pytest.mark.parametrize("T,item", KINDS, ids=KIND_IDS)
@pytest.mark.parametrize("L", NEAR_L)
def test_deeper_tiles_hold_no_more_blocks(L, T, item):
    """Why 2 segments: no deeper tile that fits holds more blocks on an SM
    (on the card 4 tied and 8 lost); the grid fills the SMs by the plan."""
    g = tiling.decode_geometry(1000, L, T, item)
    upb, threads = g.units_per_block, g.threads
    uw = tiling.unit_warps(L)
    for ks in (4, 8):
        need = _c_need(T, uw, upb, ks, item)
        if need <= 232448:
            assert _blocks_per_sm(threads, need) <= _blocks_per_sm(
                threads, g.smem)
    assert g.blocks == min(-(-g.units // upb),
                           132 * _blocks_per_sm(threads, g.smem))


@pytest.mark.parametrize("S,L,T,item,smem,blocks", [
    (384, 128, 1, 4, 60576, 384),     # the SmolLM-135M head (phase 4)
    (12288, 4, 1, 4, 60608, 384),     # its 4x4-blocked shape (phase 4c)
    (384, 128, 1, 8, 64672, 384),
    (384, 128, 2, 4, 109728, 264),
    (384, 256, 2, 4, 121152, 132),
    (384, 1024, 1, 4, 140544, 132),
    (384, 1024, 2, 8, 222464, 132),
])
def test_pinned_geometries(S, L, T, item, smem, blocks):
    g = tiling.decode_geometry(S, L, T, item)
    assert (g.smem, g.blocks) == (smem, blocks)


def test_bounding_case_fits_only_two_segments():
    """L = 1024 at f64 with two tables: 32 warps of 3,072-byte tiles beside
    98,304 bytes of tables leave no room for 4 segments a warp."""
    assert tiling.decode_geometry(3, 1024, 2, 8).smem == 222464
    assert tiling.smem_plan(2, 1024, 8, stage=4)["total"] > 232448


# --- the plain decode on the staged kernel's edge shapes -----------------

def _lens_csr(lens, n, dtype, seed):
    """(port CSR, reference CSR) with row lengths ``lens`` over ``n``
    columns, random values (escapes)."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens)
    indptr = np.r_[0, np.cumsum(lens)].astype(np.int64)
    indices = np.concatenate([np.sort(rng.choice(n, k, replace=False))
                              for k in lens]).astype(np.int32)
    values = rng.standard_normal(int(indptr[-1])).astype(dtype)
    shape = (len(lens), n)
    return (CSR(indptr, indices, values, shape),
            RCSR(indptr, indices, values, shape))


def _lens(L, rows, longest, seed):
    """Row lengths: one row of ``longest`` in the first slice, the rest 0
    to ``longest // 2`` (so later slices end before max_nseg), a third of
    them empty (lanes of no segment)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, longest // 2 + 1, size=rows)
    lens[rng.random(rows) < 1 / 3] = 0
    lens[min(L, rows) // 2] = longest
    return lens


EDGE = {
    # name: lane width, rows, longest row, dtype, shared table
    "L8-nseg9-f32": (8, 30, 35, np.float32, True),
    "L32-nseg5-f64-2tab": (32, 70, 18, np.float64, False),
    "L5-nseg10-f32-2tab": (5, 23, 38, np.float32, False),
    "L100-nseg3-f64": (100, 160, 11, np.float64, True),
    "L1-nseg7-f32": (1, 9, 27, np.float32, True),
    "L33-nseg13-f64": (33, 50, 50, np.float64, True),
}


@functools.lru_cache(maxsize=None)
def _edge(name):
    L, rows, longest, dtype, shared = EDGE[name]
    csr, rcsr = _lens_csr(_lens(L, rows, longest, len(name)), 64, dtype,
                          rows)
    kw = dict(lane_width=L, shared_table=shared)
    return encode_matrix(csr, **kw), r_encode(rcsr, **kw), -(-longest // 4)


@pytest.mark.parametrize("name", list(EDGE))
def test_plain_decode_matches_reference_on_edge_packs(name):
    """Columns exactly and values bit for bit against the reference's
    `decode_ref`, on a pack whose max_nseg is odd or no multiple of 8,
    with lanes of no segment and slices that end before max_nseg."""
    m, rm, max_nseg = _edge(name)
    pm = pack_matrix(m)
    assert pm.max_nseg == max_nseg
    assert max_nseg % 2 == 1 or max_nseg % 8 != 0
    nsegs = (pm.ns + 7) // 8
    assert ((nsegs == 0) & pm.row_valid).any()        # real rows, no segment
    assert (nsegs.max(axis=1) < max_nseg).any()       # slices end early
    cols, vals = DD.dtans_decode_plain(to_device(pm, "cpu"))
    rcols, rvals = (np.asarray(a) for a in r_decode_ref(r_pack(rm)))
    assert cols.dtype == torch.int32 and tuple(cols.shape) == rcols.shape
    np.testing.assert_array_equal(cols.numpy(), rcols)
    bits = np.uint64 if rvals.dtype == np.float64 else np.uint32
    np.testing.assert_array_equal(vals.numpy().view(bits), rvals.view(bits))
    c2, v2 = ops.decode(m, device="cpu")
    assert torch.equal(c2, cols) and torch.equal(v2, vals)
