"""Launch geometry, shared-memory plan and column tiling of the dtANS
kernels, sized for Hopper.

The dtANS kernels (`csrc/dtans_spmv.cu`, `csrc/dtans_decode.cu`) decode
with the warp-synchronous decoder of `csrc/dtans_decode.cuh`. Their
geometry is computed here and handed to the C entries:

* a slice of lane width ``L <= 32`` is decoded by a group of ``G`` threads,
  ``L`` rounded up to a power of two, and one warp packs ``32 / G`` slices
  (a *unit*); a wider slice is decoded by ``ceil(L / 32)`` warps (one unit
  per slice). A unit has ``32 * unit_warps`` rows (thread lanes);
* blocks are persistent: about as many as fit on the card's SMs, each
  staging the coding tables in shared memory once (where `tables_in_smem`
  puts them there) and looping over its
  share of the units (SpMV, decode: ``units_per_block`` units at a time;
  SpMM: one unit and column tile at a time);
* the SpMM block adds contraction warps beside the unit's decoder warps
  (`consumer_warps`), at most 32 warps a block, so the SpMM kernel takes
  lane widths up to `MAX_SPMM_LANE_WIDTH`; `ops.spmm` serves wider slices
  (to 1024) by one SpMV launch a column (`spmm_by_columns`).

The kernels are compiled once per parameter set (`DtansParams`: one
library each, `_build`), and every size below is a value of the set: the
table slots ``K``, the bytes of a slot (`slot_bytes`: 12 at `PAPER`, 16
where a slot's digit, base and escape flag take more than 32 bits), the
words a lane claims a segment (``o``) and the entries of a segment
(``l / 2``). The shared-memory plan (`smem_plan`) is the coding tables,
where `tables_in_smem` puts them there (else the kernels read them from
global memory through the read-only path), per unit in flight the refill
windows and the claim exchange, for SpMM the decoded ring and the
``(rows, bn)`` accumulator tile, and for decode a staging tile of
`DECODE_STAGE` * 4 entries a row per warp (`decode_geometry`). At `PAPER`
two tables take 98,304 bytes of the plan. The C side computes the same
sizes (``dtans_smem_need``, ``dtans_decode_smem_need``) and refuses a
launch given less.

`dtans_bn` sizes the dtANS SpMM's column tile: `choose_bn`'s, at most
`DTANS_BN_MAX` columns. `choose_bn`: the accumulator tile may take
`DEFAULT_SMEM_BYTES`, and the whole plan must fit `MAX_SMEM_BYTES`;
`dtans_widest_bn` is the widest tile whose plan fits at all, where
`ops.spmm` caps an explicit ``bn``; where not even one column fits (a wide
slice of a set with long segments, whose ring outgrows the block),
`spmm_by_columns` sends ``ops.spmm`` to one SpMV launch a column. Tiling
splits only the B axis, so every output column sees exactly the
arithmetic of the untiled kernel: tiled results are bitwise equal to
untiled ones at every ``bn``.

The SELL, RGCSR and BCSR SpMM kernel (``csrc/padded_rows.cuh::
spmm_warp_kernel``) keeps its accumulators in registers; its shared memory
holds only the slab's x columns, where they fit. `padded_geometry` gives
its launch (one warp per chunk of 32 rows and slab of columns, lanes
mapped to columns) and `padded_bn` its default column tile, one slab.

H100 facts behind the constants (NVIDIA's Hopper documentation): 132 SMs
on the SXM part; a block may use 48 KB of shared memory without opting in,
and up to 227 KB (232,448 bytes) with
``cudaFuncAttributeMaxDynamicSharedMemorySize``; an SM has 228 KB
(233,472 bytes), 1 KB of it reserved per resident block, and runs at most
2,048 threads; a warp is 32 threads.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.core.params import PAPER, DtansParams

#: Shared memory an accumulator tile may take by default: the 48 KB a block
#: gets without opting in.
DEFAULT_SMEM_BYTES = 48 * 1024

#: Most shared memory one H100 block can opt in to (227 KB), static and
#: dynamic together.
MAX_SMEM_BYTES = 232448

#: The kernels' static shared memory: none, every array is carved from
#: the dynamic plan (``dtans_spmv.static_smem_bytes`` reads it from the
#: built kernels).
STATIC_SMEM_BYTES = 0

#: Shared memory of one SM, and what the card reserves per resident block.
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024
SM_THREADS = 2048

#: SMs of an H100 SXM: the default where no card is asked.
SM_COUNT = 132

#: Threads per warp; tile widths snap down to a multiple of this.
WARP = 32

#: Floor tile width: below this the repeated decode per tile dwarfs the
#: contraction (taken only where the plan still fits).
MIN_BN = 8

#: Widest dtANS SpMM column tile `dtans_bn` picks: on an H100 wider tiles
#: ran slower (fewer blocks fit an SM; PERF.md).
DTANS_BN_MAX = 64

#: SpMV / decode blocks hold this many warps of units (or one wide unit);
#: the SpMM ring holds this many segments. Both chosen by timing the
#: SmolLM-135M head and the 4x4-pruned head on an H100 (PERF.md).
SPMV_WARPS = 4
RING_DEPTH = 2

#: Segments a decode warp stages in shared memory before it writes them
#: out (``STAGE`` of ``csrc/dtans_decode.cu``): 2, the least that writes
#: whole 32-byte sectors of a row's columns at `PAPER`'s 4 entries a
#: segment (a set whose segments hold another number of entries stages
#: the same ``DECODE_STAGE * 4`` = 8 entries a row, the same bytes,
#: written out whenever 8 have gathered). On an H100 4 tied with it on
#: the SmolLM-135M head and lost 3% on its 4x4-blocked shape, 8 lost 35-50%
#: (2 blocks an SM instead of 3; PERF.md, ``experiments/decode_geometry/``).
#: It fits a block at every lane width up to 1024, f64 on two tables
#: included (222,464 bytes at L = 1024), where 4 would not.
DECODE_STAGE = 2

#: Widest slice the SpMM block takes: its decoder warps and at least one
#: contraction warp must fit a 1024-thread block.
MAX_SPMM_LANE_WIDTH = 31 * WARP


def _align16(v: int) -> int:
    return (v + 15) & ~15


# ---------------------------------------------------------------------------
# the parameter set's sizes
# ---------------------------------------------------------------------------

def meta_words(params: DtansParams = PAPER) -> int:
    """32-bit words of a table slot's meta field (digit | base << m_bits |
    is_esc << (2 m_bits + 1), `pack.pack_tables`): 1 where its
    ``2 m_bits + 2`` bits fit one, else 2."""
    return 1 if 2 * params.m_bits + 2 <= 32 else 2


def slot_bytes(params: DtansParams = PAPER) -> int:
    """Bytes of a packed table slot: the u64 symbol and the meta words (12
    at `PAPER`, 16 at ``m_bits = 16``)."""
    return 8 + 4 * meta_words(params)


def entries(params: DtansParams = PAPER) -> int:
    """Nonzeros of a segment, ``l / 2`` (4 at `PAPER`)."""
    return params.l // 2


def exchange_words(params: DtansParams = PAPER) -> int:
    """u64 words a warp of a wide group writes per exchange: 16-bit fields
    of its ``o`` claims and escape count, or of the ``l`` positions'
    escape counts, whichever needs more (2 at `PAPER`)."""
    return max(-(-(params.o + 1) // 4), -(-params.l // 4))


def table_bytes(n_tables: int, params: DtansParams = PAPER) -> int:
    """Bytes of ``n_tables`` packed coding tables (98,304 for two at
    `PAPER`; 1,572,864 at K = 2^16 with 12-byte slots)."""
    return int(n_tables) * params.K * slot_bytes(params)


def _unit_bytes(lane_width: int, params: DtansParams) -> int:
    """Shared memory of one unit in flight: its refill windows (two
    parities of ``o`` words a lane) and the claim exchange."""
    uw = unit_warps(lane_width)
    R = uw * WARP
    return (_align16(2 * params.o * R * 4)
            + _align16(2 * uw * exchange_words(params) * 8)
            + _align16(2 * uw * 4))


@functools.lru_cache(maxsize=None)
def tables_in_smem(params: DtansParams = PAPER) -> bool:
    """Whether the kernels of a parameter set stage the coding tables in
    shared memory: where two tables fit beside the largest plan of the
    rest (the decode block at lane width 1024, f64: one unit of 32 warps,
    each with its staging tile). Else every lookup reads global memory
    through the read-only path. A value of the set, compiled into its
    kernels (``DTANS_TABLES_SMEM``): true at `PAPER` (98,304 + 124,160 of
    232,448 bytes), false at K = 2^16 (1,572,864 bytes of tables)."""
    rest = _unit_bytes(1024, params) + unit_warps(1024) * stage_bytes(
        DECODE_STAGE, 8)
    return (_align16(table_bytes(2, params)) + rest
            <= MAX_SMEM_BYTES - STATIC_SMEM_BYTES)


def group_size(lane_width: int) -> int:
    """Threads decoding one slice: L rounded up to a power of two up to a
    warp, to whole warps beyond."""
    L = int(lane_width)
    if L <= WARP:
        return 1 << max(L - 1, 0).bit_length()
    return -(-L // WARP) * WARP


def unit_warps(lane_width: int) -> int:
    return max(group_size(lane_width) // WARP, 1)


def unit_rows(lane_width: int) -> int:
    """Rows (thread lanes) of one unit: 32 for packed narrow slices, the
    slice's warps times 32 beyond."""
    return unit_warps(lane_width) * WARP


def stage_bytes(stage: int, itemsize: int) -> int:
    """A decode warp's staging tile: 32 rows x ``stage`` * 4 entries
    (``stage`` segments at `PAPER`) of columns (4 bytes an entry) and
    values (4 or 8 bytes), whatever the parameter set."""
    return WARP * int(stage) * 4 * (4 + int(itemsize))


def smem_plan(n_tables: int, lane_width: int, itemsize: int, *,
              bn: int | None = None, units_per_block: int = 1,
              stage: int = 0, params: DtansParams = PAPER) -> dict:
    """Bytes of shared memory each part of a block takes, and their
    ``total``, for the kernels of ``params``. ``bn=None`` is the SpMV /
    decode block (``units_per_block`` units in flight; the decode block
    adds a tile of ``stage`` * 4 entries a row per warp), an integer the
    SpMM block at column tile ``bn``. ``tables`` is 0 where the set's
    tables stay in global memory (`tables_in_smem`)."""
    uw = unit_warps(lane_width)
    R = uw * WARP
    per_unit = _unit_bytes(lane_width, params)
    plan = {"tables": (_align16(table_bytes(n_tables, params))
                       if tables_in_smem(params) else 0)}
    if bn is None:
        plan["units"] = units_per_block * per_unit
        if stage:
            plan["stage"] = units_per_block * uw * stage_bytes(stage,
                                                               itemsize)
    else:
        plan["units"] = per_unit
        h = entries(params)
        plan["ring"] = (_align16(RING_DEPTH * h * R * 4)
                        + _align16(RING_DEPTH * h * R * itemsize))
        plan["acc"] = _align16(R * int(bn) * itemsize)
    plan["total"] = sum(plan.values())
    return plan


def spmm_fixed_bytes(n_tables: int, lane_width: int, itemsize: int,
                     params: DtansParams = PAPER) -> int:
    """The SpMM plan without its accumulator tile."""
    return smem_plan(n_tables, lane_width, itemsize, bn=0,
                     params=params)["total"]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch of a dtANS kernel (the C entries' geometry arguments)."""
    group: int            # threads per slice
    unit_warps: int       # decoder warps per unit
    slices_per_unit: int
    units: int
    units_per_block: int  # units in flight per block (SpMM: 1)
    consumer_warps: int   # SpMM contraction warps (0 otherwise)
    threads: int
    blocks: int
    smem: int             # dynamic shared memory, bytes
    col_tiles: int = 1    # SpMM column tiles (work items = units x tiles)

    def args(self) -> list:
        return [self.group, self.unit_warps, self.slices_per_unit,
                self.units, self.units_per_block, self.consumer_warps,
                self.blocks, self.threads, self.smem]


def consumer_warps(lane_width: int, bn: int) -> int:
    """Contraction warps of the SpMM block: 4 for a tile narrower than a
    warp, else one per 8 rows of the unit, 4 to 12 (the fastest of 4, 8
    and 12 on an H100: PERF.md); blocks of up to 8 decoder warps stay
    within 512 threads (the instantiation with 128 registers a thread),
    every block within 1024."""
    uw = unit_warps(lane_width)
    room = 16 - uw if uw <= 8 else WARP - uw
    want = max(4, uw * WARP // 8) if bn >= WARP else 4
    return max(1, min(12, want, room))


def _blocks(work: int, threads: int, smem: int, n_sm: int) -> int:
    per_sm = max(1, min(SM_THREADS // threads,
                        SM_SMEM_BYTES // (smem + BLOCK_RESERVED_BYTES)))
    return max(1, min(work, n_sm * per_sm))


def geometry(n_slices: int, lane_width: int, n_tables: int, itemsize: int,
             *, bn: int | None = None, batch: int = 1,
             n_sm: int = SM_COUNT, params: DtansParams = PAPER) -> Geometry:
    """The launch of the SpMV / decode kernels (``bn=None``) or of the SpMM
    kernel at column tile ``bn`` over ``batch`` columns, for the kernels
    of ``params``."""
    G = group_size(lane_width)
    uw = unit_warps(lane_width)
    spu = WARP // G if uw == 1 else 1
    units = -(-int(n_slices) // spu)
    if bn is None:
        upb = max(SPMV_WARPS // uw, 1)
        threads = upb * uw * WARP
        smem = smem_plan(n_tables, lane_width, itemsize,
                         units_per_block=upb, params=params)["total"]
        return Geometry(G, uw, spu, units, upb, 0, threads,
                        _blocks(-(-units // upb), threads, smem, n_sm), smem)
    cw = consumer_warps(lane_width, bn)
    threads = (uw + cw) * WARP
    smem = smem_plan(n_tables, lane_width, itemsize, bn=bn,
                     params=params)["total"]
    tiles = -(-int(batch) // int(bn))
    return Geometry(G, uw, spu, units, 1, cw, threads,
                    _blocks(units * tiles, threads, smem, n_sm), smem, tiles)


def decode_geometry(n_slices: int, lane_width: int, n_tables: int,
                    itemsize: int, *, n_sm: int = SM_COUNT,
                    params: DtansParams = PAPER) -> Geometry:
    """The launch of the decode kernel: the SpMV kernel's units and blocks,
    each warp with a staging tile of `DECODE_STAGE` * 4 entries a row."""
    base = geometry(n_slices, lane_width, n_tables, itemsize, n_sm=n_sm,
                    params=params)
    upb = base.units_per_block
    smem = smem_plan(n_tables, lane_width, itemsize, units_per_block=upb,
                     stage=DECODE_STAGE, params=params)["total"]
    return dataclasses.replace(
        base, smem=smem,
        blocks=_blocks(-(-base.units // upb), base.threads, smem, n_sm))


def choose_bn(rows: int, batch: int, itemsize: int, fixed: int = 0,
              widest: int | None = None) -> int | None:
    """Widest column-tile width ``bn`` (at most ``widest``) whose ``(rows,
    bn)`` accumulator tile fits `DEFAULT_SMEM_BYTES` and, beside ``fixed``
    bytes of the kernel's other shared memory, `MAX_SMEM_BYTES`; ``None``
    when the whole batch fits (untiled: one decode per slice for all
    columns). ``rows`` rounds up to whole warps."""
    if batch <= 0:
        return None
    per_col = -(-int(rows) // WARP) * WARP * int(itemsize)
    if per_col <= 0:
        return None
    most = (MAX_SMEM_BYTES - int(fixed)) // per_col
    bn = int(min(DEFAULT_SMEM_BYTES // per_col, most))
    if widest is not None:
        bn = min(bn, int(widest))
    if bn >= batch:
        return None
    if bn >= WARP:
        bn = (bn // WARP) * WARP
    if bn < MIN_BN:
        bn = min(MIN_BN, most)
    return max(bn, 1)



def dtans_widest_bn(lane_width: int, n_tables: int, itemsize: int,
                    params: DtansParams = PAPER) -> int:
    """Widest dtANS SpMM column tile whose `smem_plan` fits a block beside
    the kernels' static shared memory: 335 columns at L = 128 f32 on one
    table, 163 at f64, 23 at L = 992 f32 (`PAPER`); 0 where not even the
    plan's fixed part fits. Every tile gives the untiled bits, so
    `ops.spmm` caps any wider tile here."""
    room = MAX_SMEM_BYTES - STATIC_SMEM_BYTES - spmm_fixed_bytes(
        n_tables, lane_width, itemsize, params)
    # the accumulator tile, (unit rows, bn), is a whole number of 16 bytes
    return max(room // (unit_rows(lane_width) * int(itemsize)), 0)


def spmm_by_columns(lane_width: int, n_tables: int = 2, itemsize: int = 8,
                    params: DtansParams = PAPER) -> bool:
    """Whether `ops.spmm` serves a lane width by one SpMV launch a column:
    wider than the SpMM block takes (`MAX_SPMM_LANE_WIDTH`), or a plan
    that holds no column tile at all (`dtans_widest_bn` 0: the ring of a
    set with long segments at a wide slice, e.g. ``l = 48`` at L = 512).
    Either way it is bitwise the SpMM column by column. At `PAPER` every
    lane width up to 992 fits, whatever the tables and dtype."""
    return (int(lane_width) > MAX_SPMM_LANE_WIDTH
            or dtans_widest_bn(lane_width, n_tables, itemsize, params) < 1)


def dtans_bn(lane_width: int, n_tables: int, batch: int,
             itemsize: int, params: DtansParams = PAPER) -> int | None:
    """Column tile of the dtANS SpMM: `choose_bn`'s beside the plan's fixed
    part, at most `DTANS_BN_MAX` columns; ``None`` when the whole batch
    fits one tile."""
    return choose_bn(unit_rows(lane_width), batch, itemsize,
                     spmm_fixed_bytes(n_tables, lane_width, itemsize,
                                      params),
                     DTANS_BN_MAX)


def dtans_budget_bn(lane_width: int, n_tables: int, itemsize: int,
                    budget: float, params: DtansParams = PAPER) -> int:
    """Widest dtANS SpMM column tile whose whole `smem_plan` fits
    ``budget`` bytes (the reference's ``vmem_budget``, here a block's
    shared memory), at most `dtans_widest_bn`, at least one column."""
    room = (int(budget) - STATIC_SMEM_BYTES
            - spmm_fixed_bytes(n_tables, lane_width, itemsize, params))
    bn = room // (unit_rows(lane_width) * int(itemsize))
    return max(1, min(bn, dtans_widest_bn(lane_width, n_tables, itemsize,
                                          params)))


def resolve_bn(batch: int, bn, choose, widest: int | None = None
               ) -> int | None:
    """Effective column-tile width of one SpMM pass: an explicit ``bn``
    wins (untiled when it covers the whole batch); otherwise the kernel's
    ``choose`` (batch -> tile). A tile wider than ``widest`` (a whole
    batch included) is cut to ``widest``: every tile width gives the
    untiled bits."""
    if bn is not None:
        b = int(bn)
        if b < 1:
            raise ValueError(f"bn must be >= 1; got {bn}")
        bt = None if b >= batch else b
    else:
        bt = choose(batch)
    if widest is not None and (batch if bt is None else bt) > widest:
        bt = int(widest)
    return bt


def n_tiles(batch: int, bn: int | None) -> int:
    """Column tiles of a pass at tile ``bn`` (``None``: one)."""
    return 1 if bn is None else -(-int(batch) // int(bn))


def _within(bt: int, batch: int) -> int | None:
    return None if bt >= batch else bt


def dtans_spmm_tile(lane_width: int, n_tables: int, batch: int,
                    itemsize: int, params: DtansParams = PAPER, *,
                    bn=None, budget: float | None = None) -> int | None:
    """The column tile one `ops.spmm` pass at ``batch`` columns runs
    (``None``: untiled): an explicit ``bn``, else `dtans_budget_bn`'s
    where a shared-memory ``budget`` is given, else `dtans_bn`'s; cut to
    `dtans_widest_bn`, or to one column where `spmm_by_columns`."""
    if spmm_by_columns(lane_width, n_tables, itemsize, params):
        return resolve_bn(batch, bn, lambda b: None, 1)
    if budget is not None:
        bt = dtans_budget_bn(lane_width, n_tables, itemsize, budget, params)
        choose = functools.partial(_within, bt)
    else:
        choose = functools.partial(dtans_bn, lane_width, n_tables,
                                   itemsize=itemsize, params=params)
    return resolve_bn(batch, bn, choose,
                      dtans_widest_bn(lane_width, n_tables, itemsize,
                                      params))


def dtans_spmm_passes(lane_width: int, n_tables: int, batch: int,
                      itemsize: int, params: DtansParams = PAPER
                      ) -> tuple[int, int]:
    """``(column tiles, launches)`` of one default `ops.spmm` pass: the
    matrix is decoded once a tile. One launch (B == 1: the SpMV kernel;
    else the SpMM kernel with its tiles as work items), or B SpMV launches
    where `spmm_by_columns`. What the `H100` cost model charges."""
    if int(batch) <= 1:
        return 1, 1
    tiles = n_tiles(batch, dtans_spmm_tile(lane_width, n_tables, batch,
                                           itemsize, params))
    by_columns = spmm_by_columns(lane_width, n_tables, itemsize, params)
    return tiles, (tiles if by_columns else 1)


# ---------------------------------------------------------------------------
# the SELL / RGCSR / BCSR SpMM (csrc/padded_rows.cuh::spmm_warp_kernel)
# ---------------------------------------------------------------------------

#: Accumulator registers (32-bit words) a lane of the padded SpMM may hold:
#: 32 rows x 2 f32 columns, or 32 rows x 1 f64 column.
PADDED_ACC_WORDS = 64

#: Warps a block at one column a lane (and the fewest at two): chosen by
#: timing the SmolLM-135M head on an H100 (``experiments/padded_geometry/``,
#: PERF.md).
PADDED_WARPS = 8

#: Most warps a block: the kernel's ``__launch_bounds__(512)``. Two
#: columns a lane take up to this many, one block an SM.
PADDED_MAX_WARPS = 16

#: Most blocks of the flat grid (its x dimension).
MAX_GRID_BLOCKS = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class PaddedGeometry:
    """One launch of the padded SpMM kernel (its C entry's geometry
    arguments). A work item is one chunk of 32 rows and one slab of
    ``slab`` columns of a column tile of ``bt``; blocks run slab-major,
    ``warps`` chunks a block. Lane ``(g, bl)``, ``g = lane // bw``, owns
    rows ``g * bw + j`` (``j < bw``) of its chunk at the slab's columns
    ``c * bw + bl`` (``c < cols_per_lane``)."""
    bw: int               # lanes of a row group: a power of two <= 32
    cols_per_lane: int    # 1, or 2 at bw == 32 (f32)
    warps: int            # warps (chunks) a block
    stage: bool           # x of the slab staged in shared memory
    smem: int             # dynamic shared memory: slab and row buffers
    bt: int               # columns a tile
    chunks: int           # ceil(R / 32)
    tiles: int            # ceil(B / bt)
    slabs_per_tile: int   # ceil(bt / slab)
    blocks: int

    @property
    def row_groups(self) -> int:
        return WARP // self.bw

    @property
    def slab(self) -> int:
        """Columns of a work item."""
        return self.bw * self.cols_per_lane

    def acc_words(self, itemsize: int) -> int:
        """32-bit registers a lane's accumulators take."""
        return self.bw * self.cols_per_lane * int(itemsize) // 4

    def args(self) -> list:
        return [self.bw, self.cols_per_lane, self.warps, int(self.stage),
                self.blocks]


def padded_rows_bytes(itemsize: int) -> int:
    """A warp's buffer of 32 (column, value) pairs: 8 bytes a pair at f32,
    16 at f64 (the int padded to the double's alignment)."""
    return WARP * (8 if int(itemsize) == 4 else 16)


def _most_cols_per_lane(itemsize: int) -> int:
    return max(1, PADDED_ACC_WORDS * 4 // (WARP * int(itemsize)))


def _staged_bytes(n: int, slab: int, itemsize: int, warps: int) -> int:
    """Shared memory of a block that stages the slab's x columns."""
    return (_align16(int(n) * slab * int(itemsize))
            + int(warps) * padded_rows_bytes(itemsize))


def padded_geometry(rows: int, n: int, batch: int, bt: int, itemsize: int,
                    *, cols_per_lane: int | None = None,
                    warps: int | None = None, stage: bool | None = None,
                    n_sm: int = SM_COUNT) -> PaddedGeometry:
    """The launch of the padded SpMM over ``rows`` padded rows, x of
    ``n`` rows and ``batch`` columns in tiles of ``bt``. The slab is ``bt``
    rounded up to a power of two up to a warp (``32 / bw`` row groups share
    a warp below that); a tile wider than a warp of f32 columns gives each
    lane two columns (a 64-column slab) where that slab's x columns fit a
    block's shared memory. One column a lane runs `PADDED_WARPS` warps a
    block; two run one block an SM, with as many warps (`PADDED_WARPS` to
    `PADDED_MAX_WARPS`) as spread the work over ``n_sm`` SMs in one wave.
    The slab's x columns are staged in shared memory wherever they fit
    (``stage=None``); else x is read through L1."""
    bt, batch, itemsize = int(bt), int(batch), int(itemsize)
    if bt < 1 or batch < 1:
        raise ValueError(f"need bt >= 1 and batch >= 1; got {bt}, {batch}")
    bw = WARP if bt >= WARP else 1 << (bt - 1).bit_length()
    most = _most_cols_per_lane(itemsize) if bw == WARP else 1
    if cols_per_lane is None:
        two = (bt > WARP and most >= 2 and _staged_bytes(
            n, 2 * WARP, itemsize, PADDED_MAX_WARPS) <= MAX_SMEM_BYTES)
        cols_per_lane = 2 if two else 1
    if not 1 <= cols_per_lane <= most:
        raise ValueError(f"{cols_per_lane} columns a lane at bw={bw} and "
                         f"{itemsize}-byte values exceed the "
                         f"{PADDED_ACC_WORDS}-register accumulator budget")
    slab = bw * cols_per_lane
    chunks = -(-int(rows) // WARP)
    tiles = -(-batch // bt)
    per_tile = -(-bt // slab)
    if warps is None:
        warps = PADDED_WARPS
        if cols_per_lane == 2:
            work = chunks * tiles * per_tile       # warps' work items
            warps = min(PADDED_MAX_WARPS, max(warps, -(-work // int(n_sm))))
    if not 1 <= int(warps) <= PADDED_MAX_WARPS:
        raise ValueError(f"warps must be 1..{PADDED_MAX_WARPS}; got {warps}")
    staged = _staged_bytes(n, slab, itemsize, warps)
    if stage is None:
        stage = staged <= MAX_SMEM_BYTES
    if stage and staged > MAX_SMEM_BYTES:
        raise ValueError(f"a slab of {staged} B does not fit a block")
    blocks = tiles * per_tile * -(-chunks // int(warps))
    if blocks > MAX_GRID_BLOCKS:
        raise ValueError(f"{blocks} blocks exceed the grid")
    rows_bytes = int(warps) * padded_rows_bytes(itemsize)
    return PaddedGeometry(bw, int(cols_per_lane), int(warps), bool(stage),
                          staged if stage else rows_bytes, bt, chunks, tiles,
                          per_tile, blocks)


def padded_bn(batch: int, itemsize: int) -> int | None:
    """Default column tile of the SELL / RGCSR / BCSR SpMM: the widest
    slab, 64 columns at f32 (two a lane) and 32 at f64, or ``None`` when
    the batch fits one."""
    slab = WARP * _most_cols_per_lane(itemsize)
    return None if int(batch) <= slab else slab


def padded_budget_bn(rows: int, n: int, batch: int, itemsize: int,
                     budget: float) -> int:
    """Widest SELL / RGCSR / BCSR SpMM column tile, at most a slab, whose
    block stages its slab of x in shared memory within ``budget`` bytes
    (the reference's ``vmem_budget``): `padded_geometry`'s own plan; one
    column where not even that fits."""
    for bt in range(WARP * _most_cols_per_lane(itemsize), 0, -1):
        g = padded_geometry(rows, n, batch, bt, itemsize)
        if g.stage and g.smem <= budget:
            return bt
    return 1


def padded_spmm_tile(rows: int, n: int, batch: int, itemsize: int, *,
                     bn=None, budget: float | None = None) -> int | None:
    """The column tile one SELL / RGCSR / BCSR SpMM pass runs (``None``:
    untiled): an explicit ``bn``, else `padded_budget_bn`'s where a
    ``budget`` is given, else `padded_bn`'s."""
    if budget is not None:
        choose = functools.partial(
            _within, padded_budget_bn(rows, n, batch, itemsize, budget))
    else:
        choose = functools.partial(padded_bn, itemsize=itemsize)
    return resolve_bn(batch, bn, choose)


def padded_spmm_staged(rows: int, n: int, batch: int, itemsize: int) -> bool:
    """Whether the default SELL / RGCSR / BCSR SpMM pass stages its x slab
    in shared memory (`padded_geometry`; else x is read through L1)."""
    bt = padded_bn(batch, itemsize) or int(batch)
    return padded_geometry(rows, n, batch, bt, itemsize).stage


def padded_spmm_passes(batch: int, itemsize: int) -> tuple[int, int]:
    """``(column tiles, launches)`` of one default SELL / RGCSR / BCSR
    pass: the SpMV kernel at B == 1, else the SpMM kernel, its tiles work
    items of one launch, each reading the matrix again."""
    if int(batch) <= 1:
        return 1, 1
    return n_tiles(batch, padded_bn(batch, itemsize)), 1


#: The reference's column-tile schedules (``repro.kernels.tiling.
#: resolve_tile_mode``): a 2-D grid over (slice, tile), a loop over the
#: tiles, or ``"auto"``, its pick of the two.
TILE_MODES = ("auto", "grid", "loop")


def check_tile_mode(tile_mode: str) -> str:
    """``tile_mode`` as the reference spells it. The port's kernels run
    one schedule, a pass's column tiles as work items of one launch, so
    every mode launches the same kernels and gives the same bits; an
    unknown one raises as the reference's does."""
    if tile_mode not in TILE_MODES:
        raise ValueError(f"tile_mode must be 'auto', 'grid' or 'loop'; "
                         f"got {tile_mode!r}")
    return tile_mode

