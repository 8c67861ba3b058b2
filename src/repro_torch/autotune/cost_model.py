"""Roofline-style cost model for sparse formats on one accelerator chip.

This is the library home of the performance model that previously lived
in ``benchmarks/suite.py``: SpMVM is memory-bound, so the runtime of a
format is two-level memory time plus a compute term:

    t = miss_bytes / hbm_bw + hit_bytes / cache_bw + work / vpu_rate

with ``hit_bytes = min(bytes, cache_bytes)`` for a warm cache (the
card's 50 MB L2 in the `H100` model, the port's default; the JAX
package's `V5E` model, kept here by name, prices the paper's 96 MB) and
0 for a cold one.

The compute term is priced from each format's
`repro_torch.sparse.registry.FormatSpec.cost_terms` work split:

* **lock-step work** (SELL, RGCSR, BCSR, the dtANS family) — element
  slots processed ``spmv_ops_per_elem`` at a time, slices running to
  their longest row (`Fingerprint.lockstep`; BCSR counts its filled
  block cells). SELL additionally pays the padding in bytes; RGCSR
  stores compactly and pays it only here — exactly the padding-waste vs
  slice-alignment trade the selector arbitrates.
* **row-sequential work** (CSR, COO) — real nonzeros that cannot fill
  the vector unit with irregular rows, charged ``row_seq_penalty`` ops
  per element (sublane utilization, the reason GPU SpMV abandons plain
  CSR).
* **decode work** (the entropy-coded formats) — ``decode_ops_per_nnz``
  vector ops per processed element (segment unpack + table gathers +
  limb update, counted from ``kernels/common.py``) — the paper's
  observation that warm caches shift the bottleneck from bytes to
  decode throughput (Section V-B vs V-C). This is the predictor behind
  the paper-Fig. 9 format-selection question `repro_torch.autotune.select`
  answers per matrix.

Byte counts come from the registry too: `FormatSpec.nbytes_exact` where
the fingerprint carries the format's features, `nbytes_estimate`
(escape-aware entropy features, see `fingerprint.codeable_bits`) for
the entropy-coded families, refinable by actually encoding
(``search.select(budget=...)``). The estimate formulas live here; the
specs call back into them lazily.

(`model_time` keeps the original two-term + decode-flag form for the
paper-figure benchmarks, Figs. 7/8; the selector path uses
`candidate_time` = `memory_time` + `work_time`.)

This is a copy of the JAX package's ``repro.autotune.cost_model``: under
the same `MachineModel` constants it prices every candidate to the same
float (the column-tile count comes from `_n_col_tiles`, the reference's
fast-memory budget rule, kept here because the port's kernels tile by
their own shared-memory plan, `repro_torch.kernels.tiling`).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.autotune.fingerprint import Fingerprint
from repro_torch.core.params import PAPER, DtansParams
from repro_torch.sparse.registry import (CostTerms, KnobbedConfigMixin,
                                         format_names, get_format)
from repro_torch.sparse.rgcsr import local_indptr_bytes


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Per-chip machine constants of the roofline model."""

    name: str = "v5e"
    hbm_bw: float = 819e9            # bytes/s
    cache_bw: float = 4 * 819e9      # VMEM-resident reread bandwidth
    cache_bytes: float = 96e6        # paper's L2 size, for comparability
    vpu_rate: float = 1.9e12         # vector ops/s (8x128 x 2 ALUs)
    decode_ops_per_nnz: float = 16   # unpack + 2 gathers + limb ops
    spmv_ops_per_elem: float = 1     # madd+gather per lock-step element
    row_seq_penalty: float = 8       # CSR/COO sublane utilization factor
    # Interconnect terms of the sharded path (x broadcast + y psum over
    # the mesh ``model`` axis): effective per-device ring-collective
    # bandwidth over the v5e 2D-torus ICI, plus a fixed per-hop launch
    # latency.
    ici_bw: float = 9e10             # bytes/s per device, ring collective
    collective_latency: float = 1e-6  # seconds per collective hop
    # Fast-memory capacity available to one kernel program (VMEM on the
    # TPU, a block's shared memory on the card) — the budget
    # `_choose_bn` tiles the RHS against.  When a batch's x/y columns
    # exceed it, the pass splits into column tiles and the matrix stream
    # (and its decode) is re-read once per tile: the capacity term
    # `spmm_bytes` / `work_time` charge via ``col_tiles``.
    vmem_bytes: float = float(16 * 2 ** 20)

    def signature(self) -> str:
        """Cache-key component: the *constants*, not just the name, so
        recalibrating a model never serves stale cached decisions."""
        return (f"{self.name}:{self.hbm_bw:g}:{self.cache_bw:g}:"
                f"{self.cache_bytes:g}:{self.vpu_rate:g}:"
                f"{self.decode_ops_per_nnz:g}:{self.spmv_ops_per_elem:g}:"
                f"{self.row_seq_penalty:g}:{self.ici_bw:g}:"
                f"{self.collective_latency:g}:{self.vmem_bytes:g}")

    def to_dict(self) -> dict:
        """JSON form — the payload of a persisted machine profile
        (`repro_torch.autotune.measure.save_profile`)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "MachineModel":
        """Inverse of `to_dict`; unknown keys are rejected so a foreign
        profile file fails loudly rather than half-applying."""
        fields = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - fields
        if extra:
            raise ValueError(f"unknown MachineModel fields: {sorted(extra)}")
        return cls(**d)


def dtans_config_name(lane_width: int, shared_table: bool) -> str:
    """Canonical name of one CSR-dtANS configuration (registry-backed;
    `FormatSpec.encode_knobs` is the single source of truth)."""
    return get_format("dtans").encode_knobs(
        {"lane_width": lane_width, "shared_table": shared_table})


def rgcsr_config_name(group_size: int) -> str:
    """Canonical name of one plain-RGCSR configuration."""
    return get_format("rgcsr").encode_knobs({"group_size": group_size})


def rgcsr_dtans_config_name(group_size: int,
                            shared_table: bool = True) -> str:
    """Canonical name of one RGCSR-dtANS configuration."""
    return get_format("rgcsr_dtans").encode_knobs(
        {"group_size": group_size, "shared_table": shared_table})


def bcsr_config_name(block_shape: tuple) -> str:
    """Canonical name of one plain-BCSR configuration."""
    return get_format("bcsr").encode_knobs({"block_shape": block_shape})


#: The JAX package's default chip model (TPU v5e), numerically identical
#: to its constants: the port prices under it to hold its decisions
#: against the reference's. Never the port's default.
V5E = MachineModel()

#: The port's default: one NVIDIA H100 SXM, seeded from the data sheet
#: (3.35 TB/s HBM, 50 MB L2, 67 TFLOP/s f32 outside the tensor cores,
#: NVLink 450 GB/s each way) and the 227 KB of shared memory a block may
#: opt into (`repro_torch.kernels.tiling.MAX_SMEM_BYTES`). The L2 reread
#: rate has no data-sheet number and takes `V5E`'s 4x the HBM rate; the
#: work coefficients are `V5E`'s. UNCALIBRATED until
#: `repro_torch.autotune.measure.calibrate` has run on the card: its
#: absolute seconds are a seed, not a measurement.
H100 = MachineModel(name="h100", hbm_bw=3.35e12, cache_bw=4 * 3.35e12,
                    cache_bytes=50e6, vpu_rate=67e12, ici_bw=450e9,
                    vmem_bytes=232448.0)


#: The reference's column-tile rule (``repro.kernels.tiling``): x/y tiles
#: may claim this fraction of `MachineModel.vmem_bytes`, widths snap down
#: to a multiple of `_LANE` and never fall under `_MIN_BN`.
_TILE_FRACTION = 0.5
_LANE = 128
_MIN_BN = 8


def _choose_bn(n: int, rows: int, batch: int, itemsize: int,
               vmem_bytes: float) -> int | None:
    """Widest column tile whose x tile ``(n, bn)`` plus y tile ``(rows,
    bn)`` fit the tile budget, or None when the whole batch fits."""
    if batch <= 0:
        return None
    per_col = (int(n) + int(rows)) * int(itemsize)
    if per_col <= 0:
        return None
    bn = int(vmem_bytes * _TILE_FRACTION // per_col)
    if bn >= batch:
        return None
    if bn >= _LANE:
        bn = (bn // _LANE) * _LANE
    return max(bn, _MIN_BN)


def _n_col_tiles(n: int, rows: int, batch: int, itemsize: int,
                 vmem_bytes: float) -> int:
    """Column tiles one SpMM pass runs at batch ``batch`` under the
    `_choose_bn` rule: the multiplier on per-tile matrix traffic and
    decode work that `spmm_bytes` / `work_time` charge."""
    bn = _choose_bn(n, rows, batch, itemsize, vmem_bytes)
    return 1 if bn is None else -(-int(batch) // bn)


def spmm_bytes(fmt_bytes: int, n: int, m: int, vbytes: int,
               batch: int = 1, col_tiles: int = 1) -> int:
    """Bytes moved by one multi-RHS SpMM pass: the matrix (and for the
    entropy formats, its one decode) is paid ONCE, while the x and y
    vectors are paid per right-hand side — the amortization that lets a
    compressed format win at batch sizes where it loses at B=1.

    ``col_tiles > 1`` is the capacity term: when the batch's x/y
    columns overflow `MachineModel.vmem_bytes`, the blocked kernel
    (`_n_col_tiles`) splits the RHS into column tiles and
    re-reads the matrix stream once per tile, so the format bytes are
    charged ``col_tiles`` times while the x/y traffic is unchanged
    (each column still moves exactly once)."""
    return fmt_bytes * max(int(col_tiles), 1) + batch * (n + m) * vbytes


def spmv_bytes(fmt_bytes: int, n: int, m: int, vbytes: int) -> int:
    """Bytes moved by one SpMVM: matrix + x + y (paper Section III-A)."""
    return spmm_bytes(fmt_bytes, n, m, vbytes, 1)


def model_time(bytes_moved: int, nnz: int, *, warm: bool, decode: bool,
               machine: MachineModel = H100) -> float:
    """Modeled seconds of one SpMVM pass (legacy two-term form).

    Kept verbatim for the paper-figure benchmarks (Figs. 7/8 compare a
    fixed CSR-dtANS against byte-count baselines under the paper's own
    model). The selector uses `candidate_time`, which also charges the
    per-format kernel work."""
    t = memory_time(bytes_moved, warm=warm, machine=machine)
    if decode:
        t += nnz * machine.decode_ops_per_nnz / machine.vpu_rate
    return t


def work_time(terms: CostTerms, machine: MachineModel = H100,
              batch: int = 1, col_tiles: int = 1) -> float:
    """Seconds of kernel compute for one `FormatSpec.cost_terms` split.

    The contraction terms (``lockstep``/``rowseq``) scale with the
    number of right-hand sides; the ``decode`` term does not — the
    fused SpMM kernels decode each segment once and contract it against
    all B columns, so entropy-decode overhead amortizes with batch.
    The amortization is bounded by fast-memory capacity: a pass split into
    ``col_tiles`` column tiles re-decodes the stream once per tile
    (`spmm_bytes` charges the matching byte term)."""
    ops = ((terms.lockstep + terms.rowseq * machine.row_seq_penalty)
           * machine.spmv_ops_per_elem * batch
           + terms.decode * machine.decode_ops_per_nnz
           * max(int(col_tiles), 1))
    return ops / machine.vpu_rate


def memory_time(bytes_moved: float, *, warm: bool,
                machine: MachineModel = H100) -> float:
    """Two-level memory seconds for one pass over ``bytes_moved`` —
    the single home of the warm hit/miss split (`spmv_time`,
    `candidate_time` and `model_time`'s callers all price memory
    through this formula)."""
    hit = min(bytes_moved, machine.cache_bytes) if warm else 0.0
    return (bytes_moved - hit) / machine.hbm_bw + hit / machine.cache_bw


def spmv_time(nbytes: int, work_elems: float, ops_per_elem: float, *,
              rows: int, cols: int, vbytes: int, warm: bool,
              machine: MachineModel = H100) -> float:
    """Modeled seconds of one SpMVM pass (selector model: memory time
    plus per-format kernel work, here as a flat work x ops/elem
    product; `candidate_time` is the `CostTerms`-split form)."""
    return (memory_time(spmv_bytes(nbytes, cols, rows, vbytes),
                        warm=warm, machine=machine)
            + work_elems * ops_per_elem / machine.vpu_rate)


def collective_time(n_shards: int, *, rows: int, cols: int, vbytes: int,
                    batch: int = 1,
                    machine: MachineModel = H100) -> float:
    """Seconds of interconnect work for one sharded SpMM pass: the x
    broadcast (each device receives the full (cols, B) operand) and the
    y all-reduce (ring psum moves ``(k-1)/k`` of the (rows, B) result
    through each device), plus a log2(k) hop-latency floor per
    collective — the reason tiny matrices never want 16 chips no matter
    how fast their shards decode.  Zero at one shard (no collectives on
    the single-device path)."""
    k = int(n_shards)
    if k <= 1:
        return 0.0
    wire = (cols + rows) * batch * vbytes * (k - 1) / k
    return wire / machine.ici_bw + \
        2 * machine.collective_latency * math.ceil(math.log2(k))


def candidate_time(fp: Fingerprint, fmt: str, nbytes: int, *, warm: bool,
                   machine: MachineModel = H100, batch: int = 1,
                   n_shards: int = 1, **knobs) -> float:
    """Modeled seconds of one (format, config) from fingerprint
    features: `memory_time` plus the `work_time` of the format's
    `CostTerms` — for a ``batch``-RHS SpMM pass (matrix bytes and
    decode work once, x/y bytes and contraction work per RHS).

    ``n_shards > 1`` prices the sharded path: the critical-path device
    holds ~1/k of the matrix bytes and does 1/k of the decode and
    contraction work (the row partition is balanced over decode
    slices), pays the full broadcast x against the cache, and the pass
    ends in the `collective_time` x-broadcast/y-reduce — the
    single-chip-vs-k-chips trade `search.select(mesh=)` arbitrates.

    The single formula shared by `candidates`, `search._refine`, the
    exhaustive oracle (`repro_torch.autotune.oracle`) and calibration —
    selector and oracle cannot drift apart. Knobs the format does not
    declare are ignored, so callers may pass a candidate's full knob
    set."""
    spec = get_format(fmt)
    terms = spec.cost_terms(fp, **spec.filter_knobs(knobs))
    k = max(int(n_shards), 1)
    if k > 1:
        nbytes = -(-int(nbytes) // k)
        terms = CostTerms(lockstep=terms.lockstep / k,
                          rowseq=terms.rowseq / k,
                          decode=terms.decode / k)
    # Capacity tile count of the grid-blocked kernel: how many column
    # tiles the batch's x/y working set forces, hence how many times the
    # matrix stream is re-read and re-decoded.
    tiles = _n_col_tiles(fp.cols, 0, max(int(batch), 1), fp.value_bytes,
                        machine.vmem_bytes)
    return (memory_time(spmm_bytes(nbytes, fp.cols, fp.rows,
                                   fp.value_bytes, batch, tiles),
                        warm=warm, machine=machine)
            + work_time(terms, machine, batch, tiles)
            + collective_time(k, rows=fp.rows, cols=fp.cols,
                              vbytes=fp.value_bytes, batch=batch,
                              machine=machine))


@dataclasses.dataclass(frozen=True)
class Candidate(KnobbedConfigMixin):
    """One (format, config) point with its size and modeled runtime.

    ``knobs`` is the canonical ``((name, value), ...)`` tuple of the
    configuration — the registry's generic replacement for per-format
    fields; `lane_width` / `shared_table` / `group_size` /
    `block_shape` remain available via `KnobbedConfigMixin`.
    """

    fmt: str                      # a registered format family
    nbytes: int                   # format bytes (estimated or exact)
    modeled_time: float           # seconds per SpMVM pass
    exact_size: bool              # True when nbytes is not an estimate
    knobs: tuple = ()             # ((knob, value), ...), domain order
    # Devices the candidate is priced for (1 = single-chip path; > 1
    # adds the `collective_time` terms). Not part of the config name —
    # the same (format, knobs) point exists once per shard count.
    n_shards: int = 1
    # Median wall-clock seconds from `repro_torch.autotune.measure`; filled
    # by the measured-refinement pass, None for modeled-only search.
    measured_time: float | None = None


def make_candidate(fp: Fingerprint, fmt: str, knobs: dict, nbytes: int,
                   exact: bool, *, warm: bool,
                   machine: MachineModel = H100,
                   batch: int = 1, n_shards: int = 1) -> Candidate:
    """Price one (format, knobs, nbytes) point into a `Candidate`."""
    spec = get_format(fmt)
    kn = spec.normalize_knobs(knobs)
    return Candidate(
        fmt=fmt, nbytes=int(nbytes),
        modeled_time=candidate_time(fp, fmt, nbytes, warm=warm,
                                    machine=machine, batch=batch,
                                    n_shards=n_shards, **kn),
        exact_size=bool(exact),
        knobs=tuple((k, kn[k]) for k in spec.knob_domains),
        n_shards=int(n_shards))


def csr_nbytes(fp: Fingerprint) -> int:
    return get_format("csr").nbytes_exact(fp)


def coo_nbytes(fp: Fingerprint) -> int:
    return get_format("coo").nbytes_exact(fp)


def sell_nbytes(fp: Fingerprint, slice_height: int = 32) -> int:
    return get_format("sell").nbytes_exact(fp, slice_height=slice_height)


def rgcsr_nbytes(fp: Fingerprint, group_size: int) -> int:
    """`repro_torch.sparse.rgcsr.RGCSR.nbytes` from the fingerprint's row-nnz
    RLE (mirrors `rgcsr_nbytes_exact`) — exact for *any* group size."""
    return get_format("rgcsr").nbytes_exact(fp, group_size=group_size)


def dtans_nbytes_estimate(fp: Fingerprint, *, lane_width: int = 128,
                          shared_table: bool = True,
                          params: DtansParams = PAPER) -> int:
    """Estimated `CSRdtANS.nbytes` from fingerprint features alone.

    Mirrors the exact accounting in `repro_torch.core.csr_dtans.CSRdtANS`:
    tables + 4-byte stream words + escaped raw payloads + one 4-byte
    per-row length + per-slice offsets.

    The stream-word count uses the encoder's segment mechanics rather
    than raw entropy: every l-symbol segment emits ``o`` words minus the
    conditional-load extractions it earns, extraction happens only on
    non-final segments of a row (``encode_scalar`` branches only while
    ``j < nseg - 1``), and each extraction is a whole 32-bit word — so a
    segment carrying ``b`` information bits extracts
    ``clip(floor((o*32 - b) / 32), 0, f)`` words. Information bits per
    symbol come from the fingerprint's escape-aware table estimate.
    """
    vb = fp.value_bytes
    K = params.K
    T = 1 if shared_table else 2
    n_slices = -(-fp.rows // lane_width) if fp.rows else 0

    symbols = 2 * fp.nnz + fp.segment_pad_symbols
    if shared_table:
        real_bps = fp.merged_stream_bits
    else:
        real_bps = (fp.delta_stream_bits + fp.value_stream_bits) / 2.0
    # Tail padding uses the cheapest in-table symbol: log2(K/M) bits.
    pad_bps = params.k_bits - params.m_bits
    bps = ((2 * fp.nnz * real_bps + fp.segment_pad_symbols * pad_bps)
           / symbols) if symbols else 0.0

    seg_bits = params.l * bps
    extracts = min(max(math.floor((params.o * 32 - seg_bits) / 32.0), 0),
                   params.f)
    n_nonlast = fp.n_segments - fp.nonempty_rows
    stream_words = params.o * fp.n_segments - extracts * n_nonlast
    stream_bytes = 4 * stream_words

    esc_bytes = int(fp.delta_escape_frac * fp.nnz) * 4
    esc_bytes += int(fp.value_escape_frac * fp.nnz) * vb

    b = T * K * (vb + 8)                 # coding tables
    b += stream_bytes
    b += esc_bytes
    b += fp.rows * 4                     # per-row n
    b += (n_slices + 1) * 8              # stream offsets
    b += (n_slices + 1) * 4 * T          # escape offsets
    return int(b)


def rgcsr_dtans_nbytes_estimate(fp: Fingerprint, *, group_size: int = 32,
                                shared_table: bool = True,
                                params: DtansParams = PAPER) -> int:
    """Estimated `RGCSRdtANS.nbytes`: the CSR-dtANS estimate at interleave
    width G, with 4-byte per-row lengths replaced by group-local ones
    (16-bit unless some row reaches 2**16 nonzeros)."""
    base = dtans_nbytes_estimate(fp, lane_width=group_size,
                                 shared_table=shared_table, params=params)
    row_bytes = local_indptr_bytes(fp.row_nnz_max)
    return base - fp.rows * 4 + fp.rows * row_bytes


def bcsr_dtans_nbytes_estimate(fp: Fingerprint, *,
                               block_shape: tuple = (2, 2),
                               shared_table: bool = True,
                               params: DtansParams = PAPER) -> int:
    """Estimated `BCSRdtANS.nbytes` from fingerprint features alone.

    The encoded stream covers the *block-filled* matrix: ``F`` stored
    cells (`Fingerprint.block_nonempty` x r x c). Unlike the plain
    dtANS estimate's uniform bits/symbol, segments here come in two
    classes — ones carrying at least one original value (priced at the
    value domain's escape-aware bits; these rarely earn conditional-
    load extractions) and fill-only segments (runs of delta 1 and value
    0, near the cheapest-in-table floor of ``k_bits - m_bits``, which
    extract eagerly) — mixed by the probability a segment contains a
    real value. Exact-fill matrices (F == nnz) have no fill-only
    segments and reduce to the real-segment model. Still an estimate
    (within ~10-15% on the stress corpus): ``select(budget=k)``
    refinement and the oracle construct the truth. Metadata follows
    `BCSRdtANS.nbytes`: tables, per-block-row 16-bit block counts,
    per-block-row offsets.
    """
    r, c = block_shape
    vb = fp.value_bytes
    K = params.K
    T = 1 if shared_table else 2
    from repro_torch.sparse.registry import block_count
    blocks, _ = block_count(fp, block_shape)
    F = blocks * r * c
    nbr = -(-fp.rows // r) if fp.rows else 0
    if F == 0:
        return T * K * (vb + 8) + nbr * 2 + (nbr + 1) * (8 + 4 * T)

    filled_rows = min(fp.rows, blocks * r)   # rows with >= 1 stored cell
    ell = params.l
    # Segment structure of the filled matrix: 2F symbols across
    # ~filled_rows rows, each row padded to a whole segment.
    n_segments = max(int(math.ceil(2 * F / ell)), filled_rows)

    fill_bps = params.k_bits - params.m_bits + 0.5
    # Real-value bits/symbol: the value domain's escape-aware estimate
    # (the fill symbols dilute the merged table, so the merged average
    # is a floor, not a price).
    vbits = max(fp.value_stream_bits, fp.merged_stream_bits)
    pairs_per_seg = ell / 2
    bits_real_seg = pairs_per_seg * (vbits + fill_bps)
    bits_fill_seg = ell * fill_bps
    # P(segment holds no original value) under a uniform fill mix.
    p_fill_only = (1.0 - fp.nnz / F) ** pairs_per_seg

    def extracts(seg_bits: float) -> int:
        return min(max(math.floor((params.o * 32 - seg_bits) / 32.0),
                       0), params.f)

    n_nonlast = max(n_segments - filled_rows, 0)
    extract_words = n_nonlast * (
        p_fill_only * extracts(bits_fill_seg)
        + (1.0 - p_fill_only) * extracts(bits_real_seg))
    stream_words = params.o * n_segments - int(extract_words)
    esc_bytes = int(fp.delta_escape_frac * fp.nnz) * 4
    esc_bytes += int(fp.value_escape_frac * fp.nnz) * vb

    b = T * K * (vb + 8)                 # coding tables
    b += 4 * stream_words
    b += esc_bytes
    b += nbr * 2                         # per-block-row block counts
    b += (nbr + 1) * 8                   # stream offsets
    b += (nbr + 1) * 4 * T               # escape offsets
    return int(b)


def normalize_knob_overrides(knob_overrides: dict | None = None) -> dict:
    """One canonical knob-override dict (``{knob name -> domain
    tuple}``, unset entries dropped). Shared by `candidates`,
    `search.select` and `oracle.oracle_times` so the three can never
    disagree about what a sweep override means.
    """
    return {k: tuple(v) for k, v in (knob_overrides or {}).items()
            if v is not None}


def render_knob_overrides(overrides: dict) -> str:
    """Deterministic cache-key spelling of one override dict
    (``"def"`` when empty — no overrides, the specs' own domains)."""
    if not overrides:
        return "def"

    def one(v) -> str:
        if isinstance(v, (tuple, list)):
            return "x".join(str(x) for x in v)
        return str(v)

    return ";".join(f"{k}=" + ",".join(one(v) for v in vs)
                    for k, vs in sorted(overrides.items()))


def candidates(fp: Fingerprint, *, machine: MachineModel = H100,
               warm: bool = True, params: DtansParams = PAPER,
               formats: tuple = None,
               batch: int = 1,
               n_shards: int = 1,
               knob_overrides: dict | None = None) -> list[Candidate]:
    """Enumerate candidate formats, cheapest modeled time first.

    Iterates the `repro_torch.sparse.registry` — a newly registered
    selectable format joins the sweep with no edit here. ``formats``
    defaults to every selectable registered family; ``batch`` prices a
    multi-RHS SpMM pass (decode and matrix bytes amortize over B);
    ``n_shards`` prices every point for a k-device sharded pass
    (`search.select(mesh=)` unions the sweep over shard counts);
    ``knob_overrides`` narrows/extends any knob domain by name.
    """
    if formats is None:
        # Dynamic, not the module constant: formats registered after
        # import (e.g. in tests) must join the sweep.
        formats = format_names(selectable=True)
    overrides = normalize_knob_overrides(knob_overrides)
    out: list[Candidate] = []
    for fmt in formats:
        spec = get_format(fmt)
        for knobs, nbytes, exact in spec.candidates(fp, overrides,
                                                    params=params):
            out.append(make_candidate(fp, fmt, knobs, nbytes, exact,
                                      warm=warm, machine=machine,
                                      batch=batch, n_shards=n_shards))
    out.sort(key=lambda cand: cand.modeled_time)
    return out
