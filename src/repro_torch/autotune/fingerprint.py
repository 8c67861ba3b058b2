"""Cheap sparsity-structure fingerprints for format selection.

A fingerprint is a small, hashable summary of a CSR matrix: shape/nnz
statistics, structural features (bandwidth, SELL padding), and
entropy-based compressibility estimates for the delta and value symbol
domains (paper Section IV-A: delta-encoding collapses structured column
indices onto a low-entropy distribution; Fig. 9 motivates picking a
format *per matrix* without AlphaSparse-scale tuning cost).

Everything here is O(nnz) or better, deterministic (strided subsampling,
no RNG), and orders of magnitude cheaper than actually encoding the
matrix — the point is that `autotune.select` can run per matrix at
serving time.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from repro_torch.core.delta import delta_encode_rows
from repro_torch.core.entropy import entropy_bits
from repro_torch.core.params import PAPER, DtansParams
from repro_torch.sparse.rgcsr import (  # noqa: F401 (re-export)
    RGCSR_GROUP_SIZES, max_group_nnz)

#: Max symbols per domain used for the entropy estimates. Strided (not
#: random) subsampling keeps fingerprints deterministic.
SAMPLE_CAP = 1 << 16

#: Slice height used for the exact SELL padding feature (matches
#: `repro_torch.sparse.formats.SELL.from_csr`'s default).
SELL_SLICE_HEIGHT = 32


def lockstep_elems(row_nnz: np.ndarray, width: int) -> int:
    """Elements processed by a ``width``-row lock-step SpMV kernel.

    Each slice of ``width`` consecutive rows runs to its longest row, so
    the kernel touches ``width * max(row_nnz in slice)`` element slots —
    SELL's padded storage count, but as *compute* (formats like RGCSR and
    CSR-dtANS store compactly yet still decode in lock-step). Equals
    `SELL.from_csr(a, width).indices.size`.
    """
    row_nnz = np.asarray(row_nnz, dtype=np.int64)
    m = int(row_nnz.size)
    if m == 0:
        return 0
    nsl = (m + width - 1) // width
    padded = np.zeros(nsl * width, dtype=np.int64)
    padded[:m] = row_nnz
    return int(padded.reshape(nsl, width).max(axis=1).sum() * width)


# (max_group_nnz is defined in `repro_torch.sparse.rgcsr` next to the
# format accounting it feeds, and re-exported here for the fingerprint
# API.)


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """Structure features of one sparse matrix (all deterministic)."""

    rows: int
    cols: int
    nnz: int
    value_bytes: int            # itemsize of the value dtype
    row_nnz_mean: float
    row_nnz_cv: float           # coefficient of variation (std/mean)
    row_nnz_max: int
    bandwidth: int              # max |col - row| over nonzeros
    sell_padded_nnz: int        # exact stored entries of SELL (slice 32)
    segment_pad_symbols: int    # per-row padding to l-symbol segments
    n_segments: int             # total l-symbol segments over all rows
    nonempty_rows: int
    delta_entropy_bits: float   # empirical H of sampled column deltas
    value_entropy_bits: float   # empirical H of sampled value bit patterns
    distinct_deltas: int        # within the sample
    distinct_values: int        # within the sample
    content_checksum: int       # cheap hash of sampled symbol content
    # Escape-aware achievable bits/symbol under a (K, M)-constrained dtANS
    # table (stream bits only; escape raw bits are accounted separately):
    delta_stream_bits: float
    value_stream_bits: float
    merged_stream_bits: float   # shared delta+value table (paper default)
    delta_escape_frac: float
    value_escape_frac: float
    # Run-length-encoded row-nnz sequence — the row-nnz histogram in
    # its exact, order-preserving form, packed as the raw bytes of an
    # int64 (2, n_runs) array ``[values; run_lengths]`` (bytes, not a
    # tuple-of-tuples: irregular matrices degenerate to one run per
    # row, and a 400k-row matrix must not pay seconds building Python
    # ints or JSON-serializing them into the cache key — `key` hashes
    # a digest of this blob instead). Every lock-step / group-size
    # feature derives from it for *arbitrary* widths (no optimistic
    # fallback), at O(rows) per width, memoized.
    row_nnz_rle: bytes = b""

    def _derived(self) -> dict:
        """Per-instance memo for O(rows) derived features (not a
        dataclass field: excluded from equality and `key`)."""
        cache = self.__dict__.get("_derived_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_derived_cache", cache)
        return cache

    def row_nnz(self) -> np.ndarray:
        """The exact row-nnz sequence, expanded from the RLE."""
        cache = self._derived()
        if "row_nnz" not in cache:
            if self.row_nnz_rle:
                vals, runs = np.frombuffer(self.row_nnz_rle,
                                           dtype=np.int64).reshape(2, -1)
                cache["row_nnz"] = np.repeat(vals, runs)
            else:
                cache["row_nnz"] = np.zeros(0, dtype=np.int64)
        return cache["row_nnz"]

    def lockstep(self, width: int) -> int:
        """Exact lock-step work elements for ``width``-row slices, any
        width (each slice of ``width`` consecutive rows runs to its
        longest row). A hand-built Fingerprint without the RLE degrades
        to the conservative ``nnz`` instead of a silent 0 (which would
        make every lock-step format look free)."""
        if not self.row_nnz_rle and self.nnz:
            return self.nnz
        cache = self._derived()
        key = ("lockstep", int(width))
        if key not in cache:
            cache[key] = lockstep_elems(self.row_nnz(), int(width))
        return cache[key]

    def group_max_nnz(self, group_size: int) -> int:
        """Exact largest group-total nnz for any group size (decides
        RGCSR's 16- vs 32-bit local indptr width); conservative ``nnz``
        for a hand-built Fingerprint without the RLE."""
        if not self.row_nnz_rle and self.nnz:
            return self.nnz
        cache = self._derived()
        key = ("group_max", int(group_size))
        if key not in cache:
            cache[key] = max_group_nnz(self.row_nnz(), int(group_size))
        return cache[key]

    def block_nonempty(self, block_shape: tuple) -> int | None:
        """Exact nonempty r x c block count for ANY block shape — the
        block-fill histogram behind the exact BCSR byte counts.

        Computed lazily from the CSR structure `fingerprint` stashes on
        the instance (an O(nnz log nnz) np.unique per shape is too
        expensive to pay eagerly for sweeps that never consider a
        blocked format) and memoized per shape. None only for
        hand-built Fingerprints without stashed structure (callers
        fall back to a conservative one-block-per-nonzero estimate)."""
        st = self.__dict__.get("_structure")
        if st is None:
            return None
        cache = self._derived()
        key = ("blocks", tuple(block_shape))
        if key not in cache:
            from repro_torch.sparse.bcsr import count_nonempty_blocks
            indptr, indices, shape = st
            cache[key] = count_nonempty_blocks(indptr, indices, shape,
                                               tuple(block_shape))
        return cache[key]

    def key(self) -> str:
        """Stable content hash — the on-disk decision-cache key.

        The packed row-nnz RLE enters as a sha1 digest, not its (up to
        O(rows)) contents, so key() stays sub-millisecond on matrices
        with hundreds of thousands of irregular rows."""
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, float):
                d[k] = round(v, 6)
        d["row_nnz_rle"] = hashlib.sha1(self.row_nnz_rle).hexdigest()
        blob = json.dumps(d, sort_keys=True).encode()
        return hashlib.sha1(blob).hexdigest()[:16]


def _pack_rle(row_nnz: np.ndarray) -> bytes:
    """Run-length-encode a row-nnz sequence into the packed int64
    ``[values; run_lengths]`` bytes of `Fingerprint.row_nnz_rle`
    (vectorized — no per-row Python objects)."""
    row_nnz = np.asarray(row_nnz, dtype=np.int64)
    if row_nnz.size == 0:
        return b""
    change = np.flatnonzero(np.diff(row_nnz)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [row_nnz.size]])
    return np.ascontiguousarray(
        np.vstack([row_nnz[starts], ends - starts])).tobytes()


def _sample(arr: np.ndarray, cap: int) -> np.ndarray:
    """Deterministic strided subsample of at most ``cap`` elements."""
    if arr.size <= cap:
        return arr
    idx = np.linspace(0, arr.size - 1, cap).astype(np.int64)
    return arr[idx]


def _value_bit_patterns(values: np.ndarray) -> np.ndarray:
    """Values -> uint64 bit patterns (the dtANS value-domain symbols)."""
    dt = values.dtype
    if dt == np.float64:
        return values.view(np.uint64)
    if dt == np.float32:
        return values.view(np.uint32).astype(np.uint64)
    # Fallback for integer matrices: the raw values are the symbols.
    return values.astype(np.uint64, casting="unsafe")


def codeable_bits(counts: np.ndarray, params: DtansParams = PAPER,
                  esc_raw_bits: int = 32) -> tuple[float, float]:
    """Estimate (stream bits/symbol, escape fraction) of a dtANS table.

    Vectorized approximation of `repro_torch.core.tables.build_table`'s
    greedy allocation: the most frequent symbols get in-table multiplicities
    proportional to their counts (capped at M, at least 1); everything
    else escapes through a shared ESC symbol. A symbol also escapes when
    its in-table cost exceeds its escape cost (digit bits + raw bits) —
    the same eviction rule build_table applies.

    Returned stream bits *exclude* the ``esc_raw_bits`` raw payload of
    escaped symbols (those bytes live in the separate escape stream, as
    in `CSRdtANS.nbytes` accounting); the escape fraction lets the cost
    model charge them.
    """
    c = np.asarray(counts, dtype=np.float64)
    c = np.sort(c[c > 0])[::-1]
    total = c.sum()
    if total == 0:
        return 0.0, 0.0
    K, M = params.K, params.M
    n_in = min(c.size, K - 1)
    in_c, tail = c[:n_in], c[n_in:].sum()

    mult = np.clip(np.floor(K * in_c / total), 1, M)
    budget = K - (1 if (tail > 0 or c.size > n_in) else 0)
    if mult.sum() > budget:
        scale = budget / mult.sum()
        mult = np.maximum(1.0, np.floor(mult * scale))
    esc_mult = max(1.0, K - mult.sum())

    keep_bits = -np.log2(mult / K)
    esc_digit_bits = -np.log2(esc_mult / K)
    evict = keep_bits > esc_digit_bits + esc_raw_bits
    esc_count = tail + in_c[evict].sum()
    stream_bits = ((in_c[~evict] * keep_bits[~evict]).sum()
                   + esc_count * esc_digit_bits)
    return float(stream_bits / total), float(esc_count / total)


def fingerprint(a, params: DtansParams = PAPER,
                sample_cap: int = SAMPLE_CAP) -> Fingerprint:
    """Fingerprint a `repro_torch.sparse.formats.CSR` matrix."""
    m, n = a.shape
    indptr = np.asarray(a.indptr, dtype=np.int64)
    indices = np.asarray(a.indices, dtype=np.int64)
    row_nnz = np.diff(indptr)
    nnz = int(row_nnz.sum())
    vb = int(a.values.dtype.itemsize)
    value_bits = vb * 8
    esc_raw_value = max(32, value_bits)

    if nnz == 0:
        fp0 = Fingerprint(
            rows=m, cols=n, nnz=0, value_bytes=vb, row_nnz_mean=0.0,
            row_nnz_cv=0.0, row_nnz_max=0, bandwidth=0, sell_padded_nnz=0,
            segment_pad_symbols=0, n_segments=0, nonempty_rows=0,
            delta_entropy_bits=0.0, value_entropy_bits=0.0,
            distinct_deltas=0, distinct_values=0, content_checksum=0,
            delta_stream_bits=0.0,
            value_stream_bits=0.0, merged_stream_bits=0.0,
            delta_escape_frac=0.0, value_escape_frac=0.0,
            row_nnz_rle=_pack_rle(np.zeros(m, dtype=np.int64)))
        object.__setattr__(fp0, "_structure", (indptr, indices, (m, n)))
        return fp0

    mean = float(row_nnz.mean())
    cv = float(row_nnz.std() / mean) if mean > 0 else 0.0

    row_of = np.repeat(np.arange(m, dtype=np.int64), row_nnz)
    bandwidth = int(np.abs(indices - row_of).max())

    # SELL's padding feature is `Fingerprint.lockstep` evaluated at
    # SELL_SLICE_HEIGHT; arbitrary widths derive exactly from the
    # row-nnz RLE below (no fallback).
    sell_padded = lockstep_elems(row_nnz, SELL_SLICE_HEIGHT)
    rle = _pack_rle(row_nnz)

    ell = params.l
    syms_per_row = 2 * row_nnz
    seg_pad = int((-syms_per_row % ell)[row_nnz > 0].sum())
    n_segments = int(((syms_per_row + ell - 1) // ell).sum())
    nonempty_rows = int((row_nnz > 0).sum())

    deltas = _sample(delta_encode_rows(indptr, indices).astype(np.uint64),
                     sample_cap)
    vbits = _sample(_value_bit_patterns(np.ascontiguousarray(a.values)),
                    sample_cap)
    _, dcounts = np.unique(deltas, return_counts=True)
    _, vcounts = np.unique(vbits, return_counts=True)
    # Distribution features alone cannot tell e.g. values {4,-1} from
    # {8,-2}; a content checksum keeps cache keys discriminating.
    mix = np.uint64(0x9E3779B97F4A7C15)
    checksum = int((deltas * mix + np.uint64(1)).sum()
                   ^ (vbits * mix + np.uint64(3)).sum())

    d_bits, d_esc = codeable_bits(dcounts, params, esc_raw_bits=32)
    v_bits, v_esc = codeable_bits(vcounts, params,
                                  esc_raw_bits=esc_raw_value)
    # Shared-table mode merges both domains into one distribution. The
    # sample halves are equal-weight, matching the 1:1 (delta, value)
    # interleave of `encode_matrix`.
    _, mcounts = np.unique(np.concatenate([deltas, vbits]),
                           return_counts=True)
    m_bits, _ = codeable_bits(mcounts, params, esc_raw_bits=esc_raw_value)

    fp = Fingerprint(
        rows=m, cols=n, nnz=nnz, value_bytes=vb,
        row_nnz_mean=mean, row_nnz_cv=cv, row_nnz_max=int(row_nnz.max()),
        bandwidth=bandwidth, sell_padded_nnz=sell_padded,
        segment_pad_symbols=seg_pad, n_segments=n_segments,
        nonempty_rows=nonempty_rows,
        delta_entropy_bits=entropy_bits(dcounts),
        value_entropy_bits=entropy_bits(vcounts),
        distinct_deltas=int(dcounts.size),
        distinct_values=int(vcounts.size),
        content_checksum=checksum,
        delta_stream_bits=d_bits, value_stream_bits=v_bits,
        merged_stream_bits=m_bits,
        delta_escape_frac=d_esc, value_escape_frac=v_esc,
        row_nnz_rle=rle,
    )
    # Stash the CSR structure for lazy derived features that are too
    # expensive to compute eagerly (`block_nonempty`). Not a field:
    # excluded from equality and `key` (it is pure input content, which
    # checksum + RLE + the other features already fingerprint).
    object.__setattr__(fp, "_structure", (indptr, indices, (m, n)))
    return fp
