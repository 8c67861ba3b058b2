"""Row-partition a sparse matrix into per-device shards along decode-
slice boundaries (the distributed analogue of the paper's independent
decode slices; a copy of the JAX package's ``repro.sparse.shard``).

Every format family in `repro_torch.sparse.registry` packs its matrix as
a sequence of independent row units — dtANS decode slices of
``lane_width`` rows, RGCSR groups of ``group_size`` rows, BCSR block
rows of ``r`` rows, SELL slices of ``slice_height`` rows (plain CSR /
COO / dense have unit 1).  A shard plan splits the ROW range at
multiples of that unit, so no decode slice / group / block row ever
straddles two shards and each shard's packed artifact is exactly what
the single-device kernel would build for that row block:

    shard k owns rows [boundaries[k], boundaries[k+1])

`FormatSpec.shard` (the registry seam) builds the plan: it slices the
CSR (`csr_row_block`), packs each row block through the family's own
`FormatSpec.pack`, and records exact per-shard byte counts via
`FormatSpec.nbytes_constructed` — the numbers the sharded cost terms
(`repro_torch.autotune.cost_model.candidate_time(n_shards=)`) price.

This module holds only the layout (plan dataclass + boundary/slicing
helpers). Running a plan across cards is not ported yet
(`FormatSpec.shard_runner` raises, ROADMAP.md A6).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.formats import CSR


def shard_boundaries(m: int, n_shards: int, unit: int = 1) -> tuple:
    """Row boundaries of a balanced ``n_shards``-way split of ``m`` rows,
    every boundary a multiple of ``unit`` (the format's decode-slice /
    group / block-row height) so no unit straddles two shards.

    Balances whole units, not raw rows: ``ceil(m / unit)`` units are
    spread as evenly as possible (first ``n_units % n_shards`` shards
    get one extra).  Shards past the unit count are empty (zero rows) —
    legal, they contribute zeros to the reduction.  Returns a tuple of
    ``n_shards + 1`` ints, ``boundaries[0] == 0``,
    ``boundaries[-1] == m``.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1; got {n_shards}")
    if unit < 1:
        raise ValueError(f"shard unit must be >= 1; got {unit}")
    n_units = -(-m // unit) if m else 0
    base, extra = divmod(n_units, n_shards)
    bounds = [0]
    for k in range(n_shards):
        units_k = base + (1 if k < extra else 0)
        bounds.append(min(bounds[-1] + units_k * unit, m))
    bounds[-1] = m
    return tuple(bounds)


def csr_row_block(a: CSR, r0: int, r1: int) -> CSR:
    """The CSR sub-matrix of rows ``[r0, r1)`` (all columns kept — the
    shard contracts against the full broadcast x)."""
    if not (0 <= r0 <= r1 <= a.shape[0]):
        raise ValueError(f"row block [{r0}, {r1}) out of range for "
                         f"{a.shape[0]} rows")
    lo, hi = int(a.indptr[r0]), int(a.indptr[r1])
    return CSR(indptr=np.asarray(a.indptr[r0:r1 + 1]) - lo,
               indices=a.indices[lo:hi],
               values=a.values[lo:hi],
               shape=(r1 - r0, a.shape[1]))


@dataclasses.dataclass
class ShardPlan:
    """One format's row partition of one matrix across ``n_shards``
    devices: per-shard packed artifacts plus exact per-shard sizes.

    Built by `repro_torch.sparse.registry.FormatSpec.shard` (running it
    waits on ROADMAP.md A6).  ``shards[k]``
    is the family's `pack` product for rows
    ``[boundaries[k], boundaries[k+1])``; empty shards hold the pack of
    a zero-row matrix and contribute zeros.
    """

    fmt: str                 # registered format family
    knobs: tuple             # ((name, value), ...) configuration
    n_shards: int
    unit: int                # row alignment (decode-slice height)
    boundaries: tuple        # (n_shards + 1,) row offsets
    shards: tuple            # per-shard packed artifacts
    shard_nbytes: tuple      # exact per-shard format bytes
    shape: tuple             # (m, n) of the WHOLE matrix
    dtype: object            # value dtype

    def __post_init__(self):
        if len(self.boundaries) != self.n_shards + 1:
            raise ValueError(
                f"{self.n_shards}-shard plan needs {self.n_shards + 1} "
                f"boundaries; got {len(self.boundaries)}")
        if len(self.shards) != self.n_shards:
            raise ValueError(f"plan holds {len(self.shards)} shard "
                             f"artifacts for n_shards={self.n_shards}")

    @property
    def shard_rows(self) -> tuple:
        """Rows owned by each shard."""
        return tuple(self.boundaries[k + 1] - self.boundaries[k]
                     for k in range(self.n_shards))

    @property
    def total_nbytes(self) -> int:
        """Sum of the exact per-shard sizes (>= the unsharded artifact's
        size for the entropy formats: each shard carries its own coding
        tables — the fixed cost `candidate_time(n_shards=)` sees through
        the per-shard byte counts)."""
        return int(sum(self.shard_nbytes))

    @property
    def max_shard_nbytes(self) -> int:
        """Largest single shard — the per-device HBM the plan needs."""
        return int(max(self.shard_nbytes)) if self.shard_nbytes else 0

    def knobs_dict(self) -> dict:
        return dict(self.knobs)
