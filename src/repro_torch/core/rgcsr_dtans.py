"""RGCSR-dtANS: row-grouped CSR with dtANS entropy coding.

The entropy pipeline is exactly `repro_torch.core.csr_dtans.encode_matrix`
— per-row column-delta + value symbol streams, dtANS coding, consumption-
order interleaving — but the interleave width equals the row-group size
G, so every decode slice IS one row group: slice boundaries and group
boundaries coincide, a decode block never straddles a group, and a
slice's stream length tracks its own longest row instead of the longest
row among ``lane_width`` neighbours (the skew behaviour row-grouped CSR
formats exist for; see `repro_torch.sparse.rgcsr` for the two source
papers).

What changes vs `CSRdtANS` is only the *metadata accounting*:

* per-row lengths are group-local (a row's nnz, bounded by its group's
  total), stored in 16-bit entries whenever no row reaches 2**16
  nonzeros — 2 bytes/row instead of CSR-dtANS's 4;
* per-slice stream/escape offsets are per *group*, so there are
  ``ceil(m/G)`` of them instead of ``ceil(m/128)`` — the small-G
  overhead an autotuner trades against skew localization.

Because `RGCSRdtANS` IS a `CSRdtANS` (same streams, tables and slice
layout), the whole downstream stack — `decode_matrix`, `spmv_gold`,
`kernels.pack.pack_matrix`, `ops.spmv` / `ops.spmm` and both dtANS CUDA
kernels — runs on it unchanged; group alignment is a property of how it
was encoded.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.csr_dtans import CSRdtANS, encode_matrix
from repro_torch.core.params import PAPER, DtansParams
from repro_torch.sparse.formats import CSR
from repro_torch.sparse.rgcsr import local_indptr_bytes


@dataclasses.dataclass
class RGCSRdtANS(CSRdtANS):
    """Group-aligned CSR-dtANS (one interleave slice per row group)."""

    group_size: int = 32

    @property
    def n_groups(self) -> int:
        return self.n_slices

    @property
    def row_len_bytes(self) -> int:
        """Bytes per stored group-local row length (16-bit when no row
        has 2**16+ nonzeros, else 32-bit)."""
        mx = int(self.row_nnz.max()) if self.row_nnz.size else 0
        return local_indptr_bytes(mx)

    @property
    def nbytes(self) -> int:
        """Byte-exact size: CSR-dtANS accounting with group-local row
        lengths (2 B/row in the common case) and per-group offsets."""
        vb = self.dtype.itemsize
        b = sum(t.nbytes(vb) for t in self.tables)
        b += int(self.stream.size) * 4
        b += int(self.esc_count_by_domain[0]) * 4          # delta escapes
        b += int(self.esc_count_by_domain[1]) * vb         # value escapes
        b += self.shape[0] * self.row_len_bytes            # local row n
        b += (self.n_groups + 1) * 8                       # stream offsets
        b += (self.n_groups + 1) * 4 * len(self.tables)    # escape offsets
        return b


def encode_rgcsr_matrix(a: CSR, group_size: int = 32,
                        params: DtansParams = PAPER,
                        shared_table: bool = True) -> RGCSRdtANS:
    """Compress a CSR matrix into RGCSR-dtANS (slice width == G)."""
    base = encode_matrix(a, params=params, lane_width=group_size,
                         shared_table=shared_table)
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(CSRdtANS)}
    return RGCSRdtANS(group_size=group_size, **fields)
