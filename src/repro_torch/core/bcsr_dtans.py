"""BCSR-dtANS: blocked CSR index layout under dtANS entropy coding.

The entropy pipeline is exactly `repro_torch.core.csr_dtans.encode_matrix`
on the *block-filled* matrix (`repro_torch.sparse.bcsr.block_fill_csr`):
every nonempty r x c block's in-bounds cells become explicit entries, so
within a block the per-row column deltas degenerate to runs of 1 and
the fill-in zeros collapse onto a single value symbol — both nearly
free under the coding table. The interleave width equals the block
height r, so every decode slice IS one block row: slice boundaries and
block-row boundaries coincide, exactly as `RGCSRdtANS` aligns slices
with row groups.

What changes vs `CSRdtANS` is only the *metadata accounting*: all rows
of a block row store the same length (c cells per block), so per-row
4-byte lengths are replaced by one 16-bit block count per block row.
Because `BCSRdtANS` IS a `CSRdtANS` (same streams, tables and slice
layout), the whole downstream stack — `decode_matrix`, `spmv_gold`,
`kernels.pack.pack_matrix`, `ops.spmv` / `ops.spmm` and the dtANS CUDA
kernels — runs on it unchanged; `decode_matrix` reconstructs the
block-filled matrix, whose SpMV equals the original's (fill-in cells are
zero). Every in-bounds lane of a slice decodes the same column sequence,
so `pack_matrix` marks the pack ``shared_cols`` and the ops run the
fused contraction, which gathers x once per decoded cell from lane 0's
columns.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.csr_dtans import CSRdtANS, encode_matrix
from repro_torch.core.params import PAPER, DtansParams
from repro_torch.sparse.bcsr import block_fill_csr, count_nonempty_blocks
from repro_torch.sparse.formats import CSR
from repro_torch.sparse.rgcsr import local_indptr_bytes


@dataclasses.dataclass
class BCSRdtANS(CSRdtANS):
    """Block-aligned CSR-dtANS (one interleave slice per block row)."""

    block_shape: tuple = (4, 4)
    n_blocks: int = 0

    @property
    def n_block_rows(self) -> int:
        return self.n_slices

    @property
    def block_count_bytes(self) -> int:
        """Bytes per stored per-block-row block count (16-bit unless a
        block row holds 2**16 or more blocks)."""
        c = self.block_shape[1]
        mx = int(self.row_nnz.max()) if self.row_nnz.size else 0
        return local_indptr_bytes(-(-mx // c))

    @property
    def nbytes(self) -> int:
        """Byte-exact size: CSR-dtANS accounting with the per-row
        4-byte lengths replaced by one block count per block row."""
        base = CSRdtANS.nbytes.fget(self)
        return (base - self.shape[0] * 4
                + self.n_block_rows * self.block_count_bytes)


def encode_bcsr_matrix(a: CSR, block_shape: tuple = (4, 4),
                       params: DtansParams = PAPER,
                       shared_table: bool = True) -> BCSRdtANS:
    """Compress a CSR matrix into BCSR-dtANS (slice width == r)."""
    r, c = block_shape
    filled = block_fill_csr(a, block_shape)
    n_blocks = count_nonempty_blocks(a.indptr, a.indices, a.shape,
                                     block_shape)
    base = encode_matrix(filled, params=params, lane_width=r,
                         shared_table=shared_table)
    fields = {f.name: getattr(base, f.name)
              for f in dataclasses.fields(CSRdtANS)}
    return BCSRdtANS(block_shape=(r, c), n_blocks=n_blocks, **fields)
