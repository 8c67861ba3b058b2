"""Blocked CSR (BCSR): CSR over dense r x c blocks.

The matrix is tiled into ``r x c`` blocks; every block containing at
least one nonzero is stored *densely* (all ``r * c`` cells, explicit
zeros included), addressed by one 32-bit block-column index per block
and a CSR-style pointer per block row. Per-element column indices
disappear entirely — the whole point of the format: on matrices whose
nonzeros cluster into tiles (FEM stencils, multi-DOF meshes, pruned NN
weights with structured masks) the index overhead drops from 4 bytes
per nonzero to ``4 / (r * c * fill)`` bytes, and the kernel processes
fully dense tiles in lock-step with zero per-element control flow.

The layout follows the blocked formats the SMASH line (Kanellopoulos et
al.) and AlphaSparse's operator zoo both draw on; the trade it makes is
*fill-in*: a block with one nonzero still stores (and processes) all
``r * c`` cells, so the format only wins when the block-fill histogram
says the matrix is block-structured — exactly the per-matrix question
the autotuner (`repro_torch.autotune`) answers from
`Fingerprint.block_nonempty`.

Byte-exact accounting (`nbytes`, mirrored fingerprint-side by
`bcsr_nbytes_exact`): 32-bit block-column indices, 32-bit block-row
pointers, ``r * c`` values per stored block.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.formats import CSR

#: Block shapes swept by the autotuner (`repro_torch.autotune`); the
#: fingerprint carries an exact nonempty-block count for each.  The
#: rectangular entries cover banded/row-run structure (wide blocks pay
#: less row metadata per stored cell; tall blocks align more rows per
#: block row) — the format and fingerprint support any r x c, this
#: tuple is only the default sweep.
BCSR_BLOCK_SHAPES = ((2, 2), (4, 4), (8, 8), (2, 4), (4, 2))


def count_nonempty_blocks(indptr: np.ndarray, indices: np.ndarray,
                          shape: tuple, block_shape: tuple,
                          row_of: np.ndarray | None = None) -> int:
    """Number of nonempty ``r x c`` blocks of a CSR pattern (O(nnz)).

    Shared by `BCSR.from_csr`, the format accounting below and
    `repro_torch.autotune.fingerprint`, so the selector's 'exact'
    sizes can never drift from the format's own. ``row_of`` optionally passes a
    precomputed per-nonzero row-id expansion (callers evaluating
    several block shapes avoid re-deriving it per shape).
    """
    r, c = block_shape
    m, n = shape
    indptr = np.asarray(indptr, dtype=np.int64)
    nnz = int(indptr[-1])
    if nnz == 0:
        return 0
    if row_of is None:
        row_of = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    nbc = (n + c - 1) // c
    block_id = (row_of // r) * nbc + np.asarray(indices, np.int64) // c
    return int(np.unique(block_id).size)


def bcsr_nbytes_exact(n_blocks: int, rows: int, block_shape: tuple,
                      value_bytes: int) -> int:
    """`BCSR.nbytes` from the nonempty-block count alone."""
    r, c = block_shape
    nbr = (rows + r - 1) // r
    return n_blocks * (4 + r * c * value_bytes) + (nbr + 1) * 4


@dataclasses.dataclass
class BCSR:
    """Blocked CSR with dense ``r x c`` blocks."""

    block_shape: tuple         # (r, c)
    block_ptr: np.ndarray      # (n_block_rows + 1,) absolute block offsets
    block_cols: np.ndarray     # (n_blocks,) block-column indices
    values: np.ndarray         # (n_blocks, r, c), explicit zeros included
    shape: tuple[int, int]

    @property
    def n_blocks(self) -> int:
        return int(self.block_cols.size)

    @property
    def n_block_rows(self) -> int:
        return int(self.block_ptr.size - 1)

    @property
    def nnz_stored(self) -> int:
        """Stored cells, fill-in included (the kernel's work count)."""
        r, c = self.block_shape
        return self.n_blocks * r * c

    @property
    def nbytes(self) -> int:
        return bcsr_nbytes_exact(self.n_blocks, self.shape[0],
                                 self.block_shape,
                                 self.values.dtype.itemsize)

    @classmethod
    def from_csr(cls, a: CSR, block_shape: tuple = (4, 4)) -> "BCSR":
        r, c = block_shape
        if r < 1 or c < 1:
            raise ValueError(f"block dims must be >= 1, got {block_shape}")
        m, n = a.shape
        nbr = (m + r - 1) // r
        nbc = (n + c - 1) // c
        row_of = np.repeat(np.arange(m, dtype=np.int64), np.diff(a.indptr))
        cols = np.asarray(a.indices, dtype=np.int64)
        bid = (row_of // r) * nbc + cols // c
        blocks, inv = np.unique(bid, return_inverse=True)
        values = np.zeros((blocks.size, r, c), dtype=a.values.dtype)
        # scatter each nonzero into its block cell
        values[inv, row_of % r, cols % c] = a.values
        block_rows = blocks // nbc
        block_cols = blocks % nbc
        block_ptr = np.zeros(nbr + 1, dtype=np.int64)
        np.add.at(block_ptr, block_rows + 1, 1)
        block_ptr = np.cumsum(block_ptr)
        return cls(block_shape=(r, c), block_ptr=block_ptr,
                   block_cols=block_cols, values=values, shape=a.shape)

    def to_dense(self) -> np.ndarray:
        r, c = self.block_shape
        m, n = self.shape
        out = np.zeros((m, n), dtype=self.values.dtype)
        for br in range(self.n_block_rows):
            for k in range(int(self.block_ptr[br]),
                           int(self.block_ptr[br + 1])):
                bc = int(self.block_cols[k])
                r0, c0 = br * r, bc * c
                rr = min(r, m - r0)
                cc = min(c, n - c0)
                out[r0:r0 + rr, c0:c0 + cc] = self.values[k, :rr, :cc]
        return out

    def to_csr(self) -> CSR:
        """Back to CSR, dropping the fill-in zeros (lossless for
        matrices built by `from_csr`, which never stores an explicit
        zero value)."""
        return CSR.from_dense(self.to_dense())

    def spmv(self, x: np.ndarray, y: np.ndarray | None = None) -> np.ndarray:
        """Reference y = A x + y running the block layout directly."""
        r, c = self.block_shape
        m, n = self.shape
        out = (np.zeros(m, dtype=self.values.dtype) if y is None
               else y.astype(self.values.dtype).copy())
        for br in range(self.n_block_rows):
            acc = np.zeros(r, dtype=self.values.dtype)
            for k in range(int(self.block_ptr[br]),
                           int(self.block_ptr[br + 1])):
                c0 = int(self.block_cols[k]) * c
                cc = min(c, n - c0)
                acc += self.values[k, :, :cc] @ x[c0:c0 + cc]
            rr = min(r, m - br * r)
            out[br * r:br * r + rr] += acc[:rr]
        return out


def block_fill_csr(a: CSR, block_shape: tuple = (4, 4)) -> CSR:
    """CSR of ``a`` with every nonempty block's in-bounds cells made
    explicit (zeros stored). This is the index layout `BCSRdtANS`
    entropy-codes: within a block the column deltas degenerate to runs
    of 1 — near-zero entropy — which is how the blocked layout composes
    with the dtANS layer without any new kernel machinery.

    Vectorized (no per-block-row Python loop): this runs once per
    admitted block shape of every matrix the exhaustive oracle encodes,
    including real ``--mtx-dir`` inputs.
    """
    r, c = block_shape
    m, n = a.shape
    b = BCSR.from_csr(a, block_shape)
    if b.n_blocks == 0:
        return CSR(indptr=np.zeros(m + 1, dtype=np.int64),
                   indices=np.zeros(0, dtype=np.int64),
                   values=np.zeros(0, dtype=a.values.dtype),
                   shape=a.shape)
    # Per stored cell (block-major, row-in-block, col-in-block order):
    # its absolute column and row; drop out-of-bounds edge cells.
    brow_of = np.repeat(np.arange(b.n_block_rows, dtype=np.int64),
                        np.diff(b.block_ptr))          # (nblocks,)
    cell_cols = (b.block_cols[:, None] * c
                 + np.arange(c, dtype=np.int64)[None, :])  # (nblocks, c)
    rows_parts, cols_parts, vals_parts = [], [], []
    for i in range(r):          # <= 8 iterations, all-array bodies
        cell_rows = np.repeat(brow_of * r + i, c)
        ok = (cell_cols.reshape(-1) < n) & (cell_rows < m)
        rows_parts.append(cell_rows[ok])
        cols_parts.append(cell_cols.reshape(-1)[ok])
        vals_parts.append(b.values[:, i, :].reshape(-1)[ok])
    rows = np.concatenate(rows_parts)
    cols = np.concatenate(cols_parts)
    vals = np.concatenate(vals_parts)
    # Stable sort by row: within a row all cells come from one i-slice,
    # already in ascending block/column order.
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(m + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=m))
    return CSR(indptr=indptr, indices=cols[order], values=vals[order],
               shape=a.shape)
