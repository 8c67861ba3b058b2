"""Sparse matrix formats: COO, CSR, SELL (paper Section III-A).

These are the cuSPARSE-equivalent baselines the paper compares against, with
byte-exact size accounting (32-bit indices, 32/64-bit values) used in
`SparseLinear.compression_vs_best_sparse` (paper Fig. 6 / Table I).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSR:
    """Compressed sparse row (Fig. 2 of the paper)."""
    indptr: np.ndarray    # (m+1,) int64 (stored as 32-bit for sizing)
    indices: np.ndarray   # (nnz,) int64 (stored as 32-bit for sizing)
    values: np.ndarray    # (nnz,) float32/float64
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.values.size)

    @property
    def nbytes(self) -> int:
        vb = self.values.dtype.itemsize
        return self.nnz * (4 + vb) + (self.shape[0] + 1) * 4

    def to_dense(self) -> np.ndarray:
        m, n = self.shape
        out = np.zeros((m, n), dtype=self.values.dtype)
        for i in range(m):
            s, e = self.indptr[i], self.indptr[i + 1]
            out[i, self.indices[s:e]] += self.values[s:e]
        return out

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    @classmethod
    def from_dense(cls, a: np.ndarray) -> "CSR":
        m, n = a.shape
        mask = a != 0
        indptr = np.zeros(m + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(mask.sum(axis=1))
        cols = np.nonzero(mask)[1]
        vals = a[mask]
        return cls(indptr=indptr, indices=cols.astype(np.int64),
                   values=vals, shape=(m, n))

    @classmethod
    def from_coo(cls, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 shape: tuple[int, int], sum_duplicates: bool = True) -> "CSR":
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and rows.size:
            key_same = np.zeros(rows.size, dtype=bool)
            key_same[1:] = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
            if key_same.any():
                group = np.cumsum(~key_same) - 1
                nv = np.zeros(group[-1] + 1, dtype=vals.dtype)
                np.add.at(nv, group, vals)
                keep = ~key_same
                rows, cols, vals = rows[keep], cols[keep], nv
        m = shape[0]
        indptr = np.zeros(m + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(indptr=indptr, indices=cols.astype(np.int64),
                   values=vals, shape=shape)


@dataclasses.dataclass
class COO:
    rows: np.ndarray
    cols: np.ndarray
    values: np.ndarray
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.values.size)

    @property
    def nbytes(self) -> int:
        return self.nnz * (8 + self.values.dtype.itemsize)

    @classmethod
    def from_csr(cls, a: CSR) -> "COO":
        rows = np.repeat(np.arange(a.shape[0], dtype=np.int64),
                         np.diff(a.indptr))
        return cls(rows=rows, cols=a.indices.copy(), values=a.values.copy(),
                   shape=a.shape)


@dataclasses.dataclass
class SELL:
    """Sliced ELLPACK, slice height C (paper: GPU-friendly SIMD format).

    Rows in a slice are padded to the slice's max nnz; values/indices stored
    column-major per slice. Size: one offset per slice + one index per
    stored (incl. padded) entry.
    """
    slice_height: int
    slice_offsets: np.ndarray   # (nslices+1,) into packed arrays
    indices: np.ndarray         # packed, padded, column-major per slice
    values: np.ndarray
    shape: tuple[int, int]

    @property
    def nbytes(self) -> int:
        vb = self.values.dtype.itemsize
        return (self.indices.size * (4 + vb)
                + (self.slice_offsets.size) * 4)

    @classmethod
    def from_csr(cls, a: CSR, slice_height: int = 32) -> "SELL":
        m, _ = a.shape
        C = slice_height
        nsl = (m + C - 1) // C
        rnnz = np.diff(a.indptr)
        idx_chunks, val_chunks = [], []
        offsets = np.zeros(nsl + 1, dtype=np.int64)
        for s in range(nsl):
            r0, r1 = s * C, min((s + 1) * C, m)
            w = int(rnnz[r0:r1].max()) if r1 > r0 else 0
            rows = r1 - r0
            ind = np.zeros((C, w), dtype=np.int64)
            val = np.zeros((C, w), dtype=a.values.dtype)
            for i in range(rows):
                lo, hi = a.indptr[r0 + i], a.indptr[r0 + i + 1]
                ind[i, :hi - lo] = a.indices[lo:hi]
                val[i, :hi - lo] = a.values[lo:hi]
            # column-major within the slice
            idx_chunks.append(ind.T.ravel())
            val_chunks.append(val.T.ravel())
            offsets[s + 1] = offsets[s] + C * w
        return cls(
            slice_height=C,
            slice_offsets=offsets,
            indices=(np.concatenate(idx_chunks) if idx_chunks
                     else np.zeros(0, dtype=np.int64)),
            values=(np.concatenate(val_chunks) if val_chunks
                    else np.zeros(0, dtype=a.values.dtype)),
            shape=a.shape,
        )


def best_baseline_nbytes(a: CSR) -> tuple[str, int]:
    """Smallest of CSR/COO/SELL — the paper's compression baseline.

    RGCSR (`repro_torch.sparse.rgcsr`) is deliberately NOT part of this
    baseline: the paper compares against the cuSPARSE formats, and the
    Fig. 6 / Table I reproductions must keep that denominator. Use
    `all_format_nbytes` for the full byte-exact table.
    """
    sizes = {
        "csr": a.nbytes,
        "coo": COO.from_csr(a).nbytes,
        "sell": SELL.from_csr(a).nbytes,
    }
    name = min(sizes, key=sizes.get)
    return name, sizes[name]

