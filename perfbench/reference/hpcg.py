"""HPCG's problem: the 27-point operator on an nx x ny x nz grid.

As HPCG's reference code builds it (``GenerateProblem``): row
``i = ix + nx * (iy + ny * iz)``, a column for every neighbour
``(iz + sz, iy + sy, ix + sx)``, sz, sy, sx in -1, 0, 1 in that order and
inside the grid, 26 on the diagonal and -1 elsewhere. Rows on the boundary
keep only their neighbours inside the grid, so the matrix is symmetric
positive definite. Vectorised: 27 offsets at a time, never a row at a time.
"""

from __future__ import annotations

import numpy as np


def stencil27(nx: int, ny: int, nz: int, dtype=np.float64,
              diagonal: float = 26.0, off_diagonal: float = -1.0):
    """``(indptr, indices, values, n)`` of the operator, in CSR with the
    columns of each row ascending."""
    n = nx * ny * nz
    iz, iy, ix = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    row = np.arange(n, dtype=np.int64)
    cols, valid = [], []
    for sz in (-1, 0, 1):
        for sy in (-1, 0, 1):
            for sx in (-1, 0, 1):
                valid.append((ix + sx >= 0) & (ix + sx < nx)
                             & (iy + sy >= 0) & (iy + sy < ny)
                             & (iz + sz >= 0) & (iz + sz < nz))
                cols.append(row + (sz * ny + sy) * nx + sx)
    cols, valid = np.stack(cols, axis=1), np.stack(valid, axis=1)
    values = np.where(cols == row[:, None], diagonal, off_diagonal)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(valid.sum(axis=1), out=indptr[1:])
    return indptr, cols[valid], values[valid].astype(dtype), n
