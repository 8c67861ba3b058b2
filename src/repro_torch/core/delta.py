"""Delta-encoding of CSR column indices (paper Section IV-A).

Rows are delta-encoded separately: within a row with ascending column
indices c_0 < c_1 < ... the stored symbols are
    d_0 = c_0,   d_i = c_i - c_{i-1}  (i >= 1).
This typically collapses structured sparsity (diagonals, blocks, stencils,
random-graph adjacency) onto a low-entropy distribution of small deltas
(Fig. 4 of the paper).
"""

from __future__ import annotations

import numpy as np


def delta_encode_rows(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """CSR column indices -> per-row deltas (same layout as ``indices``)."""
    indices = np.asarray(indices, dtype=np.int64)
    deltas = np.empty_like(indices)
    deltas[1:] = indices[1:] - indices[:-1]
    deltas[indptr[:-1][np.diff(indptr) > 0]] = \
        indices[indptr[:-1][np.diff(indptr) > 0]]
    return deltas


def delta_decode_rows(indptr: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    """Inverse of :func:`delta_encode_rows`."""
    deltas = np.asarray(deltas, dtype=np.int64)
    out = np.cumsum(deltas)
    # subtract the running total at each row start to restart the cumsum
    starts = indptr[:-1][np.diff(indptr) > 0]
    carry = np.zeros_like(deltas)
    carry[starts] = out[starts] - deltas[starts]
    carry = np.maximum.accumulate(carry)
    return out - carry
