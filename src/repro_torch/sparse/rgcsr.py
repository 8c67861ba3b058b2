"""Row-grouped CSR (RGCSR): CSR with rows partitioned into fixed groups.

Rows are partitioned into groups of ``group_size`` (G) consecutive rows.
Each group stores its rows' column indices as per-row *delta* streams
(same delta code as `repro_torch.core.delta`, the front half of the
CSR-dtANS pipeline) and a *group-local* indptr whose entries are offsets
relative to the group start. Because a group holds at most G rows, the local
offsets fit in 16-bit integers whenever no group exceeds 65535 stored
entries — halving CSR's per-row pointer cost — and a lock-step kernel
processing one group per program runs each group only to its own longest
row, so skewed row-length distributions do not pay SELL's global-slice
padding in *bytes* (only in per-group compute).

The layout follows two row-grouping formats from the literature:

* Oberhuber, Suzuki, Vacata, "New Row-grouped CSR format for storing
  the sparse matrices on GPU with implementation in CUDA" (2011):
  rows -> fixed groups, per-group offsets, one thread-group per group.
* Koza, Matyka, Szkoda, Miroslaw, "Compressed Multi-Row Storage Format
  for Sparse Matrices on Graphics Processing Units" (CMRS, 2012):
  group-local pointers narrow enough for fast on-chip arithmetic.

Field map onto the paper's Fig. 2 CSR notation (indptr / indices /
values): ``group_ptr[g]`` plays indptr's role at group granularity
(absolute offset of group g's first stored entry); ``local_indptr``
refines it to rows within the group (indptr[i] == group_ptr[i // G] +
local_indptr[i % G] for row i); ``delta_indices`` carries indices
delta-encoded per row (d_0 = c_0, d_k = c_k - c_{k-1}, Section IV-A);
``values`` is unchanged.

Byte-exact accounting (`nbytes`) mirrors `formats.CSR`: 32-bit column
deltas, 32/64-bit values, 32-bit group pointers, and 16- or 32-bit
group-local indptr entries (16 whenever every group's nnz < 2**16).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.delta import delta_decode_rows, delta_encode_rows
from repro_torch.sparse.formats import CSR

#: Group sizes swept by the JAX package's autotuner, paper-Fig. 9 style:
#: small groups localize row-length skew, large groups amortize
#: the per-group pointer overhead.
RGCSR_GROUP_SIZES = (4, 8, 16, 32)


def local_indptr_bytes(max_group_nnz: int) -> int:
    """Width of one group-local indptr entry: 2 bytes unless some group
    holds 2**16 or more stored entries."""
    return 2 if max_group_nnz < (1 << 16) else 4


def max_group_nnz(row_nnz: np.ndarray, group_size: int) -> int:
    """Largest total nnz in any group of ``group_size`` consecutive rows
    (decides the 16- vs 32-bit local indptr width). Shared by the format
    accounting below and the autotuner's fingerprint, so the selector's
    'exact' sizes cannot drift from the format's own."""
    row_nnz = np.asarray(row_nnz, dtype=np.int64)
    m = int(row_nnz.size)
    if m == 0:
        return 0
    ng = (m + group_size - 1) // group_size
    padded = np.zeros(ng * group_size, dtype=np.int64)
    padded[:m] = row_nnz
    return int(padded.reshape(ng, group_size).sum(axis=1).max())


@dataclasses.dataclass
class RGCSR:
    """Row-grouped CSR with per-row delta-coded column indices."""

    group_size: int
    group_ptr: np.ndarray      # (ngroups+1,) absolute offsets (4 B each)
    local_indptr: np.ndarray   # (ngroups, G+1) group-local offsets
    delta_indices: np.ndarray  # (nnz,) per-row column deltas (4 B each)
    values: np.ndarray         # (nnz,) float32/float64
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.values.size)

    @property
    def n_groups(self) -> int:
        return int(self.group_ptr.size - 1)

    @property
    def max_group_nnz(self) -> int:
        return int(np.diff(self.group_ptr).max()) if self.n_groups else 0

    @property
    def nbytes(self) -> int:
        vb = self.values.dtype.itemsize
        lb = local_indptr_bytes(self.max_group_nnz)
        return (self.nnz * (4 + vb)
                + self.local_indptr.size * lb
                + (self.n_groups + 1) * 4)

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.local_indptr, axis=1).reshape(-1)[:self.shape[0]]

    @classmethod
    def from_csr(cls, a: CSR, group_size: int = 32) -> "RGCSR":
        if group_size < 1:
            raise ValueError(f"group_size must be >= 1, got {group_size}")
        m, _ = a.shape
        G = group_size
        ngroups = (m + G - 1) // G
        rnnz = np.zeros(ngroups * G, dtype=np.int64)
        rnnz[:m] = np.diff(a.indptr)
        per_group = rnnz.reshape(ngroups, G)
        local = np.zeros((ngroups, G + 1), dtype=np.int64)
        local[:, 1:] = np.cumsum(per_group, axis=1)
        group_ptr = np.zeros(ngroups + 1, dtype=np.int64)
        group_ptr[1:] = np.cumsum(local[:, -1])
        return cls(group_size=G, group_ptr=group_ptr, local_indptr=local,
                   delta_indices=delta_encode_rows(a.indptr, a.indices),
                   values=a.values.copy(), shape=a.shape)

    def to_csr(self) -> CSR:
        m, _ = self.shape
        indptr = (self.group_ptr[:-1, None]
                  + self.local_indptr[:, :-1]).reshape(-1)[:m]
        indptr = np.concatenate([indptr, self.group_ptr[-1:]])
        indices = delta_decode_rows(indptr, self.delta_indices)
        return CSR(indptr=indptr.astype(np.int64), indices=indices,
                   values=self.values.copy(), shape=self.shape)

    def to_dense(self) -> np.ndarray:
        return self.to_csr().to_dense()

    def spmv(self, x: np.ndarray, y: np.ndarray | None = None) -> np.ndarray:
        """Reference y = A x + y running the group-local layout directly
        (local indptr + delta prefix-sum), not via `to_csr`."""
        m, n = self.shape
        out = (np.zeros(m, dtype=self.values.dtype) if y is None
               else y.astype(self.values.dtype).copy())
        G = self.group_size
        for g in range(self.n_groups):
            base = int(self.group_ptr[g])
            for i in range(G):
                row = g * G + i
                if row >= m:
                    break
                lo = base + int(self.local_indptr[g, i])
                hi = base + int(self.local_indptr[g, i + 1])
                if hi == lo:
                    continue
                cols = np.cumsum(self.delta_indices[lo:hi])
                out[row] += self.values[lo:hi] @ x[cols]
        return out


def rgcsr_nbytes_exact(row_nnz: np.ndarray, group_size: int,
                       value_bytes: int) -> int:
    """`RGCSR.nbytes` from a row-nnz histogram alone (no construction).

    Single source of truth shared with the autotuner's cost model so the
    selector's "exact" sizes can never drift from the format's own
    accounting (asserted in tests/test_rgcsr.py).
    """
    row_nnz = np.asarray(row_nnz, dtype=np.int64)
    m = int(row_nnz.size)
    G = int(group_size)
    ngroups = (m + G - 1) // G
    nnz = int(row_nnz.sum())
    lb = local_indptr_bytes(max_group_nnz(row_nnz, G))
    return nnz * (4 + value_bytes) + ngroups * (G + 1) * lb \
        + (ngroups + 1) * 4
