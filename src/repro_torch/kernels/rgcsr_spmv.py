"""Row-grouped CSR (RGCSR) SpMV / SpMM: the pack, its device upload, the
CUDA kernels' wrappers and their plain torch versions.

`pack_rgcsr` builds the JAX package's `PackedRGCSR` (numpy, byte-equal):
one group of G rows per slice, each row's delta-coded columns (0 =
padding) and values padded to the matrix-wide longest row, and the real
entry count per row. The padding is address padding only, not counted in
`RGCSR.nbytes`. The kernels rebuild each row's columns with an int32
running sum of its deltas (the deltas stay deltas on the device), mask
positions at or past its count, and stop each row there. `to_device`
uploads the pack once per device in the interleaved layout of
`kernels.padded`.

``rgcsr_spmv`` / ``rgcsr_spmm`` take a `DeviceRGCSR` and a dense
right-hand side on the same device. On a CUDA tensor they launch the
hand-written kernels of ``csrc/rgcsr_spmv.cu`` (which replace the JAX
package's ``rgcsr_spmv_pallas`` / ``rgcsr_spmm_pallas``): the SpMV runs
four lanes a row, each step's four columns a prefix sum of its deltas
across the lanes (warp shuffles) plus the row's carry, the products
summed in position order; the SpMM runs a warp per chunk of 32 rows and
column slab, one lane a row's running sum. Both read the real entries and
the counts, so bytes bound them. On a CPU tensor they run the plain
versions below, which walk every position and sum in the kernels' order.
There is no fallback: a CUDA tensor never reaches the plain version.

`launches` counts kernel launches per wrapper, and nothing else.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import padded
from repro_torch.kernels.pack import check_rhs, device_cached, host_tensor
from repro_torch.sparse.rgcsr import RGCSR

launches = {"rgcsr_spmv": 0, "rgcsr_spmm": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@dataclasses.dataclass
class PackedRGCSR:
    deltas: np.ndarray    # (S, G, Wg) int32 delta streams, 0 = padding
    values: np.ndarray    # (S, G, Wg)
    nnz: np.ndarray       # (S, G) int32 — real entries per row
    shape: tuple
    group_size: int


def pack_rgcsr(r: RGCSR) -> PackedRGCSR:
    m, _ = r.shape
    G = r.group_size
    S = r.n_groups
    rnnz = r.row_nnz()
    Wg = max(int(rnnz.max()) if m else 0, 1)
    deltas = np.zeros((S * G, Wg), dtype=np.int32)
    values = np.zeros((S * G, Wg), dtype=r.values.dtype)
    nnz = np.zeros(S * G, dtype=np.int32)
    # row i's entries start at group_ptr[i // G] + local_indptr[i // G, i % G]
    starts = (r.group_ptr[:-1, None] + r.local_indptr[:, :-1]).reshape(-1)
    rows = np.repeat(np.arange(m), rnnz)        # row of each entry
    pos = np.arange(rows.size) - (np.cumsum(rnnz) - rnnz)[rows]
    src = starts[rows] + pos
    deltas[rows, pos] = r.delta_indices[src]
    values[rows, pos] = r.values[src]
    nnz[:m] = rnnz
    return PackedRGCSR(deltas=deltas.reshape(S, G, Wg),
                       values=values.reshape(S, G, Wg),
                       nnz=nnz.reshape(S, G), shape=r.shape, group_size=G)


@dataclasses.dataclass(frozen=True)
class DeviceRGCSR:
    """The tensors of one `PackedRGCSR` on one device, interleaved
    (`padded.interleave`)."""
    deltas: torch.Tensor   # (ceil(R / 32), Wg, 32) int32, 0 = padding
    values: torch.Tensor   # (ceil(R / 32), Wg, 32)
    nnz: torch.Tensor      # (R,) int32
    shape: tuple
    group_size: int
    n_groups: int

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def rows(self) -> int:
        """R = S * G, the padded row count of the output."""
        return self.n_groups * self.group_size

    @functools.cached_property
    def nbytes(self) -> int:
        """Bytes of the tensors the kernels read (padding included)."""
        return int(self.deltas.nbytes + self.values.nbytes
                   + self.nnz.nbytes)


def to_device(pr: PackedRGCSR, device="cuda") -> DeviceRGCSR:
    """The pack's tensors on ``device``, built once and cached on ``pr``."""
    def build(dev: torch.device) -> DeviceRGCSR:
        padded.check_values(pr.values)
        return DeviceRGCSR(
            deltas=host_tensor(padded.interleave(
                pr.deltas.astype(np.int32), 0), dev),
            values=host_tensor(padded.interleave(pr.values, 0), dev),
            nnz=host_tensor(pr.nnz.astype(np.int32).reshape(-1), dev),
            shape=tuple(int(v) for v in pr.shape),
            group_size=int(pr.group_size),
            n_groups=int(pr.deltas.shape[0]))
    return device_cached(pr, device, build)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _terms(dr: DeviceRGCSR):
    R = dr.rows
    col = torch.zeros(R, dtype=torch.int32, device=dr.device)
    for w in range(dr.values.shape[1]):
        col = col + padded.position(dr.deltas, w, R)    # int32, wraps
        yield col, w < dr.nnz, padded.position(dr.values, w, R)


def rgcsr_spmv_plain(dr: DeviceRGCSR, x: torch.Tensor) -> torch.Tensor:
    """Per-group rows (S, G) of A x, in torch."""
    return padded.contract(_terms(dr), x, dr.rows).reshape(
        dr.n_groups, dr.group_size)


def rgcsr_spmm_plain(dr: DeviceRGCSR, x: torch.Tensor,
                     bn: int | None = None) -> torch.Tensor:
    """Per-group rows (S, G, B) of A X, X (n, B), in torch."""
    return padded.contract(_terms(dr), x, dr.rows, bn).reshape(
        dr.n_groups, dr.group_size, x.shape[1])


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def rgcsr_spmv(dr: DeviceRGCSR, x: torch.Tensor) -> torch.Tensor:
    """Per-group rows (S, G) of A x, x (n,): the CUDA kernel on a CUDA
    tensor (four lanes a row, each row stopped at its count), the plain
    version on a CPU tensor."""
    check_rhs(dr, x, 1)
    if x.device.type == "cpu":
        return rgcsr_spmv_plain(dr, x)
    y = padded.launch("rgcsr_spmv", launches, [dr.deltas, dr.nnz],
                      dr.values, dr.rows, x)
    return y.reshape(dr.n_groups, dr.group_size)


def rgcsr_spmm(dr: DeviceRGCSR, x: torch.Tensor,
               bn: int | None = None) -> torch.Tensor:
    """Per-group rows (S, G, B) of A X, X (n, B): the CUDA kernel on a CUDA
    tensor (one warp per chunk of 32 rows and slab of columns of each of
    the ceil(B / bn) column tiles, `tiling.padded_geometry`; ``bn=None`` is
    one tile of all B columns), the plain version on a CPU tensor."""
    check_rhs(dr, x, 2)
    B = x.shape[1]
    bt = padded.tile_width(B, bn)
    if x.device.type == "cpu":
        return rgcsr_spmm_plain(dr, x, None if bt == B else bt)
    y = padded.launch("rgcsr_spmm", launches, [dr.deltas, dr.nnz],
                      dr.values, dr.rows, x, bt)
    return y.reshape(dr.n_groups, dr.group_size, B)
