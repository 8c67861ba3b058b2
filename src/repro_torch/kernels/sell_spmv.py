"""SELL SpMV / SpMM (uncompressed comparator): the pack, its device upload,
the CUDA kernels' wrappers and their plain torch versions.

`pack_sell` builds the JAX package's `PackedSELL` (numpy, byte-equal):
slices of ``lane_width`` rows, every row padded with index -1 and value 0
to the matrix-wide longest row. It is the "fastest cuSPARSE format"
stand-in against which the paper's claim for the fused dtANS kernel is
measured. `to_device` uploads it once per device in the interleaved
layout of `kernels.padded`, with `row_stops`: one past each row's last
index >= 0, where the kernels stop the row (every later position is -1;
a -1 may also stand before it, and is walked and masked).

``sell_spmv`` / ``sell_spmm`` take a `DeviceSELL` and a dense right-hand
side on the same device. On a CUDA tensor they launch the hand-written
kernels of ``csrc/sell_spmv.cu`` (which replace the JAX package's
``sell_spmv_pallas`` / ``sell_spmm_pallas``): the SpMV runs four lanes a
row up to its stop, the products summed in position order through warp
shuffles, x read through L1; the SpMM runs a warp per chunk of 32 rows
and column slab, up to the chunk's longest stop. Both read the real
entries and little else, so bytes bound them. On a CPU
tensor they run the plain versions below, which walk every position and
sum in the kernels' order. There is no fallback: a CUDA tensor never
reaches the plain version.

`launches` counts kernel launches per wrapper, and nothing else.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import padded
from repro_torch.kernels.pack import check_rhs, device_cached, host_tensor
from repro_torch.sparse.formats import CSR

launches = {"sell_spmv": 0, "sell_spmm": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@dataclasses.dataclass
class PackedSELL:
    indices: np.ndarray   # (S, L, Wg) int32, -1 = padding
    values: np.ndarray    # (S, L, Wg)
    shape: tuple
    lane_width: int


def pack_sell(a: CSR, lane_width: int = 128) -> PackedSELL:
    m, _ = a.shape
    L = lane_width
    S = (m + L - 1) // L
    rnnz = np.diff(a.indptr)
    Wg = max(int(rnnz.max()) if m else 0, 1)
    idx = np.full((S * L, Wg), -1, dtype=np.int32)
    val = np.zeros((S * L, Wg), dtype=a.values.dtype)
    rows = np.repeat(np.arange(m), rnnz)        # row of each entry
    pos = np.arange(rows.size) - (np.cumsum(rnnz) - rnnz)[rows]
    src = a.indptr[:-1][rows] + pos
    idx[rows, pos] = a.indices[src]
    val[rows, pos] = a.values[src]
    return PackedSELL(indices=idx.reshape(S, L, Wg),
                      values=val.reshape(S, L, Wg), shape=a.shape,
                      lane_width=L)


def row_stops(indices: np.ndarray) -> np.ndarray:
    """``(S * L,)`` int32: one past the last position of each row of the
    ``(S, L, Wg)`` pack whose index is real (>= 0), 0 for a row of padding
    only. Every later position is padding, wherever the -1s before it
    lie."""
    idx = np.asarray(indices)
    real = idx.reshape(-1, idx.shape[-1]) >= 0
    last = real.shape[1] - np.argmax(real[:, ::-1], axis=1)
    return np.where(real.any(axis=1), last, 0).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class DeviceSELL:
    """The tensors of one `PackedSELL` on one device, interleaved
    (`padded.interleave`), and where each row's real entries end."""
    indices: torch.Tensor  # (ceil(R / 32), Wg, 32) int32, -1 = padding
    values: torch.Tensor   # (ceil(R / 32), Wg, 32)
    stops: torch.Tensor    # (R,) int32, `row_stops`
    shape: tuple
    lane_width: int
    n_slices: int

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def rows(self) -> int:
        """R = S * L, the padded row count of the output."""
        return self.n_slices * self.lane_width

    @functools.cached_property
    def nbytes(self) -> int:
        """Bytes of the tensors the kernels read (padding included)."""
        return int(self.indices.nbytes + self.values.nbytes
                   + self.stops.nbytes)


def to_device(ps: PackedSELL, device="cuda") -> DeviceSELL:
    """The pack's tensors on ``device``, built once and cached on ``ps``."""
    def build(dev: torch.device) -> DeviceSELL:
        padded.check_values(ps.values)
        return DeviceSELL(
            indices=host_tensor(padded.interleave(
                ps.indices.astype(np.int32), -1), dev),
            values=host_tensor(padded.interleave(ps.values, 0), dev),
            stops=host_tensor(row_stops(ps.indices), dev),
            shape=tuple(int(v) for v in ps.shape),
            lane_width=int(ps.lane_width),
            n_slices=int(ps.indices.shape[0]))
    return device_cached(ps, device, build)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _terms(ds: DeviceSELL):
    R = ds.rows
    for w in range(ds.values.shape[1]):
        idx = padded.position(ds.indices, w, R)
        yield idx, idx >= 0, padded.position(ds.values, w, R)


def sell_spmv_plain(ds: DeviceSELL, x: torch.Tensor) -> torch.Tensor:
    """Per-slice rows (S, L) of A x, in torch."""
    return padded.contract(_terms(ds), x, ds.rows).reshape(
        ds.n_slices, ds.lane_width)


def sell_spmm_plain(ds: DeviceSELL, x: torch.Tensor,
                    bn: int | None = None) -> torch.Tensor:
    """Per-slice rows (S, L, B) of A X, X (n, B), in torch."""
    return padded.contract(_terms(ds), x, ds.rows, bn).reshape(
        ds.n_slices, ds.lane_width, x.shape[1])


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def sell_spmv(ds: DeviceSELL, x: torch.Tensor) -> torch.Tensor:
    """Per-slice rows (S, L) of A x, x (n,): the CUDA kernel on a CUDA
    tensor (four lanes a row, each row stopped at its `row_stops` entry),
    the plain version on a CPU tensor."""
    check_rhs(ds, x, 1)
    if x.device.type == "cpu":
        return sell_spmv_plain(ds, x)
    y = padded.launch("sell_spmv", launches, [ds.indices, ds.stops],
                      ds.values, ds.rows, x)
    return y.reshape(ds.n_slices, ds.lane_width)


def sell_spmm(ds: DeviceSELL, x: torch.Tensor,
              bn: int | None = None) -> torch.Tensor:
    """Per-slice rows (S, L, B) of A X, X (n, B): the CUDA kernel on a CUDA
    tensor (one warp per chunk of 32 rows and slab of columns of each of
    the ceil(B / bn) column tiles, `tiling.padded_geometry`; ``bn=None`` is
    one tile of all B columns), the plain version on a CPU tensor."""
    check_rhs(ds, x, 2)
    B = x.shape[1]
    bt = padded.tile_width(B, bn)
    if x.device.type == "cpu":
        return sell_spmm_plain(ds, x, None if bt == B else bt)
    y = padded.launch("sell_spmm", launches, [ds.indices, ds.stops],
                      ds.values, ds.rows, x, bt)
    return y.reshape(ds.n_slices, ds.lane_width, B)
