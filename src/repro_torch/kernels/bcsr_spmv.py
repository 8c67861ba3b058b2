"""Blocked CSR (BCSR) SpMV / SpMM: the pack, its device upload, the CUDA
kernels' wrappers and their plain torch versions.

`pack_bcsr` builds the JAX package's `PackedBCSR` (numpy, byte-equal): one
slot row per block row, ``W`` (the matrix-wide most blocks per block row)
slots of dense ``r x c`` tiles, padded slots with block column -1 and zero
values. `to_device` uploads it once per device: the values as the flat rows
of `kernels.padded`, block row s and its W tiles read as r rows of
``W * c`` positions (position ``w * c + j`` of row ``s * r + i`` holds
``values[s, w, i, j]``), interleaved in chunks of 32 rows; the block
columns stay the reference's ``(S, W)`` array, and `block_stops` adds where
each block row's real slots end (``stops``), which the kernels stop at.

The kernels and the plain versions here walk each row in that position
order, w-major then j, with the padded template's arithmetic
(`kernels.padded`): the column of position ``w * c + j`` is
``block_cols[s, w] * c + j``, clipped into x, and the term is
``block_cols[s, w] >= 0 ? val * x[clip(col)] : 0``. The mask is the block
column only, as in the reference: a real block's cells past the last
column hold value 0 and still multiply ``x[n - 1]``, and a padded slot is
a select. Kernel and plain version agree bitwise; against the reference,
which sums over (W, c) in no stated order, within its tolerances.

``bcsr_spmv`` / ``bcsr_spmm`` take a `DeviceBCSR` and a dense right-hand
side on the same device. On a CUDA tensor they launch the hand-written
kernels of ``csrc/bcsr_spmv.cu`` (which replace the JAX package's
``bcsr_spmv_pallas`` / ``bcsr_spmm_pallas``: an SpMV of four lanes a row,
and the padded SpMM kernel on `tiling.padded_geometry`'s flat grid); on a
CPU tensor they run the plain versions below, which walk every slot.
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
from repro_torch.sparse.bcsr import BCSR

launches = {"bcsr_spmv": 0, "bcsr_spmm": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@dataclasses.dataclass
class PackedBCSR:
    block_cols: np.ndarray  # (S, W) int32 block-column ids, -1 = padding
    values: np.ndarray      # (S, W, r, c)
    shape: tuple
    block_shape: tuple


def pack_bcsr(b: BCSR) -> PackedBCSR:
    r, c = b.block_shape
    S = b.n_block_rows
    per_row = np.diff(b.block_ptr)
    W = max(int(per_row.max()) if S else 0, 1)
    cols = np.full((S, W), -1, dtype=np.int32)
    vals = np.zeros((S, W, r, c), dtype=b.values.dtype)
    if b.n_blocks:
        # Vectorized scatter: each block lands at (its block row, its
        # position within that row).
        brow = np.repeat(np.arange(S, dtype=np.int64), per_row)
        pos = np.arange(b.n_blocks, dtype=np.int64) - b.block_ptr[brow]
        cols[brow, pos] = b.block_cols
        vals[brow, pos] = b.values
    return PackedBCSR(block_cols=cols, values=vals, shape=b.shape,
                      block_shape=b.block_shape)


def block_stops(block_cols: np.ndarray) -> np.ndarray:
    """(S,) int32: one past the last slot of each block row whose block
    column is real (>= 0), 0 for a block row of padding only. Every later
    slot is padding, wherever the -1s before it lie."""
    real = np.asarray(block_cols) >= 0
    ends = real * np.arange(1, real.shape[1] + 1)     # slot w real: w + 1
    return ends.max(axis=1, initial=0).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class DeviceBCSR:
    """The tensors of one `PackedBCSR` on one device: the values as
    interleaved flat rows (`padded.interleave`), the block columns as
    packed, and where each block row's real slots end."""
    block_cols: torch.Tensor  # (S, W) int32, -1 = padding
    values: torch.Tensor      # (ceil(S * r / 32), W * c, 32)
    stops: torch.Tensor       # (S,) int32, `block_stops`
    shape: tuple
    block_shape: tuple

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def n_block_rows(self) -> int:
        return int(self.block_cols.shape[0])

    @property
    def rows(self) -> int:
        """R = S * r, the padded row count of the output."""
        return self.n_block_rows * self.block_shape[0]

    @functools.cached_property
    def nbytes(self) -> int:
        """Bytes of the tensors the kernels read (padding included)."""
        return int(self.block_cols.nbytes + self.values.nbytes
                   + self.stops.nbytes)


def _flat_rows(values: np.ndarray) -> np.ndarray:
    """``(S, W, r, c)`` tiles -> ``(S, r, W * c)``: row i of block row s
    holds its W tiles' row i side by side."""
    S, W, r, c = values.shape
    return values.transpose(0, 2, 1, 3).reshape(S, r, W * c)


def to_device(pb: PackedBCSR, device="cuda") -> DeviceBCSR:
    """The pack's tensors on ``device``, built once and cached on ``pb``."""
    def build(dev: torch.device) -> DeviceBCSR:
        padded.check_values(pb.values)
        return DeviceBCSR(
            block_cols=host_tensor(pb.block_cols.astype(np.int32), dev),
            values=host_tensor(padded.interleave(_flat_rows(pb.values), 0),
                               dev),
            stops=host_tensor(block_stops(pb.block_cols), dev),
            shape=tuple(int(v) for v in pb.shape),
            block_shape=tuple(int(v) for v in pb.block_shape))
    return device_cached(pb, device, build)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _terms(db: DeviceBCSR):
    r, c = db.block_shape
    R = db.rows
    for w in range(db.block_cols.shape[1]):
        bcol = db.block_cols[:, w].repeat_interleave(r)            # (R,)
        for j in range(c):
            yield (bcol * c + j, bcol >= 0,
                   padded.position(db.values, w * c + j, R))


def bcsr_spmv_plain(db: DeviceBCSR, x: torch.Tensor) -> torch.Tensor:
    """Per-block-row rows (S, r) of A x, in torch."""
    return padded.contract(_terms(db), x, db.rows).reshape(
        db.n_block_rows, db.block_shape[0])


def bcsr_spmm_plain(db: DeviceBCSR, x: torch.Tensor,
                    bn: int | None = None) -> torch.Tensor:
    """Per-block-row rows (S, r, B) of A X, X (n, B), in torch."""
    return padded.contract(_terms(db), x, db.rows, bn).reshape(
        db.n_block_rows, db.block_shape[0], x.shape[1])


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _ints(db: DeviceBCSR) -> tuple:
    """The kernels' format sizes: slots per block row, r and c."""
    return (db.block_cols.shape[1], *db.block_shape)


def bcsr_spmv(db: DeviceBCSR, x: torch.Tensor) -> torch.Tensor:
    """Per-block-row rows (S, r) of A x, x (n,): the CUDA kernel on a CUDA
    tensor (four lanes a row, x staged in shared memory up to 48 KB), the
    plain version on a CPU tensor."""
    check_rhs(db, x, 1)
    if x.device.type == "cpu":
        return bcsr_spmv_plain(db, x)
    y = padded.launch("bcsr_spmv", launches, [db.block_cols, db.stops],
                      db.values, db.rows, x, ints=_ints(db))
    return y.reshape(db.n_block_rows, db.block_shape[0])


def bcsr_spmm(db: DeviceBCSR, x: torch.Tensor,
              bn: int | None = None) -> torch.Tensor:
    """Per-block-row rows (S, r, B) of A X, X (n, B): the CUDA kernel on a
    CUDA tensor (one warp per chunk of 32 rows and slab of columns of each
    of the ceil(B / bn) column tiles, `tiling.padded_geometry`, the rows of
    a block row reading x together where r divides 32; ``bn=None`` is one
    tile of all B columns), the plain version on a CPU tensor."""
    check_rhs(db, x, 2)
    B = x.shape[1]
    bt = padded.tile_width(B, bn)
    if x.device.type == "cpu":
        return bcsr_spmm_plain(db, x, None if bt == B else bt)
    y = padded.launch("bcsr_spmm", launches, [db.block_cols, db.stops],
                      db.values, db.rows, x, bt, ints=_ints(db))
    return y.reshape(db.n_block_rows, db.block_shape[0], B)
