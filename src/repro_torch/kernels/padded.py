"""The device layout, plain contraction and launch plumbing shared by the
SELL, RGCSR and BCSR kernels (`sell_spmv.py`, `rgcsr_spmv.py`,
`bcsr_spmv.py`).

The formats pack a matrix into ``(S, rows, Wg)`` arrays: S slices (SELL),
groups (RGCSR) or block rows (BCSR, ``Wg`` = blocks x block width) of
``rows`` rows, every row padded to ``Wg``, the matrix-wide longest row.
Row-major, neighbouring rows lie ``Wg`` elements apart, so a warp running
one row per thread would touch 32 cache lines per load. On the device the
flat ``(R, Wg)`` view (``R = S * rows``) is stored in chunks of 32 rows,
``(ceil(R / 32), Wg, 32)`` (`interleave`): element w of row r lies at
``((r // 32) * Wg + w) * 32 + r % 32``, and 32 neighbouring rows read 32
neighbouring words per position whatever the slice height or group size.
Results are those of the reference's layout.

The kernels (``csrc/padded_rows.cuh``) and the plain versions here
(`contract`) sum each row and column in one fixed order,

    acc = +0
    for w in 0..Wg-1:  acc = acc + (mask_w ? val_w * x[clip(col_w)] : 0)

with the multiply and the add rounded separately, so kernel and plain
version agree bitwise, every SpMM column is bitwise the SpMV of that
column, and column tiles change nothing. A masked term is a select: a
NaN or inf in ``x`` never reaches a padded entry. Every kernel stops each
row at its last real entry (SELL's `sell_spmv.row_stops`, RGCSR's
counts, BCSR's `bcsr_spmv.block_stops`): positions past it are masked,
and skipping a masked term is bitwise adding its +0 (the accumulator is
never -0, and acc + (+0) == acc for every other value). The SELL and
RGCSR SpMV (``spmv_lanes_kernel``) and the BCSR SpMV run four lanes a row
whose products reach the sum in position order through warp shuffles, so
the loads of the real entries are what bounds them; the SpMM kernel
(``spmm_warp_kernel``) runs a warp per chunk of 32 rows and column slab.
"""

from __future__ import annotations

import ctypes
from typing import Iterable

import numpy as np
import torch

from repro_torch.kernels import _build, tiling

#: Rows per interleaved chunk: one warp of the SpMM, one lane a row.
CHUNK = 32

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def interleave(a: np.ndarray, fill) -> np.ndarray:
    """``(S, rows, Wg)`` -> ``(ceil(R / 32), Wg, 32)``, ``R = S * rows``;
    the rows that round R up to whole chunks hold ``fill``."""
    S, rows, wg = a.shape
    R = S * rows
    C = -(-R // CHUNK)
    out = np.full((C * CHUNK, wg), fill, dtype=a.dtype)
    out[:R] = a.reshape(R, wg)
    return np.ascontiguousarray(out.reshape(C, CHUNK, wg).transpose(0, 2, 1))


def position(t: torch.Tensor, w: int, R: int) -> torch.Tensor:
    """Position ``w`` of every row of an interleaved tensor, as ``(R,)``."""
    return t[:, w, :].reshape(-1)[:R]


def check_values(values: np.ndarray) -> None:
    """Refuses value types the kernels are not built for."""
    if values.dtype not in (np.float32, np.float64):
        raise TypeError(f"the kernels take float32 or float64 values, not "
                        f"{values.dtype}")


def tile_width(B: int, bn, most_tiles: int | None = None) -> int:
    """Columns per tile: ``bn``, or all ``B`` when ``bn`` is None or wider;
    refuses more than ``most_tiles`` tiles where a caller gives a limit
    (the SpMM kernel's flat grid has none: `tiling.padded_geometry`
    bounds its blocks)."""
    if bn is not None and int(bn) < 1:
        raise ValueError(f"bn must be >= 1; got {bn}")
    bt = B if bn is None or int(bn) >= B else int(bn)
    if most_tiles is not None and -(-B // max(bt, 1)) > most_tiles:
        raise ValueError(f"{B} columns in tiles of {bt} exceed the grid")
    return bt


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def contract(terms: Iterable, x: torch.Tensor, R: int,
             bn: int | None = None) -> torch.Tensor:
    """The plain contraction: ``(R,)`` for x ``(n,)``, ``(R, B)`` for x
    ``(n, B)``. ``terms`` yields ``(col, mask, val)`` per position w, each
    ``(R,)``; ``bn`` bounds the columns gathered at once, as the kernel's
    column tiles do, and changes no column's arithmetic."""
    n = x.shape[0]
    acc = torch.zeros((R, *x.shape[1:]), dtype=x.dtype, device=x.device)
    if n == 0:          # no columns: every stored entry is padding
        return acc
    B = x.shape[1] if x.ndim == 2 else 1
    step = B if bn is None else int(bn)
    for col, mask, val in terms:
        ci = col.clamp(0, n - 1)
        if x.ndim == 1:
            acc = acc + torch.where(mask, val * x[ci], 0)
            continue
        for b0 in range(0, B, step):
            xg = x[:, b0:b0 + step][ci]                      # (R, bt)
            c = torch.where(mask[:, None], val[:, None] * xg, 0)
            acc[:, b0:b0 + step] = acc[:, b0:b0 + step] + c
    return acc


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def library(fmt: str, n_mat: int, n_int: int = 0) -> ctypes.CDLL:
    """``csrc/<fmt>_spmv.cu`` built and loaded, its C entries declared:
    ``<fmt>_spmv_launch`` / ``<fmt>_spmm_launch`` take the value-type flag,
    ``n_mat`` matrix pointers, ``n_int`` integer sizes of the format, the
    values, R and Wg, then x and n (and B, the tile width and the launch
    geometry of ``spmm_warp_kernel``, `tiling.padded_geometry`), y and the
    stream."""
    lib = _build.load(f"{fmt}_spmv")
    if not getattr(lib, "_repro_declared", False):
        head = ([_I] + [_VP] * n_mat + [_I] * n_int
                + [_VP, _LL, _I, _VP, _LL])
        spmv = getattr(lib, f"{fmt}_spmv_launch")
        spmv.argtypes = head + [_VP, _VP]
        spmv.restype = _I
        spmm = getattr(lib, f"{fmt}_spmm_launch")
        spmm.argtypes = head + [_LL, _I] + [_I] * 4 + [_LL] + [_VP, _VP]
        spmm.restype = _I
        err = getattr(lib, f"{fmt}_error_string")
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
        lib._repro_declared = True
    return lib


def launch(name: str, launches: dict, mats: list, val: torch.Tensor,
           R: int, x: torch.Tensor, bt: int | None = None,
           ints: tuple = ()) -> torch.Tensor:
    """Runs the kernel ``name`` (``<fmt>_spmv`` or ``<fmt>_spmm``) on CUDA
    tensors and returns y, ``(R,)`` or ``(R, B)``, counting the launch in
    ``launches[name]``; ``ints`` are the format's integer sizes. A matrix
    without rows or columns, or an empty batch, launches nothing: its
    result is zero."""
    if R == 0 or x.numel() == 0:
        return torch.zeros((R, *x.shape[1:]), dtype=x.dtype,
                           device=x.device)
    for t in (*mats, val):
        if not t.is_contiguous():
            raise ValueError("device matrix tensors must be contiguous")
    fmt, kind = name.split("_")
    lib = library(fmt, len(mats), len(ints))
    x = x.contiguous()
    y = torch.empty((R, *x.shape[1:]), dtype=x.dtype, device=x.device)
    args = [int(x.dtype == torch.float64), *(t.data_ptr() for t in mats),
            *(int(v) for v in ints), val.data_ptr(), R, int(val.shape[1]),
            x.data_ptr(), x.shape[0]]
    if kind == "spmm":
        args += [x.shape[1], bt, *tiling.padded_geometry(
            R, x.shape[0], x.shape[1], bt, x.element_size()).args()]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(lib, f"{name}_launch")(*args, y.data_ptr(), stream)
    launches[name] += 1
    if rc != 0:
        msg = getattr(lib, f"{fmt}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    return y
