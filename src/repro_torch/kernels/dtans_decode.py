"""Decode-only dtANS: the CUDA kernel's wrapper and its plain torch version.

``dtans_decode`` takes a `DeviceMatrix` and returns the decompressed matrix
in the reference's padded layout: ``(cols, vals)``, each ``(S, L,
max_nseg * l/2)``, lane by lane and segment-major, ``cols == -1`` and
``vals == +0`` at padding. On a CUDA matrix it launches the hand-written
kernel of ``csrc/dtans_decode.cu`` (which replaces the JAX package's
``dtans_decode_pallas``: the warp-synchronous decoder, each warp's
segments staged in shared memory and written out as whole sectors),
compiled for the matrix's parameter set, in the geometry of
`tiling.decode_geometry`; on a CPU matrix it runs
`dtans_decode_plain`, the torch lock-step decoder (`kernels.common`).
There is no fallback: a CUDA matrix never reaches the plain version, and
a build or launch failure raises. Kernel and plain version agree exactly:
columns as integers, values bit for bit.

`launches` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.params import PAPER, DtansParams
from repro_torch.kernels import _build, tiling
from repro_torch.kernels.common import bits_to_value, iter_segments
from repro_torch.kernels.dtans_spmv import (GEOM_ARGS, check_plan,
                                           kernel_args, matrix_argtypes,
                                           n_sm, raise_on)
from repro_torch.kernels.pack import DeviceMatrix

launches = {"dtans_decode": 0}

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib(params: DtansParams = PAPER) -> ctypes.CDLL:
    lib = _build.load("dtans_decode", params)
    if not getattr(lib, "_repro_declared", False):
        lib.dtans_decode_launch.argtypes = matrix_argtypes(params) + \
            GEOM_ARGS + [_VP, _VP, _VP]
        lib.dtans_decode_launch.restype = _I
        lib.dtans_decode_smem_need.argtypes = [_I, _I, _I, _I]
        lib.dtans_decode_smem_need.restype = _LL
        lib.dtans_error_string.argtypes = [_I]
        lib.dtans_error_string.restype = ctypes.c_char_p
        lib._repro_declared = True
    return lib


def out_width(dm: DeviceMatrix) -> int:
    """Entries per lane of the output: ``max_nseg * l/2``."""
    return dm.max_nseg * (dm.params.l // 2)


def dtans_decode_plain(dm: DeviceMatrix
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cols, vals)`` of the matrix, each (S, L, max_nseg * l/2), in
    torch."""
    cols_out, vals_out = [], []
    for _, cols, vbits, valid in iter_segments(dm):
        vals = bits_to_value(vbits, dm.dtype)
        cols_out.append(torch.where(valid, cols, -1).to(torch.int32))
        vals_out.append(torch.where(valid, vals, 0))
    # (max_nseg, h, S, L) -> (S, L, max_nseg * h), segment-major per lane
    cols = torch.stack(cols_out).permute(2, 3, 0, 1)
    vals = torch.stack(vals_out).permute(2, 3, 0, 1)
    S, L = dm.n_slices, dm.lane_width
    return (cols.reshape(S, L, -1).contiguous(),
            vals.reshape(S, L, -1).contiguous())


def smem_need(n_tables: int, lane_width: int, itemsize: int,
              params: DtansParams = PAPER) -> int:
    """A set's built kernel's own count of the shared memory a decode block
    needs; `tiling.decode_geometry`'s plan must give the same."""
    upb = tiling.geometry(1, lane_width, n_tables, itemsize,
                          params=params).units_per_block
    return int(_lib(params).dtans_decode_smem_need(
        n_tables, tiling.unit_warps(lane_width), upb, itemsize))


def dtans_decode(dm: DeviceMatrix) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cols, vals)`` of the matrix: the CUDA kernel on a CUDA matrix,
    the plain version on a CPU matrix."""
    if dm.device.type == "cpu":
        return dtans_decode_plain(dm)
    args = kernel_args(dm)
    geom = tiling.decode_geometry(dm.n_slices, dm.lane_width,
                                  dm.tables.shape[0], dm.dtype.itemsize,
                                  n_sm=n_sm(dm.device), params=dm.params)
    check_plan(geom.smem)
    shape = (dm.n_slices, dm.lane_width, out_width(dm))
    cols = torch.empty(shape, dtype=torch.int32, device=dm.device)
    vals = torch.empty(shape, dtype=dm.dtype, device=dm.device)
    if dm.n_slices == 0:
        return cols, vals
    lib = _lib(dm.params)
    rc = lib.dtans_decode_launch(
        *args, *geom.args(), cols.data_ptr(), vals.data_ptr(),
        torch.cuda.current_stream(dm.device).cuda_stream)
    launches["dtans_decode"] += 1
    raise_on(lib, rc, "dtans_decode")
    return cols, vals
