"""Fused dtANS decode + SpMV / SpMM: the CUDA kernels' wrappers and their
plain torch versions.

``dtans_spmv`` / ``dtans_spmm`` take a `DeviceMatrix` and a dense right-hand
side on the same device. On a CUDA tensor they launch the hand-written
kernels of ``csrc/dtans_spmv.cu`` (which replace the JAX package's
``dtans_spmv_pallas`` / ``dtans_spmm_pallas``); on a CPU tensor they run
the plain versions below. There is no fallback: a CUDA tensor never
reaches the plain version, and a build or launch failure raises.

The plain versions run the torch lock-step decoder (`kernels.common`) and
contract each segment in the kernels' own order,
``s = ((c0 + c1) + c2) + c3`` with ``c_i = valid_i ? v_i * x[col_i] : 0``,
then ``acc += s``. They work on CPU and CUDA tensors alike; the kernels
are held against them on the card.

``shared_cols=True`` is the fused BCSR-dtANS contraction of a block-filled
pack (`PackedMatrix.shared_cols`): every lane gathers x at lane 0's
decoded columns, as the reference does (``cols[:, 0]``). On such a pack a
valid term multiplies the same x either way, so the result is bitwise the
generic one.

`launches` counts kernel launches per wrapper and variant (and nothing
else), so a run can show that its path went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.params import PAPER
from repro_torch.kernels import _build, tiling
from repro_torch.kernels.common import bits_to_value, iter_segments
from repro_torch.kernels.pack import DeviceMatrix, check_rhs

launches = {"dtans_spmv": 0, "dtans_spmm": 0, "dtans_spmv_shared": 0,
            "dtans_spmm_shared": 0}

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
MATRIX_ARGS = [_I, _VP, _LL, _VP, _LL, _VP, _VP, _VP, _VP, _VP, _VP,
                _I, _I, _I, _I, _I]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("dtans_spmv")
    if not getattr(lib, "_repro_declared", False):
        lib.dtans_spmv_launch.argtypes = MATRIX_ARGS + [_I, _VP, _LL, _VP,
                                                         _VP]
        lib.dtans_spmv_launch.restype = _I
        lib.dtans_spmm_launch.argtypes = MATRIX_ARGS + [_I, _VP, _LL, _LL,
                                                         _I, _VP, _VP]
        lib.dtans_spmm_launch.restype = _I
        lib.dtans_spmm_static_smem.argtypes = [ctypes.POINTER(_LL)]
        lib.dtans_spmm_static_smem.restype = _I
        lib.dtans_error_string.argtypes = [_I]
        lib.dtans_error_string.restype = ctypes.c_char_p
        lib._repro_declared = True
    return lib


def kernel_args(dm: DeviceMatrix) -> list:
    """The C entries' matrix arguments (shared by the decode-only kernel);
    refuses what the kernels do not take."""
    if dm.params != PAPER:
        raise NotImplementedError(
            f"the CUDA kernels are built for the paper's parameters "
            f"{PAPER}, not {dm.params}; other parameter sets are a later "
            f"item of ROADMAP.md queue B")
    T, K = dm.tab_symbol.shape
    if T > 2 or any(t >= T for t in dm.pattern):
        raise ValueError(f"pattern {dm.pattern} needs at most 2 tables")
    L = dm.lane_width
    if not 1 <= L <= 1024:
        raise ValueError(f"lane_width {L} outside 1..1024")
    for t in (dm.stream, dm.esc, dm.ns, dm.nnz, dm.tab_symbol, dm.tab_digit,
              dm.tab_base, dm.tab_is_esc):
        if not t.is_contiguous():
            raise ValueError("device matrix tensors must be contiguous")
    pattern_bits = sum(int(t) << k for k, t in enumerate(dm.pattern))
    return [int(dm.dtype == torch.float64),
            dm.stream.data_ptr(), dm.stream.shape[1],
            dm.esc.data_ptr(), dm.esc.shape[2],
            dm.ns.data_ptr(), dm.nnz.data_ptr(),
            dm.tab_symbol.data_ptr(), dm.tab_digit.data_ptr(),
            dm.tab_base.data_ptr(), dm.tab_is_esc.data_ptr(),
            K, pattern_bits, dm.n_slices, L, dm.max_nseg]


def _check_tile(lane_width: int, B: int, bt: int, itemsize: int) -> None:
    """Refuses a column tile the SpMM kernel cannot launch: its ``(bt,
    threads)`` accumulator must fit the block's shared memory beside the
    kernel's static arrays, and its tile count the grid's y dimension."""
    threads = -(-lane_width // tiling.WARP) * tiling.WARP
    smem = bt * threads * itemsize
    room = tiling.MAX_SMEM_BYTES - tiling.STATIC_SMEM_BYTES
    if smem > room:
        raise ValueError(
            f"a column tile of {bt} needs {smem} B of shared memory, more "
            f"than the {room} B a block has beside the kernel's static "
            f"shared memory; pass a smaller bn")
    if -(-B // max(bt, 1)) > 65535:
        raise ValueError(f"{B} columns in tiles of {bt} exceed the grid")


def raise_on(lib, rc: int, name: str) -> None:
    """Raises on a C entry's nonzero CUDA error code; ``lib`` exports
    ``dtans_error_string``."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.dtans_error_string(rc).decode()})")


def static_smem_bytes() -> int:
    """The SpMM kernel's static shared memory as the built library reports
    it; `tiling.STATIC_SMEM_BYTES` must not be less."""
    lib = _lib()
    out = _LL(0)
    raise_on(lib, lib.dtans_spmm_static_smem(ctypes.byref(out)),
             "dtans_spmm_static_smem")
    return int(out.value)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _segment_sum(c: torch.Tensor) -> torch.Tensor:
    """((c0 + c1) + c2) + ... over the leading (position) axis."""
    s = c[0]
    for i in range(1, c.shape[0]):
        s = s + c[i]
    return s


def _gather_cols(cols: torch.Tensor, shared_cols: bool) -> torch.Tensor:
    """The columns each lane gathers x at, (h, S, L) or, shared, lane 0's
    as (h, S, 1)."""
    return cols[..., :1] if shared_cols else cols


def dtans_spmv_plain(dm: DeviceMatrix, x: torch.Tensor,
                     shared_cols: bool = False) -> torch.Tensor:
    """Per-slice rows (S, L) of A x, in torch."""
    n = dm.shape[1]
    acc = torch.zeros((dm.n_slices, dm.lane_width), dtype=dm.dtype,
                      device=x.device)
    for _, cols, vbits, valid in iter_segments(dm):
        vals = bits_to_value(vbits, dm.dtype)                # (h, S, L)
        xg = x[_gather_cols(cols, shared_cols).clamp(0, n - 1)]
        acc = acc + _segment_sum(torch.where(valid, vals * xg, 0))
    return acc


def dtans_spmm_plain(dm: DeviceMatrix, x: torch.Tensor,
                     bn: int | None = None,
                     shared_cols: bool = False) -> torch.Tensor:
    """Per-slice rows (S, L, B) of A X, X (n, B), in torch. ``bn`` bounds
    the columns gathered at once, as the kernel's column tiles do; the
    arithmetic of every column is the same at any ``bn``."""
    n, B = x.shape
    step = B if bn is None else int(bn)
    acc = torch.zeros((dm.n_slices, dm.lane_width, B), dtype=dm.dtype,
                      device=x.device)
    for _, cols, vbits, valid in iter_segments(dm):
        vals = bits_to_value(vbits, dm.dtype)[..., None]     # (h, S, L, 1)
        ci = _gather_cols(cols, shared_cols).clamp(0, n - 1)
        for b0 in range(0, B, step):
            xg = x[:, b0:b0 + step][ci]                      # (h, S, L, bt)
            c = torch.where(valid[..., None], vals * xg, 0)
            acc[..., b0:b0 + step] = acc[..., b0:b0 + step] + _segment_sum(c)
    return acc


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _variant(kind: str, shared_cols: bool) -> str:
    return f"{kind}_shared" if shared_cols else kind


def dtans_spmv(dm: DeviceMatrix, x: torch.Tensor,
               shared_cols: bool = False) -> torch.Tensor:
    """Per-slice rows (S, L) of A x, x (n,): the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    check_rhs(dm, x, 1)
    if x.device.type == "cpu":
        return dtans_spmv_plain(dm, x, shared_cols)
    args = kernel_args(dm)
    x = x.contiguous()
    y = torch.empty((dm.n_slices, dm.lane_width), dtype=dm.dtype,
                    device=x.device)
    if dm.n_slices == 0:
        return y
    lib = _lib()
    rc = lib.dtans_spmv_launch(*args, int(shared_cols), x.data_ptr(),
                               x.shape[0], y.data_ptr(),
                               torch.cuda.current_stream(x.device).cuda_stream)
    name = _variant("dtans_spmv", shared_cols)
    launches[name] += 1
    raise_on(lib, rc, name)
    return y


def dtans_spmm(dm: DeviceMatrix, x: torch.Tensor, bn: int | None = None,
               shared_cols: bool = False) -> torch.Tensor:
    """Per-slice rows (S, L, B) of A X, X (n, B): the CUDA kernel on a CUDA
    tensor (grid (S, ceil(B / bn)); ``bn=None`` is one tile of all B
    columns), the plain version on a CPU tensor."""
    check_rhs(dm, x, 2)
    B = x.shape[1]
    if bn is not None and int(bn) < 1:
        raise ValueError(f"bn must be >= 1; got {bn}")
    bt = B if bn is None or int(bn) >= B else int(bn)
    if x.device.type == "cpu":
        return dtans_spmm_plain(dm, x, None if bt == B else bt, shared_cols)
    args = kernel_args(dm)
    _check_tile(dm.lane_width, B, bt, x.element_size())
    x = x.contiguous()
    y = torch.empty((dm.n_slices, dm.lane_width, B), dtype=dm.dtype,
                    device=x.device)
    if dm.n_slices == 0 or B == 0:
        return y
    lib = _lib()
    rc = lib.dtans_spmm_launch(*args, int(shared_cols), x.data_ptr(),
                               x.shape[0], B, bt, y.data_ptr(),
                               torch.cuda.current_stream(x.device).cuda_stream)
    name = _variant("dtans_spmm", shared_cols)
    launches[name] += 1
    raise_on(lib, rc, name)
    return y
