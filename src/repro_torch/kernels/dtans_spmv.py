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

Both kernels run the reference's ``pipeline`` schedule (decode segment
j + 1, then contract segment j, in the same contraction order), so
``ops``' ``pipeline=True`` and ``pipeline=False`` launch them alike and
give the same bits. The launch geometry and shared-memory plan come from
`kernels.tiling`, through `spmv_geometry` / `spmm_geometry` here.

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
MATRIX_ARGS = [_I, _VP, _LL, _VP, _LL, _VP, _VP, _VP, _I, _I, _I, _I, _I]
GEOM_ARGS = [_I, _I, _I, _LL, _I, _I, _I, _I, _LL]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("dtans_spmv")
    if not getattr(lib, "_repro_declared", False):
        lib.dtans_spmv_launch.argtypes = MATRIX_ARGS + GEOM_ARGS + [
            _I, _VP, _LL, _VP, _VP]
        lib.dtans_spmv_launch.restype = _I
        lib.dtans_spmm_launch.argtypes = MATRIX_ARGS + GEOM_ARGS + [
            _I, _VP, _LL, _LL, _I, _VP, _VP]
        lib.dtans_spmm_launch.restype = _I
        lib.dtans_smem_need.argtypes = [_I, _I, _I, _I, _I, _I]
        lib.dtans_smem_need.restype = _LL
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
    T = dm.tables.shape[0]
    if T > 2 or any(t >= T for t in dm.pattern):
        raise ValueError(f"pattern {dm.pattern} needs at most 2 tables")
    if dm.tables.shape[1] != 3 * tiling.TABLE_SLOTS:
        raise ValueError(f"packed tables of shape {tuple(dm.tables.shape)}"
                         f", want (T, {3 * tiling.TABLE_SLOTS})")
    L = dm.lane_width
    if not 1 <= L <= 1024:
        raise ValueError(f"lane_width {L} outside 1..1024")
    for t in (dm.stream, dm.esc, dm.ns, dm.nnz, dm.tables):
        if not t.is_contiguous():
            raise ValueError("device matrix tensors must be contiguous")
    pattern_bits = sum(int(t) << k for k, t in enumerate(dm.pattern))
    return [int(dm.dtype == torch.float64),
            dm.stream.data_ptr(), dm.stream.shape[1],
            dm.esc.data_ptr(), dm.esc.shape[2],
            dm.ns.data_ptr(), dm.nnz.data_ptr(), dm.tables.data_ptr(),
            T, pattern_bits, dm.n_slices, L, dm.max_nseg]


def n_sm(device: torch.device) -> int:
    """SMs of the card the launch goes to."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def spmv_geometry(dm: DeviceMatrix, n_sms: int = tiling.SM_COUNT
                  ) -> tiling.Geometry:
    """The SpMV launch of a device matrix."""
    geom = tiling.geometry(dm.n_slices, dm.lane_width, dm.tables.shape[0],
                           dm.dtype.itemsize, n_sm=n_sms)
    check_plan(geom.smem)
    return geom


def check_plan(smem: int) -> None:
    """Refuses a shared-memory plan a block cannot hold beside the
    kernels' static shared memory."""
    room = tiling.MAX_SMEM_BYTES - tiling.STATIC_SMEM_BYTES
    if smem > room:
        raise ValueError(
            f"the kernel's plan needs {smem} B of shared memory, more than "
            f"the {room} B a block has; pass a smaller bn")


def spmm_geometry(dm: DeviceMatrix, B: int, bt: int,
                  n_sms: int = tiling.SM_COUNT) -> tiling.Geometry:
    """The SpMM launch of a device matrix over ``B`` columns in tiles of
    ``bt``; refuses a lane width wider than the SpMM block takes and a
    tile whose plan does not fit the block's shared memory."""
    if dm.lane_width > tiling.MAX_SPMM_LANE_WIDTH:
        raise ValueError(
            f"the SpMM kernel takes lane widths up to "
            f"{tiling.MAX_SPMM_LANE_WIDTH} (its decoder warps and a "
            f"contraction warp share a 1024-thread block), not "
            f"{dm.lane_width}; SpMV (B = 1) takes up to 1024")
    geom = tiling.geometry(dm.n_slices, dm.lane_width, dm.tables.shape[0],
                           dm.dtype.itemsize, bn=bt, batch=B, n_sm=n_sms)
    check_plan(geom.smem)
    return geom


def raise_on(lib, rc: int, name: str) -> None:
    """Raises on a C entry's nonzero CUDA error code; ``lib`` exports
    ``dtans_error_string``."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.dtans_error_string(rc).decode()})")


def static_smem_bytes() -> int:
    """The kernels' static shared memory as the built library reports it;
    `tiling.STATIC_SMEM_BYTES` must not be less."""
    lib = _lib()
    out = _LL(0)
    raise_on(lib, lib.dtans_spmm_static_smem(ctypes.byref(out)),
             "dtans_spmm_static_smem")
    return int(out.value)


def smem_need(spmm: bool, n_tables: int, lane_width: int, itemsize: int,
              bn: int = 0) -> int:
    """The built kernels' own count of the shared memory a plan needs;
    `tiling.smem_plan` must give the same."""
    upb = tiling.geometry(1, lane_width, n_tables, itemsize).units_per_block
    return int(_lib().dtans_smem_need(int(spmm), n_tables,
                                      tiling.unit_warps(lane_width), upb,
                                      bn, itemsize))


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
    geom = spmv_geometry(dm, n_sm(x.device))
    x = x.contiguous()
    y = torch.empty((dm.n_slices, dm.lane_width), dtype=dm.dtype,
                    device=x.device)
    if dm.n_slices == 0:
        return y
    lib = _lib()
    rc = lib.dtans_spmv_launch(*args, *geom.args(), int(shared_cols),
                               x.data_ptr(), x.shape[0], y.data_ptr(),
                               torch.cuda.current_stream(x.device).cuda_stream)
    name = _variant("dtans_spmv", shared_cols)
    launches[name] += 1
    raise_on(lib, rc, name)
    return y


def dtans_spmm(dm: DeviceMatrix, x: torch.Tensor, bn: int | None = None,
               shared_cols: bool = False) -> torch.Tensor:
    """Per-slice rows (S, L, B) of A X, X (n, B): the CUDA kernel on a CUDA
    tensor (work items of one unit and one column tile of ``bn`` columns;
    ``bn=None`` is one tile of all B columns), the plain version on a CPU
    tensor."""
    check_rhs(dm, x, 2)
    B = x.shape[1]
    if bn is not None and int(bn) < 1:
        raise ValueError(f"bn must be >= 1; got {bn}")
    bt = B if bn is None or int(bn) >= B else int(bn)
    if x.device.type == "cpu":
        return dtans_spmm_plain(dm, x, None if bt == B else bt, shared_cols)
    args = kernel_args(dm)
    geom = spmm_geometry(dm, B, max(bt, 1), n_sm(x.device))
    x = x.contiguous()
    y = torch.empty((dm.n_slices, dm.lane_width, B), dtype=dm.dtype,
                    device=x.device)
    if dm.n_slices == 0 or B == 0:
        return y
    lib = _lib()
    rc = lib.dtans_spmm_launch(*args, *geom.args(), int(shared_cols),
                               x.data_ptr(), x.shape[0], B, bt, y.data_ptr(),
                               torch.cuda.current_stream(x.device).cuda_stream)
    name = _variant("dtans_spmm", shared_cols)
    launches[name] += 1
    raise_on(lib, rc, name)
    return y
