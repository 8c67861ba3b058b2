"""Fused dtANS decode + SpMV / SpMM: the CUDA kernels' wrappers and their
plain torch versions.

``dtans_spmv`` / ``dtans_spmm`` take a `DeviceMatrix` and a dense right-hand
side on the same device. On a CUDA tensor they launch the hand-written
kernels of ``csrc/dtans_spmv.cu`` (which replace the JAX package's
``dtans_spmv_pallas`` / ``dtans_spmm_pallas``), compiled for the matrix's
parameter set (`_build`: one library a set, built at first use); on a CPU
tensor they run the plain versions below. There is no fallback: a CUDA
tensor never reaches the plain version, and a build or launch failure
raises. The kernels take every set the JAX package's decoder decodes
right; `check_params` refuses the one kind it decodes wrongly.

The plain versions run the torch lock-step decoder (`kernels.common`) and
contract each segment in the kernels' own order,
``s = ((c0 + c1) + ...) + c_{l/2-1}`` with
``c_i = valid_i ? v_i * x[col_i] : 0``, then ``acc += s``. They work on
CPU and CUDA tensors alike; the kernels are held against them on the
card.

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

from repro_torch.core.params import PAPER, DtansParams
from repro_torch.kernels import _build, tiling
from repro_torch.kernels.common import bits_to_value, iter_segments
from repro_torch.kernels.pack import DeviceMatrix, check_rhs

launches = {"dtans_spmv": 0, "dtans_spmm": 0, "dtans_spmv_shared": 0,
            "dtans_spmm_shared": 0}

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
MATRIX_ARGS = [_I, _VP, _LL, _VP, _LL, _VP, _VP, _VP, _I, _LL, _I, _I, _I]
GEOM_ARGS = [_I, _I, _I, _LL, _I, _I, _I, _I, _LL]
_PATTERN = 9                            # MATRIX_ARGS' pattern argument


def matrix_argtypes(params: DtansParams) -> list:
    """`MATRIX_ARGS` of a set's library: past 64 segment positions the
    pattern goes as a pointer to its 64-bit words (``PatternArg`` in
    ``csrc/dtans_decode.cuh``)."""
    if params.l <= 64:
        return MATRIX_ARGS
    return MATRIX_ARGS[:_PATTERN] + [_VP] + MATRIX_ARGS[_PATTERN + 1:]


def pattern_arg(pattern, l: int):
    """The pattern (bit k: the table of segment position k) as the C
    entries take it: one signed 64-bit word up to 64 positions, else a
    ctypes array of ``ceil(l / 64)`` of them."""
    bits = sum(int(t) << k for k, t in enumerate(pattern))
    words = [(bits >> (64 * i)) & (2 ** 64 - 1) for i in range(-(-l // 64))]
    words = [w - 2 ** 64 if w >> 63 else w for w in words]
    return words[0] if l <= 64 else (_LL * len(words))(*words)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib(params: DtansParams = PAPER) -> ctypes.CDLL:
    lib = _build.load("dtans_spmv", params)
    if not getattr(lib, "_repro_declared", False):
        lib.dtans_spmv_launch.argtypes = matrix_argtypes(params) + \
            GEOM_ARGS + [_I, _VP, _LL, _VP, _VP]
        lib.dtans_spmv_launch.restype = _I
        lib.dtans_spmm_launch.argtypes = matrix_argtypes(params) + \
            GEOM_ARGS + [_I, _VP, _LL, _LL, _I, _VP, _VP]
        lib.dtans_spmm_launch.restype = _I
        lib.dtans_smem_need.argtypes = [_I, _I, _I, _I, _I, _I]
        lib.dtans_smem_need.restype = _LL
        lib.dtans_spmm_static_smem.argtypes = [ctypes.POINTER(_LL)]
        lib.dtans_spmm_static_smem.restype = _I
        lib.dtans_error_string.argtypes = [_I]
        lib.dtans_error_string.restype = ctypes.c_char_p
        lib._repro_declared = True
    return lib


def check_params(params: DtansParams) -> None:
    """Refuses a parameter set whose table slot can span more than the two
    stream words the decoder reads for it (``segment_step`` of both
    packages ORs word ``k`` with word ``k + 1`` only, the last word alone):
    the JAX package's decoder decodes such a set wrongly, so no kernel
    copies it (``tests/test_torch_params.py`` shows the reference wrong
    on one). No set with ``k_bits <= w_bits + 1`` meets it.

    Also refuses ``m_bits = 32``, the kernels' own limit (a base of 2^32
    does not fit their 32-bit digits): such a set needs ``k_bits = 32``,
    and one table of 2^32 slots of 24 bytes is 96 GiB, more than an H100
    holds, so no card could run it."""
    if params.m_bits > 31:
        raise ValueError(
            f"{params}: m_bits {params.m_bits} > 31; the kernels' digits "
            f"and bases are 32-bit, and its 2^{params.k_bits}-slot tables "
            f"would not fit a card")
    W, Kb, o = params.w_bits, params.k_bits, params.o
    for k in range(params.l):
        wi, sh = divmod(k * Kb, W)
        if Kb > (2 if wi + 1 < o else 1) * W - sh:
            raise ValueError(
                f"{params}: table slot {k} spans more than the two "
                f"{W}-bit stream words the decoder reads (bits {k * Kb}.."
                f"{(k + 1) * Kb - 1}); the reference decodes such a set "
                f"wrongly")


def kernel_args(dm: DeviceMatrix) -> list:
    """The C entries' matrix arguments (shared by the decode-only kernel);
    refuses what the kernels do not take."""
    check_params(dm.params)
    T = dm.tables.shape[0]
    if T > 2 or any(t >= T for t in dm.pattern):
        raise ValueError(f"pattern {dm.pattern} needs at most 2 tables")
    width = (2 + tiling.meta_words(dm.params)) * dm.params.K
    if dm.tables.shape[1] != width:
        raise ValueError(f"packed tables of shape {tuple(dm.tables.shape)}"
                         f", want (T, {width}) for {dm.params}")
    L = dm.lane_width
    if not 1 <= L <= 1024:
        raise ValueError(f"lane_width {L} outside 1..1024")
    for t in (dm.stream, dm.esc, dm.ns, dm.nnz, dm.tables):
        if not t.is_contiguous():
            raise ValueError("device matrix tensors must be contiguous")
    return [int(dm.dtype == torch.float64),
            dm.stream.data_ptr(), dm.stream.shape[1],
            dm.esc.data_ptr(), dm.esc.shape[2],
            dm.ns.data_ptr(), dm.nnz.data_ptr(), dm.tables.data_ptr(),
            T, pattern_arg(dm.pattern, dm.params.l), dm.n_slices, L,
            dm.max_nseg]


def n_sm(device: torch.device) -> int:
    """SMs of the card the launch goes to."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def spmv_geometry(dm: DeviceMatrix, n_sms: int = tiling.SM_COUNT
                  ) -> tiling.Geometry:
    """The SpMV launch of a device matrix."""
    geom = tiling.geometry(dm.n_slices, dm.lane_width, dm.tables.shape[0],
                           dm.dtype.itemsize, n_sm=n_sms, params=dm.params)
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
                           dm.dtype.itemsize, bn=bt, batch=B, n_sm=n_sms,
                           params=dm.params)
    check_plan(geom.smem)
    return geom


def raise_on(lib, rc: int, name: str) -> None:
    """Raises on a C entry's nonzero CUDA error code; ``lib`` exports
    ``dtans_error_string``."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.dtans_error_string(rc).decode()})")


def static_smem_bytes(params: DtansParams = PAPER) -> int:
    """The kernels' static shared memory as a set's built library reports
    it; `tiling.STATIC_SMEM_BYTES` must not be less."""
    lib = _lib(params)
    out = _LL(0)
    raise_on(lib, lib.dtans_spmm_static_smem(ctypes.byref(out)),
             "dtans_spmm_static_smem")
    return int(out.value)


def smem_need(spmm: bool, n_tables: int, lane_width: int, itemsize: int,
              bn: int = 0, params: DtansParams = PAPER) -> int:
    """A set's built kernels' own count of the shared memory a plan needs;
    `tiling.smem_plan` must give the same."""
    upb = tiling.geometry(1, lane_width, n_tables, itemsize,
                          params=params).units_per_block
    return int(_lib(params).dtans_smem_need(
        int(spmm), n_tables, tiling.unit_warps(lane_width), upb, bn,
        itemsize))


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
    lib = _lib(dm.params)
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
    lib = _lib(dm.params)
    rc = lib.dtans_spmm_launch(*args, *geom.args(), int(shared_cols),
                               x.data_ptr(), x.shape[0], B, bt, y.data_ptr(),
                               torch.cuda.current_stream(x.device).cuda_stream)
    name = _variant("dtans_spmm", shared_cols)
    launches[name] += 1
    raise_on(lib, rc, name)
    return y
