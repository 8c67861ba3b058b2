"""Pack a CSRdtANS matrix into dense, kernel-ready arrays.

The production format stores one flat stream with per-slice offsets. The
kernels index every slice at a fixed stride, so we pad every slice's
stream (and escape stream) to the matrix-wide maximum and expose them as
(n_slices, max_*) arrays. The padding is address padding only — it is NOT
counted in the format's compressed size (CSRdtANS.nbytes).

`PackedMatrix` stays numpy and byte-equal to the JAX package's pack.
`to_device` builds the torch tensors the kernels read, once per device,
and caches them on the packed object (as `ops.get_packed` caches the pack
on the matrix). Among them are the coding tables packed for the CUDA
kernels (`pack_tables`), in the slot layout of the pack's parameter set;
the kernels stage them in shared memory or read them from global memory,
as `tiling.tables_in_smem` says.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.csr_dtans import CSRdtANS
from repro_torch.core.params import PAPER, DtansParams
from repro_torch.kernels import tiling

_DEVICE_CACHE_FIELD = "_device_cache"


@dataclasses.dataclass
class PackedMatrix:
    """Kernel-ready CSR-dtANS. All arrays are numpy; `to_device` moves them
    to torch."""
    stream: np.ndarray      # (S, Wmax) uint64 (< 2^32)
    esc: np.ndarray         # (T, S, Emax) uint64
    ns: np.ndarray          # (S, L) int32 — symbols per lane (2*nnz)
    nnz: np.ndarray         # (S, L) int32 — nonzeros per lane
    row_valid: np.ndarray   # (S, L) bool — lane maps to a real row
    tab_symbol: np.ndarray  # (T, K) uint64
    tab_digit: np.ndarray   # (T, K) int32
    tab_base: np.ndarray    # (T, K) int32
    tab_is_esc: np.ndarray  # (T, K) int32 (0/1)
    pattern: tuple          # static, length l
    params: DtansParams     # static
    shape: tuple
    dtype: np.dtype
    lane_width: int
    max_nseg: int           # static loop bound
    # Block-filled encode (BCSR-dtANS at lane_width == block height): every
    # in-bounds lane of a slice decodes the SAME column sequence, so the
    # ops run the fused contraction (x gathered at lane 0's columns).
    shared_cols: bool = False

    @property
    def n_slices(self) -> int:
        return int(self.stream.shape[0])


@dataclasses.dataclass(frozen=True)
class DeviceMatrix:
    """The torch tensors of one `PackedMatrix` on one device.

    Unsigned words are kept as signed bit patterns of the same width,
    because torch has no uint64 arithmetic: the stream (values < 2^32) as
    int32, escape symbols and table symbols (f64 value bits may reach
    2^64) as int64."""
    stream: torch.Tensor      # (S, Wmax) int32, uint32 bit patterns
    esc: torch.Tensor         # (T, S, Emax) int64, uint64 bit patterns
    ns: torch.Tensor          # (S, L) int32
    nnz: torch.Tensor         # (S, L) int32
    tab_symbol: torch.Tensor  # (T, K) int64, uint64 bit patterns
    tab_digit: torch.Tensor   # (T, K) int32
    tab_base: torch.Tensor    # (T, K) int32
    tab_is_esc: torch.Tensor  # (T, K) int32
    tables: torch.Tensor      # (T, (2 + meta words) K) int32, `pack_tables`
    params: DtansParams
    pattern: tuple
    max_nseg: int
    lane_width: int
    shape: tuple
    dtype: torch.dtype        # value / accumulator dtype

    @property
    def device(self) -> torch.device:
        return self.stream.device

    @property
    def n_slices(self) -> int:
        return int(self.stream.shape[0])

    @functools.cached_property
    def nbytes(self) -> int:
        """Bytes of the tensors the CUDA kernels read: the matrix-side
        traffic of one pass (padded device arrays and the packed tables,
        not the compressed wire size). The plain versions' separate
        ``tab_*`` tables are not counted."""
        return sum(int(t.nbytes) for t in (
            self.stream, self.esc, self.ns, self.nnz, self.tables))


def _meta_fields(params: DtansParams) -> tuple[int, int]:
    """Shifts of base and is_esc in a slot's meta word: digit takes
    ``m_bits`` bits (digit < base <= M), base ``m_bits + 1``, is_esc 1."""
    return params.m_bits, 2 * params.m_bits + 1


def pack_tables(symbol: np.ndarray, digit: np.ndarray, base: np.ndarray,
                is_esc: np.ndarray, params: DtansParams = PAPER
                ) -> np.ndarray:
    """The (T, K) coding tables as the CUDA kernels read them: per table, K
    u64 symbols (as int32 pairs, little-endian), then K meta words of
    digit | base << m_bits | is_esc << (2 m_bits + 1), each one u32 where
    the fields fit 32 bits and one u64 where they do not
    (`tiling.meta_words`): 12 bytes a slot at `PAPER` (digit < 256, base
    <= 256), 16 at ``m_bits = 16``; a (T, (2 + meta words) K) int32 array.
    Refuses values the fields cannot hold."""
    digit, base = np.asarray(digit, np.int64), np.asarray(base, np.int64)
    is_esc = np.asarray(is_esc, np.int64)
    base_shift, esc_shift = _meta_fields(params)
    if digit.size and (digit.min() < 0 or digit.max() >= 1 << base_shift
                       or base.min() < 0
                       or base.max() >= 1 << (esc_shift - base_shift)
                       or not np.isin(is_esc, (0, 1)).all()):
        raise ValueError(
            f"coding table out of the packed slot's range (digit < "
            f"{1 << base_shift}, base < {1 << (esc_shift - base_shift)}, "
            f"is_esc 0/1)")
    T, K = digit.shape
    mw = tiling.meta_words(params)
    sym = np.ascontiguousarray(symbol, dtype=np.uint64).view(np.int32)
    meta = (digit | base << base_shift | is_esc << esc_shift).astype(
        np.uint32 if mw == 1 else np.uint64).view(np.int32)
    return np.concatenate([sym.reshape(T, 2 * K), meta.reshape(T, mw * K)],
                          axis=1)


def unpack_tables(tables: np.ndarray, params: DtansParams = PAPER):
    """Inverse of `pack_tables`: (symbol u64, digit, base, is_esc), each
    (T, K)."""
    tables = np.ascontiguousarray(tables, dtype=np.int32)
    mw = tiling.meta_words(params)
    K = tables.shape[1] // (2 + mw)
    symbol = np.ascontiguousarray(tables[:, :2 * K]).view(np.uint64)
    meta = np.ascontiguousarray(tables[:, 2 * K:]).view(
        np.uint32 if mw == 1 else np.uint64).astype(np.int64)
    base_shift, esc_shift = _meta_fields(params)
    return (symbol, (meta & ((1 << base_shift) - 1)).astype(np.int32),
            (meta >> base_shift & ((1 << (esc_shift - base_shift)) - 1)
             ).astype(np.int32),
            (meta >> esc_shift & 1).astype(np.int32))


def pack_matrix(mat: CSRdtANS) -> PackedMatrix:
    S = mat.n_slices
    L = mat.lane_width
    T = len(mat.tables)
    l = mat.params.l
    m = mat.shape[0]

    w_lens = np.diff(mat.slice_offsets)
    Wmax = max(int(w_lens.max()) if S else 0, 1)
    stream = np.zeros((S, Wmax), dtype=np.uint64)
    for s in range(S):
        lo, hi = mat.slice_offsets[s], mat.slice_offsets[s + 1]
        stream[s, :hi - lo] = mat.stream[lo:hi]

    e_lens = np.diff(mat.esc_offsets, axis=0)  # (S, T)
    Emax = max(int(e_lens.max()) if S else 0, 1)
    esc = np.zeros((T, S, Emax), dtype=np.uint64)
    for t in range(T):
        for s in range(S):
            lo, hi = mat.esc_offsets[s, t], mat.esc_offsets[s + 1, t]
            esc[t, s, :hi - lo] = mat.esc_streams[t][lo:hi]

    nnz = np.zeros((S, L), dtype=np.int32)
    row_valid = np.zeros((S, L), dtype=bool)
    for s in range(S):
        r0, r1 = s * L, min((s + 1) * L, m)
        nnz[s, :r1 - r0] = mat.row_nnz[r0:r1]
        row_valid[s, :r1 - r0] = True
    ns = 2 * nnz

    nsegs = (ns + l - 1) // l
    max_nseg = max(int(nsegs.max()) if S else 0, 1)

    return PackedMatrix(
        stream=stream,
        esc=esc,
        ns=ns.astype(np.int32),
        nnz=nnz,
        row_valid=row_valid,
        tab_symbol=mat.stacked.symbol.astype(np.uint64),
        tab_digit=mat.stacked.digit.astype(np.int32),
        tab_base=mat.stacked.base.astype(np.int32),
        tab_is_esc=mat.stacked.is_esc.astype(np.int32),
        pattern=tuple(int(p) for p in mat.pattern),
        params=mat.params,
        shape=mat.shape,
        dtype=np.dtype(mat.dtype),
        lane_width=L,
        max_nseg=max_nseg,
        shared_cols=getattr(mat, "block_shape", None) is not None,
    )


def torch_dtype(pm: PackedMatrix) -> torch.dtype:
    """Accumulator dtype of the decode kernels for a packed matrix."""
    return torch.float64 if pm.dtype == np.float64 else torch.float32


def check_device(device) -> torch.device:
    """``device`` as a `torch.device`; a CUDA request on a machine without
    a card raises instead of running anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch sees no CUDA card; pass "
                f"device='cpu' to run the plain torch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_rhs(dm, x: torch.Tensor, ndim: int) -> None:
    """Refuses a right-hand side a kernel wrapper does not take: ``dm`` is
    a device matrix with ``shape``, ``dtype`` and ``device``."""
    if x.ndim != ndim or x.shape[0] != dm.shape[1]:
        raise ValueError(f"rhs of shape {tuple(x.shape)} does not fit a "
                         f"{dm.shape} matrix (want {ndim}-D, "
                         f"{dm.shape[1]} rows)")
    if x.dtype != dm.dtype:
        raise TypeError(f"rhs dtype {x.dtype} != matrix dtype {dm.dtype}")
    if x.device != dm.device:
        raise ValueError(f"rhs on {x.device}, matrix on {dm.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def device_cached(pack, device, build):
    """``build(dev)`` for ``pack`` on ``device``, built once per device and
    cached on the pack (a CUDA request without a card raises)."""
    dev = check_device(device)
    cache = getattr(pack, _DEVICE_CACHE_FIELD, None)
    if cache is None:
        cache = {}
        object.__setattr__(pack, _DEVICE_CACHE_FIELD, cache)
    key = str(dev)
    if key not in cache:
        cache[key] = build(dev)
    return cache[key]


def host_tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A numpy array as a contiguous torch tensor on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def to_device(pm: PackedMatrix, device="cuda") -> DeviceMatrix:
    """The pack's tensors on ``device``, built once and cached on ``pm``."""
    def build(dev: torch.device) -> DeviceMatrix:
        def t(a: np.ndarray) -> torch.Tensor:
            return host_tensor(a, dev)
        return DeviceMatrix(
            stream=t(pm.stream.astype(np.uint32).view(np.int32)),
            esc=t(np.ascontiguousarray(pm.esc, dtype=np.uint64)
                  .view(np.int64)),
            ns=t(pm.ns.astype(np.int32)),
            nnz=t(pm.nnz.astype(np.int32)),
            tab_symbol=t(np.ascontiguousarray(pm.tab_symbol, dtype=np.uint64)
                         .view(np.int64)),
            tab_digit=t(pm.tab_digit.astype(np.int32)),
            tab_base=t(pm.tab_base.astype(np.int32)),
            tab_is_esc=t(pm.tab_is_esc.astype(np.int32)),
            tables=t(pack_tables(pm.tab_symbol, pm.tab_digit, pm.tab_base,
                                 pm.tab_is_esc, pm.params)),
            params=pm.params,
            pattern=tuple(pm.pattern),
            max_nseg=int(pm.max_nseg),
            lane_width=int(pm.lane_width),
            shape=tuple(int(v) for v in pm.shape),
            dtype=torch_dtype(pm),
        )
    return device_cached(pm, device, build)
