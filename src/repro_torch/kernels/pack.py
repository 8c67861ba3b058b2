"""Pack a CSRdtANS matrix into dense, kernel-ready arrays.

The production format stores one flat stream with per-slice offsets. The
kernels index every slice at a fixed stride, so we pad every slice's
stream (and escape stream) to the matrix-wide maximum and expose them as
(n_slices, max_*) arrays. The padding is address padding only — it is NOT
counted in the format's compressed size (CSRdtANS.nbytes).

`PackedMatrix` stays numpy and byte-equal to the JAX package's pack.
`to_device` builds the torch tensors the kernels read, once per device,
and caches them on the packed object (as `ops.get_packed` caches the pack
on the matrix).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.csr_dtans import CSRdtANS
from repro_torch.core.params import DtansParams

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
    # in-bounds lane of a slice decodes the SAME column sequence. Not
    # produced by this package yet; the ops refuse such a pack.
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
        """Bytes of the tensors the kernels read: the matrix-side traffic
        of one pass (padded device arrays, not the compressed wire size)."""
        return sum(int(t.nbytes) for t in (
            self.stream, self.esc, self.ns, self.nnz, self.tab_symbol,
            self.tab_digit, self.tab_base, self.tab_is_esc))


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


def to_device(pm: PackedMatrix, device="cuda") -> DeviceMatrix:
    """The pack's tensors on ``device``, built once and cached on ``pm``."""
    dev = check_device(device)
    cache = getattr(pm, _DEVICE_CACHE_FIELD, None)
    if cache is None:
        cache = {}
        object.__setattr__(pm, _DEVICE_CACHE_FIELD, cache)
    key = str(dev)
    dm = cache.get(key)
    if dm is None:
        def t(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        dm = DeviceMatrix(
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
            params=pm.params,
            pattern=tuple(pm.pattern),
            max_nseg=int(pm.max_nseg),
            lane_width=int(pm.lane_width),
            shape=tuple(int(v) for v in pm.shape),
            dtype=torch_dtype(pm),
        )
        cache[key] = dm
    return dm
