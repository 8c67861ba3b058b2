"""CSR-dtANS: the paper's entropy-coded sparse-matrix format (Section IV).

Pipeline (Fig. 1): CSR -> per-row delta-encoding of column indices ->
(delta, value)-interleaved symbol stream per row -> dtANS entropy coding ->
per-slice consumption-order interleaving of ``lane_width`` row streams.

Paper-faithful configuration: ONE coding table shared by the delta and value
domains (matches the 64 KB / 48 KB constant table budget of Fig. 6), slice
width 32 (GPU warp). Default here: slice width 128 (four warps per slice).
`shared_table=False` builds separate per-domain tables — a beyond-paper
variant.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.delta import delta_encode_rows
from repro_torch.core.dtans import EncodedStream, encode_scalar
from repro_torch.core.dtans_vec import (InterleavedSlice, StackedTables,
                                  decode_lanes,
                                  interleave_slice_with_pattern)
from repro_torch.core.params import PAPER, DtansParams
from repro_torch.core.tables import CodingTable, build_table
from repro_torch.sparse.formats import CSR

DELTA, VALUE = 0, 1  # domain ids


def _value_bits(dtype: np.dtype) -> int:
    return np.dtype(dtype).itemsize * 8


def _to_bits(values: np.ndarray) -> np.ndarray:
    dt = values.dtype
    if dt == np.float64:
        return values.view(np.uint64)
    if dt == np.float32:
        return values.view(np.uint32).astype(np.uint64)
    raise TypeError(f"unsupported value dtype {dt}")


def _from_bits(bits: np.ndarray, dtype: np.dtype) -> np.ndarray:
    if np.dtype(dtype) == np.float64:
        return bits.view(np.float64)
    if np.dtype(dtype) == np.float32:
        return bits.astype(np.uint32).view(np.float32)
    raise TypeError(f"unsupported value dtype {dtype}")


@dataclasses.dataclass
class CSRdtANS:
    params: DtansParams
    pattern: np.ndarray            # (l,) table index per in-segment position
    domain: np.ndarray             # (l,) DELTA/VALUE per position
    tables: list[CodingTable]
    stacked: StackedTables
    lane_width: int
    shape: tuple[int, int]
    dtype: np.dtype
    stream: np.ndarray             # uint64 (<2^32), all slices concatenated
    slice_offsets: np.ndarray      # (nslices+1,)
    esc_streams: list[np.ndarray]  # per table, uint64
    esc_offsets: np.ndarray        # (nslices+1, T)
    row_nnz: np.ndarray            # (m,)
    esc_count_by_domain: np.ndarray  # (2,) [delta, value] escapes

    @property
    def nnz(self) -> int:
        return int(self.row_nnz.sum())

    @property
    def n_slices(self) -> int:
        return int(self.slice_offsets.size - 1)

    @property
    def nbytes(self) -> int:
        """Byte-exact size, paper accounting (Fig. 6):
        tables + 4-byte stream words + escaped raws + one 4-byte length per
        row + per-slice offsets."""
        vb = self.dtype.itemsize
        b = sum(t.nbytes(vb) for t in self.tables)
        b += int(self.stream.size) * 4
        b += int(self.esc_count_by_domain[DELTA]) * 4
        b += int(self.esc_count_by_domain[VALUE]) * vb
        b += self.shape[0] * 4                      # per-row n
        b += (self.n_slices + 1) * 8                # stream offsets
        b += (self.n_slices + 1) * 4 * len(self.tables)  # escape offsets
        return b


def encode_matrix(a: CSR, params: DtansParams = PAPER,
                  lane_width: int = 128,
                  shared_table: bool = True) -> CSRdtANS:
    """Compress a CSR matrix into CSR-dtANS."""
    l = params.l
    if l % 2 != 0:
        raise ValueError("l must be even: (delta, value) pairs per nonzero")
    m, _ = a.shape
    deltas = delta_encode_rows(a.indptr, a.indices).astype(np.uint64)
    vbits = _to_bits(np.ascontiguousarray(a.values))
    value_bits = _value_bits(a.values.dtype)

    domain = np.tile(np.asarray([DELTA, VALUE]), l // 2)
    if shared_table:
        pattern = np.zeros(l, dtype=np.int64)
        syms, counts = np.unique(np.concatenate([deltas, vbits]),
                                 return_counts=True)
        tables = [build_table(syms, counts, params,
                              esc_raw_bits=max(32, value_bits))]
    else:
        pattern = np.tile(np.asarray([0, 1]), l // 2).astype(np.int64)
        ds, dc = np.unique(deltas, return_counts=True)
        vs, vc = np.unique(vbits, return_counts=True)
        tables = [build_table(ds, dc, params, esc_raw_bits=32),
                  build_table(vs, vc, params, esc_raw_bits=value_bits)]
    T = len(tables)

    n_slices = (m + lane_width - 1) // lane_width
    stream_chunks, esc_chunks = [], [[] for _ in range(T)]
    slice_offsets = np.zeros(n_slices + 1, dtype=np.int64)
    esc_offsets = np.zeros((n_slices + 1, T), dtype=np.int64)
    esc_by_domain = np.zeros(2, dtype=np.int64)
    row_nnz = np.diff(a.indptr).astype(np.int64)

    for s in range(n_slices):
        r0, r1 = s * lane_width, min((s + 1) * lane_width, m)
        encs: list[EncodedStream] = []
        for i in range(r0, r1):
            lo, hi = int(a.indptr[i]), int(a.indptr[i + 1])
            u = np.empty(2 * (hi - lo), dtype=np.uint64)
            u[0::2] = deltas[lo:hi]
            u[1::2] = vbits[lo:hi]
            enc = encode_scalar(u, params, tables, pattern)
            if enc.esc_mask is not None and enc.esc_mask.any():
                em = enc.esc_mask
                pos_dom = domain[np.arange(em.size) % l]
                esc_by_domain[DELTA] += int((em & (pos_dom == DELTA)).sum())
                esc_by_domain[VALUE] += int((em & (pos_dom == VALUE)).sum())
            encs.append(enc)
        sl = interleave_slice_with_pattern(encs, params, pattern, T)
        stream_chunks.append(sl.stream)
        slice_offsets[s + 1] = slice_offsets[s] + sl.stream.size
        for t in range(T):
            esc_chunks[t].append(sl.esc_streams[t])
            esc_offsets[s + 1, t] = (esc_offsets[s, t]
                                     + sl.esc_streams[t].size)

    return CSRdtANS(
        params=params, pattern=pattern, domain=domain, tables=tables,
        stacked=StackedTables.stack(tables), lane_width=lane_width,
        shape=a.shape, dtype=a.values.dtype,
        stream=(np.concatenate(stream_chunks) if stream_chunks
                else np.zeros(0, dtype=np.uint64)),
        slice_offsets=slice_offsets,
        esc_streams=[(np.concatenate(c) if c else np.zeros(0, np.uint64))
                     for c in esc_chunks],
        esc_offsets=esc_offsets,
        row_nnz=row_nnz,
        esc_count_by_domain=esc_by_domain,
    )


def _decode_slice(mat: CSRdtANS, s: int) -> tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """Decode slice ``s`` -> (cols, vals, mask), each (lanes, max_nnz)."""
    m = mat.shape[0]
    r0, r1 = s * mat.lane_width, min((s + 1) * mat.lane_width, m)
    ns = 2 * mat.row_nnz[r0:r1]
    sl = InterleavedSlice(
        stream=mat.stream[mat.slice_offsets[s]:mat.slice_offsets[s + 1]],
        esc_streams=[mat.esc_streams[t][mat.esc_offsets[s, t]:
                                        mat.esc_offsets[s + 1, t]]
                     for t in range(len(mat.tables))],
        ns=ns,
    )
    out = decode_lanes(sl, mat.params, mat.stacked, mat.pattern)
    if out.shape[1] == 0:
        z = np.zeros((r1 - r0, 0))
        return z.astype(np.int64), z.astype(mat.dtype), z.astype(bool)
    deltas = out[:, 0::2]
    vbits = out[:, 1::2]
    nnz = mat.row_nnz[r0:r1][:, None]
    mask = np.arange(deltas.shape[1])[None, :] < nnz
    cols = np.cumsum(np.where(mask, deltas, 0), axis=1).astype(np.int64)
    vals = _from_bits(vbits.copy(), mat.dtype)
    return cols, np.where(mask, vals, 0).astype(mat.dtype), mask


def decode_matrix(mat: CSRdtANS) -> CSR:
    """Lossless reconstruction of the original CSR matrix."""
    m, n = mat.shape
    indptr = np.zeros(m + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(mat.row_nnz)
    indices = np.zeros(int(mat.row_nnz.sum()), dtype=np.int64)
    values = np.zeros(indices.size, dtype=mat.dtype)
    for s in range(mat.n_slices):
        r0 = s * mat.lane_width
        cols, vals, mask = _decode_slice(mat, s)
        for i in range(cols.shape[0]):
            lo, hi = indptr[r0 + i], indptr[r0 + i + 1]
            indices[lo:hi] = cols[i, :hi - lo]
            values[lo:hi] = vals[i, :hi - lo]
    return CSR(indptr=indptr, indices=indices, values=values,
               shape=mat.shape)


def spmv_gold(mat: CSRdtANS, x: np.ndarray,
              y: np.ndarray | None = None) -> np.ndarray:
    """Gold y = A x + y via on-the-fly decode (numpy, lock-step lanes)."""
    m, n = mat.shape
    assert x.shape == (n,)
    out = np.zeros(m, dtype=mat.dtype) if y is None else y.copy()
    for s in range(mat.n_slices):
        r0 = s * mat.lane_width
        cols, vals, mask = _decode_slice(mat, s)
        if cols.shape[1] == 0:
            continue
        contrib = np.where(mask, vals * x[np.minimum(cols, n - 1)], 0)
        out[r0:r0 + cols.shape[0]] += contrib.sum(axis=1).astype(mat.dtype)
    return out
