"""Carry a compressed layer across from the JAX package.

A `SparseLinear` of either package is described completely by the numpy
fields of its `CSRdtANS` (the encoded bitstream, escape streams, offsets
and coding tables) plus a few sizes. `sparse_linear_to_arrays` flattens
those into a dict of numpy arrays with string keys (so ``np.savez`` can
store it), reading attributes only: it works on the JAX package's objects
and on this package's alike, without importing either's framework.
`sparse_linear_from_arrays` rebuilds this package's `CSRdtANS`,
`PackedMatrix` and `SparseLinear` from such a dict. No bit is re-encoded:
the rebuilt stream is the reference's stream.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.csr_dtans import CSRdtANS
from repro_torch.core.dtans_vec import StackedTables
from repro_torch.core.params import DtansParams
from repro_torch.core.tables import CodingTable
from repro_torch.kernels.pack import check_device, pack_matrix, to_device
from repro_torch.serving.sparse_linear import SparseLinear

_PARAM_FIELDS = ("w_bits", "k_bits", "l", "o", "f", "m_bits")
_MAT_ARRAYS = ("stream", "slice_offsets", "esc_offsets", "row_nnz",
               "esc_count_by_domain", "pattern", "domain")
_TABLE_ARRAYS = ("slot_symbol", "slot_digit", "slot_base", "slot_is_esc")
_TABLE_SCALARS = ("esc_first", "esc_base", "esc_raw_bits", "K", "M",
                  "used_slots")
_LAYER_SCALARS = ("d_in", "d_out", "dense_bytes", "baseline_bytes")


def sparse_linear_to_arrays(sl) -> dict:
    """Flatten a `SparseLinear` (of either package) into numpy arrays."""
    mat = sl.mat
    out = {f: np.asarray(getattr(mat, f)) for f in _MAT_ARRAYS}
    out["params"] = np.asarray([getattr(mat.params, f)
                                for f in _PARAM_FIELDS], dtype=np.int64)
    out["lane_width"] = np.asarray(mat.lane_width, dtype=np.int64)
    out["shape"] = np.asarray(mat.shape, dtype=np.int64)
    out["dtype"] = np.asarray(np.dtype(mat.dtype).name)
    out["n_tables"] = np.asarray(len(mat.tables), dtype=np.int64)
    for t, e in enumerate(mat.esc_streams):
        out[f"esc_streams.{t}"] = np.asarray(e)
    for t, tab in enumerate(mat.tables):
        for f in _TABLE_ARRAYS:
            out[f"tables.{t}.{f}"] = np.asarray(getattr(tab, f))
        for f in _TABLE_SCALARS:
            out[f"tables.{t}.{f}"] = np.asarray(int(getattr(tab, f)),
                                                dtype=np.int64)
    for f in _LAYER_SCALARS:
        out[f] = np.asarray(int(getattr(sl, f)), dtype=np.int64)
    return out


def _table(arrays: dict, t: int) -> CodingTable:
    a = {f: np.asarray(arrays[f"tables.{t}.{f}"]) for f in _TABLE_ARRAYS}
    s = {f: int(arrays[f"tables.{t}.{f}"]) for f in _TABLE_SCALARS}
    # encode-side inverse: first slot of every in-table symbol
    used = s["used_slots"]
    first_slot: dict = {}
    for pos in range(used):
        if not a["slot_is_esc"][pos] and a["slot_digit"][pos] == 0:
            first_slot[int(a["slot_symbol"][pos])] = pos
    return CodingTable(
        slot_symbol=a["slot_symbol"].astype(np.uint64),
        slot_digit=a["slot_digit"].astype(np.uint32),
        slot_base=a["slot_base"].astype(np.uint32),
        slot_is_esc=a["slot_is_esc"].astype(bool),
        first_slot=first_slot, **s)


def sparse_linear_from_arrays(arrays: dict, *, device="cuda"
                              ) -> SparseLinear:
    """Rebuild a `SparseLinear` on ``device`` from
    `sparse_linear_to_arrays` output (or an ``np.load`` of its ``.npz``)."""
    dev = check_device(device)
    params = DtansParams(**{f: int(v) for f, v in
                            zip(_PARAM_FIELDS, arrays["params"])})
    tables = [_table(arrays, t) for t in range(int(arrays["n_tables"]))]
    mat = CSRdtANS(
        params=params,
        pattern=np.asarray(arrays["pattern"], dtype=np.int64),
        domain=np.asarray(arrays["domain"]),
        tables=tables,
        stacked=StackedTables.stack(tables),
        lane_width=int(arrays["lane_width"]),
        shape=tuple(int(v) for v in arrays["shape"]),
        dtype=np.dtype(str(arrays["dtype"])),
        stream=np.asarray(arrays["stream"], dtype=np.uint64),
        slice_offsets=np.asarray(arrays["slice_offsets"], dtype=np.int64),
        esc_streams=[np.asarray(arrays[f"esc_streams.{t}"], dtype=np.uint64)
                     for t in range(len(tables))],
        esc_offsets=np.asarray(arrays["esc_offsets"], dtype=np.int64),
        row_nnz=np.asarray(arrays["row_nnz"], dtype=np.int64),
        esc_count_by_domain=np.asarray(arrays["esc_count_by_domain"],
                                       dtype=np.int64),
    )
    sl = SparseLinear(mat=mat, packed=pack_matrix(mat),
                      device=dev, **{f: int(arrays[f])
                                     for f in _LAYER_SCALARS})
    to_device(sl.packed, dev)
    return sl
