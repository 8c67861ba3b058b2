"""Carry a compressed layer across from the JAX package.

A `SparseLinear` of either package is described completely by the numpy
fields of its `CSRdtANS` (the encoded bitstream, escape streams, offsets
and coding tables) plus a few sizes. `sparse_linear_to_arrays` flattens
those into a dict of numpy arrays with string keys (so ``np.savez`` can
store it), reading attributes only: it works on the JAX package's objects
and on this package's alike, without importing either's framework.
`sparse_linear_from_arrays` rebuilds this package's `CSRdtANS`,
`PackedMatrix` and `SparseLinear` from such a dict. No bit is re-encoded:
the rebuilt stream is the reference's stream. A matrix that is a
`BCSRdtANS` carries its ``block_shape`` and ``n_blocks`` across and comes
back as one, so its pack keeps ``shared_cols`` and serves through the
fused contraction.

`packed_sell_to_arrays` / `packed_rgcsr_to_arrays` /
`packed_bcsr_to_arrays` do the same for a packed uncompressed comparator
(`PackedSELL`, `PackedRGCSR`, `PackedBCSR`) of either package, and the
``*_from_arrays`` pair rebuilds this package's pack and uploads it.

`model_from_jax_params` carries a model's weights across: the JAX
package's parameter tree, as numpy arrays, becomes this package's model of
the same family (`api.build_model`) with the same weights;
`jax_tree_from_model` carries a model's weights, or their gradients, back
into that tree. Both take a model distributed for tensor parallelism
(`api.distribute`): ``mesh=`` places the carried weights, and DTensor
leaves are gathered whole on the way back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bcsr_dtans import BCSRdtANS
from repro_torch.core.csr_dtans import CSRdtANS
from repro_torch.core.dtans_vec import StackedTables
from repro_torch.core.params import DtansParams
from repro_torch.core.tables import CodingTable
from repro_torch.kernels import bcsr_spmv, rgcsr_spmv, sell_spmv
from repro_torch.kernels.bcsr_spmv import PackedBCSR
from repro_torch.kernels.pack import check_device, pack_matrix, to_device
from repro_torch.kernels.rgcsr_spmv import PackedRGCSR
from repro_torch.kernels.sell_spmv import PackedSELL
from repro_torch.models import api
from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import full
from repro_torch.serving.sparse_linear import SparseLinear

_PARAM_FIELDS = ("w_bits", "k_bits", "l", "o", "f", "m_bits")
_MAT_ARRAYS = ("stream", "slice_offsets", "esc_offsets", "row_nnz",
               "esc_count_by_domain", "pattern", "domain")
_TABLE_ARRAYS = ("slot_symbol", "slot_digit", "slot_base", "slot_is_esc")
_TABLE_SCALARS = ("esc_first", "esc_base", "esc_raw_bits", "K", "M",
                  "used_slots")
_LAYER_SCALARS = ("d_in", "d_out", "dense_bytes", "baseline_bytes")
_SELL_ARRAYS = ("indices", "values")
_RGCSR_ARRAYS = ("deltas", "values", "nnz")
_BCSR_ARRAYS = ("block_cols", "values")


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
    if getattr(mat, "block_shape", None) is not None:      # a BCSRdtANS
        out["block_shape"] = np.asarray(mat.block_shape, dtype=np.int64)
        out["n_blocks"] = np.asarray(int(mat.n_blocks), dtype=np.int64)
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
    blocked = {}
    cls = CSRdtANS
    if "block_shape" in arrays:
        cls = BCSRdtANS
        blocked = dict(
            block_shape=tuple(int(v) for v in arrays["block_shape"]),
            n_blocks=int(arrays["n_blocks"]))
    mat = cls(
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
        **blocked,
    )
    sl = SparseLinear(mat=mat, packed=pack_matrix(mat),
                      device=dev, **{f: int(arrays[f])
                                     for f in _LAYER_SCALARS})
    to_device(sl.packed, dev)
    return sl


def _pack_to_arrays(p, fields: tuple, rows_field: str) -> dict:
    out = {f: np.asarray(getattr(p, f)) for f in fields}
    out["shape"] = np.asarray(p.shape, dtype=np.int64)
    out[rows_field] = np.asarray(int(getattr(p, rows_field)), dtype=np.int64)
    return out


def packed_sell_to_arrays(ps) -> dict:
    """Flatten a `PackedSELL` (of either package) into numpy arrays."""
    return _pack_to_arrays(ps, _SELL_ARRAYS, "lane_width")


def packed_sell_from_arrays(arrays: dict, *, device="cuda") -> PackedSELL:
    """This package's `PackedSELL` from `packed_sell_to_arrays` output,
    uploaded to ``device``."""
    ps = PackedSELL(indices=np.asarray(arrays["indices"], dtype=np.int32),
                    values=np.asarray(arrays["values"]),
                    shape=tuple(int(v) for v in arrays["shape"]),
                    lane_width=int(arrays["lane_width"]))
    sell_spmv.to_device(ps, device)
    return ps


def packed_rgcsr_to_arrays(pr) -> dict:
    """Flatten a `PackedRGCSR` (of either package) into numpy arrays."""
    return _pack_to_arrays(pr, _RGCSR_ARRAYS, "group_size")


def packed_rgcsr_from_arrays(arrays: dict, *,
                             device="cuda") -> PackedRGCSR:
    """This package's `PackedRGCSR` from `packed_rgcsr_to_arrays` output,
    uploaded to ``device``."""
    pr = PackedRGCSR(deltas=np.asarray(arrays["deltas"], dtype=np.int32),
                     values=np.asarray(arrays["values"]),
                     nnz=np.asarray(arrays["nnz"], dtype=np.int32),
                     shape=tuple(int(v) for v in arrays["shape"]),
                     group_size=int(arrays["group_size"]))
    rgcsr_spmv.to_device(pr, device)
    return pr


def packed_bcsr_to_arrays(pb) -> dict:
    """Flatten a `PackedBCSR` (of either package) into numpy arrays."""
    out = {f: np.asarray(getattr(pb, f)) for f in _BCSR_ARRAYS}
    out["shape"] = np.asarray(pb.shape, dtype=np.int64)
    out["block_shape"] = np.asarray(pb.block_shape, dtype=np.int64)
    return out


def packed_bcsr_from_arrays(arrays: dict, *, device="cuda") -> PackedBCSR:
    """This package's `PackedBCSR` from `packed_bcsr_to_arrays` output,
    uploaded to ``device``."""
    pb = PackedBCSR(block_cols=np.asarray(arrays["block_cols"],
                                          dtype=np.int32),
                    values=np.asarray(arrays["values"]),
                    shape=tuple(int(v) for v in arrays["shape"]),
                    block_shape=tuple(int(v) for v in arrays["block_shape"]))
    bcsr_spmv.to_device(pb, device)
    return pb


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _load(p: torch.Tensor, a: np.ndarray, name: str) -> None:
    if tuple(a.shape) != tuple(p.shape):
        raise RuntimeError(f"{name}: shape {tuple(a.shape)}, the model's "
                           f"is {tuple(p.shape)}")
    if a.dtype.name == "bfloat16":         # ml_dtypes: no torch view
        a = a.astype(np.float32)
    with torch.no_grad():
        p.copy_(torch.from_numpy(np.array(a)))


def model_from_jax_params(cfg: ArchConfig, params: dict, *, device="cuda",
                          mesh=None, **rules_kw):
    """This package's model of ``cfg`` holding the weights of the JAX
    package's ``params`` (``init_params``'s tree with its leaves as numpy
    arrays: ``jax.tree.map(np.asarray, params)``, done by the caller).
    With a `DeviceMesh` ``mesh`` (every rank passing the same ``params``)
    the model is then placed on it for tensor parallelism,
    `api.distribute(model, cfg, mesh, **rules_kw)`.

    The leaves are matched by `api.reference_leaves`: the reference stacks
    each layer leaf over the layers (``vmap``), so leaf ``layers.attn.wq``
    of shape (n_layers, d, H*hd) fills ``layers.<i>.attn.wq`` for each i,
    and so do the encdec family's ``enc_layers.*`` and ``dec_layers.*``
    over ``n_enc_layers`` and ``n_dec_layers`` (each ``or n_layers``); the
    hybrid family's one ``shared_attn`` block is not stacked. A tied
    config takes no ``head``, an untied one needs it, and a moe config's
    ``router``, ``wi``, ``wg``, ``wo`` carry across the same way: every
    weight of the model must be given exactly once, at its shape, or this
    raises. bfloat16 leaves go through float32 (exactly); float32 leaves
    (the SSM's ``A_log``, ``D``, ``dt_bias``) stay float32."""
    model = api.build_model(cfg, generator=torch.Generator().manual_seed(0),
                            device=device)
    leaves = api.reference_leaves(model, cfg)
    flat = _flatten(params)
    extra = sorted(set(flat) - set(leaves))
    missing = sorted(set(leaves) - set(flat))
    if extra or missing:
        raise RuntimeError(f"weights the model lacks: {extra}; weights "
                           f"not given: {missing}")
    for name, p in leaves.items():
        a = flat[name]
        if isinstance(p, list):
            if a.shape[0] != len(p):
                raise ValueError(f"{name}: {a.shape[0]} stacked layers, "
                                 f"config has {len(p)}")
            for i, t in enumerate(p):
                _load(t, a[i], f"{name}[{i}]")
        else:
            _load(p, a, name)
    if mesh is not None:
        api.distribute(model, cfg, mesh, **rules_kw)
    return model


def jax_tree_from_model(cfg: ArchConfig, model, *, grads: bool = False
                        ) -> dict:
    """The inverse of `model_from_jax_params`: the model's weights (with
    ``grads=True`` their ``.grad``, zeros where a parameter has none) as
    the reference's nested parameter tree of numpy arrays, each layer leaf
    stacked over its layers. bfloat16 tensors come back as float32
    (exactly). A distributed model's DTensor leaves come back whole
    (`sharding.full`), on every rank."""
    def host(p: torch.Tensor) -> np.ndarray:
        t = p.grad if grads else p
        t = torch.zeros_like(p) if t is None else t.detach()
        t = full(t)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    tree: dict = {}
    for name, p in api.reference_leaves(model, cfg).items():
        a = (np.stack([host(t) for t in p]) if isinstance(p, list)
             else host(p))
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree
