"""Public entry points of the decode-on-the-fly kernels.

`spmv` is the user-facing  y = A x + y  on a CSR-dtANS matrix: it packs the
format once (cached on the object), moves its tensors to the device once
(cached on the pack, `pack.to_device`), and dispatches to the fused decode
kernel. `spmm` is its multi-RHS sibling: ``x`` is (n, B), the result
(m, B), and the decode is paid once per column tile for all its columns.
B == 1 delegates to `spmv`, so spmm results at B=1 are bitwise equal to it;
B == 0 returns an empty result without reaching a kernel.

Both run on ``device="cuda"`` unless the caller passes ``device="cpu"``;
on the CPU the kernels' plain torch versions run. A CUDA request on a
machine without a card raises.

Not ported yet, and refused with `NotImplementedError` naming the
ROADMAP.md item: `decode` and the SELL / RGCSR / BCSR entry points,
``mesh=`` / ``n_shards > 1``, ``pipeline=True``, ``fused=True`` and packs
with ``shared_cols`` set.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.csr_dtans import CSRdtANS
from repro_torch.kernels import tiling
from repro_torch.kernels.dtans_spmv import dtans_spmm, dtans_spmv
from repro_torch.kernels.pack import (PackedMatrix, pack_matrix, to_device,
                                      torch_dtype)

_PACK_CACHE_FIELD = "_packed_cache"


def _record_pass(kind: str, dm, n: int, m: int, batch: int,
                 itemsize: int, *, decodes: bool = False,
                 col_tiles: int = 1) -> None:
    """One SpMV/SpMM pass into the default metrics registry: call and
    byte counters (the matrix's device tensors once per pass, x/y per RHS)
    plus the batch-size and column-tile histograms. `spmm` delegates B == 1 to `spmv`, so
    exactly one record happens per pass; the byte counters are per pass,
    never per column tile."""
    r = obs.default_registry()
    r.counter("kernels.spmm_calls").add(1)
    r.counter(f"kernels.{kind}_calls").add(1)
    if decodes:
        r.counter("kernels.decode_invocations").add(1)
    r.counter("kernels.matrix_bytes").add(dm.nbytes)
    r.counter("kernels.x_bytes").add(n * batch * itemsize)
    r.counter("kernels.y_bytes").add(m * batch * itemsize)
    r.histogram("kernels.batch_size").observe(batch)
    r.histogram("kernels.col_tiles").observe(col_tiles)


def _resolve_bn(rows: int, batch: int, itemsize: int, bn) -> int | None:
    """Effective column-tile width of one SpMM pass: an explicit ``bn``
    wins (untiled when it covers the whole batch); otherwise the
    shared-memory budget's choice (`tiling.choose_bn`)."""
    if bn is not None:
        b = int(bn)
        if b < 1:
            raise ValueError(f"bn must be >= 1; got {bn}")
        return None if b >= batch else b
    return tiling.choose_bn(rows, batch, itemsize)


def _n_tiles(batch: int, bn: int | None) -> int:
    return 1 if bn is None else -(-batch // bn)


#: Accumulator dtype of the decode kernels for a packed matrix.
out_dtype = torch_dtype


def get_packed(mat: CSRdtANS) -> PackedMatrix:
    pm = getattr(mat, _PACK_CACHE_FIELD, None)
    if pm is None:
        pm = pack_matrix(mat)
        object.__setattr__(mat, _PACK_CACHE_FIELD, pm)
    return pm


def _refuse(mesh, n_shards, pipeline, fused, pm: PackedMatrix) -> None:
    """Knobs of the JAX package's entry points that this port does not run
    yet: each raises rather than being ignored."""
    if mesh is not None or (n_shards is not None and int(n_shards) != 1):
        raise NotImplementedError(
            "sharded spmv/spmm (mesh= / n_shards > 1) is not ported yet "
            "(ROADMAP.md queue A item 10)")
    if pipeline:
        raise NotImplementedError(
            "pipeline=True (decode j+1 before contracting j) is not ported "
            "yet (ROADMAP.md queue B items 1-2)")
    if fused or getattr(pm, "shared_cols", False):
        raise NotImplementedError(
            "the fused shared-column contraction (fused=True, shared_cols "
            "packs) is not ported yet (ROADMAP.md queue B items 1-2)")


def spmv(mat: CSRdtANS | PackedMatrix, x, y=None, *, device="cuda",
         mesh=None, n_shards=None, pipeline: bool = False,
         fused=None) -> torch.Tensor:
    """y = A x + y with on-the-fly dtANS decoding (fused decode kernel)."""
    pm = get_packed(mat) if isinstance(mat, CSRdtANS) else mat
    _refuse(mesh, n_shards, pipeline, fused, pm)
    dm = to_device(pm, device)
    m, n = pm.shape
    x = torch.as_tensor(x, dtype=dm.dtype, device=dm.device)
    if x.shape != (n,):
        raise ValueError(f"spmv expects x of shape ({n},); got "
                         f"{tuple(x.shape)} (use spmm for (n, B))")
    _record_pass("dtans_spmv", dm, n, m, 1, pm.dtype.itemsize,
                 decodes=True)
    out = dtans_spmv(dm, x).reshape(-1)[:m]
    if y is not None:
        out = out + torch.as_tensor(y, dtype=dm.dtype, device=dm.device)
    return out


def _check_rhs(x: torch.Tensor, n: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"spmm expects x of shape (n, B); got "
                         f"{tuple(x.shape)} (use spmv for a single 1-D "
                         f"vector)")
    if x.shape[0] != n:
        raise ValueError(f"spmm rhs has {x.shape[0]} rows; matrix has "
                         f"{n} columns")


def _empty_y(m: int, y, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """B == 0 result: a serving pool with zero active requests is a legal
    input and must not reach the kernels (a zero-size grid is not)."""
    out = torch.zeros((m, 0), dtype=dtype, device=device)
    if y is not None:
        out = out + torch.as_tensor(y, dtype=dtype, device=device)
    return out


def spmm(mat: CSRdtANS | PackedMatrix, x, y=None, *, device="cuda",
         mesh=None, n_shards=None, bn=None, pipeline: bool = False,
         fused=None) -> torch.Tensor:
    """Y = A X + Y, X: (n, B) — decode once per column tile, contract all
    its columns in the fused kernel. B == 1 runs the single-vector `spmv`
    kernel, so the results are bitwise equal to it.

    ``bn`` pins the column-tile width (None = `tiling.choose_bn`, untiled
    when the whole batch fits); every tile width
    gives bitwise the same result as the untiled kernel."""
    pm = get_packed(mat) if isinstance(mat, CSRdtANS) else mat
    _refuse(mesh, n_shards, pipeline, fused, pm)
    dm = to_device(pm, device)
    m, n = pm.shape
    x = torch.as_tensor(x, dtype=dm.dtype, device=dm.device)
    _check_rhs(x, n)
    B = x.shape[1]
    if B == 0:
        return _empty_y(m, y, dm.dtype, dm.device)
    if B == 1:
        out = spmv(pm, x[:, 0], device=dm.device)[:, None]
    else:
        bn_eff = _resolve_bn(pm.lane_width, B, pm.dtype.itemsize, bn)
        _record_pass("dtans_spmm", dm, n, m, B, pm.dtype.itemsize,
                     decodes=True, col_tiles=_n_tiles(B, bn_eff))
        out = dtans_spmm(dm, x, bn=bn_eff).reshape(-1, B)[:m]
    if y is not None:
        out = out + torch.as_tensor(y, dtype=dm.dtype, device=dm.device)
    return out


def _not_ported(name: str, item: str):
    def entry(*args, **kwargs):
        raise NotImplementedError(
            f"ops.{name} is not ported to PyTorch/CUDA yet ({item})")
    entry.__name__ = name
    entry.__doc__ = f"Not ported yet: raises NotImplementedError ({item})."
    return entry


decode = _not_ported("decode", "ROADMAP.md queue B item 3")
sell_spmv = _not_ported("sell_spmv", "ROADMAP.md queue B item 4")
sell_spmm = _not_ported("sell_spmm", "ROADMAP.md queue B item 5")
rgcsr_spmv = _not_ported("rgcsr_spmv", "ROADMAP.md queue B item 6")
rgcsr_spmm = _not_ported("rgcsr_spmm", "ROADMAP.md queue B item 7")
bcsr_spmv = _not_ported("bcsr_spmv", "ROADMAP.md queue B item 8")
bcsr_spmm = _not_ported("bcsr_spmm", "ROADMAP.md queue B item 9")
