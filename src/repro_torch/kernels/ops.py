"""Public entry points of the decode-on-the-fly kernels.

`spmv` is the user-facing  y = A x + y  on a CSR-dtANS matrix: it packs the
format once (cached on the object), moves its tensors to the device once
(cached on the pack, `pack.to_device`), and dispatches to the fused decode
kernel. `spmm` is its multi-RHS sibling: ``x`` is (n, B), the result
(m, B), and the decode is paid once per column tile for all its columns.
B == 1 delegates to `spmv`, so spmm results at B=1 are bitwise equal to it;
B == 0 returns an empty result without reaching a kernel.

The uncompressed comparators share that ``(mat, x, y=None)`` signature:
`sell_spmv` / `sell_spmm` on a `PackedSELL`, `rgcsr_spmv` /
`rgcsr_spmm` on a `PackedRGCSR` and `bcsr_spmv` / `bcsr_spmm` on a
`PackedBCSR`, with the same B == 0 and B == 1 rules. An `RGCSRdtANS` or a
`BCSRdtANS` is a `CSRdtANS` and runs through `spmv` / `spmm`; a
BCSR-dtANS pack has ``shared_cols`` set, and ``fused`` (`_resolve_fused`)
then runs the fused shared-column contraction, bitwise equal to the
generic one. `decode` decompresses a CSR-dtANS matrix through the
decode-only kernel.

All run on ``device="cuda"`` unless the caller passes ``device="cpu"``;
on the CPU the kernels' plain torch versions run. A CUDA request on a
machine without a card raises.

``pipeline=True`` (the reference's decode-ahead schedule, decode segment
j + 1 before contracting j) is accepted by `spmv` / `spmm`: the CUDA
kernels always run that schedule, in the same contraction order, so both
values launch the same kernels and give the same bits (on the CPU the
plain versions run either way). Not ported yet, and refused with
`NotImplementedError` naming ROADMAP.md A6: ``mesh=`` / ``n_shards > 1``.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.csr_dtans import CSRdtANS
from repro_torch.kernels import bcsr_spmv as _bcsr
from repro_torch.kernels import rgcsr_spmv as _rgcsr
from repro_torch.kernels import sell_spmv as _sell
from repro_torch.kernels import tiling
from repro_torch.kernels.bcsr_spmv import PackedBCSR
from repro_torch.kernels.dtans_decode import dtans_decode
from repro_torch.kernels.dtans_spmv import dtans_spmm, dtans_spmv
from repro_torch.kernels.pack import (PackedMatrix, pack_matrix, to_device,
                                      torch_dtype)
from repro_torch.kernels.rgcsr_spmv import PackedRGCSR
from repro_torch.kernels.sell_spmv import PackedSELL

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


def _resolve_bn(batch: int, bn, choose, widest: int | None = None
                ) -> int | None:
    """Effective column-tile width of one SpMM pass: an explicit ``bn``
    wins (untiled when it covers the whole batch); otherwise the kernel's
    ``choose`` (batch -> tile). A tile wider than ``widest`` (a whole
    batch included) is cut to ``widest``: every tile width gives the
    untiled bits."""
    if bn is not None:
        b = int(bn)
        if b < 1:
            raise ValueError(f"bn must be >= 1; got {bn}")
        bt = None if b >= batch else b
    else:
        bt = choose(batch)
    if widest is not None and (batch if bt is None else bt) > widest:
        bt = int(widest)
    return bt


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


def _refuse(mesh, n_shards) -> None:
    """Knobs of the JAX package's entry points that this port does not run
    yet: each raises rather than being ignored."""
    if mesh is not None or (n_shards is not None and int(n_shards) != 1):
        raise NotImplementedError(
            "sharded spmv/spmm (mesh= / n_shards > 1) is not ported yet "
            "(ROADMAP.md A6)")


def _resolve_fused(pm: PackedMatrix, fused) -> bool:
    """Whether this pass runs the shared-column (fused block-decode)
    contraction: ``fused=None`` follows the pack's ``shared_cols`` flag
    (BCSR-dtANS encodes fuse, everything else doesn't); ``fused=False``
    forces the generic path (the comparator); ``fused=True`` on a pack that
    is not block-filled is an error, since lanes with distinct columns
    cannot share lane 0's gather."""
    shared = bool(getattr(pm, "shared_cols", False))
    if fused is None:
        return shared
    if fused and not shared:
        raise ValueError(
            "fused=True needs a block-filled (shared-column) pack; only "
            "BCSR-dtANS encodes set PackedMatrix.shared_cols")
    return bool(fused)


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


def _one_rhs(kind: str, dm, x, y, run, *, decodes: bool = False
             ) -> torch.Tensor:
    """Body of every single-vector entry point: ``run(x)`` gives the padded
    rows of A x; ``y`` is added after the kernel."""
    m, n = dm.shape
    x = torch.as_tensor(x, dtype=dm.dtype, device=dm.device)
    if x.shape != (n,):
        raise ValueError(f"spmv expects x of shape ({n},); got "
                         f"{tuple(x.shape)} (use spmm for (n, B))")
    _record_pass(kind, dm, n, m, 1, x.element_size(), decodes=decodes)
    out = run(x).reshape(-1)[:m]
    if y is not None:
        out = out + torch.as_tensor(y, dtype=dm.dtype, device=dm.device)
    return out


def _many_rhs(kind: str, dm, x, y, bn, one, run, choose, *,
              decodes: bool = False, widest: int | None = None
              ) -> torch.Tensor:
    """Body of every multi-RHS entry point: B == 0 returns `_empty_y`,
    B == 1 calls the single-vector entry ``one`` (bitwise equal to it),
    otherwise ``run(x, bn)`` gives the padded rows of A X in column tiles
    of the resolved ``bn`` (`_resolve_bn`: an explicit one, else the
    kernel's ``choose``, at most ``widest``)."""
    m, n = dm.shape
    x = torch.as_tensor(x, dtype=dm.dtype, device=dm.device)
    _check_rhs(x, n)
    B = x.shape[1]
    if B == 0:
        return _empty_y(m, y, dm.dtype, dm.device)
    if B == 1:
        out = one(x[:, 0])[:, None]
    else:
        bn_eff = _resolve_bn(B, bn, choose, widest)
        _record_pass(kind, dm, n, m, B, x.element_size(), decodes=decodes,
                     col_tiles=_n_tiles(B, bn_eff))
        out = run(x, bn_eff).reshape(-1, B)[:m]
    if y is not None:
        out = out + torch.as_tensor(y, dtype=dm.dtype, device=dm.device)
    return out


def spmv(mat: CSRdtANS | PackedMatrix, x, y=None, *, device="cuda",
         mesh=None, n_shards=None, pipeline: bool = False,
         fused=None) -> torch.Tensor:
    """y = A x + y with on-the-fly dtANS decoding (fused decode kernel).

    ``fused`` selects the shared-column contraction (None: the pack's own
    ``shared_cols`` flag); it gives bitwise the generic result.
    ``pipeline`` names the reference's decode-ahead schedule, which the
    kernel always runs: both values give the same bits."""
    pm = get_packed(mat) if isinstance(mat, CSRdtANS) else mat
    _refuse(mesh, n_shards)
    shared = _resolve_fused(pm, fused)
    dm = to_device(pm, device)
    return _one_rhs("dtans_spmv", dm, x, y,
                    lambda v: dtans_spmv(dm, v, shared_cols=shared),
                    decodes=True)


def spmm(mat: CSRdtANS | PackedMatrix, x, y=None, *, device="cuda",
         mesh=None, n_shards=None, bn=None, pipeline: bool = False,
         fused=None) -> torch.Tensor:
    """Y = A X + Y, X: (n, B) — decode once per column tile, contract all
    its columns in the fused kernel. B == 1 runs the single-vector `spmv`
    kernel, so the results are bitwise equal to it.

    ``bn`` pins the column-tile width (None = `tiling.dtans_bn`, untiled
    when the whole batch fits); a tile whose shared-memory plan does not
    fit a block, an explicit one or a whole batch, is cut to
    `tiling.dtans_widest_bn`. Every tile width gives bitwise the same
    result as the untiled kernel. A lane width wider than the SpMM kernel
    takes (993 to 1024, `tiling.spmm_by_columns`) runs the SpMV kernel
    once a column, counted in its ``dtans_spmv`` launches: bitwise the
    SpMM column by column (both sum each segment, then add it). ``fused``
    and ``pipeline`` as in `spmv`."""
    pm = get_packed(mat) if isinstance(mat, CSRdtANS) else mat
    _refuse(mesh, n_shards)
    shared = _resolve_fused(pm, fused)
    dm = to_device(pm, device)
    L, T = pm.lane_width, int(pm.tab_symbol.shape[0])
    item = dm.dtype.itemsize
    by_columns = tiling.spmm_by_columns(L)

    def run(X, b):
        if by_columns:                          # tiles of one column
            return torch.stack([dtans_spmv(dm, X[:, j].contiguous(),
                                           shared_cols=shared)
                                for j in range(X.shape[1])], dim=-1)
        return dtans_spmm(dm, X, bn=b, shared_cols=shared)
    return _many_rhs("dtans_spmm", dm, x, y, bn,
                     lambda v: spmv(pm, v, device=dm.device, fused=fused,
                                    pipeline=pipeline),
                     run, lambda B: tiling.dtans_bn(L, T, B, item),
                     decodes=True,
                     widest=1 if by_columns else tiling.dtans_widest_bn(
                         L, T, item))


def decode(mat: CSRdtANS | PackedMatrix, *, device="cuda"
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decompress to the padded (S, L, max_nseg * l/2) ``(cols, vals)``
    (cols == -1 and vals == +0 mark padding) with the decode-only kernel."""
    pm = get_packed(mat) if isinstance(mat, CSRdtANS) else mat
    dm = to_device(pm, device)
    obs.default_registry().counter("kernels.decode_invocations").add(1)
    return dtans_decode(dm)


def sell_spmv(ps: PackedSELL, x, y=None, *, device="cuda") -> torch.Tensor:
    """Baseline SELL SpMV: y = A x + y.

    Same ``(mat, x, y=None)`` signature as `spmv` / `rgcsr_spmv`, so a
    timing harness can drive all three interchangeably."""
    ds = _sell.to_device(ps, device)
    return _one_rhs("sell_spmv", ds, x, y, lambda v: _sell.sell_spmv(ds, v))


def sell_spmm(ps: PackedSELL, x, y=None, *, device="cuda",
              bn=None) -> torch.Tensor:
    """Multi-RHS SELL: Y = A X + Y, X: (n, B). Shares the `spmm`
    signature; B == 1 delegates to `sell_spmv` (bitwise equal), ``bn=None``
    takes `tiling.padded_bn`'s tile, and every ``bn`` gives bitwise the
    untiled result."""
    ds = _sell.to_device(ps, device)
    return _many_rhs("sell_spmm", ds, x, y, bn,
                     lambda v: sell_spmv(ps, v, device=ds.device),
                     lambda X, b: _sell.sell_spmm(ds, X, bn=b),
                     lambda B: tiling.padded_bn(B, ds.dtype.itemsize))


def rgcsr_spmv(pr: PackedRGCSR, x, y=None, *,
               device="cuda") -> torch.Tensor:
    """Row-grouped CSR SpMV: y = A x + y (delta running sum in the
    kernel). Shares the `spmv` / `sell_spmv` signature."""
    dr = _rgcsr.to_device(pr, device)
    return _one_rhs("rgcsr_spmv", dr, x, y,
                    lambda v: _rgcsr.rgcsr_spmv(dr, v))


def rgcsr_spmm(pr: PackedRGCSR, x, y=None, *, device="cuda",
               bn=None) -> torch.Tensor:
    """Multi-RHS RGCSR: Y = A X + Y, X: (n, B). Shares the `spmm`
    signature; B == 1 delegates to `rgcsr_spmv` (bitwise equal), ``bn=None``
    takes `tiling.padded_bn`'s tile, and every ``bn`` gives bitwise the
    untiled result."""
    dr = _rgcsr.to_device(pr, device)
    return _many_rhs("rgcsr_spmm", dr, x, y, bn,
                     lambda v: rgcsr_spmv(pr, v, device=dr.device),
                     lambda X, b: _rgcsr.rgcsr_spmm(dr, X, bn=b),
                     lambda B: tiling.padded_bn(B, dr.dtype.itemsize))


def bcsr_spmv(pb: PackedBCSR, x, y=None, *, device="cuda") -> torch.Tensor:
    """Blocked-CSR SpMV: y = A x + y (dense r x c tiles in the kernel).
    Shares the `spmv` / `sell_spmv` signature."""
    db = _bcsr.to_device(pb, device)
    return _one_rhs("bcsr_spmv", db, x, y, lambda v: _bcsr.bcsr_spmv(db, v))


def bcsr_spmm(pb: PackedBCSR, x, y=None, *, device="cuda",
              bn=None) -> torch.Tensor:
    """Multi-RHS BCSR: Y = A X + Y, X: (n, B). Shares the `spmm`
    signature; B == 1 delegates to `bcsr_spmv` (bitwise equal), ``bn=None``
    takes `tiling.padded_bn`'s tile, and every ``bn`` gives bitwise the
    untiled result."""
    db = _bcsr.to_device(pb, device)
    return _many_rhs("bcsr_spmm", db, x, y, bn,
                     lambda v: bcsr_spmv(pb, v, device=db.device),
                     lambda X, b: _bcsr.bcsr_spmm(db, X, bn=b),
                     lambda B: tiling.padded_bn(B, db.dtype.itemsize))
