"""Run a `repro_torch.sparse.shard.ShardPlan`: a per-shard loop on one
device, or one shard a rank of a process group with an all-reduce (the
port of the JAX package's ``repro.kernels.shard_ops``).

The multi-device contract: each rank holds ONE shard's packed artifact
(its row block's bitstream or index arrays), decodes and contracts it
against ``x`` broadcast from the group's first rank, writes its rows at
the shard's row offset into a zero ``(m, B)`` result, and an all-reduce
(sum) over the mesh's ``"model"`` group leaves the whole result on every
rank. The group's backend is the caller's (`torch.distributed.init_
process_group`); this module picks none.

Bit-identity: a shard's kernel is exactly the single-device kernel on
its row block (decode is lossless, and each row sums its entries in
column order, whatever its neighbours), and the all-reduce adds each
row's value to zeros, so the sharded results equal the single-device
ones at every shard count. The reference pads every shard's pack to the
fleet-wide widest and stacks them, because ``shard_map`` needs one shape
and its SELL / RGCSR kernels tree-reduce over the padded width. The
port's kernels and their plain versions stop each row at its last real
entry (or add exact zeros after it), so each shard runs its own pack as
it is: no padding, no stacking, and every shard's launch geometry and
shared-memory plan are its own.

The loop path (``mesh=None``, a one-shard plan, or a packed type without
an adapter) runs each shard in turn on one device and concatenates the
rows with ``torch.cat``; it reads nothing back to the host, so a serving
step with a sharded head still captures into a CUDA graph. The four
kernel-backed families (`SHARD_MAP_ADAPTERS`) run their kernel wrappers
directly (B == 1 through the SpMV kernel, wider batches through the SpMM
in the column tiles `ops` would choose); every other registered format
runs through its registry `spmm_runner` per shard.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import bcsr_spmv, ops, rgcsr_spmv, sell_spmv, tiling
from repro_torch.kernels.dtans_spmv import dtans_spmv
from repro_torch.kernels.pack import PackedMatrix, check_device, to_device


# ---------------------------------------------------------------------------
# Per-family adapters: (upload, run). ``upload(pack, device)`` moves one
# shard's pack to a device (cached on the pack); ``run(pack, x, bn)`` gives
# the padded rows (R, B) of that shard's A X, x (n, B) on the device.
# ---------------------------------------------------------------------------

def _run_dtans(pm: PackedMatrix, x: torch.Tensor, bn) -> torch.Tensor:
    dm = to_device(pm, x.device)
    shared = bool(pm.shared_cols)
    if x.shape[1] == 1:
        return dtans_spmv(dm, x[:, 0], shared_cols=shared).reshape(-1, 1)
    B = x.shape[1]
    return ops.dtans_run(dm, shared)(
        x, ops.dtans_tile(dm, B, bn)).reshape(-1, B)


def _padded(mod, spmv, spmm):
    """(upload, run) of a SELL / RGCSR / BCSR module."""
    def run(pack, x: torch.Tensor, bn) -> torch.Tensor:
        d = mod.to_device(pack, x.device)
        if x.shape[1] == 1:
            return spmv(d, x[:, 0]).reshape(-1, 1)
        B = x.shape[1]
        return spmm(d, x, bn=ops.padded_tile(d, B, bn)).reshape(-1, B)
    return mod.to_device, run


#: packed-artifact type -> (upload, run). A family joins the collective
#: path by registering here; every other format runs the loop.
SHARD_MAP_ADAPTERS = {
    PackedMatrix: (to_device, _run_dtans),
    sell_spmv.PackedSELL: _padded(sell_spmv, sell_spmv.sell_spmv,
                                  sell_spmv.sell_spmm),
    rgcsr_spmv.PackedRGCSR: _padded(rgcsr_spmv, rgcsr_spmv.rgcsr_spmv,
                                    rgcsr_spmv.rgcsr_spmm),
    bcsr_spmv.PackedBCSR: _padded(bcsr_spmv, bcsr_spmv.bcsr_spmv,
                                  bcsr_spmv.bcsr_spmm),
}


def supports_shard_map(plan) -> bool:
    """Whether this plan's packed artifacts have a collective-path adapter
    (the four kernel-backed families do). A rank's plan may hold its own
    shard alone (`FormatSpec.shard(only=)`): the first shard it holds
    decides."""
    held = [p for p in plan.shards if p is not None]
    return bool(held) and type(held[0]) in SHARD_MAP_ADAPTERS


def host_plan(plan):
    """A copy of ``plan`` whose packs hold no device tensors (the numpy
    arrays are shared, not copied): what a rank is sent, so that it
    uploads its own shard and nothing else."""
    def bare(pack):
        pack = copy.copy(pack)
        getattr(pack, "__dict__", {}).pop("_device_cache", None)
        return pack
    return dataclasses.replace(plan,
                               shards=tuple(bare(p) for p in plan.shards))


def upload(plan, device="cuda", *, mesh=None) -> None:
    """Moves to ``device`` the shards this process runs: every shard on the
    loop path, the rank's own under a mesh of more than one rank. Packs
    without an adapter upload when their runner is built."""
    if not supports_shard_map(plan):
        return
    up = SHARD_MAP_ADAPTERS[type(next(
        p for p in plan.shards if p is not None))][0]
    ks = range(plan.n_shards)
    if mesh is not None and plan.n_shards > 1:
        ks = [mesh.get_local_rank("model")]
    for k in ks:
        up(plan.shards[k], device)


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

def _record_shard_pass(plan, batch: int, *, collective: bool) -> None:
    """One sharded pass into the default metrics registry: per-shard
    matrix bytes plus the collective count (one x broadcast and one
    all-reduce per collective pass), the reference's names."""
    r = obs.default_registry()
    r.counter("kernels.shard_passes").add(1)
    r.counter("kernels.shard_matrix_bytes").add(plan.total_nbytes)
    r.histogram("kernels.n_shards").observe(plan.n_shards)
    for b in plan.shard_nbytes:
        r.histogram("kernels.shard_bytes").observe(int(b))
    if collective:
        r.counter("kernels.collectives.broadcast").add(1)
        r.counter("kernels.collectives.psum").add(1)


def plan_dtype(plan) -> torch.dtype:
    """The dtype a plan computes in: f64 for f64 values, else f32."""
    return torch.float64 if plan.dtype == np.float64 else torch.float32


def _loop_spmm(plan, x: torch.Tensor, bn) -> torch.Tensor:
    """Every shard in turn on x's device, rows concatenated."""
    B = x.shape[1]
    blocks = []
    if supports_shard_map(plan):
        run = SHARD_MAP_ADAPTERS[type(plan.shards[0])][1]
        for k in range(plan.n_shards):
            rows = plan.boundaries[k + 1] - plan.boundaries[k]
            if rows:                      # an empty shard adds no rows
                blocks.append(run(plan.shards[k], x, bn)[:rows])
    else:
        from repro_torch.sparse.registry import get_format
        spec = get_format(plan.fmt)
        for k in range(plan.n_shards):
            rows = plan.boundaries[k + 1] - plan.boundaries[k]
            if rows:
                y = spec.spmm_runner(plan.shards[k], x, device=x.device)()
                blocks.append(torch.as_tensor(y)[:rows])
    if not blocks:
        return torch.zeros((0, B), dtype=x.dtype, device=x.device)
    return torch.cat(blocks, dim=0)


def _collective_spmm(plan, x: torch.Tensor, mesh, bn) -> torch.Tensor:
    """This rank's shard against x broadcast from the group's first rank,
    its rows placed at the shard's offset in a zero (m, B) result, summed
    over the mesh's ``"model"`` group."""
    import torch.distributed as dist
    group = mesh.get_group("model")
    k = mesh.get_local_rank("model")
    x = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    out = torch.zeros((plan.shape[0], x.shape[1]), dtype=x.dtype,
                      device=x.device)
    r0, r1 = plan.boundaries[k], plan.boundaries[k + 1]
    if r1 > r0:
        run = SHARD_MAP_ADAPTERS[type(plan.shards[k])][1]
        out[r0:r1] = run(plan.shards[k], x, bn)[:r1 - r0]
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def validate_mesh(n_shards: int, mesh, dev: torch.device) -> None:
    """Refuses a mesh whose ``"model"`` dim is not ``n_shards`` ranks or
    whose device type is not ``dev``'s."""
    from repro_torch.launch.mesh import model_axis_size
    k = model_axis_size(mesh)
    if k != n_shards:
        raise ValueError(
            f"plan has {n_shards} shards but the mesh model axis "
            f"holds {k} ranks; build the plan with "
            f"n_shards=model_axis_size(mesh)")
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r} but the "
                         f"call runs on {dev}")


def _as_rhs(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=dtype, device=dev)


def shard_spmm(plan, x, y=None, *, mesh=None, device="cuda", bn=None,
               tile_mode: str = "auto",
               pipeline: bool = False) -> torch.Tensor:
    """Y = A X + Y from a shard plan, X: (n, B), on ``device``: the sharded
    analogue of `ops.spmm`. With a mesh of more than one rank (its
    ``"model"`` dim equal to ``plan.n_shards``, its device type
    ``device``'s) and a kernel-backed family, every rank of the mesh calls
    this with the same plan and shapes, runs its own shard and all-reduces;
    otherwise the per-shard loop runs here. Both give bitwise the
    single-device kernels' result. ``bn`` column-tiles each shard's SpMM
    as in `ops.spmm`; ``tile_mode`` (the reference's tile schedule,
    `tiling.check_tile_mode`) and ``pipeline`` (its decode-ahead schedule)
    name schedules the kernels always run one way: every value gives the
    same bits."""
    tiling.check_tile_mode(tile_mode)
    m, n = plan.shape
    dev = check_device(device)
    x2 = _as_rhs(x, plan_dtype(plan), dev)
    if x2.ndim != 2:
        raise ValueError(f"shard_spmm expects x of shape (n, B); got "
                         f"{tuple(x2.shape)} (use shard_spmv for 1-D)")
    if x2.shape[0] != n:
        raise ValueError(f"shard_spmm rhs has {x2.shape[0]} rows; "
                         f"matrix has {n} columns")
    if mesh is not None:
        validate_mesh(plan.n_shards, mesh, dev)
    if x2.shape[1] == 0 or m == 0:
        out = torch.zeros((m, x2.shape[1]), dtype=x2.dtype, device=dev)
    else:
        collective = (mesh is not None and plan.n_shards > 1
                      and supports_shard_map(plan))
        _record_shard_pass(plan, x2.shape[1], collective=collective)
        if collective:
            out = _collective_spmm(plan, x2, mesh, bn)
        else:
            out = _loop_spmm(plan, x2, bn)
    if y is not None:
        out = out + _as_rhs(y, out.dtype, dev)
    return out


def shard_spmv(plan, x, y=None, *, mesh=None, device="cuda",
               pipeline: bool = False) -> torch.Tensor:
    """y = A x + y from a shard plan, 1-D ``x``: the sharded analogue of
    `ops.spmv`. Runs the SpMV kernels (B == 1), so the result is bitwise
    the single-device `ops.spmv`."""
    x1 = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    if x1.ndim != 1:
        raise ValueError(f"shard_spmv expects 1-D x; got {tuple(x1.shape)}")
    out = shard_spmm(plan, x1[:, None], mesh=mesh, device=device,
                     pipeline=pipeline)[:, 0]
    if y is not None:
        out = out + _as_rhs(y, out.dtype, out.device)
    return out
