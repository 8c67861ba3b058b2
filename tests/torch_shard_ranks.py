"""Rank bodies of `tests/test_torch_shard.py` for
`repro_torch.launch.mesh.spawn`: module-level functions of a module that
imports only the port, so that a fresh rank process imports them by name
without loading JAX.

`rank_spmm` runs a list of shard plans through the collective path and
times them (`chip_smoke.py` phase 4i, the ``gpu`` tests and
`experiments/shard_collective` spawn it too; they put ``tests/`` on
``sys.path``, which the spawned ranks inherit).

`group_body` runs every task of one process group and returns plain host
objects (numpy arrays, dicts, strings): the collective passes of the
shard plans, the knobs of ``ops.spmv`` / ``spmm``, the refusals, the
selection under the mesh, a sharded `SparseLinear` and the obs counters.
"""

import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import autotune as A
from repro_torch import obs
from repro_torch.kernels import ops, shard_ops
from repro_torch.launch.mesh import (data_axis_names, data_axis_size,
                                     make_debug_mesh, make_production_mesh,
                                     model_axis_size)
from repro_torch.serving.sparse_linear import SparseLinear


def rank_spmm(mesh, jobs, device="cuda", reps: int = 0) -> list:
    """Each ``(plan, x)`` of ``jobs`` through `shard_ops.shard_spmm` under
    ``mesh`` on this rank's ``device``. Returns, per job, a dict: ``y``
    (the result as numpy), ``uploaded`` (per shard, whether this process
    holds it on a device) and, with ``reps`` > 0, ``ms``: the wall time of
    each of ``reps`` further passes, from a barrier to the result on the
    device (the host staging of a gloo group included), and its median
    ``ms_p50``."""
    out = []
    for plan, x in jobs:
        y = shard_ops.shard_spmm(plan, x, mesh=mesh, device=device)
        res = {"y": y.cpu().numpy(),
               "uploaded": [bool(getattr(p, "_device_cache", None))
                            for p in plan.shards]}
        ms = []
        for _ in range(reps):
            dist.barrier(group=mesh.get_group("model"))
            t0 = time.perf_counter()
            shard_ops.shard_spmm(plan, x, mesh=mesh, device=device)
            if y.is_cuda:
                torch.cuda.synchronize(y.device)
            ms.append((time.perf_counter() - t0) * 1e3)
        if ms:
            res["ms"] = ms
            res["ms_p50"] = statistics.median(ms)
        out.append(res)
    return out


def _refusal(fn) -> str:
    """The message of the `ValueError` ``fn`` raises ("" if none)."""
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def _kernel_metrics() -> dict:
    snap = obs.default_registry().snapshot()
    return {kind: {k: v for k, v in snap[kind].items()
                   if k.startswith("kernels.")}
            for kind in ("counters", "histograms")}


def group_body(mesh, tasks: dict) -> dict:
    k = model_axis_size(mesh)
    out = {"rank": mesh.get_local_rank("model"), "k": k,
           "jobs": rank_spmm(mesh, tasks["jobs"], device="cpu")}

    # ops.spmv / spmm with mesh=: bitwise the unsharded entry points
    mat, x = tasks["mat"], tasks["x"]
    out["ops"] = {
        "spmm": ops.spmm(mat, x, mesh=mesh, device="cpu").numpy(),
        "spmv": ops.spmv(mat, x[:, 0], mesh=mesh, device="cpu").numpy(),
        "spmm_1": ops.spmm(mat, x, device="cpu").numpy(),
        "spmv_1": ops.spmv(mat, x[:, 0], device="cpu").numpy()}

    # a plan of another shard count refuses this mesh
    other = tasks["other_plan"]
    out["mismatch"] = _refusal(lambda: shard_ops.shard_spmm(
        other, np.ones((other.shape[1], 2)), mesh=mesh, device="cpu"))

    # the all-zero and the zero-row matrices
    out["degenerate"] = [shard_ops.shard_spmm(p, xz, mesh=mesh,
                                              device="cpu").numpy()
                         for p, xz in tasks["degenerate"]]

    # a two-dim debug mesh over the same ranks, and the production mesh
    # that this group is too small for
    if k % 2 == 0:
        dm = make_debug_mesh((2, k // 2), ("data", "model"),
                             device_type="cpu")
        out["axes"] = (data_axis_names(dm), data_axis_size(dm),
                       model_axis_size(dm))
    try:
        make_production_mesh(device_type="cpu")
        out["production"] = ""
    except RuntimeError as exc:
        out["production"] = str(exc)

    # the selection sweeps the mesh's shard counts
    out["shard_counts"] = A.shard_counts(mesh)
    out["select"] = {}
    for name, a in tasks.get("suite", {}).items():
        cache = A.DecisionCache(path=None)
        A.clear_memo()
        dec = A.select(a, warm=False, mesh=mesh, formats=tasks["formats"],
                       machine=A.V5E, cache=cache)
        out["select"][name] = (dec.to_dict(), sorted(cache._load()))

    # a sharded SparseLinear: each rank uploads only its own shard
    sl = SparseLinear.from_dense(tasks["w"], mesh=mesh, device="cpu")
    out["layer"] = {
        "n_shards": sl.n_shards,
        "uploaded": [bool(getattr(p, "_device_cache", None))
                     for p in sl.plan.shards],
        "whole_encoded": sl.mat is not None,
        "y": sl.apply(torch.as_tensor(tasks["acts"])).numpy()}

    # a shard count other than the mesh's refuses before any encode
    other = 2 if k == 4 else 4
    out["layer_mismatch"] = _refusal(lambda: SparseLinear.from_dense(
        tasks["w"], mesh=mesh, n_shards=other, device="cpu"))

    # the obs contract of one collective pass
    obs.default_registry().reset()
    shard_ops.shard_spmm(tasks["obs_plan"], tasks["obs_x"], mesh=mesh,
                         device="cpu")
    out["metrics"] = _kernel_metrics()
    return out


def fail_on_rank(mesh, rank: int) -> None:
    if mesh.get_local_rank("model") == rank:
        raise RuntimeError(f"rank {rank} fails")


def select_body(mesh, a) -> tuple:
    """(shard counts of the mesh, the `V5E` decision under the mesh)."""
    A.clear_memo()
    dec = A.select(a, machine=A.V5E, mesh=mesh,
                   cache=A.DecisionCache(path=None))
    return A.shard_counts(mesh), dec.to_dict()


def refuse_cpu_call(mesh, plan, x) -> str:
    """The refusal of a ``device="cpu"`` pass under this (CUDA) mesh."""
    return _refusal(lambda: shard_ops.shard_spmm(plan, x, mesh=mesh,
                                                 device="cpu"))
