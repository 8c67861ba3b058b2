"""A route for DTensor's collectives over gloo on CUDA tensors.

DTensor redistributes through the functional collectives
(``torch.ops._c10d_functional``: the op returns at once, a later
``wait_tensor`` waits). Over a gloo group on CUDA tensors, torch 2.11's
``wait_tensor`` crashes the process (a segmentation fault in the wait),
while ``torch.distributed``'s own collectives on the same tensors work:
gloo copies them to the host, runs its ring there and copies back (the
port's data parallelism and row-sharded head already run so on one
card, where NCCL refuses two ranks on one GPU).

`install` registers, for CUDA tensors only, implementations of the
functional collectives that call those: each finishes before it returns,
so its ``wait_tensor`` has nothing to wait for. `all_reduce` is
``dist.all_reduce`` on a copy; the gathers, the reduce-scatter and the
all-to-all are built from ``dist.all_reduce`` of a zero buffer in which
each rank fills its own part (adding exact zeros, so the result is
bitwise the gathered tensor), since gloo's ``_allgather_base`` and
``_reduce_scatter_base`` are not there for CUDA tensors; ``broadcast`` is
``dist.broadcast``. `launch.mesh.spawn` installs it in every rank of a
gloo group on the card; NCCL groups keep the native path.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_LIB = None

_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "product": dist.ReduceOp.PRODUCT}


def _group(name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name)


def all_reduce(x, reduce_op: str, group_name: str):
    pg = _group(group_name)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[reduce_op.lower()], group=pg)
    if reduce_op.lower() == "avg":
        out.div_(pg.size())
    return out


def _gathered(x, group_size: int, pg):
    """The group's tensors stacked on a new first dim, by an all-reduce of
    a zero buffer holding this rank's own."""
    buf = x.new_zeros((group_size,) + tuple(x.shape))
    buf[pg.rank()] = x
    dist.all_reduce(buf, group=pg)
    return buf


def all_gather_into_tensor(x, group_size: int, group_name: str):
    buf = _gathered(x, group_size, _group(group_name))
    return buf.reshape((group_size * x.shape[0],) + tuple(x.shape[1:]))


def reduce_scatter_tensor(x, reduce_op: str, group_size: int,
                          group_name: str):
    pg = _group(group_name)
    out = all_reduce(x, reduce_op, group_name)
    n = x.shape[0] // group_size
    return out[pg.rank() * n:(pg.rank() + 1) * n].clone()


def all_to_all_single(x, output_split_sizes, input_split_sizes,
                      group_name: str):
    pg = _group(group_name)
    size, rank = pg.size(), pg.rank()
    ins = (list(input_split_sizes) if input_split_sizes
           else [x.shape[0] // size] * size)
    rows = max(ins)
    # every rank's input, its splits padded to one length
    padded = x.new_zeros((size, rows) + tuple(x.shape[1:]))
    for j, part in enumerate(torch.split(x, ins)):
        padded[j, :part.shape[0]] = part
    everyone = _gathered(padded, size, pg)      # (src, dst, rows, ...)
    outs = (list(output_split_sizes) if output_split_sizes
            else [x.shape[0] // size] * size)
    return torch.cat([everyone[src, rank, :outs[src]]
                      for src in range(size)])


def broadcast(x, src: int, group_name: str):
    out = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(out, src=src, group=_group(group_name))
    return out


def install(key: str = "CUDA") -> None:
    """Route the functional collectives on ``key``'s tensors (CUDA; the
    tests route CPU ones to check the arithmetic) as this module says,
    once a process."""
    global _LIB
    if _LIB is not None:
        return
    import warnings
    lib = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():
        # replacing the native CUDA kernels is the point
        warnings.simplefilter("ignore")
        for name, fn in (("all_reduce", all_reduce),
                         ("all_gather_into_tensor", all_gather_into_tensor),
                         ("reduce_scatter_tensor", reduce_scatter_tensor),
                         ("all_to_all_single", all_to_all_single),
                         ("broadcast", broadcast)):
            lib.impl(name, fn, key)
    _LIB = lib
