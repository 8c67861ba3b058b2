"""Logical-axis activation sharding: the port of the JAX package's
`models/sharding.py`.

Model code annotates activations with logical names via `shard(x, ...)`;
the launcher installs a mapping logical-name -> mesh axes. Outside
`logical_rules` the annotations are the identity, and so is `shard` of a
plain tensor: only a DTensor is redistributed, to the placements the
rules give on its own mesh.

Tensor parallelism: `launch.sharding.ShardingRules.distribute` turns a
model's parameters into DTensors placed by the reference's parameter
specs, and the model's entry points then run under `tp_context` (the
model's ``logical`` rules plus DTensor's `implicit_replication`, so the
plain tensors a forward makes, masks, positions, rotary tables, meet the
DTensors as replicated ones). DTensor's sharding propagation plays the
part of XLA's partitioner, and each `shard` site redistributes to the
reference's placement there: a row-parallel product's partial sums are
all-reduced at its ``"d_model"`` annotation, Megatron-style.

`write_local`, `local_offset` and `full` serve the in-place writes of
the decode caches (KV lines, SSM conv tails and states): DTensor cannot
re-place a tensor it writes into, so each rank writes its own shard.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

_state = threading.local()


def current_rules() -> dict | None:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def logical_rules(rules: dict):
    """rules: logical axis name -> mesh axis (str, tuple of str, or None)."""
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def logical_spec(rules: dict, names) -> tuple:
    """The spec that ``rules`` give the logical dim ``names``, mesh axes
    de-duplicated: a later dim wins (sequence-parallel runs map both
    "seq" and "heads"/"ff"/"vocab" to the model axis; inside the
    sharded-compute section the compute dim keeps it, Megatron-style)."""
    axes = [rules.get(n) if n is not None else None for n in names]
    seen = set()
    for i in range(len(axes) - 1, -1, -1):
        flat = axes[i] if isinstance(axes[i], tuple) else (axes[i],)
        if any(a in seen for a in flat if a):
            axes[i] = None
        seen.update(a for a in flat if a)
    return tuple(axes)


def divisible_spec(spec: tuple, shape: tuple, mesh) -> tuple:
    """``spec`` with every dim that its mesh axes do not divide evenly
    left replicated, as `ShardingRules` guards its specs (XLA pads an
    uneven shard; DTensor would give some ranks an empty one), and axes
    of one rank dropped (a shard of one is the whole, and DTensor's view
    rules trip on it when it merges two sharded dims)."""
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.launch.sharding import spec_axes
    sizes = mesh_shape(mesh)
    out = []
    for n, entry in zip(shape, spec):
        axes = tuple(a for a in spec_axes(entry) if sizes[a] > 1)
        ways = 1
        for a in axes:
            ways *= sizes[a]
        if not axes or n % ways:
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


def shard(x, *names):
    """Annotate ``x`` with logical axis ``names`` (one per dim; None = any).

    The identity unless inside `logical_rules` and ``x`` is a DTensor;
    then ``x`` redistributed to the rules' placements on its mesh (a dim
    its axes do not divide stays replicated, `divisible_spec`)."""
    rules = current_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.launch.sharding import placements
    mesh = x.device_mesh
    spec = divisible_spec(logical_spec(rules, names), tuple(x.shape), mesh)
    target = placements(spec, mesh)
    # partial sums are reduced before any other mesh dim re-places x: a
    # vocab-sharded lookup's partial carries a mask of x's whole batch
    mid = tuple(t if c.is_partial() else c
                for c, t in zip(x.placements, target))
    if mid != tuple(x.placements) and mid != target:
        x = x.redistribute(mesh, mid)
    x = x.redistribute(mesh, target)
    if x.requires_grad and torch.is_grad_enabled():
        x = _GradIn.apply(x, target)
    return x


class _GradIn(torch.autograd.Function):
    """The identity, whose backward places the gradient as the forward
    placed the activation: ``with_sharding_constraint`` constrains the
    cotangent too. So the partial sums a column-parallel product sends
    back to a replicated activation are all-reduced at its annotation
    (Megatron's conjugate of the forward identity), before they reach
    another partial placement such as a vocab-sharded lookup's."""

    @staticmethod
    def forward(ctx, x, target):
        ctx.target = target
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.target), None


def split_dim(x, dim: int, n: int, size: int):
    """``x`` with its dim ``dim`` (of n * size) split into (n, size). A
    DTensor sharded along ``dim`` over more ranks than divide ``n`` is made
    whole along it first: DTensor cannot split an uneven shard (XLA
    reshards at the same reshape; the kv heads of a GQA config on a wide
    model axis)."""
    dim %= x.ndim
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        ways = 1
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == dim:
                ways *= x.device_mesh.size(i)
        if n % ways:
            x = x.redistribute(x.device_mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == dim
                else p for p in x.placements])
    return x.reshape(*x.shape[:dim], n, size, *x.shape[dim + 1:])


def merge_dims(x, dim: int):
    """``x`` with dims ``dim`` and ``dim + 1`` merged into one (the heads
    of an attention output into its width). A DTensor's gradient is split
    back through `split_dim`, which makes the merged dim whole first where
    its shards do not split into whole heads (DTensor's own view backward
    refuses: a GQA config's heads on a wide model axis)."""
    dim %= x.ndim
    if not is_dtensor(x):
        return x.reshape(*x.shape[:dim], -1, *x.shape[dim + 2:])
    return _Merge.apply(x, dim)


class _Merge(torch.autograd.Function):
    """`merge_dims` of a DTensor: the reshape, and `split_dim` back."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.n, ctx.size = dim, x.shape[dim], x.shape[dim + 1]
        return x.reshape(*x.shape[:dim], -1, *x.shape[dim + 2:])

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, ctx.n, ctx.size), None


def whole_along(x, dim: int):
    """DTensor ``x`` made whole along ``dim``: every mesh dim that shards
    it there replicated, its other placements kept (FSDP's all-gather of a
    weight before its use, which the reference's partitioner inserts)."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim % x.ndim
          else p for p in x.placements]
    if tuple(pl) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def pad(x, widths: tuple):
    """``F.pad(x, widths)`` with zeros. A DTensor is padded shard by shard:
    its local block, the padded dims whole on every rank (made so first
    where they are sharded), rewrapped in its placements. (DTensor's own
    `pad` rule fails in torch 2.11 where it re-places its input.)"""
    if not is_dtensor(x):
        return torch.nn.functional.pad(x, widths)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dims = {x.ndim - 1 - i for i in range(len(widths) // 2)
            if widths[2 * i] or widths[2 * i + 1]}
    pl = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
          for p in x.placements]
    if tuple(pl) != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(torch.nn.functional.pad(x.to_local(), widths),
                              x.device_mesh, x.placements, run_check=False)


# Tensor-parallel execution ---------------------------------------------------

@contextlib.contextmanager
def tp_context(rules: dict):
    """What a tensor-parallel forward runs under: ``rules`` installed
    (`logical_rules`) and DTensor's `implicit_replication`, so that plain
    tensors meet DTensors as replicated ones, as unsharded arrays do in
    the reference. Nested contexts enter `implicit_replication` once
    (leaving an inner one would switch it off for the outer)."""
    from torch.distributed.tensor.experimental import implicit_replication
    depth = getattr(_state, "tp_depth", 0)
    _state.tp_depth = depth + 1
    try:
        with logical_rules(rules), (implicit_replication() if depth == 0
                                    else contextlib.nullcontext()):
            yield
    finally:
        _state.tp_depth = depth


def sharded(fn):
    """A model entry point that runs under `tp_context` of its model's
    ``logical`` rules where `api.distribute` set them; unchanged on a
    model that was not distributed."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        rules = getattr(self, "logical", None)
        if rules is None:
            return fn(self, *args, **kwargs)
        with tp_context(rules):
            return fn(self, *args, **kwargs)
    return run


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def full(t):
    """``t`` whole on every rank: a DTensor's `full_tensor`, a plain
    tensor itself."""
    return t.full_tensor() if is_dtensor(t) else t


def local_offset(t, dim: int) -> int:
    """Where this rank's block of DTensor ``t`` starts along ``dim``
    (even shards, the mesh's major dim first, as the specs place them)."""
    from torch.distributed.tensor import Shard
    coord = t.device_mesh.get_coordinate()
    size, off = t.shape[dim], 0
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size //= t.device_mesh.size(i)
            off += coord[i] * size
    return off


def local_heads(q, k, v):
    """This rank's blocks of q, k and v where all three are DTensors placed
    alike and split over nothing but their batch (0) and heads (2) dims:
    one head's attention needs nothing of another's, so each rank attends
    with its own heads as plain tensors (DTensor would only dispatch the
    same local ops, and torch 2.11 refuses the flatten inside `einsum`).
    None otherwise (a sequence-sharded cache, plain tensors)."""
    from torch.distributed.tensor import Shard
    if not all(is_dtensor(t) for t in (q, k, v)):
        return None
    pl = q.placements
    if k.placements != pl or v.placements != pl or any(
            p.is_partial() or (isinstance(p, Shard) and p.dim not in (0, 2))
            for p in pl):
        return None
    return q.to_local(), k.to_local(), v.to_local()


def rewrap(local, like):
    """The plain tensor ``local`` as this rank's block of a DTensor placed
    as ``like`` (the global shape follows from the even split)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False)


def local_like(src, dst, pl=None):
    """This rank's block of ``src`` (a DTensor or a plain tensor, the
    whole of a replicated one) in ``dst``'s placements (or ``pl`` on
    ``dst``'s mesh): a plain tensor, the shape of ``dst.to_local()``
    where the placements are ``dst``'s."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = dst.device_mesh
    pl = dst.placements if pl is None else pl
    if not isinstance(src, DTensor):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    return src.redistribute(mesh, pl).to_local()


def write_local(dst, src) -> None:
    """``dst.copy_(src)`` in place, a DTensor ``dst`` written shard by
    shard: each rank copies its own block of ``src`` into its local
    tensor, so ``dst`` keeps its storage and its placements."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return
    dst.to_local().copy_(local_like(src, dst))


# Canonical rule sets -------------------------------------------------------

def rules_for_mesh(axis_names: tuple, *, dp_only: bool = False,
                   batch_axes=None, seq_axis=None) -> dict:
    """Standard DP/TP/SP/EP mapping for ('data','model') or
    ('pod','data','model') meshes.

    dp_only: pure data parallelism (tiny models — TP would idle on
    sub-16-way head/ff dims); batch_axes/seq_axis override the defaults
    (per-cell batch divisibility, sequence-parallel perf runs)."""
    data_axes = tuple(a for a in axis_names if a in ("pod", "data"))
    data = data_axes if len(data_axes) > 1 else (data_axes[0]
                                                 if data_axes else None)
    tp = None if dp_only else "model"
    return {
        "batch": data if batch_axes is None else batch_axes,
        "seq": seq_axis,      # "model" for sequence-parallel runs
        "d_model": None,
        "heads": tp,
        "kv_heads": tp,
        "ff": tp,
        "vocab": tp,
        "experts": tp,
        "moe_capacity": None,   # launcher flips to "model" when E doesn't
                                # divide the model axis (see launch/steps)
        "ssm_heads": tp,
        "capacity": None,
        "state": None,
    }



def place_cache(model, cache: dict) -> dict:
    """A decode cache of ``model`` placed by its rules' `cache_spec` where
    `api.distribute` set them; ``cache`` itself otherwise."""
    rules = getattr(model, "tp_rules", None)
    return cache if rules is None else rules.distribute_cache(cache)


def insert_local(pool, req, slot: int, axis: int) -> None:
    """`layers.insert_slot` into a DTensor ``pool``: each rank writes the
    part of the request's region (``slot`` on ``axis``, offset 0
    elsewhere) that falls in its block. A request placed as the pool is,
    its sharded dims as long as the pool's (a prefill's cache, placed by
    the same `cache_spec`), is copied shard to shard; any other is made
    whole on every rank first (`full`)."""
    c = pool.to_local()
    sharded = [d for d in range(pool.ndim) if c.shape[d] != pool.shape[d]]
    if is_dtensor(req) and req.placements == pool.placements and all(
            d != axis and req.shape[d] == pool.shape[d] for d in sharded):
        r = req.to_local()
        at = [slice(0, n) for n in r.shape]
        at[axis] = slice(slot, slot + r.shape[axis])
        c[tuple(at)] = r.to(c.dtype)
        return
    r = full(req).to(pool.dtype)
    src, dst = [], []
    for d in range(pool.ndim):
        lo, n = local_offset(pool, d), c.shape[d]
        start = slot if d == axis else 0
        a, b = max(start, lo), min(start + r.shape[d], lo + n)
        if a >= b:
            return
        dst.append(slice(a - lo, b - lo))
        src.append(slice(a - start, b - start))
    c[tuple(dst)] = r[tuple(src)]
