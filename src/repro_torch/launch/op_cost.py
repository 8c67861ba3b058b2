"""FLOPs, bytes and collectives of an eager step, counted op by op: the
port's counterpart of the JAX package's `launch/hlo_cost.py`.

The reference walks the compiled, partitioned HLO of a jitted step. The
port runs eagerly and has no HLO, so `analyze(fn, *args)` runs ``fn``
under a `TorchDispatchMode` (on meta tensors for a shape-only model, or on
real ones) and counts every aten op it dispatches. An op on DTensors is
counted as the local ops and collectives DTensor runs for it on this
rank, not at its global shape; the ops of DTensor's shape propagation
(on fake tensors) are not counted:

  flops       = `torch.utils.flop_counter`'s formula for the op (matrix
                products, attention, convolutions; 2 per multiply-add);
                elementwise ops count none, as the reference's dots do
  bytes       = operand plus result bytes of the op: the device-memory
                traffic of an eager step, which fuses nothing (views and
                collectives move none here)
  collectives = the ``torch.ops.c10d`` ops that ``torch.distributed``
                dispatches, by type: raw bytes (the result side: the
                first operand) and on-wire bytes weighted as
                `hlo_cost.py`'s ``COLLECTIVE_WIRE`` (a ring all-reduce
                moves ~2x its operand); and the functional collectives
                DTensor issues (``torch.ops._c10d_functional``: raw bytes
                the op's result), each counted once where it is issued,
                not again at its ``wait_tensor``

It also records every op that produced a float64 tensor: the counterpart
of the reference's dtype-leak check (``dryrun.py``, on ``f64[`` and
``s64[`` in the HLO). int64 is torch's index dtype, so it is no leak here.

Under `traced()` it also keeps each counted op (`Costs.trace`: the op,
its tensors' shapes and dtypes, FLOPs, bytes, the collective and its
group), which the dry-run's ``--save-hlo`` writes out: the counterpart of
the HLO text the reference saves.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute", "broadcast")
# on-wire multiplier (ring algorithms), as the reference's
COLLECTIVE_WIRE = {"all-gather": 1.0, "all-reduce": 2.0,
                   "reduce-scatter": 1.0, "all-to-all": 1.0,
                   "collective-permute": 1.0, "broadcast": 1.0}
# the c10d ops `torch.distributed` dispatches, by collective
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "allgather_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "send": "collective-permute", "recv_": "collective-permute",
         "broadcast_": "broadcast"}
# the functional collectives DTensor's redistributions dispatch (and their
# autograd-aware forms), by collective
_FUNCTIONAL = {"all_reduce": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "broadcast": "broadcast"}
_FUNCTIONAL_NS = ("_c10d_functional", "_c10d_functional_autograd")


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    coll_wire: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_OPS})
    coll_raw: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_OPS})
    coll_counts: dict = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVE_OPS})
    f64_ops: set = dataclasses.field(default_factory=set)
    # (kind, raw bytes, the innermost frame of the port's models or
    # trainer that issued it) of each collective
    sites: list = dataclasses.field(default_factory=list)
    n_ops: int = 0
    max_result: int = 0        # bytes of the largest tensor an op made
    # one `TraceOp` a counted op, under `traced()` (None otherwise)
    trace: list | None = None

    def add(self, other: "Costs", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k in COLLECTIVE_OPS:
            self.coll_wire[k] += other.coll_wire[k] * mult
            self.coll_raw[k] += other.coll_raw[k] * mult
            self.coll_counts[k] += int(other.coll_counts[k] * mult)
        self.f64_ops |= other.f64_ops
        self.sites += other.sites
        self.n_ops += int(other.n_ops * mult)
        self.max_result = max(self.max_result, other.max_result)
        if other.trace is not None:
            self.trace = (self.trace or []) + [
                dataclasses.replace(op, times=int(op.times * mult))
                for op in other.trace]

    def add_collective(self, kind: str, raw_bytes: float, count: int = 1):
        self.coll_raw[kind] += raw_bytes
        self.coll_wire[kind] += raw_bytes * COLLECTIVE_WIRE[kind]
        self.coll_counts[kind] += count

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll_wire.values())


@dataclasses.dataclass(frozen=True)
class TraceOp:
    """One counted op of `Costs.trace`; ``times`` it ran (a microbatch's
    ops run once a microbatch)."""
    op: str
    shapes: tuple
    dtypes: tuple
    flops: float = 0.0
    bytes: float = 0.0
    collective: str = ""
    group: str = ""
    times: int = 1

    def line(self) -> str:
        """Tab-separated: op, shapes, dtypes, FLOPs, bytes, collective,
        group, times."""
        shapes = " ".join("x".join(map(str, s)) or "()" for s in self.shapes)
        return "\t".join((self.op, shapes or "-",
                          " ".join(self.dtypes) or "-", f"{self.flops:g}",
                          f"{self.bytes:g}", self.collective or "-",
                          self.group or "-", str(self.times)))


TRACE_HEADER = "op\tshapes\tdtypes\tflops\tbytes\tcollective\tgroup\ttimes"

_TRACING = False


@contextlib.contextmanager
def traced():
    """Within it, `analyze` also keeps each op it counts (`Costs.trace`)."""
    global _TRACING
    was, _TRACING = _TRACING, True
    try:
        yield
    finally:
        _TRACING = was


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _group(args) -> str:
    """The process group a collective op names: a functional collective's
    group name (its last string argument), or a ``c10d`` op's group's."""
    import torch.distributed as dist
    for a in reversed(args):
        if isinstance(a, str):
            return a
        name = getattr(a, "group_name", None)
        if name is None and isinstance(a, torch.ScriptObject):
            try:
                name = dist.ProcessGroup.unbox(a).group_name
            except (AttributeError, RuntimeError, TypeError):
                name = None
        if isinstance(name, str):
            return name
    return "?"


def _tensor_bytes(tree) -> int:
    return sum(t.nbytes for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _site() -> str:
    """The innermost frame of the port's own code (not this module, not
    the sharding helpers) on the current stack, as ``file:line``."""
    import traceback
    for fr in reversed(traceback.extract_stack()):
        f = fr.filename.replace("\\", "/")
        if "/repro_torch/" in f and not f.endswith(
                ("launch/op_cost.py", "models/sharding.py")):
            return f"{f.split('/repro_torch/')[-1]}:{fr.lineno}"
    return "?"


def collective_kind(func) -> str | None:
    """The collective (one of `COLLECTIVE_OPS`) that the dispatched op
    ``func`` issues, or None: a ``c10d`` or functional collective counts,
    its ``wait_tensor`` and wrappers do not."""
    name = func._overloadpacket.__name__
    if func.namespace == "c10d":
        return _C10D.get(name)
    if func.namespace in _FUNCTIONAL_NS:
        return _FUNCTIONAL.get(name)
    return None


def has_dtensor(args, kwargs=None) -> bool:
    """Whether a dispatched op takes a DTensor. A dispatch mode that
    returns ``NotImplemented`` for such an op sees, in its place, the local
    ops and the collectives DTensor runs for it on this rank (a collective
    inside DTensor's dispatch of an op is otherwise hidden from the
    mode)."""
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor)
               for t in tree_flatten((args, kwargs or {}))[0])


class _Counter(TorchDispatchMode):
    def __init__(self, costs: Costs):
        super().__init__()
        self.costs = costs

    def _collective(self, kind: str, raw: int) -> None:
        self.costs.add_collective(kind, raw)
        self.costs.sites.append((kind, raw, _site()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if has_dtensor(args, kwargs):
            # this rank's share: DTensor runs the op as local ops (and its
            # collectives), which come back here one by one
            return NotImplemented
        flat = tree_flatten((args, kwargs))[0]
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor)
               for t in flat + tree_flatten(out)[0]):
            return out       # DTensor's shape propagation, on global shapes
        c = self.costs
        c.n_ops += 1
        if func.namespace == "c10d" or func.namespace in _FUNCTIONAL_NS:
            kind = collective_kind(func)
            if kind is not None:
                raw = _tensor_bytes(args[0] if func.namespace == "c10d"
                                    else out)
                self._collective(kind, raw)
            self._trace(func, flat, 0.0, 0.0, kind, args)
            return out       # wait_tensor and the wrappers move nothing
        packet = func._overloadpacket
        flops = moved = 0.0
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += flops
        if not func.is_view:
            result = _tensor_bytes(out)
            moved = _tensor_bytes((args, kwargs)) + result
            c.bytes += moved
            c.max_result = max(c.max_result, result)
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.float64
               for t in tree_flatten(out)[0]):
            c.f64_ops.add(str(packet))
        self._trace(func, flat, flops, moved, None, args)
        return out

    def _trace(self, func, flat, flops, moved, kind, args) -> None:
        if self.costs.trace is None:
            return
        ts = _tensors(flat)
        self.costs.trace.append(TraceOp(
            str(func), tuple(tuple(t.shape) for t in ts),
            tuple(str(t.dtype).removeprefix("torch.") for t in ts),
            float(flops), float(moved), kind or "",
            _group(args) if kind else ""))


def analyze(fn, *args, **kwargs) -> tuple:
    """Runs ``fn(*args, **kwargs)`` and counts what it dispatches. Returns
    (its result, `Costs`), which also list where each collective was
    issued (`Costs.sites`)."""
    costs = Costs(trace=[] if _TRACING else None)
    with _Counter(costs):
        out = fn(*args, **kwargs)
    return out, costs
