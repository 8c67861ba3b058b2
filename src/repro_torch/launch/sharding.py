"""Parameter / optimizer / batch / cache sharding specs: the port of the
JAX package's `launch/sharding.py`.

Policy knobs:
  fsdp  — additionally shard each weight's non-TP dim over the data axis
          (needed when bf16 params alone exceed TP-sharded HBM: 405B, 34B,
          30B-MoE);
  zero1 — shard optimizer state dim-0 over the data axis when the param
          itself is not FSDP-sharded (ZeRO-1).

All rules are divisibility-guarded: a dim that doesn't divide the mesh axis
stays replicated.

Torch has no ``PartitionSpec``. A spec here is a tuple with one entry per
tensor dim: ``None`` (replicated), a mesh axis name, or a tuple of names
(the dim split over several axes, the first the major one), as the
reference's ``PartitionSpec`` entries are. `placements` turns a spec into
the DTensor placements of a `DeviceMesh`.

The rules take a `DeviceMesh` or a `launch.mesh.MeshShape`. A leaf is
named by its dotted name in `models.api.reference_leaves` (``layers.attn.
wq``) and has the reference's stacked shape (``(n_layers,) + shape`` for a
layer leaf), so a spec here is the reference's spec for the same leaf.
"""

from __future__ import annotations

from repro_torch.launch.mesh import (data_axis_names, data_axis_size,
                                     mesh_shape, model_axis_size)
from repro_torch.models.config import ArchConfig

FSDP_PARAM_THRESHOLD = 10e9

_STACKS = ("layers", "enc_layers", "dec_layers")


def should_fsdp(cfg: ArchConfig) -> bool:
    # cheap analytic estimate of param count
    hd = cfg.hd
    n_mats = 3 if cfg.mlp_gated else 2
    if cfg.family == "moe":
        per = cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
        per += 2 * cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    elif cfg.family in ("ssm", "hybrid"):
        per = cfg.d_model * (2 * cfg.d_inner + 2 * cfg.ssm_state
                             + cfg.ssm_heads) + cfg.d_inner * cfg.d_model
    else:
        per = (cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
               + cfg.n_heads * hd * cfg.d_model
               + n_mats * cfg.d_model * cfg.d_ff)
    total = per * cfg.n_layers + 2 * cfg.vocab * cfg.d_model
    return total > FSDP_PARAM_THRESHOLD


def _div(n: int, size: int) -> bool:
    return size > 1 and n % size == 0


def spec_axes(entry) -> tuple:
    """The mesh axes one spec entry names, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim d names, ``Replicate()`` on the others. A
    tensor dim split over several axes names them in the mesh's order (the
    major axis first), which is the order DTensor shards in."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} names {axes} against the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape(spec: tuple, shape: tuple, mesh) -> tuple:
    """The per-device shape of a ``shape`` tensor under ``spec`` (every
    sharded dim divides its axes, as the rules guarantee)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in spec_axes(entry):
            out[d] //= sizes[a]
    return tuple(out)


class ShardingRules:
    def __init__(self, cfg: ArchConfig, mesh, *, fsdp=None, zero1=True,
                 seq_shard_cache=True, dp_only=False):
        self.cfg = cfg
        self.mesh = mesh
        self.dp_only = dp_only
        self.fsdp = (should_fsdp(cfg) if fsdp is None else fsdp) \
            and not dp_only
        self.zero1 = zero1
        self.seq_shard_cache = seq_shard_cache
        self.dsize = data_axis_size(mesh)
        self.msize = 1 if dp_only else model_axis_size(mesh)
        self.dax = data_axis_names(mesh)
        self.data = (self.dax if len(self.dax) > 1
                     else (self.dax[0] if self.dax else None))

    # ----- parameters ------------------------------------------------------
    def _f(self, dim: int):
        """FSDP axis for a weight dim (or None)."""
        if self.fsdp and _div(dim, self.dsize):
            return "data"
        return None

    def _m(self, dim: int):
        return "model" if _div(dim, self.msize) else None

    def param_spec(self, name: str, shape: tuple) -> tuple:
        """The spec of the leaf ``name`` (dotted, as `reference_leaves`
        names it) of stacked shape ``shape``."""
        names = name.split(".") if name else []
        stacked = any(n in _STACKS for n in names)
        core = tuple(shape[1:]) if stacked else tuple(shape)
        name = names[-1] if names else ""
        in_ssm = "ssm" in names

        spec: tuple = tuple(None for _ in core)
        if name == "tok":
            spec = (self._m(core[0]), self._f(core[1]))
        elif name == "head":
            spec = (self._f(core[0]), self._m(core[1]))
        elif name in ("wq", "wk", "wv"):
            spec = (self._f(core[0]), self._m(core[1]))
        elif name in ("wi", "wg"):
            if len(core) == 3:   # moe (E, d, ff)
                if self._m(core[0]):
                    spec = ("model", self._f(core[1]), None)
                else:            # E % model axis != 0: FSDP over data,
                    spec = (None, self._f(core[1]), None)  # capacity-EP
            else:
                spec = (self._f(core[0]), self._m(core[1]))
        elif name == "wo":
            if len(core) == 3:   # moe (E, ff, d)
                if self._m(core[0]):
                    spec = ("model", self._f(core[1]), None)
                else:
                    spec = (None, self._f(core[1]), None)
            else:
                spec = (self._m(core[0]), self._f(core[1]))
        elif name == "router":
            spec = (None, None)
        elif name == "in_proj" and in_ssm:
            spec = (self._f(core[0]), self._m(core[1]))
        elif name == "in_proj":   # hybrid shared-attn input concat proj
            spec = (self._f(core[0]), None)
        elif name == "out_proj":
            spec = (self._m(core[0]), self._f(core[1]))
        elif name == "conv_w":
            spec = (None, self._m(core[1]))
        elif name in ("conv_b", "norm"):
            spec = (self._m(core[0]),)
        elif name in ("A_log", "D", "dt_bias", "scale"):
            spec = tuple(None for _ in core)
        if stacked:
            spec = (None,) + spec
        return spec

    # ----- optimizer state --------------------------------------------------
    def opt_spec(self, pspec: tuple, shape) -> tuple:
        """ZeRO-1: add data-axis sharding on dim 0 when free & divisible."""
        spec = list(pspec) + [None] * (len(shape) - len(pspec))
        if self.zero1 and not self.fsdp and spec and spec[0] is None \
                and _div(shape[0], self.dsize):
            spec[0] = "data"
        return tuple(spec)

    # ----- batch / cache ----------------------------------------------------
    def batch_axis(self, global_batch: int):
        # dp_only: fold the model axis into data parallelism too
        sizes = mesh_shape(self.mesh)
        candidates = []
        if self.dp_only:
            candidates.append(self.dax + ("model",))
        candidates.append(self.dax)
        if len(self.dax) > 1:
            candidates.append(self.dax[-1:])
        for axes in candidates:
            size = 1
            for a in axes:
                size *= int(sizes[a])
            if _div(global_batch, size):
                return axes if len(axes) > 1 else axes[0]
        # batch too small for any DP split (e.g. long_500k batch=1)
        return None

    def batch_spec(self, batch_shapes: dict) -> dict:
        """Specs of a batch given as ``{key: shape}``."""
        out = {}
        for k, shape in batch_shapes.items():
            b = self.batch_axis(shape[0])
            out[k] = (b,) + (None,) * (len(shape) - 1)
        return out

    def cache_spec(self, name: str, shape: tuple) -> tuple:
        """Decode caches, a leaf named by its dotted path (``kv.k``,
        ``ssm.state``). KV: (L, B, S, Hk, hd) — prefer head sharding if
        Hk divides the model axis, else shard S (softmax collectives are
        cheaper than replicating a 32k cache)."""
        name = name.split(".")[-1] if name else ""
        if name in ("k", "v") and len(shape) == 5:
            L, B, S, Hk, hd = shape
            b = self.batch_axis(B)
            if _div(Hk, self.msize):
                return (None, b, None, "model", None)
            if self.seq_shard_cache and _div(S, self.msize):
                return (None, b, "model", None, None)
            return (None, b, None, None, None)
        if name == "conv" and len(shape) == 4:    # (L, B, wc-1, ch)
            return (None, self.batch_axis(shape[1]), None,
                    self._m(shape[3]))
        if name == "state" and len(shape) == 5:   # (L, B, H, P, N)
            return (None, self.batch_axis(shape[1]),
                    self._m(shape[2]), None, None)
        if name == "memory" and len(shape) == 3:  # (B, ml, d)
            return (self.batch_axis(shape[0]), None, None)
        if name == "x0":
            return (self.batch_axis(shape[0]), None, None)
        b = self.batch_axis(shape[1]) if len(shape) > 1 else None
        return (None, b) + (None,) * (len(shape) - 2)
