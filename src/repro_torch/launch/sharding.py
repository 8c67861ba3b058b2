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

On a `DeviceMesh` the rules also place real tensors: `distribute` turns a
model's parameters into DTensors (a layer's tensor takes its stacked
leaf's spec without the leading layer entry), `distribute_cache` and
`distribute_batch` a decode cache and a batch, and `gather` undoes
`distribute`. Each rank builds the whole tensor from the same seed and
keeps its own slice (`local_slice`): no communication.
"""

from __future__ import annotations

import torch

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

    def state_spec(self, leaf: str | None, shape) -> tuple:
        """The spec of an optimizer state tensor of (stacked) ``shape``, as
        the reference's train cell places its state (`launch/steps.py:177-
        189`): AdamW's and Adafactor's ``master``, ``m`` and ``v`` of the
        leaf named ``leaf`` take that leaf's `param_spec`, Adafactor's
        second moments (``vr``, ``vc``, an unfactored ``v``; ``leaf``
        None) an all-replicated one; then ZeRO-1's `opt_spec`. A stacked
        leaf's state is one tensor, so its dim 0, which ZeRO-1 splits over
        the data axis, is the layer axis."""
        shape = tuple(shape)
        base = (self.param_spec(leaf, shape) if leaf is not None
                else (None,) * len(shape))
        return self.opt_spec(base, shape)

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

    # ----- placing real tensors (a DeviceMesh) ------------------------------
    def tensor_spec(self, name: str, shape: tuple) -> tuple:
        """The spec of one parameter tensor of a model, by its module name
        (``layers.3.attn.wq``): a layer's tensor takes its stacked leaf's
        spec (`param_spec`) without the layer entry."""
        stack, _, rest = name.partition(".")
        if stack in _STACKS:
            leaf = f"{stack}.{rest.partition('.')[2]}"
            return self.param_spec(leaf, (1,) + tuple(shape))[1:]
        return self.param_spec(name, tuple(shape))

    def distribute(self, model):
        """Every parameter of ``model`` replaced, in place, by a DTensor on
        ``self.mesh`` placed by `tensor_spec`, built from this rank's slice
        of the whole tensor (`local_slice`); returns ``model``. The local
        bytes of every parameter are `local_shape`'s, exactly
        (`check_distributed`)."""
        from torch import nn
        for mod_name, mod in model.named_modules():
            for pname, p in list(mod._parameters.items()):
                if p is None:
                    continue
                name = f"{mod_name}.{pname}" if mod_name else pname
                spec = self.tensor_spec(name, tuple(p.shape))
                mod._parameters[pname] = nn.Parameter(
                    self.place(p.detach(), spec),
                    requires_grad=p.requires_grad)
        return model

    def check_distributed(self, model) -> int:
        """The bytes of this rank's parameters, after checking that each
        parameter is a DTensor whose local shape is `local_shape` of its
        spec; raises on the first that is not."""
        total = 0
        for name, p in model.named_parameters():
            spec = self.tensor_spec(name, tuple(p.shape))
            want = local_shape(spec, tuple(p.shape), self.mesh)
            got = tuple(p.to_local().shape)
            if got != want or tuple(p.placements) != placements(spec,
                                                                 self.mesh):
                raise AssertionError(f"{name}: local {got} "
                                     f"{p.placements}, spec {spec} gives "
                                     f"{want}")
            total += p.to_local().nbytes
        return total

    def place(self, t, spec: tuple):
        """``t`` as a DTensor placed by ``spec``: a plain tensor by this
        rank's slice (every rank holds the same whole tensor), a DTensor by
        `redistribute`."""
        from torch.distributed.tensor import DTensor
        pl = placements(spec, self.mesh)
        if isinstance(t, DTensor):
            return t.redistribute(self.mesh, pl)
        return DTensor.from_local(local_slice(t, spec, self.mesh),
                                  self.mesh, pl, run_check=False)

    def distribute_cache(self, cache: dict, prefix: str = "") -> dict:
        """A decode cache (nested dict of tensors) placed by `cache_spec`
        of each leaf's dotted name."""
        out = {}
        for k, v in cache.items():
            name = f"{prefix}{k}"
            out[k] = (self.distribute_cache(v, f"{name}.")
                      if isinstance(v, dict)
                      else self.place(v, self.cache_spec(name,
                                                         tuple(v.shape))))
        return out

    def distribute_batch(self, batch: dict) -> dict:
        """A batch's tensors placed by `batch_spec`: each rank keeps its
        data shard of the rows."""
        specs = self.batch_spec({k: tuple(v.shape) for k, v in
                                 batch.items()})
        return {k: self.place(v, specs[k]) for k, v in batch.items()}


def local_slice(t, spec: tuple, mesh):
    """This rank's block of the whole tensor ``t`` under ``spec`` on the
    `DeviceMesh` ``mesh`` (a copy): each tensor dim split evenly over its
    axes, the major axis first, as `placements` orders them."""
    names = tuple(mesh_shape(mesh))
    coord = mesh.get_coordinate()
    out = t
    for d, entry in enumerate(spec):
        for a in spec_axes(entry):
            i = names.index(a)
            n = out.shape[d] // mesh.size(i)
            out = out.narrow(d, coord[i] * n, n)
    return out.clone(memory_format=torch.contiguous_format)


def gather(model):
    """The inverse of `ShardingRules.distribute`: every DTensor parameter
    of ``model`` replaced, in place, by its whole tensor (`full_tensor`);
    returns ``model``."""
    from torch import nn
    from torch.distributed.tensor import DTensor
    for mod in model.modules():
        for pname, p in list(mod._parameters.items()):
            if isinstance(p, DTensor):
                mod._parameters[pname] = nn.Parameter(
                    p.detach().full_tensor(),
                    requires_grad=p.requires_grad)
    if hasattr(model, "logical"):
        model.logical = model.tp_rules = None
    return model
