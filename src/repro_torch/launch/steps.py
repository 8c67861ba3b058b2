"""Build the step of every (architecture x shape x mesh) cell for the
dry-run: the port of the JAX package's `launch/steps.py`.

The reference builds abstract sharded inputs (`jax.eval_shape`
ShapeDtypeStructs with NamedShardings) and lowers the jitted step. The
port has no partitioner: a `Cell` holds the model built shape-only on the
meta device (`api.build_model(cfg, generator=None, device="meta")`, full
width, nothing allocated), the specs `ShardingRules` gives its leaves, and
the inputs of ONE device's share of the step: its data shard of the batch
(a microbatch of it, for training) and its shard of the decode cache's
batch. `Cell.run` runs that step on meta tensors under `op_cost.analyze`.

On a real `DeviceMesh` (the counterpart of the reference's
``Cell.lower(mesh)``) the cell holds the model drawn from a seed on the
mesh's device and placed on the mesh for tensor parallelism
(`api.distribute` with the cell's rules), and the step's whole inputs
placed by the rules: a microbatch of the global batch by `batch_spec`,
the decode cache by `cache_spec`; a train cell places its optimizer
state by `ShardingRules.state_spec` (ZeRO-1, FSDP) and brings each
gradient to its parameter's placement before the update, as
`TensorParallelTrainer` does. `Cell.run` then executes that step on every
rank of the mesh under `sharding.tp_context`, counted the same way,
DTensor's collectives included. On a fake process group's mesh
(`launch.mesh.fake_mesh`) the model and the inputs are shape-only, on the
meta device: the dry-run counts rank 0's share of the production mesh's
step.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import configs
from repro_torch.launch.mesh import data_axis_size, is_fake, mesh_shape
from repro_torch.launch.op_cost import Costs, analyze
from repro_torch.launch.sharding import ShardingRules, spec_axes
from repro_torch.models import api
from repro_torch.models.config import SHAPES, ArchConfig, ShapeConfig
from repro_torch.models.encdec import DEC_PREFILL_LEN
from repro_torch.models.sharding import logical_rules, tp_context
from repro_torch.optim import make_optimizer
from repro_torch.optim.grad_compress import compress, init_error_state
from repro_torch.optim.tree import leaves_of, like

# Per-arch training knobs (optimizer, microbatch budget). Microbatch count
# is clamped so each microbatch still fills the data axis.
TRAIN_KNOBS = {
    "llama3-405b": dict(optimizer="adafactor", microbatches=16,
                        seq_parallel=True, acc_dtype="bfloat16",
                        opt_kwargs=dict(master=False)),
    "granite-34b": dict(optimizer="adafactor", microbatches=8,
                        seq_parallel=True),
    "qwen3-moe-30b-a3b": dict(optimizer="adafactor", microbatches=8,
                              seq_parallel=True),
    "yi-9b": dict(optimizer="adamw", microbatches=4, fsdp=True),
    "zamba2-7b": dict(optimizer="adamw", microbatches=4, fsdp=True),
    "granite-moe-3b-a800m": dict(optimizer="adamw", microbatches=4,
                                 fsdp=True),
    "seamless-m4t-large-v2": dict(optimizer="adamw", microbatches=4),
    "internvl2-1b": dict(optimizer="adamw", microbatches=2),
    "mamba2-130m": dict(optimizer="adamw", microbatches=1),
    "smollm-135m": dict(optimizer="adamw", microbatches=1),
}

def train_knobs(arch: str) -> dict:
    """How the arch's train cell trains, from `TRAIN_KNOBS`: its
    ``optimizer`` and ``opt_kwargs`` (llama3-405b: Adafactor without
    masters), ``acc_dtype``, ``fsdp`` (None: the rules' size test decides)
    and ``seq_axis`` (``"model"`` where the knobs set sequence
    parallelism)."""
    k = TRAIN_KNOBS[arch]
    return {"optimizer": k["optimizer"],
            "opt_kwargs": dict(k.get("opt_kwargs", {})),
            "acc_dtype": k.get("acc_dtype", "float32"),
            "fsdp": k.get("fsdp"),
            "seq_axis": "model" if k.get("seq_parallel") else None}


# Tiny archs: pure DP — a 16-way TP axis would idle on 9-head / 1536-ff
# dims and replicate attention score memory.
DP_ONLY_ARCHS = {"smollm-135m", "mamba2-130m"}

# Cells skipped by assignment policy.
FULL_ATTENTION_ARCHS = {
    "smollm-135m", "yi-9b", "llama3-405b", "granite-34b", "internvl2-1b",
    "qwen3-moe-30b-a3b", "granite-moe-3b-a800m", "seamless-m4t-large-v2",
}


def cell_is_skipped(arch: str, shape: str) -> str | None:
    if shape == "long_500k" and arch in FULL_ATTENTION_ARCHS:
        return ("long_500k needs sub-quadratic attention; "
                f"{arch} is pure full-attention (skip per assignment)")
    return None


def _microbatches(arch, global_batch, dsize):
    """The reference's count, except where no count fills the data axis
    (a global batch below it): 1 here, where the reference's loop reaches
    0 and divides by it."""
    want = TRAIN_KNOBS[arch]["microbatches"]
    n = min(want, max(1, global_batch // dsize))
    while n > 1 and (global_batch % n or (global_batch // n) % dsize):
        n -= 1
    return n


def batch_struct(cfg: ArchConfig, shape: ShapeConfig, kind: str,
                 batch: int | None = None) -> dict:
    """Input batch per shape kind as meta tensors (the input_specs()
    contract), of ``batch`` rows (default: the shape's global batch)."""
    B, S = batch or shape.global_batch, shape.seq_len

    def t(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    i32, f32 = torch.int32, torch.float32
    if kind == "train":
        b = {"inputs": t((B, S), i32), "targets": t((B, S), i32),
             "mask": t((B, S), f32)}
        if cfg.family == "vlm":
            b["frontend"] = t((B, cfg.n_frontend_tokens, cfg.d_model), f32)
        elif cfg.family == "encdec":
            b["frontend"] = t((B, S, cfg.d_model), f32)
        return b
    if kind == "prefill":
        if cfg.family == "encdec":
            # long input is the AUDIO side; decoder prefills a short prefix
            return {"inputs": t((B, DEC_PREFILL_LEN), i32),
                    "frontend": t((B, S, cfg.d_model), f32)}
        b = {"inputs": t((B, S), i32)}
        if cfg.family == "vlm":
            b["frontend"] = t((B, cfg.n_frontend_tokens, cfg.d_model), f32)
        return b
    raise ValueError(kind)


def _batch_ways(rules: ShardingRules, global_batch: int) -> int:
    """The devices a global batch is split over (1 when it is not)."""
    sizes = mesh_shape(rules.mesh)
    n = 1
    for a in spec_axes(rules.batch_axis(global_batch)):
        n *= sizes[a]
    return n


def _storage(t: torch.Tensor):
    """The storage of ``t``, of this rank's block for a DTensor."""
    from torch.distributed.tensor import DTensor
    return (t._local_tensor if isinstance(t, DTensor) else t
            ).untyped_storage()


def _storage_key(t: torch.Tensor):
    return _storage(t)._cdata


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    cfg: ArchConfig
    kind: str
    rules: ShardingRules
    logical: dict
    model: torch.nn.Module       # shape-only, on the meta device
    inputs: dict                 # one device's share (see module doc)
    n_micro: int = 1
    knobs: dict = dataclasses.field(default_factory=dict)
    grad_compress: bool = False

    def leaves(self) -> dict:
        return api.reference_leaves(self.model, self.cfg)

    def leaf_shapes(self) -> dict:
        """{leaf name: (stacked shape, dtype)} in the reference's tree."""
        out = {}
        for k, v in self.leaves().items():
            t = v[0] if isinstance(v, list) else v
            shp = ((len(v),) if isinstance(v, list) else ()) + \
                tuple(t.shape)
            out[k] = (shp, t.dtype)
        return out

    def param_specs(self) -> dict:
        return {k: self.rules.param_spec(k, s)
                for k, (s, _) in self.leaf_shapes().items()}

    def run(self) -> tuple:
        """One device's step, counted: (`Costs`, the bytes of the
        activations it keeps). Training counts one microbatch's forward
        and backward ``n_micro`` times plus one optimizer update, and keeps
        one microbatch's saved tensors (weights excluded); prefill and
        decode keep the largest tensor one op makes. On a `MeshShape` it
        runs on meta tensors under the cell's logical rules, where the
        annotations change nothing (the tensors are plain); on a
        `DeviceMesh` every rank runs its part of the sharded step under
        `tp_context`."""
        ctx = (tp_context if isinstance(self.rules.mesh, DeviceMesh)
               else logical_rules)
        with ctx(self.logical):
            return self._run()

    def _run(self) -> tuple:
        model, cfg = self.model, self.cfg
        if self.kind != "train":
            with torch.no_grad():
                if self.kind == "prefill":
                    _, costs = analyze(model.prefill, self.inputs["batch"])
                else:
                    _, costs = analyze(model.decode_step,
                                       self.inputs["cache"],
                                       self.inputs["token"],
                                       self.inputs["pos"])
            return costs, costs.max_result
        model.requires_grad_(True)
        leaves = self.leaves()
        params = leaves_of(leaves)
        skip = {_storage_key(p) for p in params}
        saved: dict = {}

        def pack(t):
            key = _storage_key(t)
            if key not in skip:
                saved[key] = _storage(t).nbytes()
            return t

        def micro():
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                loss, _ = api.loss_fn(model, cfg, self.inputs["batch"])
            return torch.autograd.grad(loss, params, allow_unused=True)

        grads, mb = analyze(micro)
        act = sum(saved.values())
        acc = getattr(torch, self.knobs.get("acc_dtype", "float32"))
        grads = [torch.zeros_like(p, dtype=acc) if g is None else g.to(acc)
                 for p, g in zip(params, grads)]
        grads = like(leaves, [g.to(torch.float32) for g in grads])
        kw = dict(self.knobs.get("opt_kwargs", {}))
        sharded = isinstance(self.rules.mesh, DeviceMesh)
        if sharded and self.rules.zero1:
            kw["place"] = lambda t, leaf: self.rules.place(
                t, self.rules.state_spec(leaf, t.shape))
        opt = make_optimizer(self.knobs["optimizer"], lr=1e-4, **kw)
        state = opt.init(leaves)

        def update(grads):
            if self.grad_compress:
                grads, _ = compress(grads, init_error_state(leaves))
            if sharded:      # as `TensorParallelTrainer.reduce`
                grads = like(leaves, [
                    g.redistribute(p.device_mesh, p.placements)
                    for g, p in zip(leaves_of(grads), params)])
            opt.update(grads, state, leaves)

        _, up = analyze(update, grads)
        costs = Costs()
        costs.add(mb, self.n_micro)
        costs.add(up)
        return costs, act


def build_cell(arch: str, shape_name: str, mesh, *, fsdp=None, zero1=True,
               grad_compress=False, seq_shard_cache=True,
               microbatches=None, dp_only=None, seq_axis=None,
               cfg: ArchConfig | None = None,
               shape: ShapeConfig | None = None) -> Cell:
    """The cell of ``arch`` (its full config unless ``cfg`` is given) at
    ``shape_name`` (`SHAPES`' unless ``shape`` is given) on ``mesh``, a
    `MeshShape` (shape-only, one device's share) or a `DeviceMesh` (the
    sharded step itself, every rank of the mesh calling this)."""
    cfg = cfg or configs.get(arch)
    shape = shape or SHAPES[shape_name]
    if dp_only is None:
        # tiny archs: pure DP for train/prefill; decode keeps TP so the
        # 32k KV cache can be seq-sharded over the model axis
        dp_only = arch in DP_ONLY_ARCHS and shape.kind != "decode"
    knobs = train_knobs(arch)
    if fsdp is None:
        fsdp = knobs["fsdp"]
    rules = ShardingRules(cfg, mesh, fsdp=fsdp, zero1=zero1,
                          seq_shard_cache=seq_shard_cache, dp_only=dp_only)
    if seq_axis is None and shape.kind != "decode":
        seq_axis = knobs["seq_axis"]
    # E that doesn't divide the model axis shards the dispatch capacity
    # instead of the experts (granite-moe: E=40 on a 16-way axis)
    logical = api.logical_rules_for(cfg, rules,
                                    global_batch=shape.global_batch,
                                    seq_axis=seq_axis)
    real = isinstance(mesh, DeviceMesh)
    fake = is_fake(mesh)
    if real:
        # on a fake group: shape-only, nothing allocated
        model = api.build_model(
            cfg, generator=None if fake else torch.Generator().manual_seed(0),
            device="meta" if fake else mesh.device_type)
        api.distribute(model, cfg, mesh, fsdp=fsdp, zero1=zero1,
                       seq_shard_cache=seq_shard_cache, dp_only=dp_only,
                       seq_axis=seq_axis, global_batch=shape.global_batch)
        ways = 1            # the inputs are whole, placed by the rules
    else:
        model = api.build_model(cfg, generator=None, device="meta")
        ways = _batch_ways(rules, shape.global_batch)
    common = dict(arch=arch, shape=shape, cfg=cfg, rules=rules,
                  logical=logical, model=model)

    def inputs(batch: dict) -> dict:
        if not real:
            return batch
        if fake:
            return rules.distribute_batch(batch)
        g = torch.Generator().manual_seed(0)
        out = {}
        for k, v in batch.items():
            t = (torch.randint(0, cfg.vocab, v.shape, generator=g,
                               dtype=v.dtype) if k in ("inputs", "targets")
                 else torch.ones(v.shape) if k == "mask"
                 else torch.randn(v.shape, generator=g))
            out[k] = t.to(mesh.device_type)
        return rules.distribute_batch(out)

    if shape.kind == "train":
        knobs = TRAIN_KNOBS[arch]
        n_mb = microbatches or _microbatches(arch, shape.global_batch,
                                             data_axis_size(mesh))
        per = max(1, shape.global_batch // n_mb // ways)
        return Cell(kind="train", n_micro=n_mb, knobs=knobs,
                    grad_compress=grad_compress,
                    inputs={"batch": inputs(batch_struct(cfg, shape,
                                                         "train", per))},
                    **common)
    per = max(1, shape.global_batch // ways)
    if shape.kind == "prefill":
        return Cell(kind="prefill",
                    inputs={"batch": inputs(batch_struct(cfg, shape,
                                                         "prefill", per))},
                    **common)
    cache = model.make_decode_cache(per, shape.seq_len)
    token = torch.zeros((per, 1), dtype=torch.int32,
                        device=mesh.device_type if real and not fake
                        else "meta")
    return Cell(kind="decode", inputs={"cache": cache, "token": token,
                                       "pos": shape.seq_len - 1}, **common)
