"""Family dispatcher, as in the JAX package's `models/api.py`: the
reference picks a module by family over a bare parameter tree; here
`build_model` picks the model class, and the model's own methods
(`forward`, `forward_hidden`, `prefill`, `decode_step`, `decode_hidden`,
`make_decode_cache`, `cache_insert_slot`) are the entry points.
`loss_fn` is the training loss over a model, and `reference_leaves`
groups a model's parameters as the reference's stacked parameter tree.
`distribute` places a model on a (data, model) `DeviceMesh` for tensor
parallelism, with the rules the reference's launcher builds.

The dense, moe and vlm families run `transformer.py`, the ssm and hybrid
families `hybrid.py`, the encdec family `encdec.py`.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.config import ArchConfig
from repro_torch.models.encdec import EncDec
from repro_torch.models.hybrid import Hybrid
from repro_torch.models.sharding import is_dtensor, rules_for_mesh
from repro_torch.models.transformer import Transformer

_MOE_AUX_WEIGHT = 0.01

_FAMILIES = {"dense": Transformer, "moe": Transformer, "vlm": Transformer,
             "ssm": Hybrid, "hybrid": Hybrid, "encdec": EncDec}


def build_model(cfg: ArchConfig, *, generator: torch.Generator | None,
                device="cuda") -> nn.Module:
    """The model of ``cfg`` with weights drawn from ``generator``, on
    ``device``. ``generator=None`` builds it shape-only, which only the
    meta device takes: every weight is ``torch.empty`` there and nothing
    is drawn (the dry-run's full-width models)."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    if generator is None and torch.device(device).type != "meta":
        raise ValueError(f"a model without a generator is shape-only and "
                         f"is built on the meta device, not {device!r}")
    return _FAMILIES[cfg.family](cfg, generator=generator, device=device)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def masked_ce(logits: torch.Tensor, targets, mask=None) -> tuple:
    """Masked next-token cross entropy of (B, S, V) logits, in float32, the
    mask defaulting to ones: (``nll / max(mask.sum(), 1)``, the mask's
    sum). The gold logit is picked by an iota compare, as the reference
    does, so its gradient is a ``where`` (no scatter).

    Vocab-sharded logits (a DTensor) meet the iota and the targets as
    replicated tensors, and their log-sum-exp is taken over the sharded
    dim as a max and a sum (each a small all-reduce; `torch.logsumexp`
    would gather the whole logits first)."""
    logits = logits.float()
    dev = logits.device
    targets = torch.as_tensor(targets, device=dev)
    mask = (torch.ones(targets.shape, device=dev) if mask is None
            else torch.as_tensor(mask, device=dev).float())
    if is_dtensor(logits):
        top = logits.detach().amax(dim=-1, keepdim=True)
        logz = torch.log(torch.exp(logits - top).sum(-1)) + top[..., 0]
    else:
        logz = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(logits.shape[-1], device=dev)
    gold = torch.where(iota == targets[..., None], logits, 0.0).sum(-1)
    tokens = mask.sum()
    return ((logz - gold) * mask).sum() / torch.clamp(tokens, min=1.0), \
        tokens


def loss_fn(model: nn.Module, cfg: ArchConfig, batch) -> tuple:
    """The reference's ``loss_fn``: `masked_ce` of the model's logits (+ the
    MoE load-balance aux). Returns (loss, metrics ``nll``, ``aux``,
    ``tokens``)."""
    logits, aux = model(batch)
    loss, tokens = masked_ce(logits, batch["targets"], batch.get("mask"))
    metrics = {"nll": loss, "aux": aux, "tokens": tokens}
    if cfg.family == "moe":
        loss = loss + _MOE_AUX_WEIGHT * aux
    return loss, metrics


def reference_leaves(model: nn.Module, cfg: ArchConfig) -> dict:
    """The model's parameters grouped as the reference's parameter tree,
    by its dotted leaf name, in the reference's leaf order (each level's
    keys sorted). The reference stacks each layer leaf over the layers: a
    name under ``layers`` (``enc_layers``, ``dec_layers``) maps to the list
    of its per-layer tensors, ``layers.<i>.attn.wq`` at index i of
    ``layers.attn.wq``. Every other leaf (the embedding, the norms, the
    hybrid family's one ``shared_attn`` block) maps to its tensor."""
    depth = {"layers": cfg.n_layers,
             "enc_layers": cfg.n_enc_layers or cfg.n_layers,
             "dec_layers": cfg.n_dec_layers or cfg.n_layers}
    out: dict = {}
    for name, p in model.named_parameters():
        stack, _, rest = name.partition(".")
        if stack in depth:
            i, _, leaf = rest.partition(".")
            out.setdefault(f"{stack}.{leaf}", [None] * depth[stack])[
                int(i)] = p
        else:
            out[name] = p
    return {k: out[k] for k in sorted(out, key=lambda k: k.split("."))}


def logical_rules_for(cfg: ArchConfig, rules, *, global_batch=None,
                      seq_axis=None) -> dict:
    """The logical rules of ``rules`` (a `launch.sharding.ShardingRules`)
    as the reference's launcher builds them (`launch/steps.py::
    build_cell`): `rules_for_mesh` of its mesh, the batch on
    ``rules.batch_axis(global_batch)`` where a global batch is given, and
    for a moe config whose experts do not divide the model axis the
    dispatch capacity sharded in their place."""
    from repro_torch.launch.mesh import mesh_shape
    logical = rules_for_mesh(
        tuple(mesh_shape(rules.mesh)), dp_only=rules.dp_only,
        batch_axes=(None if global_batch is None
                    else rules.batch_axis(global_batch)),
        seq_axis=seq_axis)
    if cfg.family == "moe" and not rules.dp_only \
            and cfg.n_experts % rules.msize != 0:
        logical["experts"] = None
        logical["moe_capacity"] = "model"
    return logical


def distribute(model: nn.Module, cfg: ArchConfig, mesh, *, fsdp=False,
               zero1=False, seq_shard_cache=True, dp_only=False,
               seq_axis=None, global_batch=None) -> nn.Module:
    """Tensor parallelism: ``model``'s parameters turned into DTensors on
    the `DeviceMesh` ``mesh`` by `ShardingRules` (the reference's
    parameter specs; every rank must hold the same whole weights, as
    models drawn from one seed do), in place. Its entry points then run
    under `sharding.tp_context` of the logical rules the reference's
    launcher builds (`logical_rules_for`), and its decode caches are
    placed by `cache_spec`. Returns ``model``, with ``tp_rules`` (the
    `ShardingRules`) and ``logical`` set."""
    from repro_torch.launch.sharding import ShardingRules
    rules = ShardingRules(cfg, mesh, fsdp=fsdp, zero1=zero1,
                          seq_shard_cache=seq_shard_cache, dp_only=dp_only)
    rules.distribute(model)
    model.tp_rules = rules
    model.logical = logical_rules_for(cfg, rules, global_batch=global_batch,
                                      seq_axis=seq_axis)
    return model
