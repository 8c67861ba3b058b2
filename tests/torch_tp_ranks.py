"""Rank bodies of `tests/test_torch_tensor_parallel.py` (and the ``gpu``
test of tensor parallelism) for `repro_torch.launch.mesh.spawn`:
module-level functions of a module that imports only the port, so that a
fresh rank process imports them by name without loading JAX.

`group_body` runs every task of the 4-rank group on its (2, 2) (data,
model) mesh and on a (1, 4) mesh built inside it, and returns plain host
objects (numpy arrays, tuples, strings): the tensor-parallel outputs of
the models, the placements each annotation gave, the parameter bytes, the
training losses and gradients, the cells' counted collectives and
`op_cost`'s count of a row-parallel product. `decode_body` runs one TP
decode step against the one-device step on the mesh's device.
"""

import numpy as np
import torch

from repro_torch import configs, convert
from repro_torch.data.pipeline import PipelineConfig, SyntheticTokens
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.op_cost import analyze
from repro_torch.launch.sharding import gather, placements
from repro_torch.launch.steps import build_cell
from repro_torch.models import api, encdec, layers, moe, ssm, transformer
from repro_torch.models.config import ShapeConfig
from repro_torch.models.sharding import (full, logical_spec, shard,
                                         tp_context)
from repro_torch.train.tensor_parallel import TensorParallelTrainer
from repro_torch.train.trainer import TrainConfig

# the port's modules that call `shard` by that name
SHARD_MODULES = (layers, moe, ssm, transformer, encdec)


def _np(t) -> np.ndarray:
    return full(t).detach().cpu().numpy().copy()


def _t(batch: dict, device="cpu") -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class _Recorder:
    """`shard` in every module of `SHARD_MODULES`, recording each call's
    names, the placements it gave and the placements the rules name."""

    def __init__(self):
        self.calls: list = []

    def __call__(self, x, *names):
        from repro_torch.models.sharding import current_rules, is_dtensor
        y = shard(x, *names)
        if is_dtensor(y):
            want = placements(logical_spec(current_rules(), names),
                              y.device_mesh)
            self.calls.append((names, str(tuple(y.placements)), str(want)))
        return y

    def __enter__(self):
        for m in SHARD_MODULES:
            m.shard = self
        return self

    def __exit__(self, *exc):
        for m in SHARD_MODULES:
            m.shard = shard


def run_model(mesh, case: dict) -> dict:
    """One case of ``case``: the smoke config of ``case["arch"]`` on the
    reference's weights, placed on ``mesh`` (``case["rules"]`` the keywords
    of `api.distribute`): its whole forward logits, prefill logits and the
    logits of each decode step (``toks``, ``pos``), placements recorded
    over the forward where ``case["record"]`` and its collectives' sites
    (`op_cost.analyze`) where ``case["sites"]``. A case without decode
    steps gathers its model whole again (`gather`) and runs its forward
    once more."""
    cfg = configs.get_smoke(case["arch"])
    model = convert.model_from_jax_params(cfg, case["params"], device="cpu",
                                          mesh=mesh, **case["rules"])
    out = {"bytes": model.tp_rules.check_distributed(model)}
    batch = _t(case["batch"])
    with torch.no_grad():
        if case.get("record"):
            with _Recorder() as rec:
                logits, _ = model(batch)
            out["placements"] = rec.calls
        if case.get("sites"):
            _, costs = analyze(model, batch)
            out["sites"] = costs.sites
        else:
            logits, _ = model(batch)
        out["forward"] = _np(logits)
        if not case.get("decode", True):
            gather(model)              # whole again: a one-device model
            out["gathered_forward"] = _np(model(batch)[0])
            return out
        logits, cache, _ = model.prefill(batch, max_seq=case["max_seq"])
        out["prefill"] = _np(logits)
        kv = cache.get("k", cache.get("kv", {}).get("k"))
        if kv is not None:
            out["cache_placements"] = str(tuple(kv.placements))
        out["decode"] = []
        for tok, pos in zip(case["toks"], case["pos"]):
            logits, cache = model.decode_step(cache, torch.as_tensor(tok),
                                              torch.as_tensor(pos))
            out["decode"].append(_np(logits))
    return out


def run_training(mesh, case: dict) -> dict:
    """``case["steps"]`` `TensorParallelTrainer` steps of the smoke config
    on the reference's weights (the trainer's keywords ``case["trainer"]``:
    ``zero1``, ``fsdp``, ``seq_axis``): each step's loss and gnorm, the
    final weights whole, this rank's bytes of parameters and optimizer
    state, and where ``case["grads"]`` the first batch's gradients (before
    any update) as the reference's tree."""
    cfg = configs.get_smoke(case["arch"])
    model = convert.model_from_jax_params(cfg, case["params"], device="cpu")
    t = TensorParallelTrainer(
        cfg, TrainConfig(optimizer=case["optimizer"], lr=case["lr"]),
        SyntheticTokens(PipelineConfig(**case["pipe"])), mesh, model=model,
        **case.get("trainer", {}))
    out = {}
    if case.get("grads"):
        with tp_context(t.model.logical):
            mb = t.place(_t(t.pipeline.batch(0)))
            loss, _ = api.loss_fn(t.model, cfg, mb)
            grads = torch.autograd.grad(loss, t.params)
            for p, g in zip(t.params, grads):
                p.grad = g.redistribute(p.device_mesh, p.placements)
        out["grads"] = convert.jax_tree_from_model(cfg, t.model, grads=True)
        for p in t.params:
            p.grad = None
    out["loss"], out["gnorm"] = [], []
    for step in range(case["steps"]):
        m = t.train_step(t.pipeline.batch(step))
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["gnorm"]))
    out["weights"] = _weights(t)
    out["opt_bytes"] = t.state_bytes()
    out["param_bytes"] = t.rules.check_distributed(t.model)
    out["seq"] = t.model.logical["seq"]
    return out


def _weights(t) -> dict:
    return {n: _np(p) for n, p in t.model.named_parameters()}


def run_checkpoints(mesh, case: dict) -> dict:
    """Checkpoints across meshes, AdamW on the smoke config: a
    `TensorParallelTrainer` on the (2, 2) mesh writes one at step 2 into
    ``case["dirs"][0]``; the uninterrupted run's 4 losses and weights; that
    checkpoint restored on the (2, 2), (1, 4) and (4, 1) meshes and on one
    device (`Trainer`), 2 more steps each; and the reverse: a one-device
    `Trainer`'s checkpoint at step 2 (the first rank writes it into
    ``case["dirs"][1]``) restored on the (2, 2) mesh. Each run: (losses
    after the restore, the step restored, the final weights)."""
    import torch.distributed as dist
    from repro_torch.train.trainer import Trainer
    cfg = configs.get_smoke(case["arch"])

    def trainer(m, ckpt="", every=100):
        model = convert.model_from_jax_params(cfg, case["params"],
                                              device="cpu")
        tc = TrainConfig(optimizer="adamw", lr=case["lr"], ckpt_dir=ckpt,
                         ckpt_every=every)
        pipe = SyntheticTokens(PipelineConfig(**case["pipe"]))
        if m is None:
            return Trainer(cfg, tc, pipe, model=model, device="cpu")
        return TensorParallelTrainer(cfg, tc, pipe, m, model=model)

    def resumed(m, ckpt) -> tuple:
        t = trainer(m, ckpt)
        assert t.try_restore()
        step = t.step
        t.run(4, log_every=0)
        return t.history, step, {n: full(p).detach().numpy().copy()
                                 for n, p in t.model.named_parameters()}

    tp_dir, one_dir = case["dirs"]
    trainer(mesh, tp_dir, 2).run(2, log_every=0)
    b = trainer(mesh)
    b.run(4, log_every=0)
    out = {"uninterrupted": (b.history, 0, _weights(b))}
    meshes = {"2x2": mesh,
              "1x4": make_debug_mesh((1, 4), ("data", "model"), "cpu"),
              "4x1": make_debug_mesh((4, 1), ("data", "model"), "cpu")}
    for name, m in meshes.items():
        out[name] = resumed(m, tp_dir)
    out["one"] = resumed(None, tp_dir)
    if not any(mesh.get_coordinate()):
        trainer(None, one_dir, 2).run(2, log_every=0)
    dist.barrier()
    out["from_one"] = resumed(mesh, one_dir)
    return out


# the real-mesh cells: (arch, kind, dp_only); the FSDP archs' train cells
# take FSDP from their knobs
CELLS = (("smollm-135m", "train", False), ("smollm-135m", "prefill", False),
         ("smollm-135m", "decode", False), ("yi-9b", "train", None),
         ("granite-moe-3b-a800m", "train", None),
         ("zamba2-7b", "train", None))


def run_cells(mesh) -> dict:
    """`build_cell` of each of `CELLS` (smoke configs) on the real mesh,
    run: its counted collectives, by ``arch kind``."""
    out = {}
    for arch, kind, dp_only in CELLS:
        shape = ShapeConfig(name=f"tp_{kind}", kind=kind, seq_len=16,
                            global_batch=4)
        cell = build_cell(arch, shape.name, mesh,
                          cfg=configs.get_smoke(arch), shape=shape,
                          dp_only=dp_only)
        costs, _ = cell.run()
        out[f"{arch} {kind}"] = dict(costs.coll_counts)
    return out


def fsdp_lookup(mesh) -> dict:
    """The smoke yi-9b's embedding placed with FSDP (its table ``(model,
    data)``): its lookup of a batch placed on the data axis, whole, beside
    the one-device table's indexing, and the table's placements."""
    cfg = configs.get_smoke("yi-9b")
    model = api.build_model(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    whole = model.embed.tok.detach().clone()
    api.distribute(model, cfg, mesh, fsdp=True, global_batch=4)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab, (4, 8), generator=g)
    with tp_context(model.logical):
        got = model.embed(model.tp_rules.distribute_batch({"i": ids})["i"])
    return {"got": _np(got), "want": whole[ids].numpy(),
            "placements": str(tuple(model.embed.tok.placements))}


def row_parallel(mesh) -> dict:
    """`op_cost` of a column- then row-parallel product on the mesh's
    model axis, the result brought whole: its collectives."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    m = mesh["model"]
    g = torch.Generator().manual_seed(0)
    x = DTensor.from_local(torch.randn(4, 8, generator=g), m, [Replicate()])
    w1 = distribute_tensor(torch.randn(8, 16, generator=g), m, [Shard(1)])
    w2 = distribute_tensor(torch.randn(16, 8, generator=g), m, [Shard(0)])
    y, c = analyze(lambda: (x @ w1 @ w2).redistribute(m, [Replicate()]))
    return {"counts": dict(c.coll_counts), "raw": dict(c.coll_raw),
            "y_bytes": y.to_local().nbytes}


def group_body(mesh, tasks: dict) -> dict:
    """Every task of the 4-rank group: ``models`` (`run_model`, each on
    the (2, 2) mesh or, where ``case["mesh"] == "1x4"``, on a (1, 4) mesh
    built here), ``train`` (`run_training`, on the same meshes), the
    cells, the row-parallel count and `route_body` on a 1-D mesh of the
    4 ranks."""
    wide = make_debug_mesh((1, 4), ("data", "model"), "cpu")
    out = {"coord": tuple(mesh.get_coordinate()), "models": {},
           "train": {}}
    for name, case in tasks["models"].items():
        out["models"][name] = run_model(
            wide if case.get("mesh") == "1x4" else mesh, case)
    for name, case in tasks["train"].items():
        out["train"][name] = run_training(
            wide if case.get("mesh") == "1x4" else mesh, case)
    out["checkpoints"] = run_checkpoints(mesh, tasks["checkpoints"])
    out["cells"] = run_cells(mesh)
    out["fsdp_lookup"] = fsdp_lookup(mesh)
    out["row_parallel"] = row_parallel(mesh)
    # last: it routes this process's functional collectives from here on
    out["route"] = route_body(make_debug_mesh((4,), ("all",), "cpu"))
    return out


def decode_body(mesh, device: str = "cuda") -> dict:
    """A float32 smoke SmolLM from one seed on the mesh's ranks: the
    tensor-parallel prefill and decode step against the one-device model's
    on ``device`` (whose matmuls run without TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke("smollm-135m")
    one = api.build_model(cfg, generator=torch.Generator().manual_seed(0),
                          device=device)
    tp = api.build_model(cfg, generator=torch.Generator().manual_seed(0),
                         device=device)
    api.distribute(tp, cfg, mesh)
    rng = np.random.default_rng(0)
    batch = {"inputs": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 7)),
                                       dtype=torch.int32, device=device)}
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 1)),
                          dtype=torch.int32, device=device)
    out = {}
    with torch.no_grad():
        for name, m in (("one", one), ("tp", tp)):
            _, cache, S = m.prefill(batch, max_seq=16)
            logits, _ = m.decode_step(cache, tok, S)
            out[name] = _np(logits)
    return out


def route_body(mesh) -> dict:
    """Every redistribution DTensor makes with a collective, by its native
    functional collectives and then through `launch.gloo_route` installed
    for CPU tensors: the local results of each (the route must give the
    same bits)."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from repro_torch.launch import gloo_route
    rank = mesh.get_coordinate()[0]
    x = torch.arange(32.0).reshape(4, 8) * (rank + 1) + 0.25
    moves = {"all-gather": ([Shard(0)], [Replicate()]),
             "all-gather dim 1": ([Shard(1)], [Replicate()]),
             "all-reduce": ([Partial()], [Replicate()]),
             "reduce-scatter": ([Partial()], [Shard(0)]),
             "all-to-all": ([Shard(0)], [Shard(1)])}

    def run():
        return {name: DTensor.from_local(x, mesh, src).redistribute(
            mesh, dst).to_local().numpy().copy()
            for name, (src, dst) in moves.items()}
    native = run()
    gloo_route.install("CPU")
    return {"native": native, "routed": run()}
