"""Multi-pod dry-run: every (arch x shape x mesh) cell of the production
layouts at full width, on the meta device, with an H100 roofline: the
port of the JAX package's `launch/dryrun.py`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers and compiles each cell on 512 placeholder CPU devices
and reads XLA's memory analysis and the partitioned HLO. The port needs
no card and no JAX: it runs rank 0's share of the cell's sharded step on
a fake process group of the production mesh (`launch.mesh.fake_mesh`:
256 or 512 ranks whose collectives move nothing), the model built
shape-only on the meta device and distributed by the cell's rules, its
inputs and optimizer state placed by the specs (`launch.steps.
build_cell`), and

counts (`launch.op_cost`, DTensor's local ops and collectives of rank 0):
  * ``flops_per_device`` and ``hbm_bytes_per_device``: the counted step's;
    the bytes are those of an eager step, which fuses nothing;
  * ``collectives`` (``"reckoned": false``): every collective rank 0
    issues, by kind, raw and on-wire bytes;
  * ``activation_bytes``: one microbatch's saved tensors (weights
    excluded), this rank's blocks; for prefill and decode, the largest
    tensor an op makes;
  * ``dtype_leak``: an op that made a float64 tensor;

reckons from the sharding specs (`launch.sharding`), per device, on the
mesh's shape (`MeshShape`, `abstract_production_mesh`):
  * ``memory``: parameter, optimizer, gradient, batch and cache bytes
    under their specs; ``peak_live_bytes`` is their sum with the
    activations, ``fits_hbm`` holds it against the card's 80 GiB;
  * ``collectives["reckoning"]``, the cross-check: the gradient all-reduce
    over the data axes a leaf is not sharded on; FSDP's two all-gathers a
    microbatch and its reduce-scatter; ZeRO-1's all-gather of the updated
    weights; the Megatron all-reduces of the activations where the rules
    shard heads and ff (two a transformer layer, three a decoder layer
    with cross-attention, one an SSM layer; each way in training);
  * ``roofline``: the three terms on the H100 data sheet's rates
    (`launch.roofline`), with ``model_flops_*`` and
    ``useful_flops_ratio``.

A cell whose sharded step fails keeps the figures of one device's
unsharded share of the step divided by the model axis, and the reckoned
collectives (``"reckoned": true``), with the failure in
``sharded_error``.

The default output is ``experiments/dryrun_torch/``, one JSON a cell;
``experiments/dryrun_counts/summary.py`` tabulates the counted
collectives against the reckoned.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.launch.mesh import (abstract_production_mesh, fake_mesh,
                                     mesh_shape)
from repro_torch.launch import op_cost
from repro_torch.launch.op_cost import TRACE_HEADER, Costs
from repro_torch.launch.roofline import HBM_PER_CHIP, Roofline, model_flops
from repro_torch.launch.sharding import local_shape, spec_axes
from repro_torch.launch.steps import build_cell, cell_is_skipped
from repro_torch.models.config import SHAPES

DEFAULT_OUT = "experiments/dryrun_torch"


def _nbytes(shape, itemsize) -> int:
    return math.prod(shape) * itemsize


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _memory(cell) -> dict:
    """Per-device bytes of the cell's state under its specs."""
    rules, mesh = cell.rules, cell.rules.mesh
    shapes = cell.leaf_shapes()
    specs = cell.param_specs()
    mem = {"param_bytes": 0, "opt_bytes": 0, "grad_bytes": 0,
           "batch_bytes": 0, "cache_bytes": 0}
    for k, (shp, dt) in shapes.items():
        local = local_shape(specs[k], shp, mesh)
        mem["param_bytes"] += _nbytes(local, _itemsize(dt))
        if cell.kind != "train":
            continue
        acc = _itemsize(getattr(torch, cell.knobs.get("acc_dtype",
                                                      "float32")))
        mem["grad_bytes"] += _nbytes(local, acc)
        if cell.grad_compress:
            mem["grad_bytes"] += _nbytes(local, 4)       # the residual
        state = ([(k, shp)] * 3 if cell.knobs["optimizer"] == "adamw"
                 else _adafactor_state(k, shp, cell.knobs.get(
                     "opt_kwargs", {}).get("master", True)))
        for leaf, s in state:
            mem["opt_bytes"] += _nbytes(local_shape(
                rules.state_spec(leaf, s), s, mesh), 4)
    ways = cell.n_micro if cell.kind == "train" else 1
    if "batch" in cell.inputs:
        mem["batch_bytes"] = ways * sum(
            t.nbytes for t in cell.inputs["batch"].values())
    else:
        mem["cache_bytes"] = _cache_bytes(cell)
        mem["batch_bytes"] = cell.inputs["token"].nbytes
    return mem


def _adafactor_state(leaf: str, shp: tuple, master: bool) -> list:
    """(leaf name or None, shape) of each state tensor Adafactor keeps for
    the stacked leaf ``leaf`` of ``shp``: its master, then its moments."""
    moments = ([shp[:-1], shp[:-2] + shp[-1:]] if len(shp) >= 2 else [shp])
    return [(leaf, shp)] * master + [(None, m) for m in moments]


def _cache_bytes(cell) -> int:
    """The decode cache's per-device bytes: the cell holds one device's
    batch share, so the batch axis is already divided; the model axis
    divides what `cache_spec` shards over it."""
    msize = mesh_shape(cell.rules.mesh).get("model", 1)
    total = 0

    def walk(tree, prefix):
        nonlocal total
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
                continue
            spec = cell.rules.cache_spec(f"{prefix}{k}", tuple(v.shape))
            model = any("model" in spec_axes(e) for e in spec)
            total += v.nbytes // (msize if model else 1)
    walk(cell.inputs["cache"], "")
    return total


def _megatron(cell) -> tuple:
    """(activation elements, all-reduces) of one forward pass where heads
    and ff are sharded: two all-reduces a transformer layer, three a
    decoder layer (self- and cross-attention, MLP), one an SSM layer, two
    a shared attention block; each of its layer's tokens x d_model."""
    cfg = cell.cfg
    if cell.kind == "decode":
        enc, dec = 0, cell.inputs["token"].shape[0]
    else:
        b = cell.inputs["batch"]
        dec = b["inputs"].numel()
        enc = b["frontend"].shape[0] * b["frontend"].shape[1] \
            if cfg.family == "encdec" else 0
    if cfg.family == "encdec":
        n_enc = 2 * (cfg.n_enc_layers or cfg.n_layers) if enc else 0
        n_dec = 3 * (cfg.n_dec_layers or cfg.n_layers)
        return (n_enc * enc + n_dec * dec) * cfg.d_model, n_enc + n_dec
    if cfg.family == "ssm":
        n = cfg.n_layers
    elif cfg.family == "hybrid":
        n = cfg.n_layers + 2 * (cfg.n_layers // cfg.attn_every
                                if cfg.attn_every else 0)
    else:
        n = 2 * cfg.n_layers
    return n * dec * cfg.d_model, n


def _collectives(cell) -> tuple:
    """The cell's per-device collectives, reckoned from its specs: (a
    `Costs` holding them, the labelled terms)."""
    rules, cfg, mesh = cell.rules, cell.cfg, cell.rules.mesh
    sizes = mesh_shape(mesh)
    costs, terms = Costs(), []

    def add(label, kind, raw, count):
        if raw and count:
            costs.add_collective(kind, raw, count)
            terms.append({"term": label, "kind": kind, "raw_bytes": raw,
                          "count": count})

    if cell.kind == "train":
        specs = cell.param_specs()
        gdt = 2 if cell.grad_compress else 4
        n = cell.n_micro
        ar = rs = ag_fsdp = ag_zero = n_ar = n_rs = n_fsdp = n_zero = 0
        for k, (shp, dt) in cell.leaf_shapes().items():
            spec = specs[k]
            named = {a for e in spec for a in spec_axes(e)}
            local = local_shape(spec, shp, mesh)
            g = _nbytes(local, gdt)
            rest = math.prod(sizes[a] for a in rules.dax if a not in named)
            if "data" in named:
                rs += g
                n_rs += 1
                ag_fsdp += 2 * n * _nbytes(local, _itemsize(dt)) * \
                    sizes["data"]
                n_fsdp += 2 * n
            if rest > 1:
                ar += g
                n_ar += 1
            ospec = rules.opt_spec(spec, shp)
            if "data" not in named and ospec[:1] == ("data",):
                ag_zero += _nbytes(local, _itemsize(dt))
                n_zero += 1
        add("gradient all-reduce over the unsharded data axes",
            "all-reduce", ar, n_ar)
        add("FSDP gradient reduce-scatter", "reduce-scatter", rs, n_rs)
        add("FSDP weight all-gathers (forward and backward, a microbatch)",
            "all-gather", ag_fsdp, n_fsdp)
        add("ZeRO-1 all-gather of the updated weights", "all-gather",
            ag_zero, n_zero)
    if not rules.dp_only and rules.msize > 1:
        elems, n = _megatron(cell)
        ways = 2 * cell.n_micro if cell.kind == "train" else 1
        add("Megatron activation all-reduces (heads / ff sharded)",
            "all-reduce", ways * elems * _itemsize(cfg.param_dtype),
            ways * n)
    return costs, terms


def _counted(arch, shape_name, mesh, cfg, shape, policy) -> tuple:
    """(`Costs`, activation bytes, the mesh's groups by name) of rank 0's
    share of the cell's sharded step, run on ``mesh``'s shape as a fake
    process group (`launch.mesh.fake_mesh`) on meta tensors. The groups map
    each mesh dim's process group name to the dim's name."""
    with fake_mesh(mesh.sizes, mesh.axis_names) as dm:
        cell = build_cell(arch, shape_name, dm, cfg=cfg, shape=shape,
                          **policy)
        groups = {dm.get_group(i).group_name: name
                  for i, name in enumerate(dm.mesh_dim_names)}
        return (*cell.run(), groups)


def _save_ops(rec: dict, costs, groups: dict, out_dir: str) -> str:
    """Rank 0's op trace of the counted step (`op_cost.TraceOp` lines,
    each collective's group by its mesh dims), gzip text beside the
    record: the counterpart of the reference's ``--save-hlo``."""
    import gzip
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.ops.txt.gz")
    counted = not rec["collectives"]["reckoned"]
    with gzip.open(path, "wt") as f:
        f.write(f"# {rec['arch']} {rec['shape']} {rec['mesh']}: "
                + ("rank 0's share of the sharded step on a fake process "
                   "group" if counted else "one device's unsharded share "
                   "of the step (the sharded step failed)")
                + f"; {len(costs.trace)} ops\n# {TRACE_HEADER}\n")
        for op in costs.trace:
            if op.collective:
                op = dataclasses.replace(op, group=groups.get(op.group,
                                                              op.group))
            f.write(op.line() + "\n")
    return path


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: str | None = None, verbose: bool = True,
             cfg=None, shape=None, mesh=None, save_hlo: bool = False,
             **policy) -> dict:
    """One cell's record (also written to ``out_dir``). ``cfg``, ``shape``
    and ``mesh`` (a `MeshShape`) override the arch's full config,
    `SHAPES`' shape and the production layout (the tests run smoke
    configs on small meshes). The sharded step is counted on a fake
    process group of the mesh's shape (`_counted`); a cell whose sharded
    step fails keeps the figures reckoned from one device's unsharded
    share (``"reckoned": true``; the failure in ``sharded_error``).
    ``save_hlo`` (with ``out_dir``) also writes the counted step's op
    trace (`_save_ops`, ``ops_file`` in the record)."""
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "policy": {k: v for k, v in policy.items() if v is not None}}
    skip = cell_is_skipped(arch, shape_name)
    if skip:
        rec.update(status="skipped", reason=skip)
        _emit(rec, out_dir, verbose)
        return rec
    try:
        mesh = mesh or abstract_production_mesh(multi_pod=(mesh_kind ==
                                                            "multi"))
        t0 = time.time()
        # one device's share, shape-only: the specs' memory and reckoning
        cell = build_cell(arch, shape_name, mesh, cfg=cfg, shape=shape,
                          **policy)
        t1 = time.time()
        reckoned, terms = _collectives(cell)
        reckoning = {"reckoned": True, "weighted": reckoned.coll_wire,
                     "raw": reckoned.coll_raw,
                     "counts": reckoned.coll_counts,
                     "total_weighted": reckoned.collective_bytes,
                     "total_raw": sum(reckoned.coll_raw.values()),
                     "terms": terms}
        trace = save_hlo and out_dir
        groups: dict = {}
        try:
            with op_cost.traced() if trace else contextlib.nullcontext():
                counted, act, groups = _counted(arch, shape_name, mesh, cfg,
                                                shape, policy)
            tp = 1                   # rank 0's share: nothing to divide
            coll = {"reckoned": False, "weighted": counted.coll_wire,
                    "raw": counted.coll_raw,
                    "counts": counted.coll_counts,
                    "total_weighted": counted.collective_bytes,
                    "total_raw": sum(counted.coll_raw.values()),
                    "reckoning": reckoning}
        except Exception as e:  # noqa: BLE001 — kept, reckoned
            counted = None
            rec["sharded_error"] = f"{type(e).__name__}: {e}"
            rec["sharded_traceback"] = traceback.format_exc()[-4000:]
        if counted is None:
            with op_cost.traced() if trace else contextlib.nullcontext():
                counted, act = cell.run()
            tp = cell.rules.msize
            coll = reckoning
        t2 = time.time()
        mem = _memory(cell)
        mem["activation_bytes"] = act / tp
        live = sum(mem.values())
        mem["peak_live_bytes"] = live
        mem["fits_hbm"] = bool(live <= HBM_PER_CHIP)
        flops = counted.flops / tp
        hbm = counted.bytes / tp
        roof = Roofline.from_costs(flops, hbm, coll["total_weighted"])
        mf = model_flops(cell.cfg, cell.shape, cell.kind)
        chips = math.prod(mesh_shape(mesh).values())
        rec.update(
            status="ok",
            kind=cell.kind,
            build_s=round(t1 - t0, 2),
            count_s=round(t2 - t1, 2),
            chips=chips,
            microbatches=cell.n_micro,
            local_batch={k: list(v.shape) for k, v in
                         cell.inputs.get("batch", {}).items()},
            counted_ops=counted.n_ops,
            memory=mem,
            flops_per_device=flops,
            hbm_bytes_per_device=hbm,
            collectives=coll,
            roofline=roof.to_dict(),
            model_flops_global=mf,
            model_flops_per_device=mf / chips,
            useful_flops_ratio=(mf / chips) / flops if flops else None,
            dtype_leak=bool(counted.f64_ops),
            f64_ops=sorted(counted.f64_ops),
        )
        if trace:
            rec["ops_file"] = _save_ops(rec, counted, groups, out_dir)
    except Exception as e:  # noqa: BLE001 — a failed cell is a data point
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    _emit(rec, out_dir, verbose)
    return rec


def _emit(rec, out_dir, verbose):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        if rec["status"] == "ok":
            m = rec["memory"]
            r = rec["roofline"]
            print(f"[OK] {rec['arch']} {rec['shape']} {rec['mesh']} "
                  f"count={rec['count_s']}s "
                  f"live={m['peak_live_bytes']/2**30:.2f}GiB "
                  f"fits={m['fits_hbm']} "
                  f"terms(c/m/x)={r['compute_s']:.3e}/{r['memory_s']:.3e}/"
                  f"{r['collective_s']:.3e}s dom={r['dominant']}",
                  flush=True)
        elif rec["status"] == "skipped":
            print(f"[SKIP] {rec['arch']} {rec['shape']} {rec['mesh']}: "
                  f"{rec['reason']}", flush=True)
        else:
            print(f"[ERR] {rec['arch']} {rec['shape']} {rec['mesh']}: "
                  f"{rec['error']}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--fsdp", default=None,
                    type=lambda s: s.lower() == "true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--no-seq-shard-cache", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write each cell's op trace, "
                         "{arch}__{shape}__{mesh}.ops.txt.gz in --out")
    args = ap.parse_args(argv)

    policy = dict(fsdp=args.fsdp, grad_compress=args.grad_compress,
                  microbatches=args.microbatches,
                  seq_shard_cache=not args.no_seq_shard_cache)
    if args.all:
        n_ok = n_err = 0
        for mesh_kind in ("single", "multi"):
            for arch in configs.ARCH_IDS:
                for shape in SHAPES:
                    rec = run_cell(arch, shape, mesh_kind, args.out,
                                   save_hlo=args.save_hlo, **policy)
                    n_ok += rec["status"] in ("ok", "skipped")
                    n_err += rec["status"] == "error"
        print(f"dry-run done: {n_ok} ok/skip, {n_err} errors")
        raise SystemExit(1 if n_err else 0)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    rec = run_cell(args.arch, args.shape, args.mesh, args.out,
                   save_hlo=args.save_hlo, **policy)
    raise SystemExit(0 if rec["status"] in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
