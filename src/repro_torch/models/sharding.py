"""Logical-axis activation sharding: the port of the JAX package's
`models/sharding.py`.

Model code annotates activations with logical names via `shard(x, ...)`;
the launcher installs a mapping logical-name -> mesh axes. Outside
`logical_rules` the annotations are the identity, and so is `shard` of a
plain tensor: only a DTensor is redistributed, to the placements the
rules give on its own mesh. The port's models carry no annotations yet
(tensor-parallel layers on DTensor are a slice of their own), so on every
path the port runs today `shard` is the identity.
"""

from __future__ import annotations

import contextlib
import threading

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


def shard(x, *names):
    """Annotate ``x`` with logical axis ``names`` (one per dim; None = any).

    The identity unless inside `logical_rules` and ``x`` is a DTensor;
    then ``x`` redistributed to the rules' placements on its mesh."""
    rules = current_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.launch.sharding import placements
    spec = logical_spec(rules, names)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


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

