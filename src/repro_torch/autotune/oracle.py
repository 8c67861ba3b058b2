"""Exhaustive exact-size oracle — the AlphaSparse stand-in.

Constructs/encodes EVERY candidate configuration of every selectable
format registered in `repro_torch.sparse.registry` for a matrix and
evaluates the same `cost_model.candidate_time` the selector uses, but with
byte-exact sizes everywhere (the selector works from fingerprint
estimates for the entropy-coded families). The argmin is the paper-
Fig. 9 "best format per matrix" that AlphaSparse pays hours of tuning
for; `select()`'s regret is measured against it.

A copy of the JAX package's ``repro.autotune.oracle`` (the port's
default machine is `H100`); the port's tests hold the selector's regret
against it. Selector and oracle iterate one registry and evaluate one
formula, so a cost-model or registry edit can never make them disagree
by accident, only by genuinely changing a modeled argmin. A format
registered through the registry joins the oracle with no edit here.
"""

from __future__ import annotations

from repro_torch.autotune.cost_model import (H100, MachineModel,
                                             candidate_time,
                                             normalize_knob_overrides)
from repro_torch.autotune.fingerprint import fingerprint
from repro_torch.core.params import PAPER, DtansParams
from repro_torch.sparse.registry import format_names, get_format


def oracle_times(a, *, warm: bool = True, machine: MachineModel = H100,
                 params: DtansParams = PAPER,
                 formats: tuple | None = None,
                 batch: int = 1,
                 n_shards: int | tuple = 1,
                 knob_overrides: dict | None = None,
                 encode_cache: dict | None = None) -> dict[str, float]:
    """config_name -> exact-size modeled seconds, for every candidate.

    ``batch`` prices a multi-RHS SpMM pass exactly as `select(batch=)`
    does (same `candidate_time`), so selector-vs-oracle regret is
    meaningful at every batch size. ``n_shards`` — an int or a tuple of
    counts — additionally prices each configuration for k-device
    sharded passes, keyed ``"<config>@S<k>"`` for k > 1 (the bare
    config name stays the single-chip entry, matching
    `select(mesh=)`'s leaderboard spelling). ``knob_overrides`` narrows
    any knob domain by name, third-party specs included, exactly as in
    `select`.

    ``encode_cache`` (any mutable mapping) memoizes the expensive dtANS
    encodes across repeated calls (e.g. warm and cold evaluation of the
    same matrix) under `FormatSpec.artifact_key` —
    `repro_torch.autotune.measure.spmv_runner` and
    `search.select(artifacts=...)` share the same convention, so a
    measurement pass after an oracle run never re-encodes.
    """
    fp = fingerprint(a, params=params)
    enc = encode_cache if encode_cache is not None else {}
    overrides = normalize_knob_overrides(knob_overrides)
    if formats is None:
        formats = format_names(selectable=True)
    ks = ((int(n_shards),) if isinstance(n_shards, int)
          else tuple(int(k) for k in n_shards))
    times: dict[str, float] = {}
    for fmt in formats:
        spec = get_format(fmt)
        for knobs in spec.knob_grid(fp, overrides):
            b = spec.nbytes_constructed(a, params=params, artifacts=enc,
                                        **knobs)
            name = spec.encode_knobs(knobs)
            for k in ks:
                key = name if k == 1 else f"{name}@S{k}"
                times[key] = candidate_time(
                    fp, fmt, b, warm=warm, machine=machine, batch=batch,
                    n_shards=k, **knobs)
    return times


def oracle_best(a, **kwargs) -> tuple[str, float, dict[str, float]]:
    """(best config_name, its modeled time, all times) for matrix ``a``."""
    times = oracle_times(a, **kwargs)
    if not times:
        raise ValueError(
            "no admitted candidate configuration for the requested "
            "formats on this matrix (matrix-adaptive knob grids pruned "
            "every sweep point)")
    best = min(times, key=times.get)
    return best, times[best], times
