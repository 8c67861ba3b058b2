"""Candidate search: the `select()` entry point of the autotuner.

``select(csr)`` fingerprints the matrix, enumerates every selectable
format registered in `repro_torch.sparse.registry` under the machine cost
model, optionally *refines* the top candidates by actually constructing
them (exact bytes instead of entropy estimates), and returns the
modeled-argmin `Decision`. Two cache layers make repeat calls cheap:

  * a per-process identity memo — a warm ``select`` on the same CSR
    object is a dict lookup (~1 us; below 1% of one modeled SpMVM pass
    for serving-scale matrices with >= ~100 MB working sets, and 5-6
    orders of magnitude below re-running the search — on tiny matrices
    the modeled pass itself is tens of ns, so amortize there);
  * the persistent `DecisionCache` keyed by fingerprint hash + machine
    constants + knobs — a new process serving the same matrix skips the
    search (paper Fig. 9's per-matrix tuning at microseconds, not
    AlphaSparse-hours).

The ``budget`` knob bounds the expensive part: 0 = estimates only
(default, pure fingerprint arithmetic), k > 0 = encode/construct the k
best candidates for exact sizes before the final argmin. Adding
``measure=True`` upgrades that refinement pass from exact *sizes* to
exact *times*: the top-k candidates are packed and their real kernels
wall-clock timed (`repro_torch.autotune.measure`), the argmin ranks measured
seconds, and the winning measurement lands in ``Decision.measured_time``
next to its ``modeled_time``.

A copy of the JAX package's ``repro.autotune.search`` with two changes:
``interpret=`` becomes ``device=`` (where measured kernels run: the card
by default, ``"cpu"`` for the plain torch versions), and a measured
decision's cache key names the device it was timed on (`device_kind`),
so a CPU timing is never served on a card, nor one card's on another.
``mesh=`` is not ported yet (ROADMAP.md A6); ``n_shards > 1`` stays a
modeled selection, pure cost model, as in the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import weakref

import torch

from repro_torch import obs
from repro_torch.autotune.cache import DecisionCache, default_cache
from repro_torch.autotune.cost_model import (H100, Candidate,
                                             MachineModel, candidate_time,
                                             candidates,
                                             normalize_knob_overrides,
                                             render_knob_overrides)
from repro_torch.autotune.fingerprint import Fingerprint, fingerprint
from repro_torch.core.params import PAPER, DtansParams
from repro_torch.kernels.pack import check_device
from repro_torch.sparse.registry import (KnobbedConfigMixin, format_names,
                                         get_format)

#: Selectable format families at import time (the function defaults use
#: the live registry, so formats registered later still join).
ALL_FORMATS = format_names(selectable=True)


def _knobs_from_json(v) -> tuple:
    """JSON lists -> the canonical knobs tuple (block shapes become
    tuples again)."""
    return tuple((k, tuple(x) if isinstance(x, list) else x)
                 for k, x in v)


@dataclasses.dataclass(frozen=True)
class Decision(KnobbedConfigMixin):
    """Outcome of one format selection (JSON round-trippable).

    ``knobs`` is the canonical ``((name, value), ...)`` configuration
    tuple of the winning format — the registry's generic replacement
    for per-format fields; `lane_width` / `shared_table` /
    `group_size` / `block_shape` come from `KnobbedConfigMixin`.
    """

    fmt: str
    knobs: tuple
    nbytes: int
    modeled_time: float
    exact_size: bool
    warm: bool
    machine: str
    fingerprint_key: str
    refined: bool
    # Number of right-hand sides the selection was priced for (the
    # SpMM batch; 1 = the classic single-vector SpMV regime).
    batch: int = 1
    # Devices the winning plan is priced for (1 = single-chip; > 1 =
    # the row-sharded path priced with `collective_time`; running it
    # waits on ROADMAP.md A6).
    n_shards: int = 1
    # Median wall-clock seconds of the winner's real kernel when the
    # selection ran with ``measure=True``; None for modeled-only runs.
    # Modeled and measured seconds are different currencies (a device's
    # clock vs the machine model) — compare measured against measured.
    measured_time: float | None = None
    # (config_name, nbytes, modeled_time, measured_time | None) of the
    # best few candidates, best first — kept for regret reporting and
    # debugging.
    leaderboard: tuple = ()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["knobs"] = [list(kv) for kv in self.knobs]
        d["leaderboard"] = [list(row) for row in self.leaderboard]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Decision":
        """Raises ValueError on schema drift (old/foreign cache files);
        `select` treats that as a cache miss and recomputes. Fields with
        defaults (``measured_time``, ``leaderboard``) may be absent — a
        cache written before a field existed stays valid. ``knobs`` is
        required: pre-registry caches carrying per-format fields fail
        here and recompute."""
        fields = {f.name for f in dataclasses.fields(cls)}
        required = {f.name for f in dataclasses.fields(cls)
                    if f.default is dataclasses.MISSING
                    and f.default_factory is dataclasses.MISSING}
        if not required <= set(d):
            raise ValueError(f"missing decision fields: "
                             f"{sorted(required - set(d))}")
        d = {k: v for k, v in d.items() if k in fields}
        d["knobs"] = _knobs_from_json(d["knobs"])
        d["leaderboard"] = tuple(tuple(row) for row in
                                 d.get("leaderboard", ()))
        try:
            return cls(**d)
        except TypeError as e:
            raise ValueError(f"bad cached decision: {e}") from e


def _decision_event(dec: "Decision", *, source: str) -> None:
    """One selection outcome into the obs layer: a counter per source
    (``search`` = computed fresh, ``cache`` = served from the
    persistent decision cache) and — when a trace sink is configured —
    an ``autotune.decision`` event carrying the pick with its
    modeled-vs-measured time, so selector behaviour is inspectable from
    a serving trace, not just benchmark regret tables."""
    obs.default_registry().counter(
        f"autotune.decisions.{source}").add(1)
    obs.event("autotune.decision", source=source, fmt=dec.fmt,
              config=dec.config_name, nbytes=dec.nbytes,
              batch=dec.batch, warm=dec.warm, machine=dec.machine,
              modeled_time=dec.modeled_time,
              measured_time=(None if dec.measured_time is None
                             else float(dec.measured_time)))


#: id(matrix) -> (weakref-to-matrix, config key, Decision). The weakref
#: guards against id() reuse after garbage collection.
_memo: dict = {}


def clear_memo() -> None:
    _memo.clear()


def _refine(a, cand: Candidate, fp: Fingerprint, *, warm: bool,
            machine: MachineModel, params: DtansParams,
            artifacts: dict, batch: int = 1) -> Candidate:
    """Replace an estimated candidate size with the constructed truth.

    Registry-generic: `FormatSpec.nbytes_constructed` builds/encodes
    the configuration; ``artifacts`` memoizes expensive artifacts under
    `FormatSpec.artifact_key`, shared with the oracle and the
    measurement pass so nothing re-encodes."""
    if cand.exact_size:
        return cand
    spec = get_format(cand.fmt)
    kn = cand.knobs_dict()
    b = spec.nbytes_constructed(a, params=params, artifacts=artifacts,
                                **kn)
    t = candidate_time(fp, cand.fmt, b, warm=warm, machine=machine,
                       batch=batch, n_shards=cand.n_shards, **kn)
    return dataclasses.replace(cand, nbytes=int(b), modeled_time=t,
                               exact_size=True)


def shard_counts(mesh=None, n_shards=None) -> tuple:
    """Shard counts one selection sweeps: an explicit ``n_shards`` pins
    a single count, and none means the classic single-chip search
    ``(1,)``. A ``mesh`` (the reference sweeps the powers of two up to
    its ``model`` axis) raises `NotImplementedError`: device meshes are
    not ported yet (ROADMAP.md A6)."""
    if n_shards is not None:
        if int(n_shards) < 1:
            raise ValueError(f"n_shards must be >= 1; got {n_shards}")
        return (int(n_shards),)
    if mesh is not None:
        raise NotImplementedError(
            "select(mesh=) is not ported yet (ROADMAP.md A6); pass "
            "n_shards= for a modeled sharded selection")
    return (1,)


def device_kind(device) -> str:
    """The device a measured decision was timed on, as its cache key
    spells it: ``"cpu"``, or ``"cuda:<card name>"`` on a card."""
    dev = check_device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


def select(a, *, machine: MachineModel = H100, warm: bool = True,
           formats: tuple | None = None, budget: int = 0,
           batch: int = 1,
           mesh=None, n_shards: int | None = None,
           measure: bool = False, measure_warmup: int = 1,
           measure_repeats: int = 3, device="cuda",
           params: DtansParams = PAPER,
           knob_overrides: dict | None = None,
           cache: DecisionCache | None = None,
           use_cache: bool = True,
           artifacts: dict | None = None) -> Decision:
    """Pick the modeled- (or measured-) fastest format for matrix ``a``.

    Args:
      a: `repro_torch.sparse.formats.CSR` matrix.
      machine: chip model of the cost model.
      warm: model a cache-resident (True) or streaming (False) workload.
      formats: candidate format families to consider; None = every
        selectable family in `repro_torch.sparse.registry` (a format
        registered there joins the sweep with no edit here).
      budget: number of top estimated candidates to construct for exact
        sizes before the final argmin (0 = fingerprint estimates only).
      batch: number of right-hand sides the workload contracts per pass
        (the SpMM batch). Matrix bytes and entropy-decode work are paid
        once per pass, x/y bytes and contraction work per RHS — so the
        winning format can flip as B grows (decode overhead amortizes).
        Part of both cache keys.
      mesh: not ported yet; raises `NotImplementedError` (ROADMAP.md
        A6).
      n_shards: price the sweep at exactly one shard count (a modeled
        selection: the cost model's `collective_time` terms); ``None``
        = the classic single-chip search.
      measure: with ``budget > 0``, additionally wall-clock time the
        top-``budget`` candidates' real kernels
        (`repro_torch.autotune.measure`, at this ``batch``) and rank them by
        measured seconds; the winner always comes from the measured
        head (modeled tail times are a different currency). The winning
        measurement lands in ``Decision.measured_time``.
      measure_warmup / measure_repeats: timing harness knobs
        (median-of-``measure_repeats`` after ``measure_warmup`` calls).
      device: where measured kernels run (``measure=True`` only): the
        card by default, ``"cpu"`` for the plain torch versions on the
        host clock. Measured decisions are cached per `device_kind`.
      knob_overrides: generic knob-domain overrides, ``{knob name ->
        domain tuple}`` — narrows/extends ANY format's sweep (third-
        party specs' knobs included) without a new named keyword.
        Entries for knobs a format does not declare are ignored by that
        format. None (default) sweeps each format's own
        `FormatSpec.knob_domains` — built-in AND third-party formats
        alike, matching what the exhaustive oracle enumerates.
      cache: decision cache; ``None`` uses the process default
        (persistent on disk). Pass ``DecisionCache(path=None)`` for a
        memory-only cache.
      use_cache: disable both cache layers (for measurement).
      artifacts: optional mutable mapping memoizing encoded matrices
        under `FormatSpec.artifact_key`; callers that already encoded
        candidates (benchmarks, the oracle) pass theirs to skip
        re-encoding. Never part of the cache key.
    """
    if measure and budget <= 0:
        raise ValueError("measure=True requires budget > 0 (only the "
                         "refined head is packed and timed)")
    if batch < 1:
        raise ValueError(f"batch must be >= 1; got {batch}")
    ks = shard_counts(mesh, n_shards)
    if measure and ks != (1,):
        raise ValueError("measure=True is single-device only (the "
                         "timing harness wall-clocks one chip's "
                         "kernels); drop mesh=/n_shards= or measure "
                         "at shards=1")
    if formats is None:
        formats = format_names(selectable=True)
    cache = cache if cache is not None else default_cache()

    overrides = normalize_knob_overrides(knob_overrides)
    ko = render_knob_overrides(overrides)
    # The requested formats' LIVE knob domains enter both cache keys: a
    # release (or in-process re-registration) that changes a format's
    # default sweep must invalidate decisions that never priced the new
    # sweep points.
    doms = ";".join(
        f"{f}:" + ",".join(f"{k}=" + "|".join(map(str, v))
                           for k, v in get_format(f).knob_domains.items())
        for f in formats)
    # The cache object is part of the memo key: a repeat select with a
    # *different* cache must consult (and populate) that cache, not
    # short-circuit on the memo.
    where = device_kind(device) if measure else None
    cfg = (machine, warm, tuple(formats), int(budget), int(batch), ks,
           ko, doms, params, cache, bool(measure), int(measure_warmup),
           int(measure_repeats), where)
    if use_cache:
        hit = _memo.get(id(a))
        if hit is not None and hit[0]() is a and hit[1] == cfg:
            obs.default_registry().counter("autotune.memo_hits").add(1)
            return hit[2]

    fp = fingerprint(a, params=params)
    pp = params
    key_parts = [fp.key(), machine.signature(), f"warm={int(warm)}",
                 ",".join(formats), f"budget={int(budget)}",
                 f"batch={int(batch)}",
                 "ko:" + ko,
                 "doms:" + hashlib.sha1(doms.encode()).hexdigest()[:12],
                 f"w{pp.w_bits}k{pp.k_bits}l{pp.l}o{pp.o}"
                 f"f{pp.f}m{pp.m_bits}"]
    if ks != (1,):
        # Sharded searches key separately; the classic single-chip key
        # is unchanged, so existing cache files stay valid.
        key_parts.append("shards:" + ",".join(map(str, ks)))
    if measure:
        # Measured decisions key separately from modeled ones, by
        # harness knobs and by the device that timed them: the
        # currencies must never be mixed by a cache hit.
        key_parts.append(f"meas:w{int(measure_warmup)}"
                         f"r{int(measure_repeats)}:{where}")
    key = "|".join(key_parts)
    if use_cache:
        raw = cache.get(key)
        if raw is not None:
            try:
                dec = Decision.from_dict(raw)
            except ValueError:
                dec = None          # schema drift -> recompute
            if dec is not None:
                _memo[id(a)] = (weakref.ref(a), cfg, dec)
                _decision_event(dec, source="cache")
                return dec

    cands = []
    for k in ks:
        cands.extend(candidates(fp, machine=machine, warm=warm,
                                params=params, formats=tuple(formats),
                                batch=batch, n_shards=k,
                                knob_overrides=overrides))
    cands.sort(key=lambda cand: cand.modeled_time)
    if not cands:
        # Possible since FormatSpec.admit: e.g. bcsr_dtans's fill-in
        # guard prunes every block shape on scatter-structured
        # matrices. Diagnosable error beats IndexError.
        raise ValueError(
            f"no admitted candidate configuration for formats "
            f"{tuple(formats)} on this matrix (matrix-adaptive knob "
            f"grids pruned every sweep point; widen `formats` or the "
            f"knob overrides)")
    refined = False
    if budget > 0:
        arts = artifacts if artifacts is not None else {}
        head = [_refine(a, c, fp, warm=warm, machine=machine,
                        params=params, artifacts=arts, batch=batch)
                for c in cands[:budget]]
        refined = any(h is not c for h, c in zip(head, cands))
        if measure:
            from repro_torch.autotune.measure import measure_candidate
            head = [dataclasses.replace(
                        h, measured_time=measure_candidate(
                            a, h, params=params, device=device,
                            warmup=measure_warmup, batch=batch,
                            repeats=measure_repeats, artifacts=arts))
                    for h in head]
            refined = True
            # Measured head ranks by wall clock; the unmeasured tail
            # keeps its modeled order *behind* the head — a modeled
            # tail time is not comparable to a measured second, so the
            # tail can never outrank a measured candidate.
            head.sort(key=lambda c: c.measured_time)
            cands = head + cands[budget:]
        else:
            cands = sorted(head + cands[budget:],
                           key=lambda c: c.modeled_time)

    best = cands[0]
    dec = Decision(
        fmt=best.fmt, knobs=best.knobs, nbytes=best.nbytes,
        modeled_time=best.modeled_time, exact_size=best.exact_size,
        warm=warm, machine=machine.name, fingerprint_key=fp.key(),
        refined=refined, batch=int(batch), n_shards=best.n_shards,
        measured_time=best.measured_time,
        # Sharded rows spell the oracle's "<config>@S<k>" key so regret
        # tables line up; single-chip rows keep the bare config name.
        leaderboard=tuple((c.config_name if c.n_shards == 1
                           else f"{c.config_name}@S{c.n_shards}",
                           c.nbytes, c.modeled_time,
                           c.measured_time) for c in cands[:5]),
    )
    if use_cache:
        cache.put(key, dec.to_dict())
        if len(_memo) > 4096:  # drop entries whose matrix was collected
            for k in [k for k, v in _memo.items() if v[0]() is None]:
                del _memo[k]
        _memo[id(a)] = (weakref.ref(a), cfg, dec)
    _decision_event(dec, source="search")
    return dec


def choose_dtans_config(a, *, machine: MachineModel = H100,
                        warm: bool = True, budget: int = 0,
                        batch: int = 1,
                        mesh=None, n_shards: int | None = None,
                        measure: bool = False, device="cuda",
                        params: DtansParams = PAPER,
                        cache: DecisionCache | None = None,
                        use_cache: bool = True,
                        artifacts: dict | None = None) -> Decision:
    """Best entropy-coded configuration only: the ``decodes=True``
    families of the registry (CSR-dtANS lane width x table sharing,
    group-aligned RGCSR-dtANS, block-aligned BCSR-dtANS, ...).

    Used by `repro_torch.serving.sparse_linear.SparseLinear`'s
    ``auto=True`` path, where the family must decode on the fly but the
    knobs are free. Every such family runs the same dtANS kernels (a
    BCSR-dtANS winner their fused shared-column variant), so the serving
    stack is indifferent to which one wins. ``measure=True``
    (with ``budget > 0``) times the candidates' real kernels, exactly
    as in `select`.
    """
    return select(a, machine=machine, warm=warm,
                  formats=format_names(selectable=True, decodes=True),
                  budget=budget, batch=batch, mesh=mesh,
                  n_shards=n_shards, measure=measure,
                  device=device, params=params, cache=cache,
                  use_cache=use_cache, artifacts=artifacts)
