"""Wall-clock kernel measurement and MachineModel calibration.

The cost model's constants (`spmv_ops_per_elem`, `row_seq_penalty`,
bandwidth terms) started life as educated guesses; SMASH and AlphaSparse
both show format choice flips with the *machine*, not just the matrix.
This module closes the loop three ways:

* **Timing harness** — `spmv_runner` builds a zero-arg callable that
  runs one ``y = A x`` through the registered kernel path of any
  candidate (format, config), with the pack and x already on the
  device; `time_kernel` times it with warmup and the median of k
  replays of a CUDA graph of the call, each between a pair of CUDA
  events. Kernels run on the card by default (``device="cuda"``);
  ``device="cpu"`` runs their plain torch versions on the host clock,
  so the harness works on CPU-only hosts.
* **Measured refinement** — `search.select(budget=k, measure=True)`
  calls `measure_candidate` on the top-k candidates so the final argmin
  ranks *measured* seconds, not modeled ones, and the measurement flows
  into ``Decision.measured_time`` and the persistent cache.
* **Calibration** — `calibrate` times a small synthetic sweep across
  the format families and least-squares-fits the MachineModel constants
  to the measurements. Fitted models persist as *named machine
  profiles* (`save_profile` / `load_profile`, JSON beside the decision
  cache); `MachineModel.signature()` carries the constants into every
  decision-cache key, so loading a different profile can never serve
  decisions tuned for another machine.

Measured seconds and modeled seconds are different currencies (the
plain torch versions on a CPU host are orders of magnitude off the
card's roofline, and the `H100` model is uncalibrated until `calibrate`
has run on the card); they are never compared across candidates —
measurement re-ranks only among measured candidates, and calibration
exists precisely to bring the model into the measured currency.

A port of the JAX package's ``repro.autotune.measure``; machine
profiles live in their own file (``$REPRO_TORCH_MACHINE_PROFILES``, or
beside the port's decision cache).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.autotune.cache import (atomic_merge_json,
                                        default_cache_path)
from repro_torch.autotune.cost_model import (H100, Candidate,
                                             MachineModel, candidate_time,
                                             spmm_bytes)
from repro_torch.autotune.fingerprint import fingerprint
from repro_torch.core.params import PAPER, DtansParams
from repro_torch.kernels.pack import check_device
from repro_torch.obs.metrics import NOISY_REL_IQR
from repro_torch.sparse.registry import get_format, parse_config

#: Timing defaults: one warmup call (compilation / trace caching), then
#: a median over this many timed calls.
DEFAULT_WARMUP = 1
DEFAULT_REPEATS = 3
#: Calls of one CUDA graph that a sample on the card averages.
GRAPH_CALLS = 20

_PROFILE_ENV = "REPRO_TORCH_MACHINE_PROFILES"


# --------------------------------------------------------------------------
# Timing harness
# --------------------------------------------------------------------------




class TimingSample(float):
    """A median wall-clock time that also carries its dispersion.

    Subclasses ``float`` (the value IS the median), so every existing
    call site — candidate ranking, ``Decision.measured_time``, JSON
    serialization — keeps working on the scalar, while dispersion-aware
    consumers (calibration's down-weighting, the noisy-timing counter)
    read ``.iqr`` / ``.min`` / ``.n`` off the same object.
    """

    __slots__ = ("iqr", "min", "n")

    def __new__(cls, median: float, *, iqr: float = 0.0,
                min: float | None = None, n: int = 1) -> "TimingSample":
        self = float.__new__(cls, median)
        self.iqr = float(iqr)
        self.min = float(median if min is None else min)
        self.n = int(n)
        return self

    @classmethod
    def from_samples(cls, samples) -> "TimingSample":
        xs = np.asarray(samples, dtype=np.float64)
        if xs.size == 0:
            raise ValueError("need at least one timing sample")
        q25, med, q75 = np.percentile(xs, (25, 50, 75))
        return cls(float(med), iqr=float(q75 - q25),
                   min=float(xs.min()), n=int(xs.size))

    @property
    def median(self) -> float:
        return float(self)

    @property
    def rel_iqr(self) -> float:
        """IQR / median — scale-free dispersion; 0 for n == 1."""
        m = float(self)
        return self.iqr / m if m > 0 else 0.0

    @property
    def noisy(self) -> bool:
        """True when the spread across repeats rivals the median itself
        — a measurement calibration should not take at face value."""
        return self.rel_iqr > NOISY_REL_IQR


def _graph_samples(fn, dev, calls: int, repeats: int) -> list:
    """Seconds a call of ``fn``, one sample per replay of a CUDA graph of
    ``calls`` back-to-back calls: no host work sits between the
    launches, so the sample is the kernels' own time."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()                        # allocations settle before capture
    torch.cuda.current_stream(dev).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize(dev)
    samples = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize(dev)
        samples.append(e0.elapsed_time(e1) * 1e-3 / calls)
    return samples


def time_kernel(fn, *, warmup: int = DEFAULT_WARMUP,
                repeats: int = DEFAULT_REPEATS,
                device="cuda") -> TimingSample:
    """Median seconds of ``fn()`` (a computation on ``device``).

    On the card ``fn`` is captured ``GRAPH_CALLS`` times back to back in
    one CUDA graph; each sample is one replay between a pair of
    ``torch.cuda.Event``s, over ``GRAPH_CALLS``. The wrapper's host work
    and the launch from Python are outside the sample, so a measured
    ranking is one of the kernels, at B=1 too, where a pass takes tens
    of microseconds and a call from Python would add 10-50% to it. On
    the CPU a sample is the host clock around one call. The first
    ``warmup`` calls absorb first-call costs (the kernels' build and
    load, the packs' upload); the median of ``repeats`` samples resists
    noise better than the mean.

    Returns a `TimingSample` — a float (the median; existing call sites
    are unchanged) carrying ``iqr``, ``min`` and ``n``. Each call also
    records the dispersion in the default metrics registry
    (``autotune.timing.rel_iqr`` histogram; noisy timings bump
    ``autotune.timing.noisy``).
    """
    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    dev = check_device(device)
    for _ in range(max(warmup, 0)):
        fn()
    if dev.type == "cuda":
        samples = _graph_samples(fn, dev, GRAPH_CALLS, repeats)
    else:
        samples = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            samples.append(time.perf_counter() - t0)
    ts = TimingSample.from_samples(samples)
    reg = obs.default_registry()
    reg.counter("autotune.timings").add(1)
    reg.histogram("autotune.timing.rel_iqr").observe(ts.rel_iqr)
    if ts.noisy:
        reg.counter("autotune.timing.noisy").add(1)
    return ts


def _default_x(a, batch: int = 1) -> np.ndarray:
    rng = np.random.default_rng(0xA0)
    shape = (a.shape[1],) if batch == 1 else (a.shape[1], batch)
    return rng.standard_normal(shape).astype(a.values.dtype)


def spmv_runner(a, fmt: str, *, params: DtansParams = PAPER,
                x: np.ndarray | None = None, batch: int = 1,
                device="cuda",
                artifacts: dict | None = None, **knobs):
    """Zero-arg callable running one ``y = A x`` through the registered
    kernel path of (format, config); feed it to `time_kernel`.

    Registry-generic: ``**knobs`` is the format's own knob surface
    (``lane_width=32``, ``group_size=8``, ``block_shape=(4, 4)``, ...);
    None values and knobs the format does not declare are dropped, so a
    caller may pass a candidate's full knob set. `FormatSpec.pack`
    builds the runnable artifact (``artifacts`` memoizes expensive
    encodes under `FormatSpec.artifact_key`, shared with the exhaustive
    oracle — a benchmark that already ran the oracle times kernels
    without re-encoding) and `FormatSpec.runner` binds it to the
    format's ``spmv_fn`` (``ops.spmv`` for the dtANS families,
    ``ops.sell_spmv`` / ``ops.rgcsr_spmv`` / ``ops.bcsr_spmv`` for the
    plain kernels, the torch scatter-add SpMV for the kernel-less
    row-sequential formats, and a dense ``torch.matmul`` —
    calibration's bandwidth anchor). The runner uploads the pack and
    ``x`` to ``device`` when it is built, once.

    ``batch > 1`` drives the format's multi-RHS path instead
    (`FormatSpec.spmm_runner` — the fused SpMM kernels where the format
    has one, a per-column fallback otherwise); ``x`` must then be
    (n, batch) when given.
    """
    try:
        spec = get_format(fmt)
    except ValueError as e:
        raise ValueError(f"no registered SpMV runner for format "
                         f"{fmt!r}") from e
    if batch < 1:
        raise ValueError(f"batch must be >= 1; got {batch}")
    x = _default_x(a, batch) if x is None else x
    if batch > 1:
        # Validate the rhs BEFORE pack: a shape mistake must not cost
        # a full entropy encode first.
        x = np.asarray(x)
        if x.ndim != 2 or x.shape[1] != batch:
            raise ValueError(f"batch={batch} needs x of shape "
                             f"({a.shape[1]}, {batch}); got {x.shape}")
    packed = spec.pack(a, params=params, artifacts=artifacts,
                       **spec.filter_knobs(knobs))
    if batch == 1:
        return spec.runner(packed, x, device=device)
    return spec.spmm_runner(packed, x, device=device)


def measure_config(a, fmt: str, *, params: DtansParams = PAPER,
                   x: np.ndarray | None = None, batch: int = 1,
                   device="cuda",
                   warmup: int = DEFAULT_WARMUP,
                   repeats: int = DEFAULT_REPEATS,
                   artifacts: dict | None = None,
                   **knobs) -> TimingSample:
    """Measured median seconds of one (format, config) SpMV — or, with
    ``batch > 1``, one multi-RHS SpMM pass — on ``a`` (``**knobs`` as
    in `spmv_runner`). Returns `time_kernel`'s `TimingSample` (a float
    carrying dispersion)."""
    fn = spmv_runner(a, fmt, params=params, x=x, batch=batch,
                     device=device, artifacts=artifacts, **knobs)
    return time_kernel(fn, warmup=warmup, repeats=repeats, device=device)


def parse_config_name(name: str) -> dict:
    """Invert the canonical config names (`FormatSpec.encode_knobs`)
    into `measure_config` keyword arguments via the registry's
    `decode_knobs` — e.g. ``"rgcsr_dtans[G=8,shared]"`` ->
    ``{"fmt": "rgcsr_dtans", "group_size": 8, "shared_table": True}``.
    Raises ValueError for unregistered formats or unknown components.
    """
    spec, knobs = parse_config(name)
    return {"fmt": spec.name, **knobs}


def measure_named(a, config_name: str, *, params: DtansParams = PAPER,
                  x: np.ndarray | None = None, batch: int = 1,
                  device="cuda",
                  warmup: int = DEFAULT_WARMUP,
                  repeats: int = DEFAULT_REPEATS,
                  artifacts: dict | None = None) -> TimingSample:
    """`measure_config` addressed by canonical config name — how the
    benchmarks time the exhaustive oracle's pick."""
    return measure_config(a, **parse_config_name(config_name),
                          params=params, x=x, batch=batch,
                          device=device,
                          warmup=warmup, repeats=repeats,
                          artifacts=artifacts)


def measure_candidate(a, cand: Candidate, *, params: DtansParams = PAPER,
                      x: np.ndarray | None = None, batch: int = 1,
                      device="cuda",
                      warmup: int = DEFAULT_WARMUP,
                      repeats: int = DEFAULT_REPEATS,
                      artifacts: dict | None = None) -> TimingSample:
    """`measure_config` keyed off a cost-model `Candidate` (the
    candidate's knobs tuple carries the full configuration)."""
    return measure_config(a, cand.fmt, params=params, x=x, batch=batch,
                          device=device, warmup=warmup,
                          repeats=repeats, artifacts=artifacts,
                          **cand.knobs_dict())


# --------------------------------------------------------------------------
# Calibration: fit MachineModel constants to measured kernel times
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CalibrationPoint:
    """One (matrix, config, batch) measurement with its model features."""

    matrix: str
    config_name: str
    fmt: str
    nbytes: int
    work_elems: int
    measured: float          # seconds
    modeled_before: float    # seconds under the base (hand-tuned) model
    modeled_after: float = float("nan")   # filled in after the fit
    batch: int = 1           # right-hand sides of the measured pass
    # Dispersion of the measurement (`TimingSample`): IQR across the
    # timed repeats and the weight the fit gave this row (noisy rows
    # are down-weighted, never discarded).
    measured_iqr: float = 0.0
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    model: MachineModel
    err_before: float        # mean |modeled - measured| / measured
    err_after: float
    points: tuple            # CalibrationPoint per measurement

    def to_dict(self) -> dict:
        return {
            "model": self.model.to_dict(),
            "err_before": self.err_before,
            "err_after": self.err_after,
            "points": [dataclasses.asdict(p) for p in self.points],
        }


def _calibration_suite(small: bool = True) -> dict:
    """Small deterministic sweep spanning the structure axes the model's
    work terms distinguish: regular (banded/stencil), irregular (ER),
    skewed row lengths (the lock-step penalty case) and a low-entropy
    quantized NN weight (the decode-term case)."""
    from repro_torch.sparse.formats import CSR
    from repro_torch.sparse.prune import codebook_quantize, magnitude_prune
    from repro_torch.sparse.random_graphs import (banded, erdos_renyi,
                                                  stencil_2d)
    f = 1 if small else 2
    rng = np.random.default_rng(21)
    w = (rng.standard_normal((256 * f, 256 * f)) / 16).astype(np.float32)
    out = {
        "banded": banded(1500 * f, 5),
        "stencil": stencil_2d(28 * f),
        "er": erdos_renyi(900 * f, 8, rng),
        "nn": codebook_quantize(magnitude_prune(w, 0.85), bits=6),
    }
    skew = np.zeros((400 * f, 300 * f), dtype=np.float64)
    lens = np.minimum(rng.zipf(1.7, size=skew.shape[0]), skew.shape[1])
    for i, k in enumerate(lens):
        cols = rng.choice(skew.shape[1], size=int(k), replace=False)
        skew[i, cols] = np.round(rng.standard_normal(int(k))) + 0.5
    out["skew"] = CSR.from_dense(skew)
    return {k: CSR(v.indptr, v.indices, v.values.astype(np.float32),
                   v.shape) if v.values.dtype != np.float32 else v
            for k, v in out.items()}


#: Canonical config names measured per sweep matrix — one
#: representative per work-term family. Parsed through the registry, so
#: every knob a row depends on (the SELL slice height included) comes
#: from the config itself, never a hard-coded constant that could drift
#: from what the runner actually packed.
CALIBRATION_CONFIGS = (
    "csr",
    "sell",
    "rgcsr[G=8]",
    "dtans[w=32,shared]",
    "rgcsr_dtans[G=8,shared]",
)


def _clamped_lstsq(A: np.ndarray, t: np.ndarray,
                   fallback: np.ndarray) -> np.ndarray:
    """Least squares with non-negativity by clamp-and-refit: columns
    whose coefficient comes out non-positive are pinned to their
    ``fallback`` (base-model) value and the rest re-fit on the residual.
    Five columns, so the loop is at most five rounds."""
    beta = np.array(fallback, dtype=np.float64)
    free = np.ones(A.shape[1], dtype=bool)
    for _ in range(A.shape[1]):
        if not free.any():
            break
        resid = t - A[:, ~free] @ beta[~free]
        sol, *_ = np.linalg.lstsq(A[:, free], resid, rcond=None)
        bad = sol <= 0
        beta[free] = np.where(bad, fallback[free], sol)
        if not bad.any():
            break
        idx = np.flatnonzero(free)
        free[idx[bad]] = False
    return beta


#: Batched design rows: each calibration config is measured once per
#: batch size, so the fit sees rows where contraction work scales with
#: B while decode work does not — exactly the split the batched cost
#: model prices. B=1 keeps the classic SpMV rows; B=8 is large enough
#: to separate the per-RHS terms without slowing CI measurably.
CALIBRATION_BATCHES = (1, 8)


def calibrate(matrices: dict | None = None, *, base: MachineModel = H100,
              name: str | None = None, warm: bool = True,
              configs: tuple = CALIBRATION_CONFIGS,
              batches: tuple = CALIBRATION_BATCHES,
              params: DtansParams = PAPER, device="cuda",
              warmup: int = DEFAULT_WARMUP,
              repeats: int = DEFAULT_REPEATS,
              small: bool = True) -> CalibrationResult:
    """Fit MachineModel constants from a measured microbench sweep.

    Each (matrix, config, batch) measurement contributes one row of a
    linear system

        t = miss_bytes/hbm_bw + hit_bytes/cache_bw
            + (B * lockstep_work * c_ls + B * rowseq_work * c_rs
               + decode_work * c_dec)

    whose five coefficients map back to ``hbm_bw``, ``cache_bw``,
    ``spmv_ops_per_elem``, ``row_seq_penalty`` and
    ``decode_ops_per_nnz`` (``vpu_rate`` and ``cache_bytes`` stay at the
    base model's datasheet values — they are not separately identifiable
    from end-to-end times). Rows are weighted by their measurement's
    dispersion (`TimingSample`: weight = 1 / (1 + IQR/median)), so a
    noisy timing informs the fit less than a clean one; per-row IQR and
    weight land in the `CalibrationPoint`. Coefficients the data cannot pin down
    positively fall back to the base model's value. The ``batches``
    sweep (default ``(1, 8)``) measures every config through both the
    single-vector and the fused multi-RHS kernel path, giving the fit
    rows where the contraction terms scale but the decode term does not.

    The fitted model keeps every other field of ``base`` (interconnect,
    fast-memory budget). Returns a `CalibrationResult`;
    ``result.model`` is ready for ``select(machine=...)`` and
    `save_profile`.
    """
    mats = _calibration_suite(small=small) if matrices is None else matrices
    points: list[CalibrationPoint] = []
    feats: list[list[float]] = []
    meas: list[float] = []
    weights: list[float] = []

    for mname, a in mats.items():
        fp = fingerprint(a, params=params)
        enc: dict = {}
        for cfg_name in configs:
            spec, knobs = parse_config(cfg_name)
            nbytes = spec.nbytes_constructed(a, params=params,
                                             artifacts=enc, **knobs)
            # The design-matrix row IS the spec's cost-term split — the
            # same knobs the runner packed with (the SELL slice height
            # comes from the config, not a module constant).
            terms = spec.cost_terms(fp, **knobs)
            for B in batches:
                t_meas = measure_config(
                    a, spec.name, params=params, batch=B,
                    device=device, warmup=warmup,
                    repeats=repeats, artifacts=enc, **knobs)
                moved = spmm_bytes(nbytes, fp.cols, fp.rows,
                                   fp.value_bytes, B)
                hit = min(moved, base.cache_bytes) if warm else 0.0
                feats.append([
                    moved - hit,          # 1/hbm_bw
                    hit,                  # 1/cache_bw
                    terms.lockstep * B,   # c_ls
                    terms.rowseq * B,     # c_rs
                    terms.decode,         # c_dec (once per pass)
                ])
                meas.append(t_meas)
                # Down-weight noisy measurements (`TimingSample`
                # dispersion): a row whose repeats disagree by its own
                # median should not pull the fit as hard as a clean one.
                rel = t_meas.rel_iqr if isinstance(t_meas, TimingSample) \
                    else 0.0
                weights.append(1.0 / (1.0 + rel))
                t_before = candidate_time(fp, spec.name, nbytes,
                                          warm=warm, machine=base,
                                          batch=B, **knobs)
                points.append(CalibrationPoint(
                    matrix=mname, config_name=spec.encode_knobs(knobs),
                    fmt=spec.name, nbytes=int(nbytes),
                    work_elems=int(terms.work_elems), measured=t_meas,
                    modeled_before=t_before, batch=int(B),
                    measured_iqr=float(getattr(t_meas, "iqr", 0.0)),
                    weight=weights[-1]))

    A = np.asarray(feats, dtype=np.float64)
    t = np.asarray(meas, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    fallback = np.array([
        1.0 / base.hbm_bw,
        1.0 / base.cache_bw,
        base.spmv_ops_per_elem / base.vpu_rate,
        base.spmv_ops_per_elem * base.row_seq_penalty / base.vpu_rate,
        base.decode_ops_per_nnz / base.vpu_rate,
    ])
    # Weighted least squares by row scaling: minimizing
    # sum_i w_i (A_i beta - t_i)^2 is the plain lstsq of (sqrt(w) A,
    # sqrt(w) t). Predictions / errors below use the UNWEIGHTED rows.
    sw = np.sqrt(w)[:, None]
    beta = _clamped_lstsq(A * sw, t * sw[:, 0], fallback)

    hbm_bw = 1.0 / beta[0]
    cache_bw = max(1.0 / beta[1], hbm_bw)   # cache never slower than HBM
    ops_per_elem = beta[2] * base.vpu_rate
    # Fields the fit does not touch (interconnect, fast-memory budget)
    # keep the base model's values, not the dataclass defaults.
    fitted = dataclasses.replace(
        base, name=name or f"{base.name}-calibrated",
        hbm_bw=hbm_bw, cache_bw=cache_bw,
        decode_ops_per_nnz=beta[4] * base.vpu_rate,
        spmv_ops_per_elem=ops_per_elem,
        row_seq_penalty=max(beta[3] / beta[2], 1.0),
    )

    pred_after = A @ beta
    done = []
    err_b, err_a = [], []
    for p, t_after in zip(points, pred_after):
        done.append(dataclasses.replace(p, modeled_after=float(t_after)))
        err_b.append(abs(p.modeled_before - p.measured) / p.measured)
        err_a.append(abs(t_after - p.measured) / p.measured)
    return CalibrationResult(model=fitted,
                             err_before=float(np.mean(err_b)),
                             err_after=float(np.mean(err_a)),
                             points=tuple(done))


# --------------------------------------------------------------------------
# Named machine profiles (JSON beside the decision cache)
# --------------------------------------------------------------------------


def default_profiles_path() -> str:
    """``$REPRO_TORCH_MACHINE_PROFILES`` if set, else ``machine_profiles.json``
    next to the decision cache."""
    env = os.environ.get(_PROFILE_ENV)
    if env:
        return env
    return os.path.join(os.path.dirname(default_cache_path()),
                        "machine_profiles.json")


def save_profile(model: MachineModel, *, meta: dict | None = None,
                 path: str | os.PathLike | None = None) -> str:
    """Persist ``model`` under its name; returns the profile file path.

    Concurrent savers merge (read + update + atomic rename, same
    discipline as the decision cache); saving raises on an unwritable
    path — losing a profile silently would quietly serve decisions
    tuned for the wrong constants.
    """
    p = os.fspath(path) if path is not None else default_profiles_path()
    entry = {"model": model.to_dict(), "meta": dict(meta or {}),
             "signature": model.signature()}
    atomic_merge_json(p, {model.name: entry}, strict=True)
    return p


def load_profile(name: str, *,
                 path: str | os.PathLike | None = None) -> MachineModel:
    """Load a named profile; raises KeyError when absent."""
    p = os.fspath(path) if path is not None else default_profiles_path()
    try:
        with open(p) as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        raise KeyError(f"no machine profiles at {p}: {e}") from e
    if name not in data:
        raise KeyError(f"no machine profile {name!r} in {p} "
                       f"(have: {sorted(data)})")
    return MachineModel.from_dict(data[name]["model"])


def list_profiles(path: str | os.PathLike | None = None) -> dict:
    """name -> profile entry (empty when the file is absent/corrupt)."""
    p = os.fspath(path) if path is not None else default_profiles_path()
    try:
        with open(p) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}
