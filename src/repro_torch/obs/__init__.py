"""repro_torch.obs: dependency-free metrics + tracing for the serving stack.

The paper's core claim is a *measured* speedup; SMASH makes the same
point structurally — compression only pays when decode time hides behind
the consumer, which nothing can know without instrumentation on the real
execution path. This package is that instrumentation layer:

* **Metrics** (`repro_torch.obs.metrics`): a `MetricsRegistry` of counters,
  gauges and histograms. Histograms keep a bounded reservoir and report
  exact p50/p95/p99 (numpy-compatible linear interpolation) while the
  sample count fits the reservoir; beyond it, seeded reservoir sampling
  keeps the quantiles representative at fixed memory. `snapshot()` is
  lock-free — it copies instrument state without stopping writers.
* **Tracing** (`repro_torch.obs.trace`): a `span()` context manager and
  `event()` emitter writing JSONL to the path in ``$REPRO_TRACE`` (or
  `configure_trace(path)`). With no sink configured both are near-free
  no-ops, so the serving path stays instrumented.

Instrumented layers so far: `serving.SparseLinear` + `kernels.ops`
(decode invocations, bytes moved per SpMV/SpMM, batch-size and
column-tile histograms) and `autotune` (timings and their dispersion,
decisions by source with an ``autotune.decision`` event, decision-cache
hits and misses).
"""

from repro_torch.obs.metrics import (NULL, Counter, Gauge, Histogram,
                                     MetricsRegistry, default_registry)
from repro_torch.obs.trace import (configure_trace, event, span,
                                   trace_active, trace_path)

__all__ = [
    "NULL", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "configure_trace", "default_registry", "event", "span",
    "trace_active", "trace_path",
]
