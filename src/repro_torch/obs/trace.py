"""JSONL span tracing with a near-free disabled path.

A trace is a flat JSONL file, one object per line, written as spans
*close* (children therefore appear before their parents, like Chrome's
trace events). Schema:

    {"type": "span",  "name": ..., "id": N, "parent": N | null,
     "ts": unix_start_seconds, "dur_s": wall_seconds, ...attrs}
    {"type": "event", "name": ..., "id": N, "parent": N | null,
     "ts": unix_seconds, ...attrs}

Nesting is tracked per-thread/task with a `contextvars.ContextVar`
stack, so spans nest correctly across threads and asyncio tasks alike.

The sink is the path in ``$REPRO_TRACE`` (read once, lazily) or whatever
`configure_trace(path)` set last; `configure_trace(None)` turns tracing
off. With no sink, `span()` yields immediately and `event()` returns —
one predicate check per call, so instrumented code pays almost nothing
with tracing off.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import os
import threading
import time

_ENV_VAR = "REPRO_TRACE"

_sink = None                  # open file object, or None
_sink_path: str | None = None
_env_checked = False
_write_lock = threading.Lock()
_ids = itertools.count(1)
_stack: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_obs_span_stack", default=())


def _ensure_env() -> None:
    """Adopt ``$REPRO_TRACE`` on first use (not at import: the env var
    may be set by the harness after the module loads but before the
    first span)."""
    global _env_checked
    if _env_checked:
        return
    _env_checked = True
    path = os.environ.get(_ENV_VAR)
    if path and _sink is None:
        configure_trace(path)


def configure_trace(path: str | os.PathLike | None) -> None:
    """Point the trace sink at ``path`` (append mode; parent dirs are
    created), or disable tracing with ``None``. Replaces any previous
    sink. Takes precedence over ``$REPRO_TRACE``."""
    global _sink, _sink_path, _env_checked
    _env_checked = True          # explicit config wins over the env var
    if _sink is not None:
        try:
            _sink.close()
        except OSError:
            pass
        _sink = None
        _sink_path = None
    if path is None:
        return
    p = os.fspath(path)
    d = os.path.dirname(p)
    if d:
        os.makedirs(d, exist_ok=True)
    _sink = open(p, "a")
    _sink_path = p


def trace_active() -> bool:
    """True when a sink is configured — the single check every span and
    event makes before doing any work."""
    _ensure_env()
    return _sink is not None


def trace_path() -> str | None:
    """Path of the active sink (None when tracing is off)."""
    _ensure_env()
    return _sink_path


def _write(obj: dict) -> None:
    line = json.dumps(obj, default=str)
    with _write_lock:
        sink = _sink
        if sink is None:          # configure_trace(None) raced us
            return
        sink.write(line + "\n")
        sink.flush()              # crash-visible; tracing is opt-in


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a block and emit one JSONL span on exit.

    Yields the span id (None when tracing is off — callers never
    branch on it). Attributes must be JSON-serializable; anything else
    is stringified. Exceptions propagate; the span records
    ``error=<type>`` and still closes, so a trace of a crashed run ends
    with the failing span."""
    if not trace_active():
        yield None
        return
    sid = next(_ids)
    stack = _stack.get()
    parent = stack[-1] if stack else None
    token = _stack.set(stack + (sid,))
    ts = time.time()
    t0 = time.perf_counter()
    try:
        yield sid
    except BaseException as e:
        attrs = {**attrs, "error": type(e).__name__}
        raise
    finally:
        _stack.reset(token)
        _write({"type": "span", "name": name, "id": sid,
                "parent": parent, "ts": ts,
                "dur_s": time.perf_counter() - t0, **attrs})


def event(name: str, **attrs) -> None:
    """Emit one instantaneous JSONL event (parented to the enclosing
    span, when inside one). No-op with tracing off."""
    if not trace_active():
        return
    stack = _stack.get()
    _write({"type": "event", "name": name, "id": next(_ids),
            "parent": stack[-1] if stack else None,
            "ts": time.time(), **attrs})
