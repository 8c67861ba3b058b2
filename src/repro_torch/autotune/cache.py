"""Persistent decision cache for the format autotuner.

Decisions are keyed by ``fingerprint hash | machine | model knobs`` so a
serving process that re-loads the same matrix (same structure, same
values) skips the candidate search entirely — the AlphaSparse overhead
the paper calls "extreme" becomes a dictionary lookup on every run after
the first.

Storage is a single JSON file (human-inspectable, atomic-rename writes).
Default location: ``$REPRO_TORCH_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro_torch/autotune.json`` — never the JAX package's file,
so a decision that package cached (on a TPU, or timed on a CPU) is
never served to the port. A cache constructed with ``path=None`` is
memory-only (used by tests and benchmarks).
"""

from __future__ import annotations

import json
import os
import tempfile

from repro_torch import obs

_ENV_VAR = "REPRO_TORCH_AUTOTUNE_CACHE"


def _flock(path: str):
    """Best-effort exclusive advisory lock (context manager).

    Locks a ``<path>.lock`` sidecar, not the target itself — the target
    inode changes on every ``os.replace``, so a lock on it would not
    serialize anything. Platforms/filesystems without working flock
    degrade to unlocked operation (the atomic rename still guarantees
    readers never see a torn file)."""
    import contextlib

    @contextlib.contextmanager
    def cm():
        fd = None
        try:
            try:
                import fcntl
                fd = os.open(path + ".lock",
                             os.O_CREAT | os.O_RDWR, 0o644)
                fcntl.flock(fd, fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass
            yield
        finally:
            if fd is not None:
                try:
                    os.close(fd)       # closing drops the flock
                except OSError:
                    pass

    return cm()


def atomic_merge_json(path: str, updates: dict, *,
                      strict: bool = False) -> dict:
    """Merge ``updates`` into the JSON object at ``path`` atomically.

    Re-reads the file under an exclusive advisory lock so concurrent
    processes cannot clobber each other's keys: whatever is on disk at
    write time is kept and ``updates`` wins per key (last-write-wins).
    The write lands via tempfile + ``os.replace`` so readers never
    observe a torn file. Returns the merged mapping.

    ``strict=False`` (decision cache): any filesystem error degrades to
    a no-op — the caller keeps its in-memory copy. ``strict=True``
    (machine profiles): write errors re-raise, and a *read* error other
    than the file not existing also re-raises — treating a momentarily
    unreadable file as empty would silently discard every previously
    saved key on the next write.
    """
    with _flock(path):
        merged: dict = {}
        try:
            with open(path) as f:
                on_disk = json.load(f)
            if isinstance(on_disk, dict):
                merged = on_disk
        except FileNotFoundError:
            pass                      # first write
        except ValueError:
            pass  # corrupt file == empty mapping (heals on write)
        except OSError:
            if strict:
                raise
        merged.update(updates)

        tmp = None
        try:
            d = os.path.dirname(path) or "."
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(merged, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
            tmp = None
        except OSError:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            if strict:
                raise
    return merged


def default_cache_path() -> str:
    env = os.environ.get(_ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


class DecisionCache:
    """key (str) -> decision (JSON-serializable dict)."""

    def __init__(self, path: str | os.PathLike | None = "default"):
        if path == "default":
            path = default_cache_path()
        self.path = os.fspath(path) if path is not None else None
        self._mem: dict | None = None

    # -- internals ------------------------------------------------------
    def _load(self) -> dict:
        if self._mem is None:
            self._mem = {}
            if self.path and os.path.exists(self.path):
                try:
                    with open(self.path) as f:
                        data = json.load(f)
                    if isinstance(data, dict):
                        self._mem = data
                except (OSError, ValueError):
                    pass  # corrupt/unreadable cache == empty cache
        return self._mem

    def _persist(self) -> None:
        """Merge this process's decisions into the on-disk file.

        Writing the in-process memo verbatim would let two serving
        processes sharing one cache file clobber each other's keys
        (each overwrites with only the decisions *it* has seen);
        `atomic_merge_json` re-reads the disk contents under the same
        atomic rename, so concurrent writers union their keys with
        last-write-wins per key. An unwritable cache degrades to
        memory-only; selection must never fail because persistence did.
        """
        if not self.path:
            return
        merged = atomic_merge_json(self.path, self._mem, strict=False)
        # Adopt keys other processes persisted meanwhile — the next
        # get() on this process sees them without a disk re-read.
        self._mem = merged

    # -- API ------------------------------------------------------------
    def get(self, key: str) -> dict | None:
        """Lookup with hit/miss accounting: every ``get`` bumps
        ``autotune.decision_cache.hits`` or ``.misses`` in the default
        metrics registry, so serving runs can see whether repeated
        selections actually short-circuit (a cold cache on every
        process start shows up as a miss streak, not silence)."""
        v = self._load().get(key)
        obs.default_registry().counter(
            "autotune.decision_cache.hits" if v is not None
            else "autotune.decision_cache.misses").add(1)
        return v

    def put(self, key: str, decision: dict) -> None:
        obs.default_registry().counter(
            "autotune.decision_cache.puts").add(1)
        self._load()[key] = decision
        self._persist()

    def clear(self) -> None:
        self._mem = {}
        if self.path and os.path.exists(self.path):
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def __len__(self) -> int:
        return len(self._load())

    def __contains__(self, key: str) -> bool:
        return key in self._load()


_default: DecisionCache | None = None


def default_cache() -> DecisionCache:
    """Process-wide cache at the default on-disk location."""
    global _default
    if _default is None:
        _default = DecisionCache()
    return _default
