"""Asynchronous, atomic checkpointing, in the reference's layout.

Layout:  <dir>/step_<N>/shard_<host>.npz  +  <dir>/step_<N>/MANIFEST.json
Atomicity: writes go to  step_<N>.tmp/  and are renamed only after fsync,
so a crash mid-save never corrupts the latest complete checkpoint.
Async: `AsyncCheckpointer.save_async` copies the state to host memory
before it returns (the trainer updates its tensors in place, so the
background write must not read them) and writes in a daemon thread,
overlapping I/O with the next steps; at most one write is in flight.
Restore picks the newest step with a valid manifest; torn checkpoints are
skipped.

A state is a tree of dicts and lists whose leaves are torch
tensors or numpy arrays. It is stored flat, under dotted key names
(``opt.m.3``), which the manifest lists in place of a JAX treedef.
bfloat16 tensors, which numpy lacks, are stored as their 16-bit patterns.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> dict:
    """The leaves of ``tree`` by dotted key name, in its order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}."))
    return out


def unflatten_like(tree, flat: dict, prefix: str = ""):
    """``flat`` (leaves by dotted key name, as `flatten` gives them) in the
    structure of ``tree``."""
    if isinstance(tree, dict):
        return {k: unflatten_like(v, flat, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [unflatten_like(v, flat, f"{prefix}{i}.")
                for i, v in enumerate(tree)]
    return flat[prefix[:-1]]


def _dtype_name(x) -> str:
    return (str(x.dtype).removeprefix("torch.") if torch.is_tensor(x)
            else np.asarray(x).dtype.name)


def _to_numpy(x) -> np.ndarray:
    if not torch.is_tensor(x):
        return np.asarray(x)
    x = x.detach().cpu()
    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()


def host_copy(tree) -> dict:
    """A flat copy of ``tree`` on the host that shares no storage with it
    (``.cpu()`` of a CPU tensor would)."""
    return {k: (v.detach().to("cpu", copy=True) if torch.is_tensor(v)
                else np.array(v, copy=True))
            for k, v in flatten(tree).items()}


def save(step: int, tree, ckpt_dir: str, host: int = 0,
         extra: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    flat = flatten(tree)
    path = os.path.join(tmp, f"shard_{host}.npz")
    with open(path, "wb") as f:
        np.savez(f, **{k: _to_numpy(v) for k, v in flat.items()})
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "step": step,
        "n_leaves": len(flat),
        "keys": list(flat),
        "dtypes": [_dtype_name(v) for v in flat.values()],
        "shapes": [list(v.shape) if hasattr(v, "shape") else []
                   for v in flat.values()],
        "extra": extra or {},
    }
    mpath = os.path.join(tmp, "MANIFEST.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """Snapshot-then-write-in-background; at most one write in flight.
    ``saves`` records each save's step, its snapshot and write seconds and
    the bytes written."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.saves: list[dict] = []
        self._thread: threading.Thread | None = None

    def save_async(self, step: int, tree, extra=None) -> None:
        self.wait()
        t0 = time.perf_counter()
        host_tree = host_copy(tree)             # device -> host snapshot
        rec = {"step": step, "snapshot_s": time.perf_counter() - t0,
               "bytes": sum(v.nbytes for v in host_tree.values())}
        self.saves.append(rec)

        def work():
            t1 = time.perf_counter()
            save(step, host_tree, self.ckpt_dir, extra=extra)
            self._gc()
            rec["write_s"] = time.perf_counter() - t1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(list_steps(self.ckpt_dir))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            mpath = os.path.join(ckpt_dir, name, "MANIFEST.json")
            if os.path.exists(mpath):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def _load(d: str, host: int, want: dict) -> dict:
    """The arrays of checkpoint directory ``d`` as ``want``'s leaves (torch
    CPU tensors where ``want`` holds tensors, numpy arrays elsewhere);
    raises unless it holds exactly ``want``'s keys, shapes and dtypes."""
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    if manifest["keys"] != list(want):
        raise ValueError("the checkpoint holds other leaves")
    out = {}
    with np.load(os.path.join(d, f"shard_{host}.npz")) as data:
        for k, dt, like in zip(manifest["keys"], manifest["dtypes"],
                               want.values()):
            a = data[k]                     # each access reads the file
            if dt != _dtype_name(like) or \
                    list(a.shape) != list(np.shape(like)):
                raise ValueError(f"{k}: {dt} {a.shape}")
            if torch.is_tensor(like):
                t = torch.from_numpy(a)
                out[k] = t.view(torch.bfloat16) if dt == "bfloat16" else t
            else:
                out[k] = a
    return out


def restore_latest(ckpt_dir: str, tree_like, host: int = 0):
    """Restore the newest valid checkpoint in the structure of
    ``tree_like``. Returns (step, tree) or (None, None); the tree's leaves
    are host tensors (numpy arrays where ``tree_like`` holds numpy).
    Torn or mismatched checkpoints are skipped."""
    want = flatten(tree_like)
    for step in reversed(list_steps(ckpt_dir)):
        d = os.path.join(ckpt_dir, f"step_{step:08d}")
        try:
            flat = _load(d, host, want)
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile):
            continue  # torn/corrupt: try the previous one
        return step, unflatten_like(tree_like, flat)
    return None, None
