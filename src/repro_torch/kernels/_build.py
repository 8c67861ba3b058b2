"""Build the CUDA sources in ``csrc/`` and load them with ctypes.

Each ``csrc/<stem>.cu`` has a plain C interface and compiles with ``nvcc``
into ``build/lib<stem>-<hash>.so`` beside this module; the hash covers the
source, the shared headers (``csrc/*.cuh``) and the flags, so a checkout
builds at first use and reuses the library afterwards. ``build/`` is
listed in ``.gitignore``. A missing ``nvcc`` or a failed build raises; the
compiler's output (``-Xptxas -v``: registers, shared memory and spills per
kernel) is kept in ``build/<stem>.log``.

Nothing is compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
SOURCES = ("dtans_spmv", "dtans_decode", "sell_spmv", "rgcsr_spmv",
           "bcsr_spmv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under
    ``$CUDA_HOME`` (default ``/usr/local/cuda``)."""
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path(stem: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{stem}-{key}.so"


def log_path(stem: str) -> Path:
    return BUILD_DIR / f"{stem}.log"


def build_all(stems=SOURCES) -> dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together. Returns stem -> library path."""
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = []
    for stem in stems:
        out = library_path(stem)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        with open(log_path(stem), "w") as log:
            proc = subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC_DIR / f"{stem}.cu")],
                stdout=log, stderr=subprocess.STDOUT)
        jobs.append((stem, proc, tmp, out))
    failed = []
    for stem, proc, tmp, out in jobs:
        if proc.wait() != 0:
            failed.append(f"{stem} (exit {proc.returncode}):\n"
                          f"{log_path(stem).read_text()}")
        else:
            os.replace(tmp, out)   # atomic against a concurrent build
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return {stem: library_path(stem) for stem in stems}


def load(stem: str) -> ctypes.CDLL:
    """The built library of ``csrc/<stem>.cu``, building it first if
    needed; loaded once per process."""
    lib = _loaded.get(stem)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((stem,))[stem]))
        _loaded[stem] = lib
    return lib
