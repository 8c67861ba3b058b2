"""Build the CUDA sources in ``csrc/`` and load them with ctypes.

Each ``csrc/<stem>.cu`` has a plain C interface and compiles with ``nvcc``
into ``build/lib<stem>-<hash>.so`` beside this module; the hash covers the
source, the shared headers (``csrc/*.cuh``) and the flags, so a checkout
builds at first use and reuses the library afterwards. ``build/`` is
listed in ``.gitignore``. A missing ``nvcc`` or a failed build raises; the
compiler's output (``-Xptxas -v``: registers, shared memory and spills per
kernel) is kept in ``build/<stem>.log``.

The dtANS sources (`PARAM_SOURCES`) are compiled once per parameter set
(`DtansParams`): the set goes to ``nvcc`` as ``-D`` defines (`defines`),
which the hash covers, so each set has its own library,
``build/lib<stem>-<set>-<hash>.so`` (`lib_name`; `PAPER`'s keeps the bare
stem as its name and log), built at first use.

Nothing is compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from repro_torch.core.params import PAPER, DtansParams
from repro_torch.kernels import tiling

CSRC_DIR = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
SOURCES = ("dtans_spmv", "dtans_decode", "sell_spmv", "rgcsr_spmv",
           "bcsr_spmv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: Sources compiled once per parameter set.
PARAM_SOURCES = ("dtans_spmv", "dtans_decode")

_loaded: dict[str, ctypes.CDLL] = {}


def set_tag(params: DtansParams) -> str:
    """A parameter set's short name: ``w32k12l8o3f2m8`` at `PAPER`."""
    p = params
    return f"w{p.w_bits}k{p.k_bits}l{p.l}o{p.o}f{p.f}m{p.m_bits}"


def defines(params: DtansParams) -> tuple[str, ...]:
    """The ``-D`` flags that compile ``csrc/dtans_decode.cuh`` for a set,
    with its table placement (`tiling.tables_in_smem`)."""
    p = params
    return (f"-DDTANS_W_BITS={p.w_bits}", f"-DDTANS_K_BITS={p.k_bits}",
            f"-DDTANS_L={p.l}", f"-DDTANS_O={p.o}", f"-DDTANS_F={p.f}",
            f"-DDTANS_M_BITS={p.m_bits}",
            f"-DDTANS_TABLES_SMEM={int(tiling.tables_in_smem(p))}")


def _flags(stem: str, params: DtansParams) -> tuple[str, ...]:
    return NVCC_FLAGS + (defines(params) if stem in PARAM_SOURCES else ())


def lib_name(stem: str, params: DtansParams = PAPER) -> str:
    """The name of a source's library for a set: the stem for `PAPER` and
    for the sources that take no set, else ``<stem>-<set_tag>``."""
    if stem not in PARAM_SOURCES or params == PAPER:
        return stem
    return f"{stem}-{set_tag(params)}"


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


def library_path(stem: str, params: DtansParams = PAPER) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(stem, params)).encode())
    key = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{lib_name(stem, params)}-{key}.so"


def log_path(stem: str, params: DtansParams = PAPER) -> Path:
    return BUILD_DIR / f"{lib_name(stem, params)}.log"


def ptxas(log: str) -> dict[str, tuple[int, int, int, int]]:
    """The ``-Xptxas -v`` lines of a build log: kernel (its mangled name,
    the anonymous namespace's per-file hash replaced by ``ANON``) ->
    (registers, stack frame bytes, spill store bytes, spill load bytes)."""
    out, cur, spill = {}, None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+",
                         "ANON", m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            spill = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)),) + spill
            cur = None
    return out


class Build:
    """Libraries being compiled (`start_build`): ``wait`` for them, or
    ``kill`` the compilers still running."""

    def __init__(self, targets: dict, jobs: list):
        self.targets, self.jobs = targets, jobs

    def wait(self) -> dict[str, Path]:
        """Waits for every compiler; raises with the logs of those that
        failed. Returns `lib_name` -> library path."""
        failed = []
        for name, stem, params, proc, tmp, out in self.jobs:
            if proc.wait() != 0:
                failed.append(f"{name} (exit {proc.returncode}):\n"
                              f"{log_path(stem, params).read_text()}")
            else:
                os.replace(tmp, out)   # atomic against a concurrent build
        self.jobs = []
        if failed:
            raise RuntimeError("CUDA build failed: " + "\n".join(failed))
        return {name: library_path(*target)
                for name, target in self.targets.items()}

    def kill(self) -> None:
        for job in self.jobs:
            proc = job[3]
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        self.jobs = []


def start_build(stems=SOURCES, param_sets=(PAPER,), nice: int = 0) -> Build:
    """Starts compiling every library whose file is missing: each source,
    and each of `PARAM_SOURCES` once for every set in ``param_sets``; one
    ``nvcc`` a library, all at once, at niceness ``nice`` (a build that
    runs beside other work yields the cores to it). Returns without
    waiting."""
    BUILD_DIR.mkdir(exist_ok=True)
    targets = {}
    for stem in stems:
        for params in (param_sets if stem in PARAM_SOURCES else (PAPER,)):
            targets[lib_name(stem, params)] = (stem, params)
    jobs = []
    for name, (stem, params) in targets.items():
        out = library_path(stem, params)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        with open(log_path(stem, params), "w") as log:
            proc = subprocess.Popen(
                [nvcc(), *_flags(stem, params), "-o", str(tmp),
                 str(CSRC_DIR / f"{stem}.cu")],
                stdout=log, stderr=subprocess.STDOUT,
                preexec_fn=(lambda: os.nice(nice)) if nice else None)
        jobs.append((name, stem, params, proc, tmp, out))
    return Build(targets, jobs)


def build_all(stems=SOURCES, param_sets=(PAPER,)) -> dict[str, Path]:
    """`start_build`, then waits: returns `lib_name` -> library path;
    raises if a compile fails."""
    return start_build(stems, param_sets).wait()


def load(stem: str, params: DtansParams = PAPER) -> ctypes.CDLL:
    """The built library of ``csrc/<stem>.cu`` for a parameter set,
    building it first if needed; loaded once per process."""
    name = lib_name(stem, params)
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((stem,), (params,))[name]))
        _loaded[name] = lib
    return lib
