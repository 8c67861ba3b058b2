"""The port stands alone: importing it loads no JAX and no `repro`.

`src/repro/__init__.py` imports JAX and turns on x64 process-wide, so the
port keeps its own copies of the numpy modules it needs. A fresh
subprocess imports every module of `repro_torch` (and `chip_smoke.py`)
and lists what got loaded; a source scan catches imports that a module
might make lazily, inside a function.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
mods = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
sys.path.insert(0, sys.argv[1])
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(mods))
print(",".join(bad))
"""

_BAD_IMPORT = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro)(\s|\.|,|$)"
    r"|from\s+(jax|jaxlib|repro)(\s|\.))", re.MULTILINE)


def test_importing_the_port_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=env,
                         timeout=300, check=True).stdout.split("\n")
    n_modules, bad = int(out[0]), out[1]
    assert n_modules >= 20, n_modules
    assert bad == "", f"the port loaded: {bad}"


def test_sources_import_no_jax_and_no_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _BAD_IMPORT.finditer(f.read_text())]
    assert offenders == []


def test_scan_catches_forbidden_imports():
    for line in ("import jax", "import jax.numpy as jnp",
                 "    from jax import lax", "from repro.core import x",
                 "import repro", "from repro import obs"):
        assert _BAD_IMPORT.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "import torch", "# import jax in a comment"):
        assert not _BAD_IMPORT.search(line), line
