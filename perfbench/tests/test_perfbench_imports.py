"""Nothing the benchmark runs loads JAX, the JAX package or the old
``benchmarks``; the references import nothing of the port either."""

import subprocess
import sys

from perfbench import imports, manifest


def test_top_level_names_compare_whole():
    mods = {"repro_torch": 1, "repro_torch.kernels.ops": 1, "jaxtyping": 1,
            "numpy": 1, "reprox": 1}
    assert imports.forbidden_loaded(mods) == []
    mods.update({"repro": 1, "repro.core": 1, "jax": 1, "jaxlib.xla": 1,
                 "flax": 1, "benchmarks.run": 1})
    assert imports.forbidden_loaded(mods) == [
        "benchmarks.run", "flax", "jax", "jaxlib.xla", "repro", "repro.core"]


def test_references_import_nothing_of_the_port(tmp_path):
    assert imports.reference_imports() == {}
    (tmp_path / "bad.py").write_text("import numpy\nfrom repro_torch import ops\n")
    (tmp_path / "worse.py").write_text("import jax.numpy as jnp\n")
    assert imports.reference_imports(tmp_path) == {"bad.py": ["repro_torch"],
                                                   "worse.py": ["jax"]}


def test_a_run_loads_no_forbidden_module():
    """Everything a run imports (harness, cases, readers and the port's
    entries they call), in a fresh process."""
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from perfbench import harness, imports, manifest, control, run\n"
        "b = manifest.load()\n"
        "for c in b['configs']:\n"
        "    manifest.case_module(manifest.config(b, c['name'])['case'])\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    manifest.reader(m['name'])\n"
        "import repro_torch.serving.sparse_linear, repro_torch.autotune\n"
        "import repro_torch.core.csr_dtans, repro_torch.kernels.ops\n"
        "print(imports.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
