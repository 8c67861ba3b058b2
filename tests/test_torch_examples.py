"""The port's examples run on the CPU and import nothing of JAX.

`examples/sparse_inference_torch.py` repeats `examples/sparse_inference.py`
on the port: a smoke SmolLM with random weights, its LM head compressed,
the compressed logits against the head's decoded dense matrix, and six
requests served through the engine with the compressed head.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "sparse_inference_torch.py"


def _example():
    spec = importlib.util.spec_from_file_location("sparse_inference_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sparse_inference_example_runs_on_the_cpu(capsys):
    reqs = _example().main(device="cpu")
    assert len(reqs) == 6 and all(r.done and len(r.out) == 8 for r in reqs)
    out = capsys.readouterr().out
    for line in ("LM head: dense", "sparse-head decode == dense(pruned) "
                 "reference: OK", "served 6/6 requests", "on the CPU",
                 "batched serving: OK"):
        assert line in out


def test_sparse_inference_example_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _example().main()


def test_sparse_inference_example_imports_no_jax_and_no_repro():
    src = EXAMPLE.read_text()
    assert re.search(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\s|\.|$)",
                     src, re.MULTILINE) is None
    assert "from repro_torch" in src
