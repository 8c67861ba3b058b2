"""The port's examples run on the CPU and import nothing of JAX.

`examples/sparse_inference_torch.py` repeats `examples/sparse_inference.py`
on the port: a smoke SmolLM with random weights, its LM head compressed,
the compressed logits against the head's decoded dense matrix, and six
requests served through the engine with the compressed head.
`examples/train_lm_torch.py` repeats `examples/train_lm.py`: a tiny SmolLM
trains with checkpoints, crashes, restores and finishes, its loss falls,
and its trained head is scored compressed over the whole batch.
`examples/cg_solver_torch.py` repeats `examples/cg_solver.py`: a CG solve
whose SpMV is `ops.spmv` on device tensors, held against the same CG with
the reference's numpy `spmv_gold` (iterations within one: the dot
products sum in another order; solutions within 1e-10).
`examples/quickstart_torch.py` repeats `examples/quickstart.py`'s six
steps; its encoded matrix has the reference's size to the byte.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "sparse_inference_torch.py"
TRAIN_EXAMPLE = ROOT / "examples" / "train_lm_torch.py"
CG_EXAMPLE = ROOT / "examples" / "cg_solver_torch.py"
QUICKSTART = ROOT / "examples" / "quickstart_torch.py"


def _example(path=EXAMPLE):
    spec = importlib.util.spec_from_file_location(path.stem, path)
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


def _imports_no_jax_and_no_repro(path):
    src = path.read_text()
    assert re.search(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\s|\.|$)",
                     src, re.MULTILINE) is None
    assert "from repro_torch" in src


def test_sparse_inference_example_imports_no_jax_and_no_repro():
    _imports_no_jax_and_no_repro(EXAMPLE)


def test_train_example_imports_no_jax_and_no_repro():
    _imports_no_jax_and_no_repro(TRAIN_EXAMPLE)


def test_train_example_runs_on_the_cpu(capsys):
    t = _example(TRAIN_EXAMPLE).main(
        ["--tiny", "--steps", "12", "--fail-at", "7", "--ckpt-every", "5",
         "--device", "cpu"])
    assert t.step == 12 and len(t.history) == 7 + 7   # 0-6, then 5-11
    out = capsys.readouterr().out
    for line in ("injected failure at step 7", "restored=True at step 5",
                 "training loss decreased: OK", "pool B=512",
                 "eval loss: dense-head"):
        assert line in out


def test_sparse_head_eval_scores_the_whole_pool():
    mod = _example(TRAIN_EXAMPLE)
    from repro_torch import configs
    from repro_torch.data.pipeline import PipelineConfig, SyntheticTokens
    from repro_torch.models import api
    cfg = configs.get_smoke("smollm-135m").with_(vocab=96)
    model = api.build_model(cfg, generator=torch.Generator().manual_seed(2),
                            device="cpu")
    batch = SyntheticTokens(PipelineConfig(vocab=96, seq_len=24,
                                           global_batch=3)).batch(0)
    dense, sparse, head, hidden, logits = mod.sparse_head_eval(
        model, cfg, batch, sparsity=0.0, value_bits=16)
    assert hidden.shape == (3, 24, cfg.d_model) and hidden.dtype == \
        torch.float32
    assert logits.shape == (3, 24, 96)
    assert torch.allclose(logits, head.apply_dense_reference(hidden),
                          rtol=1e-4, atol=1e-5)
    assert head.apply(hidden.reshape(-1, cfg.d_model)[:5]).equal(
        logits.reshape(-1, 96)[:5])
    assert abs(dense - sparse) < 1e-3          # unpruned, 16-bit values
    with torch.no_grad():
        want, _ = api.loss_fn(model, cfg, batch)
    assert dense == pytest.approx(float(want), rel=1e-6)


def test_train_example_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _example(TRAIN_EXAMPLE).main(["--tiny", "--steps", "2"])


@pytest.mark.parametrize("path", [CG_EXAMPLE, QUICKSTART],
                         ids=["cg_solver", "quickstart"])
def test_new_examples_import_no_jax_and_no_repro(path):
    _imports_no_jax_and_no_repro(path)


@pytest.mark.parametrize("path", [CG_EXAMPLE, QUICKSTART],
                         ids=["cg_solver", "quickstart"])
def test_new_examples_need_a_card_by_default(path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        _example(path).main()


def test_cg_example_matches_the_reference_cg(capsys):
    import numpy as np
    from repro.core.csr_dtans import encode_matrix, spmv_gold
    from repro.sparse.random_graphs import stencil_2d
    got = _example(CG_EXAMPLE).main(device="cpu")
    out = capsys.readouterr().out
    assert "system: 2304 unknowns" in out and "CG converged in" in out
    ref = _example(ROOT / "examples" / "cg_solver.py")
    a = stencil_2d(48)
    mat = encode_matrix(a, lane_width=128)
    b = a.to_dense() @ got["x_true"]
    x, iters = ref.cg(lambda v: spmv_gold(mat, v), b, a.shape[0])
    assert abs(got["iterations"] - iters) <= 1
    assert np.abs(got["x"] - x).max() < 1e-10
    assert got["rel_error"] < 1e-6


def test_quickstart_example_runs_on_the_cpu(capsys):
    from repro.core.csr_dtans import encode_matrix
    from repro.sparse.random_graphs import stencil_2d
    got = _example(QUICKSTART).main(device="cpu")
    out = capsys.readouterr().out
    for line in ("matrix: (14400, 14400)", "lossless roundtrip: OK",
                 "fused decode+SpMVM: OK", "autotune[erdos_renyi",
                 "autotune[watts_strogatz", "SparseLinear(auto=True)"):
        assert line in out
    assert got["mat"].nbytes == encode_matrix(stencil_2d(120),
                                              lane_width=128).nbytes
    assert len(got["picks"]) == 4
