"""The CUDA kernels on the card, and their build.

This file imports neither JAX nor the `repro` package, so that it runs on
a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The ``gpu`` tests hold each kernel against its plain torch version on the
card (rtol 1e-4 f32 / 1e-12 f64, the reference's tolerances), and the
port's schedules against each other bitwise; they skip in their body where
torch sees no card. The build tests run anywhere: a missing ``nvcc`` and a
failing compile must raise.
"""

import os
import stat

import numpy as np
import pytest
import torch

from repro_torch.core.csr_dtans import encode_matrix
from repro_torch.core.params import TOY
from repro_torch.kernels import _build, ops, tiling
from repro_torch.kernels import dtans_spmv as K
from repro_torch.kernels.pack import pack_matrix, to_device
from repro_torch.serving.sparse_linear import SparseLinear
from repro_torch.sparse.formats import CSR

RTOL = {torch.float32: 1e-4, torch.float64: 1e-12}


def _dense(m, n, density, dtype, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)).astype(dtype)
    d[rng.random((m, n)) >= density] = 0
    return d


CASES = [
    # name, dense factory, lane_width, shared_table
    ("f64-escapes", lambda: _dense(200, 150, 0.3, np.float64, 1), 16, True),
    ("f32-escapes-2tab", lambda: _dense(200, 150, 0.3, np.float32, 2), 32,
     False),
    ("f32-quantized", lambda: np.round(_dense(300, 90, 0.2, np.float32, 3)
                                       * 2) / 2, 128, True),
    ("f64-wide", lambda: _dense(9, 400, 0.4, np.float64, 4), 8, True),
    ("f64-tall", lambda: _dense(500, 9, 0.5, np.float64, 5), 64, True),
    ("f64-empty-rows",
     lambda: np.diag(np.r_[np.zeros(10), np.arange(1.0, 11.0)]), 16, True),
]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def packed(request):
    _, factory, lw, shared = request.param
    d = factory()
    return d, pack_matrix(encode_matrix(CSR.from_dense(d), lane_width=lw,
                                        shared_table=shared))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _close(got, want, dtype):
    scale = want.abs().max().item() if want.numel() else 0.0
    assert bool(((got - want).abs()
                 <= RTOL[dtype] * (want.abs() + scale)).all())


@pytest.mark.gpu
def test_kernels_vs_plain_on_card(packed):
    _need_card()
    d, pm = packed
    dm = to_device(pm, "cuda")
    rng = np.random.default_rng(6)
    X = torch.as_tensor(rng.standard_normal((d.shape[1], 9)),
                        dtype=dm.dtype, device="cuda")
    x = X[:, 0].contiguous()
    y = K.dtans_spmv(dm, x)
    _close(y, K.dtans_spmv_plain(dm, x), dm.dtype)
    Y = K.dtans_spmm(dm, X)
    _close(Y, K.dtans_spmm_plain(dm, X), dm.dtype)
    for bn in (1, 4, 8):
        assert torch.equal(K.dtans_spmm(dm, X, bn=bn), Y)
    assert torch.equal(K.dtans_spmm(dm, X[:, :1].contiguous())[..., 0], y)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_ops_on_card_vs_dense(packed):
    _need_card()
    d, pm = packed
    X = np.random.default_rng(7).standard_normal((d.shape[1], 5)).astype(
        d.dtype)
    got = ops.spmm(pm, X, bn=2)
    assert got.device.type == "cuda"
    _close(got.cpu(), torch.from_numpy(d @ X), got.dtype)
    _close(ops.spmv(pm, X[:, 0]).cpu(), torch.from_numpy(d @ X[:, 0]),
           got.dtype)


@pytest.mark.gpu
def test_sparse_linear_on_card_counts_launches():
    _need_card()
    w = (np.random.default_rng(8).standard_normal((96, 300)) / 10).astype(
        np.float32)
    sl = SparseLinear.from_dense(w, sparsity=0.7, value_bits=6,
                                 lane_width=32)
    K.reset_launches()
    x = torch.randn(3, 4, 96, device="cuda")
    y = sl.apply(x)
    y1 = sl.apply(x[:1, 0])
    torch.cuda.synchronize()
    assert K.launches["dtans_spmm"] == 1 and K.launches["dtans_spmv"] == 1
    assert y.device.type == "cuda" and tuple(y.shape) == (3, 4, 300)
    torch.testing.assert_close(y, sl.apply_dense_reference(x), rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(y1, sl.apply_dense_reference(x[:1, 0]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take():
    _need_card()
    d = _dense(12, 10, 0.5, np.float64, 9)
    toy = to_device(pack_matrix(encode_matrix(CSR.from_dense(d), params=TOY,
                                              lane_width=4)), "cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        K.dtans_spmv(toy, torch.zeros(10, dtype=torch.float64,
                                      device="cuda"))
    dm = to_device(pack_matrix(encode_matrix(CSR.from_dense(d),
                                             lane_width=1024)), "cuda")
    with pytest.raises(ValueError, match="shared memory"):
        K.dtans_spmm(dm, torch.zeros(10, 64, dtype=torch.float64,
                                     device="cuda"))


@pytest.mark.gpu
def test_static_smem_matches_tiling():
    """The wrapper's shared-memory check subtracts exactly the kernel's
    static arrays."""
    _need_card()
    assert K.static_smem_bytes() == tiling.STATIC_SMEM_BYTES


def _fake_nvcc(tmp_path, body: str) -> str:
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body + "\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    return str(bindir)


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_failed_build_raises_with_log(tmp_path, monkeypatch):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cu").write_text("not c++\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", _fake_nvcc(
        tmp_path, 'echo "broken.cu(1): error: syntax" >&2; exit 2')
        + os.pathsep + os.environ.get("PATH", ""))
    with pytest.raises(RuntimeError, match="syntax"):
        _build.build_all(("broken",))
    assert not _build.library_path("broken").exists()


def test_build_is_keyed_on_the_source(tmp_path, monkeypatch):
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "csrc" / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", _fake_nvcc(
        tmp_path, 'while [ "$1" != "-o" ]; do shift; done; touch "$2"')
        + os.pathsep + os.environ.get("PATH", ""))
    first = _build.build_all(("k",))["k"]
    assert first.exists() and first.parent == tmp_path / "build"
    src.write_text("// two\n")
    second = _build.library_path("k")
    assert second != first and not second.exists()
    assert _build.build_all(("k",))["k"] == second and second.exists()
