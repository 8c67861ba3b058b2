"""The port's SparseLinear against the JAX package's, on the same weights.

Both packages compress the same seeded ``w`` (f32 and f64); the packs must
be byte-equal, and the port's `apply` (plain torch path on the CPU) must
agree with the JAX `apply` (Pallas interpret mode, as tests/test_serving.py
runs it) and with `apply_dense_reference`, within 1e-4 (f32) / 1e-12 (f64).
`convert.py` must carry a JAX layer across without re-encoding.
"""

import numpy as np
import pytest
import torch

from repro.serving.sparse_linear import SparseLinear as RSparseLinear

from repro_torch import convert, obs
from repro_torch.kernels import ops
from repro_torch.serving.sparse_linear import SparseLinear

PACK_ARRAYS = ("stream", "esc", "ns", "nnz", "row_valid", "tab_symbol",
               "tab_digit", "tab_base", "tab_is_esc")
D_IN, D_OUT = 64, 120
TOL = {np.float32: dict(rtol=1e-4, atol=1e-5),
       np.float64: dict(rtol=1e-12, atol=1e-12)}


@pytest.fixture(scope="module", params=[np.float32, np.float64],
                ids=["f32", "f64"])
def layers(request):
    dt = request.param
    w = (np.random.default_rng(0).standard_normal((D_IN, D_OUT)) / 10
         ).astype(dt)
    kw = dict(sparsity=0.7, value_bits=6, lane_width=32)
    return dt, RSparseLinear.from_dense(w, **kw), \
        SparseLinear.from_dense(w, device="cpu", **kw)


def _x(dt, seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(dt)


def test_packs_byte_equal(layers):
    _, ref, sl = layers
    for f in PACK_ARRAYS:
        a, b = getattr(ref.packed, f), getattr(sl.packed, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert ref.packed.max_nseg == sl.packed.max_nseg
    assert ref.packed.pattern == sl.packed.pattern


def test_byte_properties_match_reference(layers):
    _, ref, sl = layers
    assert sl.compressed_bytes == ref.compressed_bytes
    assert sl.dense_bytes == ref.dense_bytes
    assert sl.baseline_bytes == ref.baseline_bytes
    assert sl.compression_vs_dense == ref.compression_vs_dense
    assert sl.compression_vs_best_sparse == ref.compression_vs_best_sparse
    assert sl.mat.dtype == ref.mat.dtype


@pytest.mark.parametrize("shape", [(5, D_IN), (2, 3, D_IN), (1, D_IN)],
                         ids=["2d", "3d", "b1"])
def test_apply_vs_jax_apply(layers, shape):
    dt, ref, sl = layers
    x = _x(dt, 1, *shape)
    got = sl.apply(x)
    assert got.dtype == torch.from_numpy(x).dtype
    assert tuple(got.shape) == (*shape[:-1], D_OUT)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.apply(x)),
                               **TOL[dt])


@pytest.mark.parametrize("shape", [(7, D_IN), (2, 4, D_IN), (1, D_IN)],
                         ids=["2d", "3d", "b1"])
def test_apply_vs_dense_reference(layers, shape):
    dt, ref, sl = layers
    x = _x(dt, 2, *shape)
    got = sl.apply(x).numpy()
    np.testing.assert_allclose(got, sl.apply_dense_reference(x).numpy(),
                               **TOL[dt])
    np.testing.assert_allclose(got,
                               np.asarray(ref.apply_dense_reference(x)),
                               **TOL[dt])


def test_apply_accepts_tensors_and_tiles_bitwise(layers):
    dt, _, sl = layers
    x = torch.from_numpy(_x(dt, 3, 9, D_IN))
    whole = sl.apply(x)
    assert torch.equal(sl.apply(x, bn=2), whole)
    assert torch.equal(sl.apply(x.numpy()), whole)


def test_b1_apply_bitwise_spmv(layers):
    dt, _, sl = layers
    x = _x(dt, 4, 1, D_IN)
    assert torch.equal(sl.apply(x)[0],
                       ops.spmv(sl.packed, x[0], device="cpu"))


def test_empty_batch(layers):
    dt, _, sl = layers
    got = sl.apply(np.zeros((0, D_IN), dt))
    assert tuple(got.shape) == (0, D_OUT)


def test_apply_records_metrics(layers):
    dt, _, sl = layers
    reg = obs.MetricsRegistry()
    kern = obs.default_registry()
    before = kern.counter("kernels.dtans_spmm_calls").value
    sl.apply(_x(dt, 5, 6, D_IN), metrics=reg)
    snap = reg.snapshot()
    assert snap["counters"]["serving.sparse_apply_calls"] == 1
    assert snap["histograms"]["serving.apply_batch"]["max"] == 6
    assert kern.counter("kernels.dtans_spmm_calls").value == before + 1


def test_convert_round_trip_from_jax(layers, tmp_path):
    dt, ref, sl = layers
    arrays = convert.sparse_linear_to_arrays(ref)
    np.savez(tmp_path / "head.npz", **arrays)
    with np.load(tmp_path / "head.npz") as f:
        loaded = {k: f[k] for k in f.files}
    back = convert.sparse_linear_from_arrays(loaded, device="cpu")
    for f in PACK_ARRAYS:
        assert np.array_equal(getattr(back.packed, f),
                              getattr(ref.packed, f)), f
    assert back.compressed_bytes == ref.compressed_bytes
    assert back.baseline_bytes == ref.baseline_bytes
    for t, rt in zip(back.mat.tables, ref.mat.tables):
        assert t.first_slot == rt.first_slot
        assert t.esc_first == rt.esc_first and t.esc_base == rt.esc_base
    x = _x(dt, 6, 4, D_IN)
    assert torch.equal(back.apply(x), sl.apply(x))
    # and the port's own layer flattens to the same arrays
    mine = convert.sparse_linear_to_arrays(sl)
    assert set(mine) == set(arrays)
    for k in arrays:
        assert np.array_equal(mine[k], arrays[k]), k


def test_from_dense_refusals():
    w = np.random.default_rng(5).standard_normal((8, 40)).astype(np.float32)
    x = torch.as_tensor(np.random.default_rng(6).standard_normal((3, 8)),
                        dtype=torch.float32)
    from repro_torch.autotune import DecisionCache
    for auto in (False, True):
        kw = dict(auto=auto, device="cpu", lane_width=8,
                  autotune_cache=DecisionCache(path=None))
        # sharding is ported: n_shards=2 serves bitwise the unsharded layer
        sl = SparseLinear.from_dense(w, n_shards=2, **kw)
        assert sl.n_shards == 2 and sl.plan.n_shards == 2
        assert torch.equal(sl.apply(x), ops.spmm(
            sl.whole(), x.T.contiguous(), device="cpu").T)
        # a mesh must be a torch DeviceMesh
        with pytest.raises(TypeError, match="DeviceMesh"):
            SparseLinear.from_dense(w, mesh=object(), **kw)
    # auto=True is ported (the autotuner): it no longer refuses
    w = np.random.default_rng(4).standard_normal((8, 16)).astype(np.float32)
    from repro_torch.autotune import DecisionCache
    sl = SparseLinear.from_dense(w, auto=True, device="cpu",
                                 autotune_cache=DecisionCache(path=None))
    assert sl.decision is not None and sl.decision.machine == "h100"


def test_from_dense_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SparseLinear.from_dense(np.ones((8, 16), np.float32))


def test_non_float_weights_become_f32():
    w = np.random.default_rng(8).integers(-3, 4, size=(8, 16))
    sl = SparseLinear.from_dense(w, sparsity=0.5, lane_width=8,
                                 device="cpu")
    assert sl.mat.dtype == np.float32

