"""The yardstick's arithmetic: HPCG's operator, operations and bytes,
the roofline and idle shares, the readers, the frozen prune."""

import math

import numpy as np
import pytest
import torch

from perfbench import manifest, peaks, roofline, timeline, work
from perfbench.reference import hpcg, prune, sparse
from perfbench.reference.precision import round_tf32


def _dense_27pt(nx, ny, nz):
    n = nx * ny * nz
    a = np.zeros((n, n))
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                i = ix + nx * (iy + ny * iz)
                for sz in (-1, 0, 1):
                    for sy in (-1, 0, 1):
                        for sx in (-1, 0, 1):
                            jx, jy, jz = ix + sx, iy + sy, iz + sz
                            if 0 <= jx < nx and 0 <= jy < ny and 0 <= jz < nz:
                                j = jx + nx * (jy + ny * jz)
                                a[i, j] = 26.0 if i == j else -1.0
    return a


def test_hpcg_operator_is_the_dense_27_point_stencil():
    indptr, indices, values, n = hpcg.stencil27(8, 8, 8)
    assert n == 512 and values.size == 22 ** 3
    a = np.zeros((n, n))
    for i in range(n):
        cols = indices[indptr[i]:indptr[i + 1]]
        assert np.all(np.diff(cols) > 0)
        a[i, cols] = values[indptr[i]:indptr[i + 1]]
    np.testing.assert_array_equal(a, _dense_27pt(8, 8, 8))
    np.testing.assert_array_equal(a, a.T)
    assert np.linalg.eigvalsh(a).min() > 0


def test_hpcg_full_grid_counts():
    assert (3 * 64 - 2) ** 3 == 6_859_000
    per_iter = work.cg_set_flops(6_859_000, 64 ** 3, 1) - work.cg_set_flops(
        6_859_000, 64 ** 3, 0)
    assert per_iter == 2 * 6_859_000 + 10 * 64 ** 3 == 16_339_440


def test_multiply_operations_and_bytes():
    assert work.multiply_flops(7_723_008, 64) == 2 * 7_723_008 * 64
    assert work.pass_bytes(1000, 50280, 768, 64, 4) == 1000 + (50280 + 768) * 64 * 4
    flops, nbytes = 2 * 7_723_008 * 64, 14e6 + (50280 + 768) * 64 * 4
    assert peaks.least_time(flops, nbytes, "float32") == pytest.approx(
        flops / 67e12)
    assert peaks.least_time(2 * 6.859e6, 24e6, "float64") == pytest.approx(
        24e6 / 3.35e12)


def _run(**kw):
    tl = {"device": [("void dtans_spmm_kernel<float>", 10.0, 40.0),
                     ("fill", 50.0, 60.0), ("void dtans_spmm_kernel<float>", 70.0, 100.0)],
          "host": [("perfbench.call", 5.0, 45.0), ("cudaLaunchKernel", 6.0, 8.0),
                   ("perfbench.call", 65.0, 105.0)],
          "marks": {"perfbench.window": [(0.0, 110.0)],
                    "perfbench.call": [(5.0, 45.0), (65.0, 105.0)]}}
    run = {"timeline": tl, "dtype": "float32", "rows": 1000, "cols": 100,
           "batch": 4, "nnz": 10_000,
           "counters": {"kernels.dtans_spmm_calls": 2, "kernels.spmm_calls": 2,
                        "kernels.matrix_bytes": 2 * 50_000}}
    run.update(kw)
    return run


def test_roofline_share_from_trace_and_counters():
    run = _run()
    least = peaks.least_time(2 * 10_000 * 4, 50_000 + 1100 * 4 * 4, "float32")
    assert roofline.kernel_share(run, "dtans_spmm_kernel") == pytest.approx(
        100 * least / 30e-6)
    assert roofline.kernel_share(run, "dtans_spmv_kernel") is None
    assert roofline.kernel_share(_run(timeline=None),
                                 "dtans_spmm_kernel") is None


def test_idle_shares_and_breakdown():
    run = _run()
    assert roofline.idle_pct(run, "perfbench.call") == pytest.approx(
        100 * (1 - 60 / 80))
    assert roofline.idle_pct(run, "perfbench.window") == pytest.approx(
        100 * (1 - 70 / 110))
    tl = run["timeline"]
    assert timeline.device_ops(tl)[0] == ["void dtans_spmm_kernel<float>",
                                          pytest.approx(60e-6)]
    gaps = dict(timeline.idle_gaps(tl))
    assert sum(gaps.values()) == pytest.approx(40e-6)
    assert gaps["perfbench.call"] == pytest.approx(18e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(2e-6)
    assert gaps["python"] == pytest.approx(20e-6)             # outside calls
    assert timeline.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert timeline.covered([(0, 3), (5, 6)], [(2, 5.5)]) == pytest.approx(1.5)


def test_innermost_host_segments_nest():
    segs = timeline._innermost([("a", 0, 10), ("b", 2, 4), ("c", 3, 4),
                                ("d", 6, 12)])
    assert segs == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 6, "a"),
                    (6, 10, "d")]


@pytest.mark.parametrize("name,expect", [
    ("apply_ms", 2.5), ("apply_p95_ms", 3.85), ("step_mfu.apply", None)])
def test_latency_readers(name, expect):
    run = {"latencies_s": [1e-3, 2e-3, 3e-3, 4e-3], "batch": 4,
           "dtype": "float32", "nnz": None}
    got = manifest.reader(name)(run)
    assert got == (pytest.approx(expect) if expect is not None else None)


def test_rate_readers():
    run = {"flops": 34e12, "window_s": 2.0, "dtype": "float64"}
    assert manifest.reader("gflops")(run) == pytest.approx(17e3)
    assert manifest.reader("step_mfu.gflops")(run) == pytest.approx(50.0)
    assert manifest.reader("gflops")({}) is None


def test_enqueue_reader_reads_the_ports_span():
    run = {"spans": [{"name": "serving.sparse_apply", "dur_s": 2e-5},
                     {"name": "other", "dur_s": 1.0},
                     {"name": "serving.sparse_apply", "dur_s": 4e-5}]}
    assert manifest.reader("serving.enqueue_us.apply")(run) == pytest.approx(30.0)
    assert manifest.reader("serving.enqueue_us.apply")({}) is None


def test_frozen_prune_is_the_ports():
    from repro_torch.sparse.prune import codebook_quantize, magnitude_prune
    w = np.random.default_rng(5).normal(0, 0.02, (48, 300)).astype(np.float32)
    port = codebook_quantize(magnitude_prune(w.T, 0.8), bits=8)
    ref = prune.pruned_quantized(np.ascontiguousarray(w.T), 0.8, 8)
    np.testing.assert_array_equal(port.to_dense(), ref)
    assert port.nnz == np.count_nonzero(ref) == round(0.2 * w.size)


def test_tf32_rounding_keeps_ten_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.0],
                     dtype=torch.float32)
    assert round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, -3.0]


def test_plain_cg_solves_the_operator():
    indptr, indices, values, n = hpcg.stencil27(6, 6, 6)
    op = sparse.csr_operator(indptr, indices, values, n, torch.float64, "cpu")
    x_true = torch.linspace(-1, 1, n, dtype=torch.float64)
    x, rnorm = sparse.cg(op, op(x_true), 60)
    assert rnorm < 1e-10 and math.isfinite(rnorm)
    torch.testing.assert_close(x, x_true, rtol=0, atol=1e-10)
