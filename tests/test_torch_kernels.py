"""The port's torch decoder, ops and kernel wrappers against the JAX package.

On the CPU every wrapper runs its plain torch version (the CUDA kernels
have no CPU mode); `tests/test_torch_gpu.py` holds the kernels against
those plain versions on a card. Tolerances are the reference's
(`tests/test_kernels.py:71`): rtol 1e-12 for f64, 1e-4 for f32. Decoded
columns and value bits must match exactly; the port's own schedules
(column tiles, SpMM at B=1) must match each other bitwise.
"""

import numpy as np
import pytest
import torch

from repro.core.csr_dtans import encode_matrix as r_encode
from repro.core.csr_dtans import spmv_gold as r_spmv_gold
from repro.core.params import TOY as R_TOY
from repro.kernels.pack import pack_matrix as r_pack
from repro.kernels.ref import decode_ref as r_decode_ref
from repro.kernels.ref import spmv_ref as r_spmv_ref
from repro.sparse.formats import CSR as RCSR
from repro.sparse.random_graphs import banded, erdos_renyi, stencil_2d

from repro_torch.core.csr_dtans import encode_matrix
from repro_torch.core.params import TOY
from repro_torch.kernels import common, ops, tiling
from repro_torch.kernels import dtans_spmv as K
from repro_torch.kernels.pack import pack_matrix, to_device
from repro_torch.kernels.ref import decode_ref, spmv_ref
from repro_torch.sparse.formats import CSR


def _rng(seed=0):
    return np.random.default_rng(seed)


def _random_dense(m, n, density, dtype, seed, quantized=False):
    rng = _rng(seed)
    d = rng.standard_normal((m, n)).astype(dtype)
    if quantized:
        d = np.round(d * 2) / 2
    d[rng.random((m, n)) >= density] = 0
    return d


# tests/test_kernels.py::_CASES, plus an escape-heavy f64 case at the
# paper's parameters and the TOY-parameter escape golden.
CASES = [
    ("stencil-f64", lambda: stencil_2d(16).to_dense(), 32, True),
    ("stencil-f64-2tab", lambda: stencil_2d(16).to_dense(), 32, False),
    ("er-f64", lambda: erdos_renyi(200, 6, _rng(1)).to_dense(), 128, True),
    ("banded-f32", lambda: banded(150, 4).to_dense().astype(np.float32), 64,
     True),
    ("random-f64-escapes", lambda: _random_dense(90, 70, 0.3, np.float64, 2),
     16, True),
    ("random-f32-escapes", lambda: _random_dense(90, 70, 0.3, np.float32, 3),
     16, True),
    ("quantized-f32",
     lambda: _random_dense(120, 80, 0.2, np.float32, 4, quantized=True), 32,
     True),
    ("tall-skinny", lambda: _random_dense(400, 9, 0.5, np.float64, 5), 128,
     True),
    ("wide", lambda: _random_dense(9, 400, 0.4, np.float64, 6), 8, True),
    ("empty-rows",
     lambda: np.diag(np.r_[np.zeros(10), np.arange(1.0, 11.0)]), 16, True),
    ("many-escapes-f64-2tab",
     lambda: _random_dense(80, 220, 0.3, np.float64, 7), 32, False),
]


JAX_SPMV_CASES = [c for c in CASES
                  if c[0] in ("stencil-f64-2tab", "random-f32-escapes",
                              "many-escapes-f64-2tab", "empty-rows")]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    name, factory, lw, shared = request.param
    d = factory()
    rm = r_encode(RCSR.from_dense(d), lane_width=lw, shared_table=shared)
    m = encode_matrix(CSR.from_dense(d), lane_width=lw, shared_table=shared)
    return name, d, rm, r_pack(rm), m, pack_matrix(m)


def _rtol(d):
    return 1e-12 if d.dtype == np.float64 else 1e-4


def _x(d, seed, *cols):
    return _rng(seed).standard_normal((d.shape[1], *cols)).astype(d.dtype)


class TestDecoder:
    def test_decode_ref_cols_exact_vals_bitwise(self, case):
        name, _, _, rpm, _, pm = case
        cols, vals = decode_ref(pm)
        rcols, rvals = (np.asarray(a) for a in r_decode_ref(rpm))
        np.testing.assert_array_equal(cols.numpy(), rcols, err_msg=name)
        assert vals.numpy().dtype == rvals.dtype
        np.testing.assert_array_equal(
            np.ascontiguousarray(vals.numpy()).view(np.uint8),
            np.ascontiguousarray(rvals).view(np.uint8), err_msg=name)

    def test_spmv_ref_vs_gold(self, case):
        name, d, rm, _, _, pm = case
        x = _x(d, 11)
        np.testing.assert_allclose(spmv_ref(pm, x).numpy(),
                                   r_spmv_gold(rm, x), rtol=_rtol(d),
                                   atol=1e-6, err_msg=name)

    @pytest.mark.parametrize("case", JAX_SPMV_CASES, indirect=True)
    def test_spmv_ref_and_ops_vs_jax_spmv_ref(self, case):
        """Against the reference's jnp oracle (its jit compile costs ~2 s
        a case, so a subset covering f32/f64, split tables, escapes and
        empty rows)."""
        name, d, _, rpm, _, pm = case
        x = _x(d, 11)
        want = np.asarray(r_spmv_ref(rpm, x))
        for got in (spmv_ref(pm, x), ops.spmv(pm, x, device="cpu")):
            np.testing.assert_allclose(got.numpy(), want, rtol=_rtol(d),
                                       atol=1e-30, err_msg=name)

    def test_toy_params_escape_golden(self):
        """TOY parameters (2-bit words, K = 8) exercise the limb paths a
        32-bit word never takes, and escape nearly every value."""
        rng = np.random.default_rng(43)
        d = rng.standard_normal((9, 11))
        d[rng.random(d.shape) < 0.5] = 0
        rm = r_encode(RCSR.from_dense(d), params=R_TOY, lane_width=4)
        m = encode_matrix(CSR.from_dense(d), params=TOY, lane_width=4)
        assert int(m.esc_count_by_domain.sum()) > 0
        cols, vals = decode_ref(pack_matrix(m))
        rcols, rvals = (np.asarray(a) for a in r_decode_ref(r_pack(rm)))
        np.testing.assert_array_equal(cols.numpy(), rcols)
        np.testing.assert_array_equal(vals.numpy(), rvals)
        x = rng.standard_normal(11)
        np.testing.assert_allclose(spmv_ref(pack_matrix(m), x).numpy(),
                                   d @ x, rtol=1e-12, atol=1e-12)


class TestLimbArithmetic:
    @pytest.mark.parametrize("d0,d1,d2,m,a", [
        (0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 2 ** 32, 0xFFFFFFFF),
        (0xFFFFFFFF, 0, 0, 2 ** 32, 0),
        (0xFFFFFFFF, 0xFFFFFFFF, 0, 2 ** 32 - 1, 2 ** 32 - 1),
        (0x80000000, 0x7FFFFFFF, 0x12345678, 256, 255),
        (1, 0, 0, 1, 0),
    ])
    def test_mul_add_matches_python_ints(self, d0, d1, d2, m, a):
        """d * m + a mod 2^96 in 32-bit limbs, where the int64 products
        pass 2^63 (m = 2^32 is the racc a base of 256 can reach)."""
        d = torch.tensor([[d0], [d1], [d2]], dtype=torch.int64)
        got = common.limb_mul_add(d, torch.tensor([m]), torch.tensor([a]))
        want = ((d0 | d1 << 32 | d2 << 64) * m + a) % 2 ** 96
        got_int = sum(int(got[i, 0]) << (32 * i) for i in range(3))
        assert got_int == want
        assert all(0 <= int(v) <= 0xFFFFFFFF for v in got[:, 0])

    def test_shr_and_ge_w(self):
        d = torch.tensor([[0x89ABCDEF], [0x01234567], [0xFFFFFFFF]],
                         dtype=torch.int64)
        full = 0x89ABCDEF | 0x01234567 << 32 | 0xFFFFFFFF << 64
        for w in (32, 2):
            got = common._limb_shr(d, w)
            assert sum(int(got[i, 0]) << (32 * i)
                       for i in range(3)) == full >> w
        r = torch.tensor([[3], [0], [0]], dtype=torch.int64)
        assert not bool(common._limb_ge_w(r, 32)[0])
        assert not bool(common._limb_ge_w(r, 2)[0])
        assert bool(common._limb_ge_w(r + torch.tensor([[1], [0], [0]]),
                                      2)[0])
        assert bool(common._limb_ge_w(torch.tensor([[0], [1], [0]]), 32)[0])

    def test_bits_to_value_f32_no_saturation(self):
        vals = np.array([-1.5, 2.0, -0.0, np.inf, -3.25e-5], np.float32)
        bits = torch.from_numpy(vals.view(np.uint32).astype(np.int64))
        got = common.bits_to_value(bits, torch.float32).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      vals.view(np.uint32))

    def test_bits_to_value_f64_high_bit(self):
        vals = np.array([-1.5, 2.0, -0.0, -np.inf, 1e-300])
        bits = torch.from_numpy(vals.view(np.int64).copy())
        got = common.bits_to_value(bits, torch.float64).numpy()
        np.testing.assert_array_equal(got.view(np.uint64),
                                      vals.view(np.uint64))


class TestOps:
    def test_spmv_vs_reference_gold(self, case):
        name, d, rm, _, _, pm = case
        x = _x(d, 12)
        got = ops.spmv(pm, x, device="cpu")
        assert got.dtype == (torch.float64 if d.dtype == np.float64
                             else torch.float32)
        np.testing.assert_allclose(got.numpy(), r_spmv_gold(rm, x),
                                   rtol=_rtol(d), atol=1e-6, err_msg=name)

    def test_spmv_accumulates_y(self, case):
        _, d, _, _, _, pm = case
        x, y0 = _x(d, 13), _rng(14).standard_normal(d.shape[0]).astype(
            d.dtype)
        got = ops.spmv(pm, x, y0, device="cpu").numpy()
        np.testing.assert_allclose(got, d @ x + y0, rtol=_rtol(d),
                                   atol=1e-6)

    @pytest.mark.parametrize("B", [1, 3, 8])
    def test_spmm_vs_reference_gold(self, case, B):
        name, d, rm, _, m, _ = case
        X = _x(d, 15 + B, B)
        got = ops.spmm(m, X, device="cpu", bn=2).numpy()
        assert got.shape == (d.shape[0], B)
        for b in range(B):
            np.testing.assert_allclose(got[:, b], r_spmv_gold(rm, X[:, b]),
                                       rtol=_rtol(d), atol=1e-6,
                                       err_msg=f"{name} column {b}")

    def test_spmm_b1_bitwise_spmv(self, case):
        _, d, _, _, _, pm = case
        x = _x(d, 20)
        a = ops.spmm(pm, x[:, None], device="cpu")[:, 0]
        assert torch.equal(a, ops.spmv(pm, x, device="cpu"))
        dm = to_device(pm, "cpu")
        xt = torch.from_numpy(x)
        assert torch.equal(K.dtans_spmm(dm, xt[:, None])[..., 0],
                           K.dtans_spmv(dm, xt))

    @pytest.mark.parametrize("bn", [1, 2, 3, 5])
    def test_tiled_bitwise_untiled(self, case, bn):
        _, d, _, _, _, pm = case
        X = _x(d, 21, 7)
        untiled = ops.spmm(pm, X, device="cpu", bn=64)
        assert torch.equal(ops.spmm(pm, X, device="cpu", bn=bn), untiled)

    def test_empty_batch(self, case):
        _, d, _, _, _, pm = case
        out = ops.spmm(pm, np.zeros((d.shape[1], 0), d.dtype), device="cpu")
        assert tuple(out.shape) == (d.shape[0], 0)

    def test_rhs_shape_checks(self, case):
        _, d, _, _, _, pm = case
        with pytest.raises(ValueError):
            ops.spmm(pm, np.zeros(d.shape[1], d.dtype), device="cpu")
        with pytest.raises(ValueError):
            ops.spmm(pm, np.zeros((d.shape[1] + 1, 2), d.dtype),
                     device="cpu")
        with pytest.raises(ValueError):
            ops.spmv(pm, np.zeros((d.shape[1], 2), d.dtype), device="cpu")


class TestWrappers:
    def test_cpu_path_is_plain_and_launches_nothing(self):
        a = _random_dense(40, 30, 0.3, np.float32, 30)
        dm = to_device(pack_matrix(encode_matrix(CSR.from_dense(a),
                                                 lane_width=16)), "cpu")
        x = torch.from_numpy(_x(a, 31, 4))
        before = dict(K.launches)
        assert torch.equal(K.dtans_spmm(dm, x, bn=3),
                           K.dtans_spmm_plain(dm, x, 3))
        assert torch.equal(K.dtans_spmv(dm, x[:, 0]),
                           K.dtans_spmv_plain(dm, x[:, 0]))
        assert K.launches == before

    def test_matrix_bytes_counts_device_tensors(self):
        """`kernels.matrix_bytes` adds the bytes of the tensors the kernels
        read (uint32 stream, no row_valid), once per pass at any tiling."""
        from repro_torch import obs
        a = _random_dense(40, 30, 0.3, np.float32, 34)
        pm = pack_matrix(encode_matrix(CSR.from_dense(a), lane_width=16))
        dm = to_device(pm, "cpu")
        host = sum(v.nbytes for v in vars(pm).values()
                   if isinstance(v, np.ndarray))
        assert dm.nbytes == (pm.stream.size * 4 + pm.esc.nbytes
                             + pm.ns.nbytes + pm.nnz.nbytes
                             + pm.tab_symbol.nbytes + pm.tab_digit.nbytes
                             + pm.tab_base.nbytes + pm.tab_is_esc.nbytes)
        assert dm.nbytes < host
        c = obs.default_registry().counter("kernels.matrix_bytes")
        before = c.value
        ops.spmv(pm, _x(a, 35, 1)[:, 0], device="cpu")
        ops.spmm(pm, _x(a, 36, 5), device="cpu", bn=2)
        assert c.value == before + 2 * dm.nbytes

    def test_wrapper_rejects_mismatched_rhs(self):
        a = _random_dense(20, 10, 0.5, np.float64, 32)
        dm = to_device(pack_matrix(encode_matrix(CSR.from_dense(a),
                                                 lane_width=8)), "cpu")
        with pytest.raises(TypeError):
            K.dtans_spmv(dm, torch.zeros(10, dtype=torch.float32))
        with pytest.raises(ValueError):
            K.dtans_spmv(dm, torch.zeros(11, dtype=torch.float64))
        with pytest.raises(ValueError):
            K.dtans_spmm(dm, torch.zeros(10, 3, dtype=torch.float64), bn=0)


class TestRefusals:
    @pytest.fixture(scope="class")
    def pm(self):
        a = _random_dense(20, 10, 0.5, np.float32, 33)
        return pack_matrix(encode_matrix(CSR.from_dense(a), lane_width=8))

    @pytest.mark.parametrize("kw", [dict(n_shards=2), dict(mesh=object()),
                                    dict(pipeline=True), dict(fused=True)])
    @pytest.mark.parametrize("fn", ["spmv", "spmm"])
    def test_unported_knobs_raise(self, pm, kw, fn):
        x = np.ones(10, np.float32) if fn == "spmv" else np.ones((10, 2),
                                                                 np.float32)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(ops, fn)(pm, x, device="cpu", **kw)

    def test_shared_cols_pack_raises(self, pm):
        import dataclasses
        shared = dataclasses.replace(pm, shared_cols=True)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ops.spmv(shared, np.ones(10, np.float32), device="cpu")

    @pytest.mark.parametrize("name", ["decode", "sell_spmv", "sell_spmm",
                                      "rgcsr_spmv", "rgcsr_spmm",
                                      "bcsr_spmv", "bcsr_spmm"])
    def test_unported_entry_points_raise(self, pm, name):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            getattr(ops, name)(pm)

    def test_cuda_request_without_card_raises(self, pm):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.spmv(pm, np.ones(10, np.float32))
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.spmm(pm, np.ones((10, 3), np.float32), device="cuda")


class TestTiling:
    def test_untiled_when_batch_fits(self):
        assert tiling.choose_bn(128, 64, 4) is None
        assert tiling.choose_bn(128, 0, 4) is None

    def test_snaps_to_warp_multiple_within_budget(self):
        bn = tiling.choose_bn(128, 512, 4)
        assert bn == 96 and bn % tiling.WARP == 0
        assert 128 * bn * 4 <= tiling.DEFAULT_SMEM_BYTES
        assert tiling.choose_bn(128, 512, 8) == 32

    def test_rows_round_up_to_warps(self):
        assert tiling.choose_bn(100, 512, 4) == tiling.choose_bn(128, 512, 4)

    def test_floor_fits_opt_in_limit(self):
        bn = tiling.choose_bn(1024, 512, 8)
        assert bn == tiling.MIN_BN
        assert 1024 * bn * 8 <= (tiling.MAX_SMEM_BYTES
                                 - tiling.STATIC_SMEM_BYTES)
        K._check_tile(1024, 512, bn, 8)

    def test_tile_beside_static_smem_refused(self):
        """A tile that fits the opt-in limit alone but not beside the
        kernels' static shared memory is refused with a clear message."""
        room = tiling.MAX_SMEM_BYTES - tiling.STATIC_SMEM_BYTES
        bt = room // (128 * 4)
        K._check_tile(128, 4096, bt, 4)
        assert (bt + 1) * 128 * 4 > room
        with pytest.raises(ValueError, match="smaller bn"):
            K._check_tile(128, 4096, bt + 1, 4)
        at_limit = tiling.MAX_SMEM_BYTES // (32 * 8)      # 908 f64 columns
        assert at_limit * 32 * 8 == tiling.MAX_SMEM_BYTES
        with pytest.raises(ValueError, match="smaller bn"):
            K._check_tile(1, 4096, at_limit, 8)
        with pytest.raises(ValueError, match="grid"):
            K._check_tile(32, 65536 * 2, 1, 4)

