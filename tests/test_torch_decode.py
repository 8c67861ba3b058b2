"""`ops.decode` (the decode-only kernel's plain version on the CPU) against
the JAX package.

The reference's own decode kernel does not run on the installed JAX (its
``pl.store`` is gone), so the port is held against the reference's jnp
oracle `repro.kernels.ref.decode_ref` and against the host decoder
`decode_matrix` of both packages: columns exactly, values bit for bit, on
CSR-, RGCSR- and BCSR-dtANS encodes.
"""

import functools

import numpy as np
import pytest
import torch

from repro.core.bcsr_dtans import encode_bcsr_matrix as r_encode_bcsr
from repro.core.csr_dtans import decode_matrix as r_decode_matrix
from repro.core.csr_dtans import encode_matrix as r_encode
from repro.core.rgcsr_dtans import encode_rgcsr_matrix as r_encode_rgcsr
from repro.kernels.pack import pack_matrix as r_pack
from repro.kernels.ref import decode_ref as r_decode_ref
from repro.sparse import random_graphs as r_graphs
from repro.sparse.formats import CSR as RCSR

from repro_torch import obs
from repro_torch.core.bcsr_dtans import encode_bcsr_matrix
from repro_torch.core.csr_dtans import decode_matrix, encode_matrix
from repro_torch.core.rgcsr_dtans import encode_rgcsr_matrix
from repro_torch.kernels import dtans_decode as DD
from repro_torch.kernels import ops
from repro_torch.kernels.pack import pack_matrix, to_device
from repro_torch.kernels.ref import decode_ref
from repro_torch.sparse.formats import CSR


def _rng(seed=0):
    return np.random.default_rng(seed)


def _random_dense(m, n, density, dtype, seed):
    rng = _rng(seed)
    d = rng.standard_normal((m, n)).astype(dtype)
    d[rng.random((m, n)) >= density] = 0
    return d


MATRICES = {
    "stencil-f64": lambda: r_graphs.stencil_2d(12).to_dense(),
    "random-f32-escapes": lambda: _random_dense(90, 70, 0.3, np.float32, 3),
    "random-f64-escapes": lambda: _random_dense(90, 70, 0.3, np.float64, 2),
    "wide": lambda: _random_dense(9, 200, 0.4, np.float64, 6),
    "empty-rows": lambda: np.diag(np.r_[np.zeros(10), np.arange(1.0, 11.0)]),
}

# name -> (matrix, format, encode keyword arguments)
ENCODES = {
    "csr-stencil-f64-L32": ("stencil-f64", "csr", dict(lane_width=32)),
    "csr-stencil-f64-L32-2tab": ("stencil-f64", "csr",
                                 dict(lane_width=32, shared_table=False)),
    "csr-random-f32-L16": ("random-f32-escapes", "csr", dict(lane_width=16)),
    "csr-random-f64-L128": ("random-f64-escapes", "csr",
                            dict(lane_width=128)),
    "csr-wide-L8": ("wide", "csr", dict(lane_width=8)),
    "csr-empty-rows-L16": ("empty-rows", "csr", dict(lane_width=16)),
    "rgcsr-random-f32-G8": ("random-f32-escapes", "rgcsr",
                            dict(group_size=8)),
    "rgcsr-empty-rows-G4": ("empty-rows", "rgcsr", dict(group_size=4)),
    "bcsr-stencil-f64-2x2": ("stencil-f64", "bcsr",
                             dict(block_shape=(2, 2))),
    "bcsr-random-f32-4x4": ("random-f32-escapes", "bcsr",
                            dict(block_shape=(4, 4))),
    "bcsr-wide-2x4": ("wide", "bcsr", dict(block_shape=(2, 4))),
}

_PORT = {"csr": encode_matrix, "rgcsr": encode_rgcsr_matrix,
         "bcsr": encode_bcsr_matrix}
_REF = {"csr": r_encode, "rgcsr": r_encode_rgcsr, "bcsr": r_encode_bcsr}


@functools.lru_cache(maxsize=None)
def _encoded(name):
    """(dense, reference matrix, port matrix)."""
    case, fmt, kw = ENCODES[name]
    d = MATRICES[case]()
    return (d, _REF[fmt](RCSR.from_dense(d), **kw),
            _PORT[fmt](CSR.from_dense(d), **kw))


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(
        np.uint64 if a.dtype == np.float64 else np.uint32)


@pytest.mark.parametrize("name", list(ENCODES))
def test_decode_vs_reference_oracle(name):
    """Columns exactly and values bit for bit against the reference's jnp
    `decode_ref`, in its (S, L, max_nseg * l/2) layout."""
    _, rm, m = _encoded(name)
    cols, vals = ops.decode(m, device="cpu")
    rcols, rvals = (np.asarray(a) for a in r_decode_ref(r_pack(rm)))
    assert cols.dtype == torch.int32
    assert tuple(cols.shape) == rcols.shape == tuple(vals.shape)
    np.testing.assert_array_equal(cols.numpy(), rcols)
    assert vals.numpy().dtype == rvals.dtype
    np.testing.assert_array_equal(_bits(vals.numpy()), _bits(rvals))


@pytest.mark.parametrize("name", list(ENCODES))
def test_decode_reconstructs_host_decode(name):
    """The real entries, lane by lane, are exactly the host decoder's CSR
    (the block-filled matrix for BCSR-dtANS); padding is -1 / +0."""
    d, rm, m = _encoded(name)
    cols, vals = (t.numpy() for t in ops.decode(m, device="cpu"))
    mrows = d.shape[0]
    c = cols.reshape(-1, cols.shape[-1])[:mrows]
    v = vals.reshape(-1, vals.shape[-1])[:mrows]
    real = c >= 0
    host = decode_matrix(m)
    want = r_decode_matrix(rm)
    np.testing.assert_array_equal(host.indices, want.indices)
    np.testing.assert_array_equal(real.sum(axis=1), np.diff(host.indptr))
    np.testing.assert_array_equal(c[real], host.indices)
    np.testing.assert_array_equal(_bits(v[real]), _bits(host.values))
    assert (cols.reshape(-1, cols.shape[-1])[mrows:] == -1).all()
    assert not _bits(vals[cols < 0]).any()          # +0, sign bit clear
    dense = np.zeros_like(d)
    rows = np.repeat(np.arange(mrows), real.sum(axis=1))
    dense[rows, c[real]] = v[real]
    np.testing.assert_array_equal(dense, d)


def test_decode_accepts_the_pack_and_counts_its_pass():
    """A `PackedMatrix` decodes as its matrix does; each call adds one to
    ``kernels.decode_invocations``, and a CPU call launches no kernel."""
    _, _, m = _encoded("csr-random-f32-L16")
    pm = pack_matrix(m)
    reg = obs.default_registry()
    before = reg.counter("kernels.decode_invocations").value
    launched = dict(DD.launches)
    c1, v1 = ops.decode(m, device="cpu")
    c2, v2 = ops.decode(pm, device="cpu")
    assert reg.counter("kernels.decode_invocations").value - before == 2
    assert DD.launches == launched
    assert torch.equal(c1, c2) and torch.equal(v1, v2)
    wc, wv = decode_ref(pm)
    assert torch.equal(c1, wc) and torch.equal(v1, wv)
    dm = to_device(pm, "cpu")
    assert tuple(c1.shape) == (dm.n_slices, dm.lane_width,
                               DD.out_width(dm))


def test_decode_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, _, m = _encoded("bcsr-wide-2x4")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.decode(m)
