"""The port's Mamba2 block against the JAX package's, on the same weights.

mamba2-130m's smoke config (d_model 64, d_inner 128, 8 heads of 16, state
16, conv 4, chunk 8): the reference's ``init_params`` draws the weights and
`convert.model_from_jax_params` carries them across; layer 0's block is
compared. Inputs are made by numpy from a seed. The chunked scan runs at a
sequence a multiple of the chunk, one that is not (13 at chunk 8, padded
with x = 0 and a = 0) and one below it; the output, the conv tail and the
final state are compared. The single-token recurrence runs chained after a
prefill, with an inactive slot. Float32; tolerance rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import api as japi
from repro.models import ssm as jssm

from repro_torch import configs, convert
from repro_torch.models import ssm

TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "mamba2-130m"

_MODEL: dict = {}


def _pair():
    """(reference cfg, reference layer-0 block params, port block), built
    once per module."""
    if not _MODEL:
        jcfg = jax_smoke(ARCH)
        params = japi.init_params(jcfg, jax.random.PRNGKey(0))
        model = convert.model_from_jax_params(
            configs.get_smoke(ARCH), jax.tree.map(np.asarray, params),
            device="cpu")
        p0 = jax.tree.map(lambda a: a[0], params["layers"]["ssm"])
        _MODEL["pair"] = (jcfg, p0, model.layers[0].ssm)
    return _MODEL["pair"]


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def test_softplus_is_jax_softplus_past_torch_threshold():
    x = np.array([-40.0, -3.0, 0.0, 0.5, 19.0, 20.5, 25.0, 60.0],
                 dtype=np.float32)
    want = jax.nn.softplus(jnp.asarray(x))
    _close(ssm.softplus(torch.from_numpy(x)), want)


def test_segsum():
    a = _rand(0, 2, 3, 8, scale=0.3)
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    got = ssm._segsum(torch.from_numpy(a)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


@pytest.mark.parametrize("s, chunk", [(16, 8), (8, 8), (24, 4)])
def test_ssd_chunked(s, chunk):
    b, h, p, n = 2, 3, 4, 5
    x = _rand(1, b, s, h, p)
    a = -np.abs(_rand(2, b, s, h, scale=0.5))
    Bm, Cm = _rand(3, b, s, n), _rand(4, b, s, n)
    want_y, want_st = jssm._ssd_chunked(*map(jnp.asarray, (x, a, Bm, Cm)),
                                        chunk)
    got_y, got_st = ssm._ssd_chunked(*map(torch.from_numpy, (x, a, Bm, Cm)),
                                     chunk)
    _close(got_y, want_y)
    _close(got_st, want_st)


@pytest.mark.parametrize("S", [16, 13, 5], ids=["multiple", "ragged",
                                                 "below-chunk"])
def test_prefill_output_conv_tail_and_state(S):
    jcfg, p, block = _pair()
    u = _rand(5, 2, S, jcfg.d_model)
    want, wcache = jssm.ssm_block(p, jcfg, jnp.asarray(u), return_cache=True)
    got, cache = block(torch.from_numpy(u), return_cache=True)
    _close(got, want)
    for n in ("conv", "state"):
        assert cache[n].shape == wcache[n].shape
        assert cache[n].dtype == getattr(torch, str(wcache[n].dtype))
        _close(cache[n], wcache[n])
    out, none = block(torch.from_numpy(u))
    assert none is None
    _close(out, want)


def test_recurrence_chained_after_a_prefill_keeps_an_inactive_slot():
    jcfg, p, block = _pair()
    u = _rand(6, 3, 11, jcfg.d_model)
    _, wcache = jssm.ssm_block(p, jcfg, jnp.asarray(u), return_cache=True)
    _, cache = block(torch.from_numpy(u), return_cache=True)
    active = torch.tensor([True, False, True])
    start = {n: c.clone() for n, c in cache.items()}
    for step in range(3):
        x = _rand(7 + step, 3, 1, jcfg.d_model)
        want, wnew = jssm.ssm_block(p, jcfg, jnp.asarray(x), cache=wcache)
        got, new = block(torch.from_numpy(x), cache=cache, active=active)
        assert new is cache                       # written in place
        _close(got, want)
        for n in ("conv", "state"):
            _close(new[n][active], np.asarray(wnew[n])[active.numpy()])
        wcache = {n: jnp.where(jnp.asarray(active.numpy()).reshape(
            (-1,) + (1,) * (c.ndim - 1)), c, jnp.asarray(start[n].numpy()))
            for n, c in wnew.items()}
        for n in ("conv", "state"):              # slot 1: every bit kept
            assert torch.equal(cache[n][1], start[n][1])


def test_recurrence_without_a_mask_advances_every_slot():
    jcfg, p, block = _pair()
    conv = _rand(8, 2, jcfg.conv_width - 1,
                 jcfg.d_inner + 2 * jcfg.ssm_state)
    state = _rand(9, 2, jcfg.ssm_heads, jcfg.ssm_headdim, jcfg.ssm_state)
    x = _rand(10, 2, 1, jcfg.d_model)
    want, wnew = jssm.ssm_block(p, jcfg, jnp.asarray(x),
                                cache={"conv": jnp.asarray(conv),
                                       "state": jnp.asarray(state)})
    got, new = block(torch.from_numpy(x),
                     cache={"conv": torch.from_numpy(conv.copy()),
                            "state": torch.from_numpy(state.copy())},
                     active=torch.ones(2, dtype=torch.bool))
    _close(got, want)
    for n in ("conv", "state"):
        _close(new[n], wnew[n])


def test_cache_init_dtypes_and_float32_leaves_in_bfloat16():
    cfg = configs.get_smoke(ARCH).with_(dtype="bfloat16")
    want = jssm.ssm_cache_init(jax_smoke(ARCH).with_(dtype="bfloat16"), 3)
    got = ssm.ssm_cache_init(cfg, 3, device="cpu")
    for n in ("conv", "state"):
        assert tuple(got[n].shape) == want[n].shape
        assert str(got[n].dtype).split(".")[-1] == str(want[n].dtype)
        assert not got[n].any()
    block = ssm.SSM(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jssm.ssm_init(jax_smoke(ARCH).with_(dtype="bfloat16"),
                       jax.random.PRNGKey(0))
    for name, t in block.named_parameters():
        assert str(t.dtype).split(".")[-1] == str(jp[name].dtype), name
        assert tuple(t.shape) == jp[name].shape, name
    assert block.A_log.dtype == block.D.dtype == block.dt_bias.dtype \
        == torch.float32
