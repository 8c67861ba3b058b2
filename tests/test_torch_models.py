"""The port's transformer models against the JAX package's, on the same
weights.

The reference's ``init_params`` draws each smoke config's weights; they
cross to the port as numpy arrays through `convert.model_from_jax_params`.
Inputs are made by numpy from a seed and go through both packages' layers,
MoE block and model entry points (`forward`, `prefill` with its cache,
`decode_step` with a scalar and a per-slot position). Every config here is
float32; tolerance rtol 1e-4 / atol 1e-5 (the sums run in another order
in the two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import get_smoke as jax_smoke
from repro.models import api as japi
from repro.models import layers as jl
from repro.models import moe as jmoe

from repro_torch import configs, convert
from repro_torch.models import api, layers

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ("smollm-135m", "yi-9b", "internvl2-1b", "qwen3-moe-30b-a3b")

_MODELS: dict = {}


def _pair(arch):
    """(reference cfg, reference params, port model) of ``arch``'s smoke
    config, built once per module."""
    if arch not in _MODELS:
        jcfg = jax_smoke(arch)
        params = japi.init_params(jcfg, jax.random.PRNGKey(0))
        model = convert.model_from_jax_params(
            configs.get_smoke(arch), jax.tree.map(np.asarray, params),
            device="cpu")
        _MODELS[arch] = (jcfg, params, model)
    return _MODELS[arch]


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# --- layers --------------------------------------------------------------------

def test_configs_copy_the_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        for mine, ref in ((configs.get(arch), jconfigs.get(arch)),
                          (configs.get_smoke(arch), jax_smoke(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref), arch
            assert mine.param_dtype == getattr(torch, mine.dtype)
            assert (mine.hd, mine.d_inner) == (ref.hd, ref.d_inner)


def test_rmsnorm():
    x, scale = _rand(0, 2, 5, 64), _rand(1, 64)
    want = jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)
    got = layers.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x), 1e-5)
    _close(got, want)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_rotates_halves(theta):
    x = _rand(2, 2, 5, 4, 16)
    pos = np.random.default_rng(3).integers(0, 300, (2, 5)).astype(np.int32)
    want = jl.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, want)


def _attn(arch="smollm-135m"):
    jcfg, params, model = _pair(arch)
    return jcfg, _layer0(params["layers"]["attn"]), model.layers[0].attn


def test_attention_without_cache():
    jcfg, p, attn = _attn()
    x = _rand(4, 2, 7, jcfg.d_model)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    want, _ = jl.attention(p, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got, cache = attn(torch.from_numpy(x), _rot(jcfg, pos.copy()))
    assert cache is None
    _close(got, want)


def _rot(jcfg, pos):
    return layers.rope_tables(torch.from_numpy(pos), jcfg.hd,
                              jcfg.rope_theta)


def _cache(jcfg, B, smax, seed):
    return {n: _rand(seed + i, B, smax, jcfg.n_kv_heads, jcfg.hd)
            for i, n in enumerate(("k", "v"))}


@pytest.mark.parametrize("S", [1, 3])
def test_attention_scalar_pos(S):
    jcfg, p, attn = _attn()
    x, cache, cp = _rand(5, 2, S, jcfg.d_model), _cache(jcfg, 2, 9, 6), 4
    pos = np.full((2, S), cp, dtype=np.int32)
    want, wcache = jl.attention(
        p, jcfg, jnp.asarray(x), jnp.asarray(pos),
        kv_cache={n: jnp.asarray(c) for n, c in cache.items()},
        cache_pos=cp)
    tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    got, new = attn(torch.from_numpy(x), _rot(jcfg, pos), kv_cache=tcache,
                    write=layers.cache_write(cp, 2, S, 9, "cpu"))
    assert new is tcache                  # written in place
    _close(got, want)
    for n in ("k", "v"):
        _close(new[n], wcache[n])


def test_attention_per_slot_pos_leaves_an_inactive_slot_unchanged():
    jcfg, p, attn = _attn()
    cp = np.array([2, -1, 8, 0], dtype=np.int32)
    x, cache = _rand(7, 4, 1, jcfg.d_model), _cache(jcfg, 4, 9, 8)
    want, wcache = jl.attention(
        p, jcfg, jnp.asarray(x), jnp.asarray(cp[:, None]),
        kv_cache={n: jnp.asarray(c) for n, c in cache.items()},
        cache_pos=jnp.asarray(cp))
    tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    got, new = attn(torch.from_numpy(x), _rot(jcfg, cp[:, None]),
                    kv_cache=tcache,
                    write=layers.cache_write(torch.from_numpy(cp), 4, 1, 9,
                                             "cpu"))
    assert np.isfinite(got.numpy()).all()
    _close(got, want)
    for n in ("k", "v"):
        _close(new[n], wcache[n])
        assert np.array_equal(new[n][1].numpy(), cache[n][1])   # bitwise
        for b in (0, 2, 3):      # every other row of an active slot too
            keep = np.arange(9) != cp[b]
            assert np.array_equal(new[n][b].numpy()[keep], cache[n][b][keep])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocks", [(4, 5), (16, 3), (13, 13)])
def test_flash_attention_at_small_blocks(causal, blocks):
    q, k, v = (_rand(10 + i, 2, 13, 4, 8) for i in range(3))
    bq, bk = blocks
    want = jl._flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, block_q=bq,
                               block_k=bk)
    got = layers._flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal,
                                  block_q=bq, block_k=bk)
    _close(got, want)


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-34b"],
                         ids=["gated", "gelu"])
def test_mlp(arch):
    jcfg, params, model = _pair(arch)
    mlp = model.layers[0].mlp
    assert (mlp.wg is not None) == jcfg.mlp_gated
    x = _rand(11, 2, 5, jcfg.d_model)
    want = jl.mlp(_layer0(params["layers"]["mlp"]), jnp.asarray(x))
    _close(mlp(torch.from_numpy(x)), want)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "granite-moe-3b-a800m"])
@pytest.mark.parametrize("shape", [(2, 6), (3, 1)], ids=["prefill", "decode"])
def test_moe_output_and_aux(arch, shape):
    jcfg, params, model = _pair(arch)
    x = _rand(12, *shape, jcfg.d_model)
    want, waux = jmoe.moe(_layer0(params["layers"]["moe"]), jcfg,
                          jnp.asarray(x))
    got, aux = model.layers[0].moe(torch.from_numpy(x))
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(waux), **TOL)


# --- the model's entry points --------------------------------------------------

def _batch(jcfg, B, S, seed):
    rng = np.random.default_rng(seed)
    batch = {"inputs": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    if jcfg.family == "vlm":
        batch["frontend"] = _rand(seed + 1, B, jcfg.n_frontend_tokens,
                                  jcfg.d_model)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward(arch):
    jcfg, params, model = _pair(arch)
    batch = _batch(jcfg, 2, 6, 20)
    want, waux = japi.forward(params, jcfg, _jax(batch))
    got, aux = model.forward(_torch(batch))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(waux), **TOL)
    hidden, _ = model.forward_hidden(_torch(batch))
    assert hidden.shape == (2, 6, jcfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_its_cache(arch):
    jcfg, params, model = _pair(arch)
    batch = _batch(jcfg, 2, 5, 21)
    want, wcache, wpos = japi.prefill(params, jcfg, _jax(batch), max_seq=24)
    got, cache, pos = model.prefill(_torch(batch), max_seq=24)
    assert pos == int(wpos)
    _close(got, want)
    for n in ("k", "v"):
        assert cache[n].shape == wcache[n].shape
        _close(cache[n], wcache[n])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per-slot"])
def test_decode_step(arch, per_slot):
    jcfg, params, model = _pair(arch)
    batch = _batch(jcfg, 3, 5, 22)
    _, jcache, S = japi.prefill(params, jcfg, _jax(batch), max_seq=24)
    S = int(S)
    pos = np.array([S, -1, S - 2], dtype=np.int32) if per_slot else S
    tok = np.random.default_rng(23).integers(0, jcfg.vocab, (3, 1)
                                             ).astype(np.int32)
    want, wnew = japi.decode_step(params, jcfg, jcache, jnp.asarray(tok),
                                  jnp.asarray(pos))
    cache = {n: torch.from_numpy(np.array(c)) for n, c in jcache.items()}
    got, new = model.decode_step(cache, torch.from_numpy(tok),
                                 torch.as_tensor(pos))
    _close(got, want)
    for n in ("k", "v"):
        _close(new[n], wnew[n])
    hidden, _ = model.decode_hidden(
        {n: torch.from_numpy(np.array(c)) for n, c in jcache.items()},
        torch.from_numpy(tok), torch.as_tensor(pos))
    _close(layers.lm_head(model.embed, hidden), want)


def test_make_decode_cache_and_insert_slot():
    jcfg, params, model = _pair("smollm-135m")
    pool = model.make_decode_cache(3, 10, dtype=torch.float32)
    assert pool["k"].shape == (jcfg.n_layers, 3, 10, jcfg.n_kv_heads,
                               jcfg.hd)
    pool["k"].fill_(7.0)
    pool["v"].fill_(7.0)
    _, req, _ = model.prefill(_torch(_batch(jcfg, 1, 4, 24)), max_seq=10)
    want = japi.cache_insert_slot(
        jcfg, {n: jnp.full(pool[n].shape, 7.0, jnp.float32) for n in pool},
        {n: jnp.asarray(r.numpy()) for n, r in req.items()}, 1)
    got = model.cache_insert_slot(pool, req, 1)
    assert got is pool
    for n in ("k", "v"):
        assert np.array_equal(got[n].numpy(), np.asarray(want[n]))


def test_param_count_matches_reference():
    for arch in ARCHS:
        _, params, model = _pair(arch)
        assert api.param_count(model) == japi.param_count(params)


def test_convert_refuses_a_missing_or_misshapen_weight():
    jcfg, params, _ = _pair("smollm-135m")
    cfg = configs.get_smoke("smollm-135m")
    p = jax.tree.map(np.asarray, params)
    untied = {**p, "embed": {**p["embed"],
                             "head": np.zeros((jcfg.d_model, jcfg.vocab),
                                              np.float32)}}
    with pytest.raises(RuntimeError, match="head"):
        convert.model_from_jax_params(cfg, untied, device="cpu")
    with pytest.raises(ValueError, match="stacked layers"):
        convert.model_from_jax_params(cfg.with_(n_layers=3), p, device="cpu")


def test_convert_carries_an_untied_head():
    jcfg = jax_smoke("yi-9b")
    assert not jcfg.tie_embeddings
    _, params, model = _pair("yi-9b")
    assert np.array_equal(model.embed.head.numpy(),
                          np.asarray(params["embed"]["head"]))


def test_cuda_model_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        api.build_model(configs.get_smoke("smollm-135m"),
                        generator=torch.Generator().manual_seed(0))


def test_build_model_draws_the_reference_scales():
    cfg = configs.get("smollm-135m").with_(n_layers=1, vocab=4096)
    model = api.build_model(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert abs(float(model.embed.tok.std()) - 0.02) < 1e-3
    assert abs(float(model.layers[0].attn.wq.std())
               - 1 / np.sqrt(cfg.d_model)) < 2e-3
    assert abs(float(model.layers[0].mlp.wo.std())
               - 1 / np.sqrt(cfg.d_ff)) < 2e-3
    assert not any(p.requires_grad for p in model.parameters())
