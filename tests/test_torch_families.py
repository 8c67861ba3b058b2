"""The port's ssm, hybrid and encdec models and their serving against the
JAX package's, on the same weights.

Smoke configs: mamba2-130m (2 SSM layers, attention-free), zamba2-7b (7
layers at ``attn_every=3``: two groups, each followed by the shared block,
and a tail of one) and seamless-m4t-large-v2 (2 encoder + 2 decoder layers,
12 frames). The reference's ``init_params`` draws the weights once per
module; they cross as numpy arrays through `convert.model_from_jax_params`.
Inputs are made by numpy from a seed. Compared: the attention options these
families use (cross-attention ``kv=``, the non-causal encoder, both also
through the blocked path), `forward`, `prefill` with every cache leaf,
`decode_step` with a scalar and a per-slot position (an inactive slot keeps
the bits of every cache line), `make_decode_cache` + `cache_insert_slot`,
`param_count`; then the port's `Engine` token streams against the
reference `Engine`'s, dense head and compressed head, pooled against
sequential, and the launcher. Float32; tolerance rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_smoke as jax_smoke
from repro.models import api as japi
from repro.models import layers as jl
from repro.serving.engine import Engine as JEngine

from repro_torch import configs, convert, obs
from repro_torch.launch import serve
from repro_torch.models import api, layers
from repro_torch.serving.engine import Engine

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ("mamba2-130m", "zamba2-7b", "seamless-m4t-large-v2")

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


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _leaves(jtree, ttree):
    """[(path, reference leaf, port leaf)] over the reference's tree, which
    the port's must hold leaf for leaf."""
    out = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        t = ttree
        for k in path:
            t = t[k.key]
        out.append((jax.tree_util.keystr(path), np.asarray(leaf), t))
    n_port = len(jax.tree_util.tree_leaves(
        jax.tree.map(lambda t: 0, ttree)))
    assert n_port == len(out)
    return out


def _to_torch(jtree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jtree)


# --- the attention options ---------------------------------------------------

def _seamless_attn(name):
    jcfg, params, model = _pair("seamless-m4t-large-v2")
    p = jax.tree.map(lambda a: a[0], params["dec_layers"][name])
    return jcfg, p, getattr(model.dec_layers[0], name)


@pytest.fixture(params=["dense", "blocked"])
def attn_path(request, monkeypatch):
    """Both packages' attention through its dense path, or (``blocked``)
    through `_flash_attention` at blocks of 4 queries and 5 keys."""
    if request.param == "blocked":
        monkeypatch.setattr(jl, "_FLASH_THRESHOLD", 4)
        monkeypatch.setattr(jl, "_FLASH_BLOCK_Q", 4)
        monkeypatch.setattr(jl, "_FLASH_BLOCK_K", 5)
        monkeypatch.setattr(layers, "FLASH_THRESHOLD", 4)
        monkeypatch.setattr(layers, "FLASH_BLOCK_Q", 4)
        monkeypatch.setattr(layers, "FLASH_BLOCK_K", 5)
    return request.param


def test_cross_attention_takes_no_rope_and_no_mask(attn_path):
    jcfg, p, attn = _seamless_attn("cross_attn")
    x, mem = _rand(30, 2, 7, jcfg.d_model), _rand(31, 2, 11, jcfg.d_model)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    want, _ = jl.attention(p, jcfg, jnp.asarray(x), jnp.asarray(pos),
                           causal=False, kv=jnp.asarray(mem))
    got, cache = attn(torch.from_numpy(x), None, kv=torch.from_numpy(mem))
    assert cache is None
    _close(got, want)
    # causal=True is ignored with kv=, as in the reference
    got_c, _ = attn(torch.from_numpy(x), None, causal=True,
                    kv=torch.from_numpy(mem))
    _close(got_c, want)


def test_non_causal_self_attention(attn_path):
    jcfg, params, model = _pair("seamless-m4t-large-v2")
    p = jax.tree.map(lambda a: a[0], params["enc_layers"]["attn"])
    x = _rand(32, 2, 9, jcfg.d_model)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    rot = layers.rope_tables(torch.from_numpy(pos.copy()), jcfg.hd,
                             jcfg.rope_theta)
    attn = model.enc_layers[0].attn
    for causal in (False, True):
        want, _ = jl.attention(p, jcfg, jnp.asarray(x), jnp.asarray(pos),
                               causal=causal)
        got, _ = attn(torch.from_numpy(x), rot, causal=causal)
        _close(got, want)


# --- the model's entry points ------------------------------------------------

def _batch(jcfg, B, S, seed):
    rng = np.random.default_rng(seed)
    batch = {"inputs": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    if jcfg.family == "encdec":
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
    batch = _batch(jcfg, 2, 13, 20)
    want, waux = japi.forward(params, jcfg, _jax(batch))
    got, aux = model.forward(_torch(batch))
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want)
    assert float(aux) == float(waux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_every_cache_leaf(arch):
    jcfg, params, model = _pair(arch)
    batch = _batch(jcfg, 2, 11, 21)
    want, wcache, wpos = japi.prefill(params, jcfg, _jax(batch), max_seq=24)
    got, cache, pos = model.prefill(_torch(batch), max_seq=24)
    assert pos == int(wpos)
    _close(got, want)
    for path, w, t in _leaves(wcache, cache):
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).split(".")[-1] == str(w.dtype), path
        _close(t, w)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per-slot"])
def test_decode_step(arch, per_slot):
    jcfg, params, model = _pair(arch)
    batch = _batch(jcfg, 3, 9, 22)
    _, jcache, S = japi.prefill(params, jcfg, _jax(batch), max_seq=24)
    S = int(S)
    pos = np.array([S, -1, S - 2], dtype=np.int32) if per_slot else S
    tok = np.random.default_rng(23).integers(0, jcfg.vocab, (3, 1)
                                             ).astype(np.int32)
    want, wnew = japi.decode_step(params, jcfg, jcache, jnp.asarray(tok),
                                  jnp.asarray(pos))
    cache = _to_torch(jcache)
    got, new = model.decode_step(cache, torch.from_numpy(tok),
                                 torch.as_tensor(pos))
    assert new is cache                                # written in place
    _close(got, want)
    for path, w, t in _leaves(wnew, new):
        _close(t, w)
    if per_slot:              # slot 1 is inactive: every line keeps its bits
        for path, w, t in _leaves(jcache, new):
            axis = 0 if path in ("['x0']", "['memory']") else 1
            assert np.array_equal(t.numpy().take(1, axis),
                                  w.take(1, axis)), path
    hidden, _ = model.decode_hidden(_to_torch(jcache), torch.from_numpy(tok),
                                    torch.as_tensor(pos))
    _close(layers.lm_head(model.embed, hidden), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_decode_cache_and_insert_slot(arch):
    jcfg, params, model = _pair(arch)
    pool = model.make_decode_cache(3, 10, dtype=torch.float32)
    jpool = japi.make_decode_cache(jcfg, 3, 10, dtype=jnp.float32)
    for path, w, t in _leaves(jpool, pool):
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).split(".")[-1] == str(w.dtype), path
        assert not t.any(), path
        t.fill_(7.0)
    _, req, _ = model.prefill(_torch(_batch(jcfg, 1, 4, 24)), max_seq=10)
    want = japi.cache_insert_slot(
        jcfg, jax.tree.map(lambda a: jnp.full(a.shape, 7.0, a.dtype), jpool),
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), req), 1)
    got = model.cache_insert_slot(pool, req, 1)
    assert got is pool
    for path, w, t in _leaves(want, got):
        assert np.array_equal(t.numpy(), w), path


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    _, params, model = _pair(arch)
    assert api.param_count(model) == japi.param_count(params)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_build_model_builds_every_smoke_config(arch):
    cfg = configs.get_smoke(arch)
    model = api.build_model(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert model.cfg == cfg
    assert not any(p.requires_grad for p in model.parameters())
    jparams = jax.eval_shape(lambda: japi.init_params(
        jax_smoke(arch), jax.random.PRNGKey(0)))
    assert api.param_count(model) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(jparams))


def test_convert_refuses_a_missing_or_misshapen_weight():
    _, params, _ = _pair("zamba2-7b")
    cfg = configs.get_smoke("zamba2-7b")
    p = jax.tree.map(np.asarray, params)
    no_shared = {k: v for k, v in p.items() if k != "shared_attn"}
    with pytest.raises(RuntimeError, match="shared_attn"):
        convert.model_from_jax_params(cfg, no_shared, device="cpu")
    with pytest.raises(ValueError, match="stacked layers"):
        convert.model_from_jax_params(cfg.with_(n_layers=6), p, device="cpu")
    _, sparams, _ = _pair("seamless-m4t-large-v2")
    scfg = configs.get_smoke("seamless-m4t-large-v2")
    with pytest.raises(ValueError, match="enc_layers.*config has 3"):
        convert.model_from_jax_params(
            scfg.with_(n_enc_layers=3), jax.tree.map(np.asarray, sparams),
            device="cpu")


def test_convert_keeps_the_float32_ssm_leaves():
    _, params, model = _pair("mamba2-130m")
    ssm = model.layers[1].ssm
    for n in ("A_log", "D", "dt_bias"):
        assert getattr(ssm, n).dtype == torch.float32
        assert np.array_equal(getattr(ssm, n).numpy(),
                              np.asarray(params["layers"]["ssm"][n][1]))


# --- serving -----------------------------------------------------------------

MIXED_LENS = (1, 3, 6, 3, 2)         # > slots=2 => mid-flight refills
MAX_NEW = 4
_HEADS: dict = {}


def _head(arch):
    if arch not in _HEADS:
        _HEADS[arch] = Engine.compress_lm_head(
            _pair(arch)[2], sparsity=0.6, value_bits=5, lane_width=32)
    return _HEADS[arch]


def _prompts(vocab, lens=MIXED_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n) for n in lens]


def _serve(eng, prompts, max_new=MAX_NEW):
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run_until_drained()
    return [list(r.out) for r in reqs]


def _port_engine(model, **kw):
    return Engine(model, device="cpu", metrics=obs.MetricsRegistry(), **kw)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_head", [False, True],
                         ids=["dense", "compressed"])
def test_engine_streams_equal_the_reference(arch, use_head):
    """The compressed head is held against the reference's DENSE engine
    whose head is the compressed head's decoded pruned matrix."""
    jcfg, params, model = _pair(arch)
    head = _head(arch) if use_head else None
    ref_params = params
    if use_head:
        ref_params = {**params, "embed": {
            "tok": params["embed"]["tok"],
            "head": jnp.asarray(head.dense_weight.numpy().T)}}
    prompts = _prompts(jcfg.vocab)
    want = _serve(JEngine(jcfg, ref_params, slots=2, max_seq=16,
                          metrics=jobs.MetricsRegistry()), prompts)
    got = _serve(_port_engine(model, slots=2, max_seq=16, sparse_head=head),
                 prompts)
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_head", [False, True],
                         ids=["dense", "compressed"])
def test_pooled_equals_sequential(arch, use_head):
    jcfg, _, model = _pair(arch)
    head = _head(arch) if use_head else None
    prompts = _prompts(jcfg.vocab, seed=1)
    seq = _port_engine(model, slots=1, max_seq=16, sparse_head=head)
    want = [_serve(seq, [p])[0] for p in prompts]
    got = _serve(_port_engine(model, slots=3, max_seq=16, sparse_head=head),
                 prompts)
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_the_cpu(arch, capsys):
    reqs = serve.main(["--arch", arch, "--smoke", "--requests", "3",
                       "--prompt-len", "5", "--max-new-tokens", "3",
                       "--max-seq", "16", "--sparse-head", "--device",
                       "cpu"])
    assert all(r.done and len(r.out) == 3 for r in reqs)
    out = capsys.readouterr().out
    assert "LM head:" in out and "served 3/3 requests" in out
