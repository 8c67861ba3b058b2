"""The port's training pieces against the JAX package's: the token
pipeline, gradient compression, the optimizers, the loss and its
gradients.

- `SyntheticTokens` batches and `compress` (bf16 with error feedback) are
  bitwise the reference's.
- AdamW and Adafactor run on the reference's stacked tree of a smoke
  SmolLM and a smoke zamba2 (which has a ``shared_attn`` block), from
  identical numpy gradients: every updated leaf within rtol 1e-6 / atol
  1e-7 of the reference (float32; the two frameworks sum Adafactor's means
  in another order). The optimizers are held apart from the gradients
  because AdamW's first update is ``g / (|g| + eps)``: a gradient near 0
  whose sign differs by float error moves its weight by 2 lr.
- `api.loss_fn` on one smoke config per family (dense, moe, vlm, ssm,
  hybrid, encdec; float32, B = 2, S = 16, a mask with zeros) within rtol
  1e-5 of the reference's, and each leaf of the gradients
  (`convert.jax_tree_from_model(grads=True)`) within rtol 1e-4 and atol
  1e-5 x the leaf's largest |g| of ``jax.grad`` (the sums run in another
  order in the two frameworks).
- ``remat=True`` (each layer checkpointed) gives bitwise the gradients of
  ``remat=False``.

The reference's weights cross through `convert.model_from_jax_params`; its
``value_and_grad`` is compiled once per family for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import api as japi
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim.grad_compress import compress as jcompress

from repro_torch import configs, convert
from repro_torch.data.pipeline import PipelineConfig, SyntheticTokens
from repro_torch.models import api
from repro_torch.optim import make_optimizer
from repro_torch.optim.adamw import f32_copy
from repro_torch.optim.grad_compress import compress, init_error_state

OPT_TOL = dict(rtol=1e-6, atol=1e-7)
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5       # atol: of the leaf's largest |g|
FAMILIES = {"dense": "smollm-135m", "moe": "granite-moe-3b-a800m",
            "vlm": "internvl2-1b", "ssm": "mamba2-130m",
            "hybrid": "zamba2-7b", "encdec": "seamless-m4t-large-v2"}
B, S = 2, 16


def _flat(tree: dict, prefix: str = "") -> dict:
    """A nested dict's leaves by dotted name, in JAX's leaf order (each
    level's keys sorted)."""
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


_PARAMS: dict = {}


def _params(arch: str) -> tuple:
    """(reference cfg, reference params, port cfg, a fresh port model on
    those weights); the reference's weights are drawn once per module."""
    if arch not in _PARAMS:
        jcfg = jax_smoke(arch)
        _PARAMS[arch] = (jcfg, japi.init_params(jcfg, jax.random.PRNGKey(0)))
    jcfg, params = _PARAMS[arch]
    cfg = configs.get_smoke(arch)
    model = convert.model_from_jax_params(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, cfg, model


# --- the pipeline and gradient compression ---------------------------------

@pytest.mark.parametrize("step", [0, 7])
def test_pipeline_batches_are_bitwise_the_reference(step):
    kw = dict(vocab=300, seq_len=96, global_batch=8, seed=5,
              frontend_tokens=6, d_model=32)
    mine = SyntheticTokens(PipelineConfig(**kw))
    ref = JSyntheticTokens(JPipelineConfig(**kw))
    for shard in range(4):
        got = mine.batch(step, shard=shard, num_shards=4)
        want = ref.batch(step, shard=shard, num_shards=4)
        assert sorted(got) == sorted(want) == ["frontend", "inputs", "mask",
                                               "targets"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), (shard, k)


def test_compress_is_bitwise_the_reference_over_five_steps():
    rng = np.random.default_rng(0)
    shapes = {"w": (37, 5), "b": (11,)}
    err = init_error_state({k: torch.zeros(s) for k, s in shapes.items()})
    jerr = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    for _ in range(5):
        g = {k: (rng.standard_normal(s) * 1e-3).astype(np.float32)
             for k, s in shapes.items()}
        comp, err = compress({k: torch.from_numpy(v) for k, v in g.items()},
                             err)
        jcomp, jerr = jcompress({k: jnp.asarray(v) for k, v in g.items()},
                                jerr)
        for k in shapes:
            assert comp[k].dtype == torch.bfloat16
            assert np.array_equal(comp[k].float().numpy(),
                                  np.asarray(jcomp[k], np.float32))
            assert np.array_equal(err[k].numpy(), np.asarray(jerr[k]))


def test_error_feedback_preserves_sum():
    g_true = {"w": torch.from_numpy(
        (np.random.default_rng(0).standard_normal(1000) * 1e-3
         ).astype(np.float32))}
    err = init_error_state(g_true)
    total = np.zeros(1000)
    for _ in range(50):
        comp, err = compress(g_true, err)
        total += comp["w"].double().numpy()
    np.testing.assert_allclose(total / 50, g_true["w"].numpy(), rtol=1e-2,
                               atol=1e-6)


# --- the optimizers ---------------------------------------------------------

OPTIMIZERS = [("adamw", {}), ("adafactor", {}),
              ("adafactor", {"master": False})]


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-7b"])
def test_optimizer_on_identical_gradients(arch, name, kw):
    """Three updates of the reference's stacked tree from the same numpy
    gradients: every leaf within `OPT_TOL`; Adafactor's second moments
    have the reference's (factored) shapes and values."""
    jcfg, params, cfg, model = _params(arch)
    leaves = api.reference_leaves(model, cfg)
    assert list(leaves) == list(_flat(params))       # the reference's order
    opt, jopt = make_optimizer(name, lr=1e-2, **kw), \
        jmake_optimizer(name, lr=1e-2, **kw)
    state, jstate = opt.init(leaves), jopt.init(params)
    jupdate = jax.jit(jopt.update)
    rng = np.random.default_rng(3)
    for _ in range(3):
        g = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-2
                                    ).astype(np.float32), params)
        flat = _flat(g)
        grads = {k: [torch.from_numpy(flat[k][i].copy())
                     for i in range(len(v))]
                 if isinstance(v, list) else torch.from_numpy(flat[k].copy())
                 for k, v in leaves.items()}
        state = opt.update(grads, state, leaves)
        params, jstate = jupdate(g, jstate, params)
    got, want = _flat(convert.jax_tree_from_model(cfg, model)), \
        _flat(params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **OPT_TOL, err_msg=k)
    assert int(state["step"]) == int(jstate["step"]) == 3
    if name == "adafactor":
        assert len(state["v"]) == len(jstate["v"]) == len(leaves)
        for (k, p), v, jv in zip(leaves.items(), state["v"], jstate["v"]):
            assert sorted(v) == sorted(jv), k
            for n in jv:
                assert tuple(v[n].shape) == jv[n].shape, (k, n)
                np.testing.assert_allclose(v[n].numpy(), np.asarray(jv[n]),
                                           rtol=1e-5, atol=0, err_msg=k)
        scale = list(leaves).index("layers.ln.scale" if arch == "zamba2-7b"
                                   else "layers.ln1.scale")
        d = cfg.d_model
        assert state["v"][scale]["vr"].shape == (cfg.n_layers,)
        assert state["v"][scale]["vc"].shape == (d,)     # shared by layers


def test_adamw_masters_never_alias_a_float32_parameter():
    _, _, cfg, model = _params("smollm-135m")
    leaves = api.reference_leaves(model, cfg)
    state = make_optimizer("adamw").init(leaves)
    ps = [t for v in leaves.values() for t in
          (v if isinstance(v, list) else [v])]
    assert all(p.dtype == torch.float32 for p in ps)
    # one master a reference leaf, a stacked leaf's stacked
    assert len(state["master"]) == len(leaves)
    for w, v in zip(state["master"], leaves.values()):
        ts = v if isinstance(v, list) else [v]
        assert torch.equal(w, torch.stack(ts) if isinstance(v, list) else v)
        assert all(w.data_ptr() != p.data_ptr() for p in ts)
    assert f32_copy(ps[0]).data_ptr() != ps[0].data_ptr()


@pytest.mark.parametrize("name,kw", OPTIMIZERS)
def test_reduces_quadratic(name, kw):
    opt = make_optimizer(name, lr=0.1, **kw)
    w = torch.tensor([3.0, -2.0, 1.0], requires_grad=True)
    params = {"w": w}
    state = opt.init(params)
    l0 = float(torch.sum(w.detach() ** 2))
    for _ in range(60):
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        state = opt.update({"w": g}, state, params)
    assert float(torch.sum(w.detach() ** 2)) < 0.05 * l0


def test_adafactor_state_is_factored():
    opt = make_optimizer("adafactor", lr=0.1, master=False)
    state = opt.init({"w": torch.zeros((64, 32))})
    assert sum(t.numel() for v in state["v"] for t in v.values()) == 64 + 32


# --- the loss and its gradients ---------------------------------------------

_REF: dict = {}


def _batch(jcfg) -> dict:
    fe = jcfg.n_frontend_tokens if jcfg.family in ("vlm", "encdec") else 0
    batch = SyntheticTokens(PipelineConfig(
        vocab=jcfg.vocab, seq_len=S, global_batch=B, seed=11,
        frontend_tokens=fe, d_model=jcfg.d_model)).batch(0)
    batch["mask"][:, -3:] = 0.0
    batch["mask"][1, :2] = 0.0
    return batch


def _reference(family: str) -> tuple:
    """(reference cfg, params, batch, loss, metrics, grads) of ``family``'s
    smoke config, its ``value_and_grad`` compiled once for the module."""
    if family not in _REF:
        arch = FAMILIES[family]
        jcfg = jax_smoke(arch)
        params = japi.init_params(jcfg, jax.random.PRNGKey(0))
        batch = _batch(jcfg)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b: japi.loss_fn(p, jcfg, b), has_aux=True))(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
        _REF[family] = (jcfg, jax.tree.map(np.asarray, params), batch,
                        float(loss), jax.tree.map(float, metrics),
                        _flat(grads))
    return _REF[family]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_gradients_match_the_reference(family):
    jcfg, params, batch, jloss, jmetrics, jgrads = _reference(family)
    cfg = configs.get_smoke(FAMILIES[family])
    assert cfg.family == family and cfg.dtype == "float32"
    model = convert.model_from_jax_params(cfg, params, device="cpu")
    model.requires_grad_(True)
    loss, metrics = api.loss_fn(model, cfg, batch)
    assert abs(float(loss.detach()) - jloss) <= LOSS_RTOL * abs(jloss)
    for k in ("nll", "aux", "tokens"):
        assert abs(float(metrics[k].detach()) - jmetrics[k]) <= \
            LOSS_RTOL * abs(jmetrics[k]) + 1e-7, k
    assert float(metrics["tokens"]) == B * S - 2 * 3 - 2
    loss.backward()
    got = _flat(convert.jax_tree_from_model(cfg, model, grads=True))
    assert sorted(got) == sorted(jgrads)
    for k, want in jgrads.items():
        top = float(np.abs(want).max())
        assert top > 0, k
        np.testing.assert_allclose(got[k], want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * top, err_msg=k)


def test_loss_mask_defaults_to_ones():
    _, _, cfg, model = _params("smollm-135m")
    batch = _batch(cfg)
    full = {k: v for k, v in batch.items() if k != "mask"}
    ones = {**full, "mask": np.ones_like(batch["mask"])}
    with torch.no_grad():
        a, ma = api.loss_fn(model, cfg, full)
        b, _ = api.loss_fn(model, cfg, ones)
    assert torch.equal(a, b) and float(ma["tokens"]) == B * S


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_gives_bitwise_the_same_gradients(family, monkeypatch):
    """``remat=True`` checkpoints each layer (counted here) and gives the
    gradients of ``remat=False`` bit for bit."""
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    grads = []
    for remat in (False, True):
        cfg = configs.get_smoke(FAMILIES[family]).with_(remat=remat)
        model = api.build_model(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(4))
        model.requires_grad_(True)
        loss, _ = api.loss_fn(model, cfg, _batch(cfg))
        loss.backward()
        grads.append(_flat(convert.jax_tree_from_model(cfg, model,
                                                       grads=True)))
    n = {"encdec": cfg.n_enc_layers + cfg.n_dec_layers}.get(family,
                                                            cfg.n_layers)
    assert len(calls) == n
    for k in grads[0]:
        assert np.array_equal(grads[0][k], grads[1][k]), k
    with torch.no_grad():                       # no grad: a plain call
        api.loss_fn(model, cfg, _batch(cfg))
    assert len(calls) == n


def test_reference_leaves_group_the_stacked_layers():
    _, params, cfg, model = _params("zamba2-7b")
    leaves = api.reference_leaves(model, cfg)
    flat = _flat(params)
    assert list(leaves) == list(flat)
    for k, v in leaves.items():
        if k.startswith("layers."):
            assert isinstance(v, list) and len(v) == cfg.n_layers
            assert all(t.shape == flat[k].shape[1:] for t in v)
        else:
            assert torch.is_tensor(v) and v.shape == flat[k].shape
    assert "shared_attn.in_proj" in leaves
    assert leaves["layers.ssm.A_log"][3] is model.layers[3].ssm.A_log
