"""The port's bfloat16 path against the JAX package's, on the same weights.

The smoke configs of smollm-135m, qwen3-moe-30b-a3b, mamba2-130m and
zamba2-7b set to ``dtype="bfloat16"``: the reference's ``init_params``
draws the weights, `convert.model_from_jax_params` carries them across.
`forward`, `prefill` and `decode_step` (scalar and per-slot position) go
through both packages on the same numpy inputs.

The reference runs op by op (``jax.disable_jit()``): each bfloat16 rounding
then happens where its code writes it, as in the port's eager torch. A
compiled reference (``jit``, or ``lax.scan``'s compiled body) fuses
elementwise ops and skips some of those roundings, and so differs from its
own op-by-op run by 0.3-3.2% of its largest |logit| on these configs (3.2%
on zamba2, where a near tie of mamba2's forward also flips an argmax).
Against the op-by-op run the port's logits are mostly within 2e-7 of the
largest |logit|; where a float32 result differs in its last bit between
the two frameworks (an RMSNorm's mean or rsqrt) and that flips one
bfloat16 rounding, the difference grows to about 1% (zamba2's forward and
prefill: 0.9% and 0.8%).
Criterion: the largest absolute difference of the logits is at most 2%
of the reference's largest |logit|, the argmax agrees at every position,
and at least half of the positions agree to within 1e-5 of that largest
|logit| (a flipped rounding moves only the positions downstream of it).
The second limit is what tells a port that keeps the bfloat16 roundings
from one that skips them: the port computing in float32 on the same
bfloat16 weights stays within the 2% on most of these readings (0.6-1.35%
of the largest |logit|; 2.1-2.7% only on zamba2's forward and prefill),
but brings no position of any reading within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import api as japi

from repro_torch import configs, convert

ARCHS = ("smollm-135m", "qwen3-moe-30b-a3b", "mamba2-130m", "zamba2-7b")
REL = 2e-2          # of the reference's largest |logit|
CLOSE = 1e-5        # ... met by at least half of the positions

_MODELS: dict = {}


def _pair(arch):
    """(reference cfg, reference params, port model) of ``arch``'s smoke
    config in bfloat16, built once per module."""
    if arch not in _MODELS:
        jcfg = jax_smoke(arch).with_(dtype="bfloat16")
        params = japi.init_params(jcfg, jax.random.PRNGKey(0))
        model = convert.model_from_jax_params(
            configs.get_smoke(arch).with_(dtype="bfloat16"),
            jax.tree.map(np.asarray, params), device="cpu")
        _MODELS[arch] = (jcfg, params, model)
    return _MODELS[arch]


def _check(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.float32
    want = np.asarray(want, dtype=np.float32)
    got = got.numpy()
    assert got.shape == want.shape
    top = np.abs(want).max()
    per_pos = np.abs(got - want).max(-1).ravel()
    assert per_pos.max() <= REL * top, (per_pos.max(), top)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    close = int((per_pos <= CLOSE * top).sum())
    assert 2 * close >= per_pos.size, (close, per_pos / top)


def _torch(a) -> torch.Tensor:
    """A reference array as a torch tensor of the same dtype (bfloat16
    through float32, exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _batch(jcfg, B, S, seed):
    return {"inputs": np.random.default_rng(seed).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill(arch):
    jcfg, params, model = _pair(arch)
    batch = _batch(jcfg, 2, 13, 40)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with jax.disable_jit():
        want, _ = japi.forward(params, jcfg, jb)
        wlast, _, _ = japi.prefill(params, jcfg, jb, max_seq=20)
    got, _ = model.forward(tb)
    _check(got, want)
    last, _, _ = model.prefill(tb, max_seq=20)
    _check(last, wlast)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "per-slot"])
def test_decode_step(arch, per_slot):
    jcfg, params, model = _pair(arch)
    jb = {k: jnp.asarray(v) for k, v in _batch(jcfg, 3, 9, 41).items()}
    pos = np.array([9, -1, 7], dtype=np.int32) if per_slot else 9
    tok = np.random.default_rng(42).integers(0, jcfg.vocab, (3, 1)
                                             ).astype(np.int32)
    with jax.disable_jit():
        _, jcache, _ = japi.prefill(params, jcfg, jb, max_seq=16)
        want, _ = japi.decode_step(params, jcfg, jcache, jnp.asarray(tok),
                                   jnp.asarray(pos))
    got, _ = model.decode_step(jax.tree.map(_torch, jcache),
                               torch.from_numpy(tok), torch.as_tensor(pos))
    _check(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_criterion_rejects_float32_on_the_same_weights(arch):
    """The control: the port in float32 on the bfloat16 weights (cast up,
    exactly) skips every bfloat16 rounding. The criterion refuses its
    forward, and no position of it comes within `CLOSE`."""
    jcfg, params, _ = _pair(arch)
    f32 = convert.model_from_jax_params(
        configs.get_smoke(arch).with_(dtype="float32"),
        jax.tree.map(lambda a: np.asarray(a, dtype=np.float32), params),
        device="cpu")
    batch = _batch(jcfg, 2, 13, 40)
    with jax.disable_jit():
        want, _ = japi.forward(params, jcfg,
                               {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = f32.forward({k: torch.from_numpy(v) for k, v in batch.items()})
    with pytest.raises(AssertionError):
        _check(got, want)
    want = np.asarray(want, dtype=np.float32)
    per_pos = np.abs(got.numpy() - want).max(-1)
    assert (per_pos > CLOSE * np.abs(want).max()).all()
