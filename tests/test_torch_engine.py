"""The port's serving engine against the JAX package's, and the scheduler's
own checks on the port.

SmolLM-135M's smoke config at vocab 64: the reference's ``init_params``
draws the weights, `convert.model_from_jax_params` carries them across.
The same requests (numpy prompts from a seed, the prompt lengths of
tests/test_engine_scheduler.py) go through the reference `Engine` and the
port's, which must give the same token streams: with a dense head,
greedy and seeded-sampled; and with the port's compressed head against the
reference's DENSE engine whose head is the compressed head's decoded
pruned matrix (which keeps interpret-mode Pallas out of this file). Then
copies of the scheduler's checks run on the port alone: pooled decode
equals sequential, mid-flight refills, admission control, queue limit,
metric names, sampling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import get_smoke as jax_smoke
from repro.models import api as japi
from repro.serving.engine import Engine as JEngine

from repro_torch import configs, convert, obs
from repro_torch.launch import serve
from repro_torch.serving.engine import AdmissionError, Engine, QueueFullError

MIXED_LENS = (1, 3, 7, 12, 5, 2)     # > slots=4 => mid-flight refills
MAX_NEW = 5

_SETUPS: dict = {}


def _setup(vocab=64, seed=0):
    """(reference cfg, reference params, port model, port compressed
    head), built once per (vocab, seed)."""
    if (vocab, seed) not in _SETUPS:
        jcfg = jax_smoke("smollm-135m").with_(vocab=vocab)
        params = japi.init_params(jcfg, jax.random.PRNGKey(seed))
        model = convert.model_from_jax_params(
            configs.get_smoke("smollm-135m").with_(vocab=vocab),
            jax.tree.map(np.asarray, params), device="cpu")
        head = Engine.compress_lm_head(model, sparsity=0.6, value_bits=5,
                                       lane_width=32)
        _SETUPS[vocab, seed] = (jcfg, params, model, head)
    return _SETUPS[vocab, seed]


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n) for n in lens]


def _engine(model, **kw):
    kw.setdefault("metrics", obs.MetricsRegistry())
    return Engine(model, device="cpu", **kw)


def _serve(eng, prompts, max_new=MAX_NEW):
    reqs = [eng.submit(p, max_new) for p in prompts]
    eng.run_until_drained()
    return [list(r.out) for r in reqs]


# --- against the reference engine ------------------------------------------------

SAMPLING = {"greedy": dict(greedy=True),
            "sampled": dict(greedy=False, temperature=0.8, top_k=8,
                            sample_seed=11)}


@pytest.mark.parametrize("mode", list(SAMPLING))
def test_dense_head_streams_equal_the_reference(mode):
    jcfg, params, model, _ = _setup()
    prompts = _prompts(64, MIXED_LENS)
    want = _serve(JEngine(jcfg, params, slots=4, max_seq=32,
                          metrics=jobs.MetricsRegistry(), **SAMPLING[mode]),
                  prompts)
    got = _serve(_engine(model, slots=4, max_seq=32, **SAMPLING[mode]),
                 prompts)
    assert got == want


def test_compressed_head_streams_equal_the_reference_on_its_decoded_head():
    jcfg, params, model, head = _setup()
    decoded = head.dense_weight.numpy().T                  # (d, vocab)
    ref_params = {**params, "embed": {"tok": params["embed"]["tok"],
                                      "head": jnp.asarray(decoded)}}
    prompts = _prompts(64, MIXED_LENS)
    want = _serve(JEngine(jcfg, ref_params, slots=4, max_seq=32,
                          metrics=jobs.MetricsRegistry()), prompts)
    got = _serve(_engine(model, slots=4, max_seq=32, sparse_head=head),
                 prompts)
    assert got == want


def test_compressed_logits_match_the_decoded_head():
    _, _, model, head = _setup()
    eng = _engine(model, slots=4, max_seq=32, sparse_head=head)
    seen = []
    apply = head.apply

    def recording(x, **kw):
        seen.append((x.clone(), apply(x, **kw)))
        return seen[-1][1]
    head.apply = recording
    try:
        _serve(eng, _prompts(64, MIXED_LENS))
    finally:
        del head.apply
    assert len(seen) == eng.metrics.counter("engine.steps_total").value
    for x, y in seen:
        assert x.shape == (4, 1, model.cfg.d_model)
        assert np.isfinite(y.numpy()).all()       # inactive slots too
        np.testing.assert_allclose(
            y.numpy(), head.apply_dense_reference(x).numpy(),
            rtol=1e-4, atol=1e-5)


# --- the scheduler's checks on the port --------------------------------------------

def _sequential_outputs(model, prompts, head=None, max_new=MAX_NEW):
    """Ground truth: each request alone in a slots=1 engine (the same
    engine, so a slot's reset on refill is exercised too)."""
    eng = _engine(model, slots=1, max_seq=32, sparse_head=head)
    out = {}
    for p in prompts:
        r = eng.submit(p, max_new)
        eng.run_until_drained()
        out[r.rid] = list(r.out)
    return out


@pytest.mark.parametrize("use_head", [False, True],
                         ids=["dense", "compressed"])
def test_pooled_equals_sequential(use_head):
    _, _, model, head = _setup()
    head = head if use_head else None
    prompts = _prompts(64, MIXED_LENS)
    want = _sequential_outputs(model, prompts, head=head)
    eng = _engine(model, slots=4, max_seq=32, sparse_head=head)
    reqs = [eng.submit(p, MAX_NEW) for p in prompts]
    done = eng.run_until_drained()
    assert sorted(r.rid for r in done) == sorted(r.rid for r in reqs)
    for r in reqs:
        assert list(r.out) == want[r.rid], (
            f"rid={r.rid} prompt_len={len(r.prompt)}: pooled decode "
            f"diverged from the solo run")


def test_mid_flight_refill_does_not_corrupt_neighbor():
    _, _, model, _ = _setup()
    prompts = _prompts(64, (9,), seed=3)
    want = _sequential_outputs(model, prompts)
    eng = _engine(model, slots=2, max_seq=32)
    long_req = eng.submit(prompts[0], 8)
    eng.step()
    eng.step()          # the long request is now mid-flight
    eng.submit(np.random.default_rng(4).integers(0, 64, size=4), 2)
    eng.run_until_drained()
    assert list(long_req.out)[:MAX_NEW] == want[long_req.rid]


def test_admission_rejections():
    _, _, model, _ = _setup()
    eng = _engine(model, slots=2, max_seq=16)
    with pytest.raises(AdmissionError, match="empty prompt"):
        eng.submit(np.array([], dtype=np.int32), 4)
    with pytest.raises(AdmissionError, match="max_new_tokens"):
        eng.submit(np.array([1, 2]), 0)
    with pytest.raises(AdmissionError, match="max_seq"):
        eng.submit(np.arange(13) % 64, 4)                # 17 > 16
    assert eng.queue == []
    c = eng.metrics.counter
    assert c("engine.rejections").value == 3
    for reason in ("empty_prompt", "bad_max_new", "exceeds_max_seq"):
        assert c(f"engine.rejections.{reason}").value == 1
    assert c("engine.requests_submitted").value == 0


def test_max_seq_boundary_is_admitted_and_never_overrun():
    _, _, model, _ = _setup()
    eng = _engine(model, slots=1, max_seq=12)
    with pytest.raises(AdmissionError, match="max_seq"):
        eng.submit(np.arange(9) % 64, 4)                 # 13 > 12
    r = eng.submit(np.arange(8) % 64, 4)                 # 12 == 12
    max_pos = -1
    while eng.queue or any(s is not None for s in eng.active):
        eng.step()
        max_pos = max(max_pos, int(eng.pos.max()))
    assert r.done and len(r.out) == 4
    assert max_pos == eng.max_seq - 2
    eng2 = _engine(model, slots=2, max_seq=10)
    rng = np.random.default_rng(5)
    for _ in range(4):
        eng2.submit(rng.integers(0, 64, size=5), 5)
    eng2.run_until_drained()      # RuntimeError if a slot overran
    assert int(eng2.pos.max()) == -1


def test_queue_limit_fifo():
    _, _, model, _ = _setup()
    eng = _engine(model, slots=1, max_seq=16, max_queue=2)
    rng = np.random.default_rng(6)
    r1 = eng.submit(rng.integers(0, 64, size=2), 1)
    r2 = eng.submit(rng.integers(0, 64, size=2), 1)
    with pytest.raises(QueueFullError, match="max_queue"):
        eng.submit(rng.integers(0, 64, size=2), 1)
    assert eng.metrics.counter("engine.rejections.queue_full").value == 1
    assert [r.rid for r in eng.run_until_drained()] == [r1.rid, r2.rid]
    eng.submit(rng.integers(0, 64, size=2), 1)
    eng.run_until_drained()


def test_metric_names_are_the_reference_engines():
    jcfg, params, model, _ = _setup()
    prompts = _prompts(64, (3, 3, 3), seed=7)
    engs = (JEngine(jcfg, params, slots=2, max_seq=16,
                    metrics=jobs.MetricsRegistry()),
            _engine(model, slots=2, max_seq=16))
    snaps = []
    for eng in engs:
        _serve(eng, prompts, max_new=2)
        snaps.append(eng.metrics.snapshot())
    want, got = snaps
    for kind in ("counters", "gauges", "histograms"):
        assert sorted(got[kind]) == sorted(want[kind]), kind
    assert got["counters"] == want["counters"]
    assert got["counters"]["engine.refills_total"] == 3
    for s in range(2):
        assert got["gauges"][f"engine.slot_pos.{s}"] == -1.0


def test_seeded_sampling_reproduces_and_top_k_one_is_greedy():
    _, _, model, _ = _setup()

    def one(**kw):
        return _serve(_engine(model, slots=2, max_seq=32, **kw),
                      [np.array([1, 2, 3])], max_new=6)[0]
    kw = dict(greedy=False, temperature=0.8, top_k=5)
    a, b, c = one(sample_seed=7, **kw), one(sample_seed=7, **kw), \
        one(sample_seed=8, **kw)
    assert a == b and a != c
    assert one(greedy=False, temperature=1.3, top_k=1,
               sample_seed=99) == one(greedy=True)


def test_drain_truncation_raises_or_warns():
    _, _, model, _ = _setup()
    eng = _engine(model, slots=1, max_seq=16)
    eng.submit(np.array([1, 2]), 5)
    with pytest.raises(RuntimeError, match="max_steps"):
        eng.run_until_drained(max_steps=2)
    with pytest.warns(UserWarning, match="truncated"):
        eng.run_until_drained(max_steps=1, on_truncate="warn")
    assert eng.truncated


# --- devices and the launcher ------------------------------------------------------

def test_engine_refuses_a_model_on_another_device_and_cuda_without_a_card():
    _, _, model, head = _setup()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            Engine(model)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            Engine.compress_lm_head(model, device="cuda")
    with pytest.raises(ValueError, match="model on"):
        Engine(model, device="meta")


def test_compress_lm_head_reads_the_module_weights():
    _, params, model, head = _setup()
    assert head.device == torch.device("cpu")
    assert (head.d_in, head.d_out) == (model.cfg.d_model, model.cfg.vocab)
    want = np.asarray(params["embed"]["tok"]).T
    nz = head.dense_weight.numpy().T != 0
    assert 0 < nz.mean() < 0.5
    # pruning keeps the largest magnitudes of the tied head (tok.T)
    assert np.abs(want[nz]).min() >= np.abs(want[~nz]).max() - 1e-7


def test_serve_launcher_runs_on_the_cpu(capsys):
    reqs = serve.main(["--arch", "smollm-135m", "--smoke", "--requests",
                       "3", "--max-new-tokens", "3", "--sparse-head",
                       "--device", "cpu"])
    assert all(r.done and len(r.out) == 3 for r in reqs)
    out = capsys.readouterr().out
    assert "LM head:" in out and "served 3/3 requests" in out
    assert "CPU, plain torch" in out
