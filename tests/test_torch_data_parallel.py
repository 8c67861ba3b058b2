"""Data-parallel training on gloo groups of 2 and 4 ranks, against the
one-device `Trainer` and the reference's.

A float32 smoke SmolLM (vocab 64) trains 3 steps. The global batch of a
step is its 4 pipeline shards (``data_shards=4``, 1 row each), so 2 and 4
ranks train on the same global batch; the one-device `Trainer` and the
reference's jitted step take the 4 shards concatenated, in 4 microbatches
of 1 row (the DP ranks split theirs the same way). Limits, as in
`tests/test_torch_trainer.py`'s docstring: loss and gnorm each step within
rtol 1e-6 (the sums run in another order: the all-reduce adds the ranks'
means), except AdamW's gnorm against the reference after the first
update, within 1e-5 (`REF_GNORM_RTOL`); the weights after, AdamW by its
rule (every weight within 2 lr a step, all but 1 in 1000 within 1e-6 +
1e-5 |w|), Adafactor within rtol 1e-5 / atol 1e-6.

With ``grad_compress`` the reduction moves bf16: on one rank DP is bitwise
the `Trainer`; on two, `op_cost` counts one all-reduce of the gradients'
bf16 bytes and one of the 4-byte loss a step.

Elasticity: 4 ranks train 3 steps, shrink in the same world to a 2-rank
mesh (`resize`: the state resharded, the local batch and microbatches
doubled, ranks 2-3 idle) and go on to step 6; a 4-rank run's step-3
checkpoint restored into a 2-rank spawn goes on to step 6 too. Each ends
within 1e-4 (the reference's crash-restore limit) of a 4-rank run that
never shrank.

Each group is spawned once: the 4-rank group runs every 4-rank case and
writes the checkpoint the 2-rank group restores.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data.pipeline import PipelineConfig, SyntheticTokens
from repro_torch.launch import mesh as M
from repro_torch.launch import train as launch_train
from repro_torch.launch.op_cost import analyze
from repro_torch.models import api
from repro_torch.train.data_parallel import DataParallelTrainer
from repro_torch.train.trainer import TrainConfig, Trainer

LR = 1e-3
STEPS = 3
SHARDS = 4
PIPE = dict(vocab=64, seq_len=16, global_batch=4, seed=0)
RESUME_TOL = 1e-4
# gnorm against the reference after the first update: AdamW moves a weight
# whose gradient is near zero by about lr either way for a float error
# (`tests/test_torch_trainer.py`), and the gradients' norm follows the
# weights; the one-device `Trainer` itself is 3.1e-6 from the reference at
# step 3 here (4 microbatches), which DP, within 1e-6 of it, inherits
REF_GNORM_RTOL = {"adamw": 1e-5, "adafactor": 1e-6}


def _cfg():
    return configs.get_smoke("smollm-135m").with_(vocab=64, dtype="float32")


def _pipe():
    return SyntheticTokens(PipelineConfig(**PIPE))


def _gen():
    return torch.Generator().manual_seed(1)


def _dp(mesh, optimizer="adamw", microbatches=1, **kw):
    tcfg = TrainConfig(optimizer=optimizer, lr=LR,
                       microbatches=microbatches, **kw)
    return DataParallelTrainer(_cfg(), tcfg, _pipe(), mesh,
                               data_shards=SHARDS, generator=_gen(),
                               device="cpu")


def _weights(t) -> dict:
    return {k: p.detach().numpy().copy()
            for k, p in t.model.named_parameters()}


def _steps(t) -> dict:
    out = {"loss": [], "gnorm": []}
    for step in range(STEPS):
        m = t.train_step(t.batch(step))
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["gnorm"]))
    out["weights"] = _weights(t)
    return out


def four_body(mesh, ckpt_dir):
    """The 4-rank cases: DP (AdamW, Adafactor), a shrink to 2 ranks, an
    unshrunk run, and a run that writes the step-3 checkpoint."""
    out = {"rank": mesh.get_coordinate()[0]}
    for opt in ("adamw", "adafactor"):
        out[opt] = _steps(_dp(mesh, opt))
    t = _dp(mesh)
    t.run(STEPS, log_every=0)
    small = M.make_debug_mesh((2,), ("data",), "cpu")
    t.resize(small)
    out["shrunk_micro"] = t.tcfg.microbatches if t.active else None
    t.run(2 * STEPS, log_every=0)
    out["shrunk"] = t.history
    t = _dp(mesh)
    t.run(2 * STEPS, log_every=0)
    out["unshrunk"] = t.history
    t = _dp(mesh, ckpt_every=STEPS, ckpt_dir=ckpt_dir)
    t.run(STEPS, log_every=0)
    return out


def two_body(mesh, ckpt_dir):
    """The 2-rank cases: DP (AdamW, Adafactor) at 2 microbatches, the
    compressed reduction counted, DP on a 1-rank sub-mesh against the
    `Trainer` bitwise, and the restore of the 4-rank checkpoint."""
    out = {"rank": mesh.get_coordinate()[0]}
    for opt in ("adamw", "adafactor"):
        out[opt] = _steps(_dp(mesh, opt, microbatches=2))
    t = _dp(mesh, microbatches=2, grad_compress=True)
    _, costs = analyze(t.train_step, t.batch(0))
    out["compress_counts"] = costs.coll_counts["all-reduce"]
    out["compress_raw"] = costs.coll_raw["all-reduce"]
    out["compress_grad_bytes"] = sum(2 * p.numel() for p in t.params)
    one = M.make_debug_mesh((1,), ("data",), "cpu")
    t = _dp(one, microbatches=4, grad_compress=True)
    if t.active:
        ref = Trainer(_cfg(), TrainConfig(lr=LR, microbatches=4,
                                          grad_compress=True), _pipe(),
                      generator=_gen(), device="cpu")
        same = []
        for step in range(STEPS):
            b = t.batch(step)
            m, w = t.train_step(b), ref.train_step(b)
            same.append(torch.equal(m["loss"], w["loss"])
                        and torch.equal(m["gnorm"], w["gnorm"]))
        same.append(all(torch.equal(a, b) for a, b in
                        zip(t.params, ref.params)))
        out["compress_one_rank_bitwise"] = same
    t = _dp(mesh, microbatches=2, ckpt_dir=ckpt_dir)
    out["restored"] = t.try_restore()
    out["restored_step"] = t.step
    t.run(2 * STEPS, log_every=0)
    out["resumed"] = t.history
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ckpt_dir = str(tmp_path_factory.mktemp("dp_ckpt"))
    four = M.spawn(4, four_body, ckpt_dir, device_type="cpu",
                   axes=("data",))
    two = M.spawn(2, two_body, ckpt_dir, device_type="cpu",
                  axes=("data",))
    return {4: four, 2: two}


def _global_batch(step: int) -> dict:
    pipe = _pipe()
    parts = [pipe.batch(step, shard=j, num_shards=SHARDS)
             for j in range(SHARDS)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _one_device(optimizer):
    t = Trainer(_cfg(), TrainConfig(optimizer=optimizer, lr=LR,
                                    microbatches=SHARDS), _pipe(),
                generator=_gen(), device="cpu")
    out = {"loss": [], "gnorm": []}
    for step in range(STEPS):
        m = t.train_step(_global_batch(step))
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["gnorm"]))
    out["weights"] = _weights(t)
    return out


def _reference(optimizer, model0):
    """The reference's jitted step from the same initial weights, on the
    same global batches: losses, gnorms and final weights by port name."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke as jax_smoke
    from repro.data.pipeline import PipelineConfig as JPipelineConfig
    from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
    from repro.train.trainer import TrainConfig as JTrainConfig
    from repro.train.trainer import Trainer as JTrainer

    from repro_torch import convert
    jcfg = jax_smoke("smollm-135m").with_(vocab=64, dtype="float32")
    jt = JTrainer(jcfg, JTrainConfig(optimizer=optimizer, lr=LR,
                                     microbatches=SHARDS),
                  JSyntheticTokens(JPipelineConfig(**PIPE)))
    jt.params = jax.tree.map(jnp.asarray,
                             convert.jax_tree_from_model(_cfg(), model0))
    jt.opt_state = jt.opt.init(jt.params)
    out = {"loss": [], "gnorm": []}
    for step in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in _global_batch(step).items()}
        jt.params, jt.opt_state, jt.err, m = jt._step_fn(
            jt.params, jt.opt_state, jt.err, batch)
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["gnorm"]))
    model = convert.model_from_jax_params(
        _cfg(), jax.tree.map(np.asarray, jt.params), device="cpu")
    out["weights"] = _weights_of(model)
    return out


def _weights_of(model) -> dict:
    return {k: p.detach().numpy().copy() for k, p in model.named_parameters()}


def _weights_close(got: dict, want: dict, optimizer: str) -> None:
    assert list(got) == list(want)
    if optimizer == "adafactor":
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        return
    outside = total = 0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        assert diff.max() <= 2 * LR * STEPS, k
        outside += int((diff > 1e-6 + 1e-5 * np.abs(w)).sum())
        total += w.size
    assert outside <= 1e-3 * total, (outside, total)


@pytest.fixture(scope="module")
def baselines():
    out = {}
    for opt in ("adamw", "adafactor"):
        one = _one_device(opt)
        init = api.build_model(_cfg(), generator=_gen(), device="cpu")
        out[opt] = (one, _reference(opt, init))
    return out


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("k", [2, 4])
def test_dp_matches_one_device_and_the_reference(ranks, baselines, k, opt):
    one, ref = baselines[opt]
    got = ranks[k]
    for r in got:              # every rank holds the same replica
        np.testing.assert_allclose(r[opt]["loss"], one["loss"], rtol=1e-6)
        np.testing.assert_allclose(r[opt]["gnorm"], one["gnorm"],
                                   rtol=1e-6)
        np.testing.assert_allclose(r[opt]["loss"], ref["loss"], rtol=1e-6)
        np.testing.assert_allclose(r[opt]["gnorm"][0], ref["gnorm"][0],
                                   rtol=1e-6)
        np.testing.assert_allclose(r[opt]["gnorm"][1:], ref["gnorm"][1:],
                                   rtol=REF_GNORM_RTOL[opt])
        _weights_close(r[opt]["weights"], one["weights"], opt)
        _weights_close(r[opt]["weights"], ref["weights"], opt)
    assert all(np.array_equal(got[0][opt]["weights"][n], r[opt]["weights"][n])
               for r in got[1:] for n in got[0][opt]["weights"])


def test_grad_compress_on_one_rank_is_bitwise_the_trainer(ranks):
    assert ranks[2][0]["compress_one_rank_bitwise"] == [True] * (STEPS + 1)
    assert "compress_one_rank_bitwise" not in ranks[2][1]


def test_grad_compress_all_reduces_bf16(ranks):
    for r in ranks[2]:
        assert r["compress_counts"] == 2        # the gradients, the loss
        assert r["compress_raw"] == r["compress_grad_bytes"] + 4


def test_in_world_shrink_resumes_the_unshrunk_run(ranks):
    four = ranks[4]
    unshrunk = four[0]["unshrunk"]
    assert [r["shrunk_micro"] for r in four] == [2, 2, None, None]
    for r in four[:2]:
        assert len(r["shrunk"]) == 2 * STEPS
        np.testing.assert_allclose(r["shrunk"][:STEPS], unshrunk[:STEPS],
                                   rtol=0, atol=0)
        assert abs(r["shrunk"][-1] - unshrunk[-1]) < RESUME_TOL
    for r in four[2:]:                         # idle after the shrink
        assert r["shrunk"] == unshrunk[:STEPS]


def test_restore_into_a_smaller_spawn_resumes(ranks):
    unshrunk = ranks[4][0]["unshrunk"]
    for r in ranks[2]:
        assert r["restored"] and r["restored_step"] == STEPS
        assert len(r["resumed"]) == STEPS
        assert abs(r["resumed"][-1] - unshrunk[-1]) < RESUME_TOL


def test_launcher_trains_on_two_ranks(capsys):
    out = launch_train.main(["--arch", "smollm-135m", "--smoke", "--steps",
                             "2", "--batch", "4", "--seq", "16", "--ranks",
                             "2", "--device", "cpu"])
    assert [r["rank"] for r in out] == [0, 1]
    assert all(r["step"] == 2 and len(r["history"]) == 2 for r in out)
    assert out[0]["history"] == out[1]["history"]
    assert all(np.isfinite(out[0]["history"]))


def test_launcher_on_ranks_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_train.main(["--arch", "smollm-135m", "--smoke", "--steps",
                           "1", "--ranks", "2"])
