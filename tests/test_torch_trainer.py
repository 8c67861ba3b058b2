"""The port's `Trainer`, checkpoints and training launcher.

The port's `Trainer` against the reference's: both start from one set of
weights (the reference trainer's, carried by `convert.model_from_jax_params`)
and one pipeline, and take 3 steps (the reference's jitted step, the port's
`train_step`). Limits, float32 smoke SmolLM:

- loss each step within rtol `LOSS_RTOL` (1e-6: the sums run in another
  order in the two frameworks; measured ~1e-7);
- gnorm within rtol 1e-6, and 1e-4 where the gradients pass through bf16
  (``grad_compress``, ``acc_dtype="bfloat16"``): a component whose float32
  value differs in its last bit can round to the neighbouring bf16 value,
  2^-8 of itself away (measured ~1e-5);
- the weights after: Adafactor within rtol 1e-5 / atol 1e-6; AdamW, whose
  update ``m / (sqrt(v) + eps)`` sends a near-zero gradient's float error
  to a step of about lr either way, every weight within 2 lr a step and
  all but 1 in 1000 of the model's weights within 1e-6 + 1e-5 |w|
  (measured 2 of 78,144 outside in float32, 36 and 45 where a bf16
  rounding flips, the worst 0.02 lr).

Checkpoints: the save/restore roundtrip, a torn step skipped, the async
garbage collection keeping 2 of 4, a snapshot isolated from in-place
updates made after ``save_async`` returns, and a crash at step 6, restored
at 4 and resumed to 10, within 1e-4 of an uninterrupted run (the
reference's `tests/test_train_substrate.py` limit). The launcher trains
smoke configs on the CPU and refuses to run without a card by default.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer

from repro_torch import configs, convert
from repro_torch.data.pipeline import PipelineConfig, SyntheticTokens
from repro_torch.launch import train as launch_train
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import TrainConfig, Trainer

LR = 1e-3
STEPS = 3
LOSS_RTOL = 1e-6
PIPE = dict(vocab=64, seq_len=16, global_batch=4, seed=0)


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _weights_close(got: dict, want: dict, optimizer: str) -> None:
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


CASES = {"adamw": dict(optimizer="adamw"),
         "adamw-microbatches-2": dict(optimizer="adamw", microbatches=2),
         "adafactor": dict(optimizer="adafactor"),
         "adamw-grad-compress": dict(optimizer="adamw", grad_compress=True),
         "adamw-acc-bfloat16": dict(optimizer="adamw", microbatches=2,
                                    acc_dtype="bfloat16")}


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_against_the_reference(case):
    kw = CASES[case]
    jcfg = jax_smoke("smollm-135m").with_(vocab=64)
    cfg = configs.get_smoke("smollm-135m").with_(vocab=64)
    jt = JTrainer(jcfg, JTrainConfig(lr=LR, **kw),
                  JSyntheticTokens(JPipelineConfig(**PIPE)),
                  rng=jax.random.PRNGKey(1))
    # a copy before the reference's jitted step donates its buffers
    p0 = jax.tree.map(lambda a: np.array(a, copy=True), jt.params)
    t = Trainer(cfg, TrainConfig(lr=LR, **kw),
                SyntheticTokens(PipelineConfig(**PIPE)),
                model=convert.model_from_jax_params(cfg, p0, device="cpu"))
    gnorm_rtol = 1e-4 if kw.get("grad_compress") or \
        kw.get("acc_dtype") == "bfloat16" else 1e-6
    for step in range(STEPS):
        batch = jt.pipeline.batch(step)
        jt.params, jt.opt_state, jt.err, jm = jt._step_fn(
            jt.params, jt.opt_state, jt.err,
            {k: jnp.asarray(v) for k, v in batch.items()})
        m = t.train_step(t.pipeline.batch(step))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=LOSS_RTOL)
        assert float(m["gnorm"]) == pytest.approx(float(jm["gnorm"]),
                                                  rel=gnorm_rtol)
    _weights_close(_flat(convert.jax_tree_from_model(cfg, t.model)),
                   _flat(jt.params), kw["optimizer"])


# --- checkpoints ----------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    tree = {"a": np.arange(6).reshape(2, 3).astype(np.float32),
            "b": {"c": np.asarray(3)},
            "t": [torch.arange(4, dtype=torch.int32),
                  torch.tensor([1.5, -2.25], dtype=torch.bfloat16)]}
    ckpt.save(5, tree, str(tmp_path))
    step, back = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 5
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert back["b"]["c"] == 3
    for got, want in zip(back["t"], tree["t"]):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_torn_checkpoint_skipped(tmp_path):
    tree = {"a": np.ones(3)}
    ckpt.save(1, tree, str(tmp_path))
    os.makedirs(tmp_path / "step_00000002")        # no manifest: torn
    ckpt.save(3, tree, str(tmp_path))
    os.remove(tmp_path / "step_00000003" / "shard_0.npz")
    step, _ = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 1
    assert ckpt.restore_latest(str(tmp_path), {"b": np.ones(3)}) == \
        (None, None)                                 # other leaves


def test_async_checkpointer_gc(tmp_path):
    c = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        c.save_async(s, {"x": np.full(4, s)})
    c.wait()
    assert ckpt.list_steps(str(tmp_path)) == [3, 4]
    assert [r["step"] for r in c.saves] == [1, 2, 3, 4]
    assert all(r["bytes"] == 32 and r["write_s"] >= 0 for r in c.saves)


def test_async_snapshot_is_isolated_from_in_place_updates(tmp_path,
                                                          monkeypatch):
    """The background write must not read the live tensors: it is held
    until they have been changed in place, and still writes the values of
    the moment `save_async` was called."""
    go = threading.Event()
    real_save = ckpt.save

    def held_save(*a, **kw):
        assert go.wait(timeout=30)
        return real_save(*a, **kw)
    monkeypatch.setattr(ckpt, "save", held_save)
    tree = {"w": torch.zeros(1000), "m": [torch.ones(7)]}
    c = ckpt.AsyncCheckpointer(str(tmp_path))
    c.save_async(1, tree)
    tree["w"].add_(1.0)
    tree["m"][0].mul_(3.0)
    go.set()
    c.wait()
    _, back = ckpt.restore_latest(str(tmp_path), tree)
    assert torch.equal(back["w"], torch.zeros(1000))
    assert torch.equal(back["m"][0], torch.ones(7))


def _smoke_trainer(tcfg, seed=1):
    cfg = configs.get_smoke("smollm-135m").with_(vocab=64)
    return Trainer(cfg, tcfg, SyntheticTokens(PipelineConfig(**PIPE)),
                   generator=torch.Generator().manual_seed(seed),
                   device="cpu")


def test_crash_restore_resume_deterministic(tmp_path):
    tcfg = TrainConfig(optimizer="adamw", lr=LR, microbatches=2,
                       ckpt_every=4, ckpt_dir=str(tmp_path))
    t1 = _smoke_trainer(tcfg)
    t1.run(4, log_every=0)
    saved = ckpt.host_copy(t1.state())
    with pytest.raises(RuntimeError, match="injected failure at step 6"):
        t1.run(10, log_every=0, fail_at=6)
    assert t1.try_restore()
    assert t1.step == 4                   # restored at the checkpoint
    restored = ckpt.flatten(t1.state())
    assert list(restored) == list(saved)
    assert all(torch.equal(restored[k], saved[k]) for k in saved)
    t1.run(10, log_every=0)
    # a run that never crashed must reach the same final loss
    t2 = _smoke_trainer(TrainConfig(optimizer="adamw", lr=LR,
                                    microbatches=2))
    t2.run(10, log_every=0)
    assert abs(t1.history[-1] - t2.history[-1]) < 1e-4
    assert not t2.try_restore()           # no checkpoint directory


def test_restore_without_a_checkpoint_keeps_the_state(tmp_path):
    t = _smoke_trainer(TrainConfig(ckpt_dir=str(tmp_path / "none")))
    before = ckpt.host_copy(t.state())
    assert not t.try_restore() and t.step == 0
    after = ckpt.flatten(t.state())
    assert all(torch.equal(after[k], before[k]) for k in before)


# --- the launcher -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-130m"])
def test_launcher_trains_a_smoke_config_on_the_cpu(arch, capsys):
    t = launch_train.main(["--arch", arch, "--smoke", "--steps", "3",
                           "--batch", "4", "--seq", "32", "--device", "cpu"])
    assert t.step == 3 and len(t.history) == 3
    assert all(np.isfinite(t.history))
    assert "done: 3 steps" in capsys.readouterr().out


def test_launcher_restores_from_its_checkpoint(tmp_path, capsys):
    args = ["--arch", "smollm-135m", "--smoke", "--batch", "4", "--seq",
            "32", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    launch_train.main(args + ["--steps", "2"])
    t = launch_train.main(args + ["--steps", "3", "--restore"])
    assert "restored from step 2" in capsys.readouterr().out
    assert t.step == 3 and len(t.history) == 1


def test_launcher_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_train.main(["--arch", "smollm-135m", "--smoke",
                           "--steps", "1"])
