"""Tensor parallelism: the port's models on DTensor parameters placed by
the reference's specs, on a 4-rank gloo group, against the JAX package and
the port's own one-device model.

(a) The sites. For one smoke config of each family (smollm, qwen3-moe, the
    vlm, mamba2, zamba2, seamless), the sequence of logical-name tuples the
    port passes to `shard` over a forward equals the reference's, recorded
    by patching the ``shard`` name in both packages' model modules (the
    reference's ``repro.models.*`` only inside this test) while (b)'s
    one-device runs go (the reference's as its jitted functions trace).
    The reference traces its `lax.scan` body once, the port runs every
    layer, so both sequences are compared with tandem repeats collapsed
    (`_collapse`); zamba2's are traced apart at 6 layers (whole groups),
    since the reference's trailing scan reuses its groups' traced body and
    records nothing.
    The decode step's sequences too, where the port adds nothing: its SSM
    decode branch annotates ``xs`` and ``a``, which the reference leaves to
    XLA's propagation.
(b) Forward, prefill and 4 decode steps (per-slot positions, one slot
    inactive) of each config on the (2, 2) (data, model) mesh, within rtol
    1e-4 / atol 1e-5 of the reference's `api` on the same weights (carried
    by `convert.model_from_jax_params(mesh=)`) and of the port's one-device
    model; also smollm sequence-parallel (``seq_axis="model"``), smollm
    with its decode cache sharded over the sequence on a (1, 4) mesh (kv
    heads 2 do not divide 4), and one ``fsdp=True`` forward. Each rank's
    parameter bytes are the specs' reckoning (`check_distributed`).
(c) Placements. Every annotated activation of a forward carries
    ``placements(logical_spec(rules, names))``; the vocab-sharded
    embedding never gathers its table.
(d) Training. Three `TensorParallelTrainer` steps (AdamW, and Adafactor
    once) on the (2, 2) mesh give losses within 1e-4 of the reference's
    `Trainer`, and the first batch's gradients are within rtol 1e-4 /
    atol 1e-5 x the leaf's largest |g| of ``jax.grad``.
(e) The launcher trains on 4 ranks with ``--model-ranks 2`` by the arch's
    knobs, and its checkpoint restores on a (1, 2) mesh and on one device.
(f) Placed optimizer state (`ShardingRules.state_spec`): ZeRO-1 with AdamW
    and Adafactor, and FSDP by the knobs of yi-9b and granite-moe, give
    weights bitwise those of ``zero1=False`` on the same mesh, each rank's
    parameter and state bytes the dry-run's `_memory` exactly, and losses
    within 1e-4 of the reference's `Trainer`, as does sequence-parallel
    training (smollm with ``seq_axis="model"``, granite-34b by its
    knobs). A checkpoint written on (2, 2) restores on (2, 2) bitwise the
    uninterrupted run, on (1, 4), (4, 1) and one device within 1e-4, and a
    one-device checkpoint on (2, 2). An FSDP table looks its rows up.

Also: `op_cost` counts one all-reduce of the output's bytes for a column-
then row-parallel product on the 2 ranks of the model axis; `build_cell`
on the real mesh runs its train, prefill and decode steps, and the FSDP
train cells;
`launch.gloo_route` gives the native collectives' bits; a plain embedding
table keeps its indexing.

The group is spawned once for the module, its bodies in
`tests/torch_tp_ranks.py`, which imports no JAX. While it runs, this
process records the sites, runs the launcher and computes everything the
ranks are held to (`expected`), so that only then does a test wait for
the ranks.
"""

import contextlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer

from repro_torch import configs, convert
from repro_torch.launch import mesh as M
from repro_torch.launch import train as launch_train
from repro_torch.models import api, encdec, layers, moe, sharding, ssm, \
    transformer

import torch_tp_ranks as R

TOL = dict(rtol=1e-4, atol=1e-5)
FAMILIES = ("smollm-135m", "qwen3-moe-30b-a3b", "internvl2-1b",
            "mamba2-130m", "zamba2-7b", "seamless-m4t-large-v2")
B, S, MAX_SEQ, DECODE_STEPS = 4, 8, 16, 4
LR = 1e-3
LOSS_RTOL = 1e-4
PIPE = dict(vocab=128, seq_len=16, global_batch=4, seed=0)
# the extra cases of (b), each smollm: (name, rules, mesh, decode)
EXTRA = (("smollm-seq-parallel", {"seq_axis": "model"}, "2x2", True),
         ("smollm-seq-sharded-cache", {}, "1x4", True),
         ("smollm-fsdp", {"fsdp": True}, "2x2", False))

_REF: dict = {}


def _params(arch):
    if arch not in _REF:
        jcfg = jax_smoke(arch)
        _REF[arch] = (jcfg, japi.init_params(jcfg, jax.random.PRNGKey(0)))
    return _REF[arch]


def _np_params(arch):
    return jax.tree.map(np.asarray, _params(arch)[1])


def _inputs(jcfg, seed=0) -> dict:
    """The batch, decode tokens and per-slot positions of a case."""
    rng = np.random.default_rng(seed)
    batch = {"inputs": rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)}
    if jcfg.family in ("vlm", "encdec"):
        batch["frontend"] = rng.standard_normal(
            (B, jcfg.n_frontend_tokens, jcfg.d_model)).astype(np.float32)
    toks = [rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
            for _ in range(DECODE_STEPS)]
    first = S + (jcfg.n_frontend_tokens if jcfg.family == "vlm" else 0)
    pos, p = [], np.array([first, first, -1, first], dtype=np.int32)
    for _ in range(DECODE_STEPS):
        pos.append(p.copy())
        p = np.where(p >= 0, p + 1, p).astype(np.int32)
    return {"batch": batch, "toks": toks, "pos": pos}


def _case(arch, rules=None, mesh="2x2", decode=True, record=False):
    jcfg, _ = _params(arch)
    return {"arch": arch, "params": _np_params(arch), "rules": rules or {},
            "mesh": mesh, "decode": decode, "record": record,
            "max_seq": MAX_SEQ, **_inputs(jcfg)}


@contextlib.contextmanager
def _recording(modules, fn, names: list):
    """``shard`` in ``modules`` replaced by ``fn`` (the package's own)
    that also appends each call's logical names to ``names``."""
    def rec(x, *n):
        names.append(tuple(n))
        return fn(x, *n)
    with pytest.MonkeyPatch.context() as mp:
        for m in modules:
            mp.setattr(m, "shard", rec)
        yield


def _reference_recording(names: list):
    from repro.models import sharding as jsharding
    return _recording((jlayers, jmoe, jssm, jtransformer, jencdec),
                      jsharding.shard, names)


def _port_recording(names: list):
    return _recording((layers, moe, ssm, transformer, encdec),
                      sharding.shard, names)


def _outputs(run, case, jaxed: bool) -> dict:
    """forward / prefill / decode logits of a model given as ``run``: the
    reference's `api` (``jaxed``) or a port model; and its sites: the
    names passed to `shard` over the forward and the first decode step
    (the reference's recorded as its jitted functions trace)."""
    conv = (lambda d: {k: jnp.asarray(v) for k, v in d.items()}) if jaxed \
        else (lambda d: {k: torch.as_tensor(v) for k, v in d.items()})
    arr = jnp.asarray if jaxed else torch.as_tensor
    record = _reference_recording if jaxed else _port_recording
    out = {"sites": {"forward": [], "decode": []}}
    with record(out["sites"]["forward"]):
        logits, _ = run["forward"](conv(case["batch"]))
    out["forward"] = np.asarray(logits)
    logits, cache, _ = run["prefill"](conv(case["batch"]), MAX_SEQ)
    out["prefill"] = np.asarray(logits)
    out["decode"] = []
    for i, (tok, pos) in enumerate(zip(case["toks"], case["pos"])):
        with (record(out["sites"]["decode"]) if i == 0
              else contextlib.nullcontext()):
            logits, cache = run["decode"](cache, arr(tok), arr(pos))
        out["decode"].append(np.asarray(logits))
    return out


def _reference_outputs(case) -> dict:
    jcfg, params = _params(case["arch"])
    run = {"forward": jax.jit(lambda b: japi.forward(params, jcfg, b)),
           "prefill": jax.jit(lambda b, ms: japi.prefill(
               params, jcfg, b, max_seq=ms), static_argnums=1),
           "decode": jax.jit(lambda c, t, p: japi.decode_step(
               params, jcfg, c, t, p))}
    return _outputs(run, case, True)


def _port_outputs(case) -> dict:
    cfg = configs.get_smoke(case["arch"])
    m = convert.model_from_jax_params(cfg, case["params"], device="cpu")
    run = {"forward": m.forward,
           "prefill": lambda b, ms: m.prefill(b, max_seq=ms),
           "decode": m.decode_step}
    with torch.no_grad():
        return _outputs(run, case, False)


def _model_cases() -> dict:
    cases = {a: _case(a, record=True) for a in FAMILIES}
    cases["smollm-135m"]["sites"] = True
    for name, rules, mesh, decode in EXTRA:
        cases[name] = _case("smollm-135m", rules, mesh, decode)
    return cases


# FSDP by their train knobs
FSDP_ARCHS = ("yi-9b", "granite-moe-3b-a800m")
# each train case's (arch, optimizer) of the reference's `Trainer`
TRAIN_REFS = {"adamw": ("smollm-135m", "adamw"),
              "adafactor": ("smollm-135m", "adafactor"),
              "adamw-unplaced": ("smollm-135m", "adamw"),
              "adafactor-unplaced": ("smollm-135m", "adafactor"),
              "smollm-seq-parallel": ("smollm-135m", "adamw"),
              "granite-34b": ("granite-34b", "adafactor"),
              "granite-34b-wide": ("granite-34b", "adafactor"),
              **{a: (a, "adamw") for a in FSDP_ARCHS},
              **{f"{a}-unplaced": (a, "adamw") for a in FSDP_ARCHS}}


def _train_cases() -> dict:
    """The `TensorParallelTrainer` runs on the (2, 2) mesh: each with
    ZeRO-1, FSDP and sequence parallelism by the arch's knobs
    (`train_knobs`, as the launcher sets them), the ``-unplaced`` ones
    with ``zero1=False``, and smollm sequence-parallel."""
    from repro_torch.launch.steps import train_knobs
    out = {}
    for name, (arch, optimizer) in TRAIN_REFS.items():
        knobs = train_knobs(arch)
        case = dict(arch=arch, params=_np_params(arch), pipe=PIPE, lr=LR,
                    steps=3, optimizer=optimizer,
                    trainer=dict(fsdp=knobs["fsdp"],
                                 seq_axis=knobs["seq_axis"],
                                 zero1=not name.endswith("-unplaced")))
        if optimizer == knobs["optimizer"]:
            case["trainer"]["opt_kwargs"] = knobs["opt_kwargs"]
        out[name] = case
    out["adamw"]["grads"] = True
    out["smollm-seq-parallel"]["trainer"]["seq_axis"] = "model"
    # 6 heads on the (1, 4) mesh's 4-way model axis: the attention's heads
    # are made whole, and its gradient split back through `split_dim`
    out["granite-34b-wide"]["mesh"] = "1x4"
    return out


def _checkpoint_case(dirs) -> dict:
    return dict(arch="smollm-135m", params=_np_params("smollm-135m"),
                pipe=PIPE, lr=LR, dirs=dirs)


@pytest.fixture(scope="module", autouse=True)
def group(tmp_path_factory):
    """The 4-rank group, started with the module's first test and run in
    a thread, so the reference's side of the tests runs meanwhile."""
    dirs = [str(tmp_path_factory.mktemp(n)) for n in ("tp_ckpt",
                                                      "one_ckpt")]
    tasks = {"models": _model_cases(), "train": _train_cases(),
             "checkpoints": _checkpoint_case(dirs)}
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(M.spawn, 4, R.group_body, tasks,
                          device_type="cpu", shape=(2, 2),
                          axes=("data", "model"), timeout_s=600.0)


@pytest.fixture(scope="module")
def ranks(group):
    return group.result()


@pytest.fixture(scope="module")
def expected():
    """What the ranks are held to, computed while they run: the
    reference's and the one-device port's outputs and sites of every
    model case (one device: the rules do not matter, so the cases of one
    arch share them), the reference `Trainer`'s losses and the first
    batch's ``jax.grad``."""
    out = {}
    for name, case in _model_cases().items():
        if case["arch"] not in out:
            out[case["arch"]] = (_reference_outputs(case),
                                 _port_outputs(case))
        out[name] = out[case["arch"]]
    refs = {}
    for name, key in TRAIN_REFS.items():
        if key not in refs:
            refs[key] = _reference_trainer(*key)
    out["train"] = {name: refs[key] for name, key in TRAIN_REFS.items()}
    out["grads"] = _reference_grads()
    return out


# --- (a) the sites -------------------------------------------------------------

def _collapse(seq: list) -> list:
    """``seq`` with every tandem repeat (a block followed by a copy of
    itself) cut to one copy, shortest blocks first, until none is left."""
    seq = list(seq)
    changed = True
    while changed:
        changed = False
        for p in range(1, len(seq) // 2 + 1):
            i = 0
            while i + 2 * p <= len(seq):
                if seq[i:i + p] == seq[i + p:i + 2 * p]:
                    del seq[i + p:i + 2 * p]
                    changed = True
                else:
                    i += 1
            if changed:
                break
    return seq


# the reference's trailing scan of SSM layers reuses its groups' traced
# body, so a tail records no sites: the hybrid config's sites are traced
# apart at whole groups (the reference on abstract parameters)
SITE_CONFIG = {"zamba2-7b": {"n_layers": 6}}


def _sites(arch, kind, expected) -> tuple:
    """(reference names, port names) of one ``kind`` call of ``arch``."""
    if arch not in SITE_CONFIG:
        ref, port = expected[arch]
        return ref["sites"][kind], port["sites"][kind]
    jcfg = jax_smoke(arch).with_(**SITE_CONFIG[arch])
    cfg = configs.get_smoke(arch).with_(**SITE_CONFIG[arch])
    params = jax.eval_shape(lambda: japi.init_params(
        jcfg, jax.random.PRNGKey(0)))
    model = api.build_model(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    case = _inputs(jcfg)
    ref, port = [], []
    with torch.no_grad(), _reference_recording(ref), _port_recording(port):
        if kind == "forward":
            jb = {k: jnp.asarray(v) for k, v in case["batch"].items()}
            jax.make_jaxpr(lambda p, b: japi.forward(p, jcfg, b))(params,
                                                                   jb)
            model.forward({k: torch.as_tensor(v)
                           for k, v in case["batch"].items()})
        else:
            tok, pos = case["toks"][0], case["pos"][0]
            jax.make_jaxpr(lambda p, c, t, q: japi.decode_step(
                p, jcfg, c, t, q))(params, japi.make_decode_cache(
                    jcfg, B, MAX_SEQ), jnp.asarray(tok), jnp.asarray(pos))
            model.decode_step(model.make_decode_cache(B, MAX_SEQ),
                              torch.as_tensor(tok), torch.as_tensor(pos))
    return ref, port


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_sites_equal_the_references(arch, expected):
    ref, port = _sites(arch, "forward", expected)
    assert ref and port
    assert _collapse(port) == _collapse(ref)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_sites_equal_the_references(arch, expected):
    ref, port = _sites(arch, "decode", expected)
    if arch in ("mamba2-130m", "zamba2-7b"):
        # the port's decode branch annotates xs and a on the SSM heads
        extra = {("batch", "ssm_heads", None), ("batch", "ssm_heads")}
        assert set(port) - set(ref) == extra
        port = [n for n in port if n not in extra]
    assert _collapse(port) == _collapse(ref)


# --- (e) the launcher (run while the group works) ------------------------------

LAUNCH = ["--arch", "smollm-135m", "--smoke", "--batch", "4", "--seq", "16",
          "--device", "cpu", "--ckpt-every", "2"]


@pytest.fixture(scope="module")
def launch_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("launch_ckpt"))


def _launch_4x2(launch_dir):
    return launch_train.main(LAUNCH + ["--steps", "2", "--ranks", "4",
                                       "--model-ranks", "2", "--ckpt-dir",
                                       launch_dir])


def test_launcher_trains_tensor_parallel(capfd, launch_dir):
    out = _launch_4x2(launch_dir)
    assert sorted(r["coord"] for r in out) == [(0, 0), (0, 1), (1, 0),
                                               (1, 1)]
    losses = {tuple(r["history"]) for r in out}
    assert len(losses) == 1 and all(np.isfinite(next(iter(losses))))
    assert "done: 2 steps" in capfd.readouterr().out
    # the arch's knobs: AdamW with ZeRO-1, no FSDP, no sequence parallelism
    assert {(r["optimizer"], r["fsdp"], r["seq"]) for r in out} == \
        {("adamw", False, None)}
    with pytest.raises(ValueError, match="does not divide"):
        launch_train.main(["--arch", "smollm-135m", "--smoke", "--ranks",
                           "4", "--model-ranks", "3", "--device", "cpu"])


def test_launcher_restores_on_other_ranks(capfd, launch_dir):
    """``--restore`` of the 4-rank (2, 2) run's step-2 checkpoint on a
    (1, 2) mesh of 2 ranks and on one device: each resumes at step 2."""
    from repro_torch.train.checkpoint import list_steps
    if 2 not in list_steps(launch_dir):
        _launch_4x2(launch_dir)
    capfd.readouterr()
    out = launch_train.main(LAUNCH + ["--steps", "3", "--ranks", "2",
                                      "--model-ranks", "2", "--ckpt-dir",
                                      launch_dir, "--restore"])
    assert [r["step"] for r in out] == [3, 3]
    assert all(len(r["history"]) == 1 for r in out)
    assert "restored from step 2" in capfd.readouterr().out
    one = launch_train.main(LAUNCH + ["--steps", "3", "--ckpt-dir",
                                      launch_dir, "--restore"])
    assert one.step == 3 and len(one.history) == 1
    assert one.history[0] == pytest.approx(out[0]["history"][0],
                                           rel=LOSS_RTOL)
    assert "restored from step 2" in capfd.readouterr().out


# --- (b) forward, prefill, decode on the mesh ----------------------------------

CASE_NAMES = list(FAMILIES) + [e[0] for e in EXTRA]


def _close(got, want, what):
    np.testing.assert_allclose(got, want, err_msg=what, **TOL)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_tp_matches_the_reference_and_one_device(expected, ranks, name):
    ref, one = expected[name]
    for r in ranks:
        got = r["models"][name]
        keys = ("forward", "prefill", "decode") if "prefill" in got \
            else ("forward",)
        for key in keys:
            if key == "decode":
                assert len(got[key]) == DECODE_STEPS
                for i, (g, w, o) in enumerate(zip(got[key], ref[key],
                                                  one[key])):
                    _close(g, w, f"{name} decode {i} vs the reference")
                    _close(g, o, f"{name} decode {i} vs one device")
            else:
                _close(got[key], ref[key], f"{name} {key} vs the reference")
                _close(got[key], one[key], f"{name} {key} vs one device")


def test_gather_makes_the_model_whole_again(expected, ranks):
    """`launch.sharding.gather` turns the FSDP case's DTensor parameters
    back into whole tensors: its forward is then the one-device one."""
    _, one = expected["smollm-fsdp"]
    for r in ranks:
        _close(r["models"]["smollm-fsdp"]["gathered_forward"],
               one["forward"], "gathered forward vs one device")


def test_seq_sharded_cache_on_the_wide_mesh(ranks):
    """kv heads 2 do not divide the 4-way model axis: the cache is
    sharded over its sequence (`cache_spec`), and the decode steps above
    wrote it rank by rank."""
    for r in ranks:
        got = r["models"]["smollm-seq-sharded-cache"]["cache_placements"]
        assert got == "(Replicate(), Shard(dim=2))", got
        # on the (2, 2) mesh: the batch over "data", the kv heads over
        # "model"
        head = r["models"]["smollm-135m"]["cache_placements"]
        assert head == "(Shard(dim=1), Shard(dim=3))", head


def test_each_ranks_parameter_bytes_are_the_specs(ranks):
    """`check_distributed` held every local shape to `local_shape` in the
    ranks; the bytes add up to the model's, each sharded leaf once."""
    for name in CASE_NAMES:
        per_rank = [r["models"][name]["bytes"] for r in ranks]
        assert len(set(per_rank)) == 1, (name, per_rank)
        cfg = configs.get_smoke(_model_cases()[name]["arch"])
        whole = sum(int(np.prod(a.shape)) * 4 for a in
                    jax.tree.leaves(_np_params(cfg.name)))
        assert per_rank[0] < whole, name


# --- (c) placements --------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_every_annotation_places_as_the_rules_say(ranks, arch):
    for r in ranks:
        calls = r["models"][arch]["placements"]
        assert calls
        for names, got, want in calls:
            assert got == want, (names, got, want)


def test_the_embedding_never_gathers_its_table(ranks):
    cfg = configs.get_smoke("smollm-135m")
    table = cfg.vocab * cfg.d_model * 4
    for r in ranks:
        sites = r["models"]["smollm-135m"]["sites"]
        assert sites
        for kind, raw, site in sites:
            assert kind == "all-reduce", (kind, raw, site)
            assert raw < table, (kind, raw, site)


def test_a_plain_table_keeps_the_indexing():
    """One device: `layers.Embedding` looks a plain table up by indexing,
    so its output and its table's gradient with tokens repeated are
    bitwise ``tok[tokens]``'s (`F.embedding`, which a DTensor table takes,
    adds the repeated rows' gradients in another order)."""
    cfg = configs.get_smoke("smollm-135m")
    emb = layers.Embedding(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    emb.tok.requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 16, (4, 64), generator=g)
    up = torch.randn(4, 64, cfg.d_model, generator=g)
    out = emb(ids)
    assert torch.equal(out, emb.tok[ids])
    got, = torch.autograd.grad(out, emb.tok, up)
    want, = torch.autograd.grad(emb.tok[ids], emb.tok, up)
    assert torch.equal(got, want)


# --- (d) training ----------------------------------------------------------------

def _reference_trainer(arch, optimizer):
    jcfg = jax_smoke(arch)
    jt = JTrainer(jcfg, JTrainConfig(optimizer=optimizer, lr=LR),
                  JSyntheticTokens(JPipelineConfig(**PIPE)))
    # fresh arrays: the reference's jitted step donates its buffers
    jt.params = jax.tree.map(jnp.asarray, _np_params(arch))
    jt.opt_state = jt.opt.init(jt.params)
    losses = []
    for step in range(3):
        batch = {k: jnp.asarray(v) for k, v in
                 jt.pipeline.batch(step).items()}
        jt.params, jt.opt_state, jt.err, m = jt._step_fn(
            jt.params, jt.opt_state, jt.err, batch)
        losses.append(float(m["loss"]))
    return losses


def _reference_grads() -> dict:
    """``jax.grad`` of the loss on the first batch, flattened."""
    jcfg, params = _params("smollm-135m")
    pipe = JSyntheticTokens(JPipelineConfig(**PIPE))
    batch = {k: jnp.asarray(v) for k, v in pipe.batch(0).items()}
    return _flat(jax.jit(jax.grad(
        lambda p: japi.loss_fn(p, jcfg, batch)[0]))(params))


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_tp_training_matches_the_reference_trainer(expected, ranks,
                                                   optimizer):
    want = expected["train"][optimizer]
    for r in ranks:
        got = r["train"][optimizer]["loss"]
        assert got == pytest.approx(want, rel=LOSS_RTOL), (got, want)


# --- (f) ZeRO-1, FSDP, sequence parallelism, checkpoints ------------------------

PLACED = ["adamw", "adafactor", *FSDP_ARCHS]


@pytest.mark.parametrize("name", PLACED)
def test_placed_state_gives_the_unplaced_weights_bitwise(ranks, name):
    """ZeRO-1 (smollm, AdamW and Adafactor) and FSDP with its state in the
    specs' placements (yi-9b, granite-moe): after 3 steps every weight is
    bitwise that of the same mesh's ``zero1=False`` run."""
    for r in ranks:
        got, want = r["train"][name], r["train"][f"{name}-unplaced"]
        assert set(got["weights"]) == set(want["weights"])
        for k, w in want["weights"].items():
            assert np.array_equal(got["weights"][k], w), (name, k)


def _dry_run_memory(name) -> dict:
    """The dry-run's reckoning (`dryrun._memory`) of a train case's
    parameter and optimizer bytes a device on a (2, 2) mesh, under the
    rules the trainer places by."""
    from repro_torch.launch.dryrun import _memory
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.config import ShapeConfig
    arch, optimizer = TRAIN_REFS[name]
    cell = build_cell(arch, "tp_train", MeshShape(("data", "model"), (2, 2)),
                      cfg=configs.get_smoke(arch),
                      shape=ShapeConfig("tp_train", PIPE["seq_len"],
                                        PIPE["global_batch"], "train"),
                      dp_only=False)
    cell.knobs = {"optimizer": optimizer}
    return _memory(cell)


@pytest.mark.parametrize("name", PLACED + ["granite-34b"])
def test_each_ranks_state_bytes_are_the_dry_runs(ranks, name):
    """Each rank's bytes of optimizer state and of parameters equal the
    dry-run's ``opt_bytes`` and ``param_bytes`` for the mesh, exactly; the
    unplaced state holds more."""
    mem = _dry_run_memory(name)
    for r in ranks:
        got = r["train"][name]
        assert got["opt_bytes"] == mem["opt_bytes"], (name, got["opt_bytes"])
        assert got["param_bytes"] == mem["param_bytes"], name
        if f"{name}-unplaced" in r["train"] and name not in FSDP_ARCHS:
            assert r["train"][f"{name}-unplaced"]["opt_bytes"] > \
                mem["opt_bytes"], name


TRAINED = [n for n in TRAIN_REFS if n not in ("adamw", "adafactor")]


@pytest.mark.parametrize("name", TRAINED)
def test_placed_and_sequence_parallel_losses_match_the_reference(
        expected, ranks, name):
    """FSDP (yi-9b, granite-moe by their knobs), ZeRO-1 against
    ``zero1=False``, and sequence-parallel training (smollm with
    ``seq_axis="model"``, granite-34b by its knobs: Adafactor, sequence
    parallel; also on the (1, 4) mesh, where its 6 heads do not divide
    the model axis, which failed in the backward before): losses within
    1e-4 of the reference's `Trainer`."""
    want = expected["train"][name]
    for r in ranks:
        got = r["train"][name]["loss"]
        assert got == pytest.approx(want, rel=LOSS_RTOL), (name, got, want)
    if name in ("smollm-seq-parallel", "granite-34b", "granite-34b-wide"):
        assert all(r["train"][name]["seq"] == "model" for r in ranks)


@pytest.mark.parametrize("where", ["2x2", "1x4", "4x1", "one", "from_one"])
def test_a_checkpoint_restores_across_meshes(ranks, where):
    """A checkpoint written on the (2, 2) mesh at step 2, restored on the
    same mesh, on (1, 4), on (4, 1) and on one device, and a one-device
    checkpoint restored on (2, 2): 2 more steps each. On the same mesh the
    resumed run is bitwise the uninterrupted one (losses and weights);
    elsewhere within 1e-4."""
    for r in ranks:
        ck = r["checkpoints"]
        want_loss, _, want_w = ck["uninterrupted"]
        want_loss = want_loss[2:]          # the steps after the restore
        loss, step, weights = ck[where]
        assert step == 2
        if where == "2x2":
            assert loss == want_loss
            for k, w in want_w.items():
                assert np.array_equal(weights[k], w), k
            continue
        assert loss == pytest.approx(want_loss, rel=LOSS_RTOL)
        for k, w in want_w.items():
            np.testing.assert_allclose(weights[k], w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{where} {k}")


def test_an_fsdp_table_looks_up_its_rows(ranks):
    """The FSDP table (vocab over "model", d_model over "data") is gathered
    along d_model before its lookup: the rows are the one-device table's
    (this failed in `F.embedding` before)."""
    for r in ranks:
        lk = r["fsdp_lookup"]
        assert lk["placements"] == "(Shard(dim=1), Shard(dim=0))", lk
        assert np.array_equal(lk["got"], lk["want"])


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_first_step_gradients_match_jax_grad(expected, ranks):
    want = expected["grads"]
    for r in ranks:
        got = _flat(r["train"]["adamw"]["grads"])
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(
                got[k], w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                err_msg=k)


# --- op_cost, the cells, the gloo route ------------------------------------------

def test_op_cost_counts_one_all_reduce_for_a_row_parallel_product(ranks):
    for r in ranks:
        rp = r["row_parallel"]
        assert rp["counts"] == {"all-gather": 0, "all-reduce": 1,
                                "reduce-scatter": 0, "all-to-all": 0,
                                "collective-permute": 0, "broadcast": 0}
        assert rp["raw"]["all-reduce"] == rp["y_bytes"] == 4 * 8 * 4


def test_cells_run_sharded_on_a_real_mesh(ranks):
    """The counterpart of the reference's ``Cell.lower(mesh)``: each kind
    of step runs on the mesh, its Megatron all-reduces counted (a decode
    step of 2 layers: 2 a layer + the embedding's)."""
    for r in ranks:
        cells = r["cells"]
        assert cells["smollm-135m decode"]["all-reduce"] == 5, cells
        assert cells["smollm-135m prefill"]["all-reduce"] == 5, cells
        assert cells["smollm-135m train"]["all-reduce"] > 5, cells
        # FSDP's weight all-gathers and gradient reduce-scatters
        for arch in FSDP_ARCHS + ("zamba2-7b",):
            c = cells[f"{arch} train"]
            assert c["all-gather"] > 0 and c["reduce-scatter"] > 0, c


def test_gloo_route_gives_the_native_collectives_bits(ranks):
    """`launch.gloo_route` (installed on the card for gloo groups, whose
    functional collectives crash in torch 2.11's wait) routed for CPU
    tensors on the 4 gloo ranks: every redistribution bitwise the native
    functional collectives'."""
    for r in ranks:
        route = r["route"]
        assert set(route["native"]) == set(route["routed"])
        for name, want in route["native"].items():
            assert np.array_equal(route["routed"][name], want), name


def test_a_rank_encodes_its_own_shard_alone():
    """`FormatSpec.shard(only=k)` packs shard k alone, bitwise the whole
    plan's shard k, the others None (what each rank of `chip_smoke.py`'s
    phase 4n encodes for its own shard of the head); such a plan still
    names its family's collective adapter."""
    from repro_torch.kernels import shard_ops
    from repro_torch.sparse.formats import CSR
    from repro_torch.sparse.registry import get_format
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((384, 40)).astype(np.float32)
    dense[rng.random(dense.shape) < 0.7] = 0
    rows, cols = np.nonzero(dense)
    indptr = np.searchsorted(rows, np.arange(385)).astype(np.int64)
    a = CSR(indptr, cols.astype(np.int32), dense[rows, cols], dense.shape)
    spec = get_format("dtans")
    knobs = {"lane_width": 128, "shared_table": True}
    whole = spec.shard(a, 3, **knobs)
    for k in range(3):
        own = spec.shard(a, 3, only=k, **knobs)
        assert own.boundaries == whole.boundaries
        assert [s is None for s in own.shards] == [j != k for j in range(3)]
        assert own.shard_nbytes[k] == whole.shard_nbytes[k]
        for f in ("stream", "esc", "ns", "nnz", "tab_symbol", "pattern"):
            assert np.array_equal(np.asarray(getattr(own.shards[k], f)),
                                  np.asarray(getattr(whole.shards[k], f))), f
        assert shard_ops.supports_shard_map(own)
