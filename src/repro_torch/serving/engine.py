"""Batched serving engine: per-slot continuous batching with batched
prefill and an optional dtANS-compressed LM head.

A port of the JAX package's `serving/engine.py`, with the same scheduler,
admission rules, metric names and sampling. A fixed pool of batch slots is
filled FIFO from a bounded request queue. Each slot tracks its own cache
position (`Engine.pos[s]`; -1 = empty slot), so requests with unequal
prompt lengths decode together: slot s reads and writes K/V at exactly
``pos[s]``. Admitting a request runs ``prompt[:-1]`` through ONE batched
`prefill` and writes the batch-size-1 cache into the slot
(`cache_insert_slot`); the other slots' cache lines are untouched.
Admission control rejects, at `submit`, what the pool could never serve:
empty prompts and ``prompt_len + max_new_tokens > max_seq``.

Sampling: ``greedy=True`` takes the argmax; ``greedy=False`` samples from
the temperature-scaled softmax, optionally cut to the ``top_k`` most likely
tokens, with a seeded numpy generator on the host (the reference's, so
the same ``sample_seed`` gives the same stream in both packages).

Compressed head: `compress_lm_head` turns the model's LM head into a
`SparseLinear` (pruned + entropy-coded). Each pooled decode step then
stops the model at the final norm (`decode_hidden`) and contracts the
(slots, 1, d) hidden states against the compressed head in ONE SpMM
(`SparseLinear.apply` -> `ops.spmm`, the `dtans_spmm` CUDA kernel on the
card; a ``slots=1`` engine runs `dtans_spmv`). The model runs eagerly
under `torch.inference_mode()` (the reference jit-compiles its step). A
step waits on the card once, for the copy of its logits to the host: the
copies of the tokens and positions up to the card go into an idle stream,
and nothing in the model or the head reads the card back.
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.pack import check_device
from repro_torch.serving.sparse_linear import SparseLinear


class AdmissionError(ValueError):
    """Request rejected by admission control at `Engine.submit`."""


class QueueFullError(AdmissionError):
    """Request rejected because the FIFO queue is at ``max_queue``."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (len,) int32
    max_new_tokens: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    # Observability timestamps (time.perf_counter seconds): submission,
    # first generated token (TTFT = t_first - t_submit), completion
    # (end-to-end latency = t_done - t_submit).
    t_submit: float | None = None
    t_first: float | None = None
    t_done: float | None = None


class Engine:
    """Serves ``model`` (a `repro_torch.models` model) on ``device``
    (``"cuda"`` unless the caller asks for the CPU; the model must lie
    there, and a CUDA request without a card raises)."""

    def __init__(self, model, *, slots: int = 4, max_seq: int = 256,
                 sparse_head: SparseLinear | None = None,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, sample_seed: int = 0,
                 max_queue: int | None = None,
                 metrics: obs.MetricsRegistry | None = None,
                 device="cuda"):
        self.device = check_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on "
                             f"{self.device}")
        if sparse_head is not None and sparse_head.device != self.device:
            raise ValueError(f"compressed head on {sparse_head.device}, "
                             f"engine on {self.device}")
        self.model = model
        self.cfg = model.cfg
        self.slots = slots
        self.max_seq = max_seq
        self.sparse_head = sparse_head
        self.greedy = greedy
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self._sampler = np.random.default_rng(sample_seed)
        self.max_queue = max_queue
        # Metrics land in the process default registry unless the caller
        # isolates them (`obs.NULL` serves uninstrumented).
        self.metrics = metrics if metrics is not None \
            else obs.default_registry()
        m = self.metrics
        self._m_step = m.histogram("engine.step_s")
        self._m_prefill = m.histogram("engine.prefill_s")
        self._m_decode = m.histogram("engine.decode_s")
        self._m_refill = m.histogram("engine.refill_s")
        self._m_occupancy = m.histogram("engine.occupancy")
        self._m_ttft = m.histogram("engine.ttft_s")
        self._m_e2e = m.histogram("engine.e2e_s")
        self._m_tokens = m.counter("engine.tokens_total")
        self._m_steps = m.counter("engine.steps_total")
        self._m_submitted = m.counter("engine.requests_submitted")
        self._m_completed = m.counter("engine.requests_completed")
        self._m_rejected = m.counter("engine.rejections")
        self._m_refills = m.counter("engine.refills_total")
        self._m_tps = m.gauge("engine.tokens_per_sec")
        self._m_queue = m.gauge("engine.queue_depth")
        self._m_slot_pos = [m.gauge(f"engine.slot_pos.{s}")
                            for s in range(slots)]
        #: True when the last `run_until_drained` hit ``max_steps`` with
        #: requests still active (only reachable with on_truncate="warn").
        self.truncated = False
        self.queue: list[Request] = []
        self.active: list[Request | None] = [None] * slots
        #: Completed requests in completion order, appended by `step`
        #: and drained by `run_until_drained`.
        self.finished: list[Request] = []
        self._next_rid = 0
        #: Per-slot cache position: the index the slot's NEXT decode
        #: step writes K/V at. -1 = empty slot (its cache writes and
        #: attention are masked).
        self.pos = np.full(slots, -1, dtype=np.int32)
        self.cache = model.make_decode_cache(slots, max_seq,
                                             dtype=torch.float32)
        # A zeroed batch-size-1 cache of the model's tree (KV lines, SSM
        # states and conv tails, encoder memory), written into a slot on
        # admission of a 1-token prompt (no prefill runs, but the slot's
        # state from its previous occupant must still be cleared).
        self._blank_slot = model.make_decode_cache(1, max_seq,
                                                   dtype=torch.float32)

    # --- compressed head -------------------------------------------------------
    @classmethod
    def compress_lm_head(cls, model, sparsity=0.8, **kw) -> SparseLinear:
        """Compress the LM head of ``model`` into a `SparseLinear`.

        Reads the head as `models.layers.lm_head` does (untied ``head`` or
        tied ``tok.T``), checks its shape against the model's config, and
        hands it over in its own dtype (bfloat16 becomes float32, as in
        the reference). The layer is built on the model's device unless
        ``device=`` says otherwise."""
        cfg = model.cfg
        w = model.embed.head_weight().detach()           # (d, vocab)
        if w.dtype not in (torch.float32, torch.float64):
            w = w.to(torch.float32)
        if tuple(w.shape) != (cfg.d_model, cfg.vocab):
            raise ValueError(
                f"LM head shape {tuple(w.shape)} does not match config "
                f"(d_model={cfg.d_model}, vocab={cfg.vocab})")
        kw.setdefault("device", model.device)
        return SparseLinear.from_dense(w.cpu().numpy(), sparsity=sparsity,
                                       **kw)

    def _head(self, hidden):
        """hidden: (B, 1, d) -> logits (B, 1, vocab) through the compressed
        head's SpMM (`SparseLinear.apply` -> `ops.spmm`), recording into
        the engine's own registry."""
        if self.sparse_head is None:
            raise RuntimeError("dense path returns logits directly")
        return self.sparse_head.apply(hidden, metrics=self.metrics)

    # --- scheduler: admission control ----------------------------------------
    def _reject(self, reason: str, msg: str):
        self._m_rejected.add(1)
        self.metrics.counter(f"engine.rejections.{reason}").add(1)
        if reason == "queue_full":
            raise QueueFullError(msg)
        raise AdmissionError(msg)

    def submit(self, prompt, max_new_tokens: int, rid=None) -> Request:
        """Admit a request into the FIFO queue, or raise `AdmissionError` /
        `QueueFullError`. Rules (each rejection bumps ``engine.rejections``
        and ``engine.rejections.<reason>``): a non-empty prompt;
        ``max_new_tokens >= 1``; ``prompt_len + max_new_tokens <=
        max_seq``, so a slot position never walks past the cache; queue
        depth below ``max_queue`` (when set)."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            self._reject("empty_prompt", "empty prompt rejected: the "
                         "first decode step feeds prompt[-1]")
        if max_new_tokens < 1:
            self._reject("bad_max_new",
                         f"max_new_tokens must be >= 1; "
                         f"got {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.max_seq:
            self._reject(
                "exceeds_max_seq",
                f"prompt_len + max_new_tokens = "
                f"{len(prompt)} + {max_new_tokens} > max_seq="
                f"{self.max_seq}: request would overrun the KV cache")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self._reject("queue_full",
                         f"queue at max_queue={self.max_queue}")
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        r = Request(rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                    t_submit=time.perf_counter())
        self.queue.append(r)
        self._m_submitted.add(1)
        self._m_queue.set(len(self.queue))
        return r

    # --- scheduler: refill + batched prefill ----------------------------------
    def _fill_slots(self):
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                r = self.queue.pop(0)
                self.active[s] = r
                t0 = time.perf_counter()
                with obs.span("engine.prefill", rid=r.rid, slot=s,
                              prompt_len=int(len(r.prompt))):
                    self._prefill_slot(s, r)
                self._m_prefill.observe(time.perf_counter() - t0)
                self._m_refills.add(1)
        self._m_queue.set(len(self.queue))
        for s, g in enumerate(self._m_slot_pos):
            g.set(int(self.pos[s]))

    def _prefill_slot(self, s: int, r: Request):
        """Admit ``r`` into slot ``s``: ``prompt[:-1]`` through ONE batched
        `prefill`, its cache written into the slot (the last prompt token
        is fed by the first pooled decode step, which produces the first
        output token). Other slots are untouched."""
        L = len(r.prompt)
        if L > 1:
            batch = {"inputs": torch.as_tensor(r.prompt[None, :-1],
                                               device=self.device)}
            if self.cfg.family == "encdec":
                # No frame frontend flows through `submit`; a zero frame
                # block matches the zero `memory` of the pooled cache
                # (the encoder maps zeros to zeros).
                batch["frontend"] = torch.zeros(
                    (1, self.cfg.n_frontend_tokens, self.cfg.d_model),
                    dtype=torch.float32, device=self.device)
            _, req_cache, _ = self.model.prefill(batch,
                                                 max_seq=self.max_seq)
        else:
            # 1-token prompt: nothing to prefill, but the slot's cache
            # lines still hold its previous occupant's state.
            req_cache = self._blank_slot
        self.model.cache_insert_slot(self.cache, req_cache, s)
        self.pos[s] = L - 1

    # --- sampling --------------------------------------------------------------
    def _select_token(self, logits_row: np.ndarray) -> int:
        """Next token from one slot's (vocab,) logits: argmax when
        ``greedy``, else seeded temperature/top-k sampling."""
        if self.greedy:
            return int(logits_row.argmax())
        z = logits_row.astype(np.float64) / max(self.temperature, 1e-6)
        if self.top_k and self.top_k < z.size:
            kth = np.partition(z, -self.top_k)[-self.top_k]
            z = np.where(z >= kth, z, -np.inf)
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._sampler.choice(z.size, p=p))

    # --- decode ----------------------------------------------------------------
    def _decode(self, toks: np.ndarray) -> np.ndarray:
        """One pooled model step at the slots' own positions; float32
        logits (slots, 1, vocab) on the host."""
        toks = torch.as_tensor(toks, device=self.device)
        pos = torch.as_tensor(self.pos, device=self.device)
        if self.sparse_head is not None:
            # the pooled hidden states contract against the entropy-coded
            # head in ONE SpMM; the dense head is never consulted
            hidden, self.cache = self.model.decode_hidden(self.cache, toks,
                                                          pos)
            logits = self._head(hidden)
        else:
            logits, self.cache = self.model.decode_step(self.cache, toks,
                                                        pos)
        return logits.to(torch.float32).cpu().numpy()

    def step(self) -> int:
        """One pooled decode for all active slots; returns #tokens.

        Each slot decodes at ITS OWN position (`self.pos`), so
        mixed-length prompts and mid-flight refills stay token-identical
        to running each request alone. Step wall time splits into refill
        (admission + batched prefill) and pooled decode spans; tokens/s,
        slot occupancy, per-slot position gauges, TTFT and end-to-end
        latency land in `self.metrics` (the reference's names)."""
        t_step0 = time.perf_counter()
        with obs.span("engine.step"), torch.inference_mode():
            with obs.span("engine.refill"):
                self._fill_slots()
            t_refill = time.perf_counter() - t_step0
            n_active = sum(r is not None for r in self.active)
            if n_active == 0:
                return 0
            toks = np.zeros((self.slots, 1), dtype=np.int32)
            for s, r in enumerate(self.active):
                if r is not None:
                    toks[s, 0] = (r.out[-1] if r.out else r.prompt[-1])
            t_dec0 = time.perf_counter()
            with obs.span("engine.decode", batch=n_active,
                          sparse=self.sparse_head is not None):
                logits = self._decode(toks)
            t_decode = time.perf_counter() - t_dec0
            now = time.perf_counter()
            produced = 0
            for s, r in enumerate(self.active):
                if r is None:
                    continue
                nxt = self._select_token(logits[s, 0])
                r.out.append(nxt)
                produced += 1
                self.pos[s] += 1
                if self.pos[s] >= self.max_seq:
                    # Unreachable by construction: admission control
                    # bounds prompt_len + max_new_tokens <= max_seq.
                    raise RuntimeError(
                        f"slot {s} position {int(self.pos[s])} overran "
                        f"max_seq={self.max_seq}: admission control "
                        f"failed")
                if len(r.out) == 1:
                    r.t_first = now
                    if r.t_submit is not None:
                        self._m_ttft.observe(now - r.t_submit)
                if len(r.out) >= r.max_new_tokens:
                    r.done = True
                    r.t_done = now
                    self.active[s] = None
                    self.pos[s] = -1
                    self.finished.append(r)
                    self._m_completed.add(1)
                    if r.t_submit is not None:
                        self._m_e2e.observe(now - r.t_submit)
            for s, g in enumerate(self._m_slot_pos):
                g.set(int(self.pos[s]))
        dt = time.perf_counter() - t_step0
        self._m_step.observe(dt)
        self._m_refill.observe(t_refill)
        self._m_decode.observe(t_decode)
        self._m_occupancy.observe(n_active / self.slots)
        self._m_tokens.add(produced)
        self._m_steps.add(1)
        self._m_tps.set(produced / dt if dt > 0 else 0.0)
        return produced

    def run_until_drained(self, max_steps: int = 10000, *,
                          on_truncate: str = "raise") -> list[Request]:
        """Step until queue and slots are empty; returns the completed
        requests in completion order (including any that finished in
        manual `step` calls before this drain). Hitting ``max_steps`` with
        requests pending raises (``on_truncate="raise"``, the default) or
        warns, sets ``self.truncated`` and returns what finished
        (``"warn"``)."""
        if on_truncate not in ("raise", "warn"):
            raise ValueError(f"on_truncate must be 'raise' or 'warn'; "
                             f"got {on_truncate!r}")
        self.truncated = False
        steps = 0
        while (self.queue or any(self.active)) and steps < max_steps:
            self.step()
            steps += 1
        if self.queue or any(r is not None for r in self.active):
            pending = len(self.queue) + sum(r is not None
                                            for r in self.active)
            msg = (f"run_until_drained hit max_steps={max_steps} with "
                   f"{pending} request(s) still pending: results are "
                   f"truncated")
            self.metrics.counter("engine.drain_truncations").add(1)
            if on_truncate == "raise":
                raise RuntimeError(msg)
            warnings.warn(msg, stacklevel=2)
            self.truncated = True
        finished, self.finished = self.finished, []
        return finished
