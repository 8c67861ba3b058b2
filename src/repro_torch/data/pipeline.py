"""Deterministic, shardable, resumable token pipeline.

Batches are a pure function of (seed, step, shard) via counter-based
Philox streams — no iterator state to checkpoint, so restart-from-step-N
reproduces the exact token stream (fault-tolerance requirement), and any
data shard can be regenerated on any host (elastic re-sharding).

Synthetic text: a Zipf unigram mixture with short Markov motifs, so models
actually have something learnable (examples/train_lm_torch.py shows loss
going down) rather than uniform noise.

A copy of the JAX package's `data/pipeline.py`, which is pure numpy: the
port keeps its own so that it imports nothing of that package. Its
batches are bitwise the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_tokens: int = 0     # vlm/encdec: embeddings per sample
    d_model: int = 0


class SyntheticTokens:
    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        v = cfg.vocab
        base = np.random.default_rng(
            np.random.Philox(key=np.uint64(cfg.seed)))
        # fixed Zipf unigram distribution + a motif table
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._p = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._motifs = base.integers(0, v, size=(64, 8))

    def _rng(self, step: int, shard: int) -> np.random.Generator:
        key = np.uint64(self.cfg.seed) ^ (np.uint64(step) << np.uint64(20)) \
            ^ np.uint64(shard)
        return np.random.default_rng(np.random.Philox(key=key))

    def batch(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        """Batch for (step, shard): tokens (B_local, S+1) int32."""
        cfg = self.cfg
        assert cfg.global_batch % num_shards == 0
        bl = cfg.global_batch // num_shards
        rng = self._rng(step, shard)
        toks = rng.choice(cfg.vocab, size=(bl, cfg.seq_len + 1),
                          p=self._p).astype(np.int32)
        # paste motifs for local structure
        n_paste = max(1, cfg.seq_len // 64)
        for b in range(bl):
            ids = rng.integers(0, 64, size=n_paste)
            pos = rng.integers(0, cfg.seq_len - 8, size=n_paste)
            for i, p0 in zip(ids, pos):
                toks[b, p0:p0 + 8] = self._motifs[i] % cfg.vocab
        out = {"inputs": toks[:, :-1], "targets": toks[:, 1:],
               "mask": np.ones((bl, cfg.seq_len), dtype=np.float32)}
        if cfg.frontend_tokens:
            out["frontend"] = rng.standard_normal(
                (bl, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        return out
