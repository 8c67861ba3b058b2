"""Roofline terms of a step on the port's card: the port of the JAX
package's `launch/roofline.py`.

   compute term    = FLOPs / peak_FLOP/s
   memory term     = bytes / HBM_bw
   collective term = collective wire bytes / link_bw

per device. `launch.op_cost` counts the FLOPs, the bytes and the
collectives of an eager step (its aten ops); `launch.dryrun` reckons a
sharded cell's per-device share from them and the sharding specs. The
reference parses the partitioned HLO's collectives (`collective_bytes`);
the port has no HLO, and their on-wire factors live in `op_cost`.

Hardware model: one NVIDIA H100 SXM5, from NVIDIA's H100 Tensor Core GPU
data sheet (dense rates, no sparsity): 989 TFLOP/s bf16, HBM3 at
3.35 TB/s, 80 GB of HBM3 (80 GiB of stacks; torch reports 79.6 GiB of
it), NVLink 900 GB/s per card to the other cards of the host, 450 GB/s
each way. The rates assume the card's full 700 W power limit.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12        # bf16 dense / card
HBM_BW = 3.35e12           # bytes/s / card
LINK_BW = 450e9            # bytes/s / card, each way (NVLink 4)
HBM_PER_CHIP = 80 * 1024 ** 3


@dataclasses.dataclass
class Roofline:
    flops: float               # per-device FLOPs
    hbm_bytes: float           # per-device bytes moved
    coll_bytes: float          # per-device on-wire collective bytes
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""

    @classmethod
    def from_costs(cls, flops, hbm_bytes, coll_bytes) -> "Roofline":
        r = cls(flops=flops, hbm_bytes=hbm_bytes, coll_bytes=coll_bytes)
        r.compute_s = flops / PEAK_FLOPS
        r.memory_s = hbm_bytes / HBM_BW
        r.collective_s = coll_bytes / LINK_BW
        terms = {"compute": r.compute_s, "memory": r.memory_s,
                 "collective": r.collective_s}
        r.dominant = max(terms, key=terms.get)
        return r

    @property
    def bound_s(self) -> float:
        """The least time of the step: its largest term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self):
        return {**dataclasses.asdict(self), "bound_s": self.bound_s}


def model_flops(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) for training;
    2 N D for a forward-only pass (prefill), 2 N per token for decode."""
    hd = cfg.hd
    n_mats = 3 if cfg.mlp_gated else 2
    if cfg.family == "moe":
        per_layer = (cfg.top_k * 3 * cfg.d_model * cfg.d_ff
                     + cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                     + cfg.n_heads * hd * cfg.d_model)
    elif cfg.family in ("ssm", "hybrid"):
        per_layer = (cfg.d_model * (2 * cfg.d_inner + 2 * cfg.ssm_state
                                    + cfg.ssm_heads)
                     + cfg.d_inner * cfg.d_model)
        if cfg.family == "hybrid" and cfg.attn_every:
            attn = (2 * cfg.d_model * cfg.d_model
                    + cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                    + cfg.n_heads * hd * cfg.d_model
                    + n_mats * cfg.d_model * cfg.d_ff)
            per_layer += attn / cfg.attn_every
    else:
        per_layer = (cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                     + cfg.n_heads * hd * cfg.d_model
                     + n_mats * cfg.d_model * cfg.d_ff)
    n_layers = cfg.n_layers
    if cfg.family == "encdec":
        n_layers = (cfg.n_enc_layers or cfg.n_layers) + \
            (cfg.n_dec_layers or cfg.n_layers)
    n_active = per_layer * n_layers + 2 * cfg.vocab * cfg.d_model
    tokens = shape.global_batch * (1 if kind == "decode" else shape.seq_len)
    mult = 6 if kind == "train" else 2
    return mult * n_active * tokens
