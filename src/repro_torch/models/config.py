"""Architecture configuration shared by the whole model zoo (a copy of the
JAX package's, whose `param_dtype` is a `torch.dtype` here)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 -> d_model // n_heads

    # --- MoE ---------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) -------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4
    attn_every: int = 0       # hybrid: shared attn block after every N ssm

    # --- encoder-decoder ------------------------------------------------
    n_enc_layers: int = 0     # family == encdec: encoder depth
    n_dec_layers: int = 0     # family == encdec: decoder depth

    # --- modality frontend stubs ---------------------------------------
    frontend: str = ""        # "vision" | "speech" | "" (input_specs stub)
    n_frontend_tokens: int = 256  # patch / frame embeddings per sample

    # --- numerics / compilation ----------------------------------------
    mlp_gated: bool = True   # False: 2-matrix GELU MLP (GPT-BigCode style)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True        # checkpoint each layer in training
    # sub-quadratic attention available (SSM/hybrid) — gates long_500k
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (seq_len x global_batch + step kind)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
