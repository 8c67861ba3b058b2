"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 128 experts, top-8.
48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768 vocab=151936,
head_dim=128 (explicit, not d_model/n_heads)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=768, vocab=151936, head_dim=128,
    n_experts=128, top_k=8, rope_theta=1000000.0)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=32, vocab=128, head_dim=16, n_experts=8, top_k=2,
                     dtype="float32", remat=False)
