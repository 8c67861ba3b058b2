"""Granite-MoE-3B-A800M [hf:ibm-granite]: 40 experts, top-8.
32L d_model=1536 24H (GQA kv=8) per-expert d_ff=512 vocab=49155."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab=49155,
    n_experts=40, top_k=8)

SMOKE = CONFIG.with_(n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
                     d_ff=32, vocab=128, n_experts=5, top_k=2,
                     dtype="float32", remat=False)
