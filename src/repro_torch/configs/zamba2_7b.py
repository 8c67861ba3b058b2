"""Zamba2-7B [arXiv:2411.15242]: Mamba2 stack + shared attention blocks.
81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Shared attn applied every 6 SSM layers (13 applications)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    attn_every=6, subquadratic=True)

SMOKE = CONFIG.with_(n_layers=7, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=128, vocab=128, ssm_state=16, ssm_headdim=16,
                     ssm_chunk=8, attn_every=3, dtype="float32", remat=False)
