"""Mamba2-130M [arXiv:2405.21060]: SSD (state-space duality), attn-free.
24L d_model=768 vocab=50280, ssm_state=128; sub-quadratic -> runs
long_500k."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    subquadratic=True, tie_embeddings=True)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, ssm_state=16, ssm_headdim=16,
                     ssm_chunk=8, vocab=128, dtype="float32", remat=False)
