"""InternVL2-1B [arXiv:2404.16821]: InternViT + Qwen2-0.5B LM backbone.
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655. The ViT frontend is
a STUB: input_specs() provides precomputed patch embeddings (B, P, d)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, d_ff=4864, vocab=151655,
    frontend="vision", n_frontend_tokens=256, rope_theta=1000000.0)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=128, vocab=128, n_frontend_tokens=8,
                     dtype="float32", remat=False)
