"""SeamlessM4T-large-v2 [arXiv:2308.11596]: enc-dec, multimodal.
24L d_model=1024 16H (kv=16, MHA) d_ff=8192 vocab=256206. Interpreted as
24 encoder + 24 decoder layers; the speech frontend is a STUB providing
precomputed frame embeddings (B, S, d)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192, vocab=256206,
    n_enc_layers=24, n_dec_layers=24, frontend="speech",
    n_frontend_tokens=2048)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     d_ff=128, vocab=128, n_enc_layers=2, n_dec_layers=2,
                     n_frontend_tokens=12, dtype="float32", remat=False)
