"""Granite-34B-Code [arXiv:2405.04324]: GPT-BigCode arch, MQA (kv=1),
non-gated GELU MLP.
88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense", n_layers=88, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab=49152, mlp_gated=False)

SMOKE = CONFIG.with_(n_layers=2, d_model=96, n_heads=6, n_kv_heads=1,
                     d_ff=256, vocab=128, dtype="float32", remat=False)
