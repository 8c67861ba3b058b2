"""Yi-9B [arXiv:2403.04652]: llama-arch GQA.
48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b", family="dense", n_layers=48, d_model=4096,
    n_heads=32, n_kv_heads=4, d_ff=11008, vocab=64000)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=160, vocab=128, dtype="float32", remat=False)
