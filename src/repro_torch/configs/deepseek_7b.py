"""DeepSeek-7B (llama-arch) [arXiv:2401.02954]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b", family="dense", n_layers=30, d_model=4096,
    n_heads=32, n_kv_heads=32, head_dim=128, d_ff=11008, vocab=102400,
    microbatch=8,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     head_dim=16, d_ff=128, vocab=512, microbatch=1)
