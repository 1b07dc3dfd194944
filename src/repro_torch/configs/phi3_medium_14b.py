"""Phi-3-medium 14B [arXiv:2404.14219]: RoPE + SwiGLU + GQA."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=10, head_dim=128, d_ff=17920, vocab=100352,
    microbatch=16,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=128, vocab=512, microbatch=1)
