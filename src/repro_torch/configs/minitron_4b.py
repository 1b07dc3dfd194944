"""Minitron-4B (pruned Nemotron) [arXiv:2407.14679]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, head_dim=128, d_ff=9216, vocab=256000,
    microbatch=8,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=128, vocab=512, microbatch=1)
