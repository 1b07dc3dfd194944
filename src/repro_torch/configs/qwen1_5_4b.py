"""Qwen1.5-4B [hf:Qwen/Qwen1.5]: QKV bias."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
    n_heads=20, n_kv_heads=20, head_dim=128, d_ff=6912, vocab=151936,
    qkv_bias=True, microbatch=8,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                     head_dim=16, d_ff=128, vocab=512, microbatch=1)
