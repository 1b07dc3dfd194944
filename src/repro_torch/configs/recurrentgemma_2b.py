"""RecurrentGemma-2B [arXiv:2402.19427]: RG-LRU + local attention, 1:2.
Super-blocks of [RG-LRU, RG-LRU, local attention over a 2,048-token
window], each sublayer followed by a SwiGLU MLP; 26 layers are 8
super-blocks and 2 tail RG-LRU layers."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, head_dim=256, d_ff=7680, vocab=256000,
    lru_width=2560, attn_window=2048, ssm_conv_width=4,
    tie_embeddings=True, microbatch=8,
)

SMOKE = CONFIG.with_(n_layers=6, d_model=64, n_heads=2, n_kv_heads=1,
                     head_dim=32, d_ff=128, vocab=512, lru_width=64,
                     attn_window=32, microbatch=1)
