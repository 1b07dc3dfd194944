"""PaliGemma-3B backbone [arXiv:2407.07726]. The SigLIP frontend is a stub:
the caller provides 256 precomputed patch embeddings per image
(``prefix_embeds`` of ``lm.forward`` and ``lm.loss_fn``)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm", n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16384, vocab=257216,
    n_patches=256, tie_embeddings=True, microbatch=8,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1,
                     head_dim=32, d_ff=128, vocab=512, n_patches=8,
                     microbatch=1)
