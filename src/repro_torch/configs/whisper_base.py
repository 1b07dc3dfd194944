"""Whisper-base encoder-decoder backbone [arXiv:2212.04356]. The
convolutional audio frontend is a stub: the caller provides 1,500
precomputed frame embeddings (``enc_embeds`` of ``lm.forward`` and
``lm.loss_fn``)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec", n_layers=6, d_model=512,
    n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048, vocab=51865,
    norm="layer", enc_layers=6, enc_seq=1500, microbatch=4,
)

SMOKE = CONFIG.with_(n_layers=2, enc_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
                     enc_seq=32, microbatch=1)
