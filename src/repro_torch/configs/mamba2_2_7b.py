"""Mamba2-2.7B (SSD, attention-free) [arXiv:2405.21060]. 64 layers of one
Mamba2 mixer each (an RMS norm before it): one fused input projection to
x, z, B, C and dt, a depthwise causal conv over x, B and C, the SSD
chunked scan over 80 heads of 64 with a state of 128, and the output
projection; its decode cache is each layer's recurrent state and conv
history."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
    microbatch=8,
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, vocab=512, ssm_state=16,
                     ssm_head_dim=16, ssm_chunk=32, microbatch=1)
