"""DeepSeek-V2 236B MoE [arXiv:2405.04434]: MLA (kv_lora=512), 2 shared +
160 routed experts, top-6."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, head_dim=128, d_ff=1536, vocab=102400,
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
    use_mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128, microbatch=8, param_dtype="bfloat16",
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, head_dim=16,
                     d_ff=64, moe_d_ff=64, vocab=512, n_experts=8, top_k=2,
                     n_shared_experts=1, kv_lora_rank=32, qk_nope_dim=16,
                     qk_rope_dim=8, v_head_dim=16, microbatch=1)
