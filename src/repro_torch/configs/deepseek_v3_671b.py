"""DeepSeek-V3 671B MoE [arXiv:2412.19437]: MLA with q_lora, 1 shared +
256 routed experts, top-8. (MTP head omitted — see DESIGN.md.)"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv_heads=128, head_dim=128, d_ff=2048, vocab=129280,
    n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
    qk_rope_dim=64, v_head_dim=128, microbatch=8, param_dtype="bfloat16",
)

SMOKE = CONFIG.with_(n_layers=2, d_model=64, n_heads=4, head_dim=16,
                     d_ff=64, moe_d_ff=64, vocab=512, n_experts=8, top_k=2,
                     n_shared_experts=1, kv_lora_rank=32, q_lora_rank=32,
                     qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
                     microbatch=1)
