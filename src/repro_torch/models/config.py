"""Architecture configuration dataclass (a copy of ``repro.models.config``;
the port imports nothing from the reference)."""
from __future__ import annotations

import dataclasses
from typing import Optional


def pad_vocab(v: int, multiple: int = 128) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int                       # raw vocab (padded via vocab_padded)
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm: str = "rms"                # rms | layer
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # routed expert hidden dim
    capacity_factor: float = 1.25

    # --- MLA (deepseek v2/v3) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- hybrid (recurrentgemma) ---
    rglru_block: int = 0             # layers per super-block that are RG-LRU
    attn_window: int = 0             # local attention window (0 = global)
    lru_width: int = 0

    # --- enc-dec (whisper) ---
    enc_layers: int = 0
    enc_seq: int = 1500              # precomputed frame embeddings (stub)

    # --- vlm (paligemma) ---
    n_patches: int = 0               # precomputed patch embeddings (stub)

    # --- training ---
    microbatch: int = 8              # grad-accumulation microbatches per step
    remat: bool = True
    param_dtype: str = "float32"     # master-weight dtype (bf16 for the MoE
                                     # giants so params+momentum fit HBM)

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def d_inner(self) -> int:        # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (SSM / windowed-attention)."""
        return self.family in ("ssm", "hybrid")

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
