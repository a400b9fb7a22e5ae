"""DeepSeek-V3-671B [moe] — 61L d_model=7168 128H (kv=128 via MLA)
d_ff_expert=2048 vocab=129280, MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437; hf]"""

from ..models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    block_pattern="mla_moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,  # dense d_ff of the first 3 layers in the real model;
    # all layers are modelled as MoE + shared expert, as the reference does
    vocab=129280,
    rope_theta=10_000.0,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(n_experts=256, n_shared=1, top_k=8, d_ff_expert=2048),
    mtp_depth=1,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=256,
        mla=MLAConfig(
            q_lora_rank=32,
            kv_lora_rank=16,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
        ),
        moe=MoEConfig(
            n_experts=8, n_shared=1, top_k=2, d_ff_expert=32,
            capacity_factor=4.0,  # loose: keeps smoke tests drop-free
        ),
        mtp_depth=1,
        dtype="float32",
    )
