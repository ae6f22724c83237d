"""llama4-maverick-400b-a17b [moe] — MoE 128 experts top-1 + shared expert.

48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E lineage].  Early fusion: multimodal
tokens enter the same embedding stream (text-token dry-run shapes here).
"""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,                # shared-expert / dense-path hidden
        vocab_size=202048,
        block_pattern=("attn",),
        moe=True,
        n_experts=128,
        experts_per_token=1,
        moe_d_ff=8192,
        shared_expert=True,
        capacity_factor=1.25,
        moe_interleave=2,         # maverick alternates dense / MoE layers
        norm="rmsnorm",
        mlp_gated=True,
        rope_theta=500000.0,
        sub_quadratic=False,
    )
