"""granite-moe-1b-a400m [moe] — 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) expert d_ff=512 vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base].
"""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        block_pattern=("attn",),
        moe=True,
        n_experts=32,
        experts_per_token=8,
        moe_d_ff=512,
        shared_expert=False,
        capacity_factor=1.25,
        norm="rmsnorm",
        mlp_gated=True,
        tie_embeddings=True,
        sub_quadratic=False,
    )
