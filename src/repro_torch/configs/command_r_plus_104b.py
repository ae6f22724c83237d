"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000, no bias, cohere-style parallel blocks
[hf:CohereForAI/c4ai-command-r-v01]."""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=33792,
        vocab_size=256000,
        block_pattern=("attn",),
        qkv_bias=False,
        tie_embeddings=True,
        norm="layernorm",
        mlp_gated=True,
        parallel_block=True,
        rope_theta=75000000.0,
        sub_quadratic=False,
    )
