"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936, QKV bias [hf:Qwen/Qwen1.5-0.5B]."""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        block_pattern=("attn",),
        qkv_bias=True,
        tie_embeddings=True,
        norm="rmsnorm",
        mlp_gated=True,
        rope_theta=1000000.0,
        sub_quadratic=False,
    )
