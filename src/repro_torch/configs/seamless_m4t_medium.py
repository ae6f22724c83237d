"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.

12L (x2: encoder+decoder) d_model=1024 16H (kv=16) d_ff=4096 vocab=256206
[arXiv:2308.11596].  The speech frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, S, d_model) to the encoder.
"""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="audio",
        n_layers=12,              # decoder layers
        encoder_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        block_pattern=("attn",),
        norm="layernorm",
        mlp_gated=False,          # fairseq-style GeLU MLP
        qkv_bias=True,
        frontend="audio",
        sub_quadratic=False,      # full attention -> long_500k skipped
    )
