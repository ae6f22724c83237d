"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution. 28L d_model=3584 28H
(GQA kv=4) d_ff=18944 vocab=152064 [arXiv:2409.12191].

Backbone only; the vision frontend is a STUB — input_specs() provides
precomputed patch embeddings plus 3D (t, h, w) M-RoPE position ids.
"""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        block_pattern=("attn",),
        qkv_bias=True,
        norm="rmsnorm",
        mlp_gated=True,
        rope_kind="mrope",
        mrope_sections=(16, 24, 24),   # head_dim/2 = 64 split over t/h/w
        rope_theta=1000000.0,
        frontend="vision",
        sub_quadratic=False,
    )
