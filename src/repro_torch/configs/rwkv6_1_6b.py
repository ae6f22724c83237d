"""rwkv6-1.6b (Finch) [ssm] — attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536, head_dim=64 (32 heads)
[arXiv:2404.05892].
"""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,               # d_model / rwkv_head_dim
        n_kv_heads=32,
        d_ff=7168,                # channel-mix hidden
        vocab_size=65536,
        block_pattern=("rwkv",),
        rwkv_head_dim=64,
        norm="layernorm",
        mlp_gated=False,          # RWKV channel-mix (squared ReLU)
        rope_kind="none",
        sub_quadratic=True,       # O(1) recurrent state -> long_500k runs
    )
