"""yi-34b [dense] — llama-arch GQA. 60L d_model=7168 56H (kv=8)
d_ff=20480 vocab=64000 [arXiv:2403.04652]."""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        block_pattern=("attn",),
        norm="rmsnorm",
        mlp_gated=True,
        rope_theta=5000000.0,
        sub_quadratic=False,
    )
