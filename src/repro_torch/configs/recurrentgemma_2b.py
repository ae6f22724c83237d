"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 2:1 pattern.

26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000
[arXiv:2402.19427]
"""

from repro_torch.configs.base import ModelConfig, register


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        # Griffin: two recurrent blocks then one local-attention block.
        block_pattern=("rglru", "rglru", "local"),
        window=2048,
        norm="rmsnorm",
        mlp_gated=True,
        tie_embeddings=True,
        logit_softcap=30.0,
        rope_theta=10000.0,
        sub_quadratic=True,   # local attn + O(1) recurrent state -> long_500k
    )
