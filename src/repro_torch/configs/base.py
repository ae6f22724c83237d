"""Model / shape / run configuration dataclasses and the arch registry."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (one instance per assigned arch)."""

    name: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # Layer pattern, repeated (and truncated) over n_layers.
    # Kinds: attn | local | rglru | rwkv
    block_pattern: tuple = ("attn",)
    window: int = 0                  # sliding-window size for `local`

    # MoE
    moe: bool = False
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_interleave: int = 1          # MoE on every k-th layer (llama4: 2)

    # Encoder-decoder (0 = decoder-only)
    encoder_layers: int = 0

    # Embedding / attention details
    rope_theta: float = 10000.0
    rope_kind: str = "standard"      # standard | mrope | none
    mrope_sections: tuple = (16, 24, 24)  # t/h/w split of head_dim/2
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    mlp_gated: bool = True           # SwiGLU vs plain GeLU MLP
    parallel_block: bool = False     # cohere-style parallel attn+mlp
    logit_softcap: float = 0.0

    # RWKV
    rwkv_head_dim: int = 64

    # Modality frontend stub ('audio' | 'vision' | None): input_specs()
    # provides precomputed frame/patch embeddings for these.
    frontend: Optional[str] = None

    # Can this arch run the 524288-token decode shape?
    sub_quadratic: bool = False

    # Megatron-style sequence parallelism for activations: residual stream
    # and norms sharded over `model` along the sequence dim (perf variant).
    seq_parallel_acts: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived ----------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def block_kind(self, layer_idx: int) -> str:
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    def layer_kinds(self) -> list:
        return [self.block_kind(i) for i in range(self.n_layers)]

    # ---- parameter / FLOP accounting --------------------------------------
    def param_count(self, *, reduced: bool = False) -> int:
        """Exact parameter count of our implementation of this config."""
        from repro_torch.models.transformer import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.transformer import count_params_analytic
        return count_params_analytic(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str    # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> list:
    """Valid (non-skipped) shape cells for an arch.

    long_500k needs sub-quadratic attention — skipped for pure
    full-attention archs (see DESIGN.md section 4).
    """
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        out.append(SHAPES["long_500k"])
    return out


def all_cells(cfg: ModelConfig) -> list:
    """All 4 assigned cells, with a skip marker where inapplicable."""
    valid = {s.name for s in shapes_for(cfg)}
    return [(SHAPES[n], n in valid) for n in
            ("train_4k", "prefill_32k", "decode_32k", "long_500k")]


# ---------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(fn: Callable[[], ModelConfig]):
    cfg = fn()
    _REGISTRY[cfg.name] = cfg
    return fn


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{sorted(_REGISTRY)}") from None


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        recurrentgemma_2b, seamless_m4t_medium, qwen1_5_0_5b,
        command_r_plus_104b, yi_34b, deepseek_7b, qwen2_vl_7b,
        rwkv6_1_6b, llama4_maverick_400b_a17b, granite_moe_1b_a400m,
    )


def reduced_config(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 64,
                   n_heads: int = 4, d_ff: int = 128, vocab: int = 256,
                   n_experts: int = 4) -> ModelConfig:
    """Family-preserving tiny config for CPU smoke tests."""
    kv = max(1, min(cfg.n_kv_heads, n_heads)) if cfg.n_kv_heads else 0
    if cfg.n_kv_heads and cfg.n_heads % cfg.n_kv_heads == 0:
        kv = max(1, n_heads // max(1, cfg.n_heads // cfg.n_kv_heads))
    pattern_span = len(cfg.block_pattern)
    layers = max(n_layers, pattern_span)
    half = (d_model // n_heads) // 2
    t_sec = half // 4
    h_sec = (half - t_sec) // 2
    sections = (t_sec, h_sec, half - t_sec - h_sec)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=layers,
        encoder_layers=min(cfg.encoder_layers, 2) if cfg.is_encdec else 0,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=kv,
        head_dim=d_model // n_heads,
        d_ff=d_ff,
        moe_d_ff=min(cfg.moe_d_ff, d_ff) if cfg.moe else 0,
        n_experts=min(cfg.n_experts, n_experts) if cfg.moe else 0,
        experts_per_token=(min(cfg.experts_per_token, n_experts)
                           if cfg.moe else 0),
        vocab_size=vocab,
        window=min(cfg.window, 64) if cfg.window else 0,
        rwkv_head_dim=16,
        mrope_sections=sections,
    )
