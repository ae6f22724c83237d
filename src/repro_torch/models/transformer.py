"""Config-driven decoder (``repro.models.transformer``'s counterpart).

The port covers decoder-only stacks of global (``attn``) and sliding-window
(``local``) attention layers and RG-LRU (``rglru``) layers, each with a dense
MLP (``parallel_block`` included) or a mixture of experts (``models.moe``,
under ``moe_strategy`` as in ``repro``: ``auto`` is dense, since the port
has no mesh), and RWKV6 (``rwkv``) layers with their channel-mix, under
standard or no rope. :func:`unsupported` names what a config needs beyond
that (encoder-decoder, M-RoPE).

The parameter tree is ``repro``'s, so converting weights is a copy: the
layers of each pattern unit sit under ``params["decoder"]["stack"]["u{j}"]``
with a leading unit axis, leftovers under ``["extra"]["x{j}"]``. Decode
states use the same layout. Where ``repro`` scans over units, this module
loops over them in Python. Decode writes each new K/V row into the caches,
and each new recurrent state into its tensors, in place and returns the same
tensors, instead of copying the states each step. A ``local`` layer's cache
is a ring of ``window`` rows (the next write at ``pos % window``); a global
layer's grows to the decode capacity (``serving.engine``).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models.layers import (
    COMPUTE_DTYPE, apply_mlp, apply_norm, apply_rope, embed_tokens,
    init_embeddings, init_mlp, init_norm, unembed,
)

VOCAB_QUANTUM = 128   # embeddings padded to a multiple (no vocab tail)
CONV_K = rec_lib.CONV_K
KINDS = ("attn", "local", "rglru", "rwkv")

Pos = Union[int, torch.Tensor]


def padded_vocab(cfg: ModelConfig) -> int:
    v = cfg.vocab_size
    return ((v + VOCAB_QUANTUM - 1) // VOCAB_QUANTUM) * VOCAB_QUANTUM


def unsupported(cfg: ModelConfig) -> Optional[str]:
    """Why this slice of the port cannot run ``cfg``, or None if it can."""
    kinds = set(cfg.layer_kinds())
    if kinds - set(KINDS):
        return f"layer kinds {sorted(kinds - set(KINDS))}"
    if cfg.is_encdec:
        return "encoder-decoder"
    if cfg.rope_kind not in ("standard", "none"):
        return f"rope kind {cfg.rope_kind!r}"
    return None


def _check(cfg: ModelConfig) -> None:
    why = unsupported(cfg)
    if why is not None:
        raise NotImplementedError(
            f"{cfg.name}: {why} are not ported yet (see ROADMAP.md)")


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------
def layer_plan(cfg: ModelConfig, encoder: bool = False) -> list:
    """[(kind, mlp_kind)] per layer.  Encoder layers are always attn+dense."""
    n = cfg.encoder_layers if encoder else cfg.n_layers
    out = []
    for i in range(n):
        kind = "attn" if encoder else cfg.block_kind(i)
        if kind == "rwkv":
            mlp_kind = "cmix"
        elif (not encoder and cfg.moe
              and (i + 1) % max(cfg.moe_interleave, 1) == 0):
            mlp_kind = "moe"
        else:
            mlp_kind = "dense"
        out.append((kind, mlp_kind))
    return out


def unit_cycle(cfg: ModelConfig, encoder: bool = False) -> int:
    if encoder:
        return 1
    c = len(cfg.block_pattern)
    if cfg.moe:
        c = math.lcm(c, max(cfg.moe_interleave, 1))
    return c


def decoder_layer_refs(cfg: ModelConfig) -> list:
    """Address of every decoder layer under ``params["decoder"]``, in layer
    order: ``group`` "stack" (``key`` ``u{j}``, ``index`` along the unit
    axis) or "extra" (``key`` ``x{j}``, ``index`` None). Decode states use
    the same addresses."""
    plan = layer_plan(cfg, encoder=False)
    cycle = unit_cycle(cfg)
    n_units = len(plan) // cycle
    refs = []
    for i, (kind, mlpk) in enumerate(plan):
        u, j = divmod(i, cycle)
        if u < n_units:
            refs.append({"kind": kind, "mlp_kind": mlpk, "group": "stack",
                         "key": f"u{j}", "index": u})
        else:
            refs.append({"kind": kind, "mlp_kind": mlpk, "group": "extra",
                         "key": f"x{i - n_units * cycle}", "index": None})
    return refs


# ---------------------------------------------------------------------------
# tree helpers
# ---------------------------------------------------------------------------
def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# The leaves ``repro`` reads in fp32, without a cast: every other leaf is
# cast to bf16 at use (``layers.cast``), so casting it once is the same.
# A key maps to None when its whole subtree is read in fp32, or to the set
# of its children that are.
FP32_READS = {
    # apply_norm reads scale and bias in fp32 (src/repro/models/layers.py:51-63)
    "norm1": None, "norm2": None, "final_norm": None,
    # the RG-LRU gates (src/repro/models/recurrent.py:76-86)
    "rglru": {"a_param", "in_gate_w", "in_gate_b", "rec_gate_w",
              "rec_gate_b"},
    # the RWKV6 decay and bonus (src/repro/models/recurrent.py:226-228, 315)
    # and ln_x, a layernorm (recurrent.py:189, 322-323)
    "rwkv": {"decay_w", "decay_lora_a", "decay_lora_b", "bonus_u", "ln_x"},
    # the MoE router (src/repro/models/moe.py:58)
    "moe": {"router"},
}


def cast_params(params: dict, device=None) -> dict:
    """The tree on ``device`` with every leaf that ``repro`` reads in fp32
    (``FP32_READS``) kept fp32 and every other leaf in bf16: the values the
    layers compute with, cast once instead of at every use."""
    def walk(tree, keep: bool):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                rule = FP32_READS.get(k, ())
                if rule is None:
                    out[k] = walk(v, True)
                elif rule and isinstance(v, dict):
                    out[k] = {c: walk(x, keep or c in rule)
                              for c, x in v.items()}
                else:
                    out[k] = walk(v, keep)
            return out
        if keep:
            return tree.to(device)
        return tree.to(device=device, dtype=COMPUTE_DTYPE)
    return walk(params, False)


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------
def init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str,
               mlp_kind: str, *, lead: tuple = ()) -> dict:
    if kind not in KINDS or mlp_kind not in (
            ("cmix",) if kind == "rwkv" else ("dense", "moe")):
        raise NotImplementedError(f"layer ({kind}, {mlp_kind})")
    dev = gen.device
    p: dict = {"norm1": init_norm(cfg.norm, cfg.d_model, lead=lead,
                                  device=dev)}
    if kind == "rwkv":
        p.update(rec_lib.init_rwkv(gen, cfg.d_model, cfg.n_heads,
                                   cfg.rwkv_head_dim, cfg.d_ff, lead=lead))
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, lead=lead, device=dev)
        return p
    if kind == "rglru":
        p["rglru"] = rec_lib.init_rglru(gen, cfg.d_model, lead=lead)
    else:
        p["attn"] = attn_lib.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            bias=cfg.qkv_bias, lead=lead)
    if not cfg.parallel_block:
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, lead=lead, device=dev)
    if mlp_kind == "moe":
        p["moe"] = moe_lib.init_moe(gen, cfg.d_model, cfg.n_experts,
                                    cfg.moe_d_ff, cfg.shared_expert,
                                    cfg.d_ff, lead=lead)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                            lead=lead)
    return p


def _rope(cfg: ModelConfig, q, k, positions):
    if cfg.rope_kind == "none":
        return q, k
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _self_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                    mode: str, cache: Optional[dict],
                    positions: torch.Tensor, pos: Pos, force: Optional[str]):
    """Self-attention for train / prefill / decode.  Returns (y, cache).

    In decode, ``pos`` is the write position: an int (every row at the same
    position) or a (B,) tensor (ragged decode, each row at its own). A
    ``local`` layer writes slot ``pos % window`` of its ring and attends
    ``min(pos + 1, window)`` slots."""
    q, k, v = attn_lib.qkv_proj(p, x)
    q, k = _rope(cfg, q, k, positions)
    if mode == "decode":
        kc, vc = cache["k"], cache["v"]
        slot, valid = pos, pos + 1
        if kind == "local":
            w = cfg.window
            slot = pos % w
            valid = torch.clamp(pos + 1, max=w) if torch.is_tensor(pos) \
                else min(pos + 1, w)
        if torch.is_tensor(pos) and pos.dim() == 1:
            rows = torch.arange(x.shape[0], device=x.device)
            kc[rows, slot] = k[:, 0].to(kc.dtype)
            vc[rows, slot] = v[:, 0].to(vc.dtype)
        else:
            kc[:, slot] = k[:, 0].to(kc.dtype)
            vc[:, slot] = v[:, 0].to(vc.dtype)
        o = attn_lib.decode_attention(q[:, 0], kc, vc, valid)
        return attn_lib.out_proj(p, o[:, None]), {"k": kc, "v": vc}
    if kind == "local":
        o = attn_lib.local_attention_prefill(q, k, v, window=cfg.window)
    else:
        o = attn_lib.prefill_attention(q, k, v, mask_kind="causal",
                                       force=force)
    y = attn_lib.out_proj(p, o)
    new_cache = None
    if mode == "prefill":
        k, v = k.to(COMPUTE_DTYPE), v.to(COMPUTE_DTYPE)
        if kind == "local":
            k, v = _ring(k, cfg.window), _ring(v, cfg.window)
        new_cache = {"k": k, "v": v}
    return y, new_cache


def _ring(t: torch.Tensor, w: int) -> torch.Tensor:
    """A prefill's (B, S, KV, dh) rows as a ring of ``w`` slots whose next
    write is slot ``S % w``: padded to ``w`` rows when S < w, else the last
    ``w`` rows rolled by ``S % w``."""
    s = t.shape[1]
    if s < w:
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, w - s))
    return torch.roll(t[:, -w:], s % w, dims=1).contiguous()


def _write_back(state: dict, new: dict) -> dict:
    """Decode updates a recurrent state in place (its tensors may be views
    into the stacked states) and returns the same tensors."""
    for name, t in new.items():
        state[name].copy_(t)
    return state


def apply_layer(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                mlp_kind: str, *, mode: str, state: Optional[dict],
                positions: torch.Tensor, pos: Pos, force: Optional[str],
                moe_strategy: str = "auto"):
    """One layer of ``kind`` with its ``mlp_kind`` MLP.  Returns (x,
    new_state)."""
    decode = mode == "decode"
    if kind == "rwkv":
        h = apply_norm(p["norm1"], x, cfg.norm)
        tm_state = ({"shift": state["shift"], "s": state["s"]}
                    if decode else None)
        y, tm_new = rec_lib.apply_rwkv_timemix(p["rwkv"], h, state=tm_state,
                                               decode=decode, force=force)
        x = x + y
        h = apply_norm(p["norm2"], x, cfg.norm)
        y, cm_new = rec_lib.apply_rwkv_channelmix(
            p["cmix"], h, state["cmix_shift"] if decode else None)
        new_state = {"shift": tm_new["shift"], "s": tm_new["s"],
                     "cmix_shift": cm_new}
        if decode:
            new_state = _write_back(state, new_state)
        return x + y, new_state
    h = apply_norm(p["norm1"], x, cfg.norm)
    if kind == "rglru":
        y, new_state = rec_lib.apply_rglru_block(
            p["rglru"], h, state=state if decode else None, decode=decode,
            force=force)
        if decode:
            new_state = _write_back(state, new_state)
    else:
        y, new_state = _self_attention(p["attn"], h, cfg, kind, mode, state,
                                       positions, pos, force)
    if cfg.parallel_block and mlp_kind == "dense":
        # cohere: out = x + attn(norm(x)) + mlp(norm(x))
        return x + y + apply_mlp(p["mlp"], h, cfg.mlp_gated,
                                 force=force), new_state
    x = x + y
    h = apply_norm(p["norm2"], x, cfg.norm)
    if mlp_kind == "moe":
        # the aux losses are for training; the forward does not return them
        y, _ = moe_lib.apply_moe(p["moe"], h, cfg.experts_per_token,
                                 cfg.capacity_factor, strategy=moe_strategy,
                                 force=force)
    else:
        y = apply_mlp(p["mlp"], h, cfg.mlp_gated, force=force)
    return x + y, new_state


def init_stack(gen: torch.Generator, cfg: ModelConfig) -> dict:
    plan = layer_plan(cfg)
    cycle = unit_cycle(cfg)
    n_units = len(plan) // cycle
    out: dict = {}
    if n_units:
        out["stack"] = {f"u{j}": init_layer(gen, cfg, *plan[j],
                                            lead=(n_units,))
                        for j in range(cycle)}
    extra = {f"x{j}": init_layer(gen, cfg, *plan[n_units * cycle + j])
             for j in range(len(plan) - n_units * cycle)}
    if extra:
        out["extra"] = extra
    return out


def apply_stack(stack_p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str, states: Optional[dict], positions: torch.Tensor,
                pos: Pos, force: Optional[str], moe_strategy: str = "auto"):
    """Every decoder layer in order.  Returns (x, new_states); new_states
    is None in train mode and, in decode, the input states updated."""
    plan = layer_plan(cfg)
    cycle = unit_cycle(cfg)
    n_units = len(plan) // cycle
    new_states: dict = {}

    def run(lp, layer, st):
        nonlocal x
        x, ns = apply_layer(lp, x, cfg, *layer, mode=mode, state=st,
                            positions=positions, pos=pos, force=force,
                            moe_strategy=moe_strategy)
        return ns

    if n_units:
        units = []
        for u in range(n_units):
            units.append({
                f"u{j}": run(_index(stack_p["stack"][f"u{j}"], u),
                             plan[j],
                             _index(states["stack"][f"u{j}"], u)
                             if mode == "decode" else None)
                for j in range(cycle)})
        if mode == "prefill":
            new_states["stack"] = _stack(units)
    if "extra" in stack_p:
        extra = {k: run(lp, plan[n_units * cycle + int(k[1:])],
                        states["extra"][k] if mode == "decode" else None)
                 for k, lp in stack_p["extra"].items()}
        if mode == "prefill":
            new_states["extra"] = extra
    if mode == "train":
        return x, None
    return x, (states if mode == "decode" else new_states)


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random fp32 params in ``repro``'s layout, drawn from ``generator``
    on its device; ``device``, if given, must be of the generator's type."""
    _check(cfg)
    if device is not None and \
            torch.device(device).type != generator.device.type:
        raise ValueError(f"generator is on {generator.device}, params "
                         f"were asked for on {device}")
    return {
        "embed": init_embeddings(generator, padded_vocab(cfg), cfg.d_model,
                                 cfg.tie_embeddings),
        "final_norm": init_norm(cfg.norm, cfg.d_model,
                                device=generator.device),
        "decoder": init_stack(generator, cfg),
    }


def _positions(b: int, s: int, offset: Pos, device) -> torch.Tensor:
    if torch.is_tensor(offset) and offset.dim() == 1:
        return offset[:, None]
    return (offset + torch.arange(s, device=device))[None, :].expand(b, s)


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig):
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = unembed(params["embed"], x, cfg.tie_embeddings,
                     cfg.logit_softcap)
    return _mask_vocab_pad(logits, cfg)


def forward(params: dict, cfg: ModelConfig, *, tokens: torch.Tensor,
            mode: str = "train", force: Optional[str] = None,
            moe_strategy: str = "auto"):
    """Full-sequence forward over (B, S) tokens.  Returns (logits, states):
    in prefill mode each layer's decode state (a global layer's (B, S) KV
    cache, a local layer's ring, a recurrent layer's state), None in train
    mode."""
    _check(cfg)
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward mode {mode!r}")
    b, s = tokens.shape
    x = embed_tokens(params["embed"], tokens, cfg.d_model)
    x, states = apply_stack(params["decoder"], x, cfg, mode=mode,
                            states=None,
                            positions=_positions(b, s, 0, tokens.device),
                            pos=None, force=force, moe_strategy=moe_strategy)
    return _logits(params, x, cfg), states


def _mask_vocab_pad(logits: torch.Tensor, cfg: ModelConfig):
    vp = padded_vocab(cfg)
    if vp == cfg.vocab_size:
        return logits
    idx = torch.arange(vp, device=logits.device)
    return torch.where(idx < cfg.vocab_size, logits,
                       torch.full((), -1e9, dtype=logits.dtype,
                                  device=logits.device))


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------
def _layer_state(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 lead: tuple, device) -> dict:
    """Zero decode state of one layer (of ``lead`` stacked layers)."""
    if kind == "rglru":
        return rec_lib.rglru_init_state(batch, cfg.d_model, lead=lead,
                                        device=device)
    if kind == "rwkv":
        return rec_lib.rwkv_init_state(batch, cfg.d_model, cfg.n_heads,
                                       cfg.rwkv_head_dim, lead=lead,
                                       device=device)
    s = min(cfg.window, max_len) if kind == "local" else max_len
    shape = lead + (batch, s, cfg.n_kv_heads, cfg.head_dim)
    return {n: torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)
            for n in ("k", "v")}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> dict:
    _check(cfg)
    plan = layer_plan(cfg)
    cycle = unit_cycle(cfg)
    n_units = len(plan) // cycle
    out: dict = {}
    if n_units:
        out["stack"] = {f"u{j}": _layer_state(cfg, plan[j][0], batch,
                                              max_len, (n_units,), device)
                        for j in range(cycle)}
    extra = {f"x{j}": _layer_state(cfg, plan[n_units * cycle + j][0], batch,
                                   max_len, (), device)
             for j in range(len(plan) - n_units * cycle)}
    if extra:
        out["extra"] = extra
    return out


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                pos: Pos, states: dict, force: Optional[str] = None,
                moe_strategy: str = "auto"):
    """One token per row: tokens (B,), written at ``pos`` (int, or (B,)
    tensor for ragged rows).  Returns (logits (B, V), states), the states
    updated in place."""
    b = tokens.shape[0]
    x = embed_tokens(params["embed"], tokens[:, None], cfg.d_model)
    x, states = apply_stack(params["decoder"], x, cfg, mode="decode",
                            states=states,
                            positions=_positions(b, 1, pos, tokens.device),
                            pos=pos, force=force, moe_strategy=moe_strategy)
    return _logits(params, x, cfg)[:, 0], states


# ---------------------------------------------------------------------------
# analytic parameter counts
# ---------------------------------------------------------------------------
def count_params_analytic(cfg: ModelConfig, active_only: bool = False,
                          include_embeddings: bool = True) -> int:
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nrm = d if cfg.norm == "rmsnorm" else 2 * d   # layernorm has a bias
    total = 0
    if include_embeddings:
        total += v * d
        if not cfg.tie_embeddings:
            total += d * v

    def attn_params():
        p = d * h * dh + 2 * d * kv * dh + h * dh * d
        if cfg.qkv_bias:
            p += h * dh + 2 * kv * dh
        return p

    def mlp_params():
        return (3 if cfg.mlp_gated else 2) * d * f

    def moe_params(active: bool):
        k = cfg.experts_per_token
        e = k if active else cfg.n_experts
        p = d * cfg.n_experts + e * 3 * d * cfg.moe_d_ff
        if cfg.shared_expert:
            p += 3 * d * f
        return p

    def rglru_params():
        w = d
        return 2 * d * w + w * d + CONV_K * w + 6 * w

    def rwkv_params():
        lora = 64
        tm = 4 * d * h * cfg.rwkv_head_dim + h * cfg.rwkv_head_dim * d \
            + d * lora + lora * h * cfg.rwkv_head_dim \
            + 2 * h * cfg.rwkv_head_dim + 5 * d + 2 * d
        cm = d * f + f * d + d * d + 2 * d
        return tm + cm

    for encoder in ([True] if cfg.is_encdec else []) + [False]:
        for kind, mlpk in layer_plan(cfg, encoder):
            total += nrm  # norm1
            if kind in ("attn", "local"):
                total += attn_params()
            elif kind == "rglru":
                total += rglru_params()
            elif kind == "rwkv":
                total += rwkv_params() + nrm
                continue
            if not encoder and cfg.is_encdec:
                total += attn_params() + nrm      # cross + its norm
            if not cfg.parallel_block:
                total += nrm                      # norm2
            if mlpk == "dense":
                total += mlp_params()
            elif mlpk == "moe":
                total += moe_params(active_only)
    total += nrm  # final norm
    if cfg.is_encdec:
        total += nrm
    return int(total)
