"""Config-driven model (``repro.models.transformer``'s counterpart).

The port covers every config in ``configs/``: stacks of global (``attn``)
and sliding-window (``local``) attention layers and RG-LRU (``rglru``)
layers, each with a dense MLP (``parallel_block`` included) or a mixture of
experts (``models.moe``, under ``moe_strategy`` as in ``repro``: ``auto`` is
dense, since the port has no mesh), and RWKV6 (``rwkv``) layers with their
channel-mix; standard rope, no rope, or Qwen2-VL's M-RoPE, whose positions
are (B, S, 3) (t, h, w); and the encoder-decoder, whose encoder (one-layer
units of unmasked self-attention and a dense MLP) runs over ``src_embeds``
and whose decoder layers add a cross-attention block onto its output.
Encoder self-attention and cross-attention take the flash kernel's
unmasked form on the card, where ``repro`` computes both in plain
``chunked_attention``; decode's cross-attention reads the cached encoder
K/V (``ck``, ``cv``, ``clen``) in plain torch.

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
    COMPUTE_DTYPE, apply_mlp, apply_mrope, apply_norm, apply_rope, cast,
    embed_tokens, init_embeddings, init_mlp, init_norm, unembed,
)

VOCAB_QUANTUM = 128   # embeddings padded to a multiple (no vocab tail)
CONV_K = rec_lib.CONV_K
KINDS = ("attn", "local", "rglru", "rwkv")

Pos = Union[int, torch.Tensor]


def padded_vocab(cfg: ModelConfig) -> int:
    v = cfg.vocab_size
    return ((v + VOCAB_QUANTUM - 1) // VOCAB_QUANTUM) * VOCAB_QUANTUM


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
    "norm1": None, "norm2": None, "norm_cross": None, "final_norm": None,
    "enc_norm": None,
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
               mlp_kind: str, *, cross: bool = False,
               lead: tuple = ()) -> dict:
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
        if cross:
            p["norm_cross"] = init_norm(cfg.norm, cfg.d_model, lead=lead,
                                        device=dev)
            p["cross"] = {"attn": attn_lib.init_attention(
                gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                bias=cfg.qkv_bias, lead=lead)}
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
    if cfg.rope_kind == "mrope":
        return (apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def _self_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                    mode: str, cache: Optional[dict],
                    positions: torch.Tensor, pos: Pos, force: Optional[str],
                    causal: bool = True):
    """Self-attention for train / prefill / decode / chunk.  Returns (y,
    cache). An encoder layer (``causal`` False) attends unmasked.

    In decode, ``pos`` is the write position: an int (every row at the same
    position) or a (B,) tensor (ragged decode, each row at its own). A
    ``local`` layer writes slot ``pos % window`` of its ring and attends
    ``min(pos + 1, window)`` slots.

    In chunk mode (chunked prefill, global layers only) x is a (B, C, d)
    chunk at positions ``pos .. pos + C`` (an int or a 0-d tensor) of
    requests whose caches hold ``pos`` committed rows: the chunk's K/V go
    into rows ``[pos, pos + C)`` in place, and every row attends causally
    over the whole cache, so chunk by chunk gives the whole-prompt
    prefill's rows. Rows past the cache's end (the pad rows of a bucketed
    last chunk, never committed) land on its last row, which no real row
    of the chunk reads."""
    if mode == "chunk" and kind != "attn":
        raise ValueError("chunked prefill requires global attention layers")
    q, k, v = attn_lib.qkv_proj(p, x)
    q, k = _rope(cfg, q, k, positions)
    if mode == "chunk":
        kc, vc = cache["k"], cache["v"]
        rows = torch.clamp(torch.arange(x.shape[1], device=x.device) + pos,
                           max=kc.shape[1] - 1)
        kc.index_copy_(1, rows, k.to(kc.dtype))
        vc.index_copy_(1, rows, v.to(vc.dtype))
        o = attn_lib.chunk_prefill_attention(q, kc, vc, pos)
        return attn_lib.out_proj(p, o), {"k": kc, "v": vc}
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
        o = attn_lib.prefill_attention(
            q, k, v, mask_kind="causal" if causal else "none", force=force)
    y = attn_lib.out_proj(p, o)
    new_cache = None
    if mode == "prefill":
        k, v = k.to(COMPUTE_DTYPE), v.to(COMPUTE_DTYPE)
        if kind == "local":
            k, v = _ring(k, cfg.window), _ring(v, cfg.window)
        new_cache = {"k": k, "v": v}
    return y, new_cache


def _cross_attention(p: dict, x: torch.Tensor, mode: str,
                     cache: Optional[dict], enc_out: Optional[torch.Tensor],
                     force: Optional[str]):
    """Cross-attention onto the encoder output, with no rope.  Returns (y,
    cache): in prefill the encoder K/V it attended (``ck``, ``cv``) and
    their length (``clen``, int32); decode reads those back."""
    q = torch.einsum("...d,dhk->...hk", x, cast(p["attn"]["wq"]))
    if "bq" in p["attn"]:
        q = q + cast(p["attn"]["bq"])
    if mode == "decode":
        o = attn_lib.decode_attention(q[:, 0], cache["ck"], cache["cv"],
                                      cache["clen"])
        return attn_lib.out_proj(p["attn"], o[:, None]), cache
    k, v = attn_lib.kv_proj(p["attn"], enc_out)
    o = attn_lib.prefill_attention(q, k, v, mask_kind="none", force=force)
    y = attn_lib.out_proj(p["attn"], o)
    new_cache = None
    if mode == "prefill":
        new_cache = {"ck": k.to(COMPUTE_DTYPE), "cv": v.to(COMPUTE_DTYPE),
                     "clen": torch.full((), enc_out.shape[1],
                                        dtype=torch.int32, device=x.device)}
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
                moe_strategy: str = "auto", causal: bool = True,
                enc_out: Optional[torch.Tensor] = None):
    """One layer of ``kind`` with its ``mlp_kind`` MLP, and its
    cross-attention block onto ``enc_out`` where it has one.  Returns (x,
    new_state)."""
    if mode == "chunk" and kind != "attn":
        # a recurrent layer carries a running state, not a cache, and a
        # local ring rotates by the total length: neither replays a chunk
        raise ValueError(
            f"chunked prefill supports global-attention layers only "
            f"(got {kind!r})")
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
                                       positions, pos, force, causal)
    if cfg.parallel_block and mlp_kind == "dense":
        # cohere: out = x + attn(norm(x)) + mlp(norm(x))
        return x + y + apply_mlp(p["mlp"], h, cfg.mlp_gated,
                                 force=force), new_state
    x = x + y
    if "cross" in p:
        h = apply_norm(p["norm_cross"], x, cfg.norm)
        y, cr_new = _cross_attention(p["cross"], h, mode, state, enc_out,
                                     force)
        x = x + y
        if mode == "prefill":
            new_state.update(cr_new)
    h = apply_norm(p["norm2"], x, cfg.norm)
    if mlp_kind == "moe":
        # the aux losses are for training; the forward does not return them
        y, _ = moe_lib.apply_moe(p["moe"], h, cfg.experts_per_token,
                                 cfg.capacity_factor, strategy=moe_strategy,
                                 force=force)
    else:
        y = apply_mlp(p["mlp"], h, cfg.mlp_gated, force=force)
    return x + y, new_state


def init_stack(gen: torch.Generator, cfg: ModelConfig, *,
               encoder: bool = False, cross: bool = False) -> dict:
    plan = layer_plan(cfg, encoder)
    cycle = unit_cycle(cfg, encoder)
    n_units = len(plan) // cycle
    out: dict = {}
    if n_units:
        out["stack"] = {f"u{j}": init_layer(gen, cfg, *plan[j], cross=cross,
                                            lead=(n_units,))
                        for j in range(cycle)}
    extra = {f"x{j}": init_layer(gen, cfg, *plan[n_units * cycle + j],
                                 cross=cross)
             for j in range(len(plan) - n_units * cycle)}
    if extra:
        out["extra"] = extra
    return out


def apply_stack(stack_p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                mode: str, states: Optional[dict], positions: torch.Tensor,
                pos: Pos, force: Optional[str], moe_strategy: str = "auto",
                encoder: bool = False,
                enc_out: Optional[torch.Tensor] = None):
    """Every decoder layer (or, with ``encoder``, every encoder layer,
    unmasked) in order.  Returns (x, new_states); new_states is None in
    train mode and, in decode and chunk mode, the input states updated in
    place."""
    plan = layer_plan(cfg, encoder)
    carried = mode in ("decode", "chunk")
    cycle = unit_cycle(cfg, encoder)
    n_units = len(plan) // cycle
    new_states: dict = {}

    def run(lp, layer, st):
        nonlocal x
        x, ns = apply_layer(lp, x, cfg, *layer, mode=mode, state=st,
                            positions=positions, pos=pos, force=force,
                            moe_strategy=moe_strategy, causal=not encoder,
                            enc_out=enc_out)
        return ns

    if n_units:
        units = []
        for u in range(n_units):
            units.append({
                f"u{j}": run(_index(stack_p["stack"][f"u{j}"], u),
                             plan[j],
                             _index(states["stack"][f"u{j}"], u)
                             if carried else None)
                for j in range(cycle)})
        if mode == "prefill":
            new_states["stack"] = _stack(units)
    if "extra" in stack_p:
        extra = {k: run(lp, plan[n_units * cycle + int(k[1:])],
                        states["extra"][k] if carried else None)
                 for k, lp in stack_p["extra"].items()}
        if mode == "prefill":
            new_states["extra"] = extra
    if mode == "train":
        return x, None
    return x, (states if carried else new_states)


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random fp32 params in ``repro``'s layout, drawn from ``generator``
    on its device; ``device``, if given, must be of the generator's type.
    An encoder-decoder also has ``encoder`` and ``enc_norm``."""
    if device is not None and \
            torch.device(device).type != generator.device.type:
        raise ValueError(f"generator is on {generator.device}, params "
                         f"were asked for on {device}")
    params = {
        "embed": init_embeddings(generator, padded_vocab(cfg), cfg.d_model,
                                 cfg.tie_embeddings),
        "final_norm": init_norm(cfg.norm, cfg.d_model,
                                device=generator.device),
        "decoder": init_stack(generator, cfg, cross=cfg.is_encdec),
    }
    if cfg.is_encdec:
        params["encoder"] = init_stack(generator, cfg, encoder=True)
        params["enc_norm"] = init_norm(cfg.norm, cfg.d_model,
                                       device=generator.device)
    return params


def _positions(cfg: ModelConfig, b: int, s: int, offset: Pos,
               device) -> torch.Tensor:
    """The default positions of ``s`` tokens from ``offset`` (an int, a
    0-d tensor, or a (B,) tensor of per-row offsets): (B, S), or (B, S, 3)
    with equal (t, h, w) axes under M-RoPE."""
    if torch.is_tensor(offset) and offset.dim() == 1:
        pos = offset[:, None]
    else:
        pos = (offset + torch.arange(s, device=device))[None, :].expand(b, s)
    if cfg.rope_kind == "mrope":
        return pos[..., None].expand(*pos.shape, 3)
    return pos


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig):
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = unembed(params["embed"], x, cfg.tie_embeddings,
                     cfg.logit_softcap)
    return _mask_vocab_pad(logits, cfg)


def encode(params: dict, cfg: ModelConfig, src_embeds: torch.Tensor,
           force: Optional[str] = None,
           moe_strategy: str = "auto") -> torch.Tensor:
    """The encoder over (B, S_src, d) embeddings, cast to bf16: unmasked
    self-attention at rope positions ``0 .. S_src``, then ``enc_norm``."""
    b, s = src_embeds.shape[:2]
    x, _ = apply_stack(params["encoder"], src_embeds.to(COMPUTE_DTYPE), cfg,
                       mode="train", states=None,
                       positions=_positions(cfg, b, s, 0, src_embeds.device),
                       pos=None, force=force, moe_strategy=moe_strategy,
                       encoder=True)
    return apply_norm(params["enc_norm"], x, cfg.norm)


def forward(params: dict, cfg: ModelConfig, *,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            src_embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            mode: str = "train", force: Optional[str] = None,
            moe_strategy: str = "auto"):
    """Full-sequence forward over (B, S) ``tokens``, or over (B, S, d)
    ``embeds`` (cast to bf16, not scaled by sqrt(d)); an encoder-decoder
    also takes the encoder's (B, S_src, d) ``src_embeds``. ``positions``
    defaults to ``0 .. S`` ((B, S, 3) equal axes under M-RoPE). Returns
    (logits, states): in prefill mode each layer's decode state (a global
    layer's (B, S) KV cache, with a cross layer's encoder K/V and length, a
    local layer's ring, a recurrent layer's state), None in train mode."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward mode {mode!r}")
    enc_out = None
    if cfg.is_encdec:
        if src_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: forward "
                             f"needs src_embeds")
        enc_out = encode(params, cfg, src_embeds, force, moe_strategy)
    if embeds is not None:
        x = embeds.to(COMPUTE_DTYPE)
    else:
        x = embed_tokens(params["embed"], tokens, cfg.d_model)
    b, s = x.shape[:2]
    if positions is None:
        positions = _positions(cfg, b, s, 0, x.device)
    x, states = apply_stack(params["decoder"], x, cfg, mode=mode,
                            states=None, positions=positions, pos=None,
                            force=force, moe_strategy=moe_strategy,
                            enc_out=enc_out)
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
                 lead: tuple, device, enc_len: int = 0) -> dict:
    """Zero decode state of one layer (of ``lead`` stacked layers), with a
    cross layer's ``enc_len`` rows of encoder K/V and their length."""
    if kind == "rglru":
        return rec_lib.rglru_init_state(batch, cfg.d_model, lead=lead,
                                        device=device)
    if kind == "rwkv":
        return rec_lib.rwkv_init_state(batch, cfg.d_model, cfg.n_heads,
                                       cfg.rwkv_head_dim, lead=lead,
                                       device=device)
    s = min(cfg.window, max_len) if kind == "local" else max_len

    def zeros(rows):
        return torch.zeros(lead + (batch, rows, cfg.n_kv_heads, cfg.head_dim),
                           dtype=COMPUTE_DTYPE, device=device)
    st = {"k": zeros(s), "v": zeros(s)}
    if cfg.is_encdec:
        st.update(ck=zeros(enc_len), cv=zeros(enc_len),
                  clen=torch.zeros(lead, dtype=torch.int32, device=device))
    return st


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device=None, *, enc_len: int = 0) -> dict:
    """Zero decode states in the params' layout; an encoder-decoder's
    layers also hold ``enc_len`` rows of encoder K/V (``clen`` 0, so that a
    decode step before any prefill attends to no encoder row)."""
    plan = layer_plan(cfg)
    cycle = unit_cycle(cfg)
    n_units = len(plan) // cycle
    out: dict = {}
    if n_units:
        out["stack"] = {f"u{j}": _layer_state(cfg, plan[j][0], batch,
                                              max_len, (n_units,), device,
                                              enc_len)
                        for j in range(cycle)}
    extra = {f"x{j}": _layer_state(cfg, plan[n_units * cycle + j][0], batch,
                                   max_len, (), device, enc_len)
             for j in range(len(plan) - n_units * cycle)}
    if extra:
        out["extra"] = extra
    return out


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                pos: Pos, states: dict, force: Optional[str] = None,
                moe_strategy: str = "auto",
                positions: Optional[torch.Tensor] = None):
    """One token per row: tokens (B,), written at ``pos`` (int, or (B,)
    tensor for ragged rows) and turned by rope at ``positions`` ((B, 1),
    or (B, 1, 3) under M-RoPE; ``pos`` by default).  Returns (logits (B,
    V), states), the states updated in place."""
    b = tokens.shape[0]
    x = embed_tokens(params["embed"], tokens[:, None], cfg.d_model)
    if positions is None:
        positions = _positions(cfg, b, 1, pos, tokens.device)
    x, states = apply_stack(params["decoder"], x, cfg, mode="decode",
                            states=states, positions=positions, pos=pos,
                            force=force, moe_strategy=moe_strategy)
    return _logits(params, x, cfg)[:, 0], states


def prefill_chunk(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  pos: Pos, states: dict, force: Optional[str] = None,
                  moe_strategy: str = "auto",
                  positions: Optional[torch.Tensor] = None):
    """One prefill chunk: tokens (B, C) at positions ``[pos, pos + C)``
    (``pos`` an int or a 0-d long tensor), written into and attending over
    the decode-state caches ``states``. Returns (logits (B, C, V), states),
    the states updated in place. Chunk after chunk over a prompt, it leaves
    the caches and logits of a whole-prompt prefill, while no call costs
    more than one chunk. Pure global-attention stacks only; nothing reads
    ``pos`` on the host, so one CUDA graph per chunk shape serves every
    position. ``positions`` are the rope positions ((B, C), or (B, C, 3)
    under M-RoPE; ``pos ..`` by default)."""
    if cfg.is_encdec:
        raise ValueError("chunked prefill supports decoder-only models")
    b, c = tokens.shape
    x = embed_tokens(params["embed"], tokens, cfg.d_model)
    if positions is None:
        positions = _positions(cfg, b, c, pos, tokens.device)
    x, states = apply_stack(params["decoder"], x, cfg, mode="chunk",
                            states=states, positions=positions, pos=pos,
                            force=force, moe_strategy=moe_strategy)
    return _logits(params, x, cfg), states


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
