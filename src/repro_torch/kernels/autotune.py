"""Tail-aware tile autotuning: pick kernel tiles from paper Eq. 3
(``repro.kernels.autotune``'s counterpart).

The planner (``core.tail_model``, Algorithm 2) puts a layer's width on a
wave edge of the *model*; the kernel still runs whatever tile its caller
passes, so the width can land mid-wave on the *kernel's* grid. This module
closes that gap: it scores each candidate tiling of a ``matmul``,
``flash_attention`` or ``moe_gmm`` call by the roofline and Eq. 3's waves,
and picks one whose grid lands on full waves where one exists. A spec's
type chooses the form, as ``tail_model.model_for`` does:

* **A TPU spec** (``HardwareSpec``): ``repro``'s cost model unchanged, so
  every ``TileConfig`` field equals ``repro``'s for the same spec, shape
  and dtype. Block edges from ``_M_EDGES`` / ``_LANE_EDGES``, the VMEM
  budget (operand blocks double-buffered, the fp32 accumulator and the
  output block), and ``GridWaveModel``'s Eq. 3 over ``cores_per_chip``.
* **A GPU spec** (``gpu.GpuSpec``): the port's own CUDA tiles. The
  candidates are the tiles the kernel has (``matmul_tiled.PREFILL_TILES``
  at M > ``DECODE_BLOCK_M``, else the decode form's one tile; the flash
  kernel's one 64 x 64 tile). A candidate is admitted when its form's
  shared memory (``matmul_tiled.FORMS``) fits an SM (``smem_per_sm``).
  For a GEMM

      B         = matmul_tiled.grid_blocks(m, n, k, tile)
                  (moe_gmm.grid_blocks with experts)
      W         = ceil(B / (S * c))   S = hw.cores_per_chip SMs, c the
                                      form's CTAs an SM
                                      (tail_model.EFFECTIVE_CTAS_PER_SM: 1
                                      at prefill, 3 at decode)
      dL        = c x one CTA's FLOPs / (peak / S)
                  / TILE_EFFICIENCY[form, tile]
      compute_s = W * dL
      memory_s  = padded bytes (each padded operand read once, the padded
                  output written once: CtaWaveModel's bytes) / bandwidth
      latency_s = max(compute_s, memory_s)
      tail_free = M, N, K divide the tile (K its 64-deep stage, or the
                  decode form's SPLIT_K chunk) and B % (S * c) == 0

  ``vmem_bytes`` holds the form's dynamic shared memory, ``blocks`` the
  tile (rows, columns) that ``ops.matmul(tile=)`` takes.

Selection (``_select``, both forms): tail-free configs first when any
exist, then (latency_s, padded_flops, grid_blocks, blocks): a pure function
of (hardware, shape, dtype), so the pick is deterministic per spec.

Configs are memoized in-process per (hardware fingerprint, kernel, shape,
dtype) and optionally persisted through ``ProfileTableCache``
(``get_tiles`` / ``put_tiles``), so a serving process re-resolves tiles
from disk instead of re-enumerating candidates.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.gpu import is_gpu
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.table_cache import ProfileTableCache, \
    hardware_fingerprint
from repro_torch.core.tail_model import (EFFECTIVE_CTAS_PER_SM,
                                         GridWaveModel, ceil_div)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul_tiled as mt
from repro_torch.kernels import moe_gmm as mg

__all__ = [
    "TileConfig", "autotune_matmul", "autotune_flash_attention",
    "autotune_moe_gmm", "clear_memo", "memo_stats", "TILE_EFFICIENCY",
    "gemm_candidates", "gemm_tile_picks", "tile_rate",
]

# Candidate block edges of the TPU form. Multiples of the MXU/VPU tiles (8
# sublanes x 128 lanes); the selection cost model prunes what VMEM can't
# hold.
_M_EDGES = (8, 16, 32, 64, 128, 256, 512, 1024)
_LANE_EDGES = (128, 256, 512, 1024)

# The GPU form's share of one SM's bf16 peak that a CTA of each (form,
# tile) reaches; dL divides by it. Pure Eq. 3 (1.0 for every tile) picked
# the 64-row tile wherever it halves a wave, and the card found it 14-25 %
# slower there (a 64 x 64 CTA reads twice the shared-memory bytes per
# operation of a 128 x 64 one, and a 256 x 64 CTA half): the per-CTA rates
# differ too much for one constant. Each prefill value is the median, over
# the seven main-path prefill shapes of ``chip_smoke.py --tiles``, of
# Eq. 3's compute time at the full peak over the tile's measured time, on
# an NVIDIA H100 80GB HBM3 at a 700.00 W power limit. The decode form has
# one tile, so no pick depends on its value.
TILE_EFFICIENCY = {("prefill", (64, 64)): 0.245,
                   ("prefill", (128, 64)): 0.335,
                   ("prefill", (256, 64)): 0.443,
                   ("decode", mt.DECODE_TILE): 1.0}


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One scored tiling of one kernel invocation shape."""

    kernel: str                 # "matmul" | "flash_attention" | "moe_gmm"
    blocks: tuple[int, ...]     # kernel block args, kernel-specific order
    grid: tuple[int, ...]       # resulting kernel grid
    grid_blocks: int            # B of Eq. 3 (product of grid)
    waves: int                  # W = ceil(B / slots)
    tail_free: bool             # no padded lanes, no partial last wave
    latency_s: float            # max(Eq. 3 compute, roofline memory)
    padded_flops: float         # FLOPs actually executed incl. padding
    vmem_bytes: int             # per-core working set of this tiling (a
    #                             GPU spec: the CTA's shared memory)


# In-process memo: (hw fingerprint, kernel, shape, dtype_bits) -> TileConfig.
_MEMO: dict = {}


def clear_memo() -> None:
    _MEMO.clear()


def memo_stats() -> dict:
    """Observability for the in-process memo: entry counts per kernel and
    how many memoized grids are tail-free."""
    per_kernel: dict[str, int] = {}
    tail_free = 0
    for (_, kernel, _, _), cfg in _MEMO.items():
        per_kernel[kernel] = per_kernel.get(kernel, 0) + 1
        tail_free += bool(cfg.tail_free)
    return {"entries": len(_MEMO), "tail_free": tail_free,
            "per_kernel": per_kernel}


def _select(cands: Sequence[TileConfig]) -> TileConfig:
    """Prefer tail-free tilings when any exist; break ties
    deterministically (latency, padded work, grid size, block tuple)."""
    pool = [c for c in cands if c.tail_free] or list(cands)
    return min(pool, key=lambda c: (c.latency_s, c.padded_flops,
                                    c.grid_blocks, c.blocks))


def _edge_candidates(dim: int, edges: Sequence[int]) -> list[int]:
    """Block candidates for one padded dim: every edge not uselessly
    larger than the dim (one block covering the dim is kept once)."""
    out = [e for e in edges if e < 2 * dim or e == edges[0]]
    return out or [edges[0]]


def _divisor_candidates(dim: int, edges: Sequence[int],
                        cap: int) -> list[int]:
    """Block candidates for a dim the kernel requires to divide evenly:
    the edges that divide ``dim``, plus ``dim`` itself when small."""
    out = [e for e in edges if dim % e == 0]
    if dim <= cap and dim not in out:
        out.append(dim)
    return out


# ---- the TPU form: repro's per-kernel cost models --------------------------

def _matmul_config(hw: HardwareSpec, m: int, n: int, k: int,
                   bm: int, bn: int, bk: int,
                   dtype_bits: int) -> Optional[TileConfig]:
    bpe = dtype_bits // 8
    vmem = 2 * (bm * bk + bk * bn) * bpe + bm * bn * (4 + bpe)
    if vmem > hw.vmem_bytes:
        return None
    gm, gn, gk = ceil_div(m, bm), ceil_div(n, bn), ceil_div(k, bk)
    blocks = gm * gn * gk
    cell_flops = 2.0 * bm * bn * bk
    wave = GridWaveModel(hw, cell_flops).evaluate(blocks)
    # Padded HBM traffic: each x tile is read once per n-block, each w
    # tile once per m-block, the output written once.
    total_bytes = ((gm * bm) * (gk * bk) * gn
                   + (gk * bk) * (gn * bn) * gm
                   + (gm * bm) * (gn * bn)) * bpe
    latency = max(wave.latency_s, total_bytes / hw.hbm_bandwidth)
    tail_free = (m % bm == 0 and n % bn == 0 and k % bk == 0
                 and blocks % hw.cores_per_chip == 0)
    return TileConfig(
        kernel="matmul", blocks=(bm, bn, bk), grid=(gm, gn, gk),
        grid_blocks=blocks, waves=wave.waves, tail_free=tail_free,
        latency_s=latency, padded_flops=cell_flops * blocks,
        vmem_bytes=vmem)


def _matmul_candidates(hw: HardwareSpec, shape, dtype_bits: int):
    m, n, k = shape
    out = []
    for bm in _edge_candidates(m, _M_EDGES):
        for bn in _edge_candidates(n, _LANE_EDGES):
            for bk in _edge_candidates(k, _LANE_EDGES):
                cfg = _matmul_config(hw, m, n, k, bm, bn, bk, dtype_bits)
                if cfg is not None:
                    out.append(cfg)
    if not out:
        out.append(_force_config(
            _matmul_config, hw, (m, n, k),
            (min(256, m), min(256, n), min(512, k)), dtype_bits))
    return out


def _flash_config(hw: HardwareSpec, b: int, sq: int, skv: int, h: int,
                  kv_heads: int, dh: int, bq: int, bkv: int,
                  dtype_bits: int) -> Optional[TileConfig]:
    bpe = dtype_bits // 8
    # q block + double-buffered k/v blocks + fp32 scores, stats and
    # accumulator scratch + output block.
    vmem = (bq * dh * bpe + 2 * 2 * (bkv * dh) * bpe
            + bq * bkv * 4 + bq * dh * 4 + 2 * bq * 4 + bq * dh * bpe)
    if vmem > hw.vmem_bytes:
        return None
    gq, gkv = ceil_div(sq, bq), ceil_div(skv, bkv)
    blocks = b * h * gq * gkv
    cell_flops = 4.0 * bq * bkv * dh
    wave = GridWaveModel(hw, cell_flops).evaluate(blocks)
    # q and the output move once; k/v blocks are re-fetched per q block
    # (the kernel's kv index map changes every innermost step).
    total_bytes = (2 * b * h * sq * dh + 2 * b * h * gq * skv * dh) * bpe
    latency = max(wave.latency_s, total_bytes / hw.hbm_bandwidth)
    tail_free = (sq % bq == 0 and skv % bkv == 0
                 and blocks % hw.cores_per_chip == 0)
    return TileConfig(
        kernel="flash_attention", blocks=(bq, bkv),
        grid=(b * h, gq, gkv), grid_blocks=blocks, waves=wave.waves,
        tail_free=tail_free, latency_s=latency,
        padded_flops=cell_flops * blocks, vmem_bytes=vmem)


def _flash_candidates(hw: HardwareSpec, shape, dtype_bits: int):
    b, sq, skv, h, kv_heads, dh = shape
    out = []
    # The kernel requires divisibility, so only divisor blocks are legal
    # without padding (repro's ops.flash_attention pads otherwise).
    for bq in _divisor_candidates(sq, (16, 32, 64, 128, 256, 512, 1024),
                                  cap=2048):
        for bkv in _divisor_candidates(skv,
                                       (128, 256, 512, 1024), cap=2048):
            cfg = _flash_config(hw, b, sq, skv, h, kv_heads, dh,
                                bq, bkv, dtype_bits)
            if cfg is not None:
                out.append(cfg)
    if not out:
        out.append(_force_config(
            _flash_config, hw, (b, sq, skv, h, kv_heads, dh),
            (min(512, sq), min(512, skv)), dtype_bits))
    return out


def _moe_config(hw: HardwareSpec, e: int, c: int, d: int, f: int,
                bc: int, bf: int, bd: int,
                dtype_bits: int) -> Optional[TileConfig]:
    bpe = dtype_bits // 8
    vmem = 2 * (bc * bd + bd * bf) * bpe + bc * bf * (4 + bpe)
    if vmem > hw.vmem_bytes:
        return None
    gc, gf, gd = ceil_div(c, bc), ceil_div(f, bf), ceil_div(d, bd)
    blocks = e * gc * gf * gd
    cell_flops = 2.0 * bc * bf * bd
    wave = GridWaveModel(hw, cell_flops).evaluate(blocks)
    total_bytes = e * ((gc * bc) * (gd * bd) * gf
                       + (gd * bd) * (gf * bf) * gc
                       + (gc * bc) * (gf * bf)) * bpe
    latency = max(wave.latency_s, total_bytes / hw.hbm_bandwidth)
    tail_free = (c % bc == 0 and f % bf == 0 and d % bd == 0
                 and blocks % hw.cores_per_chip == 0)
    return TileConfig(
        kernel="moe_gmm", blocks=(bc, bf, bd), grid=(e, gc, gf, gd),
        grid_blocks=blocks, waves=wave.waves, tail_free=tail_free,
        latency_s=latency, padded_flops=cell_flops * blocks,
        vmem_bytes=vmem)


def _moe_candidates(hw: HardwareSpec, shape, dtype_bits: int):
    e, c, d, f = shape
    out = []
    for bc in _edge_candidates(c, _M_EDGES):
        for bf in _edge_candidates(f, _LANE_EDGES):
            for bd in _edge_candidates(d, _LANE_EDGES):
                cfg = _moe_config(hw, e, c, d, f, bc, bf, bd, dtype_bits)
                if cfg is not None:
                    out.append(cfg)
    if not out:
        out.append(_force_config(
            _moe_config, hw, (e, c, d, f),
            (min(128, c), min(256, f), min(256, d)), dtype_bits))
    return out


def _force_config(config_fn, hw, shape, blocks, dtype_bits) -> TileConfig:
    """Build the clamped-defaults config ignoring the VMEM filter — the
    last resort when no candidate fits (degenerate HardwareSpecs)."""
    big = dataclasses.replace(hw, vmem_bytes=1 << 62)
    return config_fn(big, *shape, *blocks, dtype_bits)


# ---- the GPU form: the port's CUDA tiles -----------------------------------

def _gemm_tiles(m: int) -> tuple:
    """The tiles a GEMM of m rows can launch: the prefill tiles, or the
    decode form's one tile at m <= DECODE_BLOCK_M."""
    return (mt.DECODE_TILE,) if m <= mt.DECODE_BLOCK_M else mt.PREFILL_TILES


def gemm_candidates(hw, m: int, k: int) -> tuple:
    """The tiles a GEMM of m rows over K = k may take on GPU spec ``hw``:
    its form's tiles whose shared memory fits an SM, smallest first. N
    plays no part."""
    kind = "decode" if mt.kernel_form(m, k)[0] else "prefill"
    return tuple(t for t in _gemm_tiles(m)
                 if mt.FORMS[kind, t]["smem_bytes"] <= hw.smem_per_sm)


def tile_rate(m: int, k: int, tile) -> float:
    """A CTA's share of an SM's peak on ``tile`` in the form an (m, k)
    GEMM takes (``TILE_EFFICIENCY``): the rate at which
    ``tail_model.CtaWaveModel`` with ``tile_hw`` prices that tile, as the
    GPU form here does."""
    kind = "decode" if mt.kernel_form(m, k)[0] else "prefill"
    return TILE_EFFICIENCY[kind, tuple(tile)]


def _gpu_gemm_scores(kernel: str, hw, e: int, m: int, n, k: int,
                     tile, dtype_bits: int) -> Optional[dict]:
    """Eq. 3 over one GEMM tile (e experts; matmul is e = 1) at every
    width of ``n`` (int64 array): ``TileConfig``'s fields as arrays, or
    None where the tile is not a candidate. The one scorer of the GPU
    form: ``autotune_matmul`` / ``autotune_moe_gmm`` score one width
    through it, ``gemm_tile_picks`` a sweep."""
    tile = tuple(tile)
    if tile not in gemm_candidates(hw, m, k):
        return None
    bm, bn = tile
    decode, chunks = mt.kernel_form(m, k)
    kind = "decode" if decode else "prefill"
    c = EFFECTIVE_CTAS_PER_SM[kind]
    slots = hw.cores_per_chip * c
    # B = g x column tiles: grid_blocks is linear in the column tiles
    g = mt.grid_blocks(m, 1, k, tile) if kernel == "matmul" \
        else mg.grid_blocks(e, m, 1, k, tile)
    n = np.asarray(n, dtype=np.int64)
    gm, gn = ceil_div(m, bm), -(-n // bn)
    blocks = g * gn
    k_step = mt.SPLIT_K if decode else mt.BLOCK_K
    k_cta = mt.SPLIT_K if decode else ceil_div(k, mt.BLOCK_K) * mt.BLOCK_K
    cta_flops = 2.0 * bm * bn * k_cta
    waves = -(-blocks // slots)
    dl = c * cta_flops * hw.cores_per_chip / hw.peak_flops_bf16 \
        / TILE_EFFICIENCY[kind, tile]
    k_pad = chunks * k_cta
    elems = (gm * bm) * k_pad + k_pad * (gn * bn) + (gm * bm) * (gn * bn)
    total_bytes = e * elems * (dtype_bits // 8)
    return {"kind": kind, "grid": (gm, gn, chunks), "blocks": blocks,
            "waves": waves,
            "latency_s": np.maximum(waves * dl,
                                    total_bytes / hw.hbm_bandwidth),
            "tail_free": ((m % bm == 0) & (n % bn == 0) & (k % k_step == 0)
                          & (blocks % slots == 0)),
            "padded_flops": cta_flops * blocks}


def gemm_tile_picks(kernel: str, hw, e: int, m: int, k: int, n,
                    dtype_bits: int = 16) -> tuple:
    """The autotuner's pick at every width of ``n`` at once: (the
    candidate tiles, an index into them per width), by ``_select``'s rule
    over ``_gpu_gemm_scores``. ``autotune_matmul(hw, m, n_i, k)`` (and
    ``autotune_moe_gmm``) pick the same tile at each width;
    ``tail_model.CtaWaveModel`` prices its sweeps on these picks."""
    tiles = gemm_candidates(hw, m, k)
    if not tiles:
        raise ValueError(f"no GEMM tile of M={m} K={k} fits {hw.name}")
    n = np.asarray(n, dtype=np.int64)
    scores = [_gpu_gemm_scores(kernel, hw, e, m, n, k, t, dtype_bits)
              for t in tiles]
    any_tf = np.logical_or.reduce([s["tail_free"] for s in scores])
    pick = np.full(n.shape, -1, dtype=np.int64)
    lat = np.zeros(n.shape)
    pf = np.zeros(n.shape)
    blk = np.zeros(n.shape, dtype=np.int64)
    # tiles ascend, so a full tie keeps the smaller tile, as _select does
    for i, s in enumerate(scores):
        ok = s["tail_free"] | ~any_tf
        less = (s["latency_s"] < lat) | ((s["latency_s"] == lat) & (
            (s["padded_flops"] < pf) | ((s["padded_flops"] == pf)
                                        & (s["blocks"] < blk))))
        take = ok & ((pick < 0) | less)
        pick = np.where(take, i, pick)
        lat = np.where(take, s["latency_s"], lat)
        pf = np.where(take, s["padded_flops"], pf)
        blk = np.where(take, s["blocks"], blk)
    return tiles, pick


def _gpu_gemm_config(kernel: str, hw, e: int, m: int, n: int, k: int,
                     bm: int, bn: int,
                     dtype_bits: int) -> Optional[TileConfig]:
    """Score one GEMM tile on a GPU spec at one width."""
    s = _gpu_gemm_scores(kernel, hw, e, m, np.array([n]), k, (bm, bn),
                         dtype_bits)
    if s is None:
        return None
    gm, gn, chunks = s["grid"]
    grid = (gm, int(gn[0]), chunks)
    return TileConfig(
        kernel=kernel, blocks=(bm, bn),
        grid=grid if kernel == "matmul" else (e,) + grid,
        grid_blocks=int(s["blocks"][0]), waves=int(s["waves"][0]),
        tail_free=bool(s["tail_free"][0]),
        latency_s=float(s["latency_s"][0]),
        padded_flops=float(s["padded_flops"][0]),
        vmem_bytes=mt.FORMS[s["kind"], (bm, bn)]["smem_bytes"])


def _gpu_matmul_config(hw, m: int, n: int, k: int, bm: int, bn: int,
                       dtype_bits: int) -> Optional[TileConfig]:
    return _gpu_gemm_config("matmul", hw, 1, m, n, k, bm, bn, dtype_bits)


def _gpu_matmul_candidates(hw, shape, dtype_bits: int):
    m, n, k = shape
    return [cfg for bm, bn in _gemm_tiles(m)
            if (cfg := _gpu_matmul_config(hw, m, n, k, bm, bn,
                                          dtype_bits)) is not None]


def _gpu_moe_config(hw, e: int, c: int, d: int, f: int, bc: int, bf: int,
                    dtype_bits: int) -> Optional[TileConfig]:
    return _gpu_gemm_config("moe_gmm", hw, e, c, f, d, bc, bf, dtype_bits)


def _gpu_moe_candidates(hw, shape, dtype_bits: int):
    e, c, d, f = shape
    return [cfg for bc, bf in _gemm_tiles(c)
            if (cfg := _gpu_moe_config(hw, e, c, d, f, bc, bf,
                                       dtype_bits)) is not None]


def _gpu_flash_config(hw, b: int, sq: int, skv: int, h: int, kv_heads: int,
                      dh: int, bq: int, bkv: int,
                      dtype_bits: int) -> Optional[TileConfig]:
    """The flash kernel's one tile: one CTA per (batch x head, 64 query
    rows), its form's CTAs an SM (``flash_attention.FORMS``)."""
    if (bq, bkv) != (fa.BLOCK_Q, fa.BLOCK_KV) or dh not in fa.FORMS:
        return None
    form = fa.FORMS[dh]
    if form["smem_bytes"] > hw.smem_per_sm:
        return None
    c = form["ctas_per_sm"]
    slots = hw.cores_per_chip * c
    gq, gkv = ceil_div(sq, bq), ceil_div(skv, bkv)
    blocks = fa.grid_blocks(b, sq, h)
    cta_flops = 4.0 * bq * (gkv * bkv) * dh
    waves = ceil_div(blocks, slots)
    dl = c * cta_flops * hw.cores_per_chip / hw.peak_flops_bf16
    # q and the output move once; k and v once (the L2 holds them across
    # the query blocks of a head)
    total_bytes = (2 * b * h * gq * bq * dh
                   + 2 * b * kv_heads * gkv * bkv * dh) * (dtype_bits // 8)
    latency = max(waves * dl, total_bytes / hw.hbm_bandwidth)
    tail_free = sq % bq == 0 and skv % bkv == 0 and blocks % slots == 0
    return TileConfig(
        kernel="flash_attention", blocks=(bq, bkv), grid=(b * h, gq, 1),
        grid_blocks=blocks, waves=waves, tail_free=tail_free,
        latency_s=latency, padded_flops=cta_flops * blocks,
        vmem_bytes=form["smem_bytes"])


def _gpu_flash_candidates(hw, shape, dtype_bits: int):
    cfg = _gpu_flash_config(hw, *shape, fa.BLOCK_Q, fa.BLOCK_KV, dtype_bits)
    if cfg is None:
        raise ValueError(f"flash_attention has no tile for {shape} on "
                         f"{hw.name}")
    return [cfg]


_KERNELS = {
    "matmul": _matmul_candidates,
    "flash_attention": _flash_candidates,
    "moe_gmm": _moe_candidates,
}
_SCORE = {"matmul": _matmul_config, "flash_attention": _flash_config,
          "moe_gmm": _moe_config}
_GPU_KERNELS = {
    "matmul": _gpu_matmul_candidates,
    "flash_attention": _gpu_flash_candidates,
    "moe_gmm": _gpu_moe_candidates,
}
_GPU_SCORE = {"matmul": _gpu_matmul_config,
              "flash_attention": _gpu_flash_config,
              "moe_gmm": _gpu_moe_config}


def _candidates(kernel: str, hw, shape, dtype_bits: int):
    table = _GPU_KERNELS if is_gpu(hw) else _KERNELS
    return table[kernel](hw, shape, dtype_bits)


def _autotune(kernel: str, hw: HardwareSpec, shape: tuple[int, ...],
              dtype_bits: int,
              cache: Optional[ProfileTableCache]) -> TileConfig:
    key = (hardware_fingerprint(hw), kernel, shape, dtype_bits)
    cfg = _MEMO.get(key)
    if cfg is not None:
        return cfg
    if cache is not None:
        blocks = cache.get_tiles(hw, kernel, shape + (dtype_bits,))
        if blocks is not None:
            # Re-score the persisted blocks (cheap) so the returned
            # TileConfig carries fresh grid/latency fields.
            cfg = _score_blocks(kernel, hw, shape, tuple(blocks),
                                dtype_bits)
            _MEMO[key] = cfg
            return cfg
    cfg = _select(_candidates(kernel, hw, shape, dtype_bits))
    _MEMO[key] = cfg
    if cache is not None:
        cache.put_tiles(hw, kernel, shape + (dtype_bits,), cfg.blocks)
    return cfg


def _score_blocks(kernel: str, hw: HardwareSpec, shape, blocks,
                  dtype_bits: int) -> TileConfig:
    fn = (_GPU_SCORE if is_gpu(hw) else _SCORE)[kernel]
    cfg = fn(hw, *shape, *blocks, dtype_bits)
    if cfg is None:   # persisted under another spec or tile set: rebuild
        return _select(_candidates(kernel, hw, shape, dtype_bits))
    return cfg


# ---- public entry points ------------------------------------------------

def autotune_matmul(hw: HardwareSpec, m: int, n: int, k: int, *,
                    dtype_bits: int = 16,
                    cache: Optional[ProfileTableCache] = None) -> TileConfig:
    """Tiles for an (M, K) @ (K, N): ``repro``'s ``matmul_pallas`` blocks
    (bm, bn, bk) on a TPU spec; ``matmul_tiled``'s tile (rows, columns)
    on a GPU spec."""
    return _autotune("matmul", hw, (m, n, k), dtype_bits, cache)


def autotune_flash_attention(hw: HardwareSpec, b: int, sq: int, skv: int,
                             h: int, kv_heads: int, dh: int, *,
                             dtype_bits: int = 16,
                             cache: Optional[ProfileTableCache] = None,
                             ) -> TileConfig:
    """(block_q, block_kv): ``flash_attention_pallas``'s on a TPU spec; the
    CUDA kernel's one tile, scored, on a GPU spec."""
    return _autotune("flash_attention", hw, (b, sq, skv, h, kv_heads, dh),
                     dtype_bits, cache)


def autotune_moe_gmm(hw: HardwareSpec, e: int, c: int, d: int, f: int, *,
                     dtype_bits: int = 16,
                     cache: Optional[ProfileTableCache] = None) -> TileConfig:
    """(block_c, block_f, block_d) for ``moe_gmm_pallas`` on a TPU spec;
    ``moe_gmm``'s tile (rows of C, columns of F) on a GPU spec."""
    return _autotune("moe_gmm", hw, (e, c, d, f), dtype_bits, cache)
