"""Paper Fig. 5 on the card: blocks (B), waves (W) and latency (L) of the
port's GEMM as its output width grows (``benchmarks/wave_verification.py``,
ported to the GPU form).

    PYTHONPATH=src python -m repro_torch.launch.wave_verification
    PYTHONPATH=src python -m repro_torch.launch.wave_verification --device cpu

1. The model side, the reference's three checks on ``CtaWaveModel`` with a
   wave of S x c CTAs (S SMs, c the effective CTAs an SM): v1, B grows by
   one column of tiles (the row tiles) per 64 columns; v2, the model's
   waves are ceil(B / (S x c)); v3, the model's latency is flat within a
   stair.
2. On the card (the default; ``--device cpu`` stops after step 1): times
   ``ops.matmul`` with ``profiler.measured_profile`` at fixed M and K
   across N in 64-column steps, each sweep after ``SETTLE_S`` of idle
   card, in the prefill form (M = 1408, 11 row tiles, so that both 132
   and 264 slots end a wave on a whole column of tiles: edges every 12 or
   24 tiles; K = 4096) and in the decode form
   (M = 64, 16 K chunks of 256), and prints each N's B, the predicted
   waves at S and at S x the occupancy, and the measured us; then
   qwen1.5-0.5b's FFN up-projection at the planner's 512 tokens (M = 512,
   K = 1024, N up to 4224), where the plans cut 2816 columns to 2112.
3. Holds the prefill sweep against each slot count's stairs
   (``card_checks``). With dL the median time of the first stair and the
   noise floor its spread (max - min: the widths where every CTA has an
   SM to itself, so nothing but noise and the CTAs' contention for the
   L2 changes), two sets of checks:
   - which slot count (``ok``), the way c is chosen:
     - edges: at each of the first ``EDGES`` predicted edges, the median
       of the ``SIDE`` widths just past it exceeds the median of the
       ``SIDE`` widths just before it by more than the noise floor;
     - dL: the least-squares slope of time over predicted waves (through
       the origin, L = dL x waves) lies within ``SLOPE_BAND`` of dL;
   - flat stairs (``flat_ok``), the model's own shape:
     - at each of the first ``EDGES`` predicted edges, the time at the
       first width past it exceeds that stair's median by more than that
       stair's spread;
     - no rise between two neighbouring widths strictly inside one of
       those stairs is larger than the noise floor scaled to the stair's
       level (the floor x the stair's median / dL): the replays' own
       spread grows with the time they take, as a wave's L2 contention
       does, so the first stair's spread is held as a share of the time.
   It reports which slot count the card follows (``CtaWaveModel``'s
   ``EFFECTIVE_CTAS_PER_SM`` is fixed from that answer; where the form
   holds one CTA an SM the two counts are one) and whether its stairs are
   flat there.

``--json PATH`` writes every row. Exits non-zero where a model check fails
or, on the card, where the sweep contradicts the model: it follows the
other slot count, or neither, or its stairs at the model's are not flat.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.tail_model import (
    EFFECTIVE_CTAS_PER_SM, CtaWaveModel, LayerShape, ceil_div,
)
from repro_torch.kernels import matmul_tiled as mt

PREFILL = (1408, 4096)    # M, K: 11 row tiles of 128, K in one CTA
DECODE = (64, 4096)       # M, K: one row tile of 64, 16 K chunks of 256
QWEN_FFN = (512, 1024)    # M, K: qwen1.5-0.5b's 512-token class
WIDTHS = tuple(range(64, 12289, 64))
QWEN_WIDTHS = tuple(range(64, 4225, 64))
EDGES = 3                 # the predicted edges checked on the card
SIDE = 3                  # widths each side of an edge whose medians differ
SLOPE_BAND = (0.8, 1.25)  # the measured time per wave over dL
# idle seconds before each sweep: right after heavy work the card ran the
# first widths of a sweep slower than the rest of their stair
SETTLE_S = 1.0


def stairs(waves: np.ndarray) -> list[tuple[int, int]]:
    """[start, end) index ranges of equal wave counts, in order."""
    cuts = np.flatnonzero(np.diff(waves)) + 1
    bounds = [0, *cuts.tolist(), len(waves)]
    return list(zip(bounds[:-1], bounds[1:]))


def slot_waves(m: int, k: int, widths, slots: int,
               tile=None) -> np.ndarray:
    """ceil(B / slots) of the GEMM's grid on ``tile`` at each width."""
    return np.array([ceil_div(mt.grid_blocks(m, int(n), k, tile), slots)
                     for n in widths], dtype=np.int64)


def model_checks(hw, m: int = PREFILL[0], k: int = PREFILL[1],
                 widths=WIDTHS) -> dict:
    """v1-v3 of the reference on ``CtaWaveModel`` at (m, k) over widths."""
    model = CtaWaveModel(hw)
    layer = LayerShape("fig5", tokens=m, d_in=k, width=int(widths[0]))
    table = model.evaluate_batch(layer, widths)
    form = model.form(layer)
    blocks = np.array([mt.grid_blocks(m, int(n), k) for n in widths])
    v1 = bool(np.isin(np.diff(blocks), (0, form.g)).all())
    v2 = bool(np.array_equal(table.waves, -(-blocks // form.slots)))
    v3 = all(np.unique(table.latency_s[a:b]).size == 1
             for a, b in stairs(table.waves))
    return {"m": m, "k": k, "g": form.g, "slots": form.slots,
            "v1": v1, "v2": v2, "v3": v3,
            "widths": [int(n) for n in widths], "blocks": blocks.tolist(),
            "waves": table.waves.tolist(),
            "model_us": (table.latency_s * 1e6).tolist()}


def card_checks(times_us, waves: np.ndarray, edges: int = EDGES) -> dict:
    """The card's sweep against one slot count's stairs (see the module
    docstring): ``ok`` says whether the card steps with them, ``flat_ok``
    whether its stairs are as flat as the model's."""
    t = np.asarray(times_us, dtype=np.float64)
    w = np.asarray(waves, dtype=np.float64)
    st = stairs(waves)
    a, b = st[0]
    dl = float(np.median(t[a:b]))
    noise = float(t[a:b].max() - t[a:b].min())
    fails, jumps = [], []
    for _, e in st[:edges]:
        if e - SIDE < 0 or e + SIDE > len(t):
            fails.append(f"no {SIDE} widths on each side of the edge at "
                         f"index {e}")
            continue
        jump = float(np.median(t[e:e + SIDE]) - np.median(t[e - SIDE:e]))
        jumps.append(jump)
        if not jump > noise:
            fails.append(f"edge before index {e}: jump {jump:.3f} us <= "
                         f"noise {noise:.3f} us")
    ratio = float(w @ t / (w @ w)) / dl
    if not SLOPE_BAND[0] <= ratio <= SLOPE_BAND[1]:
        fails.append(f"time per wave {ratio:.3f} x dL, outside "
                     f"{SLOPE_BAND}")
    flat_fails, rises, spreads, tols = [], [], [], []
    for lo, e in st[:edges]:
        seg = t[lo:e]
        spreads.append(float(seg.max() - seg.min()))
        tols.append(noise * float(np.median(seg)) / dl)
        if e >= len(t):
            flat_fails.append(f"no width past the edge at index {e}")
            continue
        rises.append(float(t[e] - np.median(seg)))
        if not rises[-1] > spreads[-1]:
            flat_fails.append(f"past the edge at index {e}: "
                              f"{rises[-1]:.3f} us over the stair's median "
                              f"<= its spread {spreads[-1]:.3f} us")
    inner = [(lo + int(i), float(d), tol)
             for (lo, hi), tol in zip(st[:edges], tols)
             for i, d in enumerate(np.diff(t[lo:hi]))]
    for i, d, tol in inner:
        if d > tol:
            flat_fails.append(f"rise {d:.3f} us > noise {tol:.3f} us "
                              f"inside a stair after index {i}")
    top = max(inner, key=lambda x: x[1], default=(0, 0.0, 0.0))
    return {"ok": not fails, "dl_us": dl, "noise_us": noise,
            "jumps_us": jumps, "per_wave_over_dl": ratio, "fails": fails,
            "flat_ok": not flat_fails, "past_edge_rises_us": rises,
            "stair_spreads_us": spreads, "stair_noise_us": tols,
            "max_inner_rise_us": top[1], "flat_fails": flat_fails}


def card_sweep(hw, m: int, k: int, widths=WIDTHS, device="cuda",
               tile=None) -> dict:
    """``measured_profile`` across widths at (m, k) on ``tile`` (the
    default when None), with the grid and the predicted waves at S and at
    S x the form's occupancy beside it."""
    from repro_torch.core.profiler import measured_profile

    kind = "decode" if mt.kernel_form(m, k)[0] else "prefill"
    occ = mt.form(kind, device, tile)["ctas_per_sm"]
    torch.cuda.synchronize(device)
    time.sleep(SETTLE_S)
    prof = measured_profile(LayerShape("fig5", tokens=m, d_in=k,
                                       width=int(widths[0])),
                            widths, hw=hw, device=device, tile=tile)
    s = hw.cores_per_chip
    return {"m": m, "k": k, "form": kind, "ctas_per_sm_occupancy": occ,
            "tile": mt.launch_tile(m, tile),
            "widths": [int(n) for n in widths],
            "blocks": [mt.grid_blocks(m, int(n), k, tile) for n in widths],
            "waves_S": slot_waves(m, k, widths, s, tile).tolist(),
            "waves_Sc": slot_waves(m, k, widths, s * occ, tile).tolist(),
            "us": (prof.latency_s * 1e6).tolist(),
            "spread_us": (prof.spread_s * 1e6).tolist()}


def slot_keys(occ: int) -> tuple[str, ...]:
    """The slot counts a sweep is held against: S, and S x the occupancy
    where that is another count."""
    return ("S",) if occ == 1 else ("S", "Sc")


def fit(sweep: dict, s: int) -> dict:
    """``card_checks`` of the prefill sweep at S and at S x the occupancy;
    ``follows`` names the slot count whose stairs the card steps with, or
    None where neither or both do. At an occupancy of one the two are the
    same count, held once and named "S"."""
    occ = sweep["ctas_per_sm_occupancy"]
    res = {"S": card_checks(sweep["us"], np.asarray(sweep["waves_S"]))}
    res["Sc"] = res["S"] if occ == 1 else \
        card_checks(sweep["us"], np.asarray(sweep["waves_Sc"]))
    ok = [k for k in slot_keys(occ) if res[k]["ok"]]
    res["follows"] = ok[0] if len(ok) == 1 else None
    res["slots"] = {"S": s, "Sc": s * occ}
    res["c"] = {"S": 1, "Sc": occ}.get(res["follows"])
    return res


def print_sweep(sweep: dict, every: int = 1) -> None:
    print(f"  {sweep['form']} M={sweep['m']} K={sweep['k']} "
          f"(occupancy {sweep['ctas_per_sm_occupancy']} CTAs/SM)")
    for i in range(0, len(sweep["widths"]), every):
        print(f"    N={sweep['widths'][i]:>6} B={sweep['blocks'][i]:>5} "
              f"W(S)={sweep['waves_S'][i]:>3} W(Sc)={sweep['waves_Sc'][i]:>3}"
              f" {sweep['us'][i]:9.3f} us")


def edges_of(sweep: dict, key: str) -> list[int]:
    """The last width of each predicted stair under ``key`` waves."""
    w = np.asarray(sweep[key])
    return [sweep["widths"][b - 1] for _, b in stairs(w)][:-1]


def run(device="cuda", json_path: Optional[str] = None, hw=None) -> dict:
    """Steps 1-3 (step 1 alone on the CPU); returns every row."""
    from repro_torch.core.gpu import H100_SXM, GpuSpec
    dev = torch.device(device)
    if hw is None:
        hw = GpuSpec.from_device(dev) if dev.type == "cuda" else H100_SXM
    out = {"spec": hw.name, "sms": hw.cores_per_chip,
           "effective_ctas_per_sm": dict(EFFECTIVE_CTAS_PER_SM),
           "model": model_checks(hw)}
    mc = out["model"]
    print(f"Fig. 5, model side on {hw.name} (S = {hw.cores_per_chip}, "
          f"M = {mc['m']}, K = {mc['k']}, {mc['slots']} slots): "
          f"verification1={mc['v1']} verification2={mc['v2']} "
          f"verification3={mc['v3']}")
    for i in range(0, len(mc["widths"]), 24):
        print(f"  N={mc['widths'][i]:>6} B={mc['blocks'][i]:>5} "
              f"W={mc['waves'][i]:>3} L={mc['model_us'][i]:8.3f} us")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda was asked for but no CUDA "
                               "device is available")
        pre = card_sweep(hw, *PREFILL, device=dev)
        dec = card_sweep(hw, *DECODE, device=dev)
        qwen = card_sweep(hw, *QWEN_FFN, widths=QWEN_WIDTHS, device=dev)
        print("Fig. 5 on the card:")
        print_sweep(pre)
        print_sweep(dec, every=8)
        print_sweep(qwen, every=4)
        at = {n: qwen["us"][qwen["widths"].index(n)] for n in (2112, 2816)}
        print(f"  qwen FFN at 512 tokens: {at[2112]:.3f} us at 2112 columns "
              f"({mt.grid_blocks(512, 2112, 1024)} CTAs) against "
              f"{at[2816]:.3f} us at 2816 "
              f"({mt.grid_blocks(512, 2816, 1024)} CTAs): "
              f"{100 * (at[2112] / at[2816] - 1):+.1f}%")
        for sw in (pre, dec, qwen):
            print(f"  {sw['form']} M={sw['m']} K={sw['k']}: predicted "
                  f"edges at S: {edges_of(sw, 'waves_S')[:8]}; at S x "
                  f"{sw['ctas_per_sm_occupancy']}: "
                  f"{edges_of(sw, 'waves_Sc')[:8]}")
        out.update(prefill=pre, decode=dec, qwen_ffn=qwen,
                   fit=fit(pre, hw.cores_per_chip))
        f = out["fit"]
        for key in slot_keys(pre["ctas_per_sm_occupancy"]):
            r = f[key]
            print(f"  prefill stairs at {f['slots'][key]} slots: steps "
                  f"with them {r['ok']}; dL {r['dl_us']:.3f} us, noise "
                  f"{r['noise_us']:.3f} us; edge jumps us "
                  f"{[round(x, 3) for x in r['jumps_us']]}; time per wave "
                  f"{r['per_wave_over_dl']:.3f} x dL; {r['fails'][:3]}")
            print(f"    flat stairs {r['flat_ok']}: past each edge over the "
                  f"stair's median us "
                  f"{[round(x, 3) for x in r['past_edge_rises_us']]} "
                  f"against its spread "
                  f"{[round(x, 3) for x in r['stair_spreads_us']]}; "
                  f"largest rise inside a stair "
                  f"{r['max_inner_rise_us']:.3f} us against the noise "
                  f"{[round(x, 3) for x in r['stair_noise_us']]}; "
                  f"{len(r['flat_fails'])} failed: {r['flat_fails'][:4]}")
        rs = np.asarray(pre["spread_us"])
        per_stair = [round(float(np.median(rs[a:b])), 3)
                     for a, b in stairs(np.asarray(pre["waves_S"]))[:EDGES]]
        print(f"  replays' spread (max - min), median over each "
              f"of the first {EDGES} stairs at S, us: {per_stair}")
        print(f"  the card follows: {f['follows']} (c = {f['c']}); the "
              f"model's c at prefill: {EFFECTIVE_CTAS_PER_SM['prefill']}; "
              f"flat there: {f[model_slots()]['flat_ok']}")
    else:
        print("Fig. 5 on the card: not measured (device cpu)")
    if json_path:
        with open(json_path, "w") as fh:
            json.dump(out, fh)
    return out


def model_slots() -> str:
    """The slot count of ``fit`` the model's prefill c names."""
    return "Sc" if EFFECTIVE_CTAS_PER_SM["prefill"] > 1 else "S"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    out = run(args.device, args.json)
    mc = out["model"]
    if not (mc["v1"] and mc["v2"] and mc["v3"]):
        sys.exit("wave_verification: a model check failed")
    if "fit" in out:
        want = model_slots()
        if out["fit"]["follows"] != want:
            sys.exit(f"wave_verification: the card follows "
                     f"{out['fit']['follows']}, the model {want}")
        if not out["fit"][want]["flat_ok"]:
            sys.exit(f"wave_verification: the card's stairs at the "
                     f"model's slot count are not flat: "
                     f"{out['fit'][want]['flat_fails'][:4]}")
    return out


if __name__ == "__main__":
    main()
