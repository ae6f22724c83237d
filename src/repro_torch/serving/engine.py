"""Static-batch serving engine (``repro.serving.engine``'s counterpart).

``ServeEngine.generate`` forms batches of ``batch_slots`` requests in order,
left-pads each batch's prompts with token 0 (the pad rows are attended, as in
``repro``), prefills with ``transformer.forward(mode="prefill")``, grows the
caches to ``max_len`` and decodes all rows in lockstep with ``decode_step``.
On a CUDA device the MLP projections and causal prefill attention run on the
port's kernels. fp32 products (decode scores) assume TF32 is off, PyTorch's
default; the entry points set it so.

Width planning, admission control, the width swapper, the degrader and the
compile cache of ``repro``'s engine are later slices of the port.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    eos_id: int = -1            # -1: never stop early
    temperature: float = 0.0    # 0 = greedy


@dataclasses.dataclass
class Result:
    tokens: np.ndarray
    steps: int
    latency_s: float = 0.0      # submission -> completion (engine clock)


@dataclasses.dataclass
class BatchStats:
    """Per-batch telemetry, appended to ``ServeEngine.batch_log``."""

    tokens: int         # batch x (prompt length + new tokens)
    latency_s: float    # batch wall time, ending in a device-to-host copy


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    no card is present, instead of running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for but torch.cuda.is_available() is "
            f"False: no CUDA device; pass device='cpu' to run the plain "
            f"path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class ServeEngine:
    """Pads requests to a slot batch, prefills, then decodes all slots in
    lockstep. ``params`` are fp32 in ``repro``'s layout on any device; the
    engine keeps them on ``device`` with the weights cast to bf16 once."""

    def __init__(self, params: dict, cfg: ModelConfig, *, max_len: int = 512,
                 batch_slots: int = 4, rng_seed: int = 0, device="cuda",
                 clock: Callable[[], float] = time.monotonic):
        self.device = require_device(device)
        self.cfg = cfg
        self.params = tfm.cast_params(params, self.device)
        self.max_len = max_len
        self.slots = batch_slots
        self.gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.clock = clock
        self.batch_log: List[BatchStats] = []

    def generate(self, requests: List[Request]) -> List[Result]:
        """Serve a burst that arrives now, in batches of ``batch_slots``."""
        results: List[Result] = []
        arrival = self.clock()
        for i in range(0, len(requests), self.slots):
            batch = requests[i:i + self.slots]
            t0 = self.clock()
            out = self._generate_batch(batch)
            self._account_batch(batch, t0)
            end = self.clock()
            for res in out:
                res.latency_s = end - arrival
            results.extend(out)
        return results

    def _account_batch(self, reqs: List[Request], t0: float) -> float:
        plen = max(len(r.prompt) for r in reqs)
        tokens = len(reqs) * (plen + max(r.max_new_tokens for r in reqs))
        dt = self.clock() - t0
        self.batch_log.append(BatchStats(tokens=tokens, latency_s=dt))
        return dt

    @torch.inference_mode()
    def _generate_batch(self, reqs: List[Request]) -> List[Result]:
        cfg, dev = self.cfg, self.device
        b = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        max_new = max(r.max_new_tokens for r in reqs)
        if plen + max_new - 1 > self.max_len:
            raise ValueError(f"prompt {plen} + {max_new} new tokens need "
                             f"{plen + max_new - 1} cache rows; max_len is "
                             f"{self.max_len}")
        toks = np.zeros((b, plen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt   # left-pad
        logits, states = tfm.forward(self.params, cfg,
                                     tokens=torch.from_numpy(toks).to(dev),
                                     mode="prefill")
        states = self._ensure_states(states)

        cur = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
        generated = [cur]
        done = np.zeros(b, bool)
        steps = 0
        any_temp = any(r.temperature > 0 for r in reqs)
        if any_temp:
            temp = torch.tensor([max(r.temperature, 1e-6) for r in reqs],
                                device=dev)[:, None]
            use_t = torch.tensor([r.temperature > 0 for r in reqs],
                                 device=dev)
        track_eos = any(r.eos_id >= 0 for r in reqs)
        for t in range(max_new - 1):
            logits, states = tfm.decode_step(self.params, cfg, cur, plen + t,
                                             states)
            logits = logits[:, :cfg.vocab_size]
            greedy = torch.argmax(logits, dim=-1)
            if any_temp:
                probs = torch.softmax(logits.float() / temp, dim=-1)
                drawn = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
                cur = torch.where(use_t, drawn, greedy)
            else:
                cur = greedy
            generated.append(cur)
            steps += 1
            if track_eos:
                host = cur.cpu().numpy()
                for i, r in enumerate(reqs):
                    if r.eos_id >= 0 and host[i] == r.eos_id:
                        done[i] = True
                if done.all():
                    break

        gen = torch.stack(generated, dim=1).cpu().numpy().astype(np.int32)
        results = []
        for i, r in enumerate(reqs):
            row = gen[i][: r.max_new_tokens]
            if r.eos_id >= 0 and (row == r.eos_id).any():
                row = row[: int(np.argmax(row == r.eos_id)) + 1]
            results.append(Result(tokens=row, steps=steps + 1))
        return results

    def _ensure_states(self, states: dict) -> dict:
        """Grow the prefill caches (sequence axis third from the end) to
        ``max_len`` rows of decode capacity."""
        def grow(tree):
            if isinstance(tree, dict):
                return {k: grow(v) for k, v in tree.items()}
            pad = self.max_len - tree.shape[-3]
            return F.pad(tree, (0, 0, 0, 0, 0, pad)) if pad > 0 else tree
        return grow(states)
