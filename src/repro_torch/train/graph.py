"""The train step as one compiled unit: forward, backward, global-norm
clipping, the bias corrections, the learning rate and AdamW captured as one
CUDA graph (``repro``'s ``jax.jit(build_train_step(...))``,
``src/repro/launch/train.py:75``).

``jax.jit`` keeps one executable per input signature. :class:`GraphedTrainStep`
keeps one graph per batch signature (keys, shapes and dtypes) and tree of
params and optimizer state, which it updates in place as
``build_train_step`` does. Each graph reads static device buffers: the
batch's tensors and the step index (from which the step computes its
learning rate on the card), copied in before every replay, outside the
graph; its metrics are static outputs, valid until the next replay.

The first step of a signature runs eagerly on the stream that later
captures it: a real step of the run, which compiles every kernel and fills
the caches the capture needs (no step that is not part of the run is
taken, and no state is saved and restored around one). The next step of
that signature captures the body into a private memory pool and replays
it; every later one replays. The kernels' launch counts (``ops.LAUNCHES``)
leave out the capture's own wrapper calls, and each replay adds the
launches of one step, so after N steps they equal N eager steps'.

On the CPU the same body runs eagerly on the static buffers: there is no
graph. On a card a failed capture raises; nothing falls back to the eager
step.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import build
from repro_torch.train.optim import AdamState, Quantized
from repro_torch.train.step import TrainConfig, build_train_step, \
    named_leaves


@dataclasses.dataclass
class _Entry:
    batch: dict                 # static batch buffers on the step's device
    step: torch.Tensor          # static 0-d int64 step index
    warm: bool = False          # the signature's eager step has run
    graph: object = None        # torch.cuda.CUDAGraph, once captured
    out: Optional[dict] = None  # the graph's static metrics
    launches: dict = dataclasses.field(default_factory=dict)


def state_leaves(params, opt_state: AdamState) -> list:
    """Every tensor a step updates in place: the params, the count, the
    moments (an 8-bit moment's codes and scales) and the compensation."""
    out = [t for _, t in named_leaves(params)] + [opt_state.count]
    for tree in (opt_state.mu, opt_state.nu, opt_state.comp):
        if tree is None:
            continue
        for _, t in named_leaves(tree):
            out.extend(t if isinstance(t, Quantized) else (t,))
    return out


class GraphedTrainStep:
    """``step(params, opt_state, batch, step_idx) -> (params, opt_state,
    metrics)``, as ``build_train_step``'s (the same body), replayed as one
    CUDA graph per signature on a card. ``batch`` holds tensors on any
    device (pinned host tensors copy without blocking); ``step_idx`` is an
    int or a 0-d tensor. ``captures`` counts the graphs captured and
    ``capture_s`` their seconds; :meth:`reset` frees every graph."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig,
                 lr_schedule: Callable):
        self.body = build_train_step(cfg, tc, lr_schedule)
        self.captures = 0
        self.capture_s: list = []
        self._entries: dict = {}
        self._stream = None

    def graphs(self) -> list:
        """The captured graphs, in the order of their capture."""
        return [e.graph for e in self._entries.values()
                if e.graph is not None]

    def reset(self) -> None:
        """Drop every graph, its pool and its static buffers, once the
        replays queued on them have run."""
        if self._entries and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._entries.clear()
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    def __call__(self, params, opt_state: AdamState, batch: dict, step_idx):
        dev = opt_state.count.device
        key = (tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(batch.items())),
               tuple(t.data_ptr() for t in state_leaves(params, opt_state)))
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = _Entry(
                batch={k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                       for k, v in batch.items()},
                step=torch.zeros((), dtype=torch.int64, device=dev))
        for k, v in batch.items():
            entry.batch[k].copy_(v, non_blocking=True)
        if torch.is_tensor(step_idx):
            entry.step.copy_(step_idx, non_blocking=True)
        else:
            entry.step.fill_(step_idx)
        if dev.type != "cuda":
            return self.body(params, opt_state, entry.batch, entry.step)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        if not entry.warm:
            cur = torch.cuda.current_stream(dev)
            self._stream.wait_stream(cur)
            with torch.cuda.stream(self._stream):
                out = self.body(params, opt_state, entry.batch, entry.step)
            cur.wait_stream(self._stream)
            entry.warm = True
            return out
        if entry.graph is None:
            self._capture(entry, params, opt_state)
        entry.graph.replay()
        for k, n in entry.launches.items():
            build.LAUNCHES[k] += n
        return params, opt_state, entry.out

    def _capture(self, entry: _Entry, params, opt_state) -> None:
        t0 = time.perf_counter()
        # the eager step's cached blocks go back to the card first: a
        # recurrentgemma-2b step's (62 GiB at its peak) and a new pool for
        # the graph do not fit in 80 GiB together
        gc.collect()
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        before = dict(build.LAUNCHES)
        try:
            with torch.cuda.graph(graph, pool=torch.cuda.graph_pool_handle(),
                                  stream=self._stream):
                _, _, out = self.body(params, opt_state, entry.batch,
                                      entry.step)
        finally:
            launches = {k: build.LAUNCHES[k] - n for k, n in before.items()}
            build.LAUNCHES.update(before)     # a capture launches nothing
        entry.graph, entry.out = graph, out
        entry.launches = {k: n for k, n in launches.items() if n}
        self.captures += 1
        self.capture_s.append(time.perf_counter() - t0)
