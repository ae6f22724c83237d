"""Disk-backed profile-table cache — persistent "Step 1: pre-analysis"
(``repro.core.table_cache``'s counterpart, the tile autotuner's entries
included: ``get_tiles`` / ``put_tiles``).

The staircase tables the optimizer sweeps (``tail_optimizer._build_tables``)
and the profiler derives (``profiler.analytic_profile``) depend only on the
hardware spec, the layer shape (minus its mutable width), and the width
vector swept.  All three are immutable inputs, so the tables can be
serialized once and reused by every later ``optimize_*`` call — across
processes: NAS sweeps, serving planners, CI — which is what hardware-aware
methods (HALP, the paper's own nvprof flow) assume: a lookup-table latency
oracle that is effectively free at optimization time.

Key = sha256 over

  * ``CACHE_VERSION`` — bumping it invalidates every existing entry (the
    staircase math changed, so the cached numbers are stale);
  * the ``HardwareSpec`` fields (``dataclasses.asdict``, sorted keys);
  * the ``LayerShape`` fields minus ``width`` and ``name`` (two identically
    shaped layers share entries; the swept start width is part of the width
    vector, not the shape);
  * the width vector's raw int64 bytes.

Entries are ``.npz`` files (parallel arrays + a JSON meta record) written
atomically (tmp + ``os.replace``), sharded into two-hex-char directories.
On load the meta is re-verified against the live hardware/shape/version —
a mismatched entry reads as a miss, never as wrong data.  An *unreadable*
entry (truncated zip, garbage bytes — e.g. a crashed writer on a
non-atomic filesystem, or disk corruption) is retried once and then
quarantined: renamed to ``*.bad`` and counted in ``stats.corrupted``, so
the key misses cleanly from then on (the caller re-sweeps and rewrites)
and repeated re-sweeps from a corrupt store stay visible in the stats
instead of masquerading as ordinary misses.

Two granularities share the store: per-layer entries (``get``/``put``,
fine-grained reuse for shallow models) and whole-stack bundles
(``get_stack``/``put_stack``) — one file per packed model sweep, because
at 1000+ layers the per-file open cost of fine-grained entries exceeds
resweeping the analytic model.  ``TailEffectOptimizer`` picks the
granularity by stack depth (``bundle_min_layers``).

Cache location
--------------
``ProfileTableCache(root)`` uses an explicit directory.
``ProfileTableCache.from_env()`` reads the ``REPRO_TABLE_CACHE_DIR``
environment variable: unset (or one of ``0/off/none/disabled/""``) disables
caching (returns ``None``); any other value is the cache root.  Pass
``default=...`` to fall back to a directory (e.g. the conventional
``~/.cache/repro-tail-tables``) when the variable is unset.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import tempfile
import zipfile
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.tail_model import LayerShape, StairTable

# Bump when the staircase math (or this file's on-disk layout) changes:
# every existing entry then misses and is rebuilt.
CACHE_VERSION = 1

CACHE_DIR_ENV = "REPRO_TABLE_CACHE_DIR"
DEFAULT_CACHE_DIR = "~/.cache/repro-tail-tables"
_DISABLE_TOKENS = {"", "0", "off", "none", "disabled"}

_STAIR_FIELDS = ("latency_s", "utilization", "throughput", "waves",
                 "flops", "padded_flops")

# Errors an unreadable (truncated / garbage / half-written) npz entry can
# raise on load.  These quarantine the file; a *verify* mismatch (stale
# version, different hw/shape) is a legitimate miss and never does.
_READ_ERRORS = (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile, json.JSONDecodeError)


@functools.lru_cache(maxsize=64)
def _hw_json(hw: HardwareSpec) -> str:
    # dataclasses.asdict is ~100us a call; HardwareSpec is frozen, so one
    # serialization per spec suffices for the whole process. A subclass's
    # name joins the fields (a GPU spec, ``gpu.GpuSpec``, selects the tail
    # model's GPU form); a ``HardwareSpec`` keeps its historical key.
    fields = dataclasses.asdict(hw)
    if type(hw) is not HardwareSpec:
        fields["spec"] = type(hw).__name__
    return json.dumps(fields, sort_keys=True)


def hardware_fingerprint(hw: HardwareSpec) -> str:
    """Short stable digest of every HardwareSpec field."""
    return hashlib.sha256(_hw_json(hw).encode()).hexdigest()[:16]


def _shape_fields(layer: LayerShape) -> dict:
    """LayerShape-minus-width (and minus name): the cache's shape key.

    Built field-by-field rather than via ``dataclasses.asdict`` — this
    runs once per layer per table build, and asdict's deep copy dominated
    cache lookups on 1000-layer stacks."""
    out = {"tokens": layer.tokens, "d_in": layer.d_in,
           "shard_in": layer.shard_in, "shard_out": layer.shard_out,
           "dtype_bits": layer.dtype_bits,
           "flop_multiplier": layer.flop_multiplier}
    if layer.experts != 1:     # the port's field; absent keeps repro's key
        out["experts"] = layer.experts
    return out


def _meta(hw: HardwareSpec, layer: LayerShape, variant: str = "") -> str:
    # ``variant`` names the model form and the sweep engine that produced
    # the tables (the model's ``table_variant``: "kernel-cuda" for the fp32
    # Triton sweep, "kernel-cpu" for its fp64 plain version, "cta-..." for
    # the GPU form, ``tail_model.CtaWaveModel``); forms differ and engines
    # agree only to tolerance, so their entries must not share keys.  The empty string
    # (the exact numpy engine) keeps the historical meta/key unchanged.
    tail = f', "variant": {json.dumps(variant)}' if variant else ""
    return (f'{{"hw": {_hw_json(hw)}, "shape": '
            f'{json.dumps(_shape_fields(layer), sort_keys=True)}, '
            f'"version": {CACHE_VERSION}{tail}}}')


def table_key(hw: HardwareSpec, layer: LayerShape, widths: np.ndarray,
              variant: str = "") -> str:
    """Cache key: (hw fingerprint, shape-minus-width, width-vector hash,
    sweep-engine variant)."""
    w = np.ascontiguousarray(np.asarray(widths, dtype=np.int64))
    h = hashlib.sha256(_meta(hw, layer, variant).encode())
    h.update(w.tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    writes: int = 0
    evictions: int = 0
    # entries whose npz could not be read (truncated/garbage file) and
    # were quarantined to *.bad — distinct from `misses` so repeated
    # re-sweeps caused by a corrupt store are visible, not silent
    corrupted: int = 0


def _atomic_savez(path: Path, **arrays) -> None:
    """np.savez to ``path`` via tmp + os.replace: readers never observe a
    partially written entry."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class ProfileTableCache:
    """npz-file cache of per-layer (width -> latency/U/T/...) tables.

    ``max_bytes`` caps the on-disk size: after every write the oldest
    entries (least-recently *used* — reads touch an entry's mtime) are
    evicted until the store fits, so long-lived NAS sweeps cannot
    accumulate stale bundles without bound.  The entry just written
    always survives, even when it alone exceeds the cap — a cache that
    evicts its own write thrashes at 100%.  ``None`` (default) disables
    the cap; ``clear()`` remains the manual full wipe.
    """

    def __init__(self, root: str | os.PathLike, *,
                 max_bytes: int | None = None):
        self.root = Path(root).expanduser()
        self.max_bytes = max_bytes
        self.stats = CacheStats()

    @classmethod
    def from_env(cls, default: str | None = None,
                 max_bytes: int | None = None
                 ) -> "ProfileTableCache | None":
        """Cache at ``$REPRO_TABLE_CACHE_DIR``; disable tokens (or an unset
        variable with no ``default``) return None."""
        val = os.environ.get(CACHE_DIR_ENV)
        if val is None:
            if default is None:
                return None
            return cls(default, max_bytes=max_bytes)
        if val.strip().lower() in _DISABLE_TOKENS:
            return None
        return cls(val, max_bytes=max_bytes)

    # ---- raw array entries ---------------------------------------------
    def _path(self, key: str) -> Path:
        return self.root / key[:2] / f"{key}.npz"

    def get(self, hw: HardwareSpec, layer: LayerShape,
            widths: np.ndarray,
            variant: str = "") -> dict[str, np.ndarray] | None:
        """Arrays stored for (hw, shape, widths), or None on miss.

        A hit re-verifies the stored meta (version/hw/shape) and width
        vector; a mismatch is a miss.  An *unreadable* entry (truncated
        or garbage npz) is retried once — transient IO — then
        quarantined to ``*.bad`` and counted in ``stats.corrupted``, so
        the caller's re-sweep rewrites a fresh entry instead of
        re-reading the corrupt one forever."""
        w = np.asarray(widths, dtype=np.int64)
        path = self._path(table_key(hw, layer, w, variant))
        if not path.exists():
            self.stats.misses += 1
            return None
        for attempt in (0, 1):
            try:
                with np.load(path, allow_pickle=False) as z:
                    meta = str(z["__meta__"])
                    stored_w = z["widths"]
                    if meta != _meta(hw, layer, variant) \
                            or stored_w.shape != w.shape \
                            or (stored_w != w).any():
                        self.stats.misses += 1
                        return None
                    out = {k: z[k] for k in z.files
                           if k not in ("__meta__", "widths")}
                break
            except _READ_ERRORS:
                if attempt == 0 and path.exists():
                    continue
                self._quarantine(path)
                self.stats.misses += 1
                return None
        self.stats.hits += 1
        self._touch(path)
        return out

    def put(self, hw: HardwareSpec, layer: LayerShape, widths: np.ndarray,
            arrays: Mapping[str, np.ndarray], variant: str = "") -> Path:
        """Atomically persist parallel arrays for (hw, shape, widths)."""
        w = np.asarray(widths, dtype=np.int64)
        path = self._path(table_key(hw, layer, w, variant))
        _atomic_savez(path, __meta__=np.array(_meta(hw, layer, variant)),
                      widths=w, **dict(arrays))
        self.stats.writes += 1
        self._evict_to_cap(keep=path)
        return path

    # ---- whole-stack bundles -------------------------------------------
    # One npz per model sweep: at 1000+ layers, per-layer entries cost one
    # file open each (seconds of zipfile overhead), so large stacks are
    # cached as a single (w2d, counts, latency_2d) bundle keyed over every
    # layer's shape plus the packed width matrix.  Granularity trade-off:
    # any change to the stack misses the whole bundle — callers fall back
    # to one stacked sweep, which is far cheaper than 1000 file opens.

    def stack_key(self, hw: HardwareSpec, layers: Sequence[LayerShape],
                  w2d: np.ndarray, counts: np.ndarray,
                  variant: str = "") -> str:
        h = hashlib.sha256(
            f"stack:{CACHE_VERSION}:{variant}:{_hw_json(hw)}".encode()
            if variant else
            f"stack:{CACHE_VERSION}:{_hw_json(hw)}".encode())
        for layer in layers:
            h.update(repr(sorted(_shape_fields(layer).items())).encode())
        h.update(np.ascontiguousarray(w2d, dtype=np.int64).tobytes())
        h.update(np.ascontiguousarray(counts, dtype=np.int64).tobytes())
        return h.hexdigest()

    def get_stack(self, hw: HardwareSpec, layers: Sequence[LayerShape],
                  w2d: np.ndarray, counts: np.ndarray,
                  variant: str = "") -> np.ndarray | None:
        """The (L, C) latency matrix for a whole packed stack, or None.

        Unreadable bundles follow the same retry-then-quarantine path as
        per-layer entries (``stats.corrupted``, renamed to ``*.bad``)."""
        key = self.stack_key(hw, layers, w2d, counts, variant)
        path = self._path(key)
        if not path.exists():
            self.stats.misses += 1
            return None
        stack_meta = f"stack:{CACHE_VERSION}:{variant}" if variant \
            else f"stack:{CACHE_VERSION}"
        for attempt in (0, 1):
            try:
                with np.load(path, allow_pickle=False) as z:
                    if str(z["__meta__"]) != stack_meta \
                            or not np.array_equal(z["w2d"], w2d) \
                            or not np.array_equal(z["counts"], counts):
                        self.stats.misses += 1
                        return None
                    lat2d = z["latency_2d"]
                break
            except _READ_ERRORS:
                if attempt == 0 and path.exists():
                    continue
                self._quarantine(path)
                self.stats.misses += 1
                return None
        self.stats.hits += 1
        self._touch(path)
        return lat2d

    def put_stack(self, hw: HardwareSpec, layers: Sequence[LayerShape],
                  w2d: np.ndarray, counts: np.ndarray,
                  lat2d: np.ndarray, variant: str = "") -> Path:
        path = self._path(self.stack_key(hw, layers, w2d, counts, variant))
        stack_meta = f"stack:{CACHE_VERSION}:{variant}" if variant \
            else f"stack:{CACHE_VERSION}"
        _atomic_savez(path, __meta__=np.array(stack_meta),
                      w2d=np.asarray(w2d, dtype=np.int64),
                      counts=np.asarray(counts, dtype=np.int64),
                      latency_2d=np.asarray(lat2d, dtype=np.float64))
        self.stats.writes += 1
        self._evict_to_cap(keep=path)
        return path

    # ---- kernel tile configs --------------------------------------------
    # Tiny entries persisting the tile autotuner's chosen blocks per
    # (hardware, kernel, invocation shape+dtype) — see kernels/autotune.py.
    # Selection is deterministic, so these are pure lookup-table reuse: a
    # serving process resolves tiles from disk instead of re-enumerating
    # the candidate space.

    def _tiles_meta(self, hw: HardwareSpec, kernel: str,
                    shape: Sequence[int]) -> str:
        return (f'{{"tiles": {CACHE_VERSION}, "hw": {_hw_json(hw)}, '
                f'"kernel": {json.dumps(kernel)}, '
                f'"shape": {json.dumps(list(map(int, shape)))}}}')

    def tiles_key(self, hw: HardwareSpec, kernel: str,
                  shape: Sequence[int]) -> str:
        return hashlib.sha256(
            self._tiles_meta(hw, kernel, shape).encode()).hexdigest()

    def get_tiles(self, hw: HardwareSpec, kernel: str,
                  shape: Sequence[int]) -> tuple[int, ...] | None:
        """Persisted block tuple for (hw, kernel, shape), or None."""
        path = self._path(self.tiles_key(hw, kernel, shape))
        if not path.exists():
            self.stats.misses += 1
            return None
        for attempt in (0, 1):
            try:
                with np.load(path, allow_pickle=False) as z:
                    if str(z["__meta__"]) != \
                            self._tiles_meta(hw, kernel, shape):
                        self.stats.misses += 1
                        return None
                    blocks = tuple(int(b) for b in z["blocks"])
                break
            except _READ_ERRORS:
                if attempt == 0 and path.exists():
                    continue
                self._quarantine(path)
                self.stats.misses += 1
                return None
        self.stats.hits += 1
        self._touch(path)
        return blocks

    def put_tiles(self, hw: HardwareSpec, kernel: str,
                  shape: Sequence[int],
                  blocks: Sequence[int]) -> Path:
        path = self._path(self.tiles_key(hw, kernel, shape))
        _atomic_savez(
            path, __meta__=np.array(self._tiles_meta(hw, kernel, shape)),
            blocks=np.asarray(list(blocks), dtype=np.int64))
        self.stats.writes += 1
        self._evict_to_cap(keep=path)
        return path

    # ---- StairTable convenience ----------------------------------------
    def put_stair_table(self, hw: HardwareSpec, layer: LayerShape,
                        table: StairTable) -> Path:
        return self.put(hw, layer, table.widths,
                        {f: getattr(table, f) for f in _STAIR_FIELDS})

    def get_stair_table(self, hw: HardwareSpec, layer: LayerShape,
                        widths: np.ndarray) -> StairTable | None:
        arrays = self.get(hw, layer, widths)
        if arrays is None or any(f not in arrays for f in _STAIR_FIELDS):
            return None
        return StairTable(widths=np.asarray(widths, dtype=np.int64),
                          **{f: arrays[f] for f in _STAIR_FIELDS})

    # ---- maintenance ----------------------------------------------------
    def _quarantine(self, path: Path) -> bool:
        """Rename an unreadable entry to ``<name>.bad`` so the next read
        of the same key is a clean miss (re-sweep + rewrite) instead of
        another doomed parse.  The sidecar keeps the evidence on disk
        for postmortems; ``purge_quarantined`` deletes it."""
        bad = path.with_name(path.name + ".bad")
        try:
            os.replace(path, bad)
        except OSError:
            return False     # e.g. lost a race with another process
        self.stats.corrupted += 1
        return True

    def quarantined(self) -> list[Path]:
        """Quarantined (``*.npz.bad``) entries currently on disk."""
        return sorted(self.root.glob("??/*.npz.bad"))

    def purge_quarantined(self) -> int:
        """Delete quarantined entries; returns the number removed."""
        removed = 0
        for p in self.root.glob("??/*.npz.bad"):
            try:
                p.unlink()
                removed += 1
            except OSError:
                pass
        return removed

    @staticmethod
    def _touch(path: Path) -> None:
        """Bump an entry's mtime on a read hit: eviction order becomes
        least-recently-USED, so a hot entry survives a sweep of writes."""
        try:
            os.utime(path)
        except OSError:
            pass

    def _evict_to_cap(self, keep: Path | None = None) -> int:
        """Evict oldest-mtime entries until the store fits ``max_bytes``.
        ``keep`` (the entry just written) is never evicted.  Returns the
        number of entries removed."""
        if self.max_bytes is None:
            return 0
        entries = []
        total = 0
        for p in self.root.glob("??/*.npz"):
            try:
                stt = p.stat()
            except OSError:
                continue
            entries.append((stt.st_mtime, stt.st_size, p))
            total += stt.st_size
        if total <= self.max_bytes:
            return 0
        removed = 0
        for _, size, p in sorted(entries):
            if total <= self.max_bytes:
                break
            if keep is not None and p == keep:
                continue
            try:
                p.unlink()
            except OSError:
                continue
            total -= size
            removed += 1
        self.stats.evictions += removed
        return removed

    def size_bytes(self) -> int:
        """Total bytes currently stored under root (entries another
        process removes mid-scan count as 0, like everywhere else)."""
        total = 0
        for p in self.root.glob("??/*.npz"):
            try:
                total += p.stat().st_size
            except OSError:
                pass
        return total

    def clear(self) -> int:
        """Remove every cache entry under root (including quarantined
        ``*.bad`` sidecars); returns live entries removed."""
        removed = 0
        if not self.root.exists():
            return removed
        for p in self.root.glob("??/*.npz"):
            try:
                p.unlink()
                removed += 1
            except OSError:
                pass
        self.purge_quarantined()
        return removed
