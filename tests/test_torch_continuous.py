"""The port's continuous engine (``repro_torch.serving.continuous``) and
what it stands on — chunk attention, ``prefill_chunk``, the step cache's
chunk kind — against ``repro``'s on the same seeds (CPU).

Engine scenarios run both engines on a ``VirtualClock`` with
``modeled_batch_cost``, so ledgers, logs, latencies, retries and join and
chunk counts must be equal exactly. Greedy tokens follow the margin rule
of ``tests/test_torch_serve.py``: a token is compared where both engines
generated the same tokens before it and ``repro``'s own logits for it
(recorded as its engine ran) have a top-2 margin above twice the bf16
tolerance, 4e-2 of the largest logit.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro import serving as jserving
from repro.serving import chaos as jchaos
from repro_torch import serving as tserving
from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.launch.serve_continuous import main as cli_main
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tfm
from repro_torch.serving import chaos as tchaos
from test_torch_serve import TOL, granite_model, recurrent_model
from test_torch_recurrent import one_torch_thread  # noqa: F401

BF16_OUT = 1e-2     # bf16 outputs: one bf16 step (2^-8 of an element) fits


# ---------------------------------------------------------------------------
# the model: tests/test_continuous.py's reduced qwen, logits spread
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model():
    jc = jax_reduced(jax_get_config("qwen1.5-0.5b"), d_model=128,
                     n_layers=2, d_ff=576)
    tc = reduced_config(get_config("qwen1.5-0.5b"), d_model=128,
                        n_layers=2, d_ff=576)
    host = jax.device_get(jtfm.init_params(jax.random.PRNGKey(0), jc))
    # a larger embedding (std 0.5, tied) spreads the logits, so that most
    # greedy choices have a clear margin to test against
    host["embed"]["tok_emb"] = host["embed"]["tok_emb"] * 25
    return jc, tc, host


def sides(jc, tc, host):
    """(repro's side, the port's side): the package, its chaos module, its
    config, its params and the engine arguments it needs."""
    j = types.SimpleNamespace(sv=jserving, ch=jchaos, cfg=jc,
                              params=jax.tree.map(jnp.asarray, host), kw={},
                              jax=True)
    t = types.SimpleNamespace(sv=tserving, ch=tchaos, cfg=tc,
                              params=params_from_jax(host),
                              kw={"device": "cpu"}, jax=False)
    return j, t


def reqs_for(S, lens, *, max_new=6, seed=0, deadline_s=None):
    rng = np.random.default_rng(seed)
    return [S.sv.Request(prompt=rng.integers(0, S.cfg.vocab_size, size=(n,))
                         .astype(np.int32), max_new_tokens=max_new,
                         deadline_s=deadline_s) for n in lens]


# repro's engine builds its jitted steps per instance; one set per config
# serves every engine of these tests (the same functions, compiled once)
_JAX_STEPS: dict = {}


def jax_steps(cfg):
    if cfg not in _JAX_STEPS:
        _JAX_STEPS[cfg] = (
            jax.jit(lambda p, t, pos, st: jtfm.decode_step(p, cfg, t, pos,
                                                           st)),
            jax.jit(lambda p, toks: jtfm.forward(p, cfg, tokens=toks,
                                                 mode="prefill")),
            jax.jit(lambda p, toks, pos, st: jtfm.prefill_chunk(
                p, cfg, toks, pos, st)))
    return _JAX_STEPS[cfg]


class Margins:
    """Records, as ``repro``'s engines run, the top-2 margin of the logits
    each greedy token was taken from, keyed by (request, token index), and
    the largest |logit| seen."""

    def __init__(self, vocab: int):
        self.v = vocab
        self.margin: dict = {}
        self.scale = 0.0
        self._joining = None

    def _note(self, tr, row) -> None:
        row = np.asarray(row[:self.v], np.float32)
        top2 = np.sort(row)[-2:]
        self.margin[(id(tr.request), len(tr.generated))] = \
            float(top2[1] - top2[0])
        self.scale = max(self.scale, float(np.abs(row).max()))

    def attach(self, eng) -> None:
        if eng.compile_cache is None:
            eng._decode, eng._prefill, eng._chunk = jax_steps(eng.cfg)
        decode, prefill, chunk, join = (eng._decode, eng._prefill,
                                        eng._chunk, eng._join)

        def rec_decode(p, toks, pos, st):
            out = decode(p, toks, pos, st)
            lg = np.asarray(out[0], np.float32)
            for i, tr in enumerate(eng._slots):
                if tr is not None and tr.chunk_state is None:
                    self._note(tr, lg[i])
            return out

        def rec_prefill(p, toks):
            out = prefill(p, toks)
            tr = self._joining
            plen = len(tr.request.prompt) + len(tr.generated)
            self._note(tr, np.asarray(out[0][0, plen - 1], np.float32))
            return out

        def rec_chunk(p, toks, pos, st):
            out = chunk(p, toks, pos, st)
            [tr] = [t for t in eng._slots
                    if t is not None and t.chunk_state is st]
            target = len(tr.request.prompt) + len(tr.generated)
            clen = min(eng.prefill_chunk, target - int(pos))
            if int(pos) + clen >= target:
                self._note(tr, np.asarray(out[0][0, clen - 1], np.float32))
            return out

        def rec_join(i, tr):
            self._joining = tr
            return join(i, tr)

        eng._decode, eng._prefill, eng._chunk, eng._join = (
            rec_decode, rec_prefill, rec_chunk, rec_join)

    def check_tokens(self, jreqs, jres, tres, *, min_frac=0.5) -> int:
        """The port's tokens against ``repro``'s under the margin rule;
        returns how many were compared."""
        tol = TOL * self.scale
        compared = total = 0
        for req, j, t in zip(jreqs, jres, tres):
            assert len(t.tokens) == len(j.tokens)
            total += len(j.tokens)
            for k in range(len(j.tokens)):
                if not np.array_equal(t.tokens[:k], j.tokens[:k]):
                    break
                if self.margin[(id(req), k)] > 2 * tol:
                    assert t.tokens[k] == j.tokens[k], (k, j.tokens,
                                                        t.tokens)
                    compared += 1
        assert compared >= min_frac * total, (compared, total)
        return compared


def outcome(r) -> tuple:
    return (r.shed, r.failed, r.retries, r.recovered, r.cancelled,
            r.deadline_missed, r.latency_s, len(r.tokens), r.steps)


def assert_same_engines(jengs, tengs) -> None:
    for je, te in zip(jengs, tengs):
        assert dataclasses.astuple(te.ledger()) == \
            dataclasses.astuple(je.ledger())
        assert [dataclasses.astuple(b) for b in te.boundary_log] == \
            [dataclasses.astuple(b) for b in je.boundary_log]
        assert [dataclasses.astuple(c) for c in te.chunk_log] == \
            [dataclasses.astuple(c) for c in je.chunk_log]
        assert (te.steps, te.join_count, te.chunk_steps,
                te._decode_steps) == (je.steps, je.join_count,
                                      je.chunk_steps, je._decode_steps)
        assert [s.outcome for s in te.swap_log] == \
            [s.outcome for s in je.swap_log]


def run_both(model, scenario, *, min_frac=0.5):
    """``scenario(S, margins)`` builds and drives engines on one side and
    returns (engines, requests, results); runs it on both sides and holds
    the port's run against ``repro``'s."""
    jc, tc, host = model
    j, t = sides(jc, tc, host)
    m = Margins(jc.vocab_size)
    jengs, jreqs, jres = scenario(j, m)
    tengs, _, tres = scenario(t, None)
    assert_same_engines(jengs, tengs)
    assert [outcome(r) for r in tres] == [outcome(r) for r in jres]
    m.check_tokens(jreqs, jres, tres, min_frac=min_frac)
    return (jengs, jres), (tengs, tres)


def engine(S, m, **kw):
    eng = S.sv.ContinuousServeEngine(S.params, S.cfg, **S.kw, **kw)
    if m is not None:
        m.attach(eng)
    return eng


def virtual(S, cost=1e-3):
    return {"clock": S.ch.VirtualClock(),
            "batch_cost_fn": S.ch.modeled_batch_cost(cost)}


# ---------------------------------------------------------------------------
# chunk attention and prefill_chunk against repro
# ---------------------------------------------------------------------------
def bf16(rng, shape):
    """Random values on bf16's grid, as numpy fp32."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("c", [4, 8])
@pytest.mark.parametrize("offset", [0, 5, 17])
def test_chunk_prefill_attention_matches_repro(offset, c):
    rng = np.random.default_rng(offset + c)
    b, s, h, kv, dh = 2, 32, 8, 2, 16          # GQA: 4 queries a KV head
    q = bf16(rng, (b, c, h, dh))
    k, v = bf16(rng, (b, s, kv, dh)), bf16(rng, (b, s, kv, dh))
    want = np.asarray(jattn.chunk_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), offset), np.float32)
    for off in (offset, torch.tensor(offset)):
        got = tattn.chunk_prefill_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            off)
        assert got.dtype == torch.bfloat16 and got.shape == (b, c, h, dh)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= BF16_OUT * np.abs(want).max(), err


def _chunks(plen, c):
    return [(p, min(c, plen - p)) for p in range(0, plen, c)]


def test_prefill_chunk_matches_repro_chunk_by_chunk(model):
    """Chunk by chunk over a 13-token prompt (chunks 4, 4, 4, 1): each
    chunk's logits within 4e-2 of the largest, every cache leaf within a
    bf16 step of the largest, after every chunk; the port's chunked
    prefill also against its own whole-prompt prefill."""
    jc, tc, host = model
    jp, tp = jax.tree.map(jnp.asarray, host), tfm.cast_params(
        params_from_jax(host), "cpu")
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, tc.vocab_size, size=(1, 13))
    max_len = 32
    jst = jtfm.init_decode_state(jc, 1, max_len)
    tst = tfm.init_decode_state(tc, 1, max_len)
    chunk = jax.jit(lambda p, t, pos, st: jtfm.prefill_chunk(p, jc, t, pos,
                                                             st))
    logits = []
    for pos, n in _chunks(13, 4):
        toks = prompt[:, pos:pos + n]
        jl, jst = chunk(jp, jnp.asarray(toks, jnp.int32),
                        jnp.asarray(pos, jnp.int32), jst)
        with torch.inference_mode():
            tl, tst = tfm.prefill_chunk(tp, tc, torch.from_numpy(toks), pos,
                                        tst)
        jl = np.asarray(jl[..., :jc.vocab_size], np.float32)
        tl = tl[..., :tc.vocab_size].float().numpy()
        assert np.abs(tl - jl).max() <= TOL * np.abs(jl).max()
        logits.append(tl)
        jleaves = jax.tree_util.tree_flatten_with_path(jst)[0]
        for path, jleaf in jleaves:
            node = tst
            for key in path:
                node = node[key.key]
            want = np.asarray(jleaf, np.float32)
            err = np.abs(node.float().numpy() - want).max()
            assert err <= BF16_OUT * np.abs(want).max() + 1e-6, path
    # the port's chunks against its own whole-prompt prefill
    with torch.inference_mode():
        whole, wst = tfm.forward(tp, tc, tokens=torch.from_numpy(prompt),
                                 mode="prefill")
    whole = whole[..., :tc.vocab_size].float().numpy()
    got = np.concatenate(logits, axis=1)
    assert np.abs(got - whole).max() <= TOL * np.abs(whole).max()
    for u in wst["stack"]:
        for name in ("k", "v"):
            a = tst["stack"][u][name][:, :, :13].float()
            w = wst["stack"][u][name].float()
            assert (a - w).abs().max() <= BF16_OUT * w.abs().max()


def test_prefill_chunk_pos_int_and_tensor_bit_equal(model):
    _, tc, host = model
    tp = tfm.cast_params(params_from_jax(host), "cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tc.vocab_size, size=(2, 8)))
    with torch.inference_mode():
        a = tfm.init_decode_state(tc, 2, 24)
        b = tfm.init_decode_state(tc, 2, 24)
        for pos in (0, 8, 16):
            la, a = tfm.prefill_chunk(tp, tc, toks, pos, a)
            lb, b = tfm.prefill_chunk(tp, tc, toks, torch.tensor(pos), b)
            assert torch.equal(la, lb)
            for u in a["stack"]:
                for n in ("k", "v"):
                    assert torch.equal(a["stack"][u][n], b["stack"][u][n])


def test_prefill_chunk_refuses_recurrent_and_local_layers():
    for arch in ("recurrentgemma-2b", "rwkv6-1.6b"):
        cfg = reduced_config(get_config(arch))
        params = tfm.cast_params(
            tfm.init_params(cfg, torch.Generator().manual_seed(0)), "cpu")
        st = tfm.init_decode_state(cfg, 1, 16)
        with pytest.raises(ValueError, match="chunked prefill"):
            tfm.prefill_chunk(params, cfg, torch.zeros(1, 4, dtype=torch.long),
                              0, st)


# ---------------------------------------------------------------------------
# the engine against repro's
# ---------------------------------------------------------------------------
def test_requests_join_in_flight(model):
    def sc(S, m):
        eng = engine(S, m, max_len=32, batch_slots=2, **virtual(S))
        reqs = reqs_for(S, (4, 8, 5, 6, 3), max_new=4)
        return [eng], reqs, eng.run(reqs)

    (jengs, _), (tengs, tres) = run_both(model, sc)
    assert tengs[0].join_count == 5 and tengs[0].ledger().finished == 5
    assert all(len(r.tokens) == 4 for r in tres)


def test_short_request_not_blocked_by_long(model):
    def sc(S, m):
        eng = engine(S, m, max_len=48, batch_slots=2, **virtual(S))
        long, short = reqs_for(S, (6, 6), max_new=16, seed=3)
        short.max_new_tokens = 2
        return [eng], [long, short], eng.run([long, short])

    _, (_, (r_long, r_short)) = run_both(model, sc)
    assert r_short.latency_s < r_long.latency_s
    assert len(r_short.tokens) == 2 and len(r_long.tokens) == 16


def test_arrivals_respect_virtual_time(model):
    def sc(S, m):
        v = virtual(S)
        eng = engine(S, m, max_len=32, batch_slots=2, **v)
        reqs = reqs_for(S, (4, 6), max_new=3)
        res = eng.run([S.sv.Arrival(t=5.0, request=reqs[0], klass="a"),
                       S.sv.Arrival(t=5.5, request=reqs[1], klass="b")])
        assert v["clock"]() >= 5.5
        return [eng], reqs, res

    _, (_, tres) = run_both(model, sc)
    assert all(r.latency_s < 5.0 for r in tres)


def test_oversized_request_fails_and_watchdog_sheds(model):
    def sc(S, m):
        eng = engine(S, m, max_len=48, batch_slots=2,
                     **virtual(S, cost=0.01))
        big = reqs_for(S, (44,), max_new=8)[0]              # 44 + 8 > 48
        doomed = reqs_for(S, (6,), max_new=16, deadline_s=0.25, seed=1)[0]
        fine = reqs_for(S, (6,), max_new=16, seed=7)[0]
        reqs = [big, doomed, fine]
        return [eng], reqs, eng.run(reqs)

    _, (tengs, (big, doomed, fine)) = run_both(model, sc)
    assert big.failed and not fine.failed and not fine.shed
    assert doomed.shed and doomed.deadline_missed
    assert 0 < len(doomed.tokens) < 16
    led = tengs[0].ledger()
    assert led.complete and (led.failed, led.shed, led.finished) == (1, 1, 1)


def test_admission_sheds_on_queue_cap(model):
    def sc(S, m):
        eng = engine(S, m, max_len=32, batch_slots=2,
                     admission=S.sv.AdmissionControl(max_queue_batches=1),
                     **virtual(S))
        reqs = reqs_for(S, (4,) * 12, max_new=8)
        return [eng], reqs, eng.run(reqs)

    _, (tengs, tres) = run_both(model, sc)
    led = tengs[0].ledger()
    assert led.complete and led.shed > 0 and led.finished > 0
    assert led.shed == sum(r.shed for r in tres)


def test_drain_ledger_is_complete(model):
    def sc(S, m):
        eng = engine(S, m, max_len=32, batch_slots=2, **virtual(S))
        reqs = reqs_for(S, (4,) * 6, max_new=8)
        rids = [eng.submit(r) for r in reqs]
        eng.step()                  # 2 joined, 4 still queued
        led = eng.drain()
        assert led.complete and (led.shed, led.finished) == (4, 2)
        late = reqs_for(S, (4,), seed=9)[0]
        rids.append(eng.submit(late))           # refused while draining
        assert eng.result(rids[-1]).shed and eng.ledger().complete
        return [eng], reqs + [late], [eng.result(r) for r in rids]

    run_both(model, sc)


def test_drain_without_work_is_stepless(model):
    jc, tc, host = model
    _, t = sides(jc, tc, host)
    eng = engine(t, None, max_len=32)
    assert eng.drain() == tserving.Ledger(
        submitted=0, finished=0, shed=0, failed=0, in_flight=0, queued=0,
        evicted=0)
    assert eng.steps == 0


def test_bucketed_joins(model):
    """Whole-prompt joins right-padded to pow2 buckets (8 and 16): the
    same as repro's bucketed engine, and the same tokens as unbucketed."""
    lens = (3, 5, 6, 7, 9, 12)

    def sc(S, m):
        eng = engine(S, m, max_len=48, batch_slots=2,
                     prefill_bucketing=True, **virtual(S))
        assert {eng._prefill_len(n) for n in lens} == {8, 16}
        reqs = reqs_for(S, lens, max_new=6)
        return [eng], reqs, eng.run(reqs)

    _, (_, tres) = run_both(model, sc)
    jc, tc, host = model
    _, t = sides(jc, tc, host)
    plain = engine(t, None, max_len=48, batch_slots=2).run(
        reqs_for(t, lens, max_new=6))
    for a, b in zip(plain, tres):
        assert np.array_equal(a.tokens, b.tokens)


class OneShotChunkFault:
    """Raises on exactly the n-th chunk (tests/test_continuous.py's)."""

    def __init__(self, ch, at):
        self.ch, self.at, self.calls = ch, int(at), 0

    def __call__(self):
        self.calls += 1
        if self.calls == self.at:
            raise self.ch.InjectedFault(
                f"injected chunk fault at call {self.at}")


CHUNK_LENS = (5, 13, 27, 3, 21)


def test_chunked_prefill_with_a_fault_resumes(model):
    """Chunks of 4 under a step budget of 8, the 4th chunk faulting: the
    request requeues at its last committed chunk, no chunk runs twice,
    and the tokens are the whole-prompt engine's."""
    def sc(S, m):
        hook = OneShotChunkFault(S.ch, 4)
        eng = engine(S, m, max_len=64, batch_slots=2, prefill_chunk=4,
                     step_token_budget=8, chunk_fault_hook=hook,
                     **virtual(S))
        reqs = reqs_for(S, CHUNK_LENS, max_new=8)
        return [eng], reqs, eng.run(reqs)

    _, (tengs, tres) = run_both(model, sc)
    eng = tengs[0]
    assert len(eng.chunk_log) == 1 and eng.chunk_log[0].committed > 0
    assert eng.chunk_steps == sum(-(-n // 4) for n in CHUNK_LENS)
    assert sum(r.recovered for r in tres) == 1
    jc, tc, host = model
    _, t = sides(jc, tc, host)
    whole = engine(t, None, max_len=64, batch_slots=2).run(
        reqs_for(t, CHUNK_LENS, max_new=8))
    same = sum(np.array_equal(a.tokens, b.tokens)
               for a, b in zip(whole, tres))
    assert same >= len(CHUNK_LENS) - 1      # bf16: a near tie may part one


def test_chunk_retry_budget_exhaustion_fails(model):
    def sc(S, m):
        def always():
            raise S.ch.InjectedFault("permanent chunk fault")

        eng = engine(S, m, max_len=64, batch_slots=2, prefill_chunk=4,
                     chunk_fault_hook=always, max_retries=1, **virtual(S))
        reqs = reqs_for(S, (9, 5), max_new=4)
        return [eng], reqs, eng.run(reqs)

    _, (tengs, tres) = run_both(model, sc, min_frac=0.0)
    assert all(r.failed and r.retries == 2 for r in tres)
    assert tengs[0].ledger().failed == 2


def test_cancel_evict_and_adopt(model):
    """cancel frees only its request (in a slot or queued); evict hands the
    rest, a chunk checkpoint among them, to a second engine, which adopts
    and finishes them."""
    def sc(S, m):
        a = engine(S, m, max_len=64, batch_slots=2, prefill_chunk=4,
                   step_token_budget=6, **virtual(S))
        reqs = reqs_for(S, (6, 21, 7, 5), max_new=6)
        rids = [a.submit(r) for r in reqs]
        for _ in range(3):
            a.step()
        assert a.cancel(rids[0]) and a.cancel(rids[3])
        assert not a.cancel(rids[0]) and not a.cancel(999)
        moved = a.evict_in_flight()
        assert any(tr.chunk_state is not None and tr.prefill_done > 0
                   for tr in moved)
        b = engine(S, m, max_len=64, batch_slots=2, prefill_chunk=4,
                   **virtual(S))
        new = [b.adopt(tr) for tr in moved]
        while b.step():
            pass
        assert a.ledger().evicted == 2 and a.ledger().complete
        assert b.ledger().complete and b.ledger().finished == 2
        res = [a.result(rids[0]), a.result(rids[3])] + \
            [b.result(r) for r in new]
        order = [reqs[0], reqs[3]] + [tr.request for tr in moved]
        return [a, b], order, res

    _, (_, tres) = run_both(model, sc)
    assert tres[0].cancelled and tres[0].shed
    assert tres[1].cancelled and len(tres[1].tokens) == 0
    assert all(len(r.tokens) == 6 and not r.shed for r in tres[2:])


# ---------------------------------------------------------------------------
# the step cache on the CPU (static-step entries)
# ---------------------------------------------------------------------------
def port_side(model):
    jc, tc, host = model
    return sides(jc, tc, host)[1]


def test_warm_compile_warms_every_shape_and_serving_captures_none(model):
    t = port_side(model)
    lens = (3, 5, 6, 7, 9, 12)
    for chunk, kinds in ((None, {"decode": 1, "prefill": 2}),
                         (4, {"decode": 1, "chunk": 1})):
        cache = tserving.WidthVariantCompileCache(t.cfg)
        eng = engine(t, None, max_len=48, batch_slots=2, compile_cache=cache,
                     prefill_chunk=chunk, **virtual(t))
        n = eng.warm_compile([], lens)
        got = {}
        for e in cache.events:
            got[e.kind] = got.get(e.kind, 0) + (e.outcome == "compiled")
        assert got == kinds and n == sum(kinds.values())
        count = cache.tracer.count
        res = eng.run(reqs_for(t, lens, max_new=5))
        assert cache.tracer.count == count
        assert cache.stats["misses"] == 0 and cache.stats["fallbacks"] == 0
        assert eng.ledger().complete and all(len(r.tokens) == 5
                                             for r in res)


def mlp_plan(S, *, sliced):
    """A plan halving every MLP, its economics pinned: ``sliced`` makes the
    modeled saving pay for a capture, else the crossover masks it."""
    _, modules = S.sv.serving_templates(S.cfg, _hw(S), sites=("mlp",))
    return S.sv.WidthPlan(
        traffic=S.sv.TrafficClass("burst", 96),
        widths={n: S.cfg.d_ff // 2 for n in modules},
        latency_s=0.5 if sliced else 0.999, baseline_latency_s=1.0,
        satisfied=True, modules=modules)


def _hw(S):
    if S.jax:
        from repro.core import TPU_V5E
    else:
        from repro_torch.core import TPU_V5E
    return TPU_V5E


class Scripted:
    """A degrader stand-in: returns the scripted plans in order, then holds
    the last (tests/test_continuous.py's)."""

    def __init__(self, plans):
        self.plans = list(plans)

    def select(self, tokens):
        plan = self.plans[0]
        if len(self.plans) > 1:
            self.plans.pop(0)
        return plan

    def observe(self, signal):
        return 0


def cached_engine(S, m, plan, *, cache, **kw):
    params = S.params if S.jax else tfm.cast_params(S.params, "cpu")
    swapper = S.sv.WidthSwapper(params, S.cfg)
    eng = S.sv.ContinuousServeEngine(
        params, S.cfg, **S.kw, max_len=48, batch_slots=2,
        swapper=swapper, compile_cache=cache, max_retries=3,
        boundary_every=2, boundary_cooldown=1000,
        admission=S.sv.AdmissionControl(max_queue_batches=100),
        degrader=Scripted([plan]), **virtual(S), **kw)
    if m is not None:
        m.attach(eng)
    return eng


@pytest.mark.parametrize("sliced", [True, False])
def test_warm_boundary_replays_the_plans_entries(model, sliced):
    """A sliced plan replays its own entries, a masked one the full-width
    entries on its masked weights; no capture while serving; the same
    ledger, boundaries and tokens as repro's cached engine."""
    def sc(S, m):
        cache = S.sv.WidthVariantCompileCache(S.cfg)
        plan = mlp_plan(S, sliced=sliced)
        eng = cached_engine(S, m, plan, cache=cache)
        assert cache.decide(plan) == ("sliced" if sliced else "masked")
        assert eng.warm_compile([plan], prefill_lengths=(6,)) > 0
        count = cache.tracer.count
        reqs = reqs_for(S, (6, 6), max_new=8)
        res = eng.run(reqs)
        if not S.jax:
            assert cache.tracer.count == count
            assert cache.stats["misses"] == 0 and cache.stats["hits"] > 0
        assert eng._masked_active is not sliced
        assert (cache.active_key == cache.full_key) is not sliced
        return [eng], reqs, res

    _, (tengs, tres) = run_both(model, sc)
    assert any(b.outcome == "ok" for b in tengs[0].boundary_log)
    assert all(len(r.tokens) == 8 for r in tres)


@pytest.mark.parametrize("step", ["lookup", "compile"])
def test_cache_faults_serve_eagerly_with_nothing_lost(model, step):
    t = port_side(model)
    plan = mlp_plan(t, sliced=True)
    want = cached_engine(t, None, plan, cache=None).run(
        reqs_for(t, (6, 6), max_new=8))
    inj = tchaos.CompileFailureInjector(1.0, steps=(step,))
    cache = tserving.WidthVariantCompileCache(t.cfg, fault_hook=inj)
    eng = cached_engine(t, None, plan, cache=cache)
    eng.warm_compile([plan], prefill_lengths=(6,))
    got = eng.run(reqs_for(t, (6, 6), max_new=8))
    assert inj.injected >= 1 and cache.stats["fallbacks"] >= 1
    assert cache.stats["hits"] == 0
    led = eng.ledger()
    assert led.complete and led.failed == 0
    for a, b in zip(want, got):
        assert np.array_equal(a.tokens, b.tokens)


def test_cached_chunks_keep_each_requests_checkpoint(model):
    """Two requests prefill at once through one cached chunk entry: each
    keeps its own checkpoint, so the tokens and every committed checkpoint
    equal the uncached engine's bit for bit (were a request handed the
    entry's static states, the other's next chunk would overwrite them)."""
    t = port_side(model)

    def serve(cache):
        eng = engine(t, None, max_len=48, batch_slots=2, prefill_chunk=4,
                     prefill_bucketing=True, compile_cache=cache,
                     **virtual(t))
        if cache is not None:
            eng.warm_compile([], (13, 11))
        committed = []
        commit = eng._commit_prefill

        def keep(i, tr, logits, plen, clen):
            committed.append({u: {n: x.clone() for n, x in d.items()}
                              for u, d in tr.chunk_state["stack"].items()})
            return commit(i, tr, logits, plen, clen)

        eng._commit_prefill = keep
        res = eng.run(reqs_for(t, (13, 11), max_new=6, seed=8))
        assert eng.chunk_steps == 7
        return res, committed

    cache = tserving.WidthVariantCompileCache(t.cfg)
    want, want_ck = serve(None)
    got, got_ck = serve(cache)
    assert cache.stats["hits"] >= 7 and cache.stats["misses"] == 0
    for a, b in zip(want, got):
        assert np.array_equal(a.tokens, b.tokens)
    assert len(got_ck) == len(want_ck) == 2
    for a, b in zip(want_ck, got_ck):
        for u in a:
            for n in a[u]:
                assert torch.equal(a[u][n], b[u][n])


@pytest.fixture(scope="module")
def unscaled():
    """The reduced qwen of tests/test_hedged_serving.py with repro's own
    initialization: no spread embedding, so that a decode step on another
    request's KV cache shows in the tokens (with the spread, each greedy
    token repeats the last one, whatever the cache holds)."""
    jc = jax_reduced(jax_get_config("qwen1.5-0.5b"), d_model=128,
                     n_layers=2, d_ff=576)
    tc = reduced_config(get_config("qwen1.5-0.5b"), d_model=128,
                        n_layers=2, d_ff=576)
    host = jax.device_get(jtfm.init_params(jax.random.PRNGKey(0), jc))
    return tc, params_from_jax(host)


def alternating_engines(tc, params, caches) -> list:
    """One continuous engine per cache, each warmed for a 9-token prompt
    and given two requests of its own (12 new tokens each); the engines
    step alternately, as a router steps its replicas. Returns each
    engine's tokens."""
    engs, rids = [], []
    for k, cache in enumerate(caches):
        eng = tserving.ContinuousServeEngine(
            params, tc, device="cpu", max_len=48, batch_slots=2,
            compile_cache=cache)
        eng.warm_compile([], (9,))
        rng = np.random.default_rng(20 + k)
        rids.append([eng.submit(tserving.Request(
            prompt=rng.integers(1, tc.vocab_size, size=(9,))
            .astype(np.int32), max_new_tokens=12)) for _ in range(2)])
        engs.append(eng)
    while any(e._outstanding() for e in engs):
        for e in engs:
            if e._outstanding():
                e.step()
    return [[e.result(r).tokens.tolist() for r in rs]
            for e, rs in zip(engs, rids)]


def test_two_engines_on_one_step_cache(unscaled):
    """A decode entry's static states are the slot state of the engine
    that replays it. Two continuous engines on one step cache must not
    decode on each other's KV caches: either the second one is refused,
    or each serves the tokens it serves on a cache of its own."""
    tc, params = unscaled
    own = alternating_engines(
        tc, params, [tserving.WidthVariantCompileCache(tc) for _ in "ab"])
    assert own[0] != own[1]
    shared = tserving.WidthVariantCompileCache(tc)
    try:
        got = alternating_engines(tc, params, [shared, shared])
    except ValueError as e:
        assert "step cache" in str(e), e
    else:
        assert got == own


def test_a_step_cache_serves_one_live_continuous_engine(unscaled):
    """The cache refuses a second live continuous engine, and a static
    engine beside one (its decode would overwrite the slot state); once
    the holder is gone the cache passes on; static engines share one."""
    tc, params = unscaled
    cache = tserving.WidthVariantCompileCache(tc)

    def cont():
        return tserving.ContinuousServeEngine(params, tc, device="cpu",
                                              max_len=48, compile_cache=cache)

    def static():
        return tserving.ServeEngine(params, tc, device="cpu", max_len=48,
                                    compile_cache=cache)

    first = cont()
    with pytest.raises(ValueError, match="live ContinuousServeEngine"):
        cont()
    with pytest.raises(ValueError, match="live ContinuousServeEngine"):
        static()
    del first
    second = cont()
    assert cache._holder_engine() is second
    del second
    statics = [static(), static()]
    with pytest.raises(ValueError, match="live ServeEngine"):
        cont()
    del statics
    assert cont().compile_cache is cache


# ---------------------------------------------------------------------------
# the other families
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-1.6b",
                                  "granite-moe-1b-a400m"])
def test_families_match_repro(arch):
    jc, tc, host = granite_model() if arch.startswith("granite") \
        else recurrent_model(arch)

    def sc(S, m):
        eng = engine(S, m, max_len=32, batch_slots=2, **virtual(S))
        reqs = reqs_for(S, (8, 5, 12), max_new=6, seed=4)
        return [eng], reqs, eng.run(reqs)

    # small models' logits are flat: ties are common, so a quarter suffices
    run_both((jc, tc, host), sc, min_frac=0.25)
    t = sides(jc, tc, host)[1]
    for kw in ({"prefill_chunk": 4}, {"prefill_bucketing": True}):
        with pytest.raises(ValueError, match="pure global-attention"):
            engine(t, None, max_len=32, **kw)


# ---------------------------------------------------------------------------
# the card by default; the CLI
# ---------------------------------------------------------------------------
def test_engine_and_cli_default_to_the_card(model):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would run on it")
    t = port_side(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.ContinuousServeEngine(t.params, t.cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--reduced"])


def test_cli_runs_on_cpu(capsys):
    out = cli_main(["--device", "cpu", "--reduced", "--requests", "5",
                    "--prompt-len", "9", "--new-tokens", "4",
                    "--prefill-chunk", "4", "--step-token-budget", "6",
                    "--rate", "500", "--cached"])
    assert out["ledger"].complete and out["ledger"].finished == 5
    assert all(len(r.tokens) == 4 for r in out["results"])
    text = capsys.readouterr().out
    assert "tok/s" in text and "p99" in text and "'misses': 0" in text
