"""Pipelined decode chains in the port's engine
(llama_box_tpu_torch/server/engine.py: _fill_chain_queue,
_consume_pending_chain, _speculate_post_prefill), on the tiny fixture
GGUF, f32 weights and KV cache, on the CPU. The cases mirror the JAX
engine's own (tests/test_engine.py): chains dispatched before the host
has the tokens of the chain before must give exactly the tokens of
strictly alternating chains and of per-token decode, across finishes,
cancels and re-admissions while a speculated chain is in flight; no
speculated chain covers a position at or past a slot's capacity; and the
greedy tokens still equal the JAX engine's (which pipelines by default
too). A slot that runs past its capacity shifts at the same tokens in
every mode, and a request that shares a prefix with a decoding slot takes
its rows while chains are in flight. Every wait on a result has a
timeout."""

import queue
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.gguf import GGUFFile as JGGUFFile
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.sampling import SamplerParams as JSamplerParams
from llama_box_tpu.server import Engine as JEngine, EngineConfig as JEngineConfig
from llama_box_tpu.server.task import CompletionsTask as JTask
from llama_box_tpu.tokenizer import Tokenizer as JTokenizer
from llama_box_tpu_torch.gguf import GGUFFile
from llama_box_tpu_torch.models.loader import load_model
from llama_box_tpu_torch.sampling import SamplerParams
from llama_box_tpu_torch.server import engine as engine_mod
from llama_box_tpu_torch.server.engine import Engine, EngineConfig
from llama_box_tpu_torch.server.task import CompletionsTask
from llama_box_tpu_torch.tokenizer import Tokenizer
from llama_box_tpu_torch.utils.staging import HostCopies, StagedBuffer
from .fixtures.make_tiny_model import write_tiny_model

TIMEOUT = 120
# the fixture seed of tests/test_torch_engine.py: its greedy steps for
# JAX_PROMPTS clear a 1e-3 top-2 margin, so the JAX comparison is not a
# comparison of near ties
SEED = 2
JAX_PROMPTS = ("the quick brown fox", "a b c d e f g h i j k l",
               "hello world, this is a longer prompt for the third slot")


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny.gguf")
    write_tiny_model(path, seed=SEED)
    cfg, params = load_model(path, dtype=torch.float32, device="cpu")
    with GGUFFile(path) as g:
        tok = Tokenizer.from_gguf(g)
    return path, cfg, params, tok


def _engine(model, start=True, **kw):
    _, cfg, params, tok = model
    kw.setdefault("n_slots", 2)
    kw.setdefault("n_ctx", 64)
    kw.setdefault("n_ubatch", 16)
    kw.setdefault("kv_dtype", "float32")
    eng = Engine(cfg, params, tok, EngineConfig(**kw), device="cpu")
    if start:
        eng.start()
    return eng


def _final(task, timeout=TIMEOUT):
    while True:
        kind, payload = task.result_q.get(timeout=timeout)
        if kind == "final":
            return payload
        if kind == "error":
            raise payload


def _run(eng, specs, late=0):
    """Submit (prompt, SamplerParams, max_tokens) tasks, the last `late`
    of them from the engine's thread when it first goes to emit a
    chain's tokens (in a pipelined engine the next chains are in flight
    by then); their generated tokens and finish reasons."""
    return [(f.generated, f.finish_reason) for f in _finals(eng, specs, late)]


def _finals(eng, specs, late=0):
    """_run's tasks, finished."""
    tok = eng.tokenizer
    tasks = [CompletionsTask(tok.encode(p), sp, tokenizer=tok,
                             max_tokens=n, stream=False)
             for p, sp, n in specs]
    held = tasks[len(tasks) - late:]
    if held:
        emit = eng._emit_chain

        def submit_held(dec, rec):
            while held:
                eng.submit(held.pop(0))
            return emit(dec, rec)
        eng._emit_chain = submit_held
    for t in tasks[:len(tasks) - late]:
        eng.submit(t)
    return [_final(t) for t in tasks]


def _spy_consumes(eng) -> dict:
    """Count, at each consume of a speculated chain, the slots whose task
    it was run for has finished ("finished") and those that hold another
    task by then ("readmitted")."""
    seen = {"finished": 0, "readmitted": 0}
    consume = eng._consume_pending_chain

    def spy(dec):
        for i, t in enumerate(eng._chain_q[0].tasks):
            now = eng.slots[i].task
            if t is not None and now is not t:
                seen["finished"] += 1
                seen["readmitted"] += now is not None
        return consume(dec)
    eng._consume_pending_chain = spy
    return seen


def _modes(model, specs, chain=4, late=0, **kw):
    """The same tasks pipelined (depth 2, the default), deeper (depth 3),
    strictly alternating and per token (`late` as in _run); each mode's
    outputs, speculated chain count and what the consumes of speculated
    chains met."""
    out = {}
    for name, ekw in (("pipe", dict(decode_chain=chain)),
                      ("deep", dict(decode_chain=chain, pipeline_depth=3)),
                      ("alt", dict(decode_chain=chain, pipeline_chain=False)),
                      ("tok", dict(decode_chain=1))):
        eng = _engine(model, start=False, **ekw, **kw)
        out[name, "seen"] = _spy_consumes(eng)
        eng.start()
        try:
            out[name] = _run(eng, specs, late)
            out[name, "spec"] = eng.metrics.n_spec_chains
        finally:
            eng.stop()
    return out


def test_pipeline_defaults_are_the_jax_engines():
    ecfg, jcfg = EngineConfig(), JEngineConfig()
    assert (ecfg.pipeline_chain, ecfg.pipeline_depth) == (
        jcfg.pipeline_chain, jcfg.pipeline_depth) == (True, 2)


@pytest.mark.parametrize("sampling", ["seeded", "greedy"])
def test_decode_chain_pipeline_identity(model, sampling):
    """4 staggered tasks over 2 slots, the last two arriving while the
    first chains are in flight (finishes and re-admissions while
    speculated chains are in flight): pipelined, depth 3, alternating and
    per-token decode give identical tokens. Seeded draws are a counter
    hash of (seed, step), so seeded output is identical too."""
    prompts = [("a b c", 17), ("x y", 5), ("c d a", 9), ("b", 13)]
    specs = [(p, SamplerParams(temp=0.8, seed=100 + i, penalty_repeat=1.1)
              if sampling == "seeded" else SamplerParams(temp=0.0), n)
             for i, (p, n) in enumerate(prompts)]
    out = _modes(model, specs, late=2)
    assert out["pipe"] == out["alt"] == out["tok"] == out["deep"]
    assert [len(g) for g, _ in out["pipe"]] == [n for _, n in prompts]
    assert out["pipe", "spec"] > 0 and out["deep", "spec"] > 0
    assert out["alt", "spec"] == out["tok", "spec"] == 0
    # the hard transitions happened with a speculated chain in flight
    for name in ("pipe", "deep"):
        seen = out[name, "seen"]
        assert seen["finished"] > 0 and seen["readmitted"] > 0, (name, seen)


def test_a_new_task_at_a_chains_position_is_not_covered(model):
    """Slot 0's task ends after the post-prefill chain (budget 5) while
    chains speculated for it are in flight; the next task lands in slot 0
    with its prompt (8 tokens) ending exactly where the oldest of those
    chains starts (4 + 4); it arrives while they are in flight. Only the task identity tells them apart: that
    chain is not consumed for the new task, whose tokens equal those of
    strictly alternating chains."""
    specs = [("a b", SamplerParams(temp=0.8, seed=1), 5),
             ("x", SamplerParams(temp=0.8, seed=2), 20),
             ("cd e f", SamplerParams(temp=0.8, seed=3), 8)]
    tok = model[3]
    assert [len(tok.encode(p)) for p, _, _ in specs[::2]] == [4, 8]
    out = {}
    for name, kw in (("pipe", {}), ("alt", dict(pipeline_chain=False))):
        eng = _engine(model, start=False, decode_chain=4, **kw)
        out[name, "seen"] = _spy_consumes(eng)
        eng.start()
        try:
            out[name] = _run(eng, specs, late=1)
        finally:
            eng.stop()
    assert out["pipe"] == out["alt"]
    assert [len(g) for g, _ in out["pipe"]] == [5, 20, 8]
    assert out["pipe", "seen"]["readmitted"] > 0


def test_pipeline_no_starvation(model):
    """A slot admitted while another slot's chains are pipelined joins a
    joint chain within a bounded number of passes (JAX
    test_pipeline_no_starvation): the queue is refilled only while the
    pending chain covers every decoding slot."""
    eng = _engine(model, n_ctx=128, decode_chain=4)
    tok = eng.tokenizer
    try:
        long_t = CompletionsTask(tok.encode("a b c"),
                                 SamplerParams(temp=0.0, ignore_eos=True),
                                 tokenizer=tok, max_tokens=40, stream=True)
        eng.submit(long_t)
        n_seen = 0
        while n_seen < 4:
            kind, payload = long_t.result_q.get(timeout=TIMEOUT)
            if kind == "delta":
                n_seen += 1
            elif kind in ("final", "error"):
                raise AssertionError(f"long task ended early: {kind}")
        short_t = CompletionsTask(tok.encode("x"), SamplerParams(temp=0.0),
                                  tokenizer=tok, max_tokens=2, stream=False)
        eng.submit(short_t)
        long_during, short_final = 0, None
        deadline = time.time() + TIMEOUT
        while short_final is None and time.time() < deadline:
            try:
                kind, payload = short_t.result_q.get(timeout=0.05)
                if kind == "final":
                    short_final = payload
                elif kind == "error":
                    raise payload
            except queue.Empty:
                pass
            while True:
                try:
                    kind, payload = long_t.result_q.get_nowait()
                except queue.Empty:
                    break
                if kind == "delta":
                    long_during += 1
                elif kind == "error":
                    raise payload
        assert short_final is not None, "short task starved"
        assert len(short_final.generated) == 2
        assert long_during <= 20, long_during
        assert eng.metrics.n_spec_chains > 0
    finally:
        eng.stop()


def _spy_refills(eng) -> list:
    """Record each chain speculated by _fill_chain_queue (one whose token0
    comes from the chain before while slots decode): whether a task
    waited in the queue, whether a slot was idle, the queue's length once
    it went out, its steps, and the least budget a covered slot had left
    beyond the steps already in flight ahead of the host."""
    seen = []
    dispatch = eng._dispatch_chain

    def spy(dec, K, pos, token0=None):
        rec = dispatch(dec, K, pos, token0)
        if token0 is not None and any(s.state == "decode"
                                      for s in eng.slots):
            seen.append(dict(
                waiting=not eng.queue.empty(),
                idle=any(s.state == "idle" for s in eng.slots),
                queued=len(eng._chain_q) + 1, k=K,
                slack=min(eng._remaining(s) - (pos[s.idx] - s.pos)
                          for s in dec)))
        return rec
    eng._dispatch_chain = spy
    return seen


def test_one_short_chain_ahead_while_a_slot_is_idle(model):
    """One task on two slots: while the other slot is idle a request may
    arrive into it and would queue behind every chain in flight, so one
    chain fewer is speculated (depth 2: one), of at most _IDLE_CHAIN
    steps. Tokens equal strictly alternating decode."""
    specs = [("a b c", SamplerParams(temp=0.8, seed=5), 40)]
    eng = _engine(model, start=False, decode_chain=16)
    seen = _spy_refills(eng)
    eng.start()
    try:
        piped = _run(eng, specs)
    finally:
        eng.stop()
    assert seen and all(r["idle"] for r in seen)
    assert max(r["queued"] for r in seen) == 1
    assert max(r["k"] for r in seen) == engine_mod._IDLE_CHAIN == 4
    eng = _engine(model, decode_chain=16, pipeline_chain=False)
    try:
        assert _run(eng, specs) == piped
    finally:
        eng.stop()


def test_no_chain_past_a_budget_while_a_task_waits(model):
    """Three tasks on two slots: while the third waits for a slot, no
    chain is speculated once the chains in flight cover a slot's whole
    budget (that slot frees at their end and the waiting task's prefill
    would queue behind the later ones). Tokens equal strictly
    alternating decode."""
    specs = [(p, SamplerParams(temp=0.0), n)
             for p, n in (("a b", 6), ("x y z", 30), ("c d", 10))]
    eng = _engine(model, start=False, decode_chain=4)
    seen = _spy_refills(eng)
    eng.start()
    try:
        piped = _run(eng, specs)
    finally:
        eng.stop()
    waited = [r for r in seen if r["waiting"]]
    assert waited, "no chain was speculated while a task waited"
    assert all(r["slack"] > 0 for r in waited), waited
    eng = _engine(model, decode_chain=4, pipeline_chain=False)
    try:
        assert _run(eng, specs) == piped
    finally:
        eng.stop()


def test_post_prefill_speculation_and_tail_shrink(model):
    """The first ramped chain goes out from the prefill's device-resident
    first tokens before the host waits for them (counted by the engine's
    metrics), and odd budgets walk the shrink ladder; greedy output equals
    per-token, strictly alternating decode (JAX
    test_post_prefill_speculation_and_tail_shrink)."""
    prompts = [("a b c", 13), ("x y", 7)]
    specs = [(p, SamplerParams(temp=0.0), n) for p, n in prompts]
    eng = _engine(model, decode_chain=16, chain_ramp=4, pipeline_depth=2)
    try:
        t0 = time.monotonic()
        piped = _run(eng, specs)
        wall_ms = (time.monotonic() - t0) * 1e3
        m = eng.metrics
    finally:
        eng.stop()
    assert m.n_spec_post_prefill > 0, "post-prefill speculation never engaged"
    # decode windows do not overlap one another (each starts at its
    # chain's dispatch or at the end of the window before, as in JAX)
    assert m.t_decode_total_ms <= wall_ms
    eng = _engine(model, decode_chain=1, pipeline_chain=False)
    try:
        assert _run(eng, specs) == piped
        assert eng.metrics.n_spec_post_prefill == 0
    finally:
        eng.stop()


def test_slot_past_capacity_shifts_at_the_same_token(model):
    """A slot that runs past its capacity context-shifts at the same
    tokens pipelined, deeper, strictly alternating and per token, ends
    with "length" at its budget with the same tokens, and no chain
    (speculated or not) covers a position at or past its capacity."""
    prompt = "a b c d e f"
    outs = {}
    for name, kw in (("pipe", dict(decode_chain=16)),
                     ("pipe4", dict(decode_chain=4, pipeline_depth=3)),
                     ("alt", dict(decode_chain=16, pipeline_chain=False)),
                     ("tok", dict(decode_chain=1))):
        eng = _engine(model, start=False, n_slots=1, n_ctx=32, **kw)
        ends, shifts = [], []
        dispatch, shift = eng._dispatch_chain, eng._context_shift

        def spy(dec, K, pos, *a, ends=ends, dispatch=dispatch):
            ends.extend(pos[s.idx] + K for s in dec)
            return dispatch(dec, K, pos, *a)

        def spy_shift(s, shifts=shifts, shift=shift):
            shifts.append((len(s.task.generated), s.pos))
            return shift(s)
        eng._dispatch_chain = spy
        eng._context_shift = spy_shift
        eng.start()
        try:
            (outs[name],) = _run(eng, [(prompt, SamplerParams(
                temp=0.0, ignore_eos=True), 100)])
            outs[name, "spec"] = eng.metrics.n_spec_chains
            outs[name, "shifts"] = shifts
        finally:
            eng.stop()
        assert ends and max(ends) <= eng.slot_ctx, (name, ends)
    gen, reason = outs["pipe"]
    assert reason == "length" and len(gen) == 100
    assert len(outs["pipe", "shifts"]) >= 2
    assert all(pos == eng.slot_ctx for _, pos in outs["pipe", "shifts"])
    assert outs["pipe"] == outs["pipe4"] == outs["alt"] == outs["tok"]
    assert outs["pipe", "shifts"] == outs["pipe4", "shifts"] \
        == outs["alt", "shifts"] == outs["tok", "shifts"]
    assert outs["pipe", "spec"] > 0 and outs["pipe4", "spec"] > 0


def test_prefix_share_admitted_while_chains_are_in_flight(model):
    """A request that shares a long prefix with a decoding slot arrives
    while that slot's speculated chains are in flight: it takes the
    slot's rows by copy (n_cached covers the prefix), and its tokens and
    the sibling's equal those of strictly alternating and per-token
    decode, and of the same request alone on a fresh engine."""
    shared = "the quick brown fox jumps over the lazy dog and"
    specs = [(shared + " runs far", SamplerParams(temp=0.0), 24),
             (shared + " sleeps here", SamplerParams(temp=0.0), 6)]
    n_shared = len(model[3].encode(shared))
    out = {}
    for name, kw in (("pipe", {}), ("alt", dict(pipeline_chain=False)),
                     ("tok", dict(decode_chain=1))):
        kw.setdefault("decode_chain", 4)
        eng = _engine(model, start=False, n_ctx=128, cache_share_min=4,
                      **kw)
        copies = []
        share = eng._share_prefix

        def spy(best, prompt, reuse, share=share, eng=eng, copies=copies):
            n = share(best, prompt, reuse)
            if n > reuse:
                copies.append(len(eng._chain_q))
            return n
        eng._share_prefix = spy
        eng.start()
        try:
            finals = _finals(eng, specs, late=1)
        finally:
            eng.stop()
        out[name] = [(f.generated, f.finish_reason) for f in finals]
        assert finals[1].n_cached >= n_shared - 1, (name, finals[1].n_cached)
        assert len(copies) == 1, (name, copies)
        out[name, "in_flight"] = copies[0]
    assert out["pipe"] == out["alt"] == out["tok"]
    assert out["pipe", "in_flight"] > 0          # chains were in flight
    assert out["alt", "in_flight"] == out["tok", "in_flight"] == 0
    fresh = _engine(model, n_slots=1, n_ctx=64, decode_chain=4)
    try:
        assert _run(fresh, specs[1:]) == out["pipe"][1:]
    finally:
        fresh.stop()


def test_cancel_mid_flight_frees_the_slot(model):
    """A task cancelled while speculated chains are in flight frees its
    slot; the next task in that slot gives what it gives on a fresh
    engine (its sampler state and KV rebuilt by admission)."""
    nxt = ("b a", SamplerParams(temp=0.8, seed=7, penalty_repeat=1.2), 12)
    eng = _engine(model, n_slots=1, n_ctx=128, decode_chain=4,
                  prompt_cache=False)
    tok = eng.tokenizer
    try:
        first = CompletionsTask(tok.encode("c c b"),
                                SamplerParams(temp=0.9, seed=3),
                                tokenizer=tok, max_tokens=80, stream=True)
        eng.submit(first)
        n_seen = 0
        while n_seen < 6:
            kind, payload = first.result_q.get(timeout=TIMEOUT)
            assert kind == "delta", kind
            n_seen += 1
        first.cancelled = True
        spec = eng.metrics.n_spec_chains
        (after,) = _run(eng, [nxt])
        assert eng.slots[0].task is None
    finally:
        eng.stop()
    assert spec > 0
    assert len(first.generated) < 80
    fresh = _engine(model, n_slots=1, n_ctx=128, decode_chain=4,
                    prompt_cache=False)
    try:
        assert _run(fresh, [nxt]) == [after]
    finally:
        fresh.stop()


def test_a_failed_wait_fails_the_tasks_and_clears_the_queue(model):
    """A copy that fails raises at consume: the pass fails its tasks
    through _fail_all, which clears the queue; nothing continues in
    lockstep, and the engine serves the next request as a fresh one."""
    spec = ("a b c", SamplerParams(temp=0.0), 30)
    eng = _engine(model, decode_chain=4)
    wait = eng._copies.wait
    calls = {"n": 0}

    def failing(handle):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("copy failed")
        return wait(handle)
    eng._copies.wait = failing
    try:
        t = CompletionsTask(eng.tokenizer.encode(spec[0]), spec[1],
                            tokenizer=eng.tokenizer, max_tokens=spec[2],
                            stream=False)
        eng.submit(t)
        with pytest.raises(RuntimeError, match="copy failed"):
            _final(t)
        deadline = time.time() + TIMEOUT
        while eng._chain_q and time.time() < deadline:
            time.sleep(0.01)
        assert eng._chain_q == []
        after = _run(eng, [spec])
    finally:
        eng.stop()
    fresh = _engine(model, decode_chain=4)
    try:
        assert _run(fresh, [spec]) == after
    finally:
        fresh.stop()


def test_greedy_tokens_match_jax_engine_pipelined(model):
    """Three concurrent greedy requests through a K=16 chain, both engines
    at their defaults (pipelined, depth 2): the port's tokens equal the
    JAX engine's, and the port did speculate."""
    path, cfg, params, tok = model
    kw = dict(n_slots=3, n_ctx=3 * 96, n_ubatch=16, kv_dtype="float32",
              decode_chain=16)
    eng = _engine(model, **kw)
    try:
        port = _run(eng, [(p, SamplerParams(temp=0.0), 24)
                          for p in JAX_PROMPTS])
        assert eng.metrics.n_spec_chains > 0
    finally:
        eng.stop()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLAMA_BOX_TPU_FORCE_FLASH", "1")
        jcfg, jparams = jax_load(path, dtype=jnp.float32)
        with JGGUFFile(path) as g:
            jtok = JTokenizer.from_gguf(g)
        jeng = JEngine(jcfg, jparams, jtok, JEngineConfig(**kw))
        jeng.start()
        try:
            tasks = [JTask(jtok.encode(p), JSamplerParams(temp=0.0),
                           tokenizer=jtok, max_tokens=24)
                     for p in JAX_PROMPTS]
            for t in tasks:
                jeng.submit(t)
            jax_out = [_final(t).generated for t in tasks]
        finally:
            jeng.stop()
    assert [g for g, _ in port] == jax_out


# -- the staging pieces the pipeline stands on --------------------------------


def test_host_copies_hold_each_programs_values():
    """Each copy lands in its own set; a set is not handed out again
    before it is waited on or dropped (more than n_sets in flight
    raises), and wait returns copies the next start cannot touch."""
    hc = HostCopies(2, [(8, torch.int32), (8, torch.float32)], "cpu")
    a = hc.start([torch.arange(6, dtype=torch.int32).view(2, 3), None])
    b = hc.start([torch.full((4,), 7, dtype=torch.int32),
                  torch.ones(2, 2)])
    with pytest.raises(RuntimeError, match="in use"):
        hc.start([torch.zeros(1, dtype=torch.int32), None])
    va = hc.wait(a)
    c = hc.start([torch.full((2, 3), -1, dtype=torch.int32), None])
    np.testing.assert_array_equal(va[0], np.arange(6).reshape(2, 3))
    assert va[1] is None
    vb = hc.wait(b)
    np.testing.assert_array_equal(vb[0], [7, 7, 7, 7])
    np.testing.assert_array_equal(vb[1], np.ones((2, 2)))
    hc.drop(c)
    hc.reset()
    hc.start([torch.zeros(1, dtype=torch.int32), None])
    hc.start([torch.zeros(1, dtype=torch.int32), None])


def test_staged_buffer_takes_its_host_buffers_in_turn():
    """host() hands out the n_host buffers in turn; push() copies from the
    one host() gave last."""
    sb = StagedBuffer(4, torch.int64, "cpu", n_host=3)
    seen = []
    for i in range(6):
        h = sb.host()
        h[:] = i
        seen.append(h.ctypes.data)
        sb.push(2)
        assert sb.dev.tolist() == [i, i, 0, 0]
    assert len(set(seen)) == 3 and seen[:3] == seen[3:]
    sb.host()[:] = 9
    sb.push()
    assert sb.dev.tolist() == [9] * 4
