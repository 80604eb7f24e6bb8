"""Speculative decoding in the port (llama_box_tpu_torch: sampling.verify_impl,
server/ngram.py, the verify forward of models/llama.py and the engine's
n-gram, one-round, M-round and pipelined draft-model passes), held against
the JAX package on the CPU, case for case with tests/test_speculative.py:
the tiny fixture GGUF, f32 weights and (unless a case says otherwise) f32
KV cache. The invariant: greedy output with drafting equals plain greedy
decode, the port's and the JAX engine's."""

import dataclasses
import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu import cli as jcli
from llama_box_tpu.gguf import GGUFFile as JGGUFFile
from llama_box_tpu.models import llama as jllama
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.sampling import SamplerParams as JSamplerParams
from llama_box_tpu.sampling import init_sampler_state as j_init_state
from llama_box_tpu.sampling import make_sampler_arrays as j_arrays
from llama_box_tpu.sampling import reset_slot as j_reset_slot
from llama_box_tpu.sampling import verify_impl as j_verify_impl
from llama_box_tpu.server import Engine as JEngine
from llama_box_tpu.server import EngineConfig as JEngineConfig
from llama_box_tpu.server.ngram import NgramCache as JNgramCache
from llama_box_tpu.server.task import CompletionsTask as JTask
from llama_box_tpu.tokenizer import Tokenizer as JTokenizer
from llama_box_tpu_torch import cli
from llama_box_tpu_torch.gguf import GGUFFile
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models.loader import load_model
from llama_box_tpu_torch.sampling import (SamplerParams, init_sampler_state,
                                          make_sampler_arrays, reset_slot,
                                          verify_impl)
from llama_box_tpu_torch.server.engine import Engine, EngineConfig
from llama_box_tpu_torch.server.ngram import NgramCache
from llama_box_tpu_torch.server.task import CompletionsTask
from llama_box_tpu_torch.tokenizer import Tokenizer
from .fixtures.make_tiny_model import write_tiny_model

TIMEOUT = 120
V = 64
# the fixture seed of tests/test_torch_engine.py (its greedy steps clear a
# 1e-3 top-2 margin on these prompts at f32)
SEED = 2
REPEAT = "a b c d a b c d a b c d"       # gives the n-gram cache hits
FOX = "the quick brown fox jumps"


# -- verify_impl ------------------------------------------------------------


def _verify_case(name):
    """(logits [B, T, V], draft [B, T], n_draft [B]) of tests/
    test_speculative.py's two verify cases, and two more: a row whose
    first draft is wrong and rows that draft fewer than T - 1 tokens."""
    rng = np.random.default_rng({"match": 0, "t1": 1, "first_wrong": 2,
                                 "short": 3}[name])
    if name == "t1":
        logits = rng.normal(size=(2, 1, V)).astype(np.float32)
        return logits, np.zeros((2, 1), np.int32), np.zeros(2, np.int32)
    B, T = (2, 4) if name == "match" else (3, 5)
    logits = rng.normal(size=(B, T, V)).astype(np.float32)
    am = logits.argmax(-1)
    draft = rng.integers(0, V, (B, T)).astype(np.int32)
    n_draft = np.full(B, T - 1, np.int32)
    if name == "match":
        draft[0, 1:] = am[0, :-1]
        draft[1, 1] = am[1, 0]
        draft[1, 2] = (am[1, 1] + 7) % V
        draft[1, 3] = 1
        n_draft[:] = 3
    elif name == "first_wrong":
        draft[:, 1] = (am[:, 0] + 1) % V
        draft[2, 2:] = am[2, 1:-1]        # later matches cannot count
    else:
        draft[:, 1:] = am[:, :-1]
        n_draft[:] = (2, 0, 4)
    return logits, draft, n_draft


@pytest.mark.parametrize("name", ["match", "t1", "first_wrong", "short"])
def test_verify_matches_jax(name):
    """Greedy verify on the same logits and drafts: the port's tokens and
    n_emitted equal JAX's, and the emitted tokens are the argmax chain
    up to the first mismatch."""
    logits, draft, n_draft = _verify_case(name)
    B = logits.shape[0]
    js = j_init_state(B, V)
    ts = init_sampler_state(B, V)
    for b in range(B):
        js = j_reset_slot(js, jnp.int32(b), jnp.uint32(b + 1))
        reset_slot(ts, b, b + 1)
    jt, jn, _, _, _, _ = j_verify_impl(
        jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(n_draft), js,
        j_arrays([JSamplerParams(temp=0.0)] * B), jnp.ones((B,), bool))
    tt, tn, _, _, _, ts = verify_impl(
        torch.from_numpy(logits), torch.from_numpy(draft).long(),
        torch.from_numpy(n_draft).long(), ts,
        make_sampler_arrays([SamplerParams(temp=0.0)] * B),
        torch.ones(B, dtype=torch.bool))
    n_em = tn.numpy()
    np.testing.assert_array_equal(n_em, np.asarray(jn))
    am = logits.argmax(-1)
    for b in range(B):
        np.testing.assert_array_equal(tt.numpy()[b, :n_em[b]],
                                      np.asarray(jt)[b, :n_em[b]])
        np.testing.assert_array_equal(tt.numpy()[b, :n_em[b]],
                                      am[b, :n_em[b]])
    # the step advances once a sampled position: the emitted ones
    np.testing.assert_array_equal(ts.step.numpy(), n_em)
    if name == "match":
        assert n_em.tolist() == [4, 2]


# -- the n-gram cache and its gate ------------------------------------------


@pytest.mark.parametrize("n_min,n_max,seq,k", [
    (2, 3, [1, 2, 3, 4] * 3, 3),
    (2, 4, [5, 1, 2, 5, 1, 3, 5, 1, 2, 5, 1], 6),
    (1, 4, [7, 7, 8, 7, 9, 7, 8, 7], 5),
])
def test_ngram_cache_matches_jax(n_min, n_max, seq, k):
    """Drafts after a prompt and after each pushed token equal the JAX
    cache's; an unknown context drafts nothing."""
    ours, theirs = NgramCache(n_min, n_max), JNgramCache(n_min, n_max)
    ours.update(seq[:4])
    theirs.update(seq[:4])
    for i in range(4, len(seq) + 1):
        if i > 4:
            ours.push(seq[:i])
            theirs.push(seq[:i])
        assert ours.draft(seq[:i], k) == theirs.draft(seq[:i], k)
    assert ours.draft([99, 98, 97], k) == []
    if seq == [1, 2, 3, 4] * 3:
        assert ours.draft(seq, 3) == [1, 2, 3]


def test_ngram_acceptance_gating_matches_jax():
    """The moving-acceptance gate (JAX `_ngram_gate`, `_ngram_observe`):
    the same script of observations gives the same decisions and resume
    points in both engines (two bad passes hold, a probe every
    lookup_probe_every tokens, one bad probe re-holds, high acceptance
    never holds; the gate off never holds)."""

    class T:
        generated: list = []

    script = [("gate", 0), ("obs", 4, 0), ("gate", 0), ("obs", 4, 1),
              ("gate", 0), ("gate", 15), ("gate", 16), ("obs", 4, 0),
              ("gate", 16), ("gate", 40), ("obs", 4, 4), ("gate", 40)] \
        + [("obs", 4, 4), ("gate", 40)] * 8
    out = {}
    for name, cls, ecls in (("port", Engine, EngineConfig),
                            ("jax", JEngine, JEngineConfig)):
        for accept in (0.66, 0.0):
            eng = cls.__new__(cls)     # only ecfg and the gate's methods
            eng.ecfg = ecls(lookup_ngram_min=2, lookup_min_accept=accept,
                            lookup_probe_every=16)
            t = T()
            seen = []
            for step in script:
                gate = None
                if step[0] == "gate":
                    t.generated = [0] * step[1]
                    gate = eng._ngram_gate(t)
                else:
                    eng._ngram_observe(t, step[1], step[2])
                seen.append((gate, getattr(t, "spec_resume_at", None)))
            out[name, accept] = seen
    assert out["port", 0.66] == out["jax", 0.66]
    assert out["port", 0.0] == out["jax", 0.0]
    held = out["port", 0.66]
    assert held[4] == (False, 16)                 # two bad passes hold
    assert held[6] == (True, -1)                  # the probe at 16
    assert held[8] == (False, 32)                 # one bad probe re-holds
    assert all(g is not False for g, _ in out["port", 0.0])


# -- the verify forward -----------------------------------------------------


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_verify_forward_rows_equal_decode_steps(model_path, kv):
    """A T-row verify forward (slot 0 with 4 drafts, slot 1 with 2 and two
    sentinel rows) gives the logits and the cache of T one-row steps:
    each query attends the rows before it as the cache holds them (an
    int8 cache: dequantized) and its own at full precision; the sentinel
    rows are neither attended nor written. f32 within 1e-5 (matmuls of
    other row counts), bf16 and int8 bit for bit at these widths."""
    cfg, params = load_model(model_path, dtype=torch.float32, device="cpu")
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}[kv]
    S, C, T = 2, 64, 5
    rng = np.random.default_rng(4)
    cos, sin = tllama.make_rope(cfg, C, "cpu")
    caches = [tllama.init_kv_cache(cfg, S, C, dt, "cpu") for _ in range(2)]
    pre = torch.from_numpy(rng.integers(3, 280, (S, 16)))
    for c in caches:
        tllama.prefill_batch_impl(params, cfg, pre, np.array([0, 0]),
                                  np.array([16, 10]), c, cos, sin)
    toks = torch.from_numpy(rng.integers(3, 280, (S, T)))
    pos = np.array([[16 + j for j in range(T)], [10, 11, 12, C, C]])
    got, _ = tllama.forward_impl(params, cfg, toks, pos, caches[0], cos, sin)
    want = torch.cat([tllama.forward_impl(params, cfg, toks[:, j:j + 1],
                                          pos[:, j:j + 1].copy(), caches[1],
                                          cos, sin)[0] for j in range(T)], 1)
    live = torch.from_numpy(pos < C)
    tol = 1e-5 if kv == "float32" else 0.0
    torch.testing.assert_close(got[live], want[live], rtol=0, atol=tol)
    for a, b in zip(caches[0], caches[1]):
        if a is not None:
            torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol)
    assert caches[0].k[:, 1, 13:].abs().sum() == 0


def test_verify_forward_matches_jax(model_path, jax_model):
    """The verify forward against the JAX `forward` (its general einsum
    path) on the same T-row batch, f32 weights and cache."""
    jcfg, jp, _ = jax_model
    cfg, params = load_model(model_path, dtype=torch.float32, device="cpu")
    S, C, T = 2, 64, 5
    rng = np.random.default_rng(5)
    pre = rng.integers(3, 280, (S, 16)).astype(np.int32)
    n1 = np.array([16, 10], np.int32)
    toks = rng.integers(3, 280, (S, T)).astype(np.int32)
    pos = np.array([[16 + j for j in range(T)], [10, 11, 12, C, C]],
                   np.int32)
    kv_j = jllama.init_kv_cache(jcfg, S, C, jnp.float32)
    cos_j, sin_j = jllama.make_rope(jcfg, C)
    _, kv_j = jllama.prefill_batch(jp, jcfg, jnp.asarray(pre),
                                   jnp.zeros(S, jnp.int32), jnp.asarray(n1),
                                   kv_j, cos_j, sin_j)
    want, _ = jllama.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                             kv_j, jnp.asarray((pos < C).sum(1), jnp.int32),
                             cos_j, sin_j)
    kv_t = tllama.init_kv_cache(cfg, S, C, torch.float32, "cpu")
    cos_t, sin_t = tllama.make_rope(cfg, C, "cpu")
    tllama.prefill_batch_impl(params, cfg, torch.from_numpy(pre),
                              np.zeros(S, np.int64), n1, kv_t, cos_t, sin_t)
    got, _ = tllama.forward_impl(params, cfg, torch.from_numpy(toks), pos,
                                 kv_t, cos_t, sin_t)
    live = pos < C
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=0, atol=1e-4)


def test_int8_verify_rows_are_decode_steps_in_the_port_not_in_jax(
        model_path, jax_model):
    """With an int8 cache the port's verify rows give their one-row decode
    steps' logits bit for bit (test_verify_forward_rows_equal_decode_steps);
    the JAX `forward` of the same T rows attends the rows before each
    query unquantized and parts from its own one-row steps (ROADMAP Queue
    3: the recorded difference)."""
    jcfg, jp, _ = jax_model
    S, C, T = 2, 64, 5
    rng = np.random.default_rng(5)
    pre = rng.integers(3, 280, (S, 16)).astype(np.int32)
    toks = rng.integers(3, 280, (S, T)).astype(np.int32)
    pos = np.array([[16 + j for j in range(T)], [10, 11, 12, C, C]],
                   np.int32)
    cos, sin = jllama.make_rope(jcfg, C)

    def prefilled():
        kv = jllama.init_kv_cache(jcfg, S, C, jnp.int8)
        return jllama.prefill_batch(
            jp, jcfg, jnp.asarray(pre), jnp.zeros(S, jnp.int32),
            jnp.asarray([16, 10], jnp.int32), kv, cos, sin)[1]

    def fwd(t, p, kv):
        return jllama.forward(jp, jcfg, jnp.asarray(t), jnp.asarray(p), kv,
                              jnp.asarray((p < C).sum(1), jnp.int32), cos,
                              sin)
    rows = np.asarray(fwd(toks, pos, prefilled())[0])
    kv, steps = prefilled(), []
    for j in range(T):
        lg, kv = fwd(toks[:, j:j + 1], pos[:, j:j + 1], kv)
        steps.append(np.asarray(lg))
    live = pos < C
    assert np.abs(rows[live] - np.concatenate(steps, 1)[live]).max() > 1e-4


# -- engines ----------------------------------------------------------------


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny.gguf")
    write_tiny_model(path, seed=SEED)
    return path


@pytest.fixture(scope="module")
def model(model_path):
    cfg, params = load_model(model_path, dtype=torch.float32, device="cpu")
    with GGUFFile(model_path) as g:
        tok = Tokenizer.from_gguf(g)
    return cfg, params, tok


@pytest.fixture(scope="module")
def jax_model(model_path):
    cfg, params = jax_load(model_path, dtype=jnp.float32)
    with JGGUFFile(model_path) as g:
        tok = JTokenizer.from_gguf(g)
    return cfg, params, tok


def _final(task, timeout=TIMEOUT):
    while True:
        kind, payload = task.result_q.get(timeout=timeout)
        if kind == "final":
            return payload
        if kind == "error":
            raise payload


def _run(eng, text, n, sp=None, task_cls=CompletionsTask,
         sp_cls=SamplerParams):
    tok = eng.tokenizer
    t = task_cls(tok.encode(text), sp or sp_cls(temp=0.0), tokenizer=tok,
                 max_tokens=n, stream=False)
    eng.submit(t)
    return _final(t)


def _engine(model, draft=False, **kw):
    cfg, params, tok = model
    kw = dict(dict(n_slots=2, n_ctx=256, n_ubatch=32, kv_dtype="float32"),
              **kw)
    eng = Engine(cfg, params, tok, EngineConfig(**kw), device="cpu",
                 draft=(cfg, params) if draft else None)
    eng.start()
    return eng


def _jax_engine(jax_model, draft=False, **kw):
    cfg, params, tok = jax_model
    kw = dict(dict(n_slots=2, n_ctx=256, n_ubatch=32, kv_dtype="float32"),
              **kw)
    eng = JEngine(cfg, params, tok, JEngineConfig(**kw),
                  draft=(cfg, params) if draft else None)
    eng.start()
    return eng


def _serve(make, jobs):
    """Each (text, n, SamplerParams-or-None) through one started engine,
    in turn; the finished tasks."""
    eng = make()
    try:
        return [_run(eng, *job) for job in jobs]
    finally:
        eng.stop()


# (name, draft model, EngineConfig fields, prompt, tokens)
SPEC_MODES = [
    ("ngram", False, dict(lookup_ngram_min=2, draft_max=4), REPEAT, 24),
    ("ngram_chain4", False, dict(lookup_ngram_min=1, draft_max=4,
                                 decode_chain=4, lookup_probe_every=8),
     REPEAT, 64),
    ("self_fused", True, dict(draft_max=4, draft_p_min=0.0, spec_rounds=1),
     FOX, 20),
    ("self_two_sync", True, dict(draft_max=4, draft_p_min=0.0,
                                 spec_rounds=1, draft_min=2), FOX, 20),
    ("spec_chain", True, dict(draft_max=4, draft_p_min=0.0, spec_rounds=3),
     FOX, 20),
    ("spec_pipelined", True, dict(n_ctx=1024, draft_max=4, draft_p_min=0.0,
                                  spec_rounds=2, pipeline_depth=2), FOX, 64),
]


@pytest.fixture(scope="module")
def jax_plain(jax_model):
    """The JAX engine's plain greedy tokens of each (prompt, n, n_ctx)."""
    out = {}
    for n_ctx in (256, 1024):
        jobs = sorted({(p, n) for _, _, kw, p, n in SPEC_MODES
                       if kw.get("n_ctx", 256) == n_ctx})
        fins = _serve(lambda n_ctx=n_ctx: _jax_engine(jax_model, n_ctx=n_ctx),
                      [(p, n, JSamplerParams(temp=0.0), JTask,
                        JSamplerParams) for p, n in jobs])
        for (p, n), f in zip(jobs, fins):
            out[p, n, n_ctx] = f.generated
    return out


@pytest.mark.parametrize("mode", SPEC_MODES, ids=[m[0] for m in SPEC_MODES])
def test_spec_greedy_equals_plain_and_jax(model, jax_plain, mode):
    """Greedy tokens with n-gram drafting (decode_chain 1 and 4), the
    draft model drafting for itself in the one-round pass, the two-sync
    pass, the M-round spec chain and the pipelined spec chain equal the
    port's plain greedy tokens and the JAX engine's; drafts were made
    (every one accepted when the model drafts for itself), /metrics'
    counters and the usage fields count them, and the pipelined mode
    did speculate a pass."""
    name, draft, kw, prompt, n = mode
    n_ctx = kw.get("n_ctx", 256)
    plain = _serve(lambda: _engine(model, n_ctx=n_ctx), [(prompt, n)])[0]
    spec_eng = _engine(model, draft, **kw)
    filled = []
    fill = spec_eng._fill_spec_queue

    def spy(dec, pend):
        n0 = len(spec_eng._spec_q)
        fill(dec, pend)
        filled.append(len(spec_eng._spec_q) - n0)
    spec_eng._fill_spec_queue = spy
    try:
        f = _run(spec_eng, prompt, n)
        m = spec_eng.metrics
        assert m.n_drafted_total == f.n_drafted
        assert m.n_drafted_accepted_total == f.n_draft_accepted
    finally:
        spec_eng.stop()
    assert f.generated == plain.generated
    assert f.generated == jax_plain[prompt, n, n_ctx]
    assert f.n_drafted > 0
    assert f.timings()["draft_tokens"] == f.n_drafted
    if draft:
        assert f.n_draft_accepted == f.n_drafted
    if name == "spec_pipelined":
        assert sum(filled) > 0, "no spec pass was ever pipelined"


@pytest.mark.parametrize("name,ignore_eos", [("ngram", False),
                                             ("self_fused", False),
                                             ("self_fused", True)])
def test_spec_draft_counts_equal_jax(model, jax_model, name, ignore_eos):
    """Where the pass structure is the JAX engine's (one verify pass a
    token, no chain in flight), the drafted and accepted counts are its
    counts too; with ignore_eos as well, where a draft of the end token
    (the draft model's argmax) is rejected by the target in both."""
    _, draft, kw, prompt, n = next(m for m in SPEC_MODES if m[0] == name)
    if ignore_eos:
        n = 48
    ours = _serve(lambda: _engine(model, draft, **kw), [(
        prompt, n, SamplerParams(temp=0.0, ignore_eos=ignore_eos))])[0]
    theirs = _serve(lambda: _jax_engine(jax_model, draft, **kw), [(
        prompt, n, JSamplerParams(temp=0.0, ignore_eos=ignore_eos), JTask,
        JSamplerParams)])[0]
    assert ours.generated == theirs.generated
    assert (ours.n_drafted, ours.n_draft_accepted) == \
        (theirs.n_drafted, theirs.n_draft_accepted)
    assert ours.n_drafted > 0


def test_spec_chain_is_the_one_round_pass_seeded(model):
    """The M-round spec chain, the one-round pass, the two-sync pass and
    plain decode give the same greedy tokens and the same seeded sampled
    tokens and top ids (the port's draws are a hash of (seed, step), and a
    spec round samples at the emitted positions only)."""
    jobs = [(FOX, 20), ("a b c x y", 18, SamplerParams(temp=0.0, seed=11)),
            (FOX, 13, SamplerParams(temp=0.9, seed=5, n_probs=2))]
    outs = {}
    for name, draft, kw in (
            ("plain", False, {}),
            ("fused", True, dict(draft_max=4, draft_p_min=0.0,
                                 spec_rounds=1)),
            ("two_sync", True, dict(draft_max=4, draft_p_min=0.0,
                                    spec_rounds=1, draft_min=2)),
            ("chain", True, dict(draft_max=4, draft_p_min=0.0,
                                 spec_rounds=3))):
        fins = _serve(lambda: _engine(model, draft, **kw), jobs)
        outs[name] = [(f.generated, [tuple(p.top_ids) for p in f.probs])
                      for f in fins]
        if draft:
            assert fins[0].n_drafted > 0
    assert outs["fused"] == outs["plain"]
    assert outs["two_sync"] == outs["plain"]
    assert outs["chain"] == outs["plain"]


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("name", ["ngram", "spec_chain"])
def test_spec_equals_plain_decode_by_cache(model, jax_model, kv, name):
    """With a bf16 or an int8 cache, n-gram and draft-model speculation
    give the port's plain greedy tokens: a verify row attends the rows
    before it as the cache holds them, as a decode step does. With a bf16
    cache they are the JAX engine's too; with an int8 cache the JAX
    verify attends the rows before it unquantized, so its speculative
    tokens are not its plain ones in general (ROADMAP Queue 3), and the
    port is held to its own plain decode."""
    _, draft, kw, prompt, n = next(m for m in SPEC_MODES if m[0] == name)
    plain = _serve(lambda: _engine(model, kv_dtype=kv), [(prompt, n)])[0]
    spec = _serve(lambda: _engine(model, draft, kv_dtype=kv, **kw),
                  [(prompt, n)])[0]
    assert spec.generated == plain.generated
    assert spec.n_drafted > 0
    if kv == "bfloat16":
        jplain = _serve(lambda: _jax_engine(jax_model, kv_dtype=kv),
                        [(prompt, n, JSamplerParams(temp=0.0), JTask,
                          JSamplerParams)])[0]
        assert spec.generated == jplain.generated


@pytest.mark.parametrize("rounds", [1, 3], ids=["fused", "spec_chain"])
def test_draft_cache_shifts_with_the_target(model, jax_model, rounds):
    """Past a 48-token slot the draft cache shifts with the target's: the
    self-drafting model keeps agreeing (acceptance >= 0.7), and the
    tokens equal plain decode's that shifted the same way, the port's
    and the JAX engine's (near capacity the spec chain shrinks, then one
    round a pass, then the one-token pass shifts at the boundary)."""
    kw = dict(n_slots=1, n_ctx=48, n_ubatch=16)
    n = 60
    plain = _serve(lambda: _engine(model, **kw), [("a b c d e f", n)])[0]
    spec = _serve(lambda: _engine(model, True, draft_max=4, draft_p_min=0.0,
                                  spec_rounds=rounds, **kw),
                  [("a b c d e f", n)])[0]
    jplain = _serve(lambda: _jax_engine(jax_model, **kw),
                    [("a b c d e f", n, JSamplerParams(temp=0.0), JTask,
                      JSamplerParams)])[0]
    assert spec.generated == plain.generated == jplain.generated
    assert plain.n_shifted >= 1 and spec.n_shifted >= 1
    assert spec.n_drafted > 0
    assert spec.n_draft_accepted >= 0.7 * spec.n_drafted, \
        (spec.n_draft_accepted, spec.n_drafted)


def test_draft_vocab_mismatch_rejected(model):
    cfg, params, tok = model
    bad = dataclasses.replace(cfg, vocab_size=cfg.vocab_size + 1)
    with pytest.raises(ValueError):
        Engine(cfg, params, tok, EngineConfig(n_slots=1, n_ctx=64),
               device="cpu", draft=(bad, params))


def test_no_chain_goes_out_while_a_slot_may_draft(model):
    """The JAX gates: with a draft model no chain is dispatched or
    speculated; with n-gram drafting at decode_chain 4, no chain is
    speculated behind one whose slot has a match."""
    calls = []
    eng = _engine(model, True, draft_max=4, draft_p_min=0.0)
    orig = eng._dispatch_chain
    eng._dispatch_chain = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        _run(eng, FOX, 20)
    finally:
        eng.stop()
    assert not calls
    eng = _engine(model, lookup_ngram_min=1, draft_max=4, decode_chain=4)
    seen = []
    fill = eng._fill_chain_queue

    def spy(dec, k, newest):
        n0 = len(eng._chain_q)
        fill(dec, k, newest)
        if len(eng._chain_q) > n0:
            hist = dec[0].task.prompt_tokens + dec[0].task.generated
            seen.append(bool(dec[0].task.ngram.draft(hist, 1)))
    eng._fill_chain_queue = spy
    try:
        _run(eng, REPEAT, 64)
    finally:
        eng.stop()
    assert not any(seen)


def test_spec_cli_flags_and_http_counters(model_path):
    """The speculative flags parse as the JAX CLI's; a server started with
    -md (the same GGUF) and one with --lookup-ngram-min 2 answer chats with
    usage draft_tokens, report support_speculative and count drafts in
    /metrics."""
    keys = ("model_draft", "draft_max", "draft_min", "draft_p_min",
            "lookup_ngram_min", "spec_rounds", "lookup_min_accept",
            "lookup_probe_every")
    p, jp = cli.build_parser(), jcli.build_parser()
    for argv in ([], ["-md", "d.gguf", "--draft", "5", "--draft-n-min", "2",
                      "--draft-p-min", "0.5", "--lookup-ngram-min", "3",
                      "--spec-rounds", "2", "--lookup-min-accept", "0.5",
                      "--lookup-probe-every", "9", "-ngld", "99", "-devd",
                      "none"]):
        a, ja = p.parse_args(argv), jp.parse_args(argv)
        assert [getattr(a, k) for k in keys] == [getattr(ja, k)
                                                 for k in keys], argv
    for flags in (["-md", model_path, "--draft-p-min", "0", "--draft-max",
                   "4"], ["--lookup-ngram-min", "1", "--draft-max", "4"]):
        engine, srv = cli.build_server([
            "-m", model_path, "--device", "cpu", "--port", "0",
            "--no-jinja", "-np", "2", "-c", "256", "-ub", "16",
            "--decode-chain", "1", "-ctk", "f32", "-ctv", "f32",
            "--weights-dtype", "f32"] + flags)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            req = urllib.request.Request(
                url + "/v1/chat/completions", data=json.dumps(dict(
                    messages=[{"role": "user", "content": REPEAT}],
                    max_tokens=32, temperature=0)).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                usage = json.loads(r.read())["usage"]
            assert usage["draft_tokens"] > 0
            assert 0 <= usage["draft_tokens_acceptance"] <= 1
            with urllib.request.urlopen(url + "/v1/models",
                                        timeout=TIMEOUT) as r:
                meta = json.loads(r.read())["data"][0]["meta"]
            assert meta["support_speculative"] is True
            with urllib.request.urlopen(url + "/metrics",
                                        timeout=TIMEOUT) as r:
                prom = r.read().decode()
            drafted = [float(line.split()[-1]) for line in prom.splitlines()
                       if line.startswith("llamabox:tokens_drafted_total")]
            assert drafted == [usage["draft_tokens"]], prom
        finally:
            srv.shutdown()
            srv.server_close()
            engine.stop()
            thread.join(timeout=30)
    assert not thread.is_alive()


def test_verify_rows_of_a_wave_whose_drafts_are_short(tmp_path):
    """Four slots with n-gram drafts, one under a rate bucket (so every
    pass is a one-token or verify pass): when no slot drafts draft_max
    tokens, the staged rows still hold T = 1 + draft_max columns a slot
    (they were staged at the longest draft list's width and read at
    T, so every slot after the first read another's tokens); greedy
    tokens equal plain decode and the JAX engine's."""
    from llama_box_tpu.utils.tokenbucket import RatelimitTokenBucket as JRB
    from llama_box_tpu_torch.utils.tokenbucket import RatelimitTokenBucket
    path = str(tmp_path / "m.gguf")
    write_tiny_model(path)
    base = ([1, 106, 88, 120, 137, 202, 249], [1, 23, 261, 150, 102],
            [1, 40, 41, 42, 43, 44, 45, 46], [1, 9, 77, 200, 31])
    prompts = [p + p[1:] for p in base]
    kw = dict(n_slots=4, n_ctx=256, n_ubatch=16, kv_dtype="float32",
              decode_chain=2, draft_max=3, lookup_min_accept=0.0)
    cfg, params = load_model(path, dtype=torch.float32, device="cpu")
    jcfg, jparams = jax_load(path, dtype=jnp.float32)
    with GGUFFile(path) as g:
        tok = Tokenizer.from_gguf(g)
    with JGGUFFile(path) as g:
        jtok = JTokenizer.from_gguf(g)
    out = {}
    for name, ngram in (("plain", 0), ("ngram", 1), ("jax", 1)):
        if name == "jax":
            eng = JEngine(jcfg, jparams, jtok,
                          JEngineConfig(lookup_ngram_min=ngram, **kw))
            tc, sc, rb = JTask, JSamplerParams, JRB
        else:
            eng = Engine(cfg, params, tok,
                         EngineConfig(lookup_ngram_min=ngram, **kw),
                         device="cpu")
            tc, sc, rb = CompletionsTask, SamplerParams, RatelimitTokenBucket
        eng.start()
        try:
            tasks = [tc(list(p), sc(temp=0.0), tokenizer=eng.tokenizer,
                        max_tokens=6) for p in prompts]
            tasks[3].rate_bucket = rb(1e6, 1e6)
            for t in tasks:
                eng.submit(t)
            out[name] = [_final(t).generated for t in tasks]
            if name == "ngram":
                assert eng.metrics.n_drafted_total > 0
        finally:
            eng.stop()
    assert out["ngram"] == out["plain"] == out["jax"]
