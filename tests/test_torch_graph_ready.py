"""The port's one-dispatch programs, on the CPU, against the JAX package and
against the sparse row writes they replaced (tiny fixture GGUF).

- The fixed-shape K-step decode chain (server/engine._decode_chain: its
  operands computed on the device from token0 / pos0 / active, one
  scatter of the chain's rows at its end) with K = 1, 4 and 16 on f32,
  bf16 and int8 caches, one slot idle: greedy tokens equal the JAX
  `_decode_chain`'s on the same numpy inputs, and the reported top
  probabilities (softmax of the candidates' logits) are within the
  tolerances test_torch_model.py holds logits to (1e-4 f32, 2e-2 bf16 and
  int8). The tiny model's logits are flat: a step whose top-2 logit
  margin in JAX is within twice the tolerance may pick either token, so a
  slot is compared up to its first such step (f32: every step).
- The idle slot's cache rows keep their bits; so does every position the
  chain does not reach.
- The fixed-shape scatter (models/llama.write_rows: all S x T rows, the
  padding, idle and past-capacity ones writing back what they overwrite)
  leaves the cache the sparse write of the valid rows would leave, bit
  for bit, with padded rows, a cached prefix and a chunk that reaches the
  capacity.
- The counter-based draws: a (seed, step) gives the same uniforms
  whatever K is and whatever the other slots do; inactive rows do not
  advance `step`; a seeded request gives the same text for K = 1 and 16.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu import sampling as js
from llama_box_tpu.models import llama as jllama
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.models.loader import (deinterleave_rope as j_deint,
                                         fuse_projections as j_fuse)
from llama_box_tpu.server.engine import _decode_chain as j_decode_chain
from llama_box_tpu_torch import sampling as ts
from llama_box_tpu_torch.gguf import GGUFFile
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models.loader import (deinterleave_rope,
                                               fuse_projections, load_model)
from llama_box_tpu_torch.server.engine import (Engine, EngineConfig,
                                               _decode_chain)
from llama_box_tpu_torch.server.task import CompletionsTask
from llama_box_tpu_torch.tokenizer import Tokenizer
from .fixtures.make_tiny_model import write_tiny_model

S, C, T = 3, 96, 32
KV = {"f32": (jnp.float32, torch.float32, 1e-4),
      "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2),
      "int8": (jnp.int8, torch.int8, 2e-2)}
# the fixture seed of test_torch_engine (its f32 greedy steps clear their
# margins)
SEED = 2


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny.gguf")
    write_tiny_model(path, seed=SEED)
    return path


@pytest.fixture(scope="module")
def models(model_path):
    jcfg, jp = jax_load(model_path, dtype=jnp.float32)
    jp, jcfg = j_deint(jp, jcfg)
    jp = j_fuse(jp, jcfg)
    tcfg, tp = load_model(model_path, dtype=torch.float32, device="cpu")
    tp, tcfg = deinterleave_rope(tp, tcfg)
    tp = fuse_projections(tp, tcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, jp, tcfg, tp


def _fields(kv):
    return [t for t in kv if t is not None]


def _prompt():
    rng = np.random.default_rng(0)
    toks = rng.integers(3, 280, (S, T)).astype(np.int32)
    n = np.array([T, 0, 9], np.int32)            # slot 1 idle
    return toks, np.zeros(S, np.int32), n


def _jax_chain(jcfg, jp, jdt, K):
    toks, p, n = _prompt()
    kv = jllama.init_kv_cache(jcfg, S, C, jdt)
    cos, sin = jllama.make_rope(jcfg, C)
    _, kv = jllama.prefill_batch(jp, jcfg, jnp.asarray(toks), jnp.asarray(p),
                                 jnp.asarray(n), kv, cos, sin)
    active = n > 0
    arrs = js.make_sampler_arrays([js.SamplerParams(temp=0.0)] * S)
    st = js.init_sampler_state(S, jcfg.vocab_size)
    pos0 = np.where(active, n, C).astype(np.int32)
    out = j_decode_chain(jp, jcfg, jnp.asarray(toks[np.arange(S), 0]),
                         jnp.asarray(pos0), kv, st, arrs,
                         jnp.asarray(active), cos, sin, n_steps=K)
    return [np.asarray(x) for x in out[:4]]


def _port_chain(tcfg, tp, tdt, K):
    toks, p, n = _prompt()
    kv = tllama.init_kv_cache(tcfg, S, C, tdt, device="cpu")
    # the cache past each slot's prompt holds values the chain must keep
    rng = np.random.default_rng(9)
    for t in _fields(kv):
        t.copy_(torch.from_numpy(rng.integers(-50, 50, t.shape)).to(t.dtype))
    cos, sin = tllama.make_rope(tcfg, C, device="cpu")
    _, kv = tllama.prefill_batch_impl(tp, tcfg, torch.from_numpy(toks), p, n,
                                      kv, cos, sin)
    before = [t.clone() for t in _fields(kv)]
    active = torch.from_numpy(n > 0)
    arrs = ts.make_sampler_arrays([ts.SamplerParams(temp=0.0)] * S)
    st = ts.init_sampler_state(S, tcfg.vocab_size)
    pos0 = torch.from_numpy(np.where(n > 0, n, C).astype(np.int64))
    out = _decode_chain(tp, tcfg, torch.from_numpy(toks[:, 0]), pos0, kv, st,
                        arrs, active, cos, sin, n_steps=K)
    return [x.numpy() for x in out[:4]], before, kv, st


@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("kv", sorted(KV))
def test_decode_chain_matches_jax(models, kv, K):
    jcfg, jp, tcfg, tp = models
    jdt, tdt, atol = KV[kv]
    jt, _, jprobs, _ = _jax_chain(jcfg, jp, jdt, K)
    (tt, _, tprobs, _), before, kv_t, st = _port_chain(tcfg, tp, tdt, K)
    live = [0, 2]
    margin = np.log(jprobs[..., 0]) - np.log(jprobs[..., 1])     # [S, K]
    for b in live:
        # steps up to the first one whose pick may differ on a near tie
        # (JAX's top-2 margin within twice the tolerance) take the same
        # inputs, so the same tokens and probabilities within atol
        ties = np.nonzero(margin[b] <= 2 * atol)[0]
        n = K if not len(ties) else ties[0] + 1
        if kv == "f32":
            assert n == K, "a near tie in f32"
        np.testing.assert_allclose(tprobs[b, :n], jprobs[b, :n], rtol=0,
                                   atol=atol)
        np.testing.assert_array_equal(tt[b, :n - (n < K)],
                                      jt[b, :n - (n < K)])
        if n < K and tt[b, n - 1] != jt[b, n - 1]:
            continue                  # the tie broke the other way
        np.testing.assert_array_equal(tt[b, :n], jt[b, :n])
    # the idle slot's rows and every position the chain did not reach keep
    # their bits; the idle slot's sampler state did not advance
    n = _prompt()[2]
    for b0, t in zip(before, _fields(kv_t)):
        assert torch.equal(t[:, 1], b0[:, 1])
        for b in live:
            assert torch.equal(t[:, b, n[b] + K:], b0[:, b, n[b] + K:])
            assert torch.equal(t[:, b, :n[b]], b0[:, b, :n[b]])
    assert st.step.tolist() == [K, 0, K]


def _sparse_reference(cache, fields, writes):
    """The writes as the sparse path made them: each valid row (b, t) at its
    own position, nothing else."""
    out = cache.clone()
    b, t = torch.nonzero(writes.valid, as_tuple=True)
    out[:, writes.b[b, t], writes.p[b, t]] = fields[:, b, t]
    return out


@pytest.mark.parametrize("kv", sorted(KV))
def test_fixed_shape_prefill_writes_what_the_sparse_writes_did(models, kv,
                                                               monkeypatch):
    """A second chunk over a cached prefix: slot 0 padded (9 of 32 rows),
    slot 1 idle, slot 2 reaching the capacity (its padded rows wrap to
    positions 0..); the cache around them holds random values."""
    _, _, tcfg, tp = models
    _, tdt, _ = KV[kv]
    cache = tllama.init_kv_cache(tcfg, S, C, tdt, device="cpu")
    rng = np.random.default_rng(11)
    for t in _fields(cache):
        t.copy_(torch.from_numpy(rng.integers(-50, 50, t.shape)).to(t.dtype))
    cos, sin = tllama.make_rope(tcfg, C, device="cpu")
    toks = torch.from_numpy(rng.integers(3, 280, (S, T)).astype(np.int32))
    pos_base = np.array([40, 0, C - 20], np.int64)
    n_valid = np.array([9, 0, 20], np.int64)
    seen = []
    real = tllama.write_rows

    def spy(kv_, fields, writes):
        seen.append(([t.clone() for t in _fields(kv_)], fields, writes))
        real(kv_, fields, writes)
    monkeypatch.setattr(tllama, "write_rows", spy)
    tllama.prefill_batch_impl(tp, tcfg, toks, pos_base, n_valid, cache, cos,
                              sin)
    (olds, fields, writes), = seen
    assert writes.valid.sum() == 29 and writes.b.shape == (S, T)
    for old, f, new in zip(olds, fields, _fields(cache)):
        assert torch.equal(new, _sparse_reference(old, f, writes))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_chain_writes_what_the_sparse_writes_did(models, kv,
                                                        monkeypatch):
    """The chain's one scatter against the per-step sparse writes, with a
    slot whose chain runs past the capacity (its last rows are dropped)."""
    _, _, tcfg, tp = models
    _, tdt, _ = KV[kv]
    cache = tllama.init_kv_cache(tcfg, S, C, tdt, device="cpu")
    rng = np.random.default_rng(12)
    for t in _fields(cache):
        t.copy_(torch.from_numpy(rng.integers(-50, 50, t.shape)).to(t.dtype))
    cos, sin = tllama.make_rope(tcfg, C, device="cpu")
    seen = []
    real = tllama.write_rows

    def spy(kv_, fields, writes):
        seen.append(([t.clone() for t in _fields(kv_)], fields, writes))
        real(kv_, fields, writes)
    monkeypatch.setattr(tllama, "write_rows", spy)
    pos0 = torch.tensor([10, C, C - 2])
    active = torch.tensor([True, False, True])
    arrs = ts.make_sampler_arrays([ts.SamplerParams(temp=0.0)] * S)
    st = ts.init_sampler_state(S, tcfg.vocab_size)
    _decode_chain(tp, tcfg, torch.tensor([5, 6, 7]), pos0, cache, st, arrs,
                  active, cos, sin, n_steps=4)
    (olds, fields, writes), = seen
    assert writes.valid.tolist() == [[True, False, True],
                                     [True, False, True],
                                     [True, False, False],
                                     [True, False, False]]
    for old, f, new in zip(olds, fields, _fields(cache)):
        assert torch.equal(new, _sparse_reference(old, f, writes))


def test_draws_depend_on_seed_and_step_alone():
    st = ts.init_sampler_state(3, 50)
    for b, seed in enumerate((7, 9, 7)):
        ts.reset_slot(st, b, seed)
    st.step.copy_(torch.tensor([3, 3, 5], dtype=torch.int32))
    u = ts._draws(st, ts.STREAM_GUMBEL, 256)
    assert u.dtype == torch.float32 and u.shape == (3, 256)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    one = ts.init_sampler_state(1, 50)
    ts.reset_slot(one, 0, 7)
    one.step.fill_(5)
    # a row's draws: the same alone, and a prefix of them at a smaller kcap
    assert torch.equal(ts._draws(one, ts.STREAM_GUMBEL, 256)[0], u[2])
    assert torch.equal(ts._draws(one, ts.STREAM_GUMBEL, 64)[0], u[2, :64])
    # seed, step and stream each move every draw
    assert not torch.equal(u[0], u[2]) and not torch.equal(u[0], u[1])
    x = ts._draws(st, ts.STREAM_XTC, 256)
    assert (x != u).float().mean() > 0.99
    # the bits of (2m + 1) / 2**24: 24-bit odd numerators, roughly uniform
    m = u * 2 ** 24
    assert torch.equal(m, m.round()) and bool((m.long() % 2 == 1).all())
    big = ts.init_sampler_state(64, 50)
    for b in range(64):
        ts.reset_slot(big, b, 1000 + b)
    v = ts._draws(big, ts.STREAM_GUMBEL, 256).flatten().numpy()
    hist = np.histogram(v, bins=16, range=(0, 1))[0]
    expect = v.size / 16
    assert (((hist - expect) ** 2) / expect).sum() < 50     # chi2, 15 dof


def test_inactive_rows_do_not_advance():
    logits = torch.from_numpy(
        np.random.default_rng(3).standard_normal((3, 60)).astype(np.float32))
    arrs = ts.make_sampler_arrays([ts.SamplerParams(temp=1.0, seed=s)
                                   for s in (4, 5, 6)])
    st = ts.init_sampler_state(3, 60)
    for b, s in enumerate((4, 5, 6)):
        ts.reset_slot(st, b, s)
    active = torch.tensor([True, False, True])
    toks = []
    for _ in range(5):
        tok, *_, st = ts.sample_impl(logits, st, arrs, active)
        toks.append(tok)
    assert st.step.tolist() == [5, 0, 5]
    assert st.ring_len.tolist() == [5, 0, 5]
    # slot 2 alone draws what it drew beside the others
    one = ts.init_sampler_state(1, 60)
    ts.reset_slot(one, 0, 6)
    arr1 = ts.make_sampler_arrays([ts.SamplerParams(temp=1.0, seed=6)])
    for j in range(5):
        tok, *_, one = ts.sample_impl(logits[2:], one, arr1,
                                      torch.tensor([True]))
        assert int(tok[0]) == int(toks[j][2])


def test_sampler_buffers_fill_in_place():
    bufs = ts.SamplerBuffers(2, "cpu")
    a = bufs.fill([ts.SamplerParams(temp=0.0), ts.SamplerParams()])
    ptrs = [t.data_ptr() for t in a]
    b = bufs.fill([ts.SamplerParams(temp=0.5, top_k=7,
                                    logit_bias={3: 1.5}),
                   ts.SamplerParams(ignore_eos=True)], eog_ids=[2])
    assert [t.data_ptr() for t in b] == ptrs
    want = ts.make_sampler_arrays([ts.SamplerParams(temp=0.5, top_k=7,
                                                    logit_bias={3: 1.5}),
                                   ts.SamplerParams(ignore_eos=True)],
                                  eog_ids=[2])
    for got, exp in zip(b, want):
        assert got.dtype == exp.dtype and torch.equal(got, exp)
    assert torch.equal(a.temp, torch.tensor([0.5, 0.8]))


def _engine_text(path, chain, sp, graphs=True):
    cfg, params = load_model(path, dtype=torch.float32, device="cpu")
    with GGUFFile(path) as g:
        tok = Tokenizer.from_gguf(g)
    eng = Engine(cfg, params, tok,
                 EngineConfig(n_slots=2, n_ctx=192, n_ubatch=16,
                              kv_dtype="float32", decode_chain=chain,
                              cuda_graphs=graphs), device="cpu")
    assert not eng.graphs.enabled            # the CPU never captures
    eng.start()
    try:
        task = CompletionsTask(tok.encode("the quick brown fox"), sp,
                               tokenizer=tok, max_tokens=24)
        eng.submit(task)
        while True:
            kind, payload = task.result_q.get(timeout=120)
            if kind == "error":
                raise payload
            if kind == "final":
                return payload.generated, payload.text
    finally:
        eng.stop()


def test_seeded_text_is_the_same_for_every_chain_length(model_path):
    sp = ts.SamplerParams(temp=1.0, top_k=40, seed=1234, ignore_eos=True)
    one = _engine_text(model_path, 1, sp)
    chained = _engine_text(model_path, 16, sp)
    assert one == chained and len(one[0]) == 24
    other = _engine_text(model_path, 16, dataclasses.replace(sp, seed=99))
    assert other[0] != one[0]
