"""Port parity of the device sampling chain (llama_box_tpu_torch/sampling.py)
against the JAX package's sample_impl, on the same numpy logits.

Greedy rows pick the argmax. The filtered distribution that top-k, top-p,
min-p, typical-p, temperature, logit bias and the repetition / frequency /
presence penalties leave (the `top_probs` both chains report) matches the
JAX chain's within atol 1e-6 (f32 softmax; only summation order differs).
The random streams differ (JAX threefry, the port's integer hash of
(seed, step)), so seeded sampling is held to the reported distribution by
its empirical frequencies."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu import sampling as js
from llama_box_tpu_torch import sampling as ts

V = 300
ATOL = 1e-6
PARAMS = [
    dict(temp=0.0),
    dict(temp=0.8, top_k=40, top_p=0.9, min_p=0.05),
    dict(temp=1.3, top_k=0, top_p=0.5, min_p=0.0),
    dict(temp=0.5, top_k=20, top_p=1.0, min_p=0.2, penalty_repeat=1.3,
         penalty_freq=0.2, penalty_present=0.1, penalty_last_n=8),
    dict(temp=0.9, top_k=64, typ_p=0.7, logit_bias={5: 3.0, 9: -100.0}),
    dict(temp=0.7, top_k=10, top_p=0.95, min_p=0.05),
]
# one compile per (extras, kcap) instead of op-by-op dispatch
jsample = jax.jit(js.sample_impl, static_argnames=("extras", "kcap"))
PROMPT = np.array([5, 7, 7, 9, 11, 5, 5, 13, 21, 7], np.int32)


def _logits(rng, B):
    return (rng.standard_normal((B, V)) * 2.5).astype(np.float32)


def _both(params, logits, extras=True, kcap=0):
    B = len(params)
    jp = [js.SamplerParams(**p) for p in params]
    tp = [ts.SamplerParams(**p) for p in params]
    jarr = js.make_sampler_arrays(jp, eog_ids=[2])
    tarr = ts.make_sampler_arrays(tp, eog_ids=[2])
    jst = js.init_sampler_state(B, V)
    tst = ts.init_sampler_state(B, V)
    for b, p in enumerate(tp):
        last_n = p.penalty_last_n
        jst = js.push_tokens(jst, b, jnp.asarray(PROMPT), len(PROMPT), last_n)
        ts.push_tokens(tst, b, PROMPT, len(PROMPT), last_n)
    np.testing.assert_array_equal(tst.counts.numpy(), np.asarray(jst.counts))
    np.testing.assert_array_equal(tst.ring.numpy(), np.asarray(jst.ring))
    active = np.ones(B, bool)
    jout = jsample(jnp.asarray(logits), jst, jarr, jnp.asarray(active),
                   extras=extras, kcap=kcap)
    tout = ts.sample_impl(torch.from_numpy(logits), tst, tarr,
                          torch.from_numpy(active), extras=extras, kcap=kcap)
    return [np.asarray(x) for x in jout[:4]], [x.numpy() for x in tout[:4]]


@pytest.mark.parametrize("extras", [True, False])
def test_filtered_distribution_matches_jax(extras):
    params = PARAMS if extras else [p for p in PARAMS
                                    if ts.SamplerParams(**p).plain]
    logits = _logits(np.random.default_rng(0), len(params))
    (jt, jids, jprobs, _), (tt, tids, tprobs, _) = _both(params, logits,
                                                         extras=extras)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tprobs, jprobs, rtol=0, atol=ATOL)
    greedy = [b for b, p in enumerate(params) if p["temp"] <= 0]
    for b in greedy:
        assert tt[b] == jt[b] == int(np.argmax(logits[b]))


def test_kcap_keeps_the_plain_distribution():
    params = [p for p in PARAMS if ts.SamplerParams(**p).plain
              and 0 < ts.SamplerParams(**p).top_k <= 64]
    logits = _logits(np.random.default_rng(1), len(params))
    (_, jids, jprobs, _), (_, tids, tprobs, _) = _both(
        params, logits, extras=False, kcap=64)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tprobs, jprobs, rtol=0, atol=ATOL)


def test_penalty_window_advances_like_jax():
    """The sampled tokens' push into the ring: fed the same tokens, both
    packages' counts and rings agree (greedy rows sample the same token)."""
    params = [dict(temp=0.0, penalty_repeat=1.1, penalty_last_n=4)] * 3
    logits = _logits(np.random.default_rng(2), 3)
    jarr = js.make_sampler_arrays([js.SamplerParams(**p) for p in params])
    tarr = ts.make_sampler_arrays([ts.SamplerParams(**p) for p in params])
    jst, tst = js.init_sampler_state(3, V), ts.init_sampler_state(3, V)
    active = np.array([True, False, True])
    for _ in range(6):
        jt, *_, jst = jsample(jnp.asarray(logits), jst, jarr,
                              jnp.asarray(active))
        tt, *_, tst = ts.sample_impl(torch.from_numpy(logits), tst, tarr,
                                     torch.from_numpy(active))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        logits = np.roll(logits, 7, axis=1)
    np.testing.assert_array_equal(tst.counts.numpy(), np.asarray(jst.counts))
    np.testing.assert_array_equal(tst.ring_len.numpy(),
                                  np.asarray(jst.ring_len))
    np.testing.assert_array_equal(tst.step.numpy(), np.asarray(jst.step))


def test_seeded_sampling_follows_the_reported_distribution():
    """N draws from one row's seeded stream: empirical frequencies match
    the reported probabilities (4-sigma binomial band), and one seed
    repeats its stream."""
    p = ts.SamplerParams(temp=1.0, top_k=8, top_p=1.0, min_p=0.0, seed=42)
    logits = torch.from_numpy(_logits(np.random.default_rng(3), 1))
    arrs = ts.make_sampler_arrays([p])
    N = 3000

    def draws(seed):
        st = ts.init_sampler_state(1, V)
        ts.reset_slot(st, 0, seed)
        out = []
        for _ in range(N):
            tok, ids, probs, _, st = ts.sample_impl(
                logits, st, arrs, torch.ones(1, dtype=torch.bool),
                extras=False)
            out.append(int(tok[0]))
        return np.asarray(out), ids[0].numpy(), probs[0].numpy()

    toks, ids, probs = draws(42)
    for i, pr in zip(ids[:8], probs[:8]):
        freq = float(np.mean(toks == i))
        assert abs(freq - pr) <= 4 * np.sqrt(pr * (1 - pr) / N) + 1e-3
    assert set(toks.tolist()) <= set(ids[:8].tolist())
    again, _, _ = draws(42)
    np.testing.assert_array_equal(again, toks)


@pytest.mark.parametrize("last_n", [0, 4, 64, ts.RING_CAP])
def test_seed_slot_is_reset_then_push_without_a_read_back(last_n):
    """seed_slot (the engine's admission: reset and push the prompt window
    from the host, one staged upload) leaves the state bit for bit where
    reset_slot + push_tokens leave it, in the port and in the JAX package,
    on a slot whose window, step and key held another task's values."""
    from llama_box_tpu_torch.utils.staging import StagedBuffer
    rng = np.random.default_rng(11)
    window = rng.integers(0, V, 300).astype(np.int32)
    n = min(last_n, len(window)) if last_n > 0 else 0
    toks = window[-n:] if n else window[:0]
    B, slot, seed = 3, 1, 0xDEADBEEF
    dirty = ts.init_sampler_state(B, V)
    ts.push_tokens(dirty, slot, window[:50], 50, 16)
    dirty.step.fill_(9)
    dirty.keys.fill_(5)
    want = ts.SamplerState(*(t.clone() for t in dirty))
    ts.reset_slot(want, slot, seed)
    if n:
        ts.push_tokens(want, slot, toks, n, last_n)
    got = ts.SamplerState(*(t.clone() for t in dirty))
    staging = StagedBuffer(ts.window_size(V), torch.int32, "cpu", n_host=2)
    ts.seed_slot(got, slot, seed, toks, n, last_n, staging)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    jst = js.init_sampler_state(B, V)
    jst = js.reset_slot(jst, slot, jnp.uint32(seed))
    if n:
        jst = js.push_tokens(jst, slot, jnp.asarray(toks), n, last_n)
    np.testing.assert_array_equal(got.counts[slot].numpy(),
                                  np.asarray(jst.counts[slot]))
    np.testing.assert_array_equal(got.ring[slot].numpy(),
                                  np.asarray(jst.ring[slot]))
    assert int(got.ring_len[slot]) == int(jst.ring_len[slot])
