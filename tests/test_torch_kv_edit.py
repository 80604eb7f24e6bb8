"""The port's two in-place KV-cache edits (llama_box_tpu_torch/models/
llama.py: make_delta_rope, shift_kv, copy_kv_prefix) and the engine logic
that calls them (server/engine.py: _context_shift, _share_prefix), on the
CPU, against the JAX package on the same numpy inputs.

Tolerances: make_delta_rope equal to JAX's tables bit for bit (the same
float64 numpy tables, one f32 division); shift_kv over the whole slot,
f32 within 1e-6, bf16 equal or one bf16 ulp apart (an f32 rotation that
rounds the other way), int8 codes within 1 with the share of equal codes
stated (at least 99 %) and the bf16 scales equal; copy_kv_prefix bit for
bit. Every other slot, and every leaf's data_ptr, is unchanged by an
edit. Engine parity on the tiny fixture GGUF with f32 weights and cache:
greedy tokens through a cross-slot copy equal a cold run's and the JAX
engine's."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu import cli as jcli
from llama_box_tpu.gguf import GGUFFile as JGGUFFile
from llama_box_tpu.models import llama as jllama
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.models.config import ModelConfig as JModelConfig
from llama_box_tpu.sampling import SamplerParams as JSamplerParams
from llama_box_tpu.server import Engine as JEngine, EngineConfig as JEngineConfig
from llama_box_tpu.server.task import CompletionsTask as JTask
from llama_box_tpu.tokenizer import Tokenizer as JTokenizer
from llama_box_tpu_torch import cli
from llama_box_tpu_torch.gguf import GGUFFile
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models.config import ModelConfig
from llama_box_tpu_torch.models.loader import (deinterleave_rope,
                                               fuse_projections, load_model)
from llama_box_tpu_torch.sampling import SamplerParams
from llama_box_tpu_torch.server.engine import Engine, EngineConfig, _Chain
from llama_box_tpu_torch.server.task import CompletionsTask
from llama_box_tpu_torch.tokenizer import Tokenizer
from llama_box_tpu_torch.utils.text import longest_common_prefix
from .fixtures.make_tiny_model import write_tiny_model

# the fixture seed of test_torch_engine (its f32 greedy steps clear their
# margins)
SEED = 2
TIMEOUT = 180
L, S, C, HKV, D = 3, 3, 16, 2, 8
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
_JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
# (n_keep, n_discard): no prefix kept, one row dropped, and a window that
# reaches past the capacity (its source rows clip to C - 1)
PAIRS = [(0, 1), (0, 4), (2, 3), (5, 1), (3, 13), (7, 9)]


# -- make_delta_rope ----------------------------------------------------------


_DELTA_CFGS = {
    "plain": dict(),
    "yarn": dict(rope_scaling_type="yarn", rope_freq_scale=0.25,
                 rope_orig_ctx=4096, yarn_attn_factor=1.3),
    "nope": dict(nope_layer_step=4),
    "swa_base": dict(swa_pattern=6, rope_freq_base=1e6,
                     rope_freq_base_swa=1e4),
}


def _cfgs(**kw):
    base = dict(n_layers=L, n_embd=64, n_heads=4, n_kv_heads=HKV,
                head_dim=D, n_ff=128, vocab_size=32)
    base.update(kw)
    return ModelConfig(**base), JModelConfig(**base)


@pytest.mark.parametrize("name", sorted(_DELTA_CFGS))
def test_make_delta_rope_matches_jax(name):
    """The plain tables, YaRN with freq_scale 0.25 (the residual mscale
    divided out), and both stacked [2, P, half] branches."""
    tcfg, jcfg = _cfgs(**_DELTA_CFGS[name])
    tc, ts = tllama.make_delta_rope(tcfg, 64, device="cpu")
    jc, js = jllama.make_delta_rope(jcfg, 64)
    assert tc.shape == jc.shape == ((2, 64, D // 2) if name in (
        "nope", "swa_base") else (64, D // 2))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if name == "yarn":
        # a pure rotation: cos^2 + sin^2 = 1 where make_rope's carry mscale
        np.testing.assert_allclose((tc ** 2 + ts ** 2).numpy(), 1.0,
                                   rtol=1e-6)


# -- shift_kv -----------------------------------------------------------------


def _random_cache(kind, seed):
    """The same cache as numpy arrays (f32 values; int8 codes and bf16-
    representable scales) and as the port's KVCache."""
    rng = np.random.default_rng(seed)
    shape = (L, S, C, HKV, D)
    if kind == "int8":
        arrs = [rng.integers(-127, 128, shape).astype(np.int8),
                rng.integers(-127, 128, shape).astype(np.int8),
                rng.uniform(0.001, 0.05, shape[:-1]).astype(np.float32),
                rng.uniform(0.001, 0.05, shape[:-1]).astype(np.float32)]
        t = [torch.tensor(a) for a in arrs[:2]] \
            + [torch.tensor(a).to(torch.bfloat16) for a in arrs[2:]]
        arrs[2:] = [x.float().numpy() for x in t[2:]]
    else:
        arrs = [rng.standard_normal(shape).astype(np.float32)
                for _ in range(2)]
        t = [torch.tensor(a).to(_TORCH[kind]) for a in arrs]
        arrs = [x.float().numpy().copy() for x in t]
    return arrs, tllama.KVCache(*t)


def _jax_cache(arrs, kind):
    if kind == "int8":
        return jllama.KVCache(
            k=jnp.asarray(arrs[0]), v=jnp.asarray(arrs[1]),
            k_scale=jnp.asarray(arrs[2], jnp.bfloat16),
            v_scale=jnp.asarray(arrs[3], jnp.bfloat16))
    return jllama.KVCache(k=jnp.asarray(arrs[0], _JAX[kind]),
                          v=jnp.asarray(arrs[1], _JAX[kind]))


def _np(x):
    x = np.asarray(x) if not isinstance(x, torch.Tensor) else x
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype != torch.int8 else x.numpy()
    return x.astype(np.float32) if x.dtype != np.int8 else x


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("mode", ["norm", "neox"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_shift_kv_matches_jax(kind, mode):
    """Every (n_keep, n_discard) of PAIRS on slot 1, the whole slot
    against JAX shift_kv; slots 0 and 2 and the data_ptrs unchanged."""
    tcfg, jcfg = _cfgs()
    dcos, dsin = tllama.make_delta_rope(tcfg, C, device="cpu")
    jdcos, jdsin = jllama.make_delta_rope(jcfg, C)
    n_eq = n_all = 0
    for i, (n_keep, n_discard) in enumerate(PAIRS):
        arrs, kv = _random_cache(kind, 10 + i)
        ptrs = [x.data_ptr() for x in kv if x is not None]
        before = [_np(x).copy() for x in kv if x is not None]
        out = tllama.shift_kv(kv, 1, n_keep, n_discard, dcos, dsin, mode)
        assert out is kv
        assert [x.data_ptr() for x in kv if x is not None] == ptrs
        jout = jllama.shift_kv(_jax_cache(arrs, kind), jnp.int32(1),
                               jnp.int32(n_keep), jnp.int32(n_discard),
                               jdcos, jdsin, mode)
        got = [_np(x) for x in kv if x is not None]
        want = [_np(x) for x in jout if x is not None]
        for g, b in zip(got, before):       # the other slots keep their bits
            np.testing.assert_array_equal(g[:, [0, 2]], b[:, [0, 2]])
        gk, wk = got[0][:, 1], want[0][:, 1]
        if kind == "f32":
            np.testing.assert_allclose(gk, wk, rtol=0, atol=1e-6)
        elif kind == "bf16":
            assert (np.abs(gk - wk) <= _bf16_ulp(wk)).all(), (n_keep,
                                                             n_discard)
        else:
            diff = np.abs(gk.astype(np.int32) - wk.astype(np.int32))
            assert diff.max() <= 1, (n_keep, n_discard)
            n_eq += int((diff == 0).sum())
            n_all += diff.size
            np.testing.assert_array_equal(got[2][:, 1], want[2][:, 1])
            np.testing.assert_array_equal(got[3][:, 1], want[3][:, 1])
        np.testing.assert_array_equal(got[1][:, 1], want[1][:, 1])
    if kind == "int8":
        assert n_eq / n_all >= 0.99, n_eq / n_all


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny.gguf")
    write_tiny_model(path, seed=SEED)
    return path


@pytest.mark.parametrize("layout", ["norm", "neox"])
def test_shift_kv_matches_reprefill(model_path, layout):
    """A shift (drop 4 rows after 2, re-rotate) against prefilling the
    kept tokens from scratch (the JAX package's
    test_shift_kv_matches_reprefill): the kept prefix exactly, and the
    first layer's keys and values (a function of token and position
    only) over every kept row; with the GGUF's adjacent-pair rotation and
    with the engine's half-split one (deinterleave_rope)."""
    cfg, params = load_model(model_path, dtype=torch.float32, device="cpu")
    if layout == "neox":
        params, cfg = deinterleave_rope(params, cfg)
        params = fuse_projections(params, cfg)
    assert cfg.rope_mode == layout
    rng = np.random.default_rng(8)
    toks = rng.integers(3, 50, size=12).astype(np.int32)
    cos, sin = tllama.make_rope(cfg, 64, device="cpu")
    dcos, dsin = tllama.make_delta_rope(cfg, 64, device="cpu")
    n_keep, n_discard = 2, 4
    kept = np.concatenate([toks[:n_keep], toks[n_keep + n_discard:]])

    def prefill(ids):
        kv = tllama.init_kv_cache(cfg, 2, 16, torch.float32, device="cpu")
        pad = np.zeros((2, 16), np.int32)
        pad[0, :len(ids)] = ids
        _, kv = tllama.prefill_batch_impl(params, cfg, torch.from_numpy(pad),
                                          np.zeros(2), np.array([len(ids), 0]),
                                          kv, cos, sin)
        return kv
    kv = tllama.shift_kv(prefill(toks), 0, n_keep, n_discard, dcos, dsin,
                         cfg.rope_mode)
    ref = prefill(kept)
    n = len(kept)
    np.testing.assert_allclose(kv.k[:, 0, :n_keep].numpy(),
                               ref.k[:, 0, :n_keep].numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(kv.k[0, 0, :n].numpy(), ref.k[0, 0, :n].numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(kv.v[0, 0, :n].numpy(), ref.v[0, 0, :n].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not kv.k[:, 1].any()            # the other slot untouched


# -- copy_kv_prefix -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_copy_kv_prefix_matches_jax(kind):
    """Rows [0, 5) of slot 0 into slot 2, every leaf, bit for bit against
    JAX copy_kv_prefix (the JAX package's test_copy_kv_prefix_exactness);
    the rows of slot 2 from 5 on and slots 0 and 1 keep their bits."""
    arrs, kv = _random_cache(kind, 4)
    before = [_np(x).copy() for x in kv if x is not None]
    ptrs = [x.data_ptr() for x in kv if x is not None]
    assert tllama.copy_kv_prefix(kv, 0, 2, 5) is kv
    jout = jllama.copy_kv_prefix(_jax_cache(arrs, kind), jnp.int32(0),
                                 jnp.int32(2), jnp.int32(5))
    assert [x.data_ptr() for x in kv if x is not None] == ptrs
    for g, w, b in zip([_np(x) for x in kv if x is not None],
                       [_np(x) for x in jout if x is not None], before):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g[:, 2, :5], b[:, 0, :5])
        np.testing.assert_array_equal(g[:, 2, 5:], b[:, 2, 5:])
        np.testing.assert_array_equal(g[:, :2], b[:, :2])


# -- the engine ---------------------------------------------------------------


@pytest.fixture(scope="module")
def model(model_path):
    cfg, params = load_model(model_path, dtype=torch.float32, device="cpu")
    with GGUFFile(model_path) as g:
        tok = Tokenizer.from_gguf(g)
    return cfg, params, tok


def _engine(model, start=True, **kw):
    cfg, params, tok = model
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


@pytest.mark.parametrize("n_keep", [4, 0, 100])
def test_context_shift_reference_amounts(model, n_keep):
    """On an engine that was never started (no reconcile thread to race):
    a shift discards min(n_left / 4, n_ubatch) rows after n_keep (clamped
    to pos - 2), as the JAX engine's test_context_shift_reference_amounts
    checks on a running one; the sampler's step does not move; and a
    shift with a chain in flight over the slot raises."""
    eng = _engine(model, start=False, n_slots=2, n_ctx=128)
    s = eng.slots[0]
    task = CompletionsTask([5], SamplerParams(temp=0.0),
                           tokenizer=eng.tokenizer, max_tokens=1,
                           n_keep=n_keep)
    s.task, s.state = task, "decode"
    s.cache_tokens = list(range(eng.slot_ctx))
    s.pos = eng.slot_ctx
    step = eng.sstate.step.clone()
    eng._context_shift(s)
    keep = max(0, min(n_keep, eng.slot_ctx - 2))
    expect = max(1, min((eng.slot_ctx - keep) // 4, eng.ecfg.n_ubatch))
    assert s.pos == eng.slot_ctx - expect
    assert s.cache_tokens == (list(range(keep))
                              + list(range(keep + expect, eng.slot_ctx)))
    assert task.n_shifted == 1
    assert torch.equal(eng.sstate.step, step)
    eng._chain_q.append(_Chain(None, None, np.zeros(2, np.int64),
                               [task, None], 4, 0.0))
    with pytest.raises(RuntimeError, match="chain in flight"):
        eng._context_shift(s)
    assert s.pos == eng.slot_ctx - expect


def test_unbounded_generation_with_seeded_sampling(model):
    """Generation past the slot's capacity keeps going (the JAX engine's
    test_context_shift_unbounded_generation): a seeded, penalised request
    of slot_ctx + 10 tokens gets all of them, or stops on an EOG token."""
    eng = _engine(model, n_slots=2, n_ctx=128, decode_chain=4)
    try:
        n = eng.slot_ctx + 10
        task = CompletionsTask(eng.tokenizer.encode("a"),
                               SamplerParams(temp=1.2, seed=3,
                                             penalty_repeat=1.3),
                               tokenizer=eng.tokenizer, max_tokens=n)
        eng.submit(task)
        final = _final(task)
    finally:
        eng.stop()
    assert len(final.generated) == n or final.finish_reason == "stop"
    if len(final.generated) == n:
        assert final.finish_reason == "length" and final.n_shifted >= 1


SHARED = "the quick brown fox jumps over the lazy dog and"


def _jax_share(path, prompts):
    """The JAX engine's greedy tokens of `prompts` ((text, max_tokens)),
    the second submitted once the first decodes, on 2 slots with
    cache_share_min 4; and the second's n_cached."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLAMA_BOX_TPU_FORCE_FLASH", "1")
        jcfg, jparams = jax_load(path, dtype=jnp.float32)
        with JGGUFFile(path) as g:
            jtok = JTokenizer.from_gguf(g)
        eng = JEngine(jcfg, jparams, jtok, JEngineConfig(
            n_slots=2, n_ctx=128, n_ubatch=16, kv_dtype="float32",
            decode_chain=4, cache_share_min=4))
        eng.start()
        try:
            (pa, na), (pb, nb) = prompts
            ta = JTask(jtok.encode(pa), JSamplerParams(temp=0.0),
                       tokenizer=jtok, max_tokens=na, stream=True)
            eng.submit(ta)
            kind, _ = ta.result_q.get(timeout=TIMEOUT)
            assert kind in ("delta", "final")
            tb = JTask(jtok.encode(pb), JSamplerParams(temp=0.0),
                       tokenizer=jtok, max_tokens=nb)
            eng.submit(tb)
            fb = _final(tb)
            fa = _final(ta)
        finally:
            eng.stop()
    return [fa.generated, fb.generated], fb.n_cached


def test_cross_slot_prefix_share_matches_cold_and_jax(model, model_path):
    """A request sharing a long prefix with a busy sibling slot takes its
    rows by copy_kv_prefix (the JAX engine's test_cross_slot_prefix_share):
    n_cached covers the shared prefix, its greedy tokens equal a cold run
    on a fresh single-slot engine and both requests' tokens equal the JAX
    engine's; with --prompt-cache-share-min -1 nothing is copied."""
    tok = model[2]
    prompts = [(SHARED + " runs far", 24), (SHARED + " sleeps here", 6)]
    shared = tok.encode(SHARED)
    assert longest_common_prefix(tok.encode(prompts[0][0]),
                                 tok.encode(prompts[1][0])) >= len(shared) - 1

    def run(share_min):
        eng = _engine(model, n_slots=2, n_ctx=128, decode_chain=4,
                      cache_share_min=share_min)
        copies = []
        share = eng._share_prefix

        def spy(best, prompt, reuse):
            n = share(best, prompt, reuse)
            copies.append((reuse, n))
            return n
        eng._share_prefix = spy
        try:
            ta = CompletionsTask(tok.encode(prompts[0][0]),
                                 SamplerParams(temp=0.0), tokenizer=tok,
                                 max_tokens=prompts[0][1], stream=True)
            eng.submit(ta)
            kind, _ = ta.result_q.get(timeout=TIMEOUT)
            assert kind in ("delta", "final")
            tb = CompletionsTask(tok.encode(prompts[1][0]),
                                 SamplerParams(temp=0.0), tokenizer=tok,
                                 max_tokens=prompts[1][1])
            eng.submit(tb)
            fb = _final(tb)
            fa = _final(ta)
        finally:
            eng.stop()
        return [fa.generated, fb.generated], fb.n_cached, copies

    port, n_cached, copies = run(4)
    assert n_cached >= len(shared) - 1, n_cached
    assert copies[1][1] > copies[1][0]          # B's rows came by copy
    cold = _engine(model, n_slots=1, n_ctx=64)
    try:
        t = CompletionsTask(tok.encode(prompts[1][0]), SamplerParams(temp=0.0),
                            tokenizer=tok, max_tokens=prompts[1][1])
        cold.submit(t)
        assert _final(t).generated == port[1]
    finally:
        cold.stop()
    off, n_off, copies_off = run(-1)
    assert off == port and n_off < len(shared) - 1
    assert all(n == r for r, n in copies_off)
    jax_out, jax_cached = _jax_share(model_path, prompts)
    assert port == jax_out and n_cached == jax_cached


def test_kv_edit_flags_parse_to_the_jax_defaults():
    """--prompt-cache-share-min, --keep and --context-shift /
    --no-context-shift parse as the JAX CLI parses them, and the engine's
    defaults for them are the JAX engine's."""
    p, jp = cli.build_parser(), jcli.build_parser()
    keys = ("prompt_cache_share_min", "n_keep", "context_shift")
    for argv in ([], ["--prompt-cache-share-min", "-1", "--keep", "7",
                      "--no-context-shift"], ["--context-shift"]):
        a, ja = p.parse_args(argv), jp.parse_args(argv)
        assert [getattr(a, k) for k in keys] == [getattr(ja, k)
                                                 for k in keys], argv
    assert [getattr(p.parse_args([]), k) for k in keys] == [32, 0, True]
    e, je = EngineConfig(), JEngineConfig()
    assert (e.cache_share_min, e.n_keep_default) == (
        je.cache_share_min, je.n_keep_default) == (32, 0)


def test_engine_builds_the_delta_tables_beside_the_rope(model):
    """The engine makes the pure-rotation tables at start-up, on its
    device, for its slot capacity, as the JAX engine does."""
    eng = _engine(model, start=False, n_slots=2, n_ctx=128)
    want = tllama.make_delta_rope(eng.cfg, eng.slot_ctx, device="cpu")
    assert eng.delta_cos.shape == eng.rope_cos.shape
    assert torch.equal(eng.delta_cos, want[0])
    assert torch.equal(eng.delta_sin, want[1])
    assert math.isclose(float(eng.delta_cos[0, 0]), 1.0)
