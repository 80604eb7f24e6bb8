"""Port parity of the llama-family embedding pass
(models/llama.forward_embeddings) and of the engine's embeddings and
rerank tasks against the JAX package, on tests/fixtures/make_tiny_model.py's
fixture: F32 (dense f32 and bf16 weights) and Q4_K at widths where Q4_K
lands whole (N_EMBD=256, HEAD_DIM=64, N_FF=512), loaded as w8a8 (the
default quantized residency) and as the grouped one (LLAMA_BOX_TPU_PACKED4);
inputs from a numpy seed.

- forward_embeddings against the JAX function for mean, cls and last and
  for the per-token output (pooling rank; the rows each input holds), at
  96 rows a pass and, on w8a8, at 32 rows (the fused kernels' plain
  versions): with f32 activations (dense, w8a8 and grouped weights: the
  same int8 codes and group sums) within atol 1e-4; with bf16 activations
  dense and grouped within atol 5e-2 (the w8a8 and grouped model tests'
  tolerance: the port rounds to bf16 at every op the code names, XLA on
  the CPU keeps f32 across fused bf16 ops), w8a8 within atol 0.15 and a
  cosine of 0.999 a row (such a rounding moves an int8 activation code,
  4.4e-2 on the w8a8 model test's logits; here the hidden state after
  the final norm, |x| up to 4.3); the causal pass runs the flash prefill
  kernel's plain version, a non-causal file the dense masked softmax;
- the engine's vectors (normalized, in input order across groups) and
  rerank scores equal the JAX engine's on the same inputs;
- the interleave: stream deltas of a completion arrive before a 12-input
  embed batch finishes (tests/test_engine.py's check);
- the JAX engine's three quirks, mirrored: a llama model's rerank score is
  the first feature of its pair's first token; an input longer than the
  largest bucket is cut to it; an embeddings task waits while every slot
  decodes."""

import dataclasses
import queue
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.fixtures.make_tiny_model as mk
from llama_box_tpu.gguf import GGUFFile as JGGUFFile
from llama_box_tpu.gguf.constants import GGMLType
from llama_box_tpu.models import llama as jllama
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.models.loader import (deinterleave_rope as j_deint,
                                         fuse_projections as j_fuse)
from llama_box_tpu.sampling import SamplerParams as JSamplerParams
from llama_box_tpu.server import Engine as JEngine
from llama_box_tpu.server import EngineConfig as JEngineConfig
from llama_box_tpu.server import EmbeddingsTask as JEmbTask
from llama_box_tpu.server import RerankTask as JRerankTask
from llama_box_tpu.server.task import CompletionsTask as JTask
from llama_box_tpu.tokenizer import Tokenizer as JTokenizer
from llama_box_tpu_torch.gguf import GGUFFile
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models.loader import (deinterleave_rope,
                                               fuse_projections, load_model)
from llama_box_tpu_torch.ops import fused_decode, qmatmul
from llama_box_tpu_torch.sampling import SamplerParams
from llama_box_tpu_torch.server import (CompletionsTask, EmbeddingsTask,
                                        Engine, EngineConfig, RerankTask)
from llama_box_tpu_torch.tokenizer import Tokenizer

ATOL_F32, ATOL_BF16, ATOL_W8A8, COS_W8A8 = 1e-4, 5e-2, 0.15, 0.999
POOLINGS = ("mean", "cls", "last", "rank")
# weights -> (file, activation dtype, quantized, residency switch)
WEIGHTS = {"f32": ("f32", "float32", False, None),
           "bf16": ("f32", "bfloat16", False, None),
           "w8a8_f32": ("q4k", "float32", True, None),
           "w8a8": ("q4k", "bfloat16", True, None),
           "grouped_f32": ("q4k", "float32", True, "LLAMA_BOX_TPU_PACKED4"),
           "grouped": ("q4k", "bfloat16", True, "LLAMA_BOX_TPU_PACKED4")}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("emb")
    out = {"f32": str(d / "tiny.gguf"), "q4k": str(d / "tiny-q4k.gguf")}
    mk.write_tiny_model(out["f32"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mk, "N_EMBD", 256)
        mp.setattr(mk, "HEAD_DIM", 64)
        mp.setattr(mk, "N_FF", 512)
        mk.write_tiny_model(out["q4k"], quant=GGMLType.Q4_K)
    return out


@pytest.fixture(scope="module")
def models(paths):
    """weights -> (jcfg, jax params, tcfg, port params), both after the
    rope de-interleave and the projection fusion the engines apply."""
    out = {}
    for name, (f, dt, quant, switch) in WEIGHTS.items():
        with pytest.MonkeyPatch.context() as mp:
            if switch:
                mp.setenv(switch, "1")
            jcfg, jp = jax_load(paths[f], dtype=getattr(jnp, dt),
                                quantized=quant)
            tcfg, tp = load_model(paths[f], dtype=getattr(torch, dt),
                                  device="cpu", quantized=quant)
        jp, jcfg = j_deint(jp, jcfg)
        jp = j_fuse(jp, jcfg)
        tp, tcfg = deinterleave_rope(tp, tcfg)
        tp = fuse_projections(tp, tcfg)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        out[name] = (jcfg, jp, tcfg, tp)
    return out


def _inputs(B, T, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, 280, (B, T)).astype(np.int32)
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[0] = T
    return toks, lens


def _both(jcfg, jp, tcfg, tp, toks, lens, pooling):
    T = toks.shape[1]
    jcos, jsin = jllama.make_rope(jcfg, T)
    tcos, tsin = tllama.make_rope(tcfg, T, device="cpu")
    want = np.asarray(jllama.forward_embeddings(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), jcos, jsin,
        pooling=pooling)).astype(np.float32)
    got = tllama.forward_embeddings(tp, tcfg, torch.from_numpy(toks),
                                    torch.from_numpy(lens), tcos, tsin,
                                    pooling=pooling)
    assert got.dtype == torch.float32
    return got.numpy(), want


def _assert_close(got, want, lens, pooling, weights):
    assert got.shape == want.shape
    if pooling == "rank":       # per token: the rows each input holds
        got = np.concatenate([got[b, :n] for b, n in enumerate(lens)])
        want = np.concatenate([want[b, :n] for b, n in enumerate(lens)])
    if weights == "w8a8":
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                      * np.linalg.norm(want, axis=-1))
        assert cos.min() >= COS_W8A8, cos.min()
        atol = ATOL_W8A8
    else:
        atol = ATOL_F32 if weights.startswith("f32") \
            or weights.endswith("_f32") else ATOL_BF16
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("pooling", POOLINGS)
@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_forward_embeddings_matches_jax(models, weights, pooling):
    toks, lens = _inputs(3, 32)
    got, want = _both(*models[weights], toks, lens, pooling)
    if pooling == "rank":
        assert got.shape == (3, 32, models[weights][2].n_embd)
    _assert_close(got, want, lens, pooling, weights)


@pytest.mark.parametrize("pooling", POOLINGS)
def test_forward_embeddings_w8a8_fused_rows_match_jax(models, pooling,
                                                      monkeypatch):
    """32 rows a pass: the q/k/v projection and the layer tail take the
    fused kernels (their plain versions here)."""
    calls = {"qkv": 0, "tail": 0}
    qkv, tail = fused_decode.fused_norm_qmm, fused_decode.fused_layer_tail

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(tllama, "fused_norm_qmm", count("qkv", qkv))
    monkeypatch.setattr(tllama, "fused_layer_tail", count("tail", tail))
    toks, lens = _inputs(2, 16)
    got, want = _both(*models["w8a8"], toks, lens, pooling)
    _assert_close(got, want, lens, pooling, "w8a8")
    n_layers = models["w8a8"][2].n_layers
    assert calls == {"qkv": n_layers, "tail": n_layers}


def test_forward_embeddings_grouped_takes_the_group_kernels(models,
                                                            monkeypatch):
    seen = []
    ref = qmatmul.q_matmul_ref

    def spy(*a, **kw):
        seen.append(a[0].shape)
        return ref(*a, **kw)
    monkeypatch.setattr(qmatmul, "q_matmul_ref", spy)
    toks, lens = _inputs(3, 32)
    _both(*models["grouped"], toks, lens, "mean")
    assert len(seen) >= 3 * models["grouped"][2].n_layers


@pytest.mark.parametrize("weights", ["f32", "bf16"])
def test_non_causal_file_matches_jax(models, weights):
    jcfg, jp, tcfg, tp = models[weights]
    jcfg = dataclasses.replace(jcfg, causal=False)
    tcfg = dataclasses.replace(tcfg, causal=False)
    toks, lens = _inputs(3, 32)
    for pooling in POOLINGS:
        got, want = _both(jcfg, jp, tcfg, tp, toks, lens, pooling)
        _assert_close(got, want, lens, pooling, weights)
    # the first row now sees the rows after it: not the causal output
    causal, _ = _both(*models[weights], toks, lens, "cls")
    bidir, _ = _both(jcfg, jp, tcfg, tp, toks, lens, "cls")
    assert np.abs(causal - bidir).max() > 1e-2


# -- the engine ----------------------------------------------------------------


def _final(task, timeout=120):
    while True:
        kind, payload = task.result_q.get(timeout=timeout)
        if kind == "error":
            raise payload
        if kind == "final":
            return payload


def _run(engine, tasks):
    engine.start()
    try:
        for t in tasks:
            engine.submit(t)
        return [_final(t) for t in tasks]
    finally:
        engine.stop()


def _tok(path, jax=False):
    if jax:
        with JGGUFFile(path) as g:
            return JTokenizer.from_gguf(g)
    with GGUFFile(path) as g:
        return Tokenizer.from_gguf(g)


TEXTS = ["hello world", "the quick test", "a", "hello hello hello world is",
         "the end and the test and the world", "he", "world world"]
DOCS = ["hello world", "the test", "a world", "hello"]


def _engine_runs(path, dt, ecfg):
    """Normalized embeddings, rerank scores (normalize on and off) of both
    engines on the same token lists."""
    jcfg, jp = jax_load(path, dtype=getattr(jnp, dt))
    tcfg, tp = load_model(path, dtype=getattr(torch, dt), device="cpu")
    out = {}
    for name, eng, tok, Emb, Rer in (
            ("jax", JEngine(jcfg, jp, _tok(path, True), JEngineConfig(
                **ecfg)), _tok(path, True), JEmbTask, JRerankTask),
            ("port", Engine(tcfg, tp, _tok(path), EngineConfig(**ecfg),
                            device="cpu"), _tok(path), EmbeddingsTask,
             RerankTask)):
        ids = [tok.encode(x) for x in TEXTS]
        pairs = [[tok.bos_id] + tok.encode("hello", add_special=False)
                 + [tok.eos_id] + tok.encode(d, add_special=False)
                 + [tok.eos_id] * 2 for d in DOCS]
        res = _run(eng, [Emb(ids), Rer(pairs, n_documents=len(DOCS),
                                       normalize=False),
                         Rer(pairs + pairs[:2], n_documents=len(DOCS))])
        out[name] = dict(ids=ids, pairs=pairs,
                         emb=np.asarray(res[0].embeddings),
                         raw=res[1].scores, scores=res[2].scores)
    return out


@pytest.fixture(scope="module")
def runs(paths):
    ecfg = dict(n_slots=2, n_ctx=128, n_ubatch=16, max_embed_batch=3)
    return {dt: _engine_runs(paths["f32"], dt, ecfg)
            for dt in ("float32", "bfloat16")}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_engine_embeddings_equal_jax_in_input_order(runs, paths, dt):
    j, t = runs[dt]["jax"], runs[dt]["port"]
    assert t["emb"].shape == (len(TEXTS), mk.N_EMBD)
    np.testing.assert_allclose(np.linalg.norm(t["emb"], axis=1), 1.0,
                               rtol=1e-6)
    atol = 1e-5 if dt == "float32" else 2e-2
    np.testing.assert_allclose(t["emb"], j["emb"], rtol=0, atol=atol)
    if dt == "float32":
        # row i is input i's vector (the groups ran sorted by length)
        tcfg, tp = load_model(paths["f32"], dtype=torch.float32,
                              device="cpu")
        cos, sin = tllama.make_rope(tcfg, 16, device="cpu")
        for i, ids in enumerate(t["ids"]):
            v = tllama.forward_embeddings(tp, tcfg, [ids], [len(ids)], cos,
                                          sin)[0].double().numpy()
            np.testing.assert_allclose(t["emb"][i], v / np.linalg.norm(v),
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_engine_rerank_scores_equal_jax(runs, dt):
    j, t = runs[dt]["jax"], runs[dt]["port"]
    atol = 1e-4 if dt == "float32" else 5e-2
    np.testing.assert_allclose(t["raw"], j["raw"], rtol=0, atol=atol)
    np.testing.assert_allclose(t["scores"], j["scores"], rtol=0, atol=atol)


def test_quirk_llama_rerank_scores_the_first_feature_of_the_first_token(
        runs, paths):
    """JAX `_finish_rerank` on a llama model: forward_embeddings' rank
    pooling falls through to the per-token output and the score is its
    [0, 0]: one causal first token (BOS for every pair) gives every
    document the same score."""
    t = runs["float32"]["port"]
    tcfg, tp = load_model(paths["f32"], dtype=torch.float32, device="cpu")
    cos, sin = tllama.make_rope(tcfg, 16, device="cpu")
    for s, pair in zip(t["raw"], t["pairs"]):
        x = tllama.forward_embeddings(tp, tcfg, [pair], [len(pair)], cos, sin,
                                      pooling="rank")
        assert s == pytest.approx(float(x[0, 0, 0]), abs=1e-6)
    assert max(t["raw"]) - min(t["raw"]) < 1e-6
    assert t["scores"] == [0.0] * len(DOCS)


def test_quirk_an_input_past_the_largest_bucket_is_cut(paths):
    """n_ubatch 16: the largest bucket is 16 tokens, and a 40-token input
    embeds as its first 16, in both engines."""
    ecfg = dict(n_slots=1, n_ctx=64, n_ubatch=16)
    long_ids = [1] + list(range(40, 79))
    embs = {}
    for name, eng, Emb in (
            ("jax", JEngine(*jax_load(paths["f32"], dtype=jnp.float32),
                            _tok(paths["f32"], True), JEngineConfig(**ecfg)),
             JEmbTask),
            ("port", Engine(*load_model(paths["f32"], dtype=torch.float32,
                                        device="cpu"), _tok(paths["f32"]),
                            EngineConfig(**ecfg), device="cpu"),
             EmbeddingsTask)):
        res = _run(eng, [Emb([long_ids]), Emb([long_ids[:16]]),
                         Emb([long_ids[:17]])])
        embs[name] = [np.asarray(r.embeddings[0]) for r in res]
    for e in embs.values():
        np.testing.assert_array_equal(e[0], e[1])
        np.testing.assert_array_equal(e[2], e[1])
    np.testing.assert_allclose(embs["port"][0], embs["jax"][0], rtol=0,
                               atol=1e-5)


def _drain_final(task) -> bool:
    """Read every event a task has emitted so far: was its final one?"""
    final = False
    while True:
        try:
            kind, payload = task.result_q.get_nowait()
        except queue.Empty:
            return final
        if kind == "error":
            raise payload
        final = final or kind == "final"


def _wait_delta(task, timeout=120):
    kind, payload = task.result_q.get(timeout=timeout)
    if kind == "error":
        raise payload
    return kind


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_quirk_embeddings_wait_while_every_slot_decodes(paths, pkg):
    """One slot, decoding a 24-token greedy request: an embeddings task
    submitted after its first token finishes only after it, in both
    engines (JAX `_admit` takes a task from the queue only while a slot is
    idle)."""
    ecfg = dict(n_slots=1, n_ctx=128, n_ubatch=16, decode_chain=1)
    if pkg == "jax":
        cfg, params = jax_load(paths["f32"], dtype=jnp.float32)
        tok = _tok(paths["f32"], True)
        eng = JEngine(cfg, params, tok, JEngineConfig(**ecfg))
        comp = JTask(tok.encode("hello"), JSamplerParams(temp=0.0,
                                                         ignore_eos=True),
                     tokenizer=tok, max_tokens=24, stream=True)
        emb = JEmbTask([tok.encode("world")])
    else:
        cfg, params = load_model(paths["f32"], dtype=torch.float32,
                                 device="cpu")
        tok = _tok(paths["f32"])
        eng = Engine(cfg, params, tok, EngineConfig(**ecfg), device="cpu")
        comp = CompletionsTask(tok.encode("hello"),
                               SamplerParams(temp=0.0, ignore_eos=True),
                               tokenizer=tok, max_tokens=24, stream=True)
        emb = EmbeddingsTask([tok.encode("world")])
    eng.start()
    try:
        eng.submit(comp)
        assert _wait_delta(comp) == "delta"
        eng.submit(emb)
        # the completion's final, if emitted before the embeddings', is in
        # its queue by the time the embeddings' final is read
        comp_done = False
        deadline = time.monotonic() + 120
        while True:
            assert time.monotonic() < deadline, "no embeddings result"
            comp_done = _drain_final(comp) or comp_done
            try:
                kind, payload = emb.result_q.get(timeout=0.01)
            except queue.Empty:
                continue
            if kind == "error":
                raise payload
            if kind == "final":
                break
        assert _drain_final(comp) or comp_done, \
            "the embeddings finished while the only slot decoded"
    finally:
        eng.stop()


def test_decode_streams_during_large_embed_batch(paths):
    """tests/test_engine.py's check on the port: 12 inputs in groups of 2
    run one group a reconcile pass, so a concurrent completion's stream
    deltas arrive before the batch finishes, and its tokens are those of
    a quiet engine."""
    cfg, params = load_model(paths["f32"], dtype=torch.float32, device="cpu")
    tok = _tok(paths["f32"])
    eng = Engine(cfg, params, tok, EngineConfig(
        n_slots=2, n_ctx=128, n_ubatch=16, max_embed_batch=2), device="cpu")
    greedy = SamplerParams(temp=0.0, ignore_eos=True)
    eng.start()
    try:
        big = EmbeddingsTask([tok.encode(f"input number {i} padding words")
                              for i in range(12)])
        comp = CompletionsTask(tok.encode("a b c"), greedy, tokenizer=tok,
                               max_tokens=6, stream=True)
        eng.submit(big)
        eng.submit(comp)
        before = comp_final = big_final = 0
        deadline = time.monotonic() + 120
        while (not comp_final or not big_final) \
                and time.monotonic() < deadline:
            try:
                kind, payload = comp.result_q.get_nowait()
                if kind == "delta" and not big_final:
                    before += 1
                elif kind == "final":
                    comp_final = 1
                    generated = list(payload.generated)
                elif kind == "error":
                    raise payload
            except queue.Empty:
                pass
            try:
                kind, payload = big.result_q.get_nowait()
                if kind == "final":
                    big_final = 1
                    assert len(payload.embeddings) == 12
                elif kind == "error":
                    raise payload
            except queue.Empty:
                pass
            time.sleep(0.001)
        assert comp_final and big_final
        assert before >= 2, before
        solo = CompletionsTask(tok.encode("a b c"), greedy, tokenizer=tok,
                               max_tokens=6)
        eng.submit(solo)
        assert list(_final(solo).generated) == generated
    finally:
        eng.stop()
