"""Port parity of the BERT encoder (llama_box_tpu_torch/models/bert.py)
against the JAX package's, on tests/test_bert.py's tiny BERT GGUF (a
cross-encoder with a `cls` head, pooling rank, and the same file without
the head, pooling mean), inputs from a numpy seed.

- load_bert gives the JAX loader's tensors, bit for bit, and its config;
- bert_forward against the JAX function for all five poolings: f32 at
  rtol 1e-4 / atol 1e-5; bf16 at atol 5e-2, two bf16 steps at the
  outputs' |x| of up to 3 (the port rounds to bf16 at every op, XLA on
  the CPU keeps f32 across its fused bf16 ops);
- bert_params_from_numpy of the JAX tree gives the port's own forward;
- padding a batch to a longer T changes no pooled output (as
  tests/test_bert.py checks the JAX one);
- the engine's rerank scores and embeddings (L2-normalized, in input
  order across groups) are the JAX engine's on the same pairs;
- an engine on a BERT file refuses completions and a draft model, and
  check_bert_supported refuses a tree without the keys it reads."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.gguf import GGUFFile as JGGUFFile
from llama_box_tpu.models.bert import bert_forward as j_forward
from llama_box_tpu.models.bert import load_bert as j_load
from llama_box_tpu.server import Engine as JEngine
from llama_box_tpu.server import EngineConfig as JEngineConfig
from llama_box_tpu.server import EmbeddingsTask as JEmbTask
from llama_box_tpu.server import RerankTask as JRerankTask
from llama_box_tpu.tokenizer import Tokenizer as JTokenizer
from llama_box_tpu_torch.gguf import GGUFFile
from llama_box_tpu_torch.models.bert import (BERT_ARCHS,
                                             bert_params_from_numpy,
                                             bert_forward, check_bert_supported,
                                             load_bert)
from llama_box_tpu_torch.sampling import SamplerParams
from llama_box_tpu_torch.server import (CompletionsTask, EmbeddingsTask,
                                        Engine, EngineConfig, RerankTask)
from llama_box_tpu_torch.tokenizer import Tokenizer
from tests.test_bert import E, write_tiny_bert

POOLINGS = ("none", "mean", "cls", "last", "rank")
RTOL_F32, ATOL_F32 = 1e-4, 1e-5
ATOL_BF16 = 5e-2
B, T = 4, 24
LENS = np.array([24, 5, 13, 1], np.int32)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("bert")
    out = {"rank": str(d / "bert-rank.gguf"), "mean": str(d / "bert.gguf")}
    write_tiny_bert(out["rank"], seed=0, with_cls=True)
    write_tiny_bert(out["mean"], seed=1, with_cls=False)
    return out


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 72, (B, T)).astype(np.int32)
    toks[np.arange(T)[None, :] >= LENS[:, None]] = 0
    return toks


def _load_both(path, jdt=jnp.float32, tdt=torch.float32):
    jcfg, jp = j_load(path, dtype=jdt)
    tcfg, tp = load_bert(path, dtype=tdt, device="cpu")
    return jcfg, jp, tcfg, tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("kind", ["rank", "mean"])
def test_load_bert_equals_jax(paths, kind):
    jcfg, jp, tcfg, tp = _load_both(paths[kind])
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.pooling == kind and tcfg.causal is False
    assert tcfg.arch in BERT_ARCHS
    jroot = {k: v for k, v in jp.items() if v is not None and k != "layers"}
    troot = {k: v for k, v in tp.items() if k != "layers"}
    assert sorted(troot) == sorted(jroot)
    assert sorted(tp["layers"]) == sorted(jp["layers"])
    for k, v in jroot.items():
        np.testing.assert_array_equal(troot[k].numpy(), np.asarray(v))
    for k, v in jp["layers"].items():
        np.testing.assert_array_equal(tp["layers"][k].numpy(), np.asarray(v))


@pytest.mark.parametrize("pooling", POOLINGS)
@pytest.mark.parametrize("kind", ["rank", "mean"])
def test_bert_forward_f32_matches_jax(paths, tokens, kind, pooling):
    jcfg, jp, tcfg, tp = _load_both(paths[kind])
    want = _np(j_forward(jp, jcfg, jnp.asarray(tokens), jnp.asarray(LENS),
                         pooling=pooling))
    got = _np(bert_forward(tp, tcfg, torch.from_numpy(tokens),
                           torch.from_numpy(LENS), pooling=pooling))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL_F32, atol=ATOL_F32)


@pytest.mark.parametrize("pooling", POOLINGS)
def test_bert_forward_bf16_matches_jax(paths, tokens, pooling):
    jcfg, jp, tcfg, tp = _load_both(paths["rank"], jnp.bfloat16,
                                    torch.bfloat16)
    want = _np(j_forward(jp, jcfg, jnp.asarray(tokens), jnp.asarray(LENS),
                         pooling=pooling))
    got = bert_forward(tp, tcfg, torch.from_numpy(tokens),
                       torch.from_numpy(LENS), pooling=pooling)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=ATOL_BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_gives_the_same_forward(paths, tokens, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg, jp, tcfg, tp = _load_both(paths["rank"], jdt, tdt)
    carried = bert_params_from_numpy(jax.tree.map(np.asarray, jp), jcfg)
    for pooling in ("mean", "rank"):
        a = bert_forward(carried, tcfg, tokens, LENS, pooling=pooling)
        b = bert_forward(tp, tcfg, tokens, LENS, pooling=pooling)
        assert a.dtype == tdt
        assert torch.equal(a, b)


@pytest.mark.parametrize("pooling", ["mean", "cls", "last", "rank"])
def test_padding_does_not_change_the_output(paths, tokens, pooling):
    _, _, tcfg, tp = _load_both(paths["rank"])
    short = bert_forward(tp, tcfg, tokens, LENS, pooling=pooling)
    wide = np.zeros((B, 2 * T), np.int32)
    wide[:, :T] = tokens
    long = bert_forward(tp, tcfg, wide, LENS, pooling=pooling)
    np.testing.assert_allclose(long.numpy(), short.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_check_bert_supported(paths):
    _, _, tcfg, tp = _load_both(paths["mean"])
    check_bert_supported(tcfg, tp)
    bad = dict(tp, layers={k: v for k, v in tp["layers"].items()
                           if k != "wq"})
    with pytest.raises(NotImplementedError, match="wq"):
        check_bert_supported(tcfg, bad)


# -- the engine ----------------------------------------------------------------


def _pair(tok, q, d):
    return ([tok.cls_id] + tok.encode(q, add_special=False) + [tok.sep_id]
            + tok.encode(d, add_special=False) + [tok.sep_id])


DOCS = ["the quick brown fox", "a slow dog", "cat runs fast",
        "the dog is good", "quick quick fox runs", "bad cat"]
INPUTS = ["the quick brown fox runs fast", "a", "dog", "good cat is slow",
          "the the the quick", "brown"]


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


@pytest.fixture(scope="module")
def engine_runs(paths):
    """Rerank scores (normalized and not) and normalized embeddings of both
    engines on the rank file, max_embed_batch 4 (two groups)."""
    path = paths["rank"]
    jcfg, jp = j_load(path)
    with JGGUFFile(path) as g:
        jtok = JTokenizer.from_gguf(g)
    tcfg, tp = load_bert(path, device="cpu")
    with GGUFFile(path) as g:
        ttok = Tokenizer.from_gguf(g)
    out = {}
    for name, eng, tok, Emb, Rer in (
            ("jax", JEngine(jcfg, jp, jtok, JEngineConfig(
                n_slots=1, n_ctx=256, max_embed_batch=4)), jtok, JEmbTask,
             JRerankTask),
            ("port", Engine(tcfg, tp, ttok, EngineConfig(
                n_slots=1, n_ctx=256, max_embed_batch=4), device="cpu"),
             ttok, EmbeddingsTask, RerankTask)):
        pairs = [_pair(tok, "quick fox", d) for d in DOCS]
        anchors = [_pair(tok, "quick fox", "quick fox"),
                   _pair(tok, "quick fox", "unknown")]
        tasks = [Rer(pairs + anchors, n_documents=len(DOCS), normalize=True),
                 Rer(pairs, n_documents=len(DOCS), normalize=False),
                 Emb([tok.encode(x, add_special=False) for x in INPUTS])]
        res = _run(eng, tasks)
        out[name] = dict(scores=res[0].scores, raw=res[1].scores,
                         emb=np.asarray(res[2].embeddings))
    return out


def test_engine_rerank_scores_equal_jax(engine_runs):
    j, t = engine_runs["jax"], engine_runs["port"]
    np.testing.assert_allclose(t["raw"], j["raw"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t["scores"], j["scores"], rtol=1e-4,
                               atol=1e-4)
    assert all(0.0 <= s <= 1.0 for s in t["scores"])
    assert np.argsort(t["raw"]).tolist() == np.argsort(j["raw"]).tolist()


def test_engine_embeddings_equal_jax_in_input_order(engine_runs, paths):
    j, t = engine_runs["jax"], engine_runs["port"]
    assert t["emb"].shape == (len(INPUTS), E)
    np.testing.assert_allclose(np.linalg.norm(t["emb"], axis=1), 1.0,
                               rtol=1e-6)
    np.testing.assert_allclose(t["emb"], j["emb"], rtol=1e-4, atol=1e-5)
    # each row is its own input's, alone through the encoder (mean: the
    # rank file's /v1/embeddings pooling)
    tcfg, tp = load_bert(paths["rank"], device="cpu")
    with GGUFFile(paths["rank"]) as g:
        tok = Tokenizer.from_gguf(g)
    for i, x in enumerate(INPUTS):
        ids = tok.encode(x, add_special=False)
        v = bert_forward(tp, tcfg, [ids], [len(ids)], pooling="mean")[0]
        v = v.double().numpy()
        np.testing.assert_allclose(t["emb"][i], v / np.linalg.norm(v),
                                   rtol=1e-4, atol=1e-5)


def test_bert_engine_refuses_completions_and_drafts(paths):
    tcfg, tp = load_bert(paths["mean"], device="cpu")
    with GGUFFile(paths["mean"]) as g:
        tok = Tokenizer.from_gguf(g)
    with pytest.raises(ValueError, match="BERT"):
        Engine(tcfg, tp, tok, EngineConfig(n_slots=1, n_ctx=64),
               device="cpu", draft=(tcfg, tp))
    eng = Engine(tcfg, tp, tok, EngineConfig(n_slots=1, n_ctx=64),
                 device="cpu")
    assert eng.kv is None
    eng.start()
    try:
        task = CompletionsTask([2, 30, 3], SamplerParams(temp=0.0),
                               tokenizer=tok, max_tokens=2)
        eng.submit(task)
        kind, payload = task.result_q.get(timeout=60)
        assert kind == "error" and "BERT" in str(payload)
    finally:
        eng.stop()
