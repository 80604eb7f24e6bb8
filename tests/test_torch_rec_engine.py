"""The port engine's recurrent branch against the JAX engine on the CPU
(f32 weights and state): greedy texts of mamba, mamba2, rwkv6, rwkv7, lfm2
(a hybrid of short-conv and attention layers, a token a pass: its layer
groups never chain) and jamba equal the JAX engine's at chain K = 1 and K
= 16, on prompts whose greedy steps clear a top-2 log-prob margin of 1e-3
(checked); and the JAX engine's recurrent rules, each mirrored from
tests/test_mamba.py: chain equals unchained, exact-extension prefix reuse
(and a cold recompute otherwise), a dirty state after a chain's discarded
tail, concurrent slots, the length cap at the slot boundary, speculation
refused, jamba's multi-turn reuse. Port-only: with pipelined chains (the
port's default) a request that ends while chains are in flight leaves its
slot dirty and the next turn prefills cold with JAX's text; an int8 cache
type gives a hybrid a bf16 KV; embeddings are refused; the loader takes
a file with ssm_in."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.gguf import GGUFFile as JGGUFFile
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.sampling import SamplerParams as JSamplerParams
from llama_box_tpu.server import Engine as JEngine
from llama_box_tpu.server import EngineConfig as JEngineConfig
from llama_box_tpu.server.task import CompletionsTask as JTask
from llama_box_tpu.tokenizer import Tokenizer as JTokenizer
from llama_box_tpu_torch.gguf import GGUFFile
from llama_box_tpu_torch.models.loader import load_model
from llama_box_tpu_torch.sampling import SamplerParams
from llama_box_tpu_torch.server.engine import Engine, EngineConfig
from llama_box_tpu_torch.server.task import CompletionsTask, EmbeddingsTask
from llama_box_tpu_torch.tokenizer import Tokenizer

from .fixtures.make_tiny_mamba import (write_tiny_jamba, write_tiny_mamba,
                                       write_tiny_mamba2)
from .fixtures.make_tiny_model import build_vocab
from .fixtures.make_tiny_rwkv import write_tiny_rwkv6, write_tiny_rwkv7
from .test_mamba import lfm2_setup  # noqa: F401
from .test_torch_families_engine import MARGIN, _collect
from .test_torch_rec_hybrid import port_of

N_GEN = 8
PROMPTS = ([1, 106, 88, 120, 137, 202, 249], [1, 23, 261, 150, 102])
# prompts whose greedy steps clear the margin on each random model (their
# logits are flat: most prompts meet a near tie)
FAMILY_PROMPTS = {
    "mamba": ([1, 183, 148, 79, 90, 14, 24], [1, 52, 233, 187, 262]),
    "mamba2": ([1, 175, 278, 210, 182, 157], [1, 268, 81, 234, 193, 3]),
    "rwkv6": ([1, 246, 160, 12, 220, 210], [1, 52, 28, 248, 9, 156, 25]),
    "rwkv7": ([1, 139, 123, 117, 11], [1, 38, 5, 193, 152]),
    "jamba": ([1, 76, 177, 219, 111, 133], [1, 231, 281, 110, 197, 272,
                                            187]),
}
WRITERS = {"mamba": write_tiny_mamba, "mamba2": write_tiny_mamba2,
           "rwkv6": write_tiny_rwkv6, "rwkv7": write_tiny_rwkv7,
           "jamba": write_tiny_jamba}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("rec_engine")
    out = {}
    for name, write in WRITERS.items():
        out[name] = str(d / f"{name}.gguf")
        write(out[name])
    # the tokenizer of tests/test_mamba.py's lfm2 file, for its model
    # carried over from the JAX tree
    out["vocab"] = str(d / "vocab.gguf")
    _write_vocab(out["vocab"])
    return out


def _write_vocab(path):
    from llama_box_tpu.gguf import GGUFWriter
    vocab, _, _ = build_vocab()
    w = GGUFWriter(path, architecture="lfm2")
    w.add_kv("tokenizer.ggml.model", "llama")
    w.add_kv("tokenizer.ggml.tokens", vocab)
    w.add_kv("tokenizer.ggml.scores", np.zeros(len(vocab), np.float32))
    w.add_kv("tokenizer.ggml.token_type", np.ones(len(vocab), np.int32))
    w.add_kv("tokenizer.ggml.bos_token_id", 1)
    w.add_kv("tokenizer.ggml.eos_token_id", 2)
    w.write()


def _port(path):
    cfg, params = load_model(path, dtype=torch.float32, device="cpu")
    with GGUFFile(path) as g:
        tok = Tokenizer.from_gguf(g)
    return cfg, params, tok


def _ecfg(cls, **kw):
    base = dict(n_slots=2, n_ctx=256, n_ubatch=16, kv_dtype="float32")
    base.update(kw)
    return cls(**base)


def _port_run(model, prompts, max_tokens=N_GEN, **kw):
    cfg, params, tok = model
    eng = _engine(model, **kw)
    try:
        tasks = [CompletionsTask(list(p), SamplerParams(temp=0.0),
                                 tokenizer=tok, max_tokens=max_tokens,
                                 n_probs=2) for p in prompts]
        for t in tasks:
            eng.submit(t)
        return _collect(tasks)
    finally:
        eng.stop()


def _jax_run(jmodel, prompts, max_tokens=N_GEN, **kw):
    cfg, params, tok = jmodel
    eng = JEngine(cfg, params, tok, _ecfg(JEngineConfig, decode_chain=4,
                                          **kw))
    eng.start()
    try:
        tasks = [JTask(list(p), JSamplerParams(temp=0.0), tokenizer=tok,
                       max_tokens=max_tokens) for p in prompts]
        for t in tasks:
            eng.submit(t)
        return [t.generated for t in _collect(tasks)]
    finally:
        eng.stop()


def _jax_model(path):
    cfg, params = jax_load(path, dtype=jnp.float32)
    with JGGUFFile(path) as g:
        return cfg, params, JTokenizer.from_gguf(g)


def _no_near_ties(finals):
    for f in finals:
        for tp in f.probs:
            p0, p1 = tp.top_probs[:2]
            assert math.log(p0) - math.log(max(p1, 1e-30)) > MARGIN, \
                "a near tie"


@pytest.mark.parametrize("name", list(WRITERS))
def test_engine_greedy_matches_jax(files, name):
    prompts = FAMILY_PROMPTS[name]
    want = _jax_run(_jax_model(files[name]), prompts)
    model = _port(files[name])
    for chain in (1, 16):
        finals = _port_run(model, prompts, decode_chain=chain)
        _no_near_ties(finals)
        assert [f.generated for f in finals] == want, chain


def test_hybrid_lfm2_engine_greedy_matches_jax(files, lfm2_setup):  # noqa: F811
    _, jcfg, jp, jtok = lfm2_setup
    want = _jax_run((jcfg, jp, jtok), PROMPTS)
    cfg, params = port_of(jcfg, jp)
    with GGUFFile(files["vocab"]) as g:
        tok = Tokenizer.from_gguf(g)
    assert sorted(tok.eog_ids) == sorted(jtok.eog_ids)
    for chain in (1, 16):
        finals = _port_run((cfg, params, tok), PROMPTS, decode_chain=chain)
        _no_near_ties(finals)
        assert [f.generated for f in finals] == want, chain


def _one(eng, prompt, max_tokens):
    tok = eng.tokenizer
    return _collect([_submit(eng, CompletionsTask(
        list(prompt), SamplerParams(temp=0.0), tokenizer=tok,
        max_tokens=max_tokens))])[0]


def _submit(eng, task):
    eng.submit(task)
    return task


def _engine(model, **kw):
    cfg, params, tok = model
    eng = Engine(cfg, params, tok, _ecfg(EngineConfig, **kw), device="cpu")
    eng.start()
    return eng


def test_chain_equals_unchained(files):
    model = _port(files["mamba"])
    outs = [_port_run(model, PROMPTS[:1], max_tokens=11,
                      decode_chain=k)[0].generated for k in (1, 5)]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("name", ["mamba", "jamba"])
def test_prefix_reuse_exact_extension(files, name):
    """A follow-up extending the whole history reuses the state (jamba:
    the mamba states and the attention KV); any other overlap recomputes;
    both give a cold engine's tokens, and JAX's."""
    model = _port(files[name])
    eng = _engine(model, n_slots=1, decode_chain=1)
    try:
        p1 = PROMPTS[0]
        f1 = _one(eng, p1, 4)
        p2 = p1 + f1.generated + [40, 41]
        f2 = _one(eng, p2, 4)
        assert f2.n_cached == len(p1) + len(f1.generated) - 1
        p3 = p1 + [77, 78, 79]
        f3 = _one(eng, p3, 4)
        assert f3.n_cached == 0
    finally:
        eng.stop()
    jmodel = _jax_model(files[name])
    for prompt, got in ((p2, f2.generated), (p3, f3.generated)):
        cold = _port_run(model, [prompt], max_tokens=4, n_slots=1)[0]
        assert cold.generated == got
        assert _jax_run(jmodel, [prompt], max_tokens=4, n_slots=1)[0] == got


@pytest.mark.parametrize("pipeline", [False, True])
def test_dirty_state_after_chain_tail(files, pipeline):
    """A request that ends mid-chain (and, pipelined, with further chains
    in flight) leaves its slot's state ahead of its tokens: dirty, never
    reused; the next turn prefills cold and gives JAX's tokens."""
    model = _port(files["mamba"])
    eng = _engine(model, n_slots=1, decode_chain=8,
                  pipeline_chain=pipeline)
    try:
        p1 = PROMPTS[1]
        f1 = _one(eng, p1, 3)
        assert eng.slots[0].rec_dirty
        p2 = p1 + f1.generated + [60]
        f2 = _one(eng, p2, 3)
        assert f2.n_cached == 0
    finally:
        eng.stop()
    assert _jax_run(_jax_model(files["mamba"]), [p2], max_tokens=3,
                    n_slots=1)[0] == f2.generated


def test_pipelined_stop_mid_chain_marks_dirty(files):
    """A request that ends on a stop word while pipelined chains are in
    flight (the port pipelines chains on recurrent models; JAX does not):
    the device runs the rest of the chain and the chains behind it, so the
    slot is dirty and the next turn prefills cold, with JAX's tokens."""
    model = _port(files["mamba"])
    prompt = FAMILY_PROMPTS["mamba"][0]
    eng = _engine(model, n_slots=1, decode_chain=4, chain_ramp=0)
    try:
        g = _one(eng, prompt, 16).generated
        stop = model[2].decode([g[3]])
        assert stop.strip()
        f = _collect([_submit(eng, CompletionsTask(
            list(prompt), SamplerParams(temp=0.0), tokenizer=model[2],
            max_tokens=16, stop_words=[stop]))])[0]
        assert f.finish_reason == "stop" and len(f.generated) <= 4
        assert eng.slots[0].rec_dirty
        p2 = prompt + f.generated + [50]
        f2 = _one(eng, p2, 4)
        assert f2.n_cached == 0
    finally:
        eng.stop()
    assert _jax_run(_jax_model(files["mamba"]), [p2], max_tokens=4,
                    n_slots=1)[0] == f2.generated


def test_multislot_concurrent_greedy(files):
    model = _port(files["mamba2"])
    cold = [_port_run(model, [p], n_slots=1)[0].generated for p in PROMPTS]
    assert [f.generated for f in _port_run(model, PROMPTS)] == cold


def test_length_cap_at_slot_boundary(files):
    """No context shift: the request ends with "length" at the slot
    boundary (max_tokens capped at admission, as in JAX)."""
    model = _port(files["mamba"])
    eng = _engine(model, n_slots=1, n_ctx=32, decode_chain=4)
    try:
        f = _one(eng, PROMPTS[0], 500)
        assert f.finish_reason in ("length", "stop")
        assert len(PROMPTS[0]) + len(f.generated) <= 32
    finally:
        eng.stop()


def test_spec_decode_rejected(files):
    cfg, params, tok = _port(files["mamba"])
    with pytest.raises(ValueError, match="speculative"):
        Engine(cfg, params, tok, _ecfg(EngineConfig, n_slots=1),
               device="cpu", draft=(cfg, params))
    eng = Engine(cfg, params, tok, _ecfg(EngineConfig, lookup_ngram_min=2),
                 device="cpu")
    assert eng.ecfg.lookup_ngram_min == 0


def test_jamba_multiturn_reuse(files):
    model = _port(files["jamba"])
    eng = _engine(model, n_slots=1, n_ctx=128, decode_chain=1)
    try:
        p1 = PROMPTS[1]
        f1 = _one(eng, p1, 4)
        p2 = p1 + f1.generated + [90, 91]
        f2 = _one(eng, p2, 4)
        assert f2.n_cached == len(p1) + len(f1.generated) - 1
    finally:
        eng.stop()
    cold = _port_run(model, [p2], max_tokens=4, n_slots=1, n_ctx=128)[0]
    assert cold.generated == f2.generated


def test_int8_cache_type_gives_a_hybrid_bf16_kv(files):
    cfg, params, tok = _port(files["jamba"])
    eng = Engine(cfg, params, tok, _ecfg(EngineConfig, kv_dtype="int8"),
                 device="cpu")
    assert eng.kv.k.dtype == torch.bfloat16
    assert eng.kv.ssm.dtype == torch.float32


def test_embeddings_refused(files):
    model = _port(files["mamba"])
    eng = _engine(model)
    try:
        task = EmbeddingsTask([[1, 2, 3]])
        eng.submit(task)
        kind, payload = task.result_q.get(timeout=60)
        assert kind == "error" and "not supported" in str(payload)
    finally:
        eng.stop()


def test_loader_takes_ssm_in(files):
    """A file with the recurrent mixer's tensors loads (the port refused
    it by its cause before the recurrent families were ported)."""
    cfg, params, _ = _port(files["jamba"])
    assert cfg.recurrent
    assert any("ssm_in" in g for g in params["layer_groups"])
    assert np.isfinite(params["layer_groups"][0]["ssm_in"].numpy()).all()


def test_cli_serves_a_recurrent_file_without_embeddings(files):
    """The CLI builds a server over a recurrent file whose capabilities
    say no embeddings (JAX `cli.py`: `"embedding": not cfg.recurrent`),
    so /props and /v1/models report none and the route is off."""
    from llama_box_tpu_torch import cli
    engine, srv = cli.build_server(
        ["-m", files["mamba"], "--device", "cpu", "--port", "0",
         "--no-jinja", "-np", "2", "-c", "256", "--weights-dtype", "f32"])
    try:
        routes = srv.RequestHandlerClass.routes
        assert engine.rec and routes.caps["embedding"] is False
        assert routes.caps["completion"] is True
    finally:
        srv.server_close()
        engine.stop()
