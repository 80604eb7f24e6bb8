"""Port parity of the serving engine (llama_box_tpu_torch/server/engine.py)
against the JAX package's Engine on the tiny fixture GGUF, f32 weights and
KV cache.

Three concurrent greedy requests through a K=16 decode chain give the
same tokens in both packages. The JAX engine runs its flash kernels in
interpret mode (LLAMA_BOX_TPU_FORCE_FLASH=1), the port its kernels' plain
versions. Before the tokens are compared, every step's top-2 logit margin
is checked to exceed 1e-3, so a near tie shows up as a tie and not as a
port fault. So do the tokens of a request that runs past its slot's
capacity through several context shifts. The port's own K=1 and K=16
greedy outputs are identical."""

import math
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
from llama_box_tpu_torch.server.engine import (Engine, EngineConfig,
                                               resolve_device)
from llama_box_tpu_torch.server.task import CompletionsTask
from llama_box_tpu_torch.tokenizer import Tokenizer
from .fixtures.make_tiny_model import write_tiny_model

PROMPTS = ("the quick brown fox", "a b c d e f g h i j k l",
           "hello world, this is a longer prompt for the third slot")
MAX_TOKENS = 24
MARGIN = 1e-3
# a fixture seed whose greedy steps for PROMPTS all clear MARGIN (the tiny
# model's logits are flat, and other seeds have near ties)
SEED = 2


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny.gguf")
    write_tiny_model(path, seed=SEED)
    return path


def _collect(tasks, timeout=180):
    out = []
    for t in tasks:
        while True:
            kind, payload = t.result_q.get(timeout=timeout)
            if kind == "final":
                out.append(payload)
                break
            if kind == "error":
                raise payload
    return out


def _ecfg(cls, chain):
    return cls(n_slots=3, n_ctx=3 * 96, n_ubatch=16, kv_dtype="float32",
               decode_chain=chain)


def run_port(path, chain, n_probs=0):
    cfg, params = load_model(path, dtype=torch.float32, device="cpu")
    with GGUFFile(path) as g:
        tok = Tokenizer.from_gguf(g)
    eng = Engine(cfg, params, tok, _ecfg(EngineConfig, chain), device="cpu")
    eng.start()
    try:
        tasks = [CompletionsTask(tok.encode(p), SamplerParams(temp=0.0),
                                 tokenizer=tok, max_tokens=MAX_TOKENS,
                                 n_probs=n_probs) for p in PROMPTS]
        for t in tasks:
            eng.submit(t)
        return _collect(tasks)
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def jax_tokens(model_path):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLAMA_BOX_TPU_FORCE_FLASH", "1")
        cfg, params = jax_load(model_path, dtype=jnp.float32)
        with JGGUFFile(model_path) as g:
            tok = JTokenizer.from_gguf(g)
        eng = JEngine(cfg, params, tok, _ecfg(JEngineConfig, 16))
        eng.start()
        try:
            tasks = [JTask(tok.encode(p), JSamplerParams(temp=0.0),
                           tokenizer=tok, max_tokens=MAX_TOKENS)
                     for p in PROMPTS]
            for t in tasks:
                eng.submit(t)
            return [t.generated for t in _collect(tasks)]
        finally:
            eng.stop()


def test_greedy_tokens_match_jax_engine(model_path, jax_tokens):
    finals = run_port(model_path, 16, n_probs=2)
    for f in finals:
        assert len(f.probs) == len(f.generated) > 0
        for tp in f.probs:
            p0, p1 = tp.top_probs[:2]
            assert tp.top_ids[0] == tp.token
            assert math.log(p0) - math.log(p1) > MARGIN, "a near tie"
    assert [f.generated for f in finals] == jax_tokens


def test_chain_lengths_give_identical_greedy_output(model_path):
    one = run_port(model_path, 1)
    chained = run_port(model_path, 16)
    assert [f.generated for f in one] == [f.generated for f in chained]
    assert [f.text for f in one] == [f.text for f in chained]
    assert all(f.finish_reason in ("stop", "length") for f in chained)


def test_generation_past_capacity_shifts_like_jax(model_path):
    """A greedy request whose generation runs past its 32-position slot
    context-shifts (8 rows dropped each time) and ends with "length" at
    its 100-token budget; its tokens equal the JAX engine's, and every
    step clears the margin."""
    prompt = "the quick brown fox"
    ecfg = dict(n_slots=1, n_ctx=32, n_ubatch=16, kv_dtype="float32",
                decode_chain=16)
    cfg, params = load_model(model_path, dtype=torch.float32, device="cpu")
    with GGUFFile(model_path) as g:
        tok = Tokenizer.from_gguf(g)
    eng = Engine(cfg, params, tok, EngineConfig(**ecfg), device="cpu")
    eng.start()
    try:
        t = CompletionsTask(tok.encode(prompt),
                            SamplerParams(temp=0.0, ignore_eos=True),
                            tokenizer=tok, max_tokens=100, n_probs=2)
        eng.submit(t)
        (f,) = _collect([t])
    finally:
        eng.stop()
    assert f.finish_reason == "length" and len(f.generated) == 100
    assert f.n_shifted >= 2
    for tp in f.probs:
        p0, p1 = tp.top_probs[:2]
        assert math.log(p0) - math.log(p1) > MARGIN, "a near tie"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLAMA_BOX_TPU_FORCE_FLASH", "1")
        jcfg, jparams = jax_load(model_path, dtype=jnp.float32)
        with JGGUFFile(model_path) as g:
            jtok = JTokenizer.from_gguf(g)
        jeng = JEngine(jcfg, jparams, jtok, JEngineConfig(**ecfg))
        jeng.start()
        try:
            jt = JTask(jtok.encode(prompt),
                       JSamplerParams(temp=0.0, ignore_eos=True),
                       tokenizer=jtok, max_tokens=100)
            jeng.submit(jt)
            (jf,) = _collect([jt])
        finally:
            jeng.stop()
    assert f.generated == jf.generated
    assert (f.finish_reason, f.n_shifted) == (jf.finish_reason, jf.n_shifted)


def test_engine_without_cuda_raises(monkeypatch):
    """Without a card and without an explicit CPU request the engine's
    device resolution raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_kv_cache_types_serve(model_path, kv):
    """bf16 and q8_0 caches serve greedy requests; K=1 and K=16 agree."""
    cfg, params = load_model(model_path, dtype=torch.float32, device="cpu")
    with GGUFFile(model_path) as g:
        tok = Tokenizer.from_gguf(g)
    outs = []
    for chain in (1, 16):
        eng = Engine(cfg, params, tok,
                     EngineConfig(n_slots=2, n_ctx=192, n_ubatch=16,
                                  kv_dtype=kv, decode_chain=chain),
                     device="cpu")
        eng.start()
        try:
            tasks = [CompletionsTask(tok.encode(p), SamplerParams(temp=0.0),
                                     tokenizer=tok, max_tokens=16)
                     for p in PROMPTS[:2]]
            for t in tasks:
                eng.submit(t)
            outs.append([f.generated for f in _collect(tasks)])
        finally:
            eng.stop()
    assert outs[0] == outs[1]
    assert all(len(g) > 0 for g in outs[0])
    assert np.isfinite(np.asarray(eng.kv.k_scale.float() if kv == "int8"
                                  else eng.kv.k.float())).all()


# -- engine behaviour on the port's own (the JAX engine tests' cases) --------


@pytest.fixture(scope="module")
def engine(model_path):
    cfg, params = load_model(model_path, dtype=torch.float32, device="cpu")
    with GGUFFile(model_path) as g:
        tok = Tokenizer.from_gguf(g)
    eng = Engine(cfg, params, tok,
                 EngineConfig(n_slots=2, n_ctx=128, n_ubatch=16,
                              kv_dtype="float32", decode_chain=4),
                 device="cpu")
    eng.start()
    yield eng
    eng.stop()


def _run(engine, task, timeout=60):
    engine.submit(task)
    deltas = []
    while True:
        kind, payload = task.result_q.get(timeout=timeout)
        if kind == "delta":
            deltas.append(payload)
        elif kind == "final":
            return payload, deltas
        elif kind == "error":
            raise payload


def test_prompt_squeeze_block_erasure(engine):
    """Over-long prompts are squeezed by whole blocks of (max_len -
    n_keep) / 2 after n_keep, as in the JAX engine."""
    n_keep = 4
    max_len = engine.slot_ctx - engine.ecfg.defrag_headroom
    n = engine.slot_ctx + 20
    toks = [int(t) for t in np.random.default_rng(1).integers(3, 200, n)]
    task = CompletionsTask(toks, SamplerParams(temp=0.0),
                           tokenizer=engine.tokenizer, max_tokens=2,
                           stream=False, n_keep=n_keep)
    final, _ = _run(engine, task)
    n_block = max(1, (max_len - n_keep) // 2)
    n_erased = max(1, (n - n_keep - n_block) // n_block)
    drop = max(n_erased * n_block, n - max_len)
    assert final.truncated and len(final.generated) == 2
    assert final.prompt_tokens == toks[:n_keep] + toks[n_keep + drop:]


def test_stop_word_and_n_probs(engine):
    toks = engine.tokenizer.encode("a b")
    task = CompletionsTask(toks, SamplerParams(temp=1.0, seed=5),
                           tokenizer=engine.tokenizer, max_tokens=48,
                           stream=True, stop_words=[" "])
    final, deltas = _run(engine, task)
    assert " " not in final.text
    assert "".join(d["text"] for d in deltas) == final.text
    task = CompletionsTask(engine.tokenizer.encode("a b c"),
                           SamplerParams(temp=0.0, n_probs=3),
                           tokenizer=engine.tokenizer, max_tokens=3,
                           stream=False, n_probs=3)
    final, _ = _run(engine, task)
    assert len(final.probs) == 3
    for tp in final.probs:
        assert len(tp.top_ids) == 3 and tp.top_ids[0] == tp.token


def test_cancelled_task_releases_slot(engine):
    task = CompletionsTask(engine.tokenizer.encode("a b c"),
                           SamplerParams(temp=0.0),
                           tokenizer=engine.tokenizer, max_tokens=100,
                           stream=True)
    engine.submit(task)
    task.result_q.get(timeout=60)          # the first delta
    task.cancelled = True
    for _ in range(200):
        if all(s.state == "idle" for s in engine.slots):
            break
        time.sleep(0.05)
    assert all(s.state == "idle" for s in engine.slots)


def test_chain_k_budget_shrink():
    """_chain_k: K caps at the pow2 bucket of the largest remaining budget;
    a 1-3 token leftover runs a 4-chain; a ramping slot caps K."""
    class _Task:
        def __init__(self, mt, gen):
            self.max_tokens = mt
            self.generated = [0] * gen

    class _Slot:
        def __init__(self, mt, gen, ramp=0):
            self.task = _Task(mt, gen)
            self.chain_ramp = ramp

    eng = Engine.__new__(Engine)
    eng.ecfg = EngineConfig(decode_chain=16)
    k = Engine._chain_k
    assert k(eng, [_Slot(1000, 0)]) == 16
    assert k(eng, [_Slot(100, 88)]) == 8
    assert k(eng, [_Slot(100, 95)]) == 4
    assert k(eng, [_Slot(100, 99)]) == 4
    assert k(eng, [_Slot(0, 50)]) == 16
    assert k(eng, [_Slot(100, 95), _Slot(1000, 0)]) == 16
    assert k(eng, [_Slot(1000, 0, ramp=4)]) == 4
