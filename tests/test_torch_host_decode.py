"""Host-controlled decode in the port's engine (llama_box_tpu_torch/
server/engine.py: the one-token pass, host-sampled first tokens after a
prefill, rate buckets) against the JAX package's Engine on the tiny
fixture GGUF, f32 weights and KV cache, on the CPU.

Greedy grammar and JSON-schema requests, seeded mirostat and DRY requests
and a grammar-forced tool call give the JAX engine's tokens (and the same
tool_calls JSON and finish reason), served together with a plain greedy
request; the JAX engine runs its flash kernels in interpret mode
(LLAMA_BOX_TPU_FORCE_FLASH=1) as tests/test_torch_engine.py does. A
constrained request that runs past its slot's capacity shifts inside
one-token passes and still gives the JAX tokens. In the port alone: a
plain greedy request beside a host-sampled one gives its text served
alone (chained); pipelined, lockstep and --decode-chain 1 give the same
outputs; no chain is dispatched or speculated while a host-controlled slot
decodes; a host-sampled slot's device sampler state never advances; a
slot whose rate bucket is empty sits passes out, with its tokens
unchanged. Tokens are compared exactly; every wait has a timeout."""

import time

import jax.numpy as jnp
import pytest
import torch

from llama_box_tpu.gguf import GGUFFile as JGGUFFile
from llama_box_tpu.grammar import Grammar as JGrammar
from llama_box_tpu.grammar import json_schema_to_grammar as j_schema
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.sampling import SamplerParams as JSamplerParams
from llama_box_tpu.server import Engine as JEngine, EngineConfig as JEngineConfig
from llama_box_tpu.server.task import CompletionsTask as JTask
from llama_box_tpu.server.toolcall import ToolCallScanner as JScanner
from llama_box_tpu.tokenizer import Tokenizer as JTokenizer
from llama_box_tpu_torch.gguf import GGUFFile
from llama_box_tpu_torch.grammar import Grammar, json_schema_to_grammar
from llama_box_tpu_torch.models.loader import load_model
from llama_box_tpu_torch.sampling import SamplerParams
from llama_box_tpu_torch.server.engine import Engine, EngineConfig
from llama_box_tpu_torch.server.task import CompletionsTask
from llama_box_tpu_torch.server.toolcall import ToolCallScanner
from llama_box_tpu_torch.tokenizer import Tokenizer
from llama_box_tpu_torch.utils.tokenbucket import RatelimitTokenBucket
from .fixtures.make_tiny_model import write_tiny_model

TIMEOUT = 180
SEED = 2        # the fixture seed of tests/test_torch_engine.py
SCHEMA = {"type": "object",
          "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"},
                         "mode": {"enum": ["fast", "slow"]}},
          "required": ["ok", "n", "mode"]}
TOOL_GBNF = ('root ::= "<tool_call>{\\"name\\": \\"f\\", \\"arguments\\": '
             '{\\"x\\": " [1-9] [0-9]? "}}</tool_call>"')
PLAIN = ("the quick brown fox", {"temp": 0.0}, None, 24)
# name -> (prompt, SamplerParams kwargs, GBNF (or "schema"), max_tokens)
SPECS = {
    "gbnf": ("a b c d e f g h i j k l", {"temp": 0.0},
             'root ::= [a-e] ([ ] [a-e])* "."', 20),
    "schema": ("hello world, this is a longer prompt",
               {"temp": 0.0}, "schema", 48),
    "mirostat": ("the quick brown fox", {"temp": 0.8, "mirostat": 2,
                                         "seed": 7}, None, 16),
    "dry": ("a b c d e f g h i j k l", {"temp": 0.7, "seed": 3,
                                        "dry_multiplier": 0.8}, None, 16),
    "tool": ("call the tool", {"temp": 0.0, "dry_multiplier": 0.8},
             TOOL_GBNF, 64),
    "plain": PLAIN,
}
SHIFT = ("a b c", {"temp": 0.0}, 'root ::= [a-z] ([ ] [a-z])*', 70)


def _gbnf(g):
    return json_schema_to_grammar(SCHEMA) if g == "schema" else g


def _ecfg(cls, **kw):
    base = dict(n_slots=3, n_ctx=3 * 96, n_ubatch=16, kv_dtype="float32",
                decode_chain=16)
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny.gguf")
    write_tiny_model(path, seed=SEED)
    return path


@pytest.fixture(scope="module")
def port_model(model_path):
    cfg, params = load_model(model_path, dtype=torch.float32, device="cpu")
    with GGUFFile(model_path) as g:
        tok = Tokenizer.from_gguf(g)
    return cfg, params, tok


def _final(task, timeout=TIMEOUT):
    while True:
        kind, payload = task.result_q.get(timeout=timeout)
        if kind == "final":
            return payload
        if kind == "error":
            raise payload


def _summary(f):
    calls = [(c.name, c.arguments) for c in f.tool_calls]
    return f.generated, f.finish_reason, calls, f.n_shifted > 0


def _port_task(tok, spec, **kw):
    prompt, sp, g, n = spec
    sp = SamplerParams(grammar=Grammar(_gbnf(g)) if g else None, **sp)
    return CompletionsTask(tok.encode(prompt), sp, tokenizer=tok,
                           max_tokens=n, stream=False, **kw)


def _port_engine(port_model, **kw):
    cfg, params, tok = port_model
    eng = Engine(cfg, params, tok, _ecfg(EngineConfig, **kw), device="cpu")
    eng.start()
    return eng


def run_port(port_model, specs, **kw):
    tok = port_model[2]
    eng = _port_engine(port_model, **kw)
    try:
        tasks = [_port_task(tok, s, toolscan=ToolCallScanner("chatml"))
                 for s in specs]
        for t in tasks:
            eng.submit(t)
        return [_summary(_final(t)) for t in tasks]
    finally:
        eng.stop()


def run_jax(model_path, specs, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LLAMA_BOX_TPU_FORCE_FLASH", "1")
        cfg, params = jax_load(model_path, dtype=jnp.float32)
        with JGGUFFile(model_path) as g:
            tok = JTokenizer.from_gguf(g)
        eng = JEngine(cfg, params, tok, _ecfg(JEngineConfig, **kw))
        eng.start()
        try:
            tasks = []
            for prompt, sp, g, n in specs:
                gbnf = j_schema(SCHEMA) if g == "schema" else g
                tasks.append(JTask(
                    tok.encode(prompt),
                    JSamplerParams(grammar=JGrammar(gbnf) if gbnf else None,
                                   **sp),
                    tokenizer=tok, max_tokens=n, stream=False,
                    toolscan=JScanner("chatml")))
            for t in tasks:
                eng.submit(t)
            return [_summary(_final(t)) for t in tasks]
        finally:
            eng.stop()


@pytest.fixture(scope="module")
def jax_out(model_path):
    return dict(zip(SPECS, run_jax(model_path, list(SPECS.values()))))


@pytest.fixture(scope="module")
def port_out(port_model):
    return dict(zip(SPECS, run_port(port_model, list(SPECS.values()))))


@pytest.mark.parametrize("name", list(SPECS))
def test_tokens_match_jax_engine(name, port_out, jax_out):
    got = port_out[name]
    assert got == jax_out[name]
    assert got[0], "no token generated"


def test_constrained_outputs_hold_their_constraints(port_out, port_model):
    import json
    tok = port_model[2]
    text = tok.decode(port_out["schema"][0])
    obj = json.loads(text)
    assert set(obj) == set(SCHEMA["required"]) and \
        port_out["schema"][1] == "stop"
    assert Grammar(SPECS["gbnf"][2], native=False).copy().accept_bytes(
        tok.decode(port_out["gbnf"][0]).encode())
    gen, finish, calls, _ = port_out["tool"]
    assert finish == "tool_calls" and len(calls) == 1
    assert calls[0][0] == "f" and "x" in json.loads(calls[0][1])


def test_context_shift_in_one_token_passes_matches_jax(model_path,
                                                        port_model):
    """A constrained greedy request past its slot's capacity (48) shifts
    inside one-token passes and gives the JAX tokens."""
    kw = dict(n_slots=1, n_ctx=48)
    got = run_port(port_model, [SHIFT], **kw)
    assert got[0][3], "no context shift happened"
    assert len(got[0][0]) == SHIFT[3]
    assert got == run_jax(model_path, [SHIFT], **kw)


def _spy_chains(eng):
    """Record each chain dispatch and whether a host-controlled slot was
    decoding then."""
    seen = []
    dispatch = eng._dispatch_chain

    def spy(dec, K, pos, token0=None):
        seen.append(any(s.state == "decode" and s.task is not None and (
            getattr(s.task, "host_sampler", None) is not None
            or s.task.rate_bucket is not None) for s in eng.slots))
        return dispatch(dec, K, pos, token0)
    eng._dispatch_chain = spy
    return seen


def test_plain_slot_beside_a_host_slot_equals_itself_alone(port_model):
    """Greedy output is the same with or without chaining: the plain
    request decodes chained alone, and in one-token passes beside a
    grammar request; no chain goes out while the host slot decodes."""
    alone = run_port(port_model, [PLAIN])[0]
    tok = port_model[2]
    eng = _port_engine(port_model)
    seen = _spy_chains(eng)
    try:
        tasks = [_port_task(tok, SPECS["gbnf"]), _port_task(tok, PLAIN)]
        for t in tasks:
            eng.submit(t)
        beside = [_summary(_final(t)) for t in tasks]
    finally:
        eng.stop()
    assert beside[1] == alone
    assert not any(seen), "a chain went out while a host slot decoded"


@pytest.mark.parametrize("mode", ["lockstep", "chain1"])
def test_pipelined_lockstep_and_chain1_identical(port_model, port_out, mode):
    kw = {"lockstep": dict(pipeline_chain=False),
          "chain1": dict(decode_chain=1)}[mode]
    got = dict(zip(SPECS, run_port(port_model, list(SPECS.values()), **kw)))
    assert got == port_out


def test_host_slot_leaves_the_device_sampler_state_still(port_model):
    """A host-sampled request's slot keeps the state its admission seeded
    (step 0, the prompt's penalty window); the next plain request on that
    slot gives the tokens it gives on a fresh engine."""
    tok = port_model[2]
    fresh = run_port(port_model, [PLAIN], n_slots=1)[0]
    eng = _port_engine(port_model, n_slots=1)
    try:
        t = _port_task(tok, SPECS["mirostat"])
        eng.submit(t)
        _final(t)
        n_prompt = len(tok.encode(SPECS["mirostat"][0]))
        assert int(eng.sstate.step[0]) == 0
        assert int(eng.sstate.ring_len[0]) == n_prompt
        assert int(eng.sstate.counts[0].sum()) == n_prompt
        t2 = _port_task(tok, PLAIN)
        eng.submit(t2)
        assert _summary(_final(t2)) == fresh
    finally:
        eng.stop()


def test_an_empty_rate_bucket_sits_out_passes(port_model):
    """A rate-limited greedy request beside a plain one: its bucket (1
    token, 5 a second) runs empty, so it sits out passes the plain
    request decodes in; its tokens equal those it gives unlimited, and it
    takes at least the time its rate allows."""
    tok = port_model[2]
    spec = ("a b c d e f g h i j k l", {"temp": 0.0}, None, 8)
    unlimited = run_port(port_model, [spec])[0]
    eng = _port_engine(port_model)
    seen = _spy_chains(eng)
    bucket = RatelimitTokenBucket(capacity=1, rate=5.0)
    refused = {"n": 0}
    acquire = bucket.try_acquire

    def counting(n=1):
        ok = acquire(n)
        refused["n"] += not ok
        return ok
    bucket.try_acquire = counting
    try:
        t = _port_task(tok, spec, rate_bucket=bucket)
        p = _port_task(tok, PLAIN)
        t0 = time.monotonic()
        eng.submit(t)
        eng.submit(p)
        got = _summary(_final(t))
        wall = time.monotonic() - t0
        _final(p)
    finally:
        eng.stop()
    assert got == unlimited
    assert refused["n"] > 0
    # 1 first token from the prefill, 1 from the full bucket, 6 at 5/s
    assert wall >= (spec[3] - 2) / 5.0 * 0.9
    assert not any(seen)
