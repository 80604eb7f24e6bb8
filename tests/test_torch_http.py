"""The port's stdlib HTTP server (llama_box_tpu_torch/server/http.py, built
through cli.build_server) against a JAX Engine run of the same request, on
the tiny fixture GGUF with f32 weights and cache, greedy decoding.

The chat and text completion routes return the content and the token
counts of `usage` that the JAX engine gives for the same prompt tokens;
each SSE stream carries the same text and ends with `data: [DONE]`."""

import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from llama_box_tpu.gguf import GGUFFile as JGGUFFile
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.sampling import SamplerParams as JSamplerParams
from llama_box_tpu.server import Engine as JEngine, EngineConfig as JEngineConfig
from llama_box_tpu.server.chat import ChatTemplates as JChatTemplates
from llama_box_tpu.server.protocol import parse_prompt_tokens as j_parse_prompt
from llama_box_tpu.server.task import CompletionsTask as JTask
from llama_box_tpu.tokenizer import Tokenizer as JTokenizer
from llama_box_tpu_torch import cli
from llama_box_tpu_torch.server import chat as tchat
from .fixtures.make_tiny_model import write_tiny_model

MAX_TOKENS = 12
MESSAGES = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hello there, tiny model"}]
PROMPT = "the quick brown fox jumps"
N_SLOTS, N_CTX = 2, 256


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny.gguf")
    write_tiny_model(path)
    return path


@pytest.fixture(scope="module")
def server(model_path):
    engine, srv = cli.build_server([
        "-m", model_path, "--device", "cpu", "--port", "0", "--no-jinja",
        "-np", str(N_SLOTS), "-c", str(N_CTX), "-ub", "16",
        "--decode-chain", "4", "-ctk", "f32", "-ctv", "f32",
        "--weights-dtype", "f32"])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    engine.stop()


@pytest.fixture(scope="module")
def jax_run(model_path):
    """Greedy JAX engine runs keyed by route: (text, usage counts)."""
    cfg, params = jax_load(model_path, dtype=jnp.float32)
    with JGGUFFile(model_path) as g:
        tok = JTokenizer.from_gguf(g)
    eng = JEngine(cfg, params, tok,
                  JEngineConfig(n_slots=N_SLOTS, n_ctx=N_CTX, n_ubatch=16,
                                kv_dtype="float32", decode_chain=4))
    eng.start()
    chat_prompt = JChatTemplates(tok, use_jinja=False).apply(
        MESSAGES, add_generation_prompt=True)
    prompts = {
        "chat": tok.encode(chat_prompt, add_special=True, parse_special=True),
        "completions": j_parse_prompt(PROMPT, tok),
    }
    out = {}
    try:
        for route, toks in prompts.items():
            t = JTask(toks, JSamplerParams(temp=0.0), tokenizer=tok,
                      max_tokens=MAX_TOKENS)
            eng.submit(t)
            while True:
                kind, payload = t.result_q.get(timeout=120)
                if kind == "error":
                    raise payload
                if kind == "final":
                    break
            out[route] = (payload.text, len(toks), len(payload.generated))
    finally:
        eng.stop()
    return out


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read().decode()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _events(text):
    lines = [ln[len("data: "):] for ln in text.split("\n")
             if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    return [json.loads(ln) for ln in lines[:-1]]


def _usage_counts(u):
    return u["prompt_tokens"], u["completion_tokens"], u["total_tokens"]


def test_health_and_models(server):
    assert _get(server + "/health") == (200, {"status": "ok"})
    status, body = _get(server + "/v1/models")
    assert status == 200 and body["object"] == "list"
    assert body["data"][0]["meta"]["n_vocab"] > 0


def test_chat_completion_matches_jax(server, jax_run):
    status, text = _post(server + "/v1/chat/completions", dict(
        messages=MESSAGES, max_tokens=MAX_TOKENS, temperature=0))
    assert status == 200
    body = json.loads(text)
    want_text, n_prompt, n_gen = jax_run["chat"]
    assert body["object"] == "chat.completion"
    assert body["choices"][0]["message"]["content"] == (want_text or None)
    assert _usage_counts(body["usage"]) == (n_prompt, n_gen, n_prompt + n_gen)


def test_completion_matches_jax(server, jax_run):
    status, text = _post(server + "/v1/completions", dict(
        prompt=PROMPT, max_tokens=MAX_TOKENS, temperature=0))
    assert status == 200
    body = json.loads(text)
    want_text, n_prompt, n_gen = jax_run["completions"]
    assert body["object"] == "text_completion"
    assert body["choices"][0]["text"] == want_text
    assert _usage_counts(body["usage"]) == (n_prompt, n_gen, n_prompt + n_gen)


def test_streams_end_with_done_and_carry_the_text(server, jax_run):
    _, text = _post(server + "/v1/chat/completions", dict(
        messages=MESSAGES, max_tokens=MAX_TOKENS, temperature=0, stream=True,
        stream_options={"include_usage": True}))
    events = _events(text)
    content = "".join(c["delta"].get("content", "")
                      for e in events for c in e["choices"])
    assert content == jax_run["chat"][0]
    assert events[0]["choices"][0]["delta"]["role"] == "assistant"
    n_prompt, n_gen = jax_run["chat"][1:]
    assert _usage_counts(events[-1]["usage"]) == (n_prompt, n_gen,
                                                  n_prompt + n_gen)

    _, text = _post(server + "/v1/completions", dict(
        prompt=PROMPT, max_tokens=MAX_TOKENS, temperature=0, stream=True))
    events = _events(text)
    assert "".join(c["text"] for e in events for c in e["choices"]) \
        == jax_run["completions"][0]
    assert events[-1]["choices"][0]["finish_reason"] in ("stop", "length")


def test_errors(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/v1/nothing", {})
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/v1/chat/completions", dict(messages=[]))
    assert e.value.code == 400
    assert json.loads(e.value.read())["error"]["type"] \
        == "invalid_request_error"


def test_cli_refuses_jinja_without_jinja2(model_path, monkeypatch):
    monkeypatch.setattr(tchat, "jinja_available", lambda: False)
    with pytest.raises(SystemExit, match="--no-jinja"):
        cli.build_server(["-m", model_path, "--device", "cpu"])


def test_cli_without_cuda_raises(model_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.build_server(["-m", model_path, "--no-jinja"])


@pytest.fixture(scope="module")
def q_server(tmp_path_factory):
    """The tiny fixture at Q4_K, widths the fused kernels take (N_EMBD=128,
    HEAD_DIM=32, N_FF=256), served with --weights-dtype quantized."""
    import tests.fixtures.make_tiny_model as mk
    from llama_box_tpu_torch.gguf.constants import GGMLType
    path = str(tmp_path_factory.mktemp("tinyq") / "tiny-q4k.gguf")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mk, "N_EMBD", 128)
        mp.setattr(mk, "HEAD_DIM", 32)
        mp.setattr(mk, "N_FF", 256)
        mk.write_tiny_model(path, quant=GGMLType.Q4_K)
    engine, srv = cli.build_server([
        "-m", path, "--device", "cpu", "--port", "0", "--no-jinja",
        "-np", str(N_SLOTS), "-c", str(N_CTX), "-ub", "16",
        "--decode-chain", "4", "--weights-dtype", "quantized"])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield engine, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    engine.stop()


def test_quantized_weights_serve_chat(q_server):
    """--weights-dtype quantized: the projections are w8a8 QTensors with
    bf16 activations, and a greedy chat completes over HTTP, streamed and
    not, with the same text."""
    from llama_box_tpu_torch.ops.qmatmul import QTensor
    engine, url = q_server
    lay = engine.params["layers"]
    for key in ("wqkv", "wo", "w_gateup", "w_down"):
        assert isinstance(lay[key], QTensor) and lay[key].w8a8, key
    assert engine.params["tok_embd"].dtype == torch.bfloat16
    status, body = _get(url + "/v1/models")
    n = sum(t.numel() for w in lay.values()
            for t in (w.leaves() if isinstance(w, QTensor) else [w]))
    assert status == 200 and body["data"][0]["meta"]["n_params"] > n
    status, text = _post(url + "/v1/chat/completions", dict(
        messages=MESSAGES, max_tokens=MAX_TOKENS, temperature=0))
    assert status == 200
    body = json.loads(text)
    content = body["choices"][0]["message"]["content"]
    n_gen = body["usage"]["completion_tokens"]
    assert 0 < n_gen <= MAX_TOKENS
    assert body["choices"][0]["finish_reason"] == (
        "length" if n_gen == MAX_TOKENS else "stop")
    _, text = _post(url + "/v1/chat/completions", dict(
        messages=MESSAGES, max_tokens=MAX_TOKENS, temperature=0,
        stream=True))
    streamed = "".join(c["delta"].get("content", "")
                       for e in _events(text) for c in e["choices"])
    assert streamed == (content or "")


@pytest.mark.parametrize("extra", [
    {"grammar": "root ::= \"a\""},
    {"json_schema": {"type": "object"}},
    {"response_format": {"type": "json_object"}},
    {"mirostat": 2},
    {"dry_multiplier": 0.8},
    {"tools": [{"type": "function", "function": {"name": "f"}}]},
], ids=["grammar", "json_schema", "response_format", "mirostat", "dry",
        "tools"])
def test_unported_features_are_refused(server, extra):
    """Grammar, host-sampled chains and tools are later slices: such a
    request gets a 400, never an unconstrained answer."""
    body = dict(messages=MESSAGES, max_tokens=4, **extra)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/v1/chat/completions", body)
    assert e.value.code == 400
