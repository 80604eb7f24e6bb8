"""The port's stdlib HTTP server (llama_box_tpu_torch/server/http.py, built
through cli.build_server) against a JAX Engine run of the same request, on
the tiny fixture GGUF with f32 weights and cache, greedy decoding.

The chat and text completion routes return the content and the token
counts of `usage` that the JAX engine gives for the same prompt tokens;
each SSE stream carries the same text and ends with `data: [DONE]`. The
host-side routes: /tokenize as the JAX tokenizer, /detokenize back,
/metrics under the JAX server's names, /lora-adapters empty, the
X-Request-Tokens-Per-Second cases, and reasoning_content and tool_calls
in SSE deltas. /v1/embeddings and /v1/rerank (and their aliases) against
the JAX package's own aiohttp server on the same engine inputs, on
tests/test_bert.py's tiny BERT files and on the llama fixture: the same
vectors (float, and base64 of their f32 bytes), scores, order, status
codes and error params, capabilities in /v1/models and 404s for the
routes that are off, as the JAX CLI sets them from --embeddings,
--rerank and the file."""

import dataclasses
import json
import threading
import time
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
    """The request features of the host-controlled path (grammar,
    json_schema, response_format, mirostat, DRY, tools) are served: a 200
    with a finish reason, and the grammar's text where one is forced."""
    body = dict(messages=MESSAGES, max_tokens=4, **extra)
    status, text = _post(server + "/v1/chat/completions", body)
    assert status == 200
    choice = json.loads(text)["choices"][0]
    assert choice["finish_reason"] in ("stop", "length")
    if "grammar" in extra:
        assert choice["message"]["content"] == "a"
        assert choice["finish_reason"] == "stop"


# -- the host-side routes ------------------------------------------------------

# a chatml template that carries reasoning markers (the builtin chatml
# writer serves it under --no-jinja)
THINK_TEMPLATE = ("{% for m in messages %}<|im_start|>{{ m.role }}\n"
                  "{{ m.content }}<|im_end|>\n{% endfor %}<|im_start|>"
                  "assistant\n<think>\n</think>")
TPS_CAP = 50


@pytest.fixture(scope="module")
def rich_server(model_path):
    """The tiny fixture behind a server with a reasoning template and a
    token-rate cap (-tps)."""
    engine, srv = cli.build_server([
        "-m", model_path, "--device", "cpu", "--port", "0", "--no-jinja",
        "-np", str(N_SLOTS), "-c", str(N_CTX), "-ub", "16",
        "--decode-chain", "4", "-ctk", "f32", "-ctv", "f32",
        "--weights-dtype", "f32", "-tps", str(TPS_CAP),
        "--chat-template", THINK_TEMPLATE])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    engine.stop()


def _post_h(url, body, headers):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **headers})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read().decode()


def test_tokenize_and_detokenize_as_jax_tokenizer(server, model_path):
    with JGGUFFile(model_path) as g:
        jtok = JTokenizer.from_gguf(g)
    status, text = _post(server + "/tokenize", {"content": PROMPT})
    assert status == 200
    ids = json.loads(text)["tokens"]
    assert ids == jtok.encode(PROMPT, add_special=True, parse_special=True)
    _, text = _post(server + "/tokenize", {"content": PROMPT,
                                            "add_special": False,
                                            "with_pieces": True})
    pieces = json.loads(text)["tokens"]
    assert [p["piece"] for p in pieces] == [
        jtok.decode([t], skip_leading_space=False)
        for t in jtok.encode(PROMPT, add_special=False, parse_special=True)]
    _, text = _post(server + "/detokenize",
                    {"tokens": [p["id"] for p in pieces]})
    assert json.loads(text)["content"] == PROMPT
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server + "/detokenize", {"tokens": ["x"]})
    assert e.value.code == 400


def _metric_names(text):
    return {ln.split()[0].split(":", 1)[1] for ln in text.splitlines()
            if ln and not ln.startswith("#")}


def test_metrics_names_as_jax_and_counters_grow(server):
    """GET /metrics is Prometheus text under the JAX server's names
    (read from its handle_metrics); its counters grow with a request."""
    import pathlib
    import re
    src = (pathlib.Path(__file__).resolve().parents[1] / "llama_box_tpu"
           / "server" / "http.py").read_text()
    body = src[src.index("async def handle_metrics"):
               src.index("async def handle_tokenize")]
    jax_names = set(re.findall(r'(?:counter|gauge)\(\s*"([a-z_]+)"', body))
    with urllib.request.urlopen(server + "/metrics", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        before = r.read().decode()
    assert _metric_names(before) == jax_names and len(jax_names) >= 12
    for ln in before.splitlines():
        assert ln.startswith(("# HELP llamabox:", "# TYPE llamabox:",
                              "llamabox:")), ln
        if not ln.startswith("#"):
            float(ln.split()[1])
    _post(server + "/v1/completions", dict(prompt=PROMPT, max_tokens=3,
                                           temperature=0))
    with urllib.request.urlopen(server + "/metrics", timeout=30) as r:
        after = r.read().decode()

    def val(text, name):
        return float(next(ln.split()[1] for ln in text.splitlines()
                          if ln.startswith(f"llamabox:{name} ")))
    for name in ("prompt_tokens_total", "tokens_predicted_total",
                 "requests_total"):
        assert val(after, name) > val(before, name), name


def test_lora_adapters_lists_none(server):
    assert _get(server + "/lora-adapters") == (200, [])


def test_rate_limit_header(rich_server):
    """X-Request-Tokens-Per-Second: 400 when not a number, 410 above the
    server's cap; a rate of 5 gives the unlimited text at no more than
    its rate after the bucket's burst of 5."""
    body = dict(prompt=PROMPT, max_tokens=10, temperature=0,
                ignore_eos=True)
    url = rich_server + "/v1/completions"
    for hdr, code in (("fast", 400), (str(TPS_CAP * 2), 410)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_h(url, body, {"X-Request-Tokens-Per-Second": hdr})
        assert e.value.code == code
    _, free = _post(url, body)
    t0 = time.monotonic()
    status, limited = _post_h(url, body, {"X-Request-Tokens-Per-Second": "5"})
    wall = time.monotonic() - t0
    assert status == 200
    assert json.loads(limited)["choices"][0]["text"] \
        == json.loads(free)["choices"][0]["text"]
    # the first token from the prefill, 5 from the full bucket, 4 at 5/s
    assert wall >= 4 / 5 * 0.9


def test_reasoning_and_tool_call_deltas(rich_server):
    """With a template that carries <think> markers, a forced
    "<think>..</think>.." answer streams reasoning_content and content
    deltas; a forced tool call streams one tool_calls delta and ends with
    finish_reason tool_calls; the non-streamed message carries both."""
    url = rich_server + "/v1/chat/completions"
    think = dict(messages=MESSAGES, max_tokens=40, temperature=0,
                 grammar='root ::= "<think>" [a-c]{3} "</think>" [d-f]{3}')
    _, text = _post(url, dict(think, stream=True))
    ev = _events(text)
    deltas = [c["delta"] for e in ev for c in e["choices"]]
    reasoning = "".join(d.get("reasoning_content", "") for d in deltas)
    content = "".join(d.get("content", "") for d in deltas)
    assert len(reasoning) == 3 and set(reasoning) <= set("abc")
    assert len(content) == 3 and set(content) <= set("def")
    _, text = _post(url, think)
    msg = json.loads(text)["choices"][0]["message"]
    assert (msg["reasoning_content"], msg["content"]) == (reasoning, content)

    tools = [{"type": "function", "function": {
        "name": "f", "parameters": {"type": "object", "properties": {
            "x": {"type": "integer"}}, "required": ["x"]}}}]
    call = dict(messages=MESSAGES, max_tokens=80, temperature=0,
                tools=tools, grammar='root ::= "<tool_call>{\\"name\\": '
                '\\"f\\", \\"arguments\\": {\\"x\\": 7}}</tool_call>"')
    _, text = _post(url, dict(call, stream=True))
    ev = _events(text)
    calls = [tc for e in ev for c in e["choices"]
             for tc in c["delta"].get("tool_calls", [])]
    assert [(c["index"], c["type"], c["function"]["name"],
             json.loads(c["function"]["arguments"])) for c in calls] \
        == [(0, "function", "f", {"x": 7})]
    assert ev[-1]["choices"][0]["finish_reason"] == "tool_calls"
    _, text = _post(url, call)
    choice = json.loads(text)["choices"][0]
    assert choice["finish_reason"] == "tool_calls"
    assert [c["function"]["name"] for c in choice["message"]["tool_calls"]] \
        == ["f"]


def test_reasoning_flags_are_parsed_and_ignored_as_jax(model_path):
    """--(no-)enable-reasoning and --(no-)reasoning-in-content parse as
    the JAX CLI parses them, and, as there, the server reads neither: a
    template with reasoning markers still splits reasoning_content off."""
    from llama_box_tpu import cli as jcli
    keys = ("enable_reasoning", "reasoning_in_content")
    flags = ["--no-enable-reasoning", "--reasoning-in-content"]
    p, jp = cli.build_parser(), jcli.build_parser()
    for argv in ([], flags, ["--enable-reasoning",
                             "--no-reasoning-in-content"]):
        a, ja = p.parse_args(argv), jp.parse_args(argv)
        assert [getattr(a, k) for k in keys] == [getattr(ja, k)
                                                 for k in keys], argv
    engine, srv = cli.build_server([
        "-m", model_path, "--device", "cpu", "--port", "0", "--no-jinja",
        "-np", str(N_SLOTS), "-c", str(N_CTX), "--weights-dtype", "f32",
        "--chat-template", THINK_TEMPLATE] + flags)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        _, text = _post(url + "/v1/chat/completions", dict(
            messages=MESSAGES, max_tokens=40, temperature=0,
            grammar='root ::= "<think>" [a-c]{3} "</think>" [d-f]{3}'))
        msg = json.loads(text)["choices"][0]["message"]
        assert len(msg["reasoning_content"]) == 3
        assert len(msg["content"]) == 3
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()


def test_tps_minus_one_probes_the_decode_rate(model_path):
    """-tps -1 runs the engine's timed greedy probe at start and caps
    every request's rate at its result; the probe leaves no prefix."""
    engine, srv = cli.build_server([
        "-m", model_path, "--device", "cpu", "--port", "0", "--no-jinja",
        "-np", str(N_SLOTS), "-c", str(N_CTX), "-ub", "16",
        "--weights-dtype", "f32", "-tps", "-1"])
    try:
        app = srv.RequestHandlerClass.routes
        assert app.max_tps > 0
        assert all(s.pos == 0 and not s.cache_tokens for s in engine.slots)
        bucket = app._request_rate_bucket({})
        assert bucket is not None and bucket.rate == app.max_tps
    finally:
        srv.server_close()
        engine.stop()


# -- embeddings and rerank -----------------------------------------------------


def _jax_server(engine, caps):
    """The JAX package's aiohttp server over a started JAX engine, with
    `caps` as its CLI would set them: (url, stop)."""
    import asyncio
    import socket

    from llama_box_tpu.server.http import HTTPServer as JHTTPServer, run_app
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    app = JHTTPServer(engine, model_name="m", capabilities=caps)
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)

        async def go():
            await run_app(app, "127.0.0.1", port)
            started.set()
        loop.run_until_complete(go())
        loop.run_forever()
    threading.Thread(target=run, daemon=True).start()
    assert started.wait(timeout=30)

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        engine.stop()
    return f"http://127.0.0.1:{port}", stop


def _port_server(argv):
    engine, srv = cli.build_server(argv + [
        "--device", "cpu", "--port", "0", "--no-jinja", "--weights-dtype",
        "f32", "-np", "1", "-c", "256", "-ctk", "f32", "-ctv", "f32"])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def stop():
        srv.shutdown()
        srv.server_close()
        engine.stop()
    return f"http://127.0.0.1:{srv.server_address[1]}", stop


def _call(url, body):
    """(status, json) of a POST, errors included (None: a body that is not
    JSON, as aiohttp's 404 page)."""
    try:
        status, text = _post(url, body)
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read().decode()
    try:
        return status, json.loads(text)
    except ValueError:
        return status, None


def _jax_bert(path):
    from llama_box_tpu.models.bert import load_bert as j_load_bert
    cfg, params = j_load_bert(path)
    with JGGUFFile(path) as g:
        tok = JTokenizer.from_gguf(g)
    return cfg, params, tok


@pytest.fixture(scope="module")
def bert_paths(tmp_path_factory):
    from tests.test_bert import write_tiny_bert
    d = tmp_path_factory.mktemp("bert")
    out = {"rank": str(d / "bert-rank.gguf"), "mean": str(d / "bert.gguf")}
    write_tiny_bert(out["rank"], seed=0, with_cls=True)
    write_tiny_bert(out["mean"], seed=1, with_cls=False)
    return out


@pytest.fixture(scope="module")
def bert_pair(bert_paths):
    """The cross-encoder file behind the JAX server and the port's CLI
    (capabilities as the JAX CLI sets them for a `rank` BERT file:
    completions off, embeddings and rerank on)."""
    cfg, params, tok = _jax_bert(bert_paths["rank"])
    eng = JEngine(cfg, params, tok, JEngineConfig(n_slots=1, n_ctx=256))
    eng.start()
    jurl, jstop = _jax_server(eng, {"completion": False, "embedding": True,
                                    "reranking": True})
    purl, pstop = _port_server(["-m", bert_paths["rank"]])
    yield jurl, purl
    pstop()
    jstop()


EMB_INPUTS = ["the quick brown fox", ["a dog", "cat runs fast", "good"],
              [2, 20, 21, 3], [[2, 20, 3], [2, 30, 31, 32, 3]]]


@pytest.mark.parametrize("inp", EMB_INPUTS,
                         ids=["string", "strings", "tokens", "token_lists"])
def test_embeddings_float_and_base64_match_jax(bert_pair, inp):
    import base64

    import numpy as np
    jurl, purl = bert_pair
    for route in ("/v1/embeddings", "/embeddings"):
        js, jb = _call(jurl + route, {"input": inp})
        ps, pb = _call(purl + route, {"input": inp})
        assert ps == js == 200
        assert pb["object"] == "list" and pb["usage"] == jb["usage"]
        assert [d["index"] for d in pb["data"]] == \
            [d["index"] for d in jb["data"]]
        got = np.array([d["embedding"] for d in pb["data"]])
        want = np.array([d["embedding"] for d in jb["data"]])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    _, b64 = _call(purl + "/v1/embeddings",
                   {"content": inp, "encoding_format": "base64"})
    dec = np.array([np.frombuffer(base64.b64decode(d["embedding"]),
                                  np.float32) for d in b64["data"]])
    np.testing.assert_array_equal(dec, got.astype(np.float32))


@pytest.mark.parametrize("body", [
    {"query": "quick fox", "documents": ["the quick brown fox",
                                         "a slow dog", "cat runs fast"]},
    {"query": "quick fox", "documents": ["the quick brown fox",
                                         "a slow dog", "cat runs fast"],
     "normalize": False, "top_n": 2},
    {"query": "dog", "documents": ["a slow dog", "the cat", "dog dog"],
     "return_documents": True, "top_n": 1},
], ids=["normalized", "raw_top2", "documents_top1"])
def test_rerank_matches_jax(bert_pair, body):
    jurl, purl = bert_pair
    for route in ("/v1/rerank", "/rerank"):
        js, jb = _call(jurl + route, body)
        ps, pb = _call(purl + route, body)
        assert ps == js == 200
        assert pb["usage"] == jb["usage"]
        assert [r["index"] for r in pb["results"]] == \
            [r["index"] for r in jb["results"]]
        assert [r.get("document") for r in pb["results"]] == \
            [r.get("document") for r in jb["results"]]
        for p, j in zip(pb["results"], jb["results"]):
            assert p["relevance_score"] == pytest.approx(
                j["relevance_score"], abs=1e-4)
    scores = [r["relevance_score"] for r in pb["results"]]
    assert scores == sorted(scores, reverse=True)


@pytest.mark.parametrize("route,body", [
    ("/v1/embeddings", {}),
    ("/v1/embeddings", {"input": []}),
    ("/v1/embeddings", {"input": 5}),
    ("/v1/embeddings", {"input": [{"a": 1}]}),
    ("/v1/embeddings", {"input": "x", "encoding_format": "hex"}),
    ("/v1/rerank", {"documents": ["a"]}),
    ("/v1/rerank", {"query": "", "documents": ["a"]}),
    ("/v1/rerank", {"query": "q", "documents": []}),
    ("/v1/rerank", {"query": "q", "documents": ["a", 3]}),
], ids=["no_input", "empty_list", "number", "objects", "encoding",
        "no_query", "empty_query", "no_documents", "bad_document"])
def test_embedding_and_rerank_errors_match_jax(bert_pair, route, body):
    jurl, purl = bert_pair
    js, jb = _call(jurl + route, body)
    ps, pb = _call(purl + route, body)
    assert ps == js == 400
    for k in ("type", "param", "message"):
        assert pb["error"][k] == jb["error"][k], k


def test_bert_capabilities_match_jax(bert_pair):
    jurl, purl = bert_pair
    flags = ("support_completion", "support_embedding", "support_reranking")
    jm = _get(jurl + "/v1/models")[1]["data"][0]["meta"]
    pm = _get(purl + "/v1/models")[1]["data"][0]["meta"]
    assert [pm[f] for f in flags] == [jm[f] for f in flags] \
        == [False, True, True]
    for route in ("/v1/completions", "/v1/chat/completions"):
        assert _call(purl + route, {"prompt": "x"})[0] \
            == _call(jurl + route, {"prompt": "x"})[0] == 404


def test_bert_file_served_with_rerank(bert_paths):
    """A BERT file without a classification head, pooling mean, behind
    --rerank: rerank scores the [CLS] row's first feature (the `rank`
    pooling with no `cls` tensors), as the JAX server does."""
    cfg, params, tok = _jax_bert(bert_paths["mean"])
    cfg = dataclasses.replace(cfg, pooling="rank")
    eng = JEngine(cfg, params, tok, JEngineConfig(n_slots=1, n_ctx=256))
    eng.start()
    jurl, jstop = _jax_server(eng, {"completion": False, "embedding": True,
                                    "reranking": True})
    purl, pstop = _port_server(["-m", bert_paths["mean"], "--rerank"])
    try:
        body = {"query": "the fox", "documents": ["a fox", "dog", "cat"],
                "normalize": False}
        (js, jb), (ps, pb) = _call(jurl + "/v1/rerank", body), \
            _call(purl + "/v1/rerank", body)
        assert ps == js == 200
        assert [r["index"] for r in pb["results"]] == \
            [r["index"] for r in jb["results"]]
        for p, j in zip(pb["results"], jb["results"]):
            assert p["relevance_score"] == pytest.approx(
                j["relevance_score"], abs=1e-5)
        meta = _get(purl + "/v1/models")[1]["data"][0]["meta"]
        assert meta["support_reranking"] is True
    finally:
        pstop()
        jstop()


@pytest.mark.parametrize("flags,caps", [
    ([], {"completion": True, "embedding": True, "reranking": False}),
    (["--embeddings"], {"completion": False, "embedding": True,
                        "reranking": False}),
    (["--embedding", "--reranking"], {"completion": False,
                                      "embedding": True,
                                      "reranking": True}),
], ids=["default", "embeddings", "aliases"])
def test_llama_capability_flags_match_jax(model_path, flags, caps):
    """A llama file: the CLI's embedding group sets the routes as the JAX
    CLI does; a route that is off answers 404 in both servers, and both
    give the same embeddings."""
    cfg, params = jax_load(model_path, dtype=jnp.float32)
    with JGGUFFile(model_path) as g:
        tok = JTokenizer.from_gguf(g)
    eng = JEngine(cfg, params, tok, JEngineConfig(
        n_slots=1, n_ctx=256, kv_dtype="float32"))
    eng.start()
    jurl, jstop = _jax_server(eng, caps)
    purl, pstop = _port_server(["-m", model_path] + flags)
    try:
        meta = _get(purl + "/v1/models")[1]["data"][0]["meta"]
        jmeta = _get(jurl + "/v1/models")[1]["data"][0]["meta"]
        for k in ("completion", "embedding", "reranking"):
            assert meta[f"support_{k}"] == jmeta[f"support_{k}"] == caps[k]
        requests = {"/v1/completions": {"prompt": "hi", "max_tokens": 2,
                                        "temperature": 0},
                    "/v1/embeddings": {"input": ["hello", "the world"]},
                    "/v1/rerank": {"query": "hello",
                                   "documents": ["world", "the test"]}}
        for route, body in requests.items():
            (ps, pb), (js, jb) = _call(purl + route, body), \
                _call(jurl + route, body)
            assert ps == js, route
            if route == "/v1/embeddings":
                import numpy as np
                np.testing.assert_allclose(
                    [d["embedding"] for d in pb["data"]],
                    [d["embedding"] for d in jb["data"]], rtol=0, atol=1e-5)
            if route == "/v1/rerank" and ps == 200:
                assert [r["index"] for r in pb["results"]] == \
                    [r["index"] for r in jb["results"]]
                assert [r["relevance_score"] for r in pb["results"]] == \
                    pytest.approx([r["relevance_score"]
                                   for r in jb["results"]], abs=1e-5)
    finally:
        pstop()
        jstop()
