"""HTTP transport + routes on the standard library (counterpart of
llama_box_tpu/server/http.py, which runs on aiohttp).

`http.server.ThreadingHTTPServer` serves one thread per connection; a
request thread submits its task to the engine and waits on the task's
result queue. Server-sent events go out as HTTP/1.1 chunked writes, one
chunk per event, ending with `data: [DONE]`. The JSON shapes are the JAX
server's (server/protocol.py).

Routes: GET /health, GET /v1/models (/models), POST /v1/completions
(/completions) and POST /v1/chat/completions (/chat/completions), each
streamed or not. Tools, reasoning splitting, multimodal content, LoRA,
embeddings, rerank, tokenize and images are not ported yet and are
refused with a 400 or a 404; the per-request rate-limit header
(X-Request-Tokens-Per-Second) is not read yet.
"""

from __future__ import annotations

import json
import queue
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from ..ops.qmatmul import QTensor
from ..sampling import SamplerParams
from ..utils.logging import SRV_ERR, SRV_INF
from .chat import ChatTemplates
from .engine import Engine
from .protocol import (RequestError, bad_request, chat_chunk_json,
                       chat_completion_json, completion_chunk_json,
                       completion_json, new_request_id, parse_max_tokens,
                       parse_prompt_tokens, parse_sampling, parse_stop,
                       parse_stream_options, usage_json)
from .task import CompletionsTask

RESULT_TIMEOUT_S = 600.0


class HTTPServer:
    """The routes, independent of the transport; `make_server` binds them
    to a ThreadingHTTPServer."""

    def __init__(self, engine: Engine, model_name: str = "model",
                 defaults: SamplerParams | None = None,
                 chat_templates: ChatTemplates | None = None,
                 default_max_tokens: int = -1,
                 chat_template_kwargs: dict | None = None,
                 default_stop: tuple = ()):
        self.engine = engine
        self.model_name = model_name
        self.defaults = defaults or SamplerParams()
        self.chat = chat_templates or ChatTemplates(engine.tokenizer,
                                                    use_jinja=False)
        self.default_max_tokens = default_max_tokens
        self.chat_template_kwargs = chat_template_kwargs or {}
        self.default_stop = tuple(default_stop)
        self.created = int(time.time())

    def make_server(self, host: str = "127.0.0.1",
                    port: int = 8080) -> ThreadingHTTPServer:
        app = self

        class Handler(_Handler):
            routes = app
        srv = ThreadingHTTPServer((host, port), Handler)
        srv.daemon_threads = True
        return srv

    # -- meta endpoints ------------------------------------------------------

    def health(self, body: dict, rid: str) -> dict:
        return {"status": "ok"}

    def models(self, body: dict, rid: str) -> dict:
        cfg = self.engine.cfg
        leaves = _leaves(self.engine.params)
        return {
            "object": "list",
            "data": [{
                "id": self.model_name,
                "object": "model",
                "created": self.created,
                "owned_by": "llama-box",
                "meta": {
                    "vocab_type": 1,
                    "n_vocab": cfg.vocab_size,
                    "n_ctx_train": cfg.n_ctx_train,
                    "n_embd": cfg.n_embd,
                    "n_params": int(sum(t.numel() for t in leaves)),
                    "size": int(sum(t.numel() * t.element_size()
                                    for t in leaves)),
                    "support_completion": True,
                    "support_embedding": False,
                    "support_reranking": False,
                    "support_image": False,
                    "support_vision": False,
                    "support_audio": False,
                    "support_speculative": False,
                    "support_tool_calls": False,
                    "support_reasoning": False,
                },
            }],
        }

    # -- completions ---------------------------------------------------------

    def completions(self, body: dict, rid: str):
        tok = self.engine.tokenizer
        if "prompt" not in body:
            raise bad_request("\"prompt\" must be provided", "prompt")
        prompt_tokens = parse_prompt_tokens(body["prompt"], tok)
        if not prompt_tokens:
            raise bad_request("\"prompt\" must not be empty", "prompt")
        task = self._task(body, rid, prompt_tokens,
                          n_keep=int(body.get("n_keep", 0)))
        if not task.stream:
            return self._wait_final(
                task, lambda t: completion_json(t, self.model_name))
        return task, lambda t, d, fr: completion_chunk_json(
            t, self.model_name, d.get("text", ""), fr)

    def chat_completions(self, body: dict, rid: str):
        tok = self.engine.tokenizer
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise bad_request("\"messages\" must be a non-empty array",
                              "messages")
        if body.get("tools") or body.get("functions"):
            raise bad_request("tool calling is not supported by this server "
                              "yet", "tools")
        msgs = _normalize_messages(messages)
        extra_ctx = dict(self.chat_template_kwargs)
        ck = body.get("chat_template_kwargs")
        if isinstance(ck, dict):
            extra_ctx.update(ck)
        prompt = self.chat.apply(msgs, add_generation_prompt=True,
                                 extra_context=extra_ctx or None)
        prompt_tokens = tok.encode(prompt, add_special=True,
                                   parse_special=True)
        task = self._task(body, rid, prompt_tokens)
        if not task.stream:
            return self._wait_final(task, lambda t: chat_completion_json(
                t, self.model_name, tok))
        first = {"role": "assistant", "content": ""}

        def chunk_fn(t, d, fr):
            nonlocal first
            delta: dict[str, Any] = {}
            if first is not None:
                delta.update(first)
                first = None
            if d.get("text"):
                delta["content"] = delta.get("content", "") + d["text"]
            return chat_chunk_json(t, self.model_name, delta, fr)
        return task, chunk_fn

    def _task(self, body: dict, rid: str, prompt_tokens: list[int],
              n_keep: int = 0) -> CompletionsTask:
        tok = self.engine.tokenizer
        sparams = parse_sampling(body, self.defaults, tok.n_vocab)
        so = parse_stream_options(body)
        mt = parse_max_tokens(body, self.engine.slot_ctx)
        if body.get("lora") is not None:
            raise bad_request("\"lora\" is not supported by this server yet",
                              "lora")
        task = CompletionsTask(
            prompt_tokens, sparams, tokenizer=tok,
            max_tokens=mt if mt > 0 else self.default_max_tokens,
            stop_words=parse_stop(body, self.default_stop),
            stream=so["stream"], n_keep=n_keep, n_probs=sparams.n_probs,
            rid=rid)
        task.include_usage = so["include_usage"]
        self.engine.submit(task)
        return task

    def _wait_final(self, task, render) -> dict:
        while True:
            kind, payload = _next_event(task)
            if kind == "error":
                raise payload if isinstance(payload, RequestError) else \
                    RequestError(500, str(payload), err_type="server_error")
            if kind == "final":
                return render(payload)


def _next_event(task):
    try:
        return task.result_q.get(timeout=RESULT_TIMEOUT_S)
    except queue.Empty:
        task.cancelled = True
        raise RequestError(500, "generation timed out",
                           err_type="server_error")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, QTensor):
        return tree.leaves()
    return [tree]


def _normalize_messages(messages: list) -> list[dict]:
    out = []
    for i, m in enumerate(messages):
        if not isinstance(m, dict):
            raise bad_request(f"messages[{i}] must be an object", "messages")
        role = m.get("role")
        if role not in ("system", "user", "assistant", "tool", "developer"):
            raise bad_request(f"messages[{i}].role is invalid", "messages")
        content = m.get("content")
        if isinstance(content, list):
            parts = []
            for p in content:
                if not isinstance(p, dict):
                    raise bad_request(
                        f"messages[{i}].content parts must be objects",
                        "messages")
                if p.get("type") != "text":
                    raise bad_request(
                        f"messages[{i}].content type \"{p.get('type')}\" is "
                        "not supported by this model", "messages")
                parts.append(p.get("text", ""))
            content = "".join(parts)
        elif content is None:
            if m.get("tool_calls") is None:
                raise bad_request(
                    f"messages[{i}] is missing 'content' or 'tool_calls'",
                    "messages")
            content = ""
        elif not isinstance(content, str):
            raise bad_request(f"messages[{i}].content is invalid", "messages")
        nm = {"role": "system" if role == "developer" else role,
              "content": content}
        for k in ("name", "tool_calls", "tool_call_id"):
            if k in m:
                nm[k] = m[k]
        out.append(nm)
    return out


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    routes: HTTPServer = None   # bound by HTTPServer.make_server

    _GET = {"/health": "health", "/v1/models": "models", "/models": "models"}
    _POST = {"/v1/completions": "completions", "/completions": "completions",
             "/v1/chat/completions": "chat_completions",
             "/chat/completions": "chat_completions"}

    def log_message(self, fmt, *args):   # access log goes through SRV_INF
        pass

    def do_OPTIONS(self):
        self._send_json(200, {}, self.headers.get("X-Request-ID") or "")

    def do_GET(self):
        self._dispatch(self._GET)

    def do_POST(self):
        self._dispatch(self._POST)

    def _dispatch(self, table: dict) -> None:
        rid = self.headers.get("X-Request-ID") or new_request_id()
        t0 = time.monotonic()
        status = 200
        try:
            name = table.get(self.path.split("?", 1)[0])
            if name is None:
                raise RequestError(404, f"no route {self.command} "
                                   f"{self.path}", err_type="not_found_error")
            body = self._body() if self.command == "POST" else {}
            result = getattr(self.routes, name)(body, rid)
            if isinstance(result, tuple):
                self._stream(rid, *result)
            else:
                self._send_json(200, result, rid)
        except RequestError as exc:
            status = exc.status
            self._send_json(exc.status, exc.to_json(), rid)
        except (BrokenPipeError, ConnectionResetError):
            status = 499
        except Exception as exc:  # noqa: BLE001 — the server keeps serving
            SRV_ERR("http", "rid=%s unhandled: %r", rid, exc)
            status = 500
            self._send_json(500, RequestError(
                500, str(exc) or "internal error",
                err_type="server_error").to_json(), rid)
        SRV_INF("http", "rid=%s %s %s %d %.1fms", rid, self.command,
                self.path, status, (time.monotonic() - t0) * 1e3)

    def _body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        try:
            body = json.loads(self.rfile.read(n) or b"null")
        except ValueError:
            raise bad_request("request body must be valid JSON")
        if not isinstance(body, dict):
            raise bad_request("request body must be a JSON object")
        return body

    def _common_headers(self, rid: str) -> None:
        self.send_header("X-Request-ID", rid)
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
        self.send_header("Access-Control-Allow-Headers", "*")

    def _send_json(self, status: int, obj, rid: str) -> None:
        data = json.dumps(obj, ensure_ascii=False).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self._common_headers(rid)
        self.end_headers()
        self.wfile.write(data)

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
        self.wfile.flush()

    def _stream(self, rid: str, task: CompletionsTask, chunk_fn) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self._common_headers(rid)
        self.end_headers()

        def send(obj) -> None:
            self._chunk(b"data: " + json.dumps(obj, ensure_ascii=False)
                        .encode() + b"\n\n")
        try:
            while True:
                try:
                    kind, payload = _next_event(task)
                except RequestError as exc:
                    kind, payload = "error", exc
                if kind == "error":
                    err = payload.to_json() if isinstance(
                        payload, RequestError) else RequestError(
                        500, str(payload), err_type="server_error").to_json()
                    self._chunk(b"error: " + json.dumps(err).encode()
                                + b"\n\n")
                    break
                if kind == "delta":
                    send(chunk_fn(task, payload,
                                  payload.get("finish_reason")))
                elif kind == "final":
                    if task.include_usage:
                        final_chunk = chunk_fn(task, {}, None)
                        final_chunk["choices"] = []
                        final_chunk["usage"] = usage_json(payload)
                        send(final_chunk)
                    self._chunk(b"data: [DONE]\n\n")
                    break
            self._chunk(b"")
        except (BrokenPipeError, ConnectionResetError):
            task.cancelled = True
            raise
