"""HTTP transport + routes on the standard library (counterpart of
llama_box_tpu/server/http.py, which runs on aiohttp).

`http.server.ThreadingHTTPServer` serves one thread per connection; a
request thread submits its task to the engine and waits on the task's
result queue. Server-sent events go out as HTTP/1.1 chunked writes, one
chunk per event, ending with `data: [DONE]`. The JSON shapes are the JAX
server's (server/protocol.py).

Routes: GET /health, GET /metrics (Prometheus text, `llamabox:*`), GET
/v1/models (/models), GET /props, GET /lora-adapters, POST /tokenize, POST
/detokenize, POST /v1/completions (/completions) and POST
/v1/chat/completions (/chat/completions), each streamed or not, with
tools and tool_choice (tool_calls in the message and in SSE deltas),
reasoning splitting (reasoning_content) and the per-request rate limit
(X-Request-Tokens-Per-Second: 400 when it is not a number, 410 above the
server's -tps cap); POST /v1/embeddings (/embeddings; float or base64
f32) and POST /v1/rerank (/rerank). The capabilities (`capabilities=`,
the JAX server's names and defaults) gate the completion, embedding and
reranking routes: a route that is off answers 404, and /v1/models
reports them. With an mmproj (`multimodal=`, a MultimodalProcessor),
chat messages take `image_url` parts (a data URI or an http(s) URL) and,
when the mmproj has an audio encoder, `input_audio` parts (wav, or mp3
where the platform's libmpg123 loads): each becomes a `<MTMD/>` marker
in the templated prompt, wrapped in the family's scaffold and split into
token and embedding chunks (server/multimodal.py; M-RoPE streams on a
Qwen2-VL file); a part the server cannot take answers a 400. /props
reports support_image and support_audio for that input (the JAX /v1/models
meta's support_image names image generation, and stays false here). A
request's `lora` field ([{"id", "scale"}]) sets its slot's adapter scales
under --lora-per-request (with static adapters only, any id is out of
range, as in JAX); /lora-adapters lists the CLI's adapters. Image
generation is not ported yet (404).
"""

from __future__ import annotations

import base64
import dataclasses
import json
import queue
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from ..grammar import Grammar, GrammarError
from ..ops.qmatmul import QTensor
from ..sampling import SamplerParams
from ..utils.logging import SRV_ERR, SRV_INF
from ..utils.tokenbucket import RatelimitTokenBucket
from .chat import ChatTemplates
from .engine import Engine
from .protocol import (RequestError, bad_request, chat_chunk_json,
                       chat_completion_json, completion_chunk_json,
                       completion_json, new_request_id, parse_max_tokens,
                       parse_lora, parse_prompt_tokens, parse_sampling,
                       parse_stop,
                       parse_stream_options, usage_json)
from .reasoning import ReasoningSplitter, detect_reasoning_markers
from .task import CompletionsTask, EmbeddingsTask, RerankTask
from .toolcall import ToolCallScanner, migrate_functions, tools_grammar

RESULT_TIMEOUT_S = 600.0


class HTTPServer:
    """The routes, independent of the transport; `make_server` binds them
    to a ThreadingHTTPServer."""

    def __init__(self, engine: Engine, model_name: str = "model",
                 defaults: SamplerParams | None = None,
                 chat_templates: ChatTemplates | None = None,
                 default_max_tokens: int = -1,
                 chat_template_kwargs: dict | None = None,
                 default_stop: tuple = (),
                 max_tps: float = 0.0,
                 default_grammar: str | None = None,
                 capabilities: dict | None = None,
                 multimodal=None, lora_adapters: list | None = None):
        """max_tps: the server's decode-rate cap a request (-tps; 0 =
        none); default_grammar: the server-wide GBNF (--grammar,
        --grammar-file, --json-schema); capabilities: overrides of the
        route switches (completion and embedding on, reranking off by
        default, as in the JAX server); multimodal: the mmproj's
        MultimodalProcessor, or None; lora_adapters: what GET
        /lora-adapters lists ({"id", "path", "scale"} an adapter, as the
        CLI builds it)."""
        self.engine = engine
        self.lora_adapters_list = list(lora_adapters or [])
        self.mp = multimodal
        self.model_name = model_name
        self.defaults = defaults or SamplerParams()
        self.chat = chat_templates or ChatTemplates(engine.tokenizer,
                                                    use_jinja=False)
        self.default_max_tokens = default_max_tokens
        self.chat_template_kwargs = chat_template_kwargs or {}
        self.default_stop = tuple(default_stop)
        self.max_tps = max_tps
        self.default_grammar = default_grammar
        self.reasoning_markers = detect_reasoning_markers(self.chat.source)
        self.caps = {"completion": True, "embedding": True,
                     "reranking": False}
        self.caps.update(capabilities or {})
        self.post_routes = {"/tokenize": "tokenize",
                            "/detokenize": "detokenize"}
        for cap, routes in _CAP_ROUTES.items():
            if self.caps[cap]:
                self.post_routes.update(routes)
        self.created = int(time.time())

    def make_server(self, host: str = "127.0.0.1",
                    port: int = 8080) -> ThreadingHTTPServer:
        app = self

        class Handler(_Handler):
            routes = app
        srv = ThreadingHTTPServer((host, port), Handler)
        srv.daemon_threads = True
        return srv

    def _request_rate_bucket(self, headers):
        """X-Request-Tokens-Per-Second -> per-task token bucket; 410 when
        the requested rate exceeds the server cap (JAX
        `_request_rate_bucket`)."""
        hdr = headers.get("X-Request-Tokens-Per-Second") if headers else None
        tps = self.max_tps
        if hdr is not None:
            try:
                tps = float(hdr)
            except ValueError:
                raise bad_request(
                    "\"X-Request-Tokens-Per-Second\" must be a number")
            if tps <= 0:
                tps = self.max_tps
            elif self.max_tps > 0 and tps > self.max_tps:
                raise RequestError(
                    410, "requested tokens per second exceeds the server "
                    f"limit ({self.max_tps:.0f})", code="rate_limit")
        if tps and tps > 0:
            return RatelimitTokenBucket(capacity=max(int(tps), 1), rate=tps)
        return None

    # -- meta endpoints ------------------------------------------------------

    def health(self, body: dict, rid: str, headers=None) -> dict:
        return {"status": "ok"}

    def lora_adapters(self, body: dict, rid: str, headers=None) -> list:
        return self.lora_adapters_list

    def props(self, body: dict, rid: str, headers=None) -> dict:
        """The server's settings and its media inputs: support_image with
        an mmproj, support_audio when it has an audio encoder."""
        mp = self.mp
        return {"model_alias": self.model_name,
                "n_ctx": self.engine.slot_ctx,
                "total_slots": len(self.engine.slots),
                "chat_template": self.chat.source or "",
                "support_image": mp is not None and mp.supports_image,
                "support_audio": mp is not None and mp.supports_audio,
                "modalities": {"vision": mp is not None
                               and mp.supports_image,
                               "audio": mp is not None
                               and mp.supports_audio}}

    def metrics(self, body: dict, rid: str, headers=None) -> str:
        """Prometheus text exposition (JAX `handle_metrics`)."""
        m = self.engine.metrics
        used, total = self.engine.kv_cache_usage()
        processing = sum(1 for s in self.engine.slots if s.state != "idle")
        lines = []

        def metric(kind, name, help_, value):
            lines.append(f"# HELP llamabox:{name} {help_}")
            lines.append(f"# TYPE llamabox:{name} {kind}")
            lines.append(f"llamabox:{name} {value}")

        metric("counter", "prompt_tokens_total",
               "Number of prompt tokens processed.", m.n_prefill_total)
        metric("counter", "prompt_seconds_total", "Prompt process time.",
               round(m.t_prefill_total_ms / 1e3, 3))
        metric("counter", "tokens_predicted_total",
               "Number of generated tokens.", m.n_decode_total)
        metric("counter", "tokens_predicted_seconds_total",
               "Generation time.", round(m.t_decode_total_ms / 1e3, 3))
        metric("counter", "tokens_drafted_total",
               "Number of drafted tokens.", m.n_drafted_total)
        metric("counter", "tokens_drafted_accepted_total",
               "Number of accepted drafted tokens.",
               m.n_drafted_accepted_total)
        metric("counter", "requests_total", "Number of requests.",
               m.n_requests)
        pps = (m.n_prefill_total / (m.t_prefill_total_ms / 1e3)
               if m.t_prefill_total_ms > 0 else 0.0)
        dps = (m.n_decode_total / (m.t_decode_total_ms / 1e3)
               if m.t_decode_total_ms > 0 else 0.0)
        metric("gauge", "prompt_tokens_seconds",
               "Average prompt throughput (tok/s).", round(pps, 2))
        metric("gauge", "predicted_tokens_seconds",
               "Average generation throughput (tok/s).", round(dps, 2))
        metric("gauge", "kv_cache_usage_ratio",
               "KV-cache usage; 1 means full.",
               round(used / max(total, 1), 4))
        metric("gauge", "kv_cache_tokens", "KV-cache tokens.", used)
        metric("gauge", "requests_processing",
               "Number of requests processing.", processing)
        metric("gauge", "requests_deferred", "Number of requests deferred.",
               self.engine.queue.qsize())
        return "\n".join(lines) + "\n"

    def tokenize(self, body: dict, rid: str, headers=None) -> dict:
        if "content" not in body:
            raise bad_request("\"content\" must be provided", "content")
        add_special = bool(body.get("add_special", True))
        tok = self.engine.tokenizer
        ids = parse_prompt_tokens(body["content"], tok, "content") \
            if not isinstance(body["content"], str) else tok.encode(
                body["content"], add_special=add_special, parse_special=True)
        if body.get("with_pieces"):
            return {"tokens": [
                {"id": t, "piece": tok.decode([t], skip_leading_space=False)}
                for t in ids]}
        return {"tokens": ids}

    def detokenize(self, body: dict, rid: str, headers=None) -> dict:
        toks = body.get("tokens")
        if not isinstance(toks, list) or not all(
                isinstance(t, int) and not isinstance(t, bool) for t in toks):
            raise bad_request("\"tokens\" must be an array of token ids",
                              "tokens")
        return {"content": self.engine.tokenizer.decode(toks)}

    def models(self, body: dict, rid: str, headers=None) -> dict:
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
                    "support_completion": self.caps["completion"],
                    "support_embedding": self.caps["embedding"],
                    "support_reranking": self.caps["reranking"],
                    "support_image": False,
                    "support_vision": self.mp is not None,
                    "support_audio": self.mp is not None
                    and self.mp.supports_audio,
                    "support_speculative": (
                        self.engine.draft_params is not None
                        or self.engine.ecfg.lookup_ngram_min > 0),
                    "support_tool_calls": self.chat.source is not None,
                    "support_reasoning": self.reasoning_markers is not None,
                },
            }],
        }

    # -- embeddings / rerank -------------------------------------------------

    def embeddings(self, body: dict, rid: str, headers=None) -> dict:
        """JAX `handle_embeddings`: input (or content) as a string, a list
        of strings, a token list or a list of token lists; the vectors L2
        normalized, as float lists or base64 of their f32 bytes."""
        tok = self.engine.tokenizer
        inp = body.get("input", body.get("content"))
        if inp is None:
            raise bad_request("\"input\" must be provided", "input")
        if isinstance(inp, str) or (
                isinstance(inp, list) and inp
                and all(isinstance(x, int) and not isinstance(x, bool)
                        for x in inp)):
            inputs = [inp]
        elif isinstance(inp, list) and inp:
            inputs = inp
        else:
            raise bad_request("\"input\" must be a string, array of "
                              "strings, or token arrays", "input")
        token_lists = [parse_prompt_tokens(x, tok, "input") for x in inputs]
        for i, t in enumerate(token_lists):
            if not t:
                raise bad_request(f"\"input\"[{i}] must not be empty",
                                  "input")
        enc = body.get("encoding_format", "float")
        if enc not in ("float", "base64"):
            raise bad_request("\"encoding_format\" must be \"float\" or "
                              "\"base64\"", "encoding_format")
        task = EmbeddingsTask(token_lists, rid=rid)
        self.engine.submit(task)
        payload = self._wait_final(task, lambda t: t)
        if enc == "base64":
            data = [{"object": "embedding", "index": i,
                     "embedding": base64.b64encode(np.asarray(
                         e, np.float32).tobytes()).decode()}
                    for i, e in enumerate(payload.embeddings)]
        else:
            data = [{"object": "embedding", "index": i, "embedding": e}
                    for i, e in enumerate(payload.embeddings)]
        return {"object": "list", "data": data, "model": self.model_name,
                "usage": {"prompt_tokens": task.n_prompt,
                          "total_tokens": task.n_prompt}}

    def rerank(self, body: dict, rid: str, headers=None) -> dict:
        """JAX `handle_rerank`: each document paired with the query as
        [CLS|BOS] q [SEP] d [SEP] [EOS], plus the query-self and
        query-unknown anchors when normalize; results sorted by score, the
        first top_n."""
        tok = self.engine.tokenizer
        query = body.get("query")
        docs = body.get("documents")
        if not isinstance(query, str) or not query:
            raise bad_request("\"query\" must be a non-empty string",
                              "query")
        if not isinstance(docs, list) or not docs or not all(
                isinstance(d, str) for d in docs):
            raise bad_request("\"documents\" must be a non-empty array of "
                              "strings", "documents")
        top_n = body.get("top_n", len(docs))
        normalize = bool(body.get("normalize", True))

        def pair(q: str, d: str) -> list[int]:
            """[BOS/CLS] q [SEP] d [SEP] [EOS] (httpserver.hpp:6189-6231)."""
            q_ids = tok.encode(q, add_special=False)
            d_ids = tok.encode(d, add_special=False)
            cls = getattr(tok, "cls_id", None)
            bos = [cls] if cls is not None else (
                [tok.bos_id] if tok.bos_id is not None else [])
            sep = [tok.sep_id] if tok.sep_id is not None else (
                [tok.eos_id] if tok.eos_id is not None else [])
            eos = [] if tok.sep_id is not None and tok.eos_id is None else (
                [tok.eos_id] if tok.eos_id is not None else [])
            return bos + q_ids + sep + d_ids + sep + eos

        pairs = [pair(query, d) for d in docs]
        if normalize:
            pairs.append(pair(query, query))      # query-self anchor
            pairs.append(pair(query, "unknown"))  # query-unknown anchor
        task = RerankTask(pairs, n_documents=len(docs), normalize=normalize,
                          rid=rid)
        self.engine.submit(task)
        payload = self._wait_final(task, lambda t: t)
        results = sorted(
            [{"index": i, "relevance_score": sc,
              "document": {"text": docs[i]} if body.get("return_documents")
              else None}
             for i, sc in enumerate(payload.scores)],
            key=lambda r: -r["relevance_score"])[:top_n]
        for r in results:
            if r["document"] is None:
                del r["document"]
        return {"model": self.model_name, "results": results,
                "usage": {"prompt_tokens": task.n_prompt,
                          "total_tokens": task.n_prompt}}

    # -- completions ---------------------------------------------------------

    def completions(self, body: dict, rid: str, headers=None):
        tok = self.engine.tokenizer
        if "prompt" not in body:
            raise bad_request("\"prompt\" must be provided", "prompt")
        prompt_tokens = parse_prompt_tokens(body["prompt"], tok)
        if not prompt_tokens:
            raise bad_request("\"prompt\" must not be empty", "prompt")
        task = self._task(body, rid, headers, prompt_tokens,
                          n_keep=int(body.get("n_keep", 0)))
        if not task.stream:
            return self._wait_final(
                task, lambda t: completion_json(t, self.model_name))
        return task, lambda t, d, fr: completion_chunk_json(
            t, self.model_name, d.get("text", ""), fr)

    def chat_completions(self, body: dict, rid: str, headers=None):
        tok = self.engine.tokenizer
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise bad_request("\"messages\" must be a non-empty array",
                              "messages")
        msgs, media = _normalize_messages(messages, self.mp)
        tools, tool_choice = migrate_functions(body)
        if tools is not None and not isinstance(tools, list):
            raise bad_request("\"tools\" must be an array", "tools")
        use_tools = bool(tools) and tool_choice != "none"
        extra_ctx = dict(self.chat_template_kwargs)
        ck = body.get("chat_template_kwargs")
        if isinstance(ck, dict):
            extra_ctx.update(ck)
        prompt = self.chat.apply(msgs, tools=tools if use_tools else None,
                                 add_generation_prompt=True,
                                 extra_context=extra_ctx or None)
        chunks, mrope_delta = None, 0
        if media:
            prompt_tokens, chunks, mrope_delta = self._media_chunks(
                prompt, media)
        else:
            prompt_tokens = tok.encode(prompt, add_special=True,
                                       parse_special=True)
        reasoning = None
        if self.reasoning_markers is not None:
            reasoning = ReasoningSplitter(
                *self.reasoning_markers,
                force_open=prompt.rstrip().endswith(
                    self.reasoning_markers[0]))
        toolscan = (ToolCallScanner(
            self.chat.alias,
            parallel=bool(body.get("parallel_tool_calls", True)))
            if use_tools else None)
        task = self._task(body, rid, headers, prompt_tokens,
                          reasoning=reasoning, toolscan=toolscan,
                          tools=tools if use_tools else None, chunks=chunks,
                          mrope_delta=mrope_delta)
        if not task.stream:
            def render(t):
                extra = {}
                if t.tool_calls:
                    extra["tool_calls"] = [
                        {"id": c.id, "type": "function",
                         "function": {"name": c.name,
                                      "arguments": c.arguments}}
                        for c in t.tool_calls]
                if t.reasoning_text:
                    extra["reasoning_content"] = t.reasoning_text
                return chat_completion_json(t, self.model_name, tok, extra)
            return self._wait_final(task, render)
        first = {"role": "assistant", "content": ""}
        n_calls = 0

        def chunk_fn(t, d, fr):
            nonlocal first, n_calls
            delta: dict[str, Any] = {}
            if first is not None:
                delta.update(first)
                first = None
            if d.get("text"):
                delta["content"] = delta.get("content", "") + d["text"]
            if d.get("reasoning_content"):
                delta["reasoning_content"] = d["reasoning_content"]
            if d.get("tool_calls"):
                delta["tool_calls"] = []
                for c in d["tool_calls"]:
                    delta["tool_calls"].append(
                        {"index": n_calls, "id": c.id, "type": "function",
                         "function": {"name": c.name,
                                      "arguments": c.arguments}})
                    n_calls += 1
            return chat_chunk_json(t, self.model_name, delta, fr)
        return task, chunk_fn

    def _media_chunks(self, prompt: str, media: list):
        """The templated prompt with its media as prefill chunks (JAX
        `handle_chat_completions`): the family's scaffold, then
        build_chunks, or build_chunks_mrope on an M-RoPE model (the
        trained grid as the fallback grid). A prompt longer than a slot
        answers a 400. Returns (flat ids, chunks, mrope_delta)."""
        from .multimodal import (build_chunks, build_chunks_mrope,
                                 scaffold_prompt)
        tok, mp = self.engine.tokenizer, self.mp
        prompt = scaffold_prompt(prompt, self.engine.cfg.arch, media=media,
                                 audio_family=mp.audio_family)
        delta = 0
        try:
            if self.engine.cfg.mrope_sections:
                side = mp.cfg.n_patches_side // max(mp.cfg.merge_size, 1)
                flat, chunks, delta = build_chunks_mrope(
                    prompt, media, tok, mp, [(side, side)] * len(media))
            else:
                flat, chunks = build_chunks(prompt, media, tok, mp)
        except ValueError as exc:
            raise bad_request(str(exc), "messages")
        max_len = self.engine.slot_ctx - self.engine.ecfg.defrag_headroom
        if len(flat) > max_len:
            raise bad_request(
                f"multimodal prompt is {len(flat)} tokens but the per-slot "
                f"context allows {max_len}", "messages")
        return flat, chunks, delta

    def _task(self, body: dict, rid: str, headers, prompt_tokens: list[int],
              n_keep: int = 0, reasoning=None, toolscan=None,
              tools=None, chunks=None, mrope_delta: int = 0
              ) -> CompletionsTask:
        tok = self.engine.tokenizer
        sparams = parse_sampling(body, self.defaults, tok.n_vocab,
                                 default_grammar=self.default_grammar)
        so = parse_stream_options(body)
        mt = parse_max_tokens(body, self.engine.slot_ctx)
        if tools and sparams.grammar is None:
            # lazy tool grammar: unconstrained until a trigger string
            tg = tools_grammar(tools, self.chat.alias)
            if tg is not None:
                try:
                    sparams = dataclasses.replace(
                        sparams, grammar=Grammar(tg[0]), grammar_lazy=True,
                        grammar_triggers=tg[1])
                except GrammarError:
                    pass   # malformed tool schema: fall back to scanning
        task = CompletionsTask(
            prompt_tokens, sparams, tokenizer=tok,
            max_tokens=mt if mt > 0 else self.default_max_tokens,
            stop_words=parse_stop(body, self.default_stop),
            stream=so["stream"], n_keep=n_keep, n_probs=sparams.n_probs,
            rid=rid, reasoning=reasoning, toolscan=toolscan,
            rate_bucket=self._request_rate_bucket(headers), chunks=chunks,
            lora=parse_lora(body, self.engine.n_lora))
        task.mrope_delta = mrope_delta
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


def _media_part(i: int, p: dict, mp) -> tuple:
    """One image_url or input_audio content part as a (kind, bytes) media
    item (JAX `_normalize_messages`); a part the server cannot take is a
    400."""
    ptype = p.get("type")
    if ptype == "image_url" and mp is not None and mp.supports_image:
        from .multimodal import fetch_image_bytes
        url = (p.get("image_url") or {}).get("url", "")
        try:
            return "image", fetch_image_bytes(url)
        except Exception as exc:  # noqa: BLE001
            raise bad_request(f"messages[{i}] image fetch failed: {exc}",
                              "messages")
    if ptype == "input_audio" and mp is not None and mp.supports_audio:
        from ..utils import mp3
        ia = p.get("input_audio") or {}
        fmt = ia.get("format", "wav")
        ok_fmts = ("wav", "mp3") if mp3.available() else ("wav",)
        if fmt not in ok_fmts:
            raise bad_request(
                f"messages[{i}] audio format \"{fmt}\" is not supported "
                f"({'/'.join(ok_fmts)} only)", "messages")
        try:
            return "audio", base64.b64decode(ia.get("data", ""))
        except Exception as exc:  # noqa: BLE001
            raise bad_request(f"messages[{i}] audio decode failed: {exc}",
                              "messages")
    raise bad_request(f"messages[{i}].content type \"{ptype}\" is not "
                      "supported by this model", "messages")


def _normalize_messages(messages: list, mp=None) -> tuple[list[dict], list]:
    """The chat messages with their content parts joined (a media part as
    a `<MTMD/>` marker), and the media items in order."""
    from .multimodal import MTMD_MARKER
    out, media = [], []
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
                if p.get("type") == "text":
                    parts.append(p.get("text", ""))
                else:
                    media.append(_media_part(i, p, mp))
                    parts.append(MTMD_MARKER)
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
    return out, media


# the POST routes each capability switches on (JAX `build_app`)
_CAP_ROUTES = {
    "completion": {"/v1/completions": "completions",
                   "/completions": "completions",
                   "/v1/chat/completions": "chat_completions",
                   "/chat/completions": "chat_completions"},
    "embedding": {"/v1/embeddings": "embeddings",
                  "/embeddings": "embeddings"},
    "reranking": {"/v1/rerank": "rerank", "/rerank": "rerank"},
}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    routes: HTTPServer = None   # bound by HTTPServer.make_server

    _GET = {"/health": "health", "/metrics": "metrics",
            "/v1/models": "models", "/models": "models",
            "/lora-adapters": "lora_adapters", "/props": "props"}

    def log_message(self, fmt, *args):   # access log goes through SRV_INF
        pass

    def do_OPTIONS(self):
        self._send_json(200, {}, self.headers.get("X-Request-ID") or "")

    def do_GET(self):
        self._dispatch(self._GET)

    def do_POST(self):
        self._dispatch(self.routes.post_routes)

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
            result = getattr(self.routes, name)(body, rid, self.headers)
            if isinstance(result, tuple):
                self._stream(rid, *result)
            elif isinstance(result, str):
                self._send(200, result.encode(), "text/plain", rid)
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
        self._send(status, json.dumps(obj, ensure_ascii=False).encode(),
                   "application/json", rid)

    def _send(self, status: int, data: bytes, ctype: str, rid: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
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
