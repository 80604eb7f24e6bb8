"""OpenAI-compatible request parsing, validation and response rendering.

Reimplements the reference's per-endpoint parser structs + task JSON
rendering (httpserver.hpp:486-2041 parsers; 2042-2580 to_json) as pure host
code. Strictness mirrors the reference: wrong-typed or out-of-range fields
produce 400 invalid_request_error with a specific message.

(Counterpart of llama_box_tpu/server/protocol.py: what chat and
completions need, grammar-constrained output (grammar, json_schema,
response_format) and the host-sampled knobs included. LoRA is not ported
yet and is refused with a 400.)
"""

from __future__ import annotations

import time
import uuid
from typing import Any

from ..grammar import (Grammar, GrammarError, JSON_OBJECT_GRAMMAR,
                       json_schema_to_grammar)
from ..sampling import SamplerParams
from .task import CompletionsTask


class RequestError(Exception):
    def __init__(self, status: int, message: str, param: str | None = None,
                 err_type: str = "invalid_request_error",
                 code: str | None = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.param = param
        self.err_type = err_type
        self.code = code

    def to_json(self) -> dict:
        return {"error": {
            "message": self.message,
            "type": self.err_type,
            "param": self.param,
            "code": self.code,
        }}


def bad_request(message: str, param: str | None = None) -> RequestError:
    return RequestError(400, message, param)


# -- field access helpers ----------------------------------------------------


def get_typed(body: dict, key: str, types, default=None, required=False):
    if key not in body or body[key] is None:
        if required:
            raise bad_request(f"\"{key}\" must be provided", key)
        return default
    v = body[key]
    if types is float and isinstance(v, int) and not isinstance(v, bool):
        v = float(v)
    if types is int and isinstance(v, float) and v.is_integer():
        v = int(v)
    if not isinstance(v, types) or isinstance(v, bool) and types is not bool:
        raise bad_request(f"\"{key}\" is invalid", key)
    return v


def get_ranged(body: dict, key: str, default, lo=None, hi=None, typ=float):
    v = get_typed(body, key, typ, default)
    if v is None:
        return v
    if lo is not None and v < lo:
        raise bad_request(f"\"{key}\" must be >= {lo}", key)
    if hi is not None and v > hi:
        raise bad_request(f"\"{key}\" must be <= {hi}", key)
    return v


# -- sampling params (reference prepare_sampling, httpserver.hpp:158-226) ----


def parse_sampling(body: dict, defaults: SamplerParams | None = None,
                   n_vocab: int = 0,
                   default_grammar: str | None = None) -> SamplerParams:
    """default_grammar: server-wide GBNF (--grammar/--grammar-file/
    --json-schema) compiled fresh per request when the body brings none
    (grammar engines are stateful)."""
    d = defaults or SamplerParams()
    seed = get_typed(body, "seed", int, None)
    if seed is None or seed < 0:
        seed = int(time.time_ns() & 0xFFFFFFFF)

    logit_bias = dict(d.logit_bias)
    lb = body.get("logit_bias")
    if lb is not None:
        if not isinstance(lb, dict):
            raise bad_request("\"logit_bias\" must be a map of token id to bias",
                              "logit_bias")
        for k, v in lb.items():
            try:
                tid = int(k)
            except (TypeError, ValueError):
                raise bad_request("\"logit_bias\" keys must be token ids",
                                  "logit_bias")
            if n_vocab and not (0 <= tid < n_vocab):
                raise bad_request(f"\"logit_bias\" token {tid} out of range",
                                  "logit_bias")
            if isinstance(v, bool):
                # reference semantics: boolean false bans the token
                # (httpserver.hpp:1186-1190)
                logit_bias[tid] = -1e9 if not v else 0.0
                continue
            if not isinstance(v, (int, float)):
                raise bad_request("\"logit_bias\" values must be a number "
                                  "or boolean", "logit_bias")
            if not (-100.0 <= float(v) <= 100.0):
                raise bad_request("\"logit_bias\" values must be in the "
                                  "range [-100, 100]", "logit_bias")
            logit_bias[tid] = float(v)

    n_probs = 0
    if body.get("logprobs") is not None:
        lp = body["logprobs"]
        if isinstance(lp, bool):  # chat-style: logprobs + top_logprobs
            if lp:
                n_probs = get_ranged(body, "top_logprobs", 1, 0, 20, int)
        else:
            # completions-style int logprobs caps at 5 (reference
            # httpserver.hpp:749-751)
            n_probs = get_ranged(body, "logprobs", 0, 0, 5, int)
    elif body.get("top_logprobs") is not None:
        raise bad_request("\"top_logprobs\" must be used with "
                          "\"logprobs\"", "top_logprobs")

    grammar = parse_grammar(body)
    if grammar is None and default_grammar:
        try:
            grammar = Grammar(default_grammar)
        except GrammarError as exc:
            raise bad_request(f"server default grammar is invalid: {exc}",
                              "grammar")

    # per-request sampler chain (reference httpserver.hpp:162-172: array of
    # names -> from_names, string -> from_chars); unknown entries skipped
    samplers = d.samplers
    if "samplers" in body:
        from ..sampling import (sampler_types_from_chars,
                                sampler_types_from_names)
        sv = body["samplers"]
        if isinstance(sv, list):
            samplers = sampler_types_from_names(sv)
        elif isinstance(sv, str):
            samplers = sampler_types_from_chars(sv)
        else:
            raise bad_request("\"samplers\" must be an array of sampler "
                              "names or a string", "samplers")

    sp = SamplerParams(
        seed=seed,
        temp=get_ranged(body, "temperature", d.temp, 0.0, None),
        top_k=get_ranged(body, "top_k", d.top_k, 0, None, int),
        top_p=get_ranged(body, "top_p", d.top_p, 0.0, 1.0),
        min_p=get_ranged(body, "min_p", d.min_p, 0.0, 1.0),
        typ_p=get_ranged(body, "typical_p", d.typ_p, 0.0, 1.0),
        xtc_probability=get_ranged(body, "xtc_probability",
                                   d.xtc_probability, 0.0, 1.0),
        xtc_threshold=get_ranged(body, "xtc_threshold", d.xtc_threshold,
                                 0.0, 1.0),
        penalty_last_n=get_ranged(body, "repeat_last_n", d.penalty_last_n,
                                  -1, None, int),
        penalty_repeat=get_ranged(body, "repeat_penalty", d.penalty_repeat,
                                  0.0, None),
        penalty_freq=get_ranged(body, "frequency_penalty", d.penalty_freq,
                                -2.0, 2.0),
        penalty_present=get_ranged(body, "presence_penalty", d.penalty_present,
                                   -2.0, 2.0),
        logit_bias=logit_bias,
        ignore_eos=bool(body.get("ignore_eos", False)),
        n_probs=n_probs,
        grammar=grammar,
        mirostat=get_ranged(body, "mirostat", d.mirostat, 0, 2, int),
        mirostat_tau=get_ranged(body, "mirostat_tau", d.mirostat_tau,
                                0.0, None),
        mirostat_eta=get_ranged(body, "mirostat_eta", d.mirostat_eta,
                                0.0, None),
        dry_multiplier=get_ranged(body, "dry_multiplier", d.dry_multiplier,
                                  0.0, None),
        dry_base=get_ranged(body, "dry_base", d.dry_base, 1.0, None),
        dry_allowed_length=get_ranged(body, "dry_allowed_length",
                                      d.dry_allowed_length, 1, None, int),
        dry_penalty_last_n=get_ranged(body, "dry_penalty_last_n",
                                      d.dry_penalty_last_n, -1, None, int),
        dry_sequence_breakers=tuple(
            body["dry_sequence_breakers"])
        if isinstance(body.get("dry_sequence_breakers"), list)
        else d.dry_sequence_breakers,
        dynatemp_range=get_ranged(body, "dynatemp_range", d.dynatemp_range,
                                  0.0, None),
        dynatemp_exponent=get_ranged(body, "dynatemp_exponent",
                                     d.dynatemp_exponent, 0.0, None),
        top_n_sigma=get_ranged(body, "top_n_sigma", d.top_n_sigma,
                               -1.0, None),
        samplers=samplers,
    )
    from ..sampling import restrict_to_samplers
    return restrict_to_samplers(sp)


def parse_grammar(body: dict) -> Grammar | None:
    """\"grammar\" (GBNF) / \"json_schema\" / \"response_format\"
    (json_object | json_schema) -> compiled grammar (reference parsers,
    httpserver.hpp:486-2041; json_schema -> GBNF like the reference)."""
    gbnf = None
    if body.get("grammar") is not None:
        if not isinstance(body["grammar"], str):
            raise bad_request("\"grammar\" must be a GBNF string", "grammar")
        gbnf = body["grammar"]
    elif body.get("json_schema") is not None:
        try:
            gbnf = json_schema_to_grammar(body["json_schema"])
        except (GrammarError, ValueError, TypeError) as exc:
            raise bad_request(f"\"json_schema\" is invalid: {exc}",
                              "json_schema")
    elif body.get("response_format") is not None:
        rf = body["response_format"]
        if not isinstance(rf, dict) or "type" not in rf:
            raise bad_request("\"response_format\" must be an object with a "
                              "\"type\"", "response_format")
        rtype = rf["type"]
        if rtype == "json_object":
            schema = rf.get("schema")
            gbnf = (json_schema_to_grammar(schema) if schema
                    else JSON_OBJECT_GRAMMAR)
        elif rtype == "json_schema":
            js = rf.get("json_schema")
            if not isinstance(js, dict):
                # reference: httpserver.hpp:1346-1348
                raise bad_request("using json schema response format must "
                                  "contain \"json_schema\"",
                                  "response_format")
            schema = js.get("schema")
            try:
                gbnf = json_schema_to_grammar(schema)
            except (GrammarError, ValueError, TypeError) as exc:
                raise bad_request(f"\"response_format.json_schema\" is "
                                  f"invalid: {exc}", "response_format")
        elif rtype == "text":
            return None
        else:
            raise bad_request(f"\"response_format.type\" \"{rtype}\" is not "
                              "supported", "response_format")
    if gbnf is None:
        return None
    try:
        return Grammar(gbnf)
    except GrammarError as exc:
        raise bad_request(f"\"grammar\" is invalid: {exc}", "grammar")


def parse_stop(body: dict, extra: tuple = ()) -> list[str]:
    """extra: server-default stop strings (--reverse-prompt) merged in."""
    stop = body.get("stop")
    if stop is None:
        return list(extra)
    if isinstance(stop, str):
        return ([stop] if stop else []) + list(extra)
    if isinstance(stop, list):
        out = []
        for s in stop:
            if not isinstance(s, str):
                raise bad_request("\"stop\" must be a string or array of strings",
                                  "stop")
            if s:
                out.append(s)
        if len(out) > 16:
            raise bad_request("\"stop\" supports up to 16 entries", "stop")
        return out + list(extra)
    raise bad_request("\"stop\" must be a string or array of strings", "stop")


def parse_prompt_tokens(prompt: Any, tokenizer, param: str = "prompt"
                        ) -> list[int]:
    """string | [int] | [string|int ...] -> token ids (z_utils.hpp:372-483)."""
    if isinstance(prompt, str):
        return tokenizer.encode(prompt, add_special=True, parse_special=True)
    if isinstance(prompt, list):
        if all(isinstance(x, int) and not isinstance(x, bool) for x in prompt):
            return list(prompt)
        out: list[int] = []
        first = True
        for x in prompt:
            if isinstance(x, str):
                out.extend(tokenizer.encode(x, add_special=first,
                                            parse_special=True))
                first = False
            elif isinstance(x, int) and not isinstance(x, bool):
                out.append(x)
                first = False
            else:
                raise bad_request(
                    f"\"{param}\" must be a string, tokens, or mixed array",
                    param)
        return out
    raise bad_request(f"\"{param}\" must be a string or an array", param)


def parse_lora(body: dict, n_adapters: int) -> tuple:
    """Per-request adapter scales: [{"id": N, "scale": S}, ...]
    (reference per-request lora override, §2.1 #22)."""
    lora = body.get("lora")
    if lora is None:
        return ()
    if not isinstance(lora, list):
        raise bad_request("\"lora\" must be an array of {id, scale}",
                          "lora")
    out = []
    for e in lora:
        if not isinstance(e, dict) or "id" not in e:
            raise bad_request("\"lora\" entries must be {id, scale}",
                              "lora")
        aid = e["id"]
        if not isinstance(aid, int) or not 0 <= aid < n_adapters:
            raise bad_request(f"\"lora\" id {aid} is out of range", "lora")
        scale = e.get("scale", 1.0)
        if not isinstance(scale, (int, float)) or isinstance(scale, bool):
            raise bad_request("\"lora\" scale must be a number", "lora")
        out.append((aid, float(scale)))
    return tuple(out)


def parse_stream_options(body: dict) -> dict:
    stream = bool(body.get("stream", False))
    opts = body.get("stream_options") or {}
    if opts and not isinstance(opts, dict):
        raise bad_request("\"stream_options\" must be an object",
                          "stream_options")
    if opts and not stream:
        raise bad_request("\"stream_options\" requires \"stream\": true",
                          "stream_options")
    return {"stream": stream,
            "include_usage": bool(opts.get("include_usage", False))}


def parse_max_tokens(body: dict, n_ctx: int = 0) -> int:
    mt = body.get("max_completion_tokens", body.get("max_tokens"))
    if mt is None:
        return -1
    if not isinstance(mt, int) or isinstance(mt, bool) or mt < 0:
        raise bad_request("\"max_tokens\" must be a non-negative integer",
                          "max_tokens")
    if n_ctx and mt > n_ctx:
        # reference: httpserver.hpp:1212-1215
        raise bad_request("\"max_completion_tokens\" or \"max_tokens\" must "
                          "be less than or equal to the model's context "
                          "length", "max_tokens")
    return mt


# -- response rendering ------------------------------------------------------


def usage_json(task: CompletionsTask) -> dict:
    t = task.timings()
    u = {
        "prompt_tokens": t["prompt_tokens"],
        "completion_tokens": t["completion_tokens"],
        "total_tokens": t["prompt_tokens"] + t["completion_tokens"],
        "prompt_tokens_details": {"cached_tokens": t["cached_tokens"]},
        "time_to_first_token_ms": round(t["time_to_first_token_ms"], 2),
        "time_per_output_token_ms": round(t["time_per_output_token_ms"], 2),
        "prompt_tokens_per_second": round(t["prompt_tokens_per_second"], 2),
        "tokens_per_second": round(t["tokens_per_second"], 2),
    }
    if t["draft_tokens"]:
        u["draft_tokens"] = t["draft_tokens"]
        u["draft_tokens_acceptance"] = round(t["draft_tokens_acceptance"], 4)
    return u


def logprobs_json_chat(task: CompletionsTask, tokenizer) -> dict | None:
    if not task.probs:
        return None
    content = []
    for tp in task.probs:
        b = tp.text.encode("utf-8", errors="replace")
        entry = {
            "token": tp.text,
            "logprob": _lp(tp.top_probs[tp.top_ids.index(tp.token)]
                           if tp.token in tp.top_ids else tp.prob),
            "bytes": list(b),
            "top_logprobs": [
                {"token": tokenizer.decode([tid], skip_leading_space=False),
                 "logprob": _lp(p),
                 "bytes": list(tokenizer.token_bytes(tid))}
                for tid, p in zip(tp.top_ids, tp.top_probs)
            ],
        }
        content.append(entry)
    return {"content": content}


def _lp(p: float) -> float:
    import math
    return round(math.log(max(p, 1e-30)), 6)


def chat_completion_json(task: CompletionsTask, model: str, tokenizer,
                         message_extra: dict | None = None) -> dict:
    msg = {"role": "assistant", "content": task.text or None}
    if message_extra:
        msg.update(message_extra)
    choice = {
        "index": 0,
        "message": msg,
        "finish_reason": task.finish_reason,
    }
    lp = logprobs_json_chat(task, tokenizer)
    if lp is not None:
        choice["logprobs"] = lp
    return {
        "id": f"chatcmpl-{task.rid}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [choice],
        "usage": usage_json(task),
    }


def chat_chunk_json(task: CompletionsTask, model: str, delta: dict,
                    finish_reason: str | None) -> dict:
    return {
        "id": f"chatcmpl-{task.rid}",
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "delta": delta,
            "finish_reason": finish_reason,
        }],
    }


def completion_json(task: CompletionsTask, model: str) -> dict:
    return {
        "id": f"cmpl-{task.rid}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "text": task.text,
            "finish_reason": task.finish_reason,
            "logprobs": None,
        }],
        "usage": usage_json(task),
    }


def completion_chunk_json(task: CompletionsTask, model: str, text: str,
                          finish_reason: str | None) -> dict:
    return {
        "id": f"cmpl-{task.rid}",
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "text": text,
            "finish_reason": finish_reason,
            "logprobs": None,
        }],
    }


def new_request_id() -> str:
    return uuid.uuid4().hex[:24]
