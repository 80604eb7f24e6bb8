"""Tool-call extraction (reference §2.1 #16: per-template start/end marker
scanning with JSON parsing, httpserver.hpp:4461-4663; jinja lazy-grammar
path approximated by the same scanner).

Formats supported (selected by chat-template alias):
- chatml/qwen/hermes: <tool_call>{"name": ..., "arguments": {...}}</tool_call>
- llama3:            {"name": "...", "parameters": {...}}   (bare json)
- mistral:           [TOOL_CALLS][{"name": ..., "arguments": {...}}, ...]
- deepseek3:         fenced ```json blocks between tool-call markers
- generic/json:      bare {"name": ..., "arguments": {...}} object(s)

Streaming: once a start marker (or a bare-JSON trigger) is seen, content is
buffered until the call completes (the reference's lazy-grammar trigger
moment); extracted calls are emitted as OpenAI tool_calls deltas.
"""

from __future__ import annotations

import json
import re
import uuid
from dataclasses import dataclass, field


@dataclass
class ToolCall:
    name: str
    arguments: str          # JSON-encoded string (OpenAI shape)
    id: str = field(default_factory=lambda: "call_" + uuid.uuid4().hex[:12])


_FORMATS = {
    # alias -> (start markers, end markers, style)
    "chatml": (["<tool_call>"], ["</tool_call>"], "wrapped"),
    "qwen": (["<tool_call>"], ["</tool_call>"], "wrapped"),
    "llama3": (['{"name":', '{"name" :', '{ "name"'], [], "bare"),
    "llama4": (['{"name":', '{"name" :', '{ "name"'], [], "bare"),
    "mistral": (["[TOOL_CALLS]"], [], "array"),
    "deepseek3": (["<｜tool▁calls▁begin｜>", "<｜tool_calls_begin｜>"],
                  ["<｜tool▁calls▁end｜>", "<｜tool_calls_end｜>"], "fenced"),
    "granite": (["<|tool_call|>", "<tool_call>"], ["</tool_call>"], "array"),
    "generic": (['{"name":', '{ "name"', '{"tool_call":'], [], "bare"),
}


def formats_for_alias(alias: str):
    return _FORMATS.get(alias, _FORMATS["chatml"])


def tools_grammar(tools: list, alias: str):
    """(gbnf, trigger_strings) for LAZY constrained tool-call decoding
    (reference common_chat grammar_lazy + trigger words): sampling stays
    unconstrained until a start marker appears, then the call JSON is
    grammar-forced. Returns None for formats whose start marker is itself
    part of the JSON (bare/fenced) — those stay scan-only."""
    from ..grammar import GrammarError, json_schema_to_grammar
    starts, ends, style = formats_for_alias(alias)
    if style not in ("wrapped", "array"):
        return None
    schemas = []
    for t in tools:
        fn = t.get("function") or {}
        params = fn.get("parameters") or {"type": "object"}
        schemas.append({
            "type": "object",
            "properties": {"name": {"const": fn.get("name", "")},
                           "arguments": params},
            "required": ["name", "arguments"],
        })
    if not schemas:
        return None
    schema = schemas[0] if len(schemas) == 1 else {"anyOf": schemas}
    if style == "array":
        schema = {"type": "array", "items": schema}
    try:
        gbnf = json_schema_to_grammar(schema)
    except (GrammarError, ValueError, TypeError):
        return None
    return gbnf, tuple(starts)


def _parse_json_prefix(text: str):
    """Parse the first JSON value in text; returns (value, end_idx) or None
    (tolerates trailing content)."""
    dec = json.JSONDecoder()
    for i, ch in enumerate(text):
        if ch in "{[":
            try:
                v, end = dec.raw_decode(text[i:])
                return v, i + end
            except json.JSONDecodeError:
                return None
    return None


def _call_from_obj(obj) -> ToolCall | None:
    if not isinstance(obj, dict):
        return None
    if "tool_call" in obj and isinstance(obj["tool_call"], dict):
        obj = obj["tool_call"]
    name = obj.get("name")
    args = obj.get("arguments", obj.get("parameters", {}))
    if not isinstance(name, str) or not name:
        return None
    if isinstance(args, str):
        args_s = args
    else:
        args_s = json.dumps(args, ensure_ascii=False)
    return ToolCall(name=name, arguments=args_s)


class ToolCallScanner:
    """Incremental scanner. feed(text) -> (content_delta, [ToolCall...]);
    text after a start trigger is withheld until the call parses or the
    generation ends (flush)."""

    def __init__(self, alias: str = "chatml", parallel: bool = True):
        self.starts, self.ends, self.style = formats_for_alias(alias)
        self._buf = ""
        self._capturing = False
        self.parallel = parallel
        self.tool_calls: list[ToolCall] = []

    def _holdback(self) -> int:
        hb = 0
        for m in self.starts:
            for k in range(min(len(m) - 1, len(self._buf)), 0, -1):
                if self._buf.endswith(m[:k]):
                    hb = max(hb, k)
                    break
        return hb

    def _find_start(self) -> tuple[int, str] | None:
        best = None
        for m in self.starts:
            i = self._buf.find(m)
            if i != -1 and (best is None or i < best[0]):
                best = (i, m)
        return best

    def feed(self, text: str) -> tuple[str, list[ToolCall]]:
        self._buf += text
        out_content = []
        out_calls: list[ToolCall] = []
        while True:
            if not self._capturing:
                if (self.tool_calls or out_calls) and not self.parallel:
                    break  # single-call mode: ignore further triggers
                hit = self._find_start()
                if hit is None:
                    emit = len(self._buf) - self._holdback()
                    out_content.append(self._buf[:emit])
                    self._buf = self._buf[emit:]
                    break
                i, marker = hit
                out_content.append(self._buf[:i])
                if self.style == "bare":
                    # keep the JSON itself in the buffer
                    self._buf = self._buf[i:]
                else:
                    self._buf = self._buf[i + len(marker):]
                self._capturing = True
            else:
                done, calls, passthrough, rest = self._try_extract()
                if not done:
                    break
                out_calls.extend(calls)
                out_content.append(passthrough)
                self._capturing = False
                self._buf = rest
        self.tool_calls.extend(out_calls)
        return "".join(out_content), out_calls

    def _try_extract(self) -> tuple[bool, list[ToolCall], str, str]:
        """Returns (done, calls, content_passthrough, rest_of_buffer)."""
        buf = self._buf
        if self.style == "fenced":
            m = re.search(r"```json\s*(.*?)```", buf, re.S)
            if not m:
                return False, [], "", buf
            parsed = _parse_json_prefix(m.group(1))
            rest = buf[m.end():]
            for em in self.ends:
                j = rest.find(em)
                if j != -1:
                    rest = rest[j + len(em):]
                    break
            if parsed:
                c = _call_from_obj(parsed[0])
                return True, [c] if c else [], "", rest
            return True, [], "", rest
        parsed = _parse_json_prefix(buf)
        if parsed is None:
            return False, [], "", buf
        obj, end = parsed
        rest = buf[end:]
        for em in self.ends:
            j = rest.find(em)
            if j != -1:
                rest = rest[j + len(em):]
                break
        calls = []
        if isinstance(obj, list):
            for o in obj:
                c = _call_from_obj(o)
                if c:
                    calls.append(c)
        else:
            c = _call_from_obj(obj)
            if c:
                calls.append(c)
        if not calls and self.style == "bare":
            # bare JSON that wasn't a tool call: pass it through as content
            return True, [], buf[:end], rest
        return True, calls, "", rest

    def flush(self) -> str:
        """Generation ended: unparsed captured text returns as content."""
        out, self._buf = self._buf, ""
        self._capturing = False
        return out


def migrate_functions(body: dict) -> tuple[list | None, object]:
    """OpenAI legacy functions/function_call -> tools/tool_choice
    (httpserver.hpp:1260-1337)."""
    from .protocol import bad_request
    tools = body.get("tools")
    if tools is not None and not isinstance(tools, list):
        raise bad_request("\"tools\" must be an array", "tools")
    if tools is None and body.get("functions") is not None:
        if not isinstance(body["functions"], list):
            raise bad_request("\"functions\" must be an array", "functions")
        tools = [{"type": "function", "function": f}
                 for f in body["functions"]]
    tool_choice = body.get("tool_choice")
    if tool_choice is not None \
            and not isinstance(tool_choice, (str, dict)):
        raise bad_request("\"tool_choice\" must be a string or an object",
                          "tool_choice")
    if tool_choice is None and body.get("function_call") is not None:
        fc = body["function_call"]
        if not isinstance(fc, (str, dict)):
            raise bad_request("\"function_call\" must be a string or an "
                              "object", "function_call")
        if isinstance(fc, dict) and "name" in fc:
            tool_choice = {"type": "function",
                           "function": {"name": fc["name"]}}
        else:
            tool_choice = fc
    return tools, tool_choice if tool_choice is not None else "auto"
