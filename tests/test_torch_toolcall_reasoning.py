"""The port's reasoning splitter and tool-call scanner
(llama_box_tpu_torch/server/reasoning.py, toolcall.py) and its token
bucket (utils/tokenbucket.py) against the JAX package's, on the streams of
tests/test_toolcall_reasoning.py, each fed whole and in ragged chunks.
Every delta, the flushed tail, and each call's name and arguments must be
equal (a call's id is random on both sides); no tolerance applies."""

import pytest

from llama_box_tpu.server import reasoning as jr
from llama_box_tpu.server import toolcall as jt
from llama_box_tpu.utils.tokenbucket import RatelimitTokenBucket as JBucket
from llama_box_tpu_torch.server import reasoning as tr
from llama_box_tpu_torch.server import toolcall as tt
from llama_box_tpu_torch.utils.tokenbucket import RatelimitTokenBucket

REASONING = {
    "basic": (("<think>", "</think>"), {},
              "<think>let me think</think>the answer"),
    "force_open": (("<think>", "</think>"), dict(force_open=True),
                   "already thinking</think>done"),
    "in_content": (("<think>", "</think>"), dict(in_content=True),
                   "<think>x</think>y"),
    "unclosed": (("<think>", "</think>"), {}, "<think>never ends"),
    "gpt_oss": (tr.GPT_OSS_PAIR, {},
                "<|channel|>analysis<|message|>think think<|end|>"
                "<|start|>assistant<|channel|>final<|message|>Hello!"),
}

TOOLS = {
    "chatml": ("chatml", True,
               'I will check the weather. <tool_call>{"name": "get_weather",'
               ' "arguments": {"city": "Paris"}}</tool_call> done'),
    "llama3": ("llama3", True, '{"name": "sq", "parameters": {"n": 4}}'),
    "mistral": ("mistral", True,
                '[TOOL_CALLS][{"name": "a", "arguments": {}}, '
                '{"name": "b", "arguments": {"k": "v"}}]'),
    "parallel": ("qwen", True,
                 '<tool_call>{"name": "a", "arguments": {}}</tool_call>'
                 '<tool_call>{"name": "b", "arguments": {}}</tool_call>'),
    "not_parallel": ("qwen", False,
                     '<tool_call>{"name": "a", "arguments": {}}</tool_call>'
                     '<tool_call>{"name": "b", "arguments": {}}</tool_call>'),
    "unfinished": ("chatml", True, '<tool_call>{"name": "broken"'),
    "deepseek3": ("deepseek3", True,
                  "<｜tool▁calls▁begin｜>```json\n{\"name\": \"w\", "
                  "\"arguments\": {\"q\": 1}}\n```<｜tool▁calls▁end｜>"),
    "granite": ("granite", True,
                '<|tool_call|>[{"name": "g", "arguments": {"a": [1, 2]}}]'),
}


def _chunks(text, size):
    return [text] if size is None else [text[i:i + size]
                                        for i in range(0, len(text), size)]


def _run_reasoning(mod, pair, kw, chunks):
    r = mod.ReasoningSplitter(*pair, **kw)
    out = [r.feed(c) for c in chunks]
    out.append(r.flush())
    return out, r.content_text, r.reasoning_text


def _run_scanner(mod, alias, parallel, chunks):
    s = mod.ToolCallScanner(alias, parallel=parallel)
    out = []
    for c in chunks:
        text, calls = s.feed(c)
        out.append((text, [(x.name, x.arguments) for x in calls]))
    out.append(s.flush())
    return out, [(x.name, x.arguments) for x in s.tool_calls]


@pytest.mark.parametrize("size", [None, 1, 7], ids=["whole", "c1", "c7"])
@pytest.mark.parametrize("case", list(REASONING))
def test_reasoning_splitter_as_jax(case, size):
    pair, kw, text = REASONING[case]
    chunks = _chunks(text, size)
    assert _run_reasoning(tr, pair, kw, chunks) \
        == _run_reasoning(jr, pair, kw, chunks)


@pytest.mark.parametrize("template", [
    "{{...}}</think>{{...}}", "plain template", None,
    "{%...%}<|start|>assistant<|channel|>final<|message|>",
    "<|channel|>x"])
def test_detect_markers_as_jax(template):
    assert tr.detect_reasoning_markers(template) \
        == jr.detect_reasoning_markers(template)


@pytest.mark.parametrize("size", [None, 1, 7], ids=["whole", "c1", "c7"])
@pytest.mark.parametrize("case", list(TOOLS))
def test_tool_call_scanner_as_jax(case, size):
    alias, parallel, text = TOOLS[case]
    chunks = _chunks(text, size)
    got = _run_scanner(tt, alias, parallel, chunks)
    assert got == _run_scanner(jt, alias, parallel, chunks)
    if case in ("chatml", "llama3", "mistral", "parallel"):
        assert got[1], "no call extracted"


@pytest.mark.parametrize("body", [
    {"functions": [{"name": "f", "parameters": {}}],
     "function_call": {"name": "f"}},
    {"tools": [{"type": "function"}]},
    {"tools": [{"type": "function", "function": {"name": "g"}}],
     "tool_choice": "none"},
    {},
])
def test_migrate_functions_as_jax(body):
    assert tt.migrate_functions(dict(body)) == jt.migrate_functions(dict(body))


@pytest.mark.parametrize("alias", ["chatml", "qwen", "mistral", "granite",
                                   "llama3", "deepseek3"])
def test_tools_grammar_as_jax(alias):
    tools = [{"type": "function", "function": {
        "name": "get_weather",
        "parameters": {"type": "object",
                       "properties": {"city": {"type": "string"}},
                       "required": ["city"]}}}]
    assert tt.tools_grammar(tools, alias) == jt.tools_grammar(tools, alias)


def test_rate_bucket_as_jax(monkeypatch):
    """The same acquisitions on the same clock readings succeed alike."""
    clock = {"t": 100.0}
    for mod in ("llama_box_tpu.utils.tokenbucket",
                "llama_box_tpu_torch.utils.tokenbucket"):
        monkeypatch.setattr(f"{mod}.time.monotonic", lambda: clock["t"])
    a, b = RatelimitTokenBucket(capacity=3, rate=2.0), JBucket(3, 2.0)
    seen = []
    for step in range(40):
        clock["t"] += 0.13 * (step % 5)
        seen.append((a.try_acquire(1), b.try_acquire(1)))
    assert all(x == y for x, y in seen)
    assert any(x for x, _ in seen) and not all(x for x, _ in seen)
