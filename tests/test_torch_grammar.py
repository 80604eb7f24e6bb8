"""The port's grammar engine (llama_box_tpu_torch/grammar.py and its native
core, llama_box_tpu_torch/native/grammar_core.cpp built by gguf/native.py)
against the JAX package's grammar.py.

On the GBNF and JSON-schema cases of tests/test_grammar.py and
tests/test_grammar_engine.py: json_schema_to_grammar gives the same GBNF
text, and the port's native matcher, the port's pure-Python matcher and
the JAX matcher accept and reject the same byte strings, with the same
completed / must_stop. The native core is held against the Python matcher
on random piece streams (tests/test_native.py's grammar cases). Exact
comparisons: no tolerance applies."""

import json

import numpy as np
import pytest

from llama_box_tpu import grammar as jgram
from llama_box_tpu_torch import grammar as tgram
from llama_box_tpu_torch.gguf import native

# (gbnf, text, complete): the text's accept (and then completed, when
# `complete`) is compared across the three matchers
GBNF_CASES = [
    ('root ::= "yes" | "no"', "yes", True),
    ('root ::= "yes" | "no"', "no", True),
    ('root ::= "yes" | "no"', "maybe", False),
    ('root ::= "yes" | "no"', "y", True),
    ('root ::= "yes" | "no"', "y", False),
    ('root ::= [a-z]+ [0-9]*', "abc123", True),
    ('root ::= [a-z]+ [0-9]*', "123", False),
    ('root ::= [a-z]+ [0-9]*', "abC", False),
    ('root ::= "<" [^>]* ">"', "<hello world>", True),
    ('root ::= "<" [^>]* ">"', "<a>b", False),
    ('root ::= ("a" | "b") ("c" "d")+', "bcdcd", True),
    ('root ::= ("a" | "b") ("c" "d")+', "ab", False),
    ('root ::= expr\nexpr ::= term ("+" term)*\n'
     'term ::= [0-9]+ | "(" expr ")"', "(1+2)+(3+(4+5))", True),
    ('root ::= expr\nexpr ::= term ("+" term)*\n'
     'term ::= [0-9]+ | "(" expr ")"', "1+", True),
    ('root ::= [0-9]{2,4}', "1", True),
    ('root ::= [0-9]{2,4}', "1234", True),
    ('root ::= [0-9]{2,4}', "12345", False),
    ('root ::= .+', "日本語", True),
    ('root ::= [\\u00e0-\\uffff]+', "héllo", False),
    ('root ::= "ok" [0-9]*', "ok", True),
    (jgram.JSON_OBJECT_GRAMMAR, '{"a": 1, "b": [1, 2, "x"], "c": {"d": null}}',
     True),
    (jgram.JSON_OBJECT_GRAMMAR, "[1,2]", False),
    ('root ::= ("a" | "b")+', "abba", True),
    ('root ::= "a" "b"', "ab", True),
    ('root ::= [a-d]{4}', "abcd", True),
    ('root ::= "z"+', "zzz", True),
]

SCHEMAS = [
    ({"type": "object",
      "properties": {"name": {"type": "string"}, "age": {"type": "integer"}},
      "required": ["name", "age"]},
     [{"name": "bob", "age": 3}, {"name": "bob"}, {"age": 3, "name": "bob"}]),
    ({"type": "object",
      "properties": {"a": {"type": "integer"}, "b": {"type": "string"}},
      "required": ["a"]},
     [{"a": 1}, {"a": 1, "b": "x"}, {"b": "x"}]),
    ({"type": "object",
      "properties": {"color": {"enum": ["red", "green"]},
                     "tag": {"const": "v1"},
                     "nums": {"type": "array", "items": {"type": "integer"},
                              "minItems": 1}},
      "required": ["color", "tag", "nums"]},
     [{"color": "red", "tag": "v1", "nums": [1, 2]},
      {"color": "blue", "tag": "v1", "nums": [1]},
      {"color": "red", "tag": "v1", "nums": []}]),
    ({"$defs": {"pt": {"type": "object", "properties": {"x": {"type": "number"}},
                       "required": ["x"]}},
      "anyOf": [{"$ref": "#/$defs/pt"}, {"type": "null"}]},
     [{"x": 1.5}, None, "nope"]),
    ({"type": "string"}, ["hello \"quoted\" \n line", "日本語", 3]),
    ({"type": "object", "properties": {"x": {"type": "integer"}},
      "required": ["x"]},
     [{"x": 42}, {"x": "42"}]),
    ({"type": "object",
      "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"},
                     "mode": {"enum": ["fast", "slow"]}},
      "required": ["ok", "n", "mode"]},
     [{"ok": True, "n": -3, "mode": "slow"}, {"ok": 1, "n": 2, "mode": "x"}]),
]


def _accepts(g, data: bytes, complete: bool):
    g = g.copy()
    ok = g.accept_bytes(data)
    if not ok:
        return False, None, None
    return True, g.completed if complete else None, g.must_stop


def _three(gbnf):
    return (tgram.Grammar(gbnf), tgram.Grammar(gbnf, native=False),
            jgram.Grammar(gbnf))


@pytest.mark.parametrize("gbnf,text,complete", GBNF_CASES)
def test_gbnf_accepts_as_jax(gbnf, text, complete):
    gn, gp, gj = _three(gbnf)
    assert gn._nst is not None and gp._nst is None
    want = _accepts(gj, text.encode(), complete)
    assert _accepts(gn, text.encode(), complete) == want
    assert _accepts(gp, text.encode(), complete) == want


def test_byte_by_byte_partials_as_jax():
    """Multi-byte characters fed one byte at a time are held, not
    rejected, by every matcher."""
    raw = "日本語".encode()
    for g in _three('root ::= .+'):
        for i in range(len(raw)):
            assert g.accept_bytes(raw[i:i + 1])
        assert g.completed


@pytest.mark.parametrize("bad", ['root ::= foo', 'start ::= "x"',
                                 "root == broken"])
def test_errors_as_jax(bad):
    with pytest.raises(jgram.GrammarError):
        jgram.Grammar(bad)
    with pytest.raises(tgram.GrammarError):
        tgram.Grammar(bad)


@pytest.mark.parametrize("case", range(len(SCHEMAS)))
def test_json_schema_gbnf_and_accepts_as_jax(case):
    schema, objs = SCHEMAS[case]
    gbnf = tgram.json_schema_to_grammar(schema)
    assert gbnf == jgram.json_schema_to_grammar(schema)
    gn, gp, gj = _three(gbnf)
    for obj in objs:
        data = json.dumps(obj, ensure_ascii=False).encode()
        want = _accepts(gj, data, True)
        assert _accepts(gn, data, True) == want, obj
        assert _accepts(gp, data, True) == want, obj


def test_json_object_grammar_is_jax_text():
    assert tgram.JSON_OBJECT_GRAMMAR == jgram.JSON_OBJECT_GRAMMAR


@pytest.mark.parametrize("gbnf", [
    'root ::= "a" [b-d]+ "e"?',
    'root ::= obj\nobj ::= "{" pair ("," pair)* "}"\n'
    'pair ::= [a-z]+ ":" [0-9]+',
    'root ::= ("x" | "yy" | zed)* "!"\nzed ::= "z" root',
    'root ::= [^a-m]{2,4} "end"',
    'root ::= "\\u00e9" [\\u00e0-\\u00ff]* "."',
])
def test_native_core_matches_the_python_matcher(gbnf):
    """tests/test_native.py's grammar cases on the port's core: random
    piece streams (multi-byte UTF-8 split across pieces included), the
    tentative accepts_token, completed / must_stop, copies and the batched
    filter_pieces agree with the pure-Python matcher at every step."""
    rng = np.random.default_rng(0)
    probes = [b"a", b"bc", b"e", b"!", b"x", b"z", b"end",
              "é".encode(), "à.".encode(), b"{ab:12}", b"\xc3", b"\xa9",
              b"\xff", b"no"]
    gn, gp = tgram.Grammar(gbnf), tgram.Grammar(gbnf, native=False)
    for step in range(60):
        assert gn.completed == gp.completed, step
        assert gn.must_stop == gp.must_stop, step
        assert gn.filter_pieces(probes) \
            == [gp.accepts_token(p) for p in probes], step
        piece = probes[int(rng.integers(len(probes)))]
        ok = gn.accepts_token(piece)
        assert ok == gp.accepts_token(piece), (step, piece)
        if ok:
            gn2, gp2 = gn.copy(), gp.copy()
            assert gn2.accept_bytes(piece) and gp2.accept_bytes(piece)
            gn, gp = gn2, gp2


def test_core_is_built_into_the_port_build_dir():
    """The core's library sits under build/torch_native, named by a hash of
    the port's own source and the flags."""
    path = native.build()
    assert path.parent.parts[-2:] == ("build", "torch_native")
    assert path.name.startswith("grammar_core-") and path.exists()
    assert native.SRC.parts[-3:] == ("llama_box_tpu_torch", "native",
                                     "grammar_core.cpp")


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a source the compiler refuses raises at the first
    grammar, and so does a missing compiler."""
    bad = tmp_path / "grammar_core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        tgram.Grammar('root ::= "a"')
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()
