"""GBNF grammar engine + JSON-schema→GBNF conversion.

Reimplements the observable semantics of llama.cpp's grammar sampler that
the reference exposes via the "grammar"/"json_schema"/"response_format"
request fields (SURVEY.md §2.1 #14): a GBNF context-free grammar matched
incrementally by a pushdown automaton over Unicode codepoints, used to mask
the token distribution during sampling.

Design: the automaton lives on the host; the engine samples
grammar-constrained slots host-side from device logits (sampling.HostSampler)
so the device programs never block on grammar state. Token masks over the
candidate set are cached per automaton state.

(Counterpart of llama_box_tpu/grammar.py.) The byte-level matcher runs in
the port's native core (native/grammar_core.cpp, built at first use by
gguf/native.py; a failed build raises). The pure-Python matcher below is
its plain version: `Grammar(..., native=False)`, which the tests hold the
core against.

Grammar format: https://github.com/ggml-org/llama.cpp/blob/master/grammars/
(rule ::= alternates; literals "..", classes [a-z0-9], ( ) groups, | alts,
* + ? {m,n} repetition, # comments).
"""

from __future__ import annotations

import json
import re
from typing import Iterable


# -- compiled form -----------------------------------------------------------
# rules: dict[rid] -> list of alternates; alternate = tuple of items
# item = ("char", ranges, negated) | ("ref", rid)
# ranges = tuple of (lo, hi) codepoint ranges


class GrammarError(ValueError):
    pass


class _Parser:
    """GBNF text -> compiled rules (desugars groups/repetition into aux
    rules, like llama.cpp's grammar_parser)."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.symbol_ids: dict[str, int] = {}
        self.rules: dict[int, list[tuple]] = {}

    # lexing helpers
    def _ws(self, newlines: bool = False) -> None:
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#":
                while self.pos < len(self.text) and self.text[self.pos] != "\n":
                    self.pos += 1
            elif c in " \t" or (newlines and c in "\r\n"):
                self.pos += 1
            elif c == "\\" and self.pos + 1 < len(self.text) \
                    and self.text[self.pos + 1] in "\r\n":
                self.pos += 2
            else:
                return

    def _sym_id(self, name: str) -> int:
        if name not in self.symbol_ids:
            self.symbol_ids[name] = len(self.symbol_ids)
        return self.symbol_ids[name]

    def _aux_id(self, base: str) -> int:
        n = 0
        while f"{base}_{n}" in self.symbol_ids:
            n += 1
        return self._sym_id(f"{base}_{n}")

    def parse(self) -> tuple[dict[int, list[tuple]], int]:
        self._ws(newlines=True)
        while self.pos < len(self.text):
            self._parse_rule()
            self._ws(newlines=True)
        if "root" not in self.symbol_ids:
            raise GrammarError("grammar has no 'root' rule")
        root = self.symbol_ids["root"]
        for name, rid in self.symbol_ids.items():
            if rid not in self.rules:
                raise GrammarError(f"undefined rule reference '{name}'")
        return self.rules, root

    def _parse_rule(self) -> None:
        name = self._parse_name()
        self._ws()
        if self.text[self.pos:self.pos + 3] != "::=":
            raise GrammarError(f"expecting ::= at {self.pos}")
        self.pos += 3
        self._ws()
        rid = self._sym_id(name)
        self.rules[rid] = self._parse_alternates(name)
        if self.pos < len(self.text) and self.text[self.pos] in "\r\n":
            while self.pos < len(self.text) and self.text[self.pos] in "\r\n":
                self.pos += 1

    def _parse_name(self) -> str:
        m = re.match(r"[a-zA-Z][a-zA-Z0-9_-]*", self.text[self.pos:])
        if not m:
            raise GrammarError(f"expecting rule name at {self.pos}")
        self.pos += m.end()
        return m.group(0)

    def _parse_alternates(self, base: str) -> list[tuple]:
        alts = [self._parse_sequence(base)]
        self._ws()
        while self.pos < len(self.text) and self.text[self.pos] == "|":
            self.pos += 1
            self._ws(newlines=True)
            alts.append(self._parse_sequence(base))
            self._ws()
        return alts

    def _parse_sequence(self, base: str) -> tuple:
        items: list[tuple] = []
        self._ws()
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == '"':
                for cp in self._parse_literal():
                    items.append(("char", ((cp, cp),), False))
            elif c == "[":
                items.append(self._parse_class())
            elif c == "(":
                self.pos += 1
                aux = self._aux_id(base)
                self.rules[aux] = self._parse_alternates(base)
                self._ws()
                if self.pos >= len(self.text) or self.text[self.pos] != ")":
                    raise GrammarError("expecting )")
                self.pos += 1
                items.append(("ref", aux))
            elif c == "." :
                self.pos += 1
                items.append(("char", ((0, 0x10FFFF),), False))
            elif re.match(r"[a-zA-Z]", c):
                items.append(("ref", self._sym_id(self._parse_name())))
            else:
                break
            # repetition suffix
            self._ws()
            if self.pos < len(self.text) and self.text[self.pos] in "*+?{":
                items[-1] = self._apply_repeat(base, items[-1])
            self._ws()
        return tuple(items)

    def _apply_repeat(self, base: str, item: tuple) -> tuple:
        c = self.text[self.pos]
        if c == "{":
            m = re.match(r"\{(\d*)(,?)(\d*)\}", self.text[self.pos:])
            if not m:
                raise GrammarError("bad {m,n}")
            self.pos += m.end()
            lo = int(m.group(1) or 0)
            hi = int(m.group(3)) if m.group(3) else (
                lo if not m.group(2) else -1)
        else:
            self.pos += 1
            lo, hi = {"*": (0, -1), "+": (1, -1), "?": (0, 1)}[c]
        aux = self._aux_id(base)
        # R -> item{lo,hi}: build alts
        if hi == -1:
            # lo..inf: a prefix of `lo` items followed by a star rule
            star = self._aux_id(base)
            self.rules[star] = [(item, ("ref", star)), ()]
            self.rules[aux] = [tuple([item] * lo + [("ref", star)])]
        else:
            alts = []
            for n in range(lo, hi + 1):
                alts.append(tuple([item] * n))
            # longest-first so greedy matching prefers more repeats
            alts.sort(key=len, reverse=True)
            self.rules[aux] = alts
        return ("ref", aux)

    def _parse_literal(self) -> list[int]:
        assert self.text[self.pos] == '"'
        self.pos += 1
        cps = []
        while self.pos < len(self.text) and self.text[self.pos] != '"':
            cps.append(self._parse_char())
        if self.pos >= len(self.text):
            raise GrammarError("unterminated literal")
        self.pos += 1
        return cps

    def _parse_char(self) -> int:
        c = self.text[self.pos]
        if c == "\\":
            self.pos += 1
            e = self.text[self.pos]
            self.pos += 1
            simple = {"n": 10, "r": 13, "t": 9, "\\": 92, '"': 34, "[": 91,
                      "]": 93, "-": 45, "^": 94}
            if e in simple:
                return simple[e]
            if e == "x":
                v = int(self.text[self.pos:self.pos + 2], 16)
                self.pos += 2
                return v
            if e == "u":
                v = int(self.text[self.pos:self.pos + 4], 16)
                self.pos += 4
                return v
            if e == "U":
                v = int(self.text[self.pos:self.pos + 8], 16)
                self.pos += 8
                return v
            raise GrammarError(f"unknown escape \\{e}")
        self.pos += 1
        return ord(c)

    def _parse_class(self) -> tuple:
        assert self.text[self.pos] == "["
        self.pos += 1
        negated = False
        if self.pos < len(self.text) and self.text[self.pos] == "^":
            negated = True
            self.pos += 1
        ranges: list[tuple[int, int]] = []
        while self.pos < len(self.text) and self.text[self.pos] != "]":
            lo = self._parse_char()
            if (self.text[self.pos] == "-"
                    and self.text[self.pos + 1] != "]"):
                self.pos += 1
                hi = self._parse_char()
            else:
                hi = lo
            ranges.append((lo, hi))
        if self.pos >= len(self.text):
            raise GrammarError("unterminated char class")
        self.pos += 1
        return ("char", tuple(ranges), negated)


def _char_match(item: tuple, cp: int) -> bool:
    _, ranges, negated = item
    hit = any(lo <= cp <= hi for lo, hi in ranges)
    return hit != negated


def _char_match_range(item: tuple, lo: int, hi: int) -> bool:
    """Could ANY codepoint in [lo, hi] match this matcher? Used for partial
    UTF-8 sequences split across token boundaries (llama.cpp partial_utf8)."""
    _, ranges, negated = item
    if not negated:
        return any(rlo <= hi and lo <= rhi for rlo, rhi in ranges)
    # negated: true iff [lo, hi] is NOT fully covered by the ranges
    cur = lo
    for rlo, rhi in sorted(ranges):
        if rlo > cur:
            break
        cur = max(cur, rhi + 1)
        if cur > hi:
            return False
    return True


def _utf8_partial_range(tail: bytes, ln: int) -> tuple[int, int]:
    """Codepoint range reachable by completing the partial sequence `tail`
    (first byte says it has `ln` bytes total)."""
    b0 = tail[0]
    v = b0 & {2: 0x1F, 3: 0x0F, 4: 0x07}[ln]
    for b in tail[1:]:
        v = (v << 6) | (b & 0x3F)
    rem = ln - len(tail)
    lo = v << (6 * rem)
    hi = ((v + 1) << (6 * rem)) - 1
    # overlong encodings are invalid: clamp to the minimum codepoint that a
    # sequence of this length can legally encode
    min_cp = {2: 0x80, 3: 0x800, 4: 0x10000}[ln]
    return max(lo, min_cp), min(hi, 0x10FFFF)


class _NativeGramHandle:
    """Owns a native grammar handle (shared across Grammar copies)."""

    def __init__(self, lib, handle):
        self.lib = lib
        self.h = handle

    def __del__(self):  # noqa: D105
        try:
            self.lib.lbox_gram_free(self.h)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class _NativeState:
    """Owns a native matcher-state handle."""

    def __init__(self, lib, handle):
        self.lib = lib
        self.h = handle

    def __del__(self):  # noqa: D105
        try:
            self.lib.lbox_gram_state_free(self.h)
        except Exception:  # noqa: BLE001
            pass


def _u8(data: bytes):
    """A ctypes uint8 array holding `data` (at least one byte), copied in
    one block."""
    import ctypes
    return (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(
        data or b"\0")


def _serialize_rules(rules: dict, n_rules: int):
    """Rules dict -> the int32 stream grammar_core.cpp parses."""
    out = [n_rules]
    for r in range(n_rules):
        alts = rules[r]
        out.append(len(alts))
        for seq in alts:
            out.append(len(seq))
            for item in seq:
                if item[0] == "ref":
                    out += [0, item[1]]
                else:
                    _, ranges, neg = item
                    out += [1, int(neg), len(ranges)]
                    for lo, hi in ranges:
                        out += [lo, hi]
    import numpy as np
    return np.asarray(out, np.int32)


class Grammar:
    """Incremental pushdown matcher. State = set of stacks; each stack is a
    tuple of (rule_id, alt_idx, item_idx) frames, top = last, normalized so
    the top frame's next item is a char matcher.

    With native=True (the default) the byte-level API (accept_bytes /
    accepts_token / completed / must_stop / filter_pieces) runs in the
    native core (native/grammar_core.cpp) — same semantics, ~100x less
    per-candidate overhead on the constrained-sampling scan; its build
    happens at the first such grammar and raises on failure. native=False
    is the pure-Python matcher, the core's plain version."""

    def __init__(self, gbnf: str | None = None, rules=None, root=None,
                 native: bool = True):
        if gbnf is not None:
            rules, root = _Parser(gbnf).parse()
        self.rules = rules
        self.root = root
        self.stacks: frozenset = self._normalize(((root, 0, 0),))
        for alt in range(1, len(self.rules[root])):
            self.stacks |= self._normalize(((root, alt, 0),))
        self._pending = b""  # partial UTF-8 from token boundaries
        self._ng = self._nst = None
        if native:
            import ctypes

            from .gguf.native import grammar_lib
            lib = grammar_lib()
            buf = _serialize_rules(self.rules, len(self.rules))
            h = lib.lbox_gram_new(
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                buf.size, int(self.root))
            if not h:
                raise GrammarError("the native grammar core refused the "
                                   "compiled rules")
            self._ng = _NativeGramHandle(lib, h)
            self._nst = _NativeState(lib, lib.lbox_gram_state_new(h))

    # -- state manipulation --------------------------------------------------

    def _normalize(self, stack: tuple, depth: int = 0) -> frozenset:
        """Expand refs / pop completed frames until the top item is a char
        matcher (or the stack is fully consumed -> empty stack = accept)."""
        if depth > 256:
            raise GrammarError("grammar too deeply nested")
        while True:
            if not stack:
                return frozenset({stack})
            rid, alt, idx = stack[-1]
            seq = self.rules[rid][alt]
            if idx >= len(seq):
                stack = stack[:-1]
                if stack:
                    prid, palt, pidx = stack[-1]
                    stack = stack[:-1] + ((prid, palt, pidx + 1),)
                continue
            item = seq[idx]
            if item[0] == "char":
                return frozenset({stack})
            # ref: branch over alternates of the target rule
            out = set()
            tgt = item[1]
            for a in range(len(self.rules[tgt])):
                out |= self._normalize(stack + ((tgt, a, 0),), depth + 1)
            return frozenset(out)

    def _advance(self, stacks: Iterable[tuple], cp: int) -> frozenset:
        out = set()
        for stack in stacks:
            if not stack:
                continue  # already complete; cannot consume more
            rid, alt, idx = stack[-1]
            item = self.rules[rid][alt][idx]
            if _char_match(item, cp):
                ns = stack[:-1] + ((rid, alt, idx + 1),)
                out |= self._normalize(ns)
        return frozenset(out)

    # -- public API ----------------------------------------------------------

    def copy(self) -> "Grammar":
        g = Grammar.__new__(Grammar)
        g.rules = self.rules
        g.root = self.root
        g.stacks = self.stacks
        g._pending = self._pending
        g._ng = self._ng
        g._nst = None
        if self._ng is not None and self._nst is not None:
            g._nst = _NativeState(
                self._ng.lib,
                self._ng.lib.lbox_gram_state_copy(self._nst.h))
        return g

    def accept_cp(self, cp: int) -> bool:
        if self._nst is not None:
            return self.accept_bytes(chr(cp).encode("utf-8"))
        ns = self._advance(self.stacks, cp)
        if not ns:
            return False
        self.stacks = ns
        return True

    def accept_bytes(self, data: bytes) -> bool:
        """Advance over a token's bytes (UTF-8). Partial sequences at the end
        are held across calls and accepted only if SOME completion could
        match a pending char matcher (llama.cpp partial_utf8 semantics)."""
        if self._nst is not None:
            import ctypes
            buf = _u8(data)
            return bool(self._ng.lib.lbox_gram_accept_bytes(
                self._ng.h, self._nst.h, buf, len(data)))
        buf = self._pending + data
        i, n = 0, len(buf)
        while i < n:
            b0 = buf[i]
            if b0 < 0x80:
                ln = 1
            elif b0 < 0xC0:
                return False  # stray continuation byte
            elif b0 < 0xE0:
                ln = 2
            elif b0 < 0xF0:
                ln = 3
            elif b0 < 0xF8:
                ln = 4
            else:
                return False
            if i + ln > n:
                tail = buf[i:]
                if any(not (0x80 <= b < 0xC0) for b in tail[1:]):
                    return False
                lo, hi = _utf8_partial_range(tail, ln)
                ok = any(s and _char_match_range(self._top_item(s), lo, hi)
                         for s in self.stacks)
                if not ok:
                    return False
                break
            try:
                cp = buf[i:i + ln].decode("utf-8")
            except UnicodeDecodeError:
                return False
            if not self.accept_cp(ord(cp)):
                return False
            i += ln
        self._pending = buf[i:]
        return True

    def _top_item(self, stack: tuple) -> tuple:
        rid, alt, idx = stack[-1]
        return self.rules[rid][alt][idx]

    def accepts_token(self, piece: bytes) -> bool:
        """Tentative check: would this token's bytes be accepted?"""
        if self._nst is not None:
            import ctypes
            buf = _u8(piece)
            return bool(self._ng.lib.lbox_gram_try_bytes(
                self._ng.h, self._nst.h, buf, len(piece)))
        return self.copy().accept_bytes(piece)

    def filter_pieces(self, pieces: list) -> list:
        """Batched accepts_token over candidate byte strings — ONE
        native crossing for the whole candidate list (the constrained
        sampler's full-vocab fallback scan)."""
        if self._nst is None:
            return [self.accepts_token(p) for p in pieces]
        import ctypes

        import numpy as np
        n = len(pieces)
        offs = np.zeros(n + 1, np.int64)
        offs[1:] = np.cumsum(np.fromiter(map(len, pieces), np.int64, n))
        out = np.zeros(max(n, 1), np.uint8)
        self._ng.lib.lbox_gram_filter(
            self._ng.h, self._nst.h, _u8(b"".join(pieces)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out[:n].astype(bool).tolist()

    @property
    def completed(self) -> bool:
        """True if the grammar can stop here (some stack fully consumed)."""
        if self._nst is not None:
            return bool(self._ng.lib.lbox_gram_completed(self._nst.h))
        return any(not s for s in self.stacks)

    @property
    def must_stop(self) -> bool:
        """True if NO continuation is possible (only complete stacks left)."""
        if self._nst is not None:
            return bool(self._ng.lib.lbox_gram_must_stop(self._nst.h))
        return all(not s for s in self.stacks)

    def state_key(self) -> tuple:
        return (self.stacks, self._pending)


# -- JSON schema -> GBNF -----------------------------------------------------

_SPACE = 'space ::= " "?\n'
_PRIMS = {
    "boolean": 'boolean ::= ("true" | "false") space\n',
    "null": 'null ::= "null" space\n',
    "number": ('number ::= ("-"? ([0-9] | [1-9] [0-9]*)) ("." [0-9]+)? '
               '([eE] [-+]? [0-9]+)? space\n'),
    "integer": 'integer ::= ("-"? ([0-9] | [1-9] [0-9]*)) space\n',
    "string": ('string ::= "\\"" ( [^"\\\\\\x00-\\x1f] | "\\\\" '
               '(["\\\\bfnrt] | "u" [0-9a-fA-F]{4}) )* "\\"" space\n'),
    "value": None,  # defined on demand
    "object": None,
    "array": None,
}
_VALUE_RULES = (
    'value ::= object | array | string | number | boolean | null\n'
    'object ::= "{" space ( string ":" space value ("," space string ":" '
    'space value)* )? "}" space\n'
    'array ::= "[" space ( value ("," space value)* )? "]" space\n'
)


class _SchemaConverter:
    """JSON-schema subset -> GBNF (semantics of llama.cpp
    json_schema_to_grammar: type/enum/const/properties/required/items/
    oneOf/anyOf/$ref-local/additionalProperties)."""

    def __init__(self):
        self.rules: dict[str, str] = {}
        self.n = 0
        self.defs: dict[str, dict] = {}

    def _add(self, name: str, body: str) -> str:
        if name in self.rules and self.rules[name] != f"{name} ::= {body}\n":
            name = f"{name}{self.n}"
            self.n += 1
        self.rules[name] = f"{name} ::= {body}\n"
        return name

    def _need_prims(self, *names):
        for nm in names:
            if nm in ("value", "object", "array"):
                for line in _VALUE_RULES.strip().split("\n"):
                    self.rules[line.split(" ::=")[0]] = line + "\n"
                self._need_prims("string", "number", "boolean", "null")
            elif nm not in self.rules:
                self.rules[nm] = _PRIMS[nm]

    @staticmethod
    def _lit(s: str) -> str:
        out = s.replace("\\", "\\\\").replace('"', '\\"') \
               .replace("\n", "\\n").replace("\r", "\\r").replace("\t", "\\t")
        return f'"{out}"'

    def _json_lit(self, v) -> str:
        return self._lit(json.dumps(v, ensure_ascii=False))

    def visit(self, schema: dict, name: str) -> str:
        if not isinstance(schema, (dict, bool)) or schema is True:
            schema = {}
        if schema is False:
            raise GrammarError("schema 'false' matches nothing")
        if "$defs" in schema:
            self.defs.update(schema["$defs"])
        if "definitions" in schema:
            self.defs.update(schema["definitions"])
        ref = schema.get("$ref")
        if ref:
            key = ref.split("/")[-1]
            if key not in self.defs:
                raise GrammarError(f"unresolvable $ref {ref}")
            return self.visit(self.defs[key], f"{name}-{key}")
        if "const" in schema:
            return self._add(name, self._json_lit(schema["const"]) + " space")
        if "enum" in schema:
            alts = " | ".join(self._json_lit(v) for v in schema["enum"])
            return self._add(name, f"({alts}) space")
        for comb in ("oneOf", "anyOf"):
            if comb in schema:
                subs = [self.visit(s, f"{name}-{i}")
                        for i, s in enumerate(schema[comb])]
                return self._add(name, " | ".join(subs))

        t = schema.get("type")
        if isinstance(t, list):
            subs = [self.visit({**schema, "type": ti}, f"{name}-{ti}")
                    for ti in t]
            return self._add(name, " | ".join(subs))
        if t == "object" or (t is None and "properties" in schema):
            return self._object(schema, name)
        if t == "array":
            return self._array(schema, name)
        if t in ("string",):
            self._need_prims("string")
            return "string"
        if t in ("number", "integer", "boolean", "null"):
            self._need_prims(t)
            return t
        self._need_prims("value")
        return "value"

    def _object(self, schema: dict, name: str) -> str:
        props = schema.get("properties", {})
        required = set(schema.get("required", []))
        addl = schema.get("additionalProperties", True)
        parts = []
        if props:
            items = []
            for i, (k, sub) in enumerate(props.items()):
                sub_name = self.visit(sub, f"{name}-{re.sub(r'[^a-zA-Z0-9-]', '-', k)}")
                kv = f'{self._lit(json.dumps(k))} space ":" space {sub_name}'
                items.append((k, kv, k in required))
            # render required in order; optionals in tail combinations
            seq = []
            opt_tail: list[str] = []
            first = True
            for k, kv, req in items:
                sep = '' if first else '"," space '
                if req:
                    if opt_tail:
                        # flush optionals before a required (keep order simple:
                        # emit them as optional groups)
                        seq.extend(opt_tail)
                        opt_tail = []
                    seq.append(f'{sep}{kv}')
                    first = False
                else:
                    opt_tail.append(f'({sep}{kv})?')
            seq.extend(opt_tail)
            body = '"{" space ' + " ".join(seq) + ' "}" space'
        elif addl is False:
            body = '"{" space "}" space'
        else:
            self._need_prims("object")
            return "object"
        return self._add(name, body)

    def _array(self, schema: dict, name: str) -> str:
        items = schema.get("items")
        if isinstance(items, dict) or items is None:
            sub = self.visit(items or {}, f"{name}-item")
            min_i = int(schema.get("minItems", 0))
            max_i = schema.get("maxItems")
            if max_i is None:
                if min_i == 0:
                    body = f'"[" space ( {sub} ("," space {sub})* )? "]" space'
                else:
                    reqd = f' ("," space {sub})' * (min_i - 1)
                    body = (f'"[" space {sub}{reqd} ("," space {sub})* "]"'
                            ' space')
            else:
                alts = []
                for n in range(int(max_i), min_i - 1, -1):
                    if n == 0:
                        alts.append('""')
                    else:
                        alts.append(sub + "".join(
                            f' "," space {sub}' for _ in range(n - 1)))
                body = '"[" space (' + " | ".join(alts) + ') "]" space'
            return self._add(name, body)
        # tuple form
        subs = [self.visit(s, f"{name}-{i}") for i, s in enumerate(items)]
        inner = ' "," space '.join(subs)
        return self._add(name, f'"[" space {inner} "]" space')


def json_schema_to_grammar(schema) -> str:
    if isinstance(schema, str):
        schema = json.loads(schema)
    conv = _SchemaConverter()
    root_ref = conv.visit(schema or {}, "root")
    conv.rules.setdefault("space", _SPACE.strip() + "\n")
    lines = []
    if root_ref != "root":
        lines.append(f"root ::= {root_ref}\n")
    for body in conv.rules.values():
        lines.append(body)
    return "".join(lines)


JSON_OBJECT_GRAMMAR = (
    "root ::= object\n" + _VALUE_RULES + _PRIMS["string"] + _PRIMS["number"]
    + _PRIMS["boolean"] + _PRIMS["null"] + _SPACE
)
