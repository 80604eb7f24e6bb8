"""The port's HostSampler (llama_box_tpu_torch/sampling.py) against the JAX
package's on the same numpy logits.

Each case runs both samplers for a few dozen steps over logits drawn from
a seeded numpy generator (the tiny fixture's tokenizer on each side,
byte-level pieces), feeding each step's token back through `accept`:
seeded mirostat (1 and 2), DRY, a reordered chain, xtc, strict and lazy
(trigger-armed) grammars, penalties with logit bias, and the full-vocab
fallback when no candidate fits the grammar. Tokens and the reported top
ids must be identical, the probabilities within 1e-6; must_stop must
agree at every step."""

import numpy as np
import pytest

from llama_box_tpu.gguf import GGUFFile as JGGUFFile
from llama_box_tpu.grammar import Grammar as JGrammar
from llama_box_tpu.sampling import HostSampler as JHostSampler
from llama_box_tpu.sampling import SamplerParams as JSamplerParams
from llama_box_tpu.tokenizer import Tokenizer as JTokenizer
from llama_box_tpu_torch.gguf import GGUFFile
from llama_box_tpu_torch.grammar import Grammar
from llama_box_tpu_torch.sampling import HostSampler, SamplerParams
from llama_box_tpu_torch.server.toolcall import tools_grammar
from llama_box_tpu_torch.tokenizer import Tokenizer
from .fixtures.make_tiny_model import write_tiny_model

PROB_TOL = 1e-6
TOOLS = [{"type": "function", "function": {
    "name": "f", "parameters": {
        "type": "object", "properties": {"x": {"type": "integer"}},
        "required": ["x"]}}}]


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny.gguf")
    write_tiny_model(path)
    with GGUFFile(path) as g:
        t = Tokenizer.from_gguf(g)
    with JGGUFFile(path) as g:
        j = JTokenizer.from_gguf(g)
    return t, j


def _piece_ids(tok, text: str) -> list[int]:
    """Token ids of `text`'s bytes, one single-byte piece each."""
    by = {tok.token_bytes(t, render_special=True): t
          for t in range(tok.n_vocab)}
    return [by[bytes([b])] for b in text.encode()]


# name -> (SamplerParams kwargs, GBNF or None, steps, logits boost of the
# pieces of a text: pushes a lazy grammar's trigger into the stream)
CASES = {
    "mirostat2": (dict(temp=0.8, mirostat=2, seed=7), None, 40, None),
    "mirostat1": (dict(temp=0.8, mirostat=1, seed=11, mirostat_tau=3.0,
                       mirostat_eta=0.2), None, 40, None),
    "dry": (dict(temp=0.7, dry_multiplier=0.8, seed=3,
                 dry_allowed_length=1), None, 48, None),
    "dry_greedy": (dict(temp=0.0, dry_multiplier=0.8, dry_base=2.0),
                   None, 48, None),
    "reordered": (dict(temp=0.9, seed=5, top_k=20, top_p=0.8, min_p=0.05,
                       samplers=("temperature", "min_p", "top_p", "top_k")),
                  None, 40, None),
    "xtc_typical": (dict(temp=1.0, seed=9, xtc_probability=0.5,
                         xtc_threshold=0.05, typ_p=0.9,
                         samplers=("top_k", "xtc", "typ_p", "temperature")),
                    None, 40, None),
    "penalties_bias": (dict(temp=0.6, seed=13, penalty_repeat=1.3,
                            penalty_freq=0.2, penalty_present=0.1,
                            logit_bias={40: 3.0, 41: -2.0}, mirostat=2),
                       None, 40, None),
    "grammar_greedy": (dict(temp=0.0), 'root ::= [a-e ]+ "."', 30, None),
    "grammar_sampled": (dict(temp=1.0, seed=21),
                        'root ::= ("ab" | "c" [0-9]{1,3})+ "!"', 30, None),
    "grammar_mirostat": (dict(temp=0.8, seed=23, mirostat=2),
                         'root ::= [a-z]{3,12} "."', 20, None),
    "json_schema": (dict(temp=0.7, seed=29),
                    None, 40, None),
    "lazy_tool": (dict(temp=0.0, grammar_lazy=True), "tools", 60,
                  "x <tool_call>"),
}


def _grammars(name, gbnf):
    if name == "json_schema":
        from llama_box_tpu_torch.grammar import json_schema_to_grammar
        gbnf = json_schema_to_grammar(
            {"type": "object", "properties": {"ok": {"type": "boolean"}},
             "required": ["ok"]})
    if gbnf == "tools":
        gbnf, triggers = tools_grammar(TOOLS, "chatml")
        return Grammar(gbnf), JGrammar(gbnf), triggers
    if gbnf is None:
        return None, None, ()
    return Grammar(gbnf), JGrammar(gbnf), ()


@pytest.mark.parametrize("name", list(CASES))
def test_host_sampler_matches_jax(toks, name):
    tok, jtok = toks
    kw, gbnf, steps, boost = CASES[name]
    g, jg, triggers = _grammars(name, gbnf)
    if triggers:
        kw = dict(kw, grammar_triggers=triggers)
    hs = HostSampler(SamplerParams(grammar=g, **kw), g, tok)
    js = JHostSampler(JSamplerParams(grammar=jg, **kw), jg, jtok)
    prompt = tok.encode("the quick brown fox")
    hs.push_prompt(prompt)
    js.push_prompt(prompt)
    rng = np.random.default_rng(len(name))
    forced = _piece_ids(tok, boost) if boost else []
    V = tok.n_vocab
    n_constrained = 0
    for step in range(steps):
        logits = rng.standard_normal(V).astype(np.float32) * 3.0
        if step < len(forced):
            logits[forced[step]] += 40.0
        a = hs.sample(logits)
        b = js.sample(logits.copy())
        assert a[0] == b[0], (step, a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_allclose(a[2], b[2], rtol=0, atol=PROB_TOL)
        assert abs(a[3] - b[3]) <= PROB_TOL
        n_constrained += hs.grammar is not None
        hs.accept(a[0])
        js.accept(b[0])
        assert hs.must_stop == js.must_stop, step
        if hs.must_stop:
            break
    if name == "lazy_tool":
        assert n_constrained > 0, "the trigger never armed the grammar"


def test_full_vocab_fallback_matches_jax(toks):
    """No top-N_CAND candidate fits: both scan the full vocabulary in logit
    order and pick the same token."""
    tok, jtok = toks
    target = _piece_ids(tok, "z")[0]
    hs = HostSampler(SamplerParams(temp=0.0), Grammar('root ::= "z"+'), tok)
    js = JHostSampler(JSamplerParams(temp=0.0), JGrammar('root ::= "z"+'),
                      jtok)
    logits = np.linspace(5.0, 0.0, tok.n_vocab).astype(np.float32)
    logits[target] = -50.0
    a, b = hs.sample(logits), js.sample(logits.copy())
    assert a[0] == b[0] == target
    assert abs(a[3] - b[3]) <= PROB_TOL
