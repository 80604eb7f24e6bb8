"""Port parity of the serving engine on the mixture-of-experts families of
tests/test_torch_families_moe.py: the port engine's greedy tokens at K 1
and K 4 equal the JAX engine's (f32 weights and KV cache), on prompts
whose greedy steps all clear a top-2 log-prob margin of 1e-3 (checked, as
tests/test_torch_families_engine.py does). The families with layer groups
decode a token a pass in both engines (the JAX engine's gate: no chain,
no post-prefill speculation); the others chain. gpt-oss's and llama4's
prompts pass their window and chunk of 8."""

import math

import pytest

from .test_torch_families_engine import (ATTN_PROMPTS, MARGIN, PROMPTS,
                                         _jax_tokens, _port_tokens)
from .test_torch_families_moe import MOE_ARCHS, WINDOW, write_moe

# prompts whose greedy steps clear MARGIN in every MoE family (the dense
# families' second prompt, and one in place of their first, which meets a
# near tie on dbrx's flat logits)
MOE_PROMPTS = (PROMPTS[1], [1, 51, 228, 182, 255])


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("families_moe_engine")
    out = {}
    for arch in MOE_ARCHS:
        out[arch] = str(d / f"{arch}.gguf")
        write_moe(out[arch], arch)
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_greedy_matches_jax(paths, arch):
    long = arch in ("gpt-oss", "llama4")
    prompts = ATTN_PROMPTS if long else MOE_PROMPTS
    assert not long or min(map(len, prompts)) > WINDOW
    want = _jax_tokens(paths[arch], prompts)
    for chain in (1, 4):
        finals = _port_tokens(paths[arch], chain, prompts)
        for f in finals:
            for tp in f.probs:
                p0, p1 = tp.top_probs[:2]
                assert math.log(p0) - math.log(max(p1, 1e-30)) > MARGIN, \
                    "a near tie"
        assert [f.generated for f in finals] == want, chain
