"""The port's mixture-of-experts FFN (llama_box_tpu_torch/models/llama.py
`_moe_ffn`, `_moe_mix`, and ops/moe.moe_ffn_plain, the plain version of
csrc/moe_ffn.cu) against the JAX package's `_moe_ffn` / `_moe_mix`, which
compute every expert densely under a routing mask, on the same numpy
inputs made from a seed.

Every router: softmax with and without renormalized top-k weights,
sigmoid, phimoe's sparsemixer, deepseek3's bias-corrected group-limited
selection with a routed scale, gpt-oss's router bias with its expert
biases and swiglu_oai, grok's router softcap with gelu experts, llama4's
weight-before-FFN routing with a shared expert, qwen2moe's gated shared
expert, relu2 experts, jetmoe's bias after the sum; and arctic's parallel
dense and expert branches through `_layer_tail`.

Tolerances: f32 within 1e-5 x max|y| + 1e-6 (f32 sums of the same
products in another order: JAX sums all X experts, zeros included, the
port only the K picked); bf16 inputs within 3e-2 x max|y| + 3e-3, the
bound of tests/test_torch_families.py (the router product rounds to bf16
in both; the experts run in f32 on the rounded inputs). A router row
with exact ties picks JAX's experts: the lower index first."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.models import llama as jllama
from llama_box_tpu.models.config import ModelConfig as JModelConfig
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models.config import ModelConfig
from llama_box_tpu_torch.ops.moe import moe_ffn, moe_ffn_plain

E, F, X = 64, 48, 8

# name -> (config fields, extra layer tensors)
ROUTERS = {
    "softmax_norm": (dict(expert_used_count=2), ()),
    "softmax": (dict(expert_used_count=3, expert_weights_norm=False), ()),
    "sigmoid": (dict(expert_used_count=2, expert_gating_func=2), ()),
    "sparsemixer": (dict(expert_used_count=2, expert_gating_func=3,
                         router_jitter_eps=0.01, expert_weights_norm=False,
                         act_fn="silu"), ()),
    "deepseek3": (dict(expert_used_count=2, expert_gating_func=2,
                       expert_group_count=4, expert_group_used_count=2,
                       expert_weights_scale=2.5), ("exp_probs_b",)),
    "gpt_oss": (dict(expert_used_count=2, act_fn="swiglu_oai"),
                ("b_gate_inp", "b_gate_exps", "b_up_exps", "b_down_exps")),
    "grok_softcap": (dict(expert_used_count=2, router_softcap=0.5,
                          act_fn="gelu", expert_weights_norm=False), ()),
    "llama4": (dict(expert_used_count=1, expert_gating_func=2,
                    moe_weight_before_ffn=True, expert_weights_norm=False),
               ("w_gate_shexp", "w_up_shexp", "w_down_shexp")),
    "shared_gated": (dict(expert_used_count=2, expert_weights_norm=False),
                     ("w_gate_shexp", "w_up_shexp", "w_down_shexp",
                      "w_gate_inp_shexp")),
    "relu2": (dict(expert_used_count=2, act_fn="relu2"), ()),
    "jetmoe_bias": (dict(expert_used_count=2), ("b_down",)),
    "all_experts": (dict(expert_used_count=X), ()),
}
DT = {"f32": (jnp.float32, torch.float32, 1e-5, 1e-6),
      "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2, 3e-3)}


def _layer(seed, extra=(), s=0.2):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=s):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    lp = {"w_gate_inp": r(E, X, scale=0.5), "w_gate_exps": r(X, E, F),
          "w_up_exps": r(X, E, F), "w_down_exps": r(X, F, E)}
    shapes = {"b_gate_inp": (X,), "b_gate_exps": (X, F), "b_up_exps": (X, F),
              "b_down_exps": (X, E), "exp_probs_b": (X,),
              "w_gate_shexp": (E, F), "w_up_shexp": (E, F),
              "w_down_shexp": (F, E), "w_gate_inp_shexp": (E, 1),
              "b_down": (E,)}
    for k in extra:
        lp[k] = r(*shapes[k])
    return lp


def _cfgs(**kw):
    base = dict(arch="qwen3moe", n_embd=E, expert_count=X, rms_eps=1e-5)
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _both(lp, jdt, tdt):
    return ({k: jnp.asarray(v, jdt) for k, v in lp.items()},
            {k: torch.from_numpy(v).to(tdt) for k, v in lp.items()})


def _check(got, want, rel, floor):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max() + floor)


@pytest.mark.parametrize("router", list(ROUTERS))
@pytest.mark.parametrize("dt", list(DT))
def test_moe_ffn_matches_jax(router, dt):
    jdt, tdt, rel, floor = DT[dt]
    fields, extra = ROUTERS[router]
    jcfg, tcfg = _cfgs(**fields)
    jlp, tlp = _both(_layer(1, extra), jdt, tdt)
    h = np.random.default_rng(2).standard_normal((2, 5, E)).astype(
        np.float32)
    want = jllama._moe_ffn(jnp.asarray(h, jdt), jlp, jcfg)
    got = tllama._moe_ffn(torch.from_numpy(h).to(tdt), tlp, tcfg)
    assert got.dtype == torch.float32
    _check(got, want, rel, floor)


@pytest.mark.parametrize("case", ["silu", "gelu", "relu2", "swiglu_oai",
                                  "biases", "weight_before", "k1", "k_all",
                                  "x60", "idle_expert"])
def test_moe_ffn_plain_matches_jax_dense_mix(case):
    """moe_ffn_plain (the kernel's plain version; the wrapper takes it on
    a CPU tensor) against JAX's dense `_moe_mix` under the mask the same
    picks give: each activation, gpt-oss's biases, llama4's weight before
    the FFN, one pick and every expert, qwen2moe's 60 experts, and an
    expert no row picks."""
    Xc = 60 if case == "x60" else X
    K = {"k1": 1, "k_all": Xc}.get(case, 2)
    act = case if case in ("gelu", "relu2", "swiglu_oai") else "silu"
    rng = np.random.default_rng(5)
    N = 11
    lp = {"w_gate_exps": rng.standard_normal((Xc, E, F)) * 0.2,
          "w_up_exps": rng.standard_normal((Xc, E, F)) * 0.2,
          "w_down_exps": rng.standard_normal((Xc, F, E)) * 0.2}
    if case == "biases":
        lp.update(b_gate_exps=rng.standard_normal((Xc, F)) * 0.3,
                  b_up_exps=rng.standard_normal((Xc, F)) * 0.3,
                  b_down_exps=rng.standard_normal((Xc, E)) * 0.3)
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    pool = Xc - 1 if case == "idle_expert" else Xc    # expert Xc-1 idle
    topi = np.stack([rng.permutation(pool)[:K] for _ in range(N)])
    topv = rng.uniform(0.05, 1.0, (N, K)).astype(np.float32)
    h = (rng.standard_normal((N, E)) * 3.0).astype(np.float32)
    route = np.zeros((N, Xc), np.float32)
    route[np.arange(N)[:, None], topi] = topv
    jcfg, _ = _cfgs(expert_count=Xc, expert_used_count=K, act_fn=act,
                    moe_weight_before_ffn=case == "weight_before")
    want = jllama._moe_mix(jnp.asarray(h[None]),
                           {k: jnp.asarray(v) for k, v in lp.items()}, jcfg,
                           None, jnp.asarray(route[None]))[0]
    t = {k: torch.from_numpy(v) for k, v in lp.items()}
    wb = case == "weight_before"
    got = moe_ffn_plain(
        torch.from_numpy(h), torch.from_numpy(topi), torch.from_numpy(topv),
        t["w_gate_exps"], t["w_up_exps"], t["w_down_exps"], act=act,
        b_gate=t.get("b_gate_exps"), b_up=t.get("b_up_exps"),
        b_down=t.get("b_down_exps"), weight_before=wb)
    _check(got, want, 1e-5, 1e-6)
    # the wrapper takes the plain version on a CPU tensor, bit for bit
    again = moe_ffn(
        torch.from_numpy(h), torch.from_numpy(topi), torch.from_numpy(topv),
        t["w_gate_exps"], t["w_up_exps"], t["w_down_exps"], act=act,
        b_gate=t.get("b_gate_exps"), b_up=t.get("b_up_exps"),
        b_down=t.get("b_down_exps"), weight_before=wb)
    assert torch.equal(got, again)


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_top_k_breaks_ties_as_jax(k):
    """Exact ties (as bf16 router logits give) pick the lower index first,
    as jax.lax.top_k does, values and indices alike."""
    rng = np.random.default_rng(7)
    x = rng.integers(-3, 3, (64, X)).astype(np.float32) / 4
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = tllama._top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dt", list(DT))
def test_router_ties_pick_jax_experts(dt):
    """A router whose experts come in identical pairs (every row's logits
    tie pairwise) routes each row to JAX's experts: the FFN output
    matches."""
    jdt, tdt, rel, floor = DT[dt]
    lp = _layer(3)
    lp["w_gate_inp"][:, 4:] = lp["w_gate_inp"][:, :4]   # expert i+4 = i
    jcfg, tcfg = _cfgs(expert_used_count=3)
    jlp, tlp = _both(lp, jdt, tdt)
    h = np.random.default_rng(4).standard_normal((1, 9, E)).astype(
        np.float32)
    want = jllama._moe_ffn(jnp.asarray(h, jdt), jlp, jcfg)
    got = tllama._moe_ffn(torch.from_numpy(h).to(tdt), tlp, tcfg)
    _check(got, want, rel, floor)


@pytest.mark.parametrize("dt", list(DT))
def test_arctic_parallel_branches_match_jax(dt):
    """arctic's `_layer_tail`: the dense FFN (ffn_norm, b_down) and the
    experts (ffn_norm_exps) in parallel off the attention residual."""
    jdt, tdt, rel, floor = DT[dt]
    rng = np.random.default_rng(8)
    lp = _layer(9)

    def r(*shape, s=0.1):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    lp.update(wo=r(E, E), ffn_norm=1 + r(E), ffn_norm_exps=1 + r(E),
              w_gate=r(E, 96), w_up=r(E, 96), w_down=r(96, E), b_down=r(E))
    jcfg, tcfg = _cfgs(arch="arctic", expert_used_count=2)
    jlp, tlp = _both(lp, jdt, tdt)
    x = rng.standard_normal((2, 3, E)).astype(np.float32)
    attn = rng.standard_normal((2, 3, E)).astype(np.float32)
    want = jllama._layer_tail(jnp.asarray(x, jdt), jlp, jcfg,
                              jnp.asarray(attn, jnp.float32), None)
    got = tllama._layer_tail(torch.from_numpy(x).to(tdt), tlp, tcfg,
                             torch.from_numpy(attn))
    assert got.dtype == tdt
    _check(got, want, rel, floor)


def test_moe_layers_dispatch_through_ffn_block():
    """`_ffn_block` takes the experts where the layer has a router and
    returns the activations' dtype."""
    _, tcfg = _cfgs(expert_used_count=2)
    _, tlp = _both(_layer(11), jnp.bfloat16, torch.bfloat16)
    h = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1, 4, E)).astype(np.float32)).to(torch.bfloat16)
    out = tllama._ffn_block(h, tlp, tcfg, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, tllama._moe_ffn(h, tlp, tcfg).to(torch.bfloat16))
