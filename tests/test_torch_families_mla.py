"""Port parity of multi-head latent attention (MLA) against the JAX
package, on small GGUF files written here from a seed (random floats, no
checkpoint) with the tensor names of tests/test_deepseek.py and the
goldens of tests/test_arch_goldens.py: low-rank q (q_a -> q_a_norm -> q_b,
or plain wq without a q rank) and kv (kv_a -> [c_kv | k_pe], kv_a_norm,
kv_b) projections, the rope dims first in each head, H heads of K at
nope + rope and V at value_length in the cache.

The files (K 24 = nope 16 + rope 8, V 16, 8 heads, E 64):
- deepseek2: q rank 32, a leading dense layer, then MoE layers with a
  shared expert (two layer groups: a token a pass in both engines);
- deepseek2-noq: the same without a q rank (plain wq);
- deepseek3: the routing of test_deepseek3_noaux_tc_routing (sigmoid,
  exp_probs_b, 4 groups of which 2, top-k renormalized, scale 2.5);
- deepseek2-moe: every layer MoE (uniform: chains), with YaRN (factor 4,
  original context 32) as DeepSeek-V2 has it;
- minicpm3: every layer dense (uniform: chains), q rank 32, its
  embedding, residual and logit scales and longrope factors.

For every file:
- both loaders give the same config and layer grouping, the port's check
  passes, and the MLA projections stay unfused in both packages;
- `_mla_qkv` equals JAX's on the same inputs (f32, 1e-5);
- batched prefill logits within tests/test_torch_families.py's bounds:
  f32 weights and cache 1e-4 x max|logit| + 1e-5; a bf16 or int8 cache
  (attention in bf16) 3e-2 x max|logit| + 3e-3, bf16 weights with the
  bf16 cache;
- the port engine's greedy tokens equal the JAX engine's at K 1 and 4
  (f32), a token a pass for the grouped files and chains for the
  uniform ones;
- a T-row verify forward gives its rows' one-row decode steps (f32,
  within 1e-5);
- params_from_numpy of the JAX tree gives the port loader's prefill
  logits bit for bit.
And: the embeddings pass against JAX forward_embeddings where V is as
wide as K (at unequal widths the JAX function raises), and at unequal
widths against the port's own prefill rows; shift_kv and copy_kv_prefix on an MLA cache (K and V of different
widths, the rotation over the first rope_dim dims of each K head only)
equal JAX shift_kv_impl / copy_kv_prefix_impl (f32, int8); the w8a8 and
grouped paths load and run an MLA file with Q8_0 matrices (the plain wq
and wo quantized, the low-rank projections dense as the JAX loader keeps
them) within the w8a8 bounds of tests/test_torch_families.py against the
JAX forward; on a CUDA device the check takes the kernels' (K, V) pairs
(192, 128) and (96, 64) and refuses others by naming the pairs."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.gguf.constants import GGMLType
from llama_box_tpu.models import llama as jllama
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models.loader import (fuse_projections, load_model,
                                               params_from_numpy)
from llama_box_tpu_torch.server.engine import Engine

from .test_torch_families import C, S, T, _header, _load_both, _prefill_both
from .test_torch_families_engine import (MARGIN, PROMPTS, _jax_tokens,
                                         _port_tokens)

MLA_KINDS = ["deepseek2", "deepseek2-noq", "deepseek3", "deepseek2-moe",
             "minicpm3"]
E, H, ROPE, NOPE, DV, QLORA, KVLORA = 64, 8, 8, 16, 16, 32, 32
DK = NOPE + ROPE
FF, FFE = 128, 64           # dense FF; the experts' and shared expert's
GROUPED = {"deepseek2", "deepseek2-noq", "deepseek3"}   # a dense layer 0
_KV = {
    "deepseek2": {"expert_weights_scale": 2.0, "expert_weights_norm": False},
    "deepseek3": {"expert_gating_func": 2, "expert_weights_norm": True,
                  "expert_weights_scale": 2.5, "expert_group_count": 4,
                  "expert_group_used_count": 2},
    "deepseek2-moe": {"expert_weights_scale": 1.0,
                      "rope.scaling.type": "yarn", "rope.scaling.factor": 4.0,
                      "rope.scaling.original_context_length": 32},
    "minicpm3": {"embedding_scale": 12.0, "residual_scale": 1.4 / 2 ** 0.5,
                 "logit_scale": 0.25,
                 "rope.scaling.original_context_length": 32},
}
_KV["deepseek2-noq"] = _KV["deepseek2"]


def write_mla(path, kind, seed=0, quant=GGMLType.F32, dv=DV):
    """A GGUF of one of MLA_KINDS (see the module docstring); the 2D
    projections in `quant`, V heads of width `dv`."""
    arch = "minicpm3" if kind == "minicpm3" else "deepseek2"
    q_rank = 0 if kind == "deepseek2-noq" else QLORA
    X = 8 if kind == "deepseek3" else 4
    L = 2 if kind in ("deepseek2-moe", "minicpm3") else 3
    rng = np.random.default_rng(seed)

    def rand(*shape, s=0.08):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def norm(n):
        return np.ones(n, np.float32) + rand(n, s=0.1)

    extra = {"block_count": L, "attention.head_count_kv": H,
             "attention.key_length": DK, "attention.value_length": dv,
             "attention.q_lora_rank": q_rank,
             "attention.kv_lora_rank": KVLORA, "rope.dimension_count": ROPE,
             **_KV.get(kind, {})}
    if arch == "deepseek2":
        extra.update(expert_count=X, expert_used_count=2,
                     expert_feed_forward_length=FFE, expert_shared_count=1)
    w, V = _header(path, arch, (E, H, H, DK, FF), extra.items())
    w.add_tensor("token_embd.weight", rand(V, E))
    w.add_tensor("output_norm.weight", norm(E))
    w.add_tensor("output.weight", rand(V, E), quant)
    if kind == "minicpm3":
        w.add_tensor("rope_factors_long.weight",
                     (1.0 + rng.uniform(0.5, 3.0, ROPE // 2)).astype(
                         np.float32))
        w.add_tensor("rope_factors_short.weight",
                     (1.0 + rng.uniform(0.0, 0.3, ROPE // 2)).astype(
                         np.float32))
    for i in range(L):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", norm(E))
        if q_rank:
            w.add_tensor(p + "attn_q_a.weight", rand(q_rank, E), quant)
            w.add_tensor(p + "attn_q_a_norm.weight", norm(q_rank))
            w.add_tensor(p + "attn_q_b.weight", rand(H * DK, q_rank), quant)
        else:
            w.add_tensor(p + "attn_q.weight", rand(H * DK, E), quant)
        w.add_tensor(p + "attn_kv_a_mqa.weight", rand(KVLORA + ROPE, E),
                     quant)
        w.add_tensor(p + "attn_kv_a_norm.weight", norm(KVLORA))
        w.add_tensor(p + "attn_kv_b.weight", rand(H * (NOPE + dv), KVLORA),
                     quant)
        w.add_tensor(p + "attn_output.weight", rand(E, H * dv), quant)
        w.add_tensor(p + "ffn_norm.weight", norm(E))
        if kind == "minicpm3" or (i == 0 and kind in GROUPED):
            w.add_tensor(p + "ffn_gate.weight", rand(FF, E), quant)
            w.add_tensor(p + "ffn_up.weight", rand(FF, E), quant)
            w.add_tensor(p + "ffn_down.weight", rand(E, FF), quant)
            continue
        w.add_tensor(p + "ffn_gate_inp.weight", rand(X, E, s=0.5))
        w.add_tensor(p + "ffn_gate_exps.weight", rand(X, FFE, E))
        w.add_tensor(p + "ffn_up_exps.weight", rand(X, FFE, E))
        w.add_tensor(p + "ffn_down_exps.weight", rand(X, E, FFE))
        w.add_tensor(p + "ffn_gate_shexp.weight", rand(FFE, E))
        w.add_tensor(p + "ffn_up_shexp.weight", rand(FFE, E))
        w.add_tensor(p + "ffn_down_shexp.weight", rand(E, FFE))
        if kind == "deepseek3":
            w.add_tensor(p + "exp_probs_b.bias", rand(X, s=0.3))
    w.write()


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("families_mla")
    out = {}
    for kind in MLA_KINDS:
        out[kind] = str(d / f"{kind}.gguf")
        write_mla(out[kind], kind)
    return out


def _layer0(jp, tp):
    """Layer 0's parameters in both packages (the first group's first)."""
    jg = (jp.get("layer_groups") or [jp["layers"]])[0]
    return ({k: v[0] for k, v in jg.items()}, tllama.layer_params(tp)[0])


@pytest.mark.parametrize("kind", MLA_KINDS)
def test_config_groups_and_no_fusion_match_jax(paths, kind):
    jcfg, jp, tcfg, tp = _load_both(paths[kind], jnp.float32, torch.float32)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.kv_lora_rank == KVLORA and tcfg.head_dim == DK
    assert tcfg.v_head_dim == DV and tcfg.rope_dim == ROPE
    assert ("layer_groups" in tp) == ("layer_groups" in jp) \
        == (kind in GROUPED)
    tllama.check_supported(tcfg, tp)
    for jg, tg in zip(jp.get("layer_groups") or [jp["layers"]],
                      tllama.layer_groups(tp)):
        assert set(jg) == set(tg)
        assert "wkv_a" in tg and "wqkv" not in tg
        assert ("wq_a" in tg) == (kind != "deepseek2-noq")
    # fuse_projections fuses wq / wk / wv but never beside wkv_a (the JAX
    # gate)
    w = torch.zeros(4, 8)
    for lay, fused in (({"wq": w, "wk": w, "wv": w}, True),
                       ({"wq": w, "wk": w, "wv": w, "wkv_a": w}, False)):
        out = fuse_projections({"layers": lay}, tcfg)["layers"]
        assert ("wqkv" in out) == fused


@pytest.mark.parametrize("kind", MLA_KINDS)
def test_mla_qkv_matches_jax(paths, kind):
    jcfg, jp, tcfg, tp = _load_both(paths[kind], jnp.float32, torch.float32)
    jl, tl = _layer0(jp, tp)
    h = np.random.default_rng(5).standard_normal((S, T, E)).astype(
        np.float32)
    want = jllama._mla_qkv(jnp.asarray(h), jl, jcfg)
    got = tllama._mla_qkv(torch.from_numpy(h), tl, tcfg)
    for g, w, width in zip(got, want, (DK, DK, DV)):
        assert tuple(g.shape) == (S, T, H, width)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("kind", MLA_KINDS)
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_prefill_logits_match_jax(paths, kind, cache):
    jdt, tdt, kvj, kvt, rel, floor = {
        "f32": (jnp.float32, torch.float32, jnp.float32, torch.float32,
                1e-4, 1e-5),
        "bf16": (jnp.bfloat16, torch.bfloat16, jnp.bfloat16, torch.bfloat16,
                 3e-2, 3e-3),
        "int8": (jnp.float32, torch.float32, jnp.int8, torch.int8, 3e-2,
                 3e-3)}[cache]
    jcfg, jp, tcfg, tp = _load_both(paths[kind], jdt, tdt)
    kv = tllama.init_kv_cache(tcfg, S, C, kvt, device="cpu")
    assert tuple(kv.k.shape) == (tcfg.n_layers, S, C, H, DK)
    assert tuple(kv.v.shape) == (tcfg.n_layers, S, C, H, DV)
    got, want = _prefill_both(jcfg, jp, tcfg, tp, kvj, kvt)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max() + floor)


@pytest.mark.parametrize("kind", MLA_KINDS)
def test_engine_greedy_matches_jax(paths, kind, monkeypatch):
    """Greedy tokens equal the JAX engine's; the grouped files decode a
    token a pass (no chain), the uniform ones in chains."""
    chains = []
    dispatch = Engine._dispatch_chain

    def spy(self, dec, K, *a, **kw):
        chains.append(K)
        return dispatch(self, dec, K, *a, **kw)
    monkeypatch.setattr(Engine, "_dispatch_chain", spy)
    want = _jax_tokens(paths[kind], PROMPTS)
    for chain in (1, 4):
        chains.clear()
        finals = _port_tokens(paths[kind], chain, PROMPTS)
        for f in finals:
            for tp in f.probs:
                p0, p1 = tp.top_probs[:2]
                assert math.log(p0) - math.log(max(p1, 1e-30)) > MARGIN, \
                    "a near tie"
        assert [f.generated for f in finals] == want, chain
        assert (not chains) == (kind in GROUPED), chains
        assert chain == 1 or kind in GROUPED or max(chains) > 1


@pytest.mark.parametrize("kind", MLA_KINDS)
def test_verify_forward_rows_equal_decode_steps(paths, kind):
    cfg, params = load_model(paths[kind], dtype=torch.float32, device="cpu")
    params = fuse_projections(params, cfg)
    Tv = 5
    rng = np.random.default_rng(4)
    cos, sin = tllama.make_rope(cfg, C, "cpu")
    caches = [tllama.init_kv_cache(cfg, S, C, torch.float32, "cpu")
              for _ in range(2)]
    pre = torch.from_numpy(rng.integers(3, 280, (S, 16)))
    for c in caches:
        tllama.prefill_batch_impl(params, cfg, pre, np.array([0, 0]),
                                  np.array([16, 10]), c, cos, sin)
    toks = torch.from_numpy(rng.integers(3, 280, (S, Tv)))
    pos = np.array([[16 + j for j in range(Tv)], [10, 11, 12, C, C]])
    got, _ = tllama.forward_impl(params, cfg, toks, pos, caches[0], cos, sin)
    want = torch.cat([tllama.forward_impl(params, cfg, toks[:, j:j + 1],
                                          pos[:, j:j + 1].copy(), caches[1],
                                          cos, sin)[0] for j in range(Tv)], 1)
    live = torch.from_numpy(pos < C)
    torch.testing.assert_close(got[live], want[live], rtol=0, atol=1e-5)
    for a, b in zip(caches[0], caches[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["deepseek2", "minicpm3"])
def test_params_from_numpy_carries_mla(paths, kind):
    """The JAX loader's tree carried into torch holds the port loader's
    groups and keys and gives its prefill logits bit for bit."""
    jcfg, jp = jax_load(paths[kind], dtype=jnp.float32)
    tcfg, tp = load_model(paths[kind], dtype=torch.float32, device="cpu")
    carried = params_from_numpy(jax.tree.map(np.asarray, jp), jcfg)
    assert [set(g) for g in tllama.layer_groups(carried)] \
        == [set(g) for g in tllama.layer_groups(tp)]
    toks = torch.from_numpy(np.random.default_rng(2).integers(3, 280, (S, T)))
    pos, nv = np.array([0, 0]), np.array([T, 7])
    out = []
    for params in (tp, carried):
        kv = tllama.init_kv_cache(tcfg, S, C, torch.float32, device="cpu")
        cos, sin = tllama.make_rope(tcfg, C, device="cpu")
        out.append(tllama.prefill_batch_impl(params, tcfg, toks, pos, nv, kv,
                                             cos, sin)[0])
    assert torch.equal(out[0], out[1])


def test_embeddings_pass_matches_jax_on_mla_at_equal_widths(tmp_path):
    """The embeddings forward on an MLA file against JAX forward_embeddings
    (mean pooling, f32), with V as wide as K: at unequal widths the JAX
    function's scratch V cache has K's width and it raises (ROADMAP Queue
    3); the next test holds the port there."""
    path = str(tmp_path / "minicpm3-eq.gguf")
    write_mla(path, "minicpm3", dv=DK)
    jcfg, jp, tcfg, tp = _load_both(path, jnp.float32, torch.float32)
    rng = np.random.default_rng(7)
    toks = rng.integers(3, 280, (S, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    jcos, jsin = jllama.make_rope(jcfg, 16)
    want = np.asarray(jllama.forward_embeddings(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), jcos, jsin,
        pooling="mean"))
    cos, sin = tllama.make_rope(tcfg, 16, device="cpu")
    got = tllama.forward_embeddings(tp, tcfg, torch.from_numpy(toks),
                                    torch.from_numpy(lens), cos, sin,
                                    pooling="mean").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_embeddings_pass_at_unequal_widths_gives_the_prefill_rows(paths):
    """At K 24 / V 16 the embeddings forward (pooling none: every row,
    after the output norm) projected by the output weight gives the
    batched prefill's last-token logits (f32, within 1e-5): its scratch
    cache holds V at V's width."""
    cfg, params = load_model(paths["deepseek2-moe"], dtype=torch.float32,
                             device="cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(3, 280, (S, T)))
    nv = np.array([T, 7])
    cos, sin = tllama.make_rope(cfg, C, device="cpu")
    rows = tllama.forward_embeddings(params, cfg, toks, torch.from_numpy(nv),
                                     cos, sin, pooling="none")
    kv = tllama.init_kv_cache(cfg, S, C, torch.float32, device="cpu")
    want, _ = tllama.prefill_batch_impl(params, cfg, toks, np.array([0, 0]),
                                        nv, kv, cos, sin)
    last = rows[torch.arange(S), torch.from_numpy(nv - 1)]
    torch.testing.assert_close(last @ params["output"], want, rtol=0,
                               atol=1e-5)


def _mla_cache(kind, L, seed):
    """A random MLA cache [L, 3, 64, H, DK | DV] as numpy (int8 codes and
    bf16-representable scales, or f32) and as the port's KVCache."""
    rng = np.random.default_rng(seed)
    lead = (L, 3, 64, H)
    if kind == "int8":
        arrs = [rng.integers(-127, 128, lead + (DK,)).astype(np.int8),
                rng.integers(-127, 128, lead + (DV,)).astype(np.int8),
                rng.uniform(0.001, 0.05, lead).astype(np.float32),
                rng.uniform(0.001, 0.05, lead).astype(np.float32)]
        t = [torch.tensor(a) for a in arrs[:2]] \
            + [torch.tensor(a).to(torch.bfloat16) for a in arrs[2:]]
        arrs[2:] = [x.float().numpy() for x in t[2:]]
        jkv = jllama.KVCache(
            k=jnp.asarray(arrs[0]), v=jnp.asarray(arrs[1]),
            k_scale=jnp.asarray(arrs[2], jnp.bfloat16),
            v_scale=jnp.asarray(arrs[3], jnp.bfloat16))
    else:
        arrs = [rng.standard_normal(lead + (w,)).astype(np.float32)
                for w in (DK, DV)]
        t = [torch.tensor(a) for a in arrs]
        jkv = jllama.KVCache(k=jnp.asarray(arrs[0]), v=jnp.asarray(arrs[1]))
    return tllama.KVCache(*t), jkv


@pytest.mark.parametrize("kind", ["deepseek2-moe", "minicpm3"])
@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_shift_kv_on_an_mla_cache_matches_jax(paths, kind, cache):
    """A context shift of slot 1 (keep 4, discard 16): K's first rope_dim
    dims of every head rotated by the delta tables (YaRN's without its
    mscale; longrope's factors), the rest of K and all of V only moved;
    f32 within 1e-6, int8 codes within 1 (99 % equal), scales equal."""
    cfg, _ = load_model(paths[kind], dtype=torch.float32, device="cpu")
    jcfg, _ = jax_load(paths[kind], dtype=jnp.float32)
    kv, jkv = _mla_cache(cache, cfg.n_layers, 11)
    k0 = kv.k.clone()
    dcos, dsin = tllama.make_delta_rope(cfg, 64, device="cpu")
    assert dcos.shape[-1] == ROPE // 2
    tllama.shift_kv(kv, 1, 4, 16, dcos, dsin, cfg.rope_mode)
    jcos, jsin = jllama.make_delta_rope(jcfg, 64)
    np.testing.assert_allclose(dcos.numpy(), np.asarray(jcos), rtol=0,
                               atol=1e-7)
    jout = jllama.shift_kv_impl(jkv, 1, 4, 16, jcos, jsin, jcfg.rope_mode)
    got = [x.numpy() if x.dtype == torch.int8 else x.float().numpy()
           for x in kv if x is not None]
    want = [np.asarray(x) if x.dtype == jnp.int8
            else np.asarray(x, np.float32) for x in jout if x is not None]
    if cache == "f32":
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        # past the rope dims K's rows only moved
        np.testing.assert_array_equal(got[0][:, 1, 4:48, :, ROPE:],
                                      k0.numpy()[:, 1, 20:64, :, ROPE:])
    else:
        diff = np.abs(got[0].astype(np.int32) - want[0].astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_copy_kv_prefix_on_an_mla_cache_matches_jax(cache):
    kv, jkv = _mla_cache(cache, 2, 4)
    tllama.copy_kv_prefix(kv, 0, 2, 5)
    jout = jllama.copy_kv_prefix_impl(jkv, 0, 2, 5)
    for g, w in zip([x for x in kv if x is not None],
                    [x for x in jout if x is not None]):
        g = g.numpy() if g.dtype == torch.int8 else g.float().numpy()
        np.testing.assert_array_equal(g, np.asarray(w, g.dtype))


@pytest.fixture(scope="module")
def q8_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("families_mla_q8")
    out = {}
    for kind in ("deepseek2-noq", "minicpm3"):
        out[kind] = str(d / f"{kind}-q8_0.gguf")
        write_mla(out[kind], kind, seed=1, quant=GGMLType.Q8_0)
    return out


@pytest.mark.parametrize("kind", ["deepseek2-noq", "minicpm3"])
@pytest.mark.parametrize("residency", ["w8a8", "grouped"])
def test_quantized_paths_run_mla_as_jax(q8_paths, kind, residency,
                                        monkeypatch):
    """Q8_0 matrices under --weights-dtype quantized: the plain wq (no q
    rank) and wo as w8a8 or grouped QTensors, the low-rank projections
    dense (the JAX loader's optional keys); prefill logits with f32
    activations within 1e-5 (w8a8: the same int8 codes and sums) or 1e-4
    (grouped: f32 dequantization, sums in another order) of the JAX
    forward's."""
    if residency == "grouped":
        monkeypatch.setenv("LLAMA_BOX_TPU_Q4_INT8", "1")
    jcfg, jp, tcfg, tp = _load_both(q8_paths[kind], jnp.float32,
                                    torch.float32, quantized=True)
    tllama.check_supported(tcfg, tp)
    lay = tllama.layer_groups(tp)[-1]
    q_keys = {k for k, v in lay.items() if isinstance(v, tllama.QTensor)}
    assert "wo" in q_keys and ("wq" in q_keys) == (kind == "deepseek2-noq")
    assert not q_keys & {"wq_a", "wq_b", "wkv_a", "wkv_b"}
    assert {lay[k].w8a8 for k in q_keys} == {residency == "w8a8"}
    got, want = _prefill_both(jcfg, jp, tcfg, tp, jnp.float32,
                              torch.float32, seed=3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 if residency == "w8a8" else 1e-4)


@pytest.mark.parametrize("pair,ok", [((192, 128), True), ((96, 64), True),
                                     ((128, 128), True), ((192, 64), False),
                                     ((24, 16), False)])
def test_cuda_check_takes_the_kernels_width_pairs(paths, pair, ok):
    """On a CUDA device the check takes the (K, V) pairs both attention
    kernels instantiate and refuses any other by naming them; the CPU's
    plain versions take any. (Building torch.device("cuda") needs no
    card.)"""
    cfg, params = load_model(paths["minicpm3"], dtype=torch.bfloat16,
                             device="cpu")
    cfg = dataclasses.replace(cfg, head_dim=pair[0], v_head_dim=pair[1])
    tllama.check_supported(cfg, params, torch.device("cpu"))
    if ok:
        tllama.check_supported(cfg, params, torch.device("cuda"))
    else:
        with pytest.raises(NotImplementedError, match=r"\(192, 128\), "
                           r"\(96, 64\)"):
            tllama.check_supported(cfg, params, torch.device("cuda"))
