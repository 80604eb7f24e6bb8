"""Port parity of the mixture-of-experts families against the JAX package,
on small GGUF files of each family written here from a seed (random
floats, no checkpoint) with the tensor names of its JAX golden
(tests/test_arch_goldens.py, tests/test_moe.py, tests/test_llama4.py):
mixtral, qwen2moe, qwen3moe, olmoe, granitemoe, granitemoeshared, phimoe,
grok, dbrx, arctic, bailingmoe, hunyuan-moe, glm4moe, dots1, gpt-oss and
llama4. They cover every router, shared experts, heterogeneous layer
groups (glm4moe's, dots1's and bailingmoe's leading dense layer, llama4's
interleaved dense and MoE layers), gpt-oss's sinks, biases and sliding
window, llama4's chunked window, q/k L2 norm and temperature.

For every family:
- both loaders give the same config and the same layer grouping, and the
  port's check passes;
- batched prefill logits (after the engine's rope de-interleave and
  projection fusion, in both packages) within the bounds of
  tests/test_torch_families.py: 1e-4 x max|logit| + 1e-5 with f32
  weights and cache, 3e-2 x max|logit| + 3e-3 with bf16;
- (tests/test_torch_families_moe_engine.py) the port engine's greedy
  tokens equal the JAX engine's;
- a T-row verify forward gives its rows' one-row decode steps (f32,
  within 1e-5).
jetmoe (mixture of attention: q and output experts over a shared kv
projection, and MoE FFN layers) is one of the families; jamba's recurrent
mixer stays refused at load by its cause (qwen2vl's M-RoPE and deepseek2's
MLA are ported: tests/test_torch_multimodal_engine.py,
tests/test_torch_families_mla.py); on a CUDA device the check refuses
expert stacks the kernel does not take."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models.loader import (deinterleave_rope,
                                               fuse_projections, load_model,
                                               params_from_numpy)

from .test_torch_families import C, S, T, _header, _load_both, _prefill_both

MOE_ARCHS = ["mixtral", "qwen2moe", "qwen3moe", "olmoe", "granitemoe",
             "granitemoeshared", "phimoe", "grok", "dbrx", "arctic",
             "bailingmoe", "hunyuan-moe", "glm4moe", "dots1", "gpt-oss",
             "llama4", "jetmoe"]
DIMS = (64, 4, 2, 16, 128)      # E, H, HKV, D, dense FF
FFE = 48                        # the experts' FF (not a multiple of 64)
WINDOW = 8                      # gpt-oss's window, llama4's chunk
# the families with dense layers: the leading one, or every other
_DENSE = {"glm4moe": lambda i: i == 0, "dots1": lambda i: i == 0,
          "bailingmoe": lambda i: i == 0, "llama4": lambda i: i % 2 == 0}
_SHEXP = {"qwen2moe", "granitemoeshared", "bailingmoe", "hunyuan-moe",
          "glm4moe", "dots1", "llama4"}
_KV = {
    "qwen2moe": {"expert_weights_norm": False},
    "granitemoe": {"embedding_scale": 2.0, "residual_scale": 0.5,
                   "logit_scale": 0.25, "attention.scale": 0.125},
    "dbrx": {"attention.clamp_kqv": 6.0},
    "bailingmoe": {"expert_weights_norm": True,
                   "leading_dense_block_count": 1},
    "glm4moe": {"expert_gating_func": 2, "expert_weights_norm": True,
                "expert_weights_scale": 2.5, "expert_group_count": 4,
                "expert_group_used_count": 2},
    "gpt-oss": {"attention.sliding_window": WINDOW},
    "llama4": {"attention.no_rope_layer_step": 2,
               "attention.chunk_size": WINDOW,
               "attention.temperature_scale": 0.1,
               "attention.floor_scale": 4.0},
}
_KV["granitemoeshared"] = _KV["granitemoe"]
_KV["dots1"] = _KV["glm4moe"]


def n_layers(arch):
    return 4 if arch == "llama4" else 3 if arch in _DENSE else 2


def write_moe(path, arch, seed=0):
    """A GGUF of one of MOE_ARCHS (see the module docstring): 8 experts
    (4 for gpt-oss), 2 a token (1 for llama4), expert FF 48."""
    E, H, HKV, D, FF = DIMS
    L = n_layers(arch)
    X = 4 if arch == "gpt-oss" else 8
    K = 1 if arch == "llama4" else 2
    rng = np.random.default_rng(seed)

    def rand(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def norm(n):
        return np.ones(n, np.float32) + rand(n, s=0.1)

    extra = {"block_count": L, "expert_count": X, "expert_used_count": K,
             "attention.key_length": D, "attention.value_length": D,
             **_KV.get(arch, {})}
    if arch == "jetmoe":
        # the golden's export convention: head_count = X * head_count_kv
        extra["attention.head_count"] = X * HKV
    w, V = _header(path, arch, DIMS, extra.items())
    qd, kvd = H * D, HKV * D
    ln_b = arch == "phimoe"                  # biased LayerNorms
    w.add_tensor("token_embd.weight", rand(V, E))
    w.add_tensor("output_norm.weight", norm(E))
    if ln_b:
        w.add_tensor("output_norm.bias", rand(E))
        w.add_tensor("output.bias", rand(V))
    w.add_tensor("output.weight", rand(V, E))
    for i in range(L):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", norm(E))
        if ln_b:
            w.add_tensor(p + "attn_norm.bias", rand(E))
        if arch == "dbrx":
            w.add_tensor(p + "attn_qkv.weight", rand(qd + 2 * kvd, E))
        elif arch == "jetmoe":
            # mixture of attention: q and output experts over shared k, v,
            # a router, the output bias
            w.add_tensor(p + "attn_q_exps.weight", rand(X, kvd, E, s=0.1))
            w.add_tensor(p + "attn_output_exps.weight",
                         rand(X, E, kvd, s=0.1))
            w.add_tensor(p + "attn_gate_inp.weight", rand(X, E, s=0.5))
            w.add_tensor(p + "attn_k.weight", rand(kvd, E))
            w.add_tensor(p + "attn_v.weight", rand(kvd, E))
        else:
            w.add_tensor(p + "attn_q.weight", rand(qd, E))
            w.add_tensor(p + "attn_k.weight", rand(kvd, E))
            w.add_tensor(p + "attn_v.weight", rand(kvd, E))
        if arch in ("qwen2moe", "gpt-oss", "glm4moe", "phimoe"):
            w.add_tensor(p + "attn_q.bias", rand(qd, s=0.3))
            w.add_tensor(p + "attn_k.bias", rand(kvd, s=0.3))
            w.add_tensor(p + "attn_v.bias", rand(kvd, s=0.3))
        if arch in ("qwen3moe", "hunyuan-moe", "glm4moe", "dots1"):
            w.add_tensor(p + "attn_q_norm.weight", norm(D))
            w.add_tensor(p + "attn_k_norm.weight", norm(D))
        if arch == "olmoe":
            w.add_tensor(p + "attn_q_norm.weight", norm(qd))
            w.add_tensor(p + "attn_k_norm.weight", norm(kvd))
        if arch == "gpt-oss":
            w.add_tensor(p + "attn_sinks.weight", rand(H, s=1.0))
        if arch != "jetmoe":
            w.add_tensor(p + "attn_output.weight", rand(E, qd))
        if arch in ("gpt-oss", "phimoe", "jetmoe"):
            w.add_tensor(p + "attn_output.bias", rand(E))
        if arch in ("grok", "dbrx"):
            # grok: the post-attention sandwich norm; dbrx: its pre-FFN norm
            w.add_tensor(p + "attn_output_norm.weight", norm(E))
        if arch == "grok":
            w.add_tensor(p + "layer_output_norm.weight", norm(E))
        if arch != "dbrx":
            w.add_tensor(p + "ffn_norm.weight", norm(E))
            if ln_b:
                w.add_tensor(p + "ffn_norm.bias", rand(E))
        if arch in _DENSE and _DENSE[arch](i) or arch == "arctic":
            w.add_tensor(p + "ffn_gate.weight", rand(FF, E))
            w.add_tensor(p + "ffn_up.weight", rand(FF, E))
            w.add_tensor(p + "ffn_down.weight", rand(E, FF))
            if arch != "arctic":
                continue
            w.add_tensor(p + "ffn_norm_exps.weight", norm(E))
        w.add_tensor(p + "ffn_gate_inp.weight", rand(X, E, s=0.5))
        w.add_tensor(p + "ffn_gate_exps.weight", rand(X, FFE, E, s=0.1))
        w.add_tensor(p + "ffn_up_exps.weight", rand(X, FFE, E, s=0.1))
        w.add_tensor(p + "ffn_down_exps.weight", rand(X, E, FFE, s=0.1))
        if arch == "gpt-oss":
            w.add_tensor(p + "ffn_gate_inp.bias", rand(X, s=0.3))
            w.add_tensor(p + "ffn_gate_exps.bias", rand(X, FFE, s=0.3))
            w.add_tensor(p + "ffn_up_exps.bias", rand(X, FFE, s=0.3))
            w.add_tensor(p + "ffn_down_exps.bias", rand(X, E, s=0.1))
        if arch in ("glm4moe", "dots1"):
            w.add_tensor(p + "exp_probs_b.bias", rand(X, s=0.3))
        if arch in _SHEXP:
            w.add_tensor(p + "ffn_gate_shexp.weight", rand(FFE, E, s=0.1))
            w.add_tensor(p + "ffn_up_shexp.weight", rand(FFE, E, s=0.1))
            w.add_tensor(p + "ffn_down_shexp.weight", rand(E, FFE, s=0.1))
        if arch == "qwen2moe":
            w.add_tensor(p + "ffn_gate_inp_shexp.weight", rand(1, E, s=0.3))
        if arch == "jetmoe":        # the bias after the expert sum
            w.add_tensor(p + "ffn_down.bias", rand(E))
    w.write()


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("families_moe")
    out = {}
    for arch in MOE_ARCHS:
        out[arch] = str(d / f"{arch}.gguf")
        write_moe(out[arch], arch)
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_logits_match_jax(paths, arch, dt):
    jdt, tdt, rel, floor = {
        "f32": (jnp.float32, torch.float32, 1e-4, 1e-5),
        "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2, 3e-3)}[dt]
    jcfg, jp, tcfg, tp = _load_both(paths[arch], jdt, tdt)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert ("layer_groups" in tp) == ("layer_groups" in jp) \
        == (arch in _DENSE)
    tllama.check_supported(tcfg, tp)
    got, want = _prefill_both(jcfg, jp, tcfg, tp, jdt, tdt)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max() + floor)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_verify_forward_rows_equal_decode_steps(paths, arch):
    cfg, params = load_model(paths[arch], dtype=torch.float32, device="cpu")
    params, cfg = deinterleave_rope(params, cfg)
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


@pytest.mark.parametrize("arch", ["glm4moe", "llama4", "gpt-oss"])
def test_params_from_numpy_carries_layer_groups(paths, arch):
    """The JAX loader's tree carried into torch holds the port loader's
    groups and keys and gives its prefill logits bit for bit."""
    jcfg, jp = jax_load(paths[arch], dtype=jnp.float32)
    tcfg, tp = load_model(paths[arch], dtype=torch.float32, device="cpu")
    carried = params_from_numpy(jax.tree.map(np.asarray, jp), jcfg)
    assert set(carried) == set(tp)
    assert [set(g) for g in tllama.layer_groups(carried)] \
        == [set(g) for g in tllama.layer_groups(tp)]
    kv = tllama.init_kv_cache(tcfg, S, C, torch.float32, device="cpu")
    cos, sin = tllama.make_rope(tcfg, C, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(3, 280, (S, T)))
    pos, nv = np.array([0, 0]), np.array([T, 7])
    want, _ = tllama.prefill_batch_impl(tp, tcfg, toks, pos, nv, kv, cos,
                                        sin)
    kv = tllama.init_kv_cache(tcfg, S, C, torch.float32, device="cpu")
    got, _ = tllama.prefill_batch_impl(carried, tcfg, toks, pos, nv, kv, cos,
                                       sin)
    assert torch.equal(got, want)


def test_llama4_attention_operands(paths):
    """llama4's chunk rides the window operand's second field on its rope
    (local) layers, the unroped global layers take none."""
    cfg, _ = load_model(paths["llama4"], dtype=torch.float32, device="cpu")
    assert tllama.layer_is_local(cfg) == [1, 0, 1, 0]
    win = tllama.layer_windows(cfg, "cpu")
    assert win.tolist() == [[0, WINDOW], [0, 0], [0, WINDOW], [0, 0]]


def _write_refused(path, arch, names, extra=()):
    w, _ = _header(path, arch, DIMS, {"block_count": 1, **dict(extra)}.items())
    w.add_tensor("token_embd.weight", np.zeros((300, DIMS[0]), np.float32))
    for n in names:
        w.add_tensor(n, np.zeros((16, DIMS[0]), np.float32))
    w.write()


@pytest.mark.parametrize("arch,names,cause", [
    # mixture of attention, ported: a jetmoe file with these tensors loads
    # and runs (its parity: the jetmoe cases of the tests above and
    # tests/test_torch_families_moe_engine.py)
    ("jetmoe", ["blk.0.attn_q_exps.weight", "blk.0.attn_output_exps.weight"],
     "mixture-of-attention"),
    # M-RoPE: the file loads and, since M-RoPE was ported, passes the
    # check (tests/test_torch_multimodal_engine.py runs it; MLA, this case
    # before it was ported, loads and runs: tests/test_torch_families_mla.py)
    ("qwen2vl", [], None),
    # a recurrent mixer's tensor in a file whose config is not recurrent
    # (no ssm metadata): refused by the port's check by its cause (the
    # recurrent families run: tests/test_torch_mamba.py)
    ("jamba", ["blk.0.ssm_in.weight"], "recurrent")])
def test_moa_mla_and_recurrent_files_are_refused(tmp_path, arch, names,
                                                 cause):
    path = str(tmp_path / f"{arch}.gguf")
    if arch == "jetmoe":
        write_moe(path, arch)
        cfg, params = load_model(path, dtype=torch.float32, device="cpu")
        assert {n.split(".", 2)[2] for n in names} == {
            "attn_q_exps.weight", "attn_output_exps.weight"}
        assert {"wq_exps", "wo_exps"} <= set(params["layers"])
        tllama.check_supported(cfg, params)
        kv = tllama.init_kv_cache(cfg, S, C, torch.float32, device="cpu")
        cos, sin = tllama.make_rope(cfg, C, device="cpu")
        logits, _ = tllama.prefill_batch_impl(
            params, cfg, torch.arange(3, 3 + S * T).view(S, T),
            np.array([0, 0]), np.array([T, 5]), kv, cos, sin)
        assert torch.isfinite(logits).all()
        return
    _write_refused(path, arch, names, (("rope.dimension_sections",
                                        [2, 3, 3, 0]),)
                   if arch == "qwen2vl" else ())
    if cause is None:
        cfg, params = load_model(path, dtype=torch.float32, device="cpu")
        assert cfg.mrope_sections == (2, 3, 3, 0)
        tllama.check_supported(cfg, params)
        return
    with pytest.raises(NotImplementedError, match=cause):
        cfg, params = load_model(path, dtype=torch.float32, device="cpu")
        tllama.check_supported(cfg, params)


@pytest.mark.parametrize("change,named", [
    ("f32", "bf16 expert stacks"), ("act", "activations"),
    ("width", "multiples of 8"), ("bf16", None)])
def test_cuda_refuses_experts_the_kernel_cannot_take(paths, change, named):
    """On a CUDA device the check refuses, at load and by its cause,
    expert stacks that are not bf16, an expert activation csrc/moe_ffn.cu
    lacks or widths it does not take; the CPU's plain version takes any.
    (Building torch.device("cuda") needs no card.)"""
    cfg, params = load_model(paths["qwen3moe"], dtype=torch.bfloat16,
                             device="cpu")
    # head widths the attention kernels take
    cfg = dataclasses.replace(cfg, head_dim=64, v_head_dim=64)
    lay = dict(params["layers"])
    if change == "f32":
        lay = {k: v.float() if k == "w_up_exps" else v
               for k, v in lay.items()}
    if change == "act":
        cfg = dataclasses.replace(cfg, act_fn="xielu")
    if change == "width":
        lay["w_gate_exps"] = lay["w_gate_exps"][..., :44]
    params = dict(params, layers=lay)
    tllama.check_supported(cfg, params, torch.device("cpu"))
    if named is None:
        tllama.check_supported(cfg, params, torch.device("cuda"))
    else:
        with pytest.raises(NotImplementedError, match=named):
            tllama.check_supported(cfg, params, torch.device("cuda"))


@pytest.mark.parametrize("shape", [(64, 96), (3, 40, 64), (7, 32)])
def test_q8_0_dequant_by_torch_equals_numpy(shape):
    """The loader's torch Q8_0 dequant (on the device a tensor loads to)
    gives gguf/quants.dequantize_q8_0's values bit for bit."""
    from llama_box_tpu_torch.gguf.quants import (dequantize_q8_0,
                                                 quantize_q8_0)
    from llama_box_tpu_torch.models.loader import dequant_q8_0
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    raw = np.frombuffer(quantize_q8_0(x), np.uint8)
    want = dequantize_q8_0(raw, x.size).reshape(shape)
    got = dequant_q8_0(raw, shape, "cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
