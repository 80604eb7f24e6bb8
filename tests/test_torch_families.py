"""Port parity of the dense llama variants (LayerNorm and biases, q/k
norms, post and sub norms, parallel residual, ungated FFN, scales, learned
positions, longrope) against the JAX package, on small GGUF files of each
family written here: the eight of tests/test_arch_families.py (its own
`_write_family`) and qwen2, qwen3, gpt2, phi3, bitnet, hunyuan-dense, olmo
and minicpm, whose tensor names follow tests/test_arch_goldens.py (random
floats from a seed, no checkpoint).

For every family:
- both loaders give the same config, and the port's check passes;
- batched prefill logits (after the engine's rope de-interleave and
  projection fusion, in both packages) within 1e-4 x max|logit| + 1e-5
  with f32 weights and cache (sums in another order), and within 3e-2 x
  max|logit| + 3e-3 with bf16 weights and cache (the port rounds to bf16
  at every op the JAX code names; XLA on the CPU keeps f32 across its
  fused bf16 ops);
- (tests/test_torch_families_engine.py) the port engine's greedy tokens
  equal the JAX engine's, and a context shift equals JAX's;
- a T-row verify forward gives its rows' one-row decode steps (f32,
  within 1e-5: matmuls of other row counts).
For one LayerNorm family (gpt2) and one RMS family (qwen3), at widths the
w8a8 path quantizes: the embeddings pass against JAX forward_embeddings
and w8a8 prefill logits against the JAX w8a8 forward (f32 activations
within 1e-5; bf16 ones within the bf16 bound above, the noise of
tests/test_torch_w8a8_model.py's 4.4e-2). Families outside the slice
still raise NotImplementedError at load."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.gguf.constants import GGMLType
from llama_box_tpu.gguf.writer import GGUFWriter
from llama_box_tpu.models import llama as jllama
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.models.loader import (deinterleave_rope as j_deint,
                                         fuse_projections as j_fuse)
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models.loader import (deinterleave_rope,
                                               fuse_projections, load_model,
                                               params_from_numpy)

from .fixtures.make_tiny_model import build_vocab
from .test_arch_families import ARCHS as FAMILY_ARCHS, _write_family

OWN_ARCHS = ["qwen2", "qwen3", "gpt2", "phi3", "bitnet", "hunyuan-dense",
             "olmo", "minicpm", "openelm"]
# openelm's per-layer query and KV head counts and FFN widths (padded at
# load to 6 / 2 heads, FF 128, q heads grouped at stride 3)
OPENELM = {"hc": [2, 6], "hk": [1, 2], "ff": [96, 128]}
# the attention variants: sliding windows with their layer pattern (and
# gemma3's local rope base, cohere2/exaone4's unroped global layers),
# attention softcap (gemma2), ALiBi (bloom, mpt, jais, refact)
ATTN_ARCHS = ["gemma2", "gemma3", "cohere2", "exaone4", "olmo3", "bloom",
              "mpt", "jais", "refact"]
ALL_ARCHS = FAMILY_ARCHS + OWN_ARCHS + ATTN_ARCHS
S, C, T = 2, 96, 12
WINDOW = 8      # the SWA families' window: the tests' prompts pass it
# enough layers that each pattern has a global layer
ATTN_LAYERS = {"gemma3": 6, "cohere2": 4, "exaone4": 4, "olmo3": 4}


def _header(path, arch, dims, extra=()):
    E, H, HKV, D, FF = dims
    vocab, scores, types = build_vocab()
    w = GGUFWriter(path, architecture=arch)
    kvs = {"block_count": 2, "context_length": 256, "embedding_length": E,
           "feed_forward_length": FF, "attention.head_count": H,
           "attention.head_count_kv": HKV,
           "attention.layer_norm_rms_epsilon": 1e-5,
           "attention.layer_norm_epsilon": 1e-5, "rope.freq_base": 10000.0,
           "rope.dimension_count": D, "vocab_size": len(vocab)}
    kvs.update(extra)
    for k, v in kvs.items():
        w.add_kv(f"{arch}.{k}", v)
    w.add_kv("tokenizer.ggml.model", "llama")
    w.add_kv("tokenizer.ggml.tokens", vocab)
    w.add_kv("tokenizer.ggml.scores", np.array(scores, np.float32))
    w.add_kv("tokenizer.ggml.token_type", np.array(types, np.int32))
    w.add_kv("tokenizer.ggml.bos_token_id", 1)
    w.add_kv("tokenizer.ggml.eos_token_id", 2)
    w.add_kv("tokenizer.ggml.add_bos_token", True)
    return w, len(vocab)


def write_own(path, arch, seed=0, dims=(64, 4, 2, 16, 128),
              quant=GGMLType.F32):
    """A 2-layer GGUF of one of OWN_ARCHS with the tensor names of its
    golden in tests/test_arch_goldens.py; random floats from `seed`, the
    2D projections in `quant`."""
    E, H, HKV, D, FF = dims
    rng = np.random.default_rng(seed)

    def rand(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def norm(n):
        return np.ones(n, np.float32) + rand(n, s=0.1)

    if arch == "openelm":
        _write_openelm(path, dims, rand, norm)
        return
    extra = {}
    if arch == "gpt2":
        extra["attention.head_count_kv"] = H
        HKV = H
    if arch == "phi3":
        extra["rope.scaling.original_context_length"] = 8
    if arch == "olmo":
        extra["attention.clamp_kqv"] = 0.3
    if arch == "minicpm":
        extra.update(embedding_scale=12.0, residual_scale=1.4 / 2 ** 0.5,
                     logit_scale=0.25)
    w, V = _header(path, arch, dims, extra.items())
    qd, kvd = H * D, HKV * D
    ln = arch in ("gpt2", "olmo")
    w.add_tensor("token_embd.weight", rand(V, E))
    if arch == "gpt2":
        w.add_tensor("position_embd.weight", rand(256, E))
    if arch == "phi3":
        w.add_tensor("rope_factors_long.weight",
                     (1.0 + rng.uniform(0.5, 3.0, D // 2)).astype(np.float32))
        w.add_tensor("rope_factors_short.weight",
                     (1.0 + rng.uniform(0.0, 0.3, D // 2)).astype(np.float32))
    if arch != "olmo":
        w.add_tensor("output_norm.weight", norm(E))
    if ln and arch != "olmo":
        w.add_tensor("output_norm.bias", rand(E))
    if arch not in ("qwen3", "minicpm"):     # those two tie the embeddings
        w.add_tensor("output.weight", rand(V, E), quant)
    for i in range(2):
        p = f"blk.{i}."
        if arch != "olmo":
            w.add_tensor(p + "attn_norm.weight", norm(E))
            w.add_tensor(p + "ffn_norm.weight", norm(E))
        if arch == "gpt2":
            w.add_tensor(p + "attn_norm.bias", rand(E))
            w.add_tensor(p + "ffn_norm.bias", rand(E))
        if arch in ("gpt2", "phi3"):
            w.add_tensor(p + "attn_qkv.weight", rand(qd + 2 * kvd, E), quant)
            if arch == "gpt2":
                w.add_tensor(p + "attn_qkv.bias", rand(qd + 2 * kvd))
        else:
            w.add_tensor(p + "attn_q.weight", rand(qd, E), quant)
            w.add_tensor(p + "attn_k.weight", rand(kvd, E), quant)
            w.add_tensor(p + "attn_v.weight", rand(kvd, E), quant)
        if arch == "qwen2":
            w.add_tensor(p + "attn_q.bias", rand(qd, s=0.5))
            w.add_tensor(p + "attn_k.bias", rand(kvd, s=0.5))
            w.add_tensor(p + "attn_v.bias", rand(kvd, s=0.5))
        if arch in ("qwen3", "hunyuan-dense"):
            w.add_tensor(p + "attn_q_norm.weight", norm(D))
            w.add_tensor(p + "attn_k_norm.weight", norm(D))
        w.add_tensor(p + "attn_output.weight", rand(E, qd), quant)
        if arch == "gpt2":
            w.add_tensor(p + "attn_output.bias", rand(E))
        if arch == "bitnet":
            w.add_tensor(p + "attn_sub_norm.weight", norm(E))
            w.add_tensor(p + "ffn_sub_norm.weight", norm(FF))
        if arch == "phi3":
            w.add_tensor(p + "ffn_up.weight", rand(2 * FF, E), quant)
        elif arch == "gpt2":
            w.add_tensor(p + "ffn_up.weight", rand(FF, E), quant)
            w.add_tensor(p + "ffn_up.bias", rand(FF))
        else:
            w.add_tensor(p + "ffn_gate.weight", rand(FF, E), quant)
            w.add_tensor(p + "ffn_up.weight", rand(FF, E), quant)
        w.add_tensor(p + "ffn_down.weight", rand(E, FF), quant)
        if arch == "gpt2":
            w.add_tensor(p + "ffn_down.bias", rand(E))
    w.write()


def _write_openelm(path, dims, rand, norm):
    """openelm (the golden's tensors, tests/test_arch_goldens.py): per-layer
    head counts and FFN widths as metadata arrays (OPENELM), a fused qkv
    at each layer's geometry, per-head [D] q/k norms, tied embeddings."""
    E, _, _, D, _ = dims
    hc, hk, ffs = OPENELM["hc"], OPENELM["hk"], OPENELM["ff"]
    w, V = _header(path, "openelm", dims, (
        ("attention.head_count", hc), ("attention.head_count_kv", hk),
        ("feed_forward_length", ffs), ("attention.key_length", D)))
    w.add_tensor("token_embd.weight", rand(V, E))
    w.add_tensor("output_norm.weight", norm(E))
    for i in range(2):
        p = f"blk.{i}."
        w.add_tensor(p + "attn_norm.weight", norm(E))
        w.add_tensor(p + "attn_qkv.weight", rand((hc[i] + 2 * hk[i]) * D, E))
        w.add_tensor(p + "attn_output.weight", rand(E, hc[i] * D))
        w.add_tensor(p + "attn_q_norm.weight", norm(D))
        w.add_tensor(p + "attn_k_norm.weight", norm(D))
        w.add_tensor(p + "ffn_norm.weight", norm(E))
        w.add_tensor(p + "ffn_gate.weight", rand(ffs[i], E))
        w.add_tensor(p + "ffn_up.weight", rand(ffs[i], E))
        w.add_tensor(p + "ffn_down.weight", rand(E, ffs[i]))
    w.write()


def write_attn(path, arch, seed=0, dims=(64, 4, 2, 16, 128),
               quant=GGMLType.F32, n_layers=None, window=WINDOW):
    """A GGUF of one of ATTN_ARCHS with the tensor names of its golden in
    tests/test_arch_goldens.py (random floats from `seed`, the 2D
    projections in `quant`): gemma2/3 with their sandwich norms (gemma3's
    per-head q/k norms and dual rope bases), cohere2's shared-norm
    parallel block, exaone4's and olmo3's post-norm-only blocks with
    per-head or whole-row q/k norms, bloom's embedding LayerNorm and biased
    fused qkv, mpt's bias-free LayerNorm, jais's biased SwiGLU and muP
    scales, refact's single KV head; the SWA families under a window of
    `window`."""
    E, H, HKV, D, FF = dims
    L = n_layers or ATTN_LAYERS.get(arch, 2)
    rng = np.random.default_rng(seed)

    def rand(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def norm(n):
        return np.ones(n, np.float32) + rand(n, s=0.1)

    if arch in ("bloom", "mpt", "jais"):
        HKV = H
    if arch == "refact":
        HKV = 1
    if arch == "bloom":
        FF = 4 * E
    extra = {"block_count": L, "attention.head_count_kv": HKV,
             "attention.key_length": D, "attention.value_length": D}
    if arch in ("gemma2", "gemma3", "cohere2", "exaone4", "olmo3"):
        extra["attention.sliding_window"] = window
    if arch == "gemma2":
        extra.update({"attn_logit_softcapping": 50.0,
                      "final_logit_softcapping": 30.0})
    if arch == "gemma3":
        extra.update({"rope.freq_base": 1e6, "rope.local_freq_base": 1e4})
    if arch == "cohere2":
        extra["logit_scale"] = 0.5
    if arch == "jais":
        extra.update(embedding_scale=4.0, logit_scale=0.5)
    if arch == "mpt":
        extra["attention.max_alibi_bias"] = 8.0
    w, V = _header(path, arch, (E, H, HKV, D, FF), extra.items())
    qd, kvd = H * D, HKV * D
    ln_b = arch in ("bloom", "jais")          # biased LayerNorms
    w.add_tensor("token_embd.weight", rand(V, E))
    if arch == "bloom":
        w.add_tensor("token_embd_norm.weight", norm(E))
        w.add_tensor("token_embd_norm.bias", rand(E))
    w.add_tensor("output_norm.weight", norm(E))
    if ln_b:
        w.add_tensor("output_norm.bias", rand(E))
    if arch not in ("gemma2", "gemma3", "cohere2"):   # those three tie
        w.add_tensor("output.weight", rand(V, E), quant)
    for i in range(L):
        p = f"blk.{i}."
        if arch not in ("exaone4", "olmo3"):
            w.add_tensor(p + "attn_norm.weight", norm(E))
            if ln_b:
                w.add_tensor(p + "attn_norm.bias", rand(E))
        if arch in ("gemma2", "gemma3", "exaone4", "olmo3"):
            w.add_tensor(p + "post_attention_norm.weight", norm(E))
            w.add_tensor(p + "post_ffw_norm.weight", norm(E))
        if arch in ("gemma2", "gemma3", "bloom", "mpt", "jais", "refact"):
            w.add_tensor(p + "ffn_norm.weight", norm(E))
            if ln_b:
                w.add_tensor(p + "ffn_norm.bias", rand(E))
        if arch in ("gemma3", "exaone4"):
            w.add_tensor(p + "attn_q_norm.weight", norm(D))
            w.add_tensor(p + "attn_k_norm.weight", norm(D))
        if arch == "olmo3":
            w.add_tensor(p + "attn_q_norm.weight", norm(qd))
            w.add_tensor(p + "attn_k_norm.weight", norm(kvd))
        if arch in ("bloom", "mpt", "jais"):
            w.add_tensor(p + "attn_qkv.weight", rand(qd + 2 * kvd, E), quant)
            if ln_b:
                w.add_tensor(p + "attn_qkv.bias", rand(qd + 2 * kvd))
        else:
            w.add_tensor(p + "attn_q.weight", rand(qd, E), quant)
            w.add_tensor(p + "attn_k.weight", rand(kvd, E), quant)
            w.add_tensor(p + "attn_v.weight", rand(kvd, E), quant)
        w.add_tensor(p + "attn_output.weight", rand(E, qd), quant)
        if ln_b:
            w.add_tensor(p + "attn_output.bias", rand(E))
        if arch not in ("bloom", "mpt"):
            w.add_tensor(p + "ffn_gate.weight", rand(FF, E), quant)
            if arch == "jais":
                w.add_tensor(p + "ffn_gate.bias", rand(FF))
        w.add_tensor(p + "ffn_up.weight", rand(FF, E), quant)
        if ln_b:
            w.add_tensor(p + "ffn_up.bias", rand(FF))
        w.add_tensor(p + "ffn_down.weight", rand(E, FF), quant)
        if ln_b:
            w.add_tensor(p + "ffn_down.bias", rand(E))
    w.write()


def write_arch(path, arch, seed=0):
    if arch in FAMILY_ARCHS:
        _write_family(path, arch, seed=seed)
    elif arch in ATTN_ARCHS:
        write_attn(path, arch, seed=seed)
    else:
        write_own(path, arch, seed=seed)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("families")
    out = {}
    for arch in ALL_ARCHS:
        out[arch] = str(d / f"{arch}.gguf")
        write_arch(out[arch], arch)
    return out


def _load_both(path, jdt, tdt, quantized=False):
    jcfg, jp = jax_load(path, dtype=jdt, quantized=quantized)
    jp, jcfg = j_deint(jp, jcfg)
    jp = j_fuse(jp, jcfg)
    tcfg, tp = load_model(path, dtype=tdt, device="cpu", quantized=quantized)
    tp, tcfg = deinterleave_rope(tp, tcfg)
    tp = fuse_projections(tp, tcfg)
    return jcfg, jp, tcfg, tp


def _prefill_both(jcfg, jp, tcfg, tp, kvj, kvt, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, 280, (S, T)).astype(np.int32)
    pos = np.array([0, 5], np.int32)
    nv = np.array([T, 9], np.int32)
    kv = jllama.init_kv_cache(jcfg, S, C, kvj)
    cos, sin = jllama.make_rope(jcfg, C)
    want, _ = jllama.prefill_batch(jp, jcfg, jnp.asarray(toks),
                                   jnp.asarray(pos), jnp.asarray(nv), kv,
                                   cos, sin)
    kv = tllama.init_kv_cache(tcfg, S, C, kvt, device="cpu")
    cos, sin = tllama.make_rope(tcfg, C, device="cpu")
    got, _ = tllama.prefill_batch_impl(tp, tcfg, torch.from_numpy(toks),
                                       pos, nv, kv, cos, sin)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_prefill_logits_match_jax(paths, arch, dt):
    jdt, tdt, rel, floor = {
        "f32": (jnp.float32, torch.float32, 1e-4, 1e-5),
        "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2, 3e-3)}[dt]
    jcfg, jp, tcfg, tp = _load_both(paths[arch], jdt, tdt)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    tllama.check_supported(tcfg, tp)
    got, want = _prefill_both(jcfg, jp, tcfg, tp, jdt, tdt)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max() + floor)


@pytest.mark.parametrize("arch", ALL_ARCHS)
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


@pytest.mark.parametrize("arch", ["gpt2", "qwen2", "olmo2", "phi3",
                                  "bitnet", "gemma3", "exaone4", "bloom",
                                  "jais"])
def test_params_from_numpy_carries_every_key(paths, arch):
    """The JAX loader's tree carried into torch (params_from_numpy) holds
    the port loader's keys and gives its prefill logits bit for bit."""
    jcfg, jp = jax_load(paths[arch], dtype=jnp.float32)
    tcfg, tp = load_model(paths[arch], dtype=torch.float32, device="cpu")
    carried = params_from_numpy(jax.tree.map(np.asarray, jp), jcfg)
    assert set(carried) == set(tp)
    assert set(carried["layers"]) == set(tp["layers"])
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


# -- one LayerNorm and one RMS family at widths the w8a8 path quantizes ------

W8_DIMS = (128, 4, 2, 32, 256)


@pytest.fixture(scope="module")
def w8_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("families_w8")
    out = {}
    for arch in ("gpt2", "qwen3"):
        for quant in ("F32", "Q8_0"):
            out[arch, quant] = str(d / f"{arch}-{quant}.gguf")
            write_own(out[arch, quant], arch, seed=7, dims=W8_DIMS,
                      quant=GGMLType[quant])
    return out


@pytest.mark.parametrize("arch", ["gpt2", "qwen3"])
@pytest.mark.parametrize("pooling", ["mean", "last"])
def test_embeddings_pass_matches_jax(w8_paths, arch, pooling):
    jcfg, jp, tcfg, tp = _load_both(w8_paths[arch, "F32"], jnp.float32,
                                    torch.float32)
    rng = np.random.default_rng(9)
    toks = rng.integers(3, 280, (3, 16)).astype(np.int32)
    lens = np.array([16, 9, 3], np.int32)
    jcos, jsin = jllama.make_rope(jcfg, 16)
    want = np.asarray(jllama.forward_embeddings(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), jcos, jsin,
        pooling=pooling))
    cos, sin = tllama.make_rope(tcfg, 16, device="cpu")
    got = tllama.forward_embeddings(tp, tcfg, torch.from_numpy(toks),
                                    torch.from_numpy(lens), cos, sin,
                                    pooling=pooling).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["gemma2", "gemma3", "cohere2", "bloom"])
def test_embeddings_pass_matches_jax_on_attention_variants(paths, arch):
    """The embeddings pass on the attention variants (rows past the
    window of 8): as in the JAX forward_embeddings, whose mask is the
    causal one alone, no layer attends under the window, while the rope
    branches (gemma3's local base, cohere2's unroped layers), the softcap
    (gemma2) and ALiBi (bloom) apply."""
    jcfg, jp, tcfg, tp = _load_both(paths[arch], jnp.float32, torch.float32)
    rng = np.random.default_rng(10)
    toks = rng.integers(3, 280, (3, 16)).astype(np.int32)
    lens = np.array([16, 12, 5], np.int32)
    jcos, jsin = jllama.make_rope(jcfg, 16)
    want = np.asarray(jllama.forward_embeddings(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), jcos, jsin,
        pooling="mean"))
    cos, sin = tllama.make_rope(tcfg, 16, device="cpu")
    got = tllama.forward_embeddings(tp, tcfg, torch.from_numpy(toks),
                                    torch.from_numpy(lens), cos, sin,
                                    pooling="mean").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["gpt2", "qwen3"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_w8a8_prefill_logits_match_jax(w8_paths, arch, dt):
    """f32 activations: the same int8 codes and sums, within 1e-5; bf16:
    the file's bf16 bound (a bf16 step that XLA skips moves an int8 code:
    the noise of tests/test_torch_w8a8_model.py's 4.4e-2 at |logit| up to
    about 2, here up to 2.3)."""
    jdt, tdt, rel, floor = {
        "f32": (jnp.float32, torch.float32, 0.0, 1e-5),
        "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2, 3e-3)}[dt]
    jcfg, jp, tcfg, tp = _load_both(w8_paths[arch, "Q8_0"], jdt, tdt,
                                    quantized=True)
    assert tp["layers"]["wo"].w8a8
    got, want = _prefill_both(jcfg, jp, tcfg, tp, jdt, tdt, seed=3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max() + floor)


@pytest.mark.parametrize("heads", [(4, 4), (12, 4), (20, 20), (32, 8)])
def test_alibi_slopes_match_jax(paths, heads):
    """The [Hkv, G] ALiBi slopes, power-of-two head counts and others (the
    ggml interleave past the largest power of two), bit for bit."""
    H, Hkv = heads
    tcfg, _ = load_model(paths["bloom"], dtype=torch.float32, device="cpu")
    jcfg, _ = jax_load(paths["bloom"], dtype=jnp.float32)
    got = tllama.alibi_slopes(dataclasses.replace(
        tcfg, n_heads=H, n_kv_heads=Hkv), "cpu")
    want = np.asarray(jllama._alibi_slopes(dataclasses.replace(
        jcfg, n_heads=H, n_kv_heads=Hkv)))
    assert got.shape == want.shape == (Hkv, H // Hkv)
    np.testing.assert_array_equal(got.numpy(), want)


# -- what stays refused -----------------------------------------------------


@pytest.mark.parametrize("flag,value,named", [
    ("mrope_sections", (4, 2, 2), "mrope"), ("v_head_dim", 32, "v_head_dim"),
    ("kv_lora_rank", 16, "kv_lora"), ("ssm_d_inner", 16, "recurrent")])
def test_outside_the_slice_is_refused_at_load(tmp_path, flag, value, named):
    """M-RoPE beside stacked rope tables (a local rope base), a V head
    width other than K's outside multi-head latent attention, an MLA rank
    without its tensors, a recurrent config whose layers carry no
    recurrent mixer: still refused by the port's check, by name (MLA files run: tests/test_torch_families_mla.py; M-RoPE alone
    passes the check and runs: tests/test_torch_multimodal_engine.py)."""
    path = str(tmp_path / "m.gguf")
    write_own(path, "qwen3")
    cfg, params = load_model(path, dtype=torch.float32, device="cpu")
    cfg = dataclasses.replace(cfg, **{flag: value})
    if flag == "mrope_sections":
        tllama.check_supported(cfg, params)
        cfg = dataclasses.replace(cfg, rope_freq_base_swa=1e4)
    with pytest.raises(NotImplementedError, match=named):
        tllama.check_supported(cfg, params)


@pytest.mark.parametrize("flag,value", [
    ("chunked_window", 8192), ("qk_l2_norm", True), ("attn_temp_scale", 0.1),
    ("expert_count", 4)])
def test_moe_and_llama4_config_is_in_the_slice(tmp_path, flag, value):
    """llama4's chunked window, q/k L2 norm and temperature and the
    experts' config now pass the port's check (tests/test_torch_families_
    moe.py runs them)."""
    path = str(tmp_path / "m.gguf")
    write_own(path, "qwen3")
    cfg, params = load_model(path, dtype=torch.float32, device="cpu")
    tllama.check_supported(dataclasses.replace(cfg, **{flag: value}), params)


def test_layer_groups_and_unknown_tensors_are_refused(tmp_path):
    """A layer group, or the layer stack, holding a tensor the port does
    not serve on this config (a recurrent mixer's ssm_in on a config that
    is not recurrent) is refused by its name; an unknown root key too."""
    path = str(tmp_path / "m.gguf")
    write_own(path, "qwen3")
    cfg, params = load_model(path, dtype=torch.float32, device="cpu")
    lay = dict(params["layers"], ssm_in=params["layers"]["q_norm"])
    base = {"tok_embd": params["tok_embd"],
            "output_norm": params["output_norm"]}
    with pytest.raises(NotImplementedError, match="ssm_in"):
        tllama.check_supported(cfg, dict(base, layer_groups=[
            params["layers"], lay]))
    with pytest.raises(NotImplementedError, match="ssm_in"):
        tllama.check_supported(cfg, dict(base, layers=lay))
    with pytest.raises(NotImplementedError, match="altup"):
        tllama.check_supported(cfg, dict(params, altup_proj=lay["q_norm"]))


@pytest.mark.parametrize("quantized", [False, True])
def test_openelm_pads_per_layer_geometry_as_jax(tmp_path, quantized):
    """openelm's per-layer head counts and FFN widths: the port's loader
    pads every layer to the largest geometry as the JAX loader does (q
    heads grouped by kv head at stride G_max, zero rows and columns),
    giving its config and its stacked tensors bit for bit; a quantized
    load stays dense in both (JAX's warning: the padding precedes
    packing)."""
    from llama_box_tpu_torch.ops.qmatmul import QTensor
    path = str(tmp_path / "openelm.gguf")
    write_own(path, "openelm", quant=GGMLType.Q8_0 if quantized
              else GGMLType.F32)
    jcfg, jp = jax_load(path, dtype=jnp.float32, quantized=quantized)
    tcfg, tp = load_model(path, dtype=torch.float32, device="cpu",
                          quantized=quantized)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.n_ff) == (6, 2, 128)
    assert set(tp["layers"]) == set(jp["layers"])
    for k, v in tp["layers"].items():
        assert not isinstance(v, QTensor)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jp["layers"][k]),
                                      err_msg=k)
    # layer 0 (2 q heads on 1 kv head): heads 0, 1 filled, 2 zero; kv 1 zero
    D = 16
    wq, wk = tp["layers"]["wq"][0], tp["layers"]["wk"][0]
    assert wq[:, :2 * D].abs().sum() > 0 and not wq[:, 2 * D:].any()
    assert not wk[:, D:].any() and not tp["layers"]["w_up"][0][:, 96:].any()
