"""Port parity of the recurrent hybrids against the JAX package on the CPU:
bamba (mamba2 mixers and roped attention), falcon-h1 (both mixers in every
layer, the mamba2 output riding the attention tail's extra residual),
lfm2 (gated short conv and q/k-normed attention), qwen3-next (gated
DeltaNet, gated attention with its output gate wq_gate, MoE with a shared
expert) and nemotron_h (a mamba2 block, an attention-only block and an
FFN-only block). The tiny models are the JAX tests' own (tests/test_mamba.py
fixtures, transformers weights exported to GGUF; nemotron_h's written
here from a seed); their JAX parameter trees carry into the port by
params_from_numpy.

For each: a batched prefill of two slots (ragged lengths, non-zero
entering states) gives the JAX logits within 1e-4 x max|logit|, and every
state leaf and the attention KV within 1e-5 x max|leaf| + 1e-6; then two
decode steps (the port's one-row step through the flash decode kernel's
plain version, one slot inactive) give the JAX one-row pass's logits and
states, and the inactive slot keeps its bits. init_rec_cache gives JAX's
leaves (an int8 cache type makes the hybrid's KV bf16, as in JAX)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.gguf import GGUFWriter
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.models import mamba as jm
from llama_box_tpu.models.llama import make_rope as j_make_rope
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models import mamba as tm
from llama_box_tpu_torch.models.config import ModelConfig
from llama_box_tpu_torch.models.loader import params_from_numpy

from .fixtures.make_tiny_model import build_vocab
from .test_mamba import (bamba_setup, falcon_h1_setup,  # noqa: F401
                         lfm2_setup, qwen3next_setup)

CAP = 64


def port_of(jcfg, jparams):
    """The JAX config and parameter tree, carried into the port."""
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    return cfg, params


def _close(got, want, rel, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale + (1e-6 if rel < 1e-4 else 0.0), \
        (what, err, scale)


def check_states(tc, jc, what=""):
    for name in ("conv", "ssm", "k", "v"):
        j = getattr(jc, name)
        t = getattr(tc, name)
        assert (j is None) == (t is None), name
        if j is not None:
            _close(t.float().numpy(), np.asarray(j, np.float32), 1e-5,
                   what + name)


def both_caches(jcfg, jp, cfg, tp, S, seed=7):
    """A JAX and a port cache of S slots holding the same random entering
    states (the attention KV zero)."""
    jc = jm.init_rec_cache(jcfg, S, capacity=CAP, params=jp)
    rng = np.random.default_rng(seed)
    conv = (rng.standard_normal(jc.conv.shape) * 0.1).astype(np.float32)
    ssm = (rng.standard_normal(jc.ssm.shape) * 0.1).astype(np.float32)
    jc = jc._replace(conv=jnp.asarray(conv), ssm=jnp.asarray(ssm))
    tc = tm.init_rec_cache(cfg, S, capacity=CAP, params=tp, device="cpu")
    tc.conv.copy_(torch.from_numpy(conv))
    tc.ssm.copy_(torch.from_numpy(ssm))
    return jc, tc


def prefill_and_decode(jcfg, jp, cfg, tp, S=2, T=12, seed=0):
    """The checks of the module docstring; returns the port cache."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, cfg.vocab_size, (S, T)).astype(np.int32)
    nv = np.array([T, 7][:S], np.int32)
    pb = np.zeros(S, np.int32)
    jc, tc = both_caches(jcfg, jp, cfg, tp, S)
    jcos = jsin = tcos = tsin = None
    if cfg.n_heads > 0:
        jcos, jsin = j_make_rope(jcfg, CAP)
        tcos, tsin = tllama.make_rope(cfg, CAP, device="cpu")
    jl, jc = jm.rec_prefill_batch_impl(jp, jcfg, jnp.asarray(toks),
                                       jnp.asarray(pb), jnp.asarray(nv), jc,
                                       jcos, jsin)
    tl, _ = tm.rec_prefill_batch_impl(tp, cfg, toks, pb, nv, tc, tcos, tsin)
    _close(tl.numpy(), np.asarray(jl), 1e-4, "prefill logits")
    check_states(tc, jc, "prefill ")
    pos = nv.astype(np.int64)
    for step in range(2):
        tok = rng.integers(3, cfg.vocab_size, (S,)).astype(np.int32)
        active = np.array([True, step == 0][:S])
        keep = tc.ssm[:, -1].clone()
        jl, jc = jm.rec_prefill_batch_impl(
            jp, jcfg, jnp.asarray(tok[:, None]), jnp.asarray(pos, jnp.int32),
            jnp.asarray(active.astype(np.int32)), jc, jcos, jsin)
        tl = tm._decode_step(tp, cfg, torch.from_numpy(tok).long(),
                             torch.from_numpy(pos), torch.from_numpy(active),
                             tc, tcos, tsin)
        live = np.flatnonzero(active)
        _close(tl.numpy()[live], np.asarray(jl)[live], 1e-4,
               f"decode {step} logits")
        check_states(tc, jc, f"decode {step} ")
        if not active[-1]:
            assert torch.equal(tc.ssm[:, -1], keep)
        pos = pos + active
    return tc


@pytest.mark.parametrize("fixture", ["bamba_setup", "falcon_h1_setup",
                                     "lfm2_setup", "qwen3next_setup"])
def test_hybrid_prefill_and_decode_match_jax(request, fixture):
    _, jcfg, jp, _ = request.getfixturevalue(fixture)
    cfg, tp = port_of(jcfg, jp)
    tllama.check_supported(cfg, tp)
    groups = tllama.layer_groups(tp)
    if fixture == "falcon_h1_setup":
        # both mixers in one layer: the extra residual's path
        assert any("ssm_in" in gp and "wq" in gp for gp in groups)
    if fixture == "qwen3next_setup":
        assert any("wq_gate" in gp for gp in groups)
        assert any("ssm_ba" in gp for gp in groups)
    # init_rec_cache's leaves, a hybrid's KV bf16 for an int8 cache type
    jc = jm.init_rec_cache(jcfg, 3, capacity=CAP, params=jp, dtype=jnp.int8)
    tc = tm.init_rec_cache(cfg, 3, capacity=CAP, params=tp,
                           dtype=torch.int8, device="cpu")
    assert [None if a is None else (tuple(a.shape), str(a.dtype))
            for a in tc] == \
        [None if b is None else (tuple(b.shape), f"torch.{b.dtype}")
         for b in jc]
    prefill_and_decode(jcfg, jp, cfg, tp)


def write_nemotron_h(path, seed=4):
    """A nemotron_h file of three blocks (mamba2, unroped attention,
    squared-ReLU MLP), as tests/test_mamba.py's composite golden lays it
    out, with random weights from `seed`."""
    from .fixtures.make_tiny_mamba import (M2_D_CONV, M2_D_STATE,
                                           M2_HEAD_DIM, M2_N_EMBD,
                                           M2_N_GROUPS, M2_N_HEADS)
    vocab, scores, types = build_vocab()
    V, E, H, HKV, FF = len(vocab), M2_N_EMBD, 4, 2, 96
    D = E // H
    di, ds, ng, nh = (M2_N_HEADS * M2_HEAD_DIM, M2_D_STATE, M2_N_GROUPS,
                      M2_N_HEADS)
    conv_dim = di + 2 * ng * ds
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.05):
        return rng.normal(size=shape, scale=scale).astype(np.float32)

    a = "nemotron_h"
    w = GGUFWriter(path, architecture=a)
    for k, v in [("block_count", 3), ("context_length", 256),
                 ("embedding_length", E), ("feed_forward_length", FF),
                 ("attention.head_count", H),
                 ("attention.head_count_kv", [0, HKV, 0]),
                 ("attention.layer_norm_rms_epsilon", 1e-5),
                 ("ssm.conv_kernel", M2_D_CONV), ("ssm.inner_size", di),
                 ("ssm.state_size", ds), ("ssm.time_step_rank", nh),
                 ("ssm.group_count", ng), ("vocab_size", V)]:
        w.add_kv(f"{a}.{k}", v)
    w.add_kv("tokenizer.ggml.model", "llama")
    w.add_kv("tokenizer.ggml.tokens", vocab)
    w.add_kv("tokenizer.ggml.scores", np.array(scores, np.float32))
    w.add_kv("tokenizer.ggml.token_type", np.array(types, np.int32))
    w.add_kv("tokenizer.ggml.bos_token_id", 1)
    w.add_kv("tokenizer.ggml.eos_token_id", 2)
    w.add_tensor("token_embd.weight", r(V, E))
    w.add_tensor("output_norm.weight", 1 + r(E, scale=0.1))
    w.add_tensor("output.weight", r(V, E))
    w.add_tensor("blk.0.attn_norm.weight", 1 + r(E, scale=0.1))
    w.add_tensor("blk.0.ssm_in.weight", r(2 * di + 2 * ng * ds + nh, E))
    w.add_tensor("blk.0.ssm_conv1d.weight", r(conv_dim, M2_D_CONV, scale=0.3))
    w.add_tensor("blk.0.ssm_conv1d.bias", r(conv_dim))
    w.add_tensor("blk.0.ssm_dt.bias", r(nh, scale=0.5))
    w.add_tensor("blk.0.ssm_a.weight",
                 -np.exp(r(nh, scale=0.5)).astype(np.float32))
    w.add_tensor("blk.0.ssm_d.weight", 1 + r(nh, scale=0.1))
    w.add_tensor("blk.0.ssm_norm.weight", 1 + r(di, scale=0.1))
    w.add_tensor("blk.0.ssm_out.weight", r(E, di))
    w.add_tensor("blk.1.attn_norm.weight", 1 + r(E, scale=0.1))
    w.add_tensor("blk.1.attn_q.weight", r(H * D, E))
    w.add_tensor("blk.1.attn_k.weight", r(HKV * D, E))
    w.add_tensor("blk.1.attn_v.weight", r(HKV * D, E))
    w.add_tensor("blk.1.attn_output.weight", r(E, H * D))
    w.add_tensor("blk.2.attn_norm.weight", 1 + r(E, scale=0.1))
    w.add_tensor("blk.2.ffn_up.weight", r(FF, E))
    w.add_tensor("blk.2.ffn_down.weight", r(E, FF))
    w.write()


def test_nemotron_h_prefill_and_decode_match_jax(tmp_path):
    """The FFN-only and attention-only blocks: loaded from the same file
    by both loaders into three layer groups."""
    from llama_box_tpu_torch.models.loader import load_model
    path = str(tmp_path / "nemotron_h.gguf")
    write_nemotron_h(path)
    jcfg, jp = jax_load(path, dtype=jnp.float32)
    cfg, tp = load_model(path, dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert len(tp["layer_groups"]) == 3
    tllama.check_supported(cfg, tp)
    prefill_and_decode(jcfg, jp, cfg, tp)
