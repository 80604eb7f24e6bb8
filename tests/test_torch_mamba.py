"""Port parity of the mamba family against the JAX package on the CPU
(the cases of tests/test_mamba.py, held against the JAX functions in place
of transformers): mamba, mamba2 and jamba with and without MoE layers,
random GGUFs of the JAX fixtures (tests/fixtures/make_tiny_mamba.py)
loaded by both loaders, f32.

- both loaders give the same config and layer groups, and the port's
  check passes;
- batched prefill (two slots, ragged, non-zero entering states) and two
  decode steps: logits within 1e-4 x max|JAX logit|, every state leaf
  within 1e-5 x max|leaf| + 1e-6 (tests/test_torch_rec_hybrid.py's
  prefill_and_decode);
- the chunked prefill identity (9 + 7 rows against 16), a padded chunk
  against the exact one, a batched pass against single-slot ones (an idle
  slot keeps its bits);
- reset_rec_slot / copy_rec_state; init_rec_cache's shapes for every
  family against JAX's;
- a Q8_0 mamba file on the bf16 and w8a8 paths against JAX's (bf16
  activations, within 3e-2 x max|logit|)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.models import mamba as jm
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models import mamba as tm
from llama_box_tpu_torch.models.loader import load_model

from .fixtures.make_tiny_mamba import (write_tiny_jamba, write_tiny_mamba,
                                       write_tiny_mamba2)
from .fixtures.make_tiny_rwkv import write_tiny_rwkv6, write_tiny_rwkv7
from .test_torch_rec_hybrid import (CAP, _close, check_states,
                                    prefill_and_decode, write_nemotron_h)

WRITERS = {
    "mamba": write_tiny_mamba, "mamba2": write_tiny_mamba2,
    "jamba": write_tiny_jamba,
    "jamba_moe": lambda p: write_tiny_jamba(p, n_experts=4,
                                            n_experts_used=2),
    "rwkv6": write_tiny_rwkv6, "rwkv7": write_tiny_rwkv7,
    "nemotron_h": write_nemotron_h,
}
MAMBAS = ["mamba", "mamba2", "jamba", "jamba_moe"]


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mamba")
    out = {}
    for name, write in WRITERS.items():
        path = str(d / f"{name}.gguf")
        write(path)
        jcfg, jp = jax_load(path, dtype=jnp.float32)
        cfg, tp = load_model(path, dtype=torch.float32, device="cpu")
        out[name] = (jcfg, jp, cfg, tp)
    return out


@pytest.mark.parametrize("name", MAMBAS)
def test_prefill_and_decode_match_jax(models, name):
    jcfg, jp, cfg, tp = models[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jg = jp.get("layer_groups") or [jp["layers"]]
    assert [sorted(g) for g in tllama.layer_groups(tp)] == \
        [sorted(g) for g in jg]
    tllama.check_supported(cfg, tp)
    if name == "jamba_moe":
        assert any("w_gate_exps" in g for g in tllama.layer_groups(tp))
    prefill_and_decode(jcfg, jp, cfg, tp)


def _prefill(cfg, tp, toks, S=1, pos=0, n=None, cache=None, slot=0):
    cache = cache or tm.init_rec_cache(cfg, S, CAP, tp, device="cpu")
    cos = sin = None
    if cfg.n_heads > 0:
        cos, sin = tllama.make_rope(cfg, CAP, device="cpu")
    logits, _ = tm.rec_prefill_impl(tp, cfg, torch.as_tensor(toks), cache,
                                    slot, pos, len(toks) if n is None else n,
                                    cos, sin)
    return logits, cache


@pytest.mark.parametrize("name", MAMBAS)
def test_chunked_prefill_identity(models, name):
    """9 + 7 rows, the state carried, against 16 at once."""
    _, _, cfg, tp = models[name]
    toks = np.random.default_rng(2).integers(3, cfg.vocab_size, 16)
    full, cf = _prefill(cfg, tp, toks)
    _, cp = _prefill(cfg, tp, toks[:9])
    part, cp = _prefill(cfg, tp, toks[9:], pos=9, cache=cp)
    _close(part.numpy(), full.numpy(), 1e-5, "logits")
    check_states(cp, cf)


@pytest.mark.parametrize("name", MAMBAS)
def test_padded_chunk_matches_exact(models, name):
    """A bucket-padded chunk (n_valid < T): the pad rows change nothing."""
    _, _, cfg, tp = models[name]
    toks = np.random.default_rng(3).integers(3, cfg.vocab_size, 10)
    exact, ce = _prefill(cfg, tp, toks)
    padded = np.zeros(16, np.int64)
    padded[:10] = toks
    got, cg = _prefill(cfg, tp, padded, n=10)
    # the CPU's matmuls may round by the row count: f32 tolerance
    _close(got.numpy(), exact.numpy(), 1e-5, "logits")
    check_states(cg, ce)


@pytest.mark.parametrize("name", MAMBAS)
def test_batch_prefill_matches_single(models, name):
    """A batched pass (ragged, one idle slot holding a marker state) gives
    each slot's single-slot logits and states; the idle slot keeps its
    bits."""
    _, _, cfg, tp = models[name]
    rng = np.random.default_rng(4)
    t0 = rng.integers(3, cfg.vocab_size, 12)
    t1 = rng.integers(3, cfg.vocab_size, 7)
    cache = tm.init_rec_cache(cfg, 3, CAP, tp, device="cpu")
    cache.ssm[:, 2] = 1.25
    marker = cache.ssm[:, 2].clone()
    tokens = np.zeros((3, 12), np.int64)
    tokens[0], tokens[1, :7] = t0, t1
    cos = sin = None
    if cfg.n_heads > 0:
        cos, sin = tllama.make_rope(cfg, CAP, device="cpu")
    lg, _ = tm.rec_prefill_batch_impl(tp, cfg, tokens, [0, 0, 0],
                                      [12, 7, 0], cache, cos, sin)
    s0, c0 = _prefill(cfg, tp, t0)
    s1, c1 = _prefill(cfg, tp, t1)
    _close(lg[0].numpy(), s0.numpy(), 1e-5, "slot 0")
    _close(lg[1].numpy(), s1.numpy(), 1e-5, "slot 1")
    assert torch.equal(cache.ssm[:, 2], marker)
    _close(cache.ssm[:, 0].numpy(), c0.ssm[:, 0].numpy(), 1e-5, "state 0")


def test_state_ops():
    """reset_rec_slot zeroes one slot; copy_rec_state moves src -> dst
    (JAX tests/test_mamba.py test_mamba_state_ops), in place."""
    rng = np.random.default_rng(0)
    conv = rng.normal(size=(2, 3, 3, 8)).astype(np.float32)
    ssm = rng.normal(size=(2, 3, 8, 4)).astype(np.float32)
    c = tm.RecCache(torch.from_numpy(conv.copy()),
                    torch.from_numpy(ssm.copy()))
    jc = jm.copy_rec_state(jm.RecCache(jnp.asarray(conv), jnp.asarray(ssm)),
                           jnp.int32(0), jnp.int32(2))
    tm.copy_rec_state(c, 0, 2)
    np.testing.assert_array_equal(c.ssm.numpy(), np.asarray(jc.ssm))
    np.testing.assert_array_equal(c.conv.numpy(), np.asarray(jc.conv))
    jc = jm.reset_rec_slot(jc, jnp.int32(1))
    tm.reset_rec_slot(c, 1)
    np.testing.assert_array_equal(c.ssm.numpy(), np.asarray(jc.ssm))
    np.testing.assert_array_equal(c.conv.numpy(), np.asarray(jc.conv))
    assert float(c.ssm[:, 1].abs().max()) == 0.0


@pytest.mark.parametrize("name", list(WRITERS))
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_init_rec_cache_shapes_match_jax(models, name, dtype):
    """Every leaf's shape and dtype, a hybrid's KV bf16 for an int8 cache
    type as JAX makes it."""
    jcfg, jp, cfg, tp = models[name]
    jc = jm.init_rec_cache(jcfg, 3, capacity=CAP, params=jp,
                           dtype=getattr(jnp, dtype))
    tc = tm.init_rec_cache(cfg, 3, capacity=CAP, params=tp,
                           dtype=getattr(torch, dtype), device="cpu")
    for a, b in zip(tc, jc):
        assert (a is None) == (b is None)
        if a is not None:
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype).split(".")[-1] == str(b.dtype)


@pytest.mark.parametrize("quantized", [False, True])
def test_bf16_and_w8a8_prefill_match_jax(tmp_path, quantized):
    """A Q8_0 mamba file on the bf16 path and on the w8a8 one
    (--weights-dtype quantized: ssm_in and ssm_out as QTensors, ssm_x and
    ssm_dt dense at the fixture's widths, as the JAX loader leaves them):
    the port's logits against JAX's within 3e-2 x max|logit| (the bf16
    bound of tests/test_torch_families.py)."""
    from llama_box_tpu.gguf import GGMLType

    from llama_box_tpu_torch.ops.qmatmul import QTensor
    path = str(tmp_path / "mamba-q8.gguf")
    write_tiny_mamba(path, quant=GGMLType.Q8_0)
    jcfg, jp = jax_load(path, dtype=jnp.bfloat16, quantized=quantized)
    cfg, tp = load_model(path, dtype=torch.bfloat16, device="cpu",
                         quantized=quantized)
    assert isinstance(tp["layers"]["ssm_in"], QTensor) == quantized
    toks = np.random.default_rng(6).integers(3, cfg.vocab_size, (2, 16))
    jl, _ = jm.rec_prefill_batch_impl(
        jp, jcfg, jnp.asarray(toks, jnp.int32), jnp.zeros(2, jnp.int32),
        jnp.asarray([16, 9], jnp.int32), jm.init_rec_cache(jcfg, 2))
    tl, _ = tm.rec_prefill_batch_impl(tp, cfg, toks, [0, 0], [16, 9],
                                      tm.init_rec_cache(cfg, 2, device="cpu"))
    _close(tl.float().numpy(), np.asarray(jl, np.float32), 3e-2, "logits")
