"""Port parity of the dense llama model (llama_box_tpu_torch/models)
against the JAX package on the tiny fixture GGUF (f32 weights).

prefill_batch last-token logits: atol 1e-4 with an f32 KV cache; with a
bf16 or int8 KV cache attention runs in bf16 (the JAX model's `adt`), so
atol 2e-2. Both packages apply the load-time rope de-interleave and the
projection fusion before comparing (the engine does both at start)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.models import llama as jllama
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.models.loader import (deinterleave_rope as j_deint,
                                         fuse_projections as j_fuse)
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models.loader import (deinterleave_rope,
                                               fuse_projections, load_model,
                                               params_from_numpy)
from .fixtures.make_tiny_model import write_tiny_model

S, C, T = 3, 96, 32
KV = {"f32": (jnp.float32, torch.float32, 1e-4),
      "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2),
      "int8": (jnp.int8, torch.int8, 2e-2)}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tiny") / "tiny.gguf")
    write_tiny_model(path)
    jcfg, jp = jax_load(path, dtype=jnp.float32)
    jp, jcfg = j_deint(jp, jcfg)
    jp = j_fuse(jp, jcfg)
    tcfg, tp = load_model(path, dtype=torch.float32, device="cpu")
    tp, tcfg = deinterleave_rope(tp, tcfg)
    tp = fuse_projections(tp, tcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, jp, tcfg, tp


def _chunks():
    rng = np.random.default_rng(0)
    toks = rng.integers(3, 280, (2, S, T)).astype(np.int32)
    # second chunk: slot 0 continues, slot 1 idle, slot 2 continues short
    n1 = np.array([T, 20, 9], np.int32)
    p2 = np.array([T, 0, 9], np.int32)
    n2 = np.array([17, 0, 23], np.int32)
    return toks, (np.zeros(S, np.int32), n1), (p2, n2)


def _jax_prefill(jcfg, jp, kvd):
    kv = jllama.init_kv_cache(jcfg, S, C, kvd)
    cos, sin = jllama.make_rope(jcfg, C)
    toks, (p1, n1), (p2, n2) = _chunks()
    out = []
    for t, p, n in ((toks[0], p1, n1), (toks[1], p2, n2)):
        lg, kv = jllama.prefill_batch(jp, jcfg, jnp.asarray(t),
                                      jnp.asarray(p), jnp.asarray(n), kv,
                                      cos, sin)
        out.append(np.asarray(lg))
    return out


def _torch_prefill(tcfg, tp, kvd):
    kv = tllama.init_kv_cache(tcfg, S, C, kvd, device="cpu")
    cos, sin = tllama.make_rope(tcfg, C, device="cpu")
    toks, (p1, n1), (p2, n2) = _chunks()
    out = []
    for t, p, n in ((toks[0], p1, n1), (toks[1], p2, n2)):
        lg, kv = tllama.prefill_batch_impl(tp, tcfg, torch.from_numpy(t),
                                           p, n, kv, cos, sin)
        out.append(lg.numpy())
    return out, kv


@pytest.mark.parametrize("kv", sorted(KV))
def test_prefill_batch_logits(models, kv):
    jcfg, jp, tcfg, tp = models
    jdt, tdt, atol = KV[kv]
    want = _jax_prefill(jcfg, jp, jdt)
    got, _ = _torch_prefill(tcfg, tp, tdt)
    _, (_, n1), (_, n2) = _chunks()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=atol)
    live = n2 > 0     # an idle row's logits are discarded by the engine
    np.testing.assert_allclose(got[1][live], want[1][live], rtol=0,
                               atol=atol)


def test_params_from_numpy_gives_same_logits(models):
    jcfg, jp, tcfg, tp = models
    tp2 = params_from_numpy(jax.tree.map(np.asarray, jp), jcfg)
    assert set(tp2["layers"]) == set(tp["layers"])
    for k, v in tp["layers"].items():
        assert tp2["layers"][k].shape == v.shape
    a, _ = _torch_prefill(tcfg, tp, torch.float32)
    b, _ = _torch_prefill(tcfg, tp2, torch.float32)
    want = _jax_prefill(jcfg, jp, jnp.float32)
    np.testing.assert_allclose(b[0], a[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(b[0], want[0], rtol=0, atol=1e-4)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_decode_step_logits(models, kv):
    """One batched decode step after the prefill: the port's chained-decode
    forward (flash decode plain version) against the JAX forward."""
    jcfg, jp, tcfg, tp = models
    jdt, tdt, atol = KV[kv]
    toks, (p1, n1), _ = _chunks()
    nxt = np.array([[5], [7], [9]], np.int32)
    pos = n1[:, None].astype(np.int32)
    pos[1, 0] = C               # slot 1 inactive (sentinel position)

    kv_j = jllama.init_kv_cache(jcfg, S, C, jdt)
    cos_j, sin_j = jllama.make_rope(jcfg, C)
    _, kv_j = jllama.prefill_batch(jp, jcfg, jnp.asarray(toks[0]),
                                   jnp.asarray(p1), jnp.asarray(n1), kv_j,
                                   cos_j, sin_j)
    want, _ = jllama.forward(jp, jcfg, jnp.asarray(nxt), jnp.asarray(pos),
                             kv_j, jnp.asarray((pos[:, 0] < C).astype(
                                 np.int32)), cos_j, sin_j)

    kv_t = tllama.init_kv_cache(tcfg, S, C, tdt, device="cpu")
    cos_t, sin_t = tllama.make_rope(tcfg, C, device="cpu")
    _, kv_t = tllama.prefill_batch_impl(tp, tcfg, torch.from_numpy(toks[0]),
                                        p1, n1, kv_t, cos_t, sin_t)
    got, kv_t = tllama.forward_impl(tp, tcfg, torch.from_numpy(nxt), pos,
                                    kv_t, cos_t, sin_t)
    live = pos[:, 0] < C
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=0, atol=atol)
    # the rows went into the cache at the live positions only
    assert kv_t.k[:, 1, n1[1]:].abs().sum() == 0


def test_kv_quantize_matches_jax():
    """int8 cache rows: the same codes (round half to even) and the same
    bf16 scales as the JAX model's _kv_quantize, zero rows included."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3.0
    x[0, 1, 2] = 0.0
    x[1, 0, 0, :4] = [127.0, -63.5, 0.5, 1.5]   # exact ties
    qj, sj = jllama._kv_quantize(jnp.asarray(x))
    qt, st = tllama._kv_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.float().numpy(),
                                  np.asarray(sj.astype(jnp.float32)))


@pytest.mark.parametrize("change,refused", [
    (dict(head_dim=112), True), (dict(head_dim=192), True),
    (dict(head_dim=32), True), (dict(), True),        # the fixture's 16
    (dict(head_dim=64), False), (dict(head_dim=128), False),
    (dict(head_dim=64, v_head_dim=64), False),
    (dict(head_dim=64, n_heads=34, n_kv_heads=2), True),   # 17 a KV head
    (dict(head_dim=64, n_heads=32, n_kv_heads=2), False),
    (dict(head_dim=80), False), (dict(head_dim=96), False),
    (dict(head_dim=256), False)])
def test_cuda_refuses_head_shapes_the_kernels_cannot_take(models, change,
                                                          refused):
    """On a CUDA device the engine's check refuses, at load, a head width
    the attention kernels do not instantiate (64, 80, 96, 128, 256) or
    more than 16 query heads per KV head; the CPU's plain versions take
    any. (Building torch.device("cuda") needs no card.)"""
    _, _, tcfg, tp = models
    cfg = dataclasses.replace(tcfg, **change)
    tllama.check_supported(cfg, tp, torch.device("cpu"))
    tllama.check_supported(cfg, tp)
    if refused:
        with pytest.raises(NotImplementedError, match="head widths"):
            tllama.check_supported(cfg, tp, torch.device("cuda"))
    else:
        tllama.check_supported(cfg, tp, torch.device("cuda"))


def test_other_families_are_refused(tmp_path):
    """A GGUF with tensors no ported path knows (gemma3n's per-layer
    embeddings) is refused at load, never half-loaded; a mamba file, a
    recurrent family the port now serves (models/mamba.py), loads."""
    from .fixtures.make_tiny_mamba import write_tiny_mamba
    from .test_torch_families_moe import _write_refused
    path = str(tmp_path / "mamba.gguf")
    write_tiny_mamba(path)
    cfg, _ = load_model(path, dtype=torch.float32, device="cpu")
    assert cfg.recurrent
    path = str(tmp_path / "gemma3n.gguf")
    _write_refused(path, "gemma3n", ["per_layer_token_embd.weight"])
    with pytest.raises(NotImplementedError, match="per_layer_token_embd"):
        load_model(path, dtype=torch.float32, device="cpu")
