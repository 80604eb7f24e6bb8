"""Port parity of rwkv6 and rwkv7 against the JAX package on the CPU (the
cases of tests/test_rwkv.py, held against the JAX functions), on the JAX
fixtures' random GGUFs (tests/fixtures/make_tiny_rwkv.py) loaded by both
loaders, f32:

- the same config and layer groups (rwkv7's layer 0, without its v LoRA,
  a group of its own: v_first crosses groups), the port's check passes;
- batched prefill and two decode steps against JAX (logits within 1e-4 x
  max|JAX logit|, states within 1e-5 x max + 1e-6);
- prefill then decode consistency: a prompt prefilled whole gives the
  logits of its prefix prefilled and its last token decoded;
- chunk padding identity: a padded chunk gives the exact chunk's logits
  and states;
- rescale_every (the activations halved every n layers) against JAX;
- params_from_numpy carries the JAX trees over, groups and all."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.models import mamba as jm
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models import mamba as tm
from llama_box_tpu_torch.models.loader import load_model

from .fixtures.make_tiny_rwkv import write_tiny_rwkv6, write_tiny_rwkv7
from .test_torch_rec_hybrid import (CAP, _close, check_states,
                                    prefill_and_decode)

ARCHS = {"rwkv6": write_tiny_rwkv6, "rwkv7": write_tiny_rwkv7}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_rwkv")
    out = {}
    for name, write in ARCHS.items():
        path = str(d / f"{name}.gguf")
        write(path)
        out[name] = (*jax_load(path, dtype=jnp.float32),
                     *load_model(path, dtype=torch.float32, device="cpu"))
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_match_jax(models, arch):
    jcfg, jp, cfg, tp = models[arch]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    groups = tllama.layer_groups(tp)
    jg = jp.get("layer_groups") or [jp["layers"]]
    assert [sorted(g) for g in groups] == [sorted(g) for g in jg]
    if arch == "rwkv7":
        # layer 0 sets v_first, the next group mixes it in
        assert len(groups) == 2 and "tm_v0" not in groups[0] \
            and "tm_v0" in groups[1]
    tllama.check_supported(cfg, tp)
    prefill_and_decode(jcfg, jp, cfg, tp)


def _prefill(cfg, tp, toks, n=None, pos=0, cache=None):
    cache = cache or tm.init_rec_cache(cfg, 1, CAP, tp, device="cpu")
    logits, _ = tm.rec_prefill_impl(tp, cfg, torch.as_tensor(toks), cache,
                                    0, pos, len(toks) if n is None else n)
    return logits, cache


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_decode_consistency(models, arch):
    _, _, cfg, tp = models[arch]
    toks = np.random.default_rng(1).integers(3, cfg.vocab_size, 11)
    full, cf = _prefill(cfg, tp, toks)
    _, cache = _prefill(cfg, tp, toks[:-1])
    logits = tm._decode_step(tp, cfg, torch.as_tensor(toks[-1:]),
                             torch.tensor([10]), torch.tensor([True]), cache,
                             None, None)
    _close(logits[0].numpy(), full.numpy(), 1e-5, "logits")
    check_states(cache, cf)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_chunk_padding_identity(models, arch):
    _, _, cfg, tp = models[arch]
    toks = np.random.default_rng(2).integers(3, cfg.vocab_size, 9)
    exact, ce = _prefill(cfg, tp, toks)
    padded = np.zeros(16, np.int64)
    padded[:9] = toks
    got, cg = _prefill(cfg, tp, padded, n=9)
    _close(got.numpy(), exact.numpy(), 1e-5, "logits")
    check_states(cg, ce)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_rescale_every_matches_jax(models, arch):
    """rescale_every = 1 halves the activations after every layer, in both
    packages (the fixture's own files carry none)."""
    jcfg, jp, cfg, tp = models[arch]
    jcfg = dataclasses.replace(jcfg, rescale_every=1)
    cfg = dataclasses.replace(cfg, rescale_every=1)
    toks = np.random.default_rng(3).integers(3, cfg.vocab_size, (1, 10))
    jl, _ = jm.rec_prefill_batch_impl(
        jp, jcfg, jnp.asarray(toks, jnp.int32), jnp.zeros(1, jnp.int32),
        jnp.full((1,), 10, jnp.int32), jm.init_rec_cache(jcfg, 1))
    tl, _ = tm.rec_prefill_batch_impl(tp, cfg, toks, [0], [10],
                                      tm.init_rec_cache(cfg, 1, CAP, tp,
                                                        device="cpu"))
    _close(tl.numpy(), np.asarray(jl), 1e-4, "logits")
    base, _ = _prefill(dataclasses.replace(cfg, rescale_every=0), tp,
                       toks[0])
    assert not torch.allclose(base, tl[0])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_from_numpy_carries_the_jax_tree(models, arch):
    """The JAX package's rwkv trees (rwkv7's layer 0 without its v LoRA a
    group of its own; tm_w2 after the loaders' "3d" swap) carried by
    params_from_numpy equal the port loader's, key for key."""
    import jax

    from llama_box_tpu_torch.models.loader import params_from_numpy
    jcfg, jp, cfg, tp = models[arch]
    got = params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    groups = tllama.layer_groups(tp)
    assert [sorted(g) for g in tllama.layer_groups(got)] == \
        [sorted(g) for g in groups]
    for g_got, g_want in zip(tllama.layer_groups(got), groups):
        for k, w in g_want.items():
            assert torch.equal(g_got[k], w), k
