"""The port's norms (llama_box_tpu_torch/ops/norm.py) against the JAX
functions they copy: ops/norm.rms_norm, models/llama._norm_any (RMS, and
LayerNorm with and without a bias) and models/llama._ln_per_head, on the
same numpy inputs, [rows, E] and [B, T, H, D], f32 and bf16. On the CPU
each wrapper runs its plain version (the CUDA kernel csrc/norm.cu is held
to these on the card by tests/test_torch_gpu.py).

Tolerances: f32 within 2e-6 (the row sums run in another order); bf16
within one bf16 rounding (rtol 2**-7: the f32 result before the cast can
move by a few f32 ulps and cross a rounding point)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.models import llama as jllama
from llama_box_tpu.models.config import ModelConfig as JModelConfig
from llama_box_tpu.ops.norm import rms_norm as j_rms_norm
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models.config import ModelConfig
from llama_box_tpu_torch.ops import norm as tnorm

DT = {"f32": (jnp.float32, torch.float32, 0.0, 2e-6),
      "bf16": (jnp.bfloat16, torch.bfloat16, 2 ** -7, 1e-6)}
SHAPES = {"rows": (7, 96), "heads": (2, 3, 4, 32)}


def _inputs(shape, seed=0, groups=1):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    x = (rng.standard_normal(shape) * 1.5 + 0.2).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(groups * n)).astype(np.float32)
    b = (0.1 * rng.standard_normal(groups * n)).astype(np.float32)
    return x, w, b


def _both(a, jdt, tdt):
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _check(got, want, rel, floor):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=floor)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dt", list(DT))
def test_rms_norm_matches_jax(shape, dt):
    jdt, tdt, rel, floor = DT[dt]
    x, w, _ = _inputs(SHAPES[shape])
    (jx, tx), (jw, tw) = _both(x, jdt, tdt), _both(w, jdt, tdt)
    got = tnorm.rms_norm(tx, tw, 1e-6)
    assert got.dtype == tdt
    _check(got, j_rms_norm(jx, jw, 1e-6), rel, floor)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dt", list(DT))
@pytest.mark.parametrize("style,bias", [("ln", True), ("ln", False),
                                        ("rms", True)])
def test_norm_any_matches_jax(shape, dt, style, bias):
    """JAX `_norm_any` through the port's model-level `_norm_any` (an RMS
    style ignores the bias, as in JAX)."""
    jdt, tdt, rel, floor = DT[dt]
    x, w, b = _inputs(SHAPES[shape], seed=1)
    (jx, tx), (jw, tw), (jb, tb) = (_both(a, jdt, tdt) for a in (x, w, b))
    jcfg = JModelConfig(norm_style=style, rms_eps=1e-5)
    tcfg = ModelConfig(norm_style=style, rms_eps=1e-5)
    want = jllama._norm_any(jx, jw, jb if bias else None, jcfg)
    got = tllama._norm_any(tx, tw, tb if bias else None, tcfg)
    assert got.dtype == tdt
    _check(got, want, rel, floor)
    assert torch.equal(got, tnorm.norm_any_plain(
        tx, tw, tb if bias else None, style, 1e-5))


@pytest.mark.parametrize("dt", list(DT))
def test_ln_per_head_matches_jax(dt):
    """chameleon: a weight and bias of their own for each of H heads."""
    jdt, tdt, rel, floor = DT[dt]
    B, T, H, D = SHAPES["heads"]
    x, w, b = _inputs((B, T, H, D), seed=2, groups=H)
    (jx, tx), (jw, tw), (jb, tb) = (_both(a, jdt, tdt) for a in (x, w, b))
    want = jllama._ln_per_head(jx, jw, jb, H, D)
    got = tnorm.ln_per_head(tx, tw, tb)
    _check(got, want, rel, floor)


@pytest.mark.parametrize("dt", list(DT))
def test_qk_norms_match_jax_attention_norms(dt):
    """The three q/k norm forms of `_attn_layer` (per head, whole row,
    per-head biased LayerNorm) as the port's `_qk_norms` applies them."""
    jdt, tdt, rel, floor = DT[dt]
    B, T, H, D = SHAPES["heads"]
    q, wd, bd = _inputs((B, T, H, D), seed=3)
    _, wr, br = _inputs((B, T, H, D), seed=4, groups=H)
    cfg = ModelConfig(rms_eps=1e-6)
    (jq, tq) = _both(q, jdt, tdt)
    for lp_np, want in (
            ({"q_norm": wd}, j_rms_norm(jq, jnp.asarray(wd, jdt), 1e-6)),
            ({"q_norm": wr}, j_rms_norm(
                jq.reshape(B, T, -1), jnp.asarray(wr, jdt),
                1e-6).reshape(B, T, H, D)),
            ({"q_norm": wr, "q_norm_b": br}, jllama._ln_per_head(
                jq, jnp.asarray(wr, jdt), jnp.asarray(br, jdt), H, D))):
        lp = {k: torch.from_numpy(v).to(tdt) for k, v in lp_np.items()}
        lp.update({k.replace("q_", "k_"): v for k, v in lp.items()})
        got, got_k = tllama._qk_norms(tq, tq, lp, cfg)
        assert torch.equal(got, got_k)
        _check(got, want, rel, floor)


def test_row_norm_raises_on_what_the_kernel_does_not_take():
    """The kernel's own checks run before any launch (here on CPU tensors,
    which the public wrappers never hand it)."""
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="weight"):
        tnorm.row_norm(x, torch.ones(4), None, False, 1e-5)
    with pytest.raises(ValueError, match="dtype"):
        tnorm.row_norm(x.half(), torch.ones(8), None, False, 1e-5)
    with pytest.raises(ValueError, match="bias"):
        tnorm.row_norm(x, torch.ones(8), torch.ones(3), True, 1e-5)


def test_model_config_is_the_jax_config():
    assert [f.name for f in dataclasses.fields(ModelConfig)] \
        == [f.name for f in dataclasses.fields(JModelConfig)]
