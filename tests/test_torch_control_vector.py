"""Port parity of control vectors (llama_box_tpu_torch/models/
control_vector.py and the forward's residual add after each layer,
models/llama._run_stack) against the JAX package:
- load_control_vector and combine_control_vectors, the layer range and the
  width check give JAX's arrays and errors;
- prefill logits with params["cvec"] equal JAX's on the tiny dense model
  and on a layer-group model (glm4moe's leading dense layer), f32 within
  1e-4 x max|logit| + 1e-5, bf16 within 3e-2 x max + 3e-3 (the families'
  bounds); a zero vector leaves the port's logits unchanged, bit for bit;
- the embeddings forward reads it as JAX's does;
- on the w8a8 path the fused decode gates stay on under a control vector
  (it adds nothing inside the fused tail);
- the CLI's --control-vector(-scaled) and --control-vector-layer-range
  give JAX's [L, E] in the weights' dtype."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.models import control_vector as jcv
from llama_box_tpu.models import llama as jllama
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.models.loader import deinterleave_rope as j_deint
from llama_box_tpu.models.loader import fuse_projections as j_fuse
from llama_box_tpu_torch.gguf import GGMLType, GGUFWriter
from llama_box_tpu_torch.models import control_vector as tcv
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models.loader import (deinterleave_rope,
                                               fuse_projections, load_model)

from .fixtures import make_tiny_model as mtm


def write_cvec(path, n_layers, n_embd, seed=0, scale=1.0):
    """A control-vector GGUF: direction.<N> (1-based) for every layer."""
    rng = np.random.default_rng(seed)
    w = GGUFWriter(str(path), architecture="controlvector")
    for li in range(n_layers):
        w.add_tensor(f"direction.{li + 1}",
                     (rng.standard_normal(n_embd) * scale).astype(
                         np.float32))
    w.write()
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from .test_torch_families_moe import DIMS, write_moe
    d = tmp_path_factory.mktemp("cvec")
    out = {"model": mtm.write_tiny_model(str(d / "m.gguf")),
           "groups": str(d / "glm4moe.gguf"), "dir": d}
    write_moe(out["groups"], "glm4moe")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mtm, "N_EMBD", 128)
        mp.setattr(mtm, "HEAD_DIM", 32)
        mp.setattr(mtm, "N_FF", 256)
        out["q8"] = mtm.write_tiny_model(str(d / "q8.gguf"),
                                         quant=GGMLType.Q8_0)
    out["a"] = write_cvec(d / "a.gguf", 2, mtm.N_EMBD, seed=1, scale=0.3)
    out["b"] = write_cvec(d / "b.gguf", 2, mtm.N_EMBD, seed=2, scale=0.3)
    out["g"] = write_cvec(d / "g.gguf", 3, DIMS[0], seed=3, scale=0.3)
    out["a8"] = write_cvec(d / "a8.gguf", 2, 128, seed=4, scale=0.5)
    out["six"] = write_cvec(d / "six.gguf", 6, 8, seed=5)
    return out


@pytest.mark.parametrize("case", [
    dict(entries=[("a", 1.0), ("b", -0.5)], n=2, e=64),
    dict(entries=[("six", 1.0)], n=6, e=8, layer_range=(2, 4)),
    dict(entries=[("six", 0.25)], n=4, e=8, layer_range=(0, 9)),
    dict(entries=[("six", 2.0)], n=8, e=8)])
def test_combine_matches_jax(files, case):
    entries = [(files[k], s) for k, s in case["entries"]]
    kw = {"layer_range": case.get("layer_range")}
    want = jcv.combine_control_vectors(entries, case["n"], case["e"], **kw)
    got = tcv.combine_control_vectors(entries, case["n"], case["e"], **kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_width_check_raises_as_jax(files):
    with pytest.raises(ValueError) as je:
        jcv.load_control_vector(files["six"], 6, 16)
    with pytest.raises(ValueError) as te:
        tcv.load_control_vector(files["six"], 6, 16)
    assert str(te.value) == str(je.value)


S, T, C = 2, 9, 32


def _prefill_pair(path, cv, jdt, tdt, port_only=False):
    """(port logits, JAX logits) of one batched prefill with the vector
    `cv` (None: none); the port's alone with port_only."""
    tcfg, tp = load_model(path, dtype=tdt, device="cpu")
    tp, tcfg = deinterleave_rope(tp, tcfg)
    tp = fuse_projections(tp, tcfg)
    if cv is not None:
        tp["cvec"] = torch.from_numpy(cv).to(tdt)
    toks = np.random.default_rng(2).integers(3, 250, (S, T)).astype(np.int32)
    pos, nv = np.array([0, 4]), np.array([T, 5])
    kv = tllama.init_kv_cache(tcfg, S, C, tdt, device="cpu")
    cos, sin = tllama.make_rope(tcfg, C, device="cpu")
    got, _ = tllama.prefill_batch_impl(tp, tcfg, torch.from_numpy(toks),
                                       pos, nv, kv, cos, sin)
    if port_only:
        return got.float().numpy()
    jcfg, jp = jax_load(path, dtype=jdt)
    jp, jcfg = j_deint(jp, jcfg)
    jp = j_fuse(jp, jcfg)
    if cv is not None:
        jp["cvec"] = jnp.asarray(cv, jdt)
    kv = jllama.init_kv_cache(jcfg, S, C, jdt)
    cos, sin = jllama.make_rope(jcfg, C)
    want, _ = jllama.prefill_batch(jp, jcfg, jnp.asarray(toks),
                                   jnp.asarray(pos), jnp.asarray(nv), kv,
                                   cos, sin)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("model,dt", [("model", "f32"), ("model", "bf16"),
                                      ("groups", "f32")])
def test_cvec_prefill_matches_jax(files, model, dt):
    jdt, tdt, rel, floor = {
        "f32": (jnp.float32, torch.float32, 1e-4, 1e-5),
        "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2, 3e-3)}[dt]
    key, n, e = ("a", 2, mtm.N_EMBD) if model == "model" else ("g", 3, 64)
    cv = tcv.combine_control_vectors([(files[key], 0.8)], n, e,
                                     layer_range=(2, 3))
    got, want = _prefill_pair(files[model], cv, jdt, tdt)
    base = _prefill_pair(files[model], None, jdt, tdt, port_only=True)
    assert np.abs(got - base).max() > 1e-2      # it steers
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max() + floor)


def test_zero_cvec_changes_nothing(files):
    zero = np.zeros((2, mtm.N_EMBD), np.float32)
    got = _prefill_pair(files["model"], zero, jnp.float32, torch.float32,
                        port_only=True)
    base = _prefill_pair(files["model"], None, jnp.float32, torch.float32,
                         port_only=True)
    np.testing.assert_array_equal(got, base)


def test_embeddings_forward_reads_the_vector_as_jax(files):
    cv = tcv.combine_control_vectors([(files["a"], 1.0)], 2, mtm.N_EMBD)
    jcfg, jp = jax_load(files["model"], dtype=jnp.float32)
    tcfg, tp = load_model(files["model"], dtype=torch.float32, device="cpu")
    jp["cvec"], tp["cvec"] = jnp.asarray(cv), torch.from_numpy(cv)
    toks = np.random.default_rng(4).integers(3, 250, (3, T)).astype(np.int32)
    lens = np.array([T, 4, 7], np.int32)
    jcos, jsin = jllama.make_rope(jcfg, T)
    tcos, tsin = tllama.make_rope(tcfg, T, device="cpu")
    want = np.asarray(jllama.forward_embeddings(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), jcos, jsin))
    got = tllama.forward_embeddings(tp, tcfg, toks, lens, tcos, tsin).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_w8a8_keeps_the_fused_decode_kernels(files):
    """The fused gates look at nothing of the vector: a w8a8 decode row
    under a control vector takes the fused kernels (unlike under
    per-request LoRA, tests/test_torch_lora.py)."""
    tcfg, tp = load_model(files["q8"], dtype=torch.bfloat16, device="cpu",
                          quantized=True)
    tp["cvec"] = torch.from_numpy(tcv.combine_control_vectors(
        [(files["a8"], 1.0)], 2, 128)).to(torch.bfloat16)
    tp = fuse_projections(tp, tcfg)
    lp = tllama.layer_params(tp)[0]
    x = torch.zeros(2, 1, 128, dtype=torch.bfloat16)
    assert tllama._fuse_qkv_ok(tcfg, lp, x, tp.get("lora_scales")) \
        and tllama._fuse_tail_ok(tcfg, lp, x, tp.get("lora_scales"))


def test_cli_loads_the_vectors_as_jax(files):
    """build_server's control vectors: the JAX CLI's combine (both flags,
    the layer range) cast to the weights' dtype on the device."""
    from llama_box_tpu_torch.cli import build_parser, load_cvec
    args = build_parser().parse_args([
        "-m", files["model"], "--control-vector", files["a"],
        "--control-vector-scaled", files["b"], "-0.5",
        "--control-vector-layer-range", "2", "2"])
    cfg, _ = load_model(files["model"], dtype=torch.float32, device="cpu")
    got = load_cvec(args, cfg, torch.bfloat16, "cpu")
    want = jcv.combine_control_vectors(
        [(files["a"], 1.0), (files["b"], -0.5)], 2, mtm.N_EMBD,
        layer_range=(2, 2))
    assert got.dtype == torch.bfloat16 and not got[0].any()
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(jnp.asarray(want, jnp.bfloat16), np.float32))
