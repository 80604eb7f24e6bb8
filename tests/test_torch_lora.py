"""Port parity of LoRA adapters (llama_box_tpu_torch/models/lora.py and the
forward's per-slot deltas, models/llama._lora_delta) against the JAX
package, on the tiny fixture model (tests/fixtures/make_tiny_model.py)
and adapters written here from a seed:
- load_lora, apply_lora and stack_dynamic give JAX's arrays (f32 stacks
  bit for bit, rank padding and a w8a8 base's dims included; merged f32
  and bf16 weights bit for bit), and refuse what JAX refuses;
- prefill logits under per-slot scale rows equal JAX's (f32 within 1e-5 x
  max|logit| + 1e-6: the port folds the adapter sum into the second
  product's inner dim where JAX sums after it; bf16 within 3e-2 x max +
  3e-3, as the families' bound); scale 0 gives the base model's logits
  and scale s the merged model's (f32, 1e-4 x max + 1e-5);
- the engine's greedy tokens equal the JAX engine's with two adapters and
  four slots of different mixes, through the batched prefill, chains, a
  one-token pass and verify passes, f32 and w8a8 (whose fused gates are
  off while scale rows are present);
- the reference's quirks, mirrored: a slot reuses a prefix computed under
  another adapter mix; the embeddings forward broadcasts the [S, n_ad]
  rows against its batch rows and raises TypeError where that fails; a
  layer-group tree has no `layers` (KeyError)."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.models import llama as jllama
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.models import lora as jlora
from llama_box_tpu.models.loader import fuse_projections as j_fuse
from llama_box_tpu.server import Engine as JEngine
from llama_box_tpu.server import EngineConfig as JEngineConfig
from llama_box_tpu.server.protocol import RequestError as JRequestError
from llama_box_tpu.server.protocol import parse_lora as j_parse_lora
from llama_box_tpu.server.task import CompletionsTask as JTask
from llama_box_tpu.sampling import SamplerParams as JSamplerParams
from llama_box_tpu.tokenizer import Tokenizer as JTokenizer
from llama_box_tpu.gguf import GGUFFile as JGGUFFile
from llama_box_tpu_torch.gguf import GGMLType, GGUFFile, GGUFWriter
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models import lora as tlora
from llama_box_tpu_torch.models.loader import fuse_projections, load_model
from llama_box_tpu_torch.ops.qmatmul import QTensor
from llama_box_tpu_torch.sampling import SamplerParams
from llama_box_tpu_torch.server.engine import Engine, EngineConfig
from llama_box_tpu_torch.server.protocol import RequestError, parse_lora
from llama_box_tpu_torch.server.task import CompletionsTask
from llama_box_tpu_torch.tokenizer import Tokenizer

from .fixtures import make_tiny_model as mtm

E, H, HKV, D, FF = (mtm.N_EMBD, mtm.N_HEADS, mtm.N_KV_HEADS, mtm.HEAD_DIM,
                    mtm.N_FF)
# base tensor -> (out, in) of the fixture's projections
SHAPES = {"attn_q": (H * D, E), "attn_k": (HKV * D, E),
          "attn_v": (HKV * D, E), "attn_output": (E, H * D),
          "ffn_gate": (FF, E), "ffn_up": (FF, E), "ffn_down": (E, FF)}
SCALES = np.array([[0.7, 0.3], [0.0, 0.0], [0.0, 1.0], [0.5, 0.5]],
                  np.float32)


def write_lora(path, seed, targets, rank, alpha, n_layers=mtm.N_LAYERS,
               shapes=SHAPES, output=None, scale=0.5):
    """An adapter GGUF: lora_a [r, in] and lora_b [out, r] for `targets`
    of every layer (and output.weight's, output = (vocab, E)), random
    from `seed` times `scale`."""
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path, architecture="llama")
    w.add_kv("general.type", "adapter")
    w.add_kv("adapter.type", "lora")
    w.add_kv("general.name", f"lora-{seed}")
    w.add_kv("adapter.lora.alpha", float(alpha))
    names = [f"blk.{i}.{t}" for i in range(n_layers) for t in targets]
    dims = {n: shapes[n.split(".")[2]] for n in names}
    if output is not None:
        names.append("output")
        dims["output"] = output
    for n in names:
        out, inn = dims[n]
        w.add_tensor(f"{n}.weight.lora_a", (rng.standard_normal(
            (rank, inn)) * scale).astype(np.float32))
        w.add_tensor(f"{n}.weight.lora_b", (rng.standard_normal(
            (out, rank)) * scale).astype(np.float32))
    w.write()
    return path


def _shapes(e, h, hkv, d, ff):
    return {"attn_q": (h * d, e), "attn_k": (hkv * d, e),
            "attn_v": (hkv * d, e), "attn_output": (e, h * d),
            "ffn_gate": (ff, e), "ffn_up": (ff, e), "ffn_down": (e, ff)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tiny model (f32) and, at the fused w8a8 kernels' widths (E 128,
    D 32, FF 256, as tests/test_torch_w8a8_model.py), its Q8_0 twin; two
    adapters for each: a on all seven targets and the output projection,
    rank 4; b on q, v and down, rank 2 (padded to 4 in the stacks)."""
    d = tmp_path_factory.mktemp("lora")
    out = {"dir": d, "model": mtm.write_tiny_model(str(d / "m.gguf"))}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mtm, "N_EMBD", 128)
        mp.setattr(mtm, "HEAD_DIM", 32)
        mp.setattr(mtm, "N_FF", 256)
        out["q8"] = mtm.write_tiny_model(str(d / "q8.gguf"),
                                         quant=GGMLType.Q8_0)
    with GGUFFile(out["model"]) as g:
        V = g.tensors["token_embd.weight"].shape[0]
    for sfx, dims in (("", (E, H, HKV, D, FF)),
                      ("8", (128, H, HKV, 32, 256))):
        sh = _shapes(*dims)
        out["a" + sfx] = write_lora(str(d / f"a{sfx}.gguf"), 1, list(sh), 4,
                                    8.0, shapes=sh, output=(V, dims[0]))
        out["b" + sfx] = write_lora(str(d / f"b{sfx}.gguf"), 2,
                                    ["attn_q", "attn_v", "ffn_down"], 2, 4.0,
                                    shapes=sh)
    return out


def _adapters(files, mod, scales=(0.8, 1.0), sfx=""):
    return [mod.load_lora(files["a" + sfx], scales[0]),
            mod.load_lora(files["b" + sfx], scales[1])]


def test_load_lora_matches_jax(files):
    for t, j in zip(_adapters(files, tlora), _adapters(files, jlora)):
        assert (t.name, t.path, t.alpha, t.scale, t.rank) == \
            (j.name, j.path, j.alpha, j.scale, j.rank)
        assert list(t.pairs) == list(j.pairs)
        for k in t.pairs:
            for x, y in zip(t.pairs[k], j.pairs[k]):
                np.testing.assert_array_equal(x, y)


def _non_adapter(files, kind):
    path = str(files["dir"] / f"{kind}.gguf")
    if kind == "model":
        return files["model"]
    w = GGUFWriter(path, architecture="llama")
    w.add_kv("general.type", "adapter")
    w.add_kv("adapter.type", "cvec" if kind == "cvec" else "lora")
    w.add_tensor("blk.0.attn_q.weight.lora_a", np.zeros((2, E), np.float32))
    w.write()
    return path


@pytest.mark.parametrize("kind", ["model", "cvec", "no_pairs"])
def test_non_adapter_files_are_refused_as_in_jax(files, kind):
    path = _non_adapter(files, kind)
    with pytest.raises(ValueError) as je:
        jlora.load_lora(path)
    with pytest.raises(ValueError) as te:
        tlora.load_lora(path)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_apply_lora_matches_jax(files, dt):
    """The merged weights, the output projection's too, bit for bit."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    jcfg, jp = jax_load(files["model"], dtype=jdt)
    tcfg, tp = load_model(files["model"], dtype=tdt, device="cpu")
    before = tp["layers"]["wq"].clone()
    jp = jlora.apply_lora(jp, jcfg, _adapters(files, jlora))
    tp = tlora.apply_lora(tp, tcfg, _adapters(files, tlora))
    assert torch.equal(load_model(files["model"], dtype=tdt,
                                  device="cpu")[1]["layers"]["wq"], before)
    for key in ["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"]:
        np.testing.assert_array_equal(
            tp["layers"][key].float().numpy(),
            np.asarray(jp["layers"][key], np.float32), err_msg=key)
    np.testing.assert_array_equal(tp["output"].float().numpy(),
                                  np.asarray(jp["output"], np.float32))


def test_quantized_base_as_jax(files):
    """A w8a8 base: apply_lora leaves every QTensor as it is (a warning
    each, as in JAX); stack_dynamic takes the dims from the QTensor."""
    jcfg, jp = jax_load(files["q8"], dtype=jnp.bfloat16, quantized=True)
    tcfg, tp = load_model(files["q8"], dtype=torch.bfloat16, device="cpu",
                          quantized=True)
    qs = tp["layers"]["wq"].qs
    tp = tlora.apply_lora(tp, tcfg, _adapters(files, tlora, sfx="8"))
    assert isinstance(tp["layers"]["wq"], QTensor) \
        and tp["layers"]["wq"].qs is qs
    n_j = jlora.stack_dynamic(jp, jcfg, _adapters(files, jlora, sfx="8"))
    n_t = tlora.stack_dynamic(tp, tcfg, _adapters(files, tlora, sfx="8"))
    assert n_t == n_j == 2
    _same_stacks(tp, jp)


def _same_stacks(tp, jp):
    keys = sorted(k for k in tp["layers"] if k.startswith("lora_"))
    assert keys == sorted(k for k in jp["layers"] if k.startswith("lora_"))
    for k in keys:
        np.testing.assert_array_equal(tp["layers"][k].numpy(),
                                      np.asarray(jp["layers"][k]), err_msg=k)
    return keys


def test_stack_dynamic_matches_jax(files):
    """Stacks of both adapters on every target, rank 2 padded to 4 with
    zeros; the engine's layout (lora_Bt_) is lora_B_'s transposed."""
    jcfg, jp = jax_load(files["model"], dtype=jnp.float32)
    tcfg, tp = load_model(files["model"], dtype=torch.float32, device="cpu")
    assert jlora.stack_dynamic(jp, jcfg, _adapters(files, jlora)) == 2
    assert tlora.stack_dynamic(tp, tcfg, _adapters(files, tlora)) == 2
    keys = _same_stacks(tp, jp)
    assert len(keys) == 14 and tp["layers"]["lora_A_wq"].shape == (
        2, 2, 4, E)
    assert not tp["layers"]["lora_A_wk"][:, 1].any()     # b has no k
    assert not tp["layers"]["lora_A_wq"][:, 1, 2:].any()  # padded rank
    fused = fuse_projections(tp, tcfg)["layers"]
    B = tp["layers"]["lora_B_w_down"]
    assert "lora_B_w_down" not in fused and torch.equal(
        fused["lora_Bt_w_down"], B.transpose(2, 3).reshape(2, 8, E))


def test_layer_groups_raise_key_error_as_in_jax(tmp_path, files):
    """A layer-group tree (here glm4moe's leading dense layer) has no
    `layers`: stack_dynamic and apply_lora raise KeyError in both."""
    from .test_torch_families_moe import write_moe
    path = str(tmp_path / "glm4moe.gguf")
    write_moe(path, "glm4moe")
    jcfg, jp = jax_load(path, dtype=jnp.float32)
    tcfg, tp = load_model(path, dtype=torch.float32, device="cpu")
    assert "layer_groups" in jp and "layer_groups" in tp
    for fn, mod, cfg, p in ((jlora.stack_dynamic, jlora, jcfg, jp),
                            (tlora.stack_dynamic, tlora, tcfg, tp),
                            (jlora.apply_lora, jlora, jcfg, jp),
                            (tlora.apply_lora, tlora, tcfg, tp)):
        with pytest.raises(KeyError):
            fn(p, cfg, _adapters(files, mod))


# -- the forward ---------------------------------------------------------------

S, T, C = 4, 9, 32


def _prefill(mod, params, cfg, kvdt, toks, pos, nv, device=None):
    if mod is tllama:
        kv = tllama.init_kv_cache(cfg, S, C, kvdt, device="cpu")
        cos, sin = tllama.make_rope(cfg, C, device="cpu")
        got, _ = tllama.prefill_batch_impl(params, cfg, torch.from_numpy(toks),
                                           pos, nv, kv, cos, sin)
        return got.float().numpy()
    kv = jllama.init_kv_cache(cfg, S, C, kvdt)
    cos, sin = jllama.make_rope(cfg, C)
    got, _ = jllama.prefill_batch(params, cfg, jnp.asarray(toks),
                                  jnp.asarray(pos), jnp.asarray(nv), kv,
                                  cos, sin)
    return np.asarray(got, np.float32)


def _dynamic(files, jdt, tdt, scales=SCALES):
    """Both packages' params with the two adapters stacked and the scale
    rows set, fused as their engines fuse under per-request LoRA (no rope
    de-interleave)."""
    jcfg, jp = jax_load(files["model"], dtype=jdt)
    tcfg, tp = load_model(files["model"], dtype=tdt, device="cpu")
    jlora.stack_dynamic(jp, jcfg, _adapters(files, jlora))
    tlora.stack_dynamic(tp, tcfg, _adapters(files, tlora))
    jp = j_fuse(jp, jcfg)
    tp = fuse_projections(tp, tcfg)
    jp["lora_scales"] = jnp.asarray(scales)
    tp["lora_scales"] = torch.tensor(scales)
    return jcfg, jp, tcfg, tp


TOKS = np.random.default_rng(5).integers(3, 280, (S, T)).astype(np.int32)
POS, NV = np.array([0, 3, 0, 5]), np.array([T, 6, T, 4])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dynamic_lora_prefill_matches_jax(files, dt):
    jdt, tdt, rel, floor = {
        "f32": (jnp.float32, torch.float32, 1e-5, 1e-6),
        "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2, 3e-3)}[dt]
    jcfg, jp, tcfg, tp = _dynamic(files, jdt, tdt)
    tllama.check_supported(tcfg, tp)
    want = _prefill(jllama, jp, jcfg, jdt, TOKS, POS, NV)
    got = _prefill(tllama, tp, tcfg, tdt, TOKS, POS, NV)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max() + floor)


def test_scale_zero_is_the_base_and_scale_s_the_merge(files):
    """Row 1 (scales 0) gives the base model's logits bit for bit; a row
    of (0.8, 1.0), the adapters' own scales, gives the model that
    apply_lora merged their layer pairs into (f32, within 1e-4 x max +
    1e-5); unfused projections give the fused ones' logits."""
    rows = np.array([[0.8, 1.0], [0.0, 0.0], [0.8, 1.0], [0.0, 0.0]],
                    np.float32)
    _, _, tcfg, tp = _dynamic(files, jnp.float32, torch.float32, rows)
    got = _prefill(tllama, tp, tcfg, torch.float32, TOKS, POS, NV)
    cfg, base = load_model(files["model"], dtype=torch.float32, device="cpu")
    base = fuse_projections(base, cfg)
    want0 = _prefill(tllama, base, cfg, torch.float32, TOKS, POS, NV)
    np.testing.assert_array_equal(got[1::2], want0[1::2])
    cfg, merged = load_model(files["model"], dtype=torch.float32,
                             device="cpu")
    # the dynamic path leaves output.weight's pair out, as JAX's does
    blk = [dataclasses.replace(a, pairs={k: v for k, v in a.pairs.items()
                                         if k.startswith("blk.")})
           for a in _adapters(files, tlora)]
    merged = tlora.apply_lora(merged, cfg, blk)
    want1 = _prefill(tllama, fuse_projections(merged, cfg), cfg,
                     torch.float32, TOKS, POS, NV)
    np.testing.assert_allclose(got[0::2], want1[0::2], rtol=0,
                               atol=1e-4 * np.abs(want1).max() + 1e-5)
    # the same stacks without fusion (lora_B_ read in JAX's layout)
    cfg, un = load_model(files["model"], dtype=torch.float32, device="cpu")
    tlora.stack_dynamic(un, cfg, _adapters(files, tlora))
    un["lora_scales"] = torch.from_numpy(rows)
    np.testing.assert_allclose(
        _prefill(tllama, un, cfg, torch.float32, TOKS, POS, NV), got,
        rtol=0, atol=1e-5 * np.abs(got).max())


def test_fused_gates_are_off_under_scale_rows(files):
    """The w8a8 decode gates (JAX `_fuse_qkv_ok` / `_fuse_tail_ok`) are
    false while scale rows are present, true without, on a bf16 decode
    row."""
    cfg, p = load_model(files["q8"], dtype=torch.bfloat16, device="cpu",
                        quantized=True)
    lp = tllama.layer_params(fuse_projections(p, cfg))[0]
    x = torch.zeros(S, 1, 128, dtype=torch.bfloat16)
    rows = torch.from_numpy(SCALES)
    assert tllama._fuse_qkv_ok(cfg, lp, x) and tllama._fuse_tail_ok(
        cfg, lp, x)
    assert not tllama._fuse_qkv_ok(cfg, lp, x, rows)
    assert not tllama._fuse_tail_ok(cfg, lp, x, rows)


@pytest.mark.parametrize("arch", ["qwen3moe", "minicpm3"])
def test_experts_and_mla_take_no_delta_as_in_jax(tmp_path, arch):
    """Routed experts and MLA's q/k/v take no delta, as in JAX (their keys
    are not targets, or the branch adds none); MLA's output projection
    does. The stacks and the prefill logits (f32) equal JAX's."""
    if arch == "qwen3moe":
        from .test_torch_families_moe import DIMS, FFE, write_moe
        path = str(tmp_path / "m.gguf")
        write_moe(path, arch)
        shapes = {"attn_q": (DIMS[1] * DIMS[3], DIMS[0]),
                  "attn_k": (DIMS[2] * DIMS[3], DIMS[0]),
                  "attn_v": (DIMS[2] * DIMS[3], DIMS[0]),
                  "attn_output": (DIMS[0], DIMS[1] * DIMS[3]),
                  "ffn_gate": (FFE, DIMS[0]), "ffn_up": (FFE, DIMS[0]),
                  "ffn_down": (DIMS[0], FFE)}
        n_layers, want_keys = 2, {"wq", "wk", "wv", "wo"}
    else:
        from . import test_torch_families_mla as fm
        path = str(tmp_path / "m.gguf")
        fm.write_mla(path, "minicpm3")
        shapes = {"attn_q": (fm.H * fm.DK, fm.E),
                  "attn_output": (fm.E, fm.H * fm.DV),
                  "ffn_gate": (fm.FF, fm.E), "ffn_up": (fm.FF, fm.E),
                  "ffn_down": (fm.E, fm.FF)}
        n_layers = 2
        want_keys = {"wo", "w_gate", "w_up", "w_down"}
    lpath = write_lora(str(tmp_path / "l.gguf"), 3, list(shapes), 2, 4.0,
                       n_layers=n_layers, shapes=shapes)
    jcfg, jp = jax_load(path, dtype=jnp.float32)
    tcfg, tp = load_model(path, dtype=torch.float32, device="cpu")
    jlora.stack_dynamic(jp, jcfg, [jlora.load_lora(lpath)])
    tlora.stack_dynamic(tp, tcfg, [tlora.load_lora(lpath)])
    keys = _same_stacks(tp, jp)
    assert {k[len("lora_A_"):] for k in keys if "_A_" in k} == want_keys
    jp, tp = j_fuse(jp, jcfg), fuse_projections(tp, tcfg)
    rows = np.array([[1.0], [0.5], [0.0], [2.0]], np.float32)
    jp["lora_scales"], tp["lora_scales"] = jnp.asarray(rows), \
        torch.from_numpy(rows)
    toks = np.random.default_rng(1).integers(3, 250, (S, T)).astype(np.int32)
    want = _prefill(jllama, jp, jcfg, jnp.float32, toks, POS, NV)
    got = _prefill(tllama, tp, tcfg, torch.float32, toks, POS, NV)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max() + 1e-5)


def test_embeddings_forward_broadcasts_the_rows_as_jax(files):
    """The embeddings forward reads the [S, n_ad] rows against its own B
    rows: B == S takes row b's scales, as JAX's broadcast does (f32 within
    1e-5); B == 1 < S raises TypeError in both."""
    jcfg, jp, tcfg, tp = _dynamic(files, jnp.float32, torch.float32)
    toks, lens = TOKS, np.array([T, 6, 3, T], np.int32)
    jcos, jsin = jllama.make_rope(jcfg, T)
    tcos, tsin = tllama.make_rope(tcfg, T, device="cpu")
    want = np.asarray(jllama.forward_embeddings(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), jcos, jsin))
    got = tllama.forward_embeddings(tp, tcfg, toks, lens, tcos, tsin).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(TypeError):
        jllama.forward_embeddings(jp, jcfg, jnp.asarray(toks[:1]),
                                  jnp.asarray(lens[:1]), jcos, jsin)
    with pytest.raises(TypeError):
        tllama.forward_embeddings(tp, tcfg, toks[:1], lens[:1], tcos, tsin)


# -- the engine ------------------------------------------------------------------

N_GEN, MARGIN = 6, 1e-3
PROMPTS = ([1, 106, 88, 120, 137, 202, 249], [1, 23, 261, 150, 102],
           [1, 40, 41, 42, 43, 44, 45, 46], [1, 9, 77, 200, 31])
MIXES = ((), ((0, 0.0), (1, 0.0)), ((1, 1.0),), ((0, 0.5), (1, 0.5)))
# the w8a8 wave's: each clears a 0.1 top-2 log-prob margin under its mix
W8_PROMPTS = ([1, 135, 74, 114, 273, 104], [1, 110, 260, 20, 199, 204, 78, 27],
              [1, 112, 274, 244, 67, 133], [1, 161, 44, 241, 127, 250])


def _collect(tasks, timeout=180):
    out = []
    for t in tasks:
        while True:
            kind, payload = t.result_q.get(timeout=timeout)
            if kind == "final":
                out.append(payload)
                break
            if kind == "error":
                raise payload
    return out


def _ecfg(cls, chain, **kw):
    return cls(n_slots=S, n_ctx=S * 64, n_ubatch=16, kv_dtype="float32",
               decode_chain=chain, **kw)


def _engine_pair(files, quantized, chain, **kw):
    dt = (jnp.bfloat16, torch.bfloat16) if quantized else \
        (jnp.float32, torch.float32)
    path = files["q8" if quantized else "model"]
    kvd = "bfloat16" if quantized else "float32"
    jcfg, jp = jax_load(path, dtype=dt[0], quantized=quantized)
    tcfg, tp = load_model(path, dtype=dt[1], device="cpu",
                          quantized=quantized)
    sfx = "8" if quantized else ""
    n = jlora.stack_dynamic(jp, jcfg, _adapters(files, jlora, sfx=sfx))
    tlora.stack_dynamic(tp, tcfg, _adapters(files, tlora, sfx=sfx))
    with JGGUFFile(path) as g:
        jtok = JTokenizer.from_gguf(g)
    with GGUFFile(path) as g:
        ttok = Tokenizer.from_gguf(g)
    jeng = JEngine(jcfg, jp, jtok, _ecfg(JEngineConfig, 4, **kw)
                   if not quantized else JEngineConfig(
                       n_slots=S, n_ctx=S * 64, n_ubatch=16, kv_dtype=kvd,
                       decode_chain=4, **kw))
    teng = Engine(tcfg, tp, ttok, _ecfg(EngineConfig, chain, **kw)
                  if not quantized else EngineConfig(
                      n_slots=S, n_ctx=S * 64, n_ubatch=16, kv_dtype=kvd,
                      decode_chain=chain, **kw), device="cpu")
    for eng in (jeng, teng):
        eng.configure_lora(n, [0.8, 1.0])
    return jeng, jtok, teng, ttok


def _wave(eng, tok, task_cls, sp_cls, prompts, mixes, want_probs=False,
          **sp):
    eng.start()
    try:
        kw = {"n_probs": 2} if want_probs else {}
        tasks = [task_cls(list(p), sp_cls(temp=0.0, **sp), tokenizer=tok,
                          max_tokens=N_GEN, lora=m, **kw)
                 for p, m in zip(prompts, mixes)]
        for t in tasks:
            eng.submit(t)
        return _collect(tasks)
    finally:
        eng.stop()


def _check_margins(finals, margin):
    for f in finals:
        for tp in f.probs:
            p0, p1 = tp.top_probs[:2]
            assert math.log(p0) - math.log(max(p1, 1e-30)) > margin, \
                "a near tie: pick another prompt"


@pytest.mark.parametrize("path,chain", [("f32", 1), ("f32", 4),
                                        ("w8a8", 4)])
def test_engine_greedy_mixes_match_jax(files, path, chain):
    """Four slots, four adapter mixes, one wave: the port engine's greedy
    tokens equal the JAX engine's (at K 1 and 4 on f32; w8a8 with bf16
    activations on prompts clearing a 0.1 margin), and both hold the same
    scale rows afterwards."""
    q = path == "w8a8"
    prompts = W8_PROMPTS if q else PROMPTS
    jeng, jtok, teng, ttok = _engine_pair(files, q, chain)
    want = [t.generated for t in _wave(jeng, jtok, JTask, JSamplerParams,
                                       prompts, MIXES)]
    finals = _wave(teng, ttok, CompletionsTask, SamplerParams, prompts,
                   MIXES, want_probs=True)
    _check_margins(finals, 0.1 if q else MARGIN)
    assert [f.generated for f in finals] == want
    np.testing.assert_array_equal(teng._lora_rows, jeng._lora_rows)
    assert torch.equal(teng.params["lora_scales"],
                       torch.from_numpy(teng._lora_rows))


def test_engine_one_token_and_verify_passes_match_jax(files):
    """n-gram drafts (verify passes of T = 1 + draft_max rows under each
    slot's row) beside a rate-limited slot (one-token passes): greedy
    tokens equal the JAX engine's."""
    from llama_box_tpu.utils.tokenbucket import RatelimitTokenBucket as JRB
    from llama_box_tpu_torch.utils.tokenbucket import RatelimitTokenBucket
    kw = dict(lookup_ngram_min=1, draft_max=3, lookup_min_accept=0.0)
    jeng, jtok, teng, ttok = _engine_pair(files, False, 2, **kw)
    prompts = [p + p[1:] for p in PROMPTS]     # repeats for the n-grams
    out = []
    for eng, tok, tc, sc, rb in ((jeng, jtok, JTask, JSamplerParams, JRB),
                                 (teng, ttok, CompletionsTask, SamplerParams,
                                  RatelimitTokenBucket)):
        eng.start()
        try:
            tasks = [tc(list(p), sc(temp=0.0), tokenizer=tok,
                        max_tokens=N_GEN, lora=m, n_probs=2)
                     for p, m in zip(prompts, MIXES)]
            tasks[3].rate_bucket = rb(1e6, 1e6)
            for t in tasks:
                eng.submit(t)
            out.append(_collect(tasks))
        finally:
            eng.stop()
    for finals in out:
        _check_margins(finals, MARGIN)
    assert [f.generated for f in out[1]] == [f.generated for f in out[0]]
    assert teng.metrics.n_drafted_total > 0


def test_prefix_reuse_across_adapter_mixes_as_jax(files):
    """The reference's quirk, mirrored: a request reuses the cached prefix
    another adapter mix computed (JAX `_admit_completion` matches tokens
    only); its tokens and n_cached equal the JAX engine's."""
    out = {}
    for pkg in ("jax", "port"):
        jeng, jtok, teng, ttok = _engine_pair(files, False, 4,
                                              cache_share_min=-1)
        eng, tok, tc, sc = (jeng, jtok, JTask, JSamplerParams) \
            if pkg == "jax" else (teng, ttok, CompletionsTask, SamplerParams)
        eng.start()
        try:
            res = []
            for mix in (((0, 0.0), (1, 0.0)), ((0, 1.0),)):
                t = tc(list(PROMPTS[0]), sc(temp=0.0), tokenizer=tok,
                       max_tokens=N_GEN, lora=mix)
                eng.submit(t)
                f = _collect([t])[0]
                res.append((f.generated, f.n_cached))
        finally:
            eng.stop()
        out[pkg] = res
    assert out["port"] == out["jax"]
    assert out["port"][1][1] > 0


def test_embeddings_request_under_lora_fails_as_jax(files):
    """An embeddings request of one input on a 4-slot engine under
    per-request LoRA fails with TypeError, as the JAX engine's does."""
    from llama_box_tpu.server.task import EmbeddingsTask as JEmb
    from llama_box_tpu_torch.server.task import EmbeddingsTask
    jeng, _, teng, _ = _engine_pair(files, False, 4)
    for eng, cls in ((jeng, JEmb), (teng, EmbeddingsTask)):
        eng.start()
        try:
            t = cls([[1, 5, 9]])
            eng.submit(t)
            kind, payload = t.result_q.get(timeout=120)
        finally:
            eng.stop()
        assert kind == "error" and isinstance(payload, TypeError)


@pytest.mark.parametrize("body", [
    {}, {"lora": None}, {"lora": []}, {"lora": [{"id": 1, "scale": 0.25}]},
    {"lora": [{"id": 0}]}, {"lora": {"id": 0}}, {"lora": [3]},
    {"lora": [{"scale": 1}]}, {"lora": [{"id": 2}]}, {"lora": [{"id": -1}]},
    {"lora": [{"id": True}]}, {"lora": [{"id": 0, "scale": "x"}]},
    {"lora": [{"id": 0, "scale": True}]}])
@pytest.mark.parametrize("n", [0, 2])
def test_parse_lora_matches_jax(body, n):
    try:
        want = ("ok", j_parse_lora(body, n))
    except JRequestError as e:
        want = ("err", e.status, e.message, e.param)
    try:
        got = ("ok", parse_lora(body, n))
    except RequestError as e:
        got = ("err", e.status, e.message, e.param)
    assert got == want
