"""Port parity of the grouped model path (`load_model(..., quantized=True)`
under LLAMA_BOX_TPU_PACKED4 or _Q4_INT8) against the JAX package, on the
CPU, on the tiny fixture GGUF at widths where Q4_K really lands
(N_EMBD=256, HEAD_DIM=64, N_FF=512: every row a whole 256-block) and with
Q4_K_M's tensor types, one per layer key: Q6_K for ffn_down and output,
Q4_K for the rest (output has 287 rows, not a multiple of 64, so both
packages keep it dense).

- the loaded QTensors equal the JAX loader's bit for bit (packed Q4_K
  codes, Q6_K codes in groups of 16, bf16 scales and mins);
- params_from_numpy of the JAX tree (bf16 leaves included) gives the
  port's own forward;
- prefill logits with f32 activations within 1e-4 of JAX's (both run
  q_matmul_ref on the CPU: f32 dequantization, f32 sums in another
  order), with bf16 activations within 5e-2 (the w8a8 path's tolerance:
  XLA on the CPU keeps f32 across fused bf16 ops, the port rounds at
  every point the code names), and decode logits within 5e-2;
- engine greedy tokens equal the JAX engine's, per-token and chained, on
  a prompt whose greedy steps all clear a top-2 logit margin of 0.1;
- the fused w8a8 gates are false for a grouped model (decode rows take
  mm);
- a key whose layers hold Q4_K and Q6_K cannot be stacked under the
  grouped residency: the JAX loader fails inside np.stack, the port's
  refuses it by name; the w8a8 residency loads it in both."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.fixtures.make_tiny_model as mk
from llama_box_tpu.gguf import GGUFFile as JGGUFFile, GGUFWriter as JWriter
from llama_box_tpu.gguf.constants import GGMLType
from llama_box_tpu.models import llama as jllama
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.models.loader import (deinterleave_rope as j_deint,
                                         fuse_projections as j_fuse)
from llama_box_tpu.ops.qmatmul import QTensor as JQTensor
from llama_box_tpu.sampling import SamplerParams as JSamplerParams
from llama_box_tpu.server import Engine as JEngine, EngineConfig as JEngineConfig
from llama_box_tpu.server.task import CompletionsTask as JTask
from llama_box_tpu.tokenizer import Tokenizer as JTokenizer
from llama_box_tpu_torch.gguf import GGUFFile
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models.loader import (_stack_qtensors,
                                               deinterleave_rope,
                                               fuse_projections, load_model,
                                               params_from_numpy)
from llama_box_tpu_torch.ops import qmatmul as tq
from llama_box_tpu_torch.ops.qmatmul import QTensor
from llama_box_tpu_torch.sampling import SamplerParams
from llama_box_tpu_torch.server.engine import Engine, EngineConfig
from llama_box_tpu_torch.server.task import CompletionsTask
from llama_box_tpu_torch.tokenizer import Tokenizer

SWITCHES = ("LLAMA_BOX_TPU_PACKED4", "LLAMA_BOX_TPU_Q4_INT8")
S, C, T = 3, 96, 32
ATOL = 5e-2
ATOL_F32 = 1e-4
PROMPT = [1, 193, 3, 114, 246, 160, 12, 220, 210, 243, 52, 28]
N_GEN = 8
MARGIN = 0.1


def _q4_k_m_type(name: str):
    """Q4_K_M's type for a 2D tensor: Q6_K for ffn_down and output."""
    if name == "output.weight" or name.endswith("ffn_down.weight"):
        return GGMLType.Q6_K
    return GGMLType.Q4_K


def _write(path, type_of):
    """The tiny fixture with each 2D weight's type given by
    type_of(name)."""
    class Writer(JWriter):
        def add_tensor(self, name, array, ggml_type=GGMLType.F32):
            if array.ndim == 2:
                ggml_type = type_of(name)
            super().add_tensor(name, array, ggml_type)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mk, "N_EMBD", 256)
        mp.setattr(mk, "HEAD_DIM", 64)
        mp.setattr(mk, "N_FF", 512)
        mp.setattr(mk, "GGUFWriter", Writer)
        mk.write_tiny_model(path, quant=GGMLType.Q4_K)
    return path


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp("q4km") / "tiny-q4_k_m.gguf"),
                  _q4_k_m_type)


def _load_both(path, switch, jdt=jnp.bfloat16, tdt=torch.bfloat16,
               prepared=True):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(switch, "1")
        jcfg, jp = jax_load(path, dtype=jdt, quantized=True)
        tcfg, tp = load_model(path, dtype=tdt, device="cpu", quantized=True)
    if prepared:
        jp, jcfg = j_deint(jp, jcfg)
        jp = j_fuse(jp, jcfg)
        tp, tcfg = deinterleave_rope(tp, tcfg)
        tp = fuse_projections(tp, tcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def models(path):
    """switch -> (jcfg, jax params, tcfg, port params), bf16 activations,
    after the rope de-interleave and the projection fusion."""
    return {sw: _load_both(path, sw) for sw in SWITCHES}


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint8) if a.dtype == np.int8 else a.view(np.uint32)


@pytest.mark.parametrize("switch", SWITCHES, ids=lambda s: s[14:])
def test_loaded_qtensors_equal_jax(path, switch):
    jcfg, jp, tcfg, tp = _load_both(path, switch, prepared=False)
    jl, tl = jp["layers"], tp["layers"]
    assert set(tl) <= set(jl)
    layouts = {}
    for key, tw in list(tl.items()) + [("output", tp["output"])]:
        jw = jp["output"] if key == "output" else jl[key]
        assert isinstance(tw, QTensor) == isinstance(jw, JQTensor), key
        if not isinstance(tw, QTensor):
            np.testing.assert_array_equal(_bits(tw), _bits(jw))
            continue
        assert (tw.w8a8, tw.packed4, tw.group, tw.in_dim) == (
            jw.w8a8, jw.packed4, jw.group, jw.in_dim), key
        for leaf in ("qs", "scales", "mins"):
            a, b = getattr(tw, leaf), getattr(jw, leaf)
            assert (a is None) == (b is None), (key, leaf)
            if a is not None:
                np.testing.assert_array_equal(_bits(a), _bits(b))
        layouts[key] = (tw.packed4, tw.group, tw.mins is not None,
                        tw.scales.dtype)
    packed = switch == "LLAMA_BOX_TPU_PACKED4"
    q4 = (packed, 32, True, torch.bfloat16)
    assert layouts == {"wq": q4, "wk": q4, "wv": q4, "wo": q4, "w_gate": q4,
                       "w_up": q4,
                       "w_down": (False, 16, False, torch.bfloat16)}
    assert not isinstance(tp["output"], QTensor)     # 287 rows
    np.testing.assert_array_equal(_bits(tp["tok_embd"]), _bits(jp["tok_embd"]))


def _chunks():
    rng = np.random.default_rng(0)
    toks = rng.integers(3, 280, (2, S, T)).astype(np.int32)
    n1 = np.array([T, 20, 9], np.int32)
    p2 = np.array([T, 0, 9], np.int32)
    n2 = np.array([17, 0, 23], np.int32)
    return toks, (np.zeros(S, np.int32), n1), (p2, n2)


def _jax_prefill(jcfg, jp, kvd=jnp.bfloat16):
    kv = jllama.init_kv_cache(jcfg, S, C, kvd)
    cos, sin = jllama.make_rope(jcfg, C)
    toks, (p1, n1), (p2, n2) = _chunks()
    out = []
    for t, p, n in ((toks[0], p1, n1), (toks[1], p2, n2)):
        lg, kv = jllama.prefill_batch(jp, jcfg, jnp.asarray(t),
                                      jnp.asarray(p), jnp.asarray(n), kv,
                                      cos, sin)
        out.append(np.asarray(lg))
    return out, kv


def _torch_prefill(tcfg, tp, kvd=torch.bfloat16):
    kv = tllama.init_kv_cache(tcfg, S, C, kvd, device="cpu")
    cos, sin = tllama.make_rope(tcfg, C, device="cpu")
    toks, (p1, n1), (p2, n2) = _chunks()
    out = []
    for t, p, n in ((toks[0], p1, n1), (toks[1], p2, n2)):
        lg, kv = tllama.prefill_batch_impl(tp, tcfg, torch.from_numpy(t),
                                           p, n, kv, cos, sin)
        out.append(lg.numpy())
    return out, kv


def _assert_prefill_close(got, want, atol):
    _, _, (_, n2) = _chunks()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=atol)
    np.testing.assert_allclose(got[1][n2 > 0], want[1][n2 > 0], rtol=0,
                               atol=atol)


@pytest.mark.parametrize("switch", SWITCHES, ids=lambda s: s[14:])
def test_params_from_numpy_gives_the_same_forward(models, switch):
    jcfg, jp, tcfg, tp = models[switch]
    tp2 = params_from_numpy(jax.tree.map(np.asarray, jp), jcfg)
    w = tp2["layers"]["wqkv"]
    assert isinstance(w, QTensor) and not w.w8a8
    assert w.scales.dtype == torch.bfloat16 and w.mins.dtype == torch.bfloat16
    assert w.packed4 == (switch == "LLAMA_BOX_TPU_PACKED4")
    a, _ = _torch_prefill(tcfg, tp)
    b, _ = _torch_prefill(tcfg, tp2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("switch", SWITCHES, ids=lambda s: s[14:])
def test_prefill_logits(models, switch):
    jcfg, jp, tcfg, tp = models[switch]
    _assert_prefill_close(_torch_prefill(tcfg, tp)[0],
                          _jax_prefill(jcfg, jp)[0], ATOL)


@pytest.mark.parametrize("switch", SWITCHES, ids=lambda s: s[14:])
def test_prefill_logits_f32_activations(path, switch):
    jcfg, jp, tcfg, tp = _load_both(path, switch, jnp.float32, torch.float32)
    _assert_prefill_close(_torch_prefill(tcfg, tp, torch.float32)[0],
                          _jax_prefill(jcfg, jp, jnp.float32)[0], ATOL_F32)


def test_decode_logits(models):
    jcfg, jp, tcfg, tp = models["LLAMA_BOX_TPU_PACKED4"]
    toks, (p1, n1), _ = _chunks()
    nxt = np.array([[5], [7], [9]], np.int32)
    pos = n1[:, None].astype(np.int32)
    pos[1, 0] = C               # slot 1 inactive
    kv_j = jllama.init_kv_cache(jcfg, S, C, jnp.bfloat16)
    cos_j, sin_j = jllama.make_rope(jcfg, C)
    _, kv_j = jllama.prefill_batch(jp, jcfg, jnp.asarray(toks[0]),
                                   jnp.asarray(p1), jnp.asarray(n1), kv_j,
                                   cos_j, sin_j)
    want, _ = jllama.forward(jp, jcfg, jnp.asarray(nxt), jnp.asarray(pos),
                             kv_j, jnp.asarray((pos[:, 0] < C).astype(
                                 np.int32)), cos_j, sin_j)
    kv_t = tllama.init_kv_cache(tcfg, S, C, torch.bfloat16, device="cpu")
    cos_t, sin_t = tllama.make_rope(tcfg, C, device="cpu")
    _, kv_t = tllama.prefill_batch_impl(tp, tcfg, torch.from_numpy(toks[0]),
                                        p1, n1, kv_t, cos_t, sin_t)
    got, _ = tllama.forward_impl(tp, tcfg, torch.from_numpy(nxt), pos, kv_t,
                                 cos_t, sin_t)
    live = pos[:, 0] < C
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=0, atol=ATOL)


def test_fused_gates_are_w8a8_only(models):
    _, _, tcfg, tp = models["LLAMA_BOX_TPU_PACKED4"]
    lp = {k: v.unbind(0)[0] for k, v in tp["layers"].items()}
    x = torch.zeros(4, 1, tcfg.n_embd, dtype=torch.bfloat16)
    assert isinstance(lp["wqkv"], QTensor) and not lp["wqkv"].w8a8
    assert not tllama._fuse_qkv_ok(tcfg, lp, x)
    assert not tllama._fuse_tail_ok(tcfg, lp, x)


def _run_engine(eng, task):
    eng.start()
    try:
        eng.submit(task)
        while True:
            kind, payload = task.result_q.get(timeout=300)
            if kind == "error":
                raise payload
            if kind == "final":
                return payload
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def greedy(path):
    """(package, chain) -> greedy tokens for PROMPT under PACKED4."""
    cache = {}

    def get(pkg, chain=1):
        if (pkg, chain) in cache:
            return cache[pkg, chain]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("LLAMA_BOX_TPU_PACKED4", "1")
            if pkg == "jax":
                cfg, params = jax_load(path, dtype=jnp.bfloat16,
                                       quantized=True)
                with JGGUFFile(path) as g:
                    tok = JTokenizer.from_gguf(g)
                eng = JEngine(cfg, params, tok,
                              JEngineConfig(n_slots=2, n_ctx=128))
                out = list(_run_engine(eng, JTask(
                    PROMPT, JSamplerParams(temp=0.0, seed=0), tokenizer=tok,
                    max_tokens=N_GEN, stream=False)).generated)
            else:
                cfg, params = load_model(path, dtype=torch.bfloat16,
                                         device="cpu", quantized=True)
                with GGUFFile(path) as g:
                    tok = Tokenizer.from_gguf(g)
                eng = Engine(cfg, params, tok,
                             EngineConfig(n_slots=2, n_ctx=128,
                                          decode_chain=chain), device="cpu")
                final = _run_engine(eng, CompletionsTask(
                    PROMPT, SamplerParams(temp=0.0, seed=0), tokenizer=tok,
                    max_tokens=N_GEN, n_probs=2))
                for p in final.probs:          # no near tie on this prompt
                    assert p.top_ids[0] == p.token
                    p0, p1 = p.top_probs[:2]
                    assert math.log(p0) - math.log(p1) > MARGIN, "a near tie"
                out = list(final.generated)
        cache[pkg, chain] = out
        return out
    return get


@pytest.mark.parametrize("chain", [1, 4])
def test_engine_greedy_matches_jax(greedy, chain):
    want = greedy("jax")
    assert len(want) == N_GEN
    assert greedy("port", chain) == want


@pytest.mark.parametrize("n_slots", [1, 4, 8])
def test_grouped_prefill_passes_take_the_unsplit_gemm(models, path,
                                                      n_slots):
    """On grouped weights every prefill bucket makes a pass of more than
    _SPLIT_MAX_ROWS rows (slots x bucket), so a prompt's rows take the
    unsplit grouped GEMM however much of the prompt was cached (a
    one-token chunk included); w8a8 weights keep every bucket."""
    _, _, tcfg, tp = models["LLAMA_BOX_TPU_PACKED4"]
    with GGUFFile(path) as g:
        tok = Tokenizer.from_gguf(g)
    ecfg = EngineConfig(n_slots=n_slots, n_ctx=n_slots * 128, n_ubatch=128)
    eng = Engine(tcfg, tp, tok, ecfg, device="cpu")
    assert eng.buckets and all(n_slots * b > tq._SPLIT_MAX_ROWS
                               for b in eng.buckets)
    assert eng._bucket(1) == min(b for b in (16, 32, 64, 128)
                                 if n_slots * b > tq._SPLIT_MAX_ROWS)
    cfg, params = load_model(path, dtype=torch.bfloat16, device="cpu",
                             quantized=True)
    assert Engine(cfg, params, tok, ecfg, device="cpu").buckets == (
        16, 32, 64, 128)


def test_grouped_media_chunks_take_the_unsplit_gemm(models, path):
    """A multimodal chunk prefills one slot alone (the engine's
    _prefill_chunk), its pass the bucket's rows: on grouped weights its
    buckets hold more than _SPLIT_MAX_ROWS rows, so a media prompt's rows
    take the unsplit grouped GEMM whether its last chunk is cold or all
    but one token came from the cache; w8a8 weights keep every bucket."""
    _, _, tcfg, tp = models["LLAMA_BOX_TPU_PACKED4"]
    with GGUFFile(path) as g:
        tok = Tokenizer.from_gguf(g)
    ecfg = EngineConfig(n_slots=4, n_ctx=4 * 256, n_ubatch=256)
    eng = Engine(tcfg, tp, tok, ecfg, device="cpu")
    assert eng.mm_buckets == (128, 256)
    assert eng._bucket(1, eng.mm_buckets) == eng._bucket(100,
                                                          eng.mm_buckets)
    assert eng._bucket(1) == 32
    cfg, params = load_model(path, dtype=torch.bfloat16, device="cpu",
                             quantized=True)
    assert Engine(cfg, params, tok, ecfg, device="cpu").mm_buckets == (
        16, 32, 64, 128, 256)


def _mixed_type(name):
    """ffn_down Q6_K in layer 0 only (as llama.cpp's Q4_K_M mixes it)."""
    return GGMLType.Q6_K if name == "blk.0.ffn_down.weight" else GGMLType.Q4_K


def test_mixed_formats_of_one_key(tmp_path, monkeypatch):
    p = _write(str(tmp_path / "tiny-mixed.gguf"), _mixed_type)
    # w8a8: every format becomes [in, out] int8, so both packages load it
    for s in SWITCHES + ("LLAMA_BOX_TPU_Q4_F32SCALES",):
        monkeypatch.delenv(s, raising=False)
    _, jp = jax_load(p, dtype=jnp.bfloat16, quantized=True)
    _, tp = load_model(p, dtype=torch.bfloat16, device="cpu", quantized=True)
    assert tp["layers"]["w_down"].w8a8 and jp["layers"]["w_down"].w8a8
    # grouped: the layers of w_down pack to two layouts
    monkeypatch.setenv("LLAMA_BOX_TPU_PACKED4", "1")
    with pytest.raises(ValueError):
        jax_load(p, dtype=jnp.bfloat16, quantized=True)
    with pytest.raises(ValueError, match=r"w_down.*Q4_K.*Q6_K"):
        load_model(p, dtype=torch.bfloat16, device="cpu", quantized=True)


def test_dense_and_quantized_layers_of_one_key(tmp_path, monkeypatch):
    """A key with an F16 layer beside Q4_K ones is refused by name (the
    JAX loader's stack fails on it too)."""
    p = _write(str(tmp_path / "tiny-f16-layer.gguf"),
               lambda n: GGMLType.F16 if n == "blk.1.attn_output.weight"
               else GGMLType.Q4_K)
    monkeypatch.setenv("LLAMA_BOX_TPU_PACKED4", "1")
    with pytest.raises(ValueError, match="wo: some layers are quantized"):
        load_model(p, dtype=torch.bfloat16, device="cpu", quantized=True)


def test_stack_qtensors_refuses_differing_layouts():
    def qt(packed4, group, mins):
        rows = 32 if packed4 else 64
        return QTensor(torch.zeros(rows, 64, dtype=torch.int8),
                       torch.ones(64 // group, 64),
                       torch.zeros(64 // group, 64) if mins else None,
                       64, group, packed4)
    a, b = qt(True, 32, True), qt(False, 16, False)
    stacked = _stack_qtensors([a, a], "wq", ["Q4_K", "Q4_K"])
    assert tuple(stacked.qs.shape) == (2, 32, 64) and stacked.packed4
    with pytest.raises(ValueError, match=r"wq.*packed4=False.*packed4=True.*Q4_K.*Q6_K"):
        _stack_qtensors([a, b], "wq", ["Q4_K", "Q6_K"])
    # mins present in one layer only: refused, never dropped
    with pytest.raises(ValueError, match="mins"):
        _stack_qtensors([qt(False, 32, False), qt(False, 32, True)], "wo",
                        ["Q4_K", "Q4_K"])
    assert tq.mm(torch.zeros(2, 64), stacked.unbind(0)[1]).shape == (2, 64)
