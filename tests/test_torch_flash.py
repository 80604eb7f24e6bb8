"""Port parity: the plain torch versions of the flash kernels
(llama_box_tpu_torch/ops/flash_prefill.py, flash_decode.py) against the
JAX package's Pallas kernels run in interpret mode, on the same numpy
inputs. (The hand-written kernels are held against the plain versions on
a CUDA card in test_torch_gpu.py.)

Tolerances: atol 2e-5 on f32 inputs (summation order only); atol 2e-2
on bf16 inputs and int8 caches (p is rounded to bf16 before it weights V,
at a running max that differs between the block structures)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from llama_box_tpu.ops.flash_decode import flash_decode as jax_decode
from llama_box_tpu.ops.flash_prefill import flash_prefill_batched as jax_prefill
from llama_box_tpu_torch.ops.flash_decode import flash_decode
from llama_box_tpu_torch.ops.flash_prefill import flash_prefill_batched
from .torch_cases import (DECODE_CASES, PREFILL_CASES, as_t, decode_case,
                          prefill_case, valid_rows)

F32_ATOL = 2e-5
BF16_ATOL = 2e-2


@pytest.mark.parametrize("name", sorted(PREFILL_CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_plain_matches_pallas(name, dtype):
    kw = dict(PREFILL_CASES[name])
    win = np.asarray(kw.pop("win", (0, 0)), np.int32)
    softcap = kw.pop("softcap", 0.0)
    rng = np.random.default_rng(7)
    sinks = (rng.standard_normal((2, 2)).astype(np.float32) * 2.0
             if kw.pop("sinks", False) else None)
    c = prefill_case(rng, **kw)
    if name == "fresh_slot":   # a fresh slot must never read its cache
        c["kc"] = np.full_like(c["kc"], np.nan)
        c["vc"] = np.full_like(c["vc"], np.nan)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    cdt_j = None if "ks" in c else jdt
    cdt_t = None if "ks" in c else tdt
    scales_j = ({} if "ks" not in c else
                dict(k_scale=jnp.asarray(c["ks"]), v_scale=jnp.asarray(c["vs"])))
    scales_t = ({} if "ks" not in c else
                dict(k_scale=as_t(c["ks"]), v_scale=as_t(c["vs"])))
    want = np.asarray(jax_prefill(
        jnp.asarray(c["q"], jdt), jnp.asarray(c["kc"], cdt_j),
        jnp.asarray(c["vc"], cdt_j), jnp.asarray(c["kr"], jdt),
        jnp.asarray(c["vr"], jdt), jnp.asarray(c["meta"]), jnp.asarray(win),
        sinks=None if sinks is None else jnp.asarray(sinks),
        softcap=softcap, bq=32, bc=32, interpret=True, **scales_j))
    got = flash_prefill_batched(
        as_t(c["q"], tdt), as_t(c["kc"], cdt_t), as_t(c["vc"], cdt_t),
        as_t(c["kr"], tdt), as_t(c["vr"], tdt), as_t(c["meta"]), as_t(win),
        sinks=None if sinks is None else as_t(sinks), softcap=softcap,
        **scales_t)
    assert got.dtype == torch.float32
    atol = F32_ATOL if dtype == "f32" and "ks" not in c else BF16_ATOL
    valid_rows(got.numpy(), want, c["meta"], atol)


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_plain_matches_pallas(name, dtype):
    kw = dict(DECODE_CASES[name])
    win = np.asarray(kw.pop("win", (0, 0)), np.int32)
    softcap = kw.pop("softcap", 0.0)
    rng = np.random.default_rng(11)
    sinks = (rng.standard_normal((2, 2)).astype(np.float32) * 2.0
             if kw.pop("sinks", False) else None)
    c = decode_case(rng, **kw)
    layer = 1 if kw.get("layers") else None
    if name == "fresh_slot":   # chain start 0: the cache is never read
        c["kc"] = np.full_like(c["kc"], np.nan)
        c["vc"] = np.full_like(c["vc"], np.nan)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    cdt_j = None if "ks" in c else jdt
    cdt_t = None if "ks" in c else tdt
    scales_j = ({} if "ks" not in c else
                dict(k_scale=jnp.asarray(c["ks"]), v_scale=jnp.asarray(c["vs"])))
    scales_t = ({} if "ks" not in c else
                dict(k_scale=as_t(c["ks"]), v_scale=as_t(c["vs"])))
    want = np.asarray(jax_decode(
        jnp.asarray(c["q"], jdt), jnp.asarray(c["kc"], cdt_j),
        jnp.asarray(c["vc"], cdt_j), jnp.asarray(c["kr"], jdt),
        jnp.asarray(c["vr"], jdt), jnp.asarray(c["meta"]), jnp.asarray(win),
        layer=None if layer is None else jnp.int32(layer),
        sinks=None if sinks is None else jnp.asarray(sinks),
        softcap=softcap, bc=32, interpret=True, **scales_j))
    got = flash_decode(
        as_t(c["q"], tdt), as_t(c["kc"], cdt_t), as_t(c["vc"], cdt_t),
        as_t(c["kr"], tdt), as_t(c["vr"], tdt), as_t(c["meta"]), as_t(win),
        layer=layer, sinks=None if sinks is None else as_t(sinks),
        softcap=softcap, **scales_t)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    atol = F32_ATOL if dtype == "f32" and "ks" not in c else BF16_ATOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_cpu_tensors_never_touch_the_kernels(monkeypatch):
    """On the CPU a wrapper takes its plain version because the tensors lie
    there: neither the build nor a launch is reached."""
    from llama_box_tpu_torch.ops import _kernels

    def boom(*a, **k):
        raise AssertionError("kernel path reached on CPU tensors")
    monkeypatch.setattr(_kernels, "call", boom)
    monkeypatch.setattr(_kernels, "build", boom)
    rng = np.random.default_rng(0)
    c = decode_case(rng)
    before = flash_decode.launches
    flash_decode(as_t(c["q"]), as_t(c["kc"]), as_t(c["vc"]), as_t(c["kr"]),
                 as_t(c["vr"]), as_t(c["meta"]), torch.zeros(2, dtype=torch.int32))
    p = prefill_case(rng)
    flash_prefill_batched(as_t(p["q"]), as_t(p["kc"]), as_t(p["vc"]), as_t(p["kr"]),
                          as_t(p["vr"]), as_t(p["meta"]),
                          torch.zeros(2, dtype=torch.int32))
    assert flash_decode.launches == before


@pytest.mark.parametrize("split", [1, 63, 64, 137])
@pytest.mark.parametrize("win", [(0, 0), (24, 0), (0, 32)],
                         ids=["causal", "window", "chunk"])
def test_prefill_plain_cold_equals_cached_prefix(split, win):
    """A prompt prefilled in one pass gives the rows that the same prompt
    gives with its first `split` positions already in the cache (f32, up
    to summation order). csrc/flash_prefill.cu holds this bit for bit on
    a bf16 cache (test_torch_gpu.py)."""
    rng = np.random.default_rng(split)
    B, Hkv, G, T, C, D = 2, 2, 2, 160, 192, 32
    c = prefill_case(rng, B=B, Hkv=Hkv, G=G, T=T, C=C, D=D, pos0=(0, 0),
                     n_valid=(T, T))
    c["kc"][:] = np.nan                  # a cold slot never reads its cache
    c["vc"][:] = np.nan
    w = as_t(np.asarray(win, np.int32))
    cold = flash_prefill_batched(*(as_t(c[k]) for k in ("q", "kc", "vc",
                                                        "kr", "vr")),
                                 as_t(c["meta"]), w)
    kc, vc = c["kc"].copy(), c["vc"].copy()
    kc[:, :split], vc[:, :split] = c["kr"][:, :split], c["vr"][:, :split]
    meta = np.array([[split, T - split, 0, 0]] * B, np.int32)
    warm = flash_prefill_batched(
        as_t(c["q"][:, :, :, split:]), as_t(kc), as_t(vc),
        as_t(c["kr"][:, split:]), as_t(c["vr"][:, split:]), as_t(meta), w)
    assert torch.isfinite(warm).all()
    np.testing.assert_allclose(warm.numpy(), cold[:, :, :, split:].numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("C,want", [(1, (128, 1)), (256, (128, 2)),
                                    (2048, (128, 16)), (8192, (128, 64)),
                                    (8193, (192, 43)), (32768, (512, 64))])
def test_decode_splits_depend_on_the_capacity_alone(C, want):
    """The bf16 kernel's split span L and split count S (grid and
    workspace) are a function of the cache capacity only, never of the
    device-side (cpos, nv), R or B: whole 64-key tiles, at least two a
    split, at most 64 splits covering the cache."""
    import inspect
    from llama_box_tpu_torch.ops import flash_decode as fd
    assert list(inspect.signature(fd._splits).parameters) == ["C"]
    L, S = fd._splits(C)
    assert (L, S) == want
    assert L % 64 == 0 and L >= 128 and 1 <= S <= 64
    assert (S - 1) * L < C <= S * L


# the attention variants' head widths (phi-2's 80, phi-3's 96, gemma's 256)
# under a layer pattern: row 0 of the per-layer window buffer is a local
# layer's window, row 1 a global layer's 0; gemma-2's softcap on both
WINDOWS = np.array([[24, 0], [0, 0]], np.int32)


@pytest.mark.parametrize("D", [80, 96, 256])
@pytest.mark.parametrize("layer", [0, 1], ids=["local", "global"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_plain_matches_pallas_at_head_widths(D, layer, dtype):
    rng = np.random.default_rng(D + layer)
    c = prefill_case(rng, D=D, T=40, C=96, pos0=(40, 8), n_valid=(40, 29))
    win = WINDOWS[layer]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jax_prefill(
        *(jnp.asarray(c[k], jdt) for k in ("q", "kc", "vc", "kr", "vr")),
        jnp.asarray(c["meta"]), jnp.asarray(win), softcap=50.0, bq=32,
        bc=32, interpret=True))
    got = flash_prefill_batched(
        *(as_t(c[k], tdt) for k in ("q", "kc", "vc", "kr", "vr")),
        as_t(c["meta"]), as_t(win), softcap=50.0)
    valid_rows(got.numpy(), want, c["meta"],
               F32_ATOL if dtype == "f32" else BF16_ATOL)


@pytest.mark.parametrize("D", [80, 96, 256])
@pytest.mark.parametrize("layer", [0, 1], ids=["local", "global"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_plain_matches_pallas_at_head_widths(D, layer, dtype):
    rng = np.random.default_rng(D + layer)
    c = decode_case(rng, D=D, C=96, R=8, cpos=(70, 9), nv=(6, 8))
    win = WINDOWS[layer]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jax_decode(
        *(jnp.asarray(c[k], jdt) for k in ("q", "kc", "vc", "kr", "vr")),
        jnp.asarray(c["meta"]), jnp.asarray(win), softcap=50.0, bc=32,
        interpret=True))
    got = flash_decode(
        *(as_t(c[k], tdt) for k in ("q", "kc", "vc", "kr", "vr")),
        as_t(c["meta"]), as_t(win), softcap=50.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F32_ATOL if dtype == "f32" else BF16_ATOL)


@pytest.mark.parametrize("name", ["causal", "bidir", "int8", "dk_ne_dv"])
def test_prefill_plain_reads_the_meta_slot(name):
    """A fifth meta column names the cache row a batch row reads: the
    same numbers as a four-column meta over those rows of the cache."""
    kw = dict(PREFILL_CASES[name])
    win = as_t(np.asarray(kw.pop("win", (0, 0)), np.int32))
    rng = np.random.default_rng(11)
    c = prefill_case(rng, B=4, pos0=(48, 16, 30, 5),
                     n_valid=(64, 40, 10, 64), **(
                         dict(spans=[(8, 40), (0, 0), (2, 20), (0, 0)])
                         if name == "bidir" else kw))
    scales = ({} if "ks" not in c else
              dict(k_scale=as_t(c["ks"]), v_scale=as_t(c["vs"])))
    rows = [3, 1]
    meta5 = np.concatenate(
        [c["meta"][rows], np.asarray(rows, np.int32)[:, None]], axis=1)
    got = flash_prefill_batched(
        as_t(c["q"][rows]), as_t(c["kc"]), as_t(c["vc"]),
        as_t(c["kr"][rows]), as_t(c["vr"][rows]), as_t(meta5), win,
        **scales)
    want = flash_prefill_batched(
        as_t(c["q"][rows]), as_t(c["kc"][rows]), as_t(c["vc"][rows]),
        as_t(c["kr"][rows]), as_t(c["vr"][rows]), as_t(c["meta"][rows]), win,
        **{k: v[rows] for k, v in scales.items()})
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
