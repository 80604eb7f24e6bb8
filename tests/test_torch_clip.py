"""The port's vision towers (llama_box_tpu_torch/models/clip.py) against
the JAX package's on the same mmproj and the same pixels, f32, max abs
error <= 1e-4 x max |JAX|: the llava mlp projector, the minicpmv
resampler (v2 and v3), pixtral at a non-square native grid, internvl and
idefics3 with their pixel shuffles, qwen2vl at a non-square grid and
qwen2.5vl with its windows. The port runs both on its own load_clip and
on the JAX tree carried over by params_from_numpy (the two equal). The
preprocessors (preprocess_image, preprocess_image_native,
qwen2vl_smart_resize, pixtral_fit_resize, minicpmv_slice, llama4_slice)
give exactly JAX's results."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from llama_box_tpu.models import clip as jclip
from llama_box_tpu.server import multimodal as jmm
from llama_box_tpu_torch.gguf.writer import GGUFWriter
from llama_box_tpu_torch.models import clip as tclip
from llama_box_tpu_torch.models.loader import params_from_numpy
from llama_box_tpu_torch.server import multimodal as tmm

from .fixtures.make_tiny_mmproj import write_tiny_mmproj

E, FF, NL, H, PROJ = 32, 64, 2, 4, 64


def write_tower(path: str, kind: str, seed: int = 0, E: int = E,
                FF: int = FF, NL: int = NL, H: int = H, P: int = 4,
                IMG: int = 16, PROJ: int = PROJ) -> str:
    """A small random mmproj of one projector family (tensor names and
    metadata as llama.cpp's converters write them)."""
    if kind in ("mlp", "resampler_v2", "resampler_v3"):
        return write_tiny_mmproj(path, seed=seed,
                                 resampler=kind != "mlp",
                                 minicpmv_version=int(kind[-1])
                                 if kind != "mlp" else 3)
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    proj = {"llava": "mlp", "pixtral": "pixtral", "internvl": "internvl",
            "idefics3": "idefics3", "qwen2vl": "qwen2vl_merger",
            "qwen25vl": "qwen2.5vl_merger"}[kind]
    w = GGUFWriter(path, architecture="clip")
    w.add_kv("clip.has_vision_encoder", True)
    w.add_kv("clip.projector_type", proj)
    for key, val in (("image_size", IMG), ("patch_size", P),
                     ("embedding_length", E), ("feed_forward_length", FF),
                     ("block_count", NL), ("attention.head_count", H),
                     ("projection_dim", PROJ)):
        w.add_kv(f"clip.vision.{key}", val)
    w.add_kv("clip.vision.attention.layer_norm_epsilon", 1e-5)
    S = IMG // P
    biased = kind in ("llava", "internvl", "idefics3", "qwen2vl", "qwen25vl")
    w.add_tensor("v.patch_embd.weight", rand(E, 3, P, P))
    if kind in ("qwen2vl", "qwen25vl"):
        w.add_tensor("v.patch_embd.weight.1", rand(E, 3, P, P))
    if kind != "pixtral":
        w.add_tensor("v.patch_embd.bias", rand(E))
    if kind == "internvl":
        w.add_kv("clip.use_gelu", True)
    if kind in ("llava", "internvl"):
        w.add_tensor("v.class_embd", rand(E))
        w.add_tensor("v.position_embd.weight", rand(S * S + 1, E))
    if kind == "llava":
        for nm in ("pre_ln", "post_ln"):
            w.add_tensor(f"v.{nm}.weight", 1.0 + rand(E))
            w.add_tensor(f"v.{nm}.bias", rand(E))
    if kind == "idefics3":
        w.add_kv("clip.use_gelu", True)
        w.add_tensor("v.position_embd.weight", rand(S * S, E))
        w.add_tensor("v.post_ln.weight", 1.0 + rand(E))
        w.add_tensor("v.post_ln.bias", rand(E))
    if kind == "pixtral":
        w.add_kv("clip.use_silu", True)
        w.add_kv("clip.vision.rope_theta", 10000.0)
        w.add_tensor("v.pre_ln.weight", 1.0 + rand(E))
    if kind in ("qwen2vl", "qwen25vl"):
        w.add_tensor("v.post_ln.weight", 1.0 + rand(E))
        w.add_tensor("v.post_ln.bias", rand(E))
    if kind == "qwen25vl":
        w.add_kv("clip.vision.n_wa_pattern", 2)
    for i in range(NL):
        p = f"v.blk.{i}."
        for nm in ("ln1", "ln2"):
            w.add_tensor(p + nm + ".weight", 1.0 + rand(E))
            if kind in ("llava", "internvl", "idefics3", "qwen2vl"):
                w.add_tensor(p + nm + ".bias", rand(E))
        for nm in ("attn_q", "attn_k", "attn_v", "attn_out"):
            w.add_tensor(p + nm + ".weight", rand(E, E))
            if biased:
                w.add_tensor(p + nm + ".bias", rand(E))
        if kind in ("pixtral", "qwen25vl"):
            w.add_tensor(p + "ffn_gate.weight", rand(FF, E))
            if biased:
                w.add_tensor(p + "ffn_gate.bias", rand(FF))
        w.add_tensor(p + "ffn_up.weight", rand(FF, E))
        w.add_tensor(p + "ffn_down.weight", rand(E, FF))
        if biased:
            w.add_tensor(p + "ffn_up.bias", rand(FF))
            w.add_tensor(p + "ffn_down.bias", rand(E))
        if kind == "internvl":
            w.add_tensor(p + "ls1.weight", 0.5 + rand(E))
            w.add_tensor(p + "ls2.weight", 0.5 + rand(E))
    if kind == "pixtral":
        w.add_tensor("mm.1.weight", rand(PROJ, E))
        w.add_tensor("mm.1.bias", rand(PROJ))
        w.add_tensor("mm.2.weight", rand(PROJ, PROJ))
        w.add_tensor("mm.2.bias", rand(PROJ))
    elif kind == "internvl":
        w.add_tensor("mm.0.weight", 1.0 + rand(4 * E))
        w.add_tensor("mm.0.bias", rand(4 * E))
        w.add_tensor("mm.1.weight", rand(PROJ, 4 * E))
        w.add_tensor("mm.1.bias", rand(PROJ))
        w.add_tensor("mm.3.weight", rand(PROJ, PROJ))
        w.add_tensor("mm.3.bias", rand(PROJ))
    elif kind == "idefics3":
        w.add_tensor("mm.model.fc.weight", rand(PROJ, 4 * E))
    elif kind == "llava":
        w.add_tensor("mm.0.weight", rand(PROJ, E))
        w.add_tensor("mm.0.bias", rand(PROJ))
        w.add_tensor("mm.2.weight", rand(PROJ, PROJ))
        w.add_tensor("mm.2.bias", rand(PROJ))
    else:
        w.add_tensor("mm.0.weight", rand(PROJ, 4 * E))
        w.add_tensor("mm.0.bias", rand(PROJ))
        w.add_tensor("mm.2.weight", rand(PROJ, PROJ))
        w.add_tensor("mm.2.bias", rand(PROJ))
    w.write()
    return path


KINDS = ["mlp", "llava", "resampler_v2", "resampler_v3", "pixtral", "internvl",
         "idefics3", "qwen2vl", "qwen25vl"]
# the native-grid towers run at a non-square (gh, gw) patch grid; qwen2.5vl
# at 16 x 8 patches spans two of its 8x8 windows
GRIDS = {"pixtral": (3, 5), "qwen2vl": (4, 6), "qwen25vl": (16, 8)}


def _jax_tree(params):
    return jax.tree.map(np.asarray, params)


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _run_jax(kind, cfg, params, pixels):
    x = jnp.asarray(pixels)
    if kind == "pixtral":
        return jclip.encode_image_pixtral_impl(params, cfg, x, GRIDS[kind])
    if kind in ("qwen2vl", "qwen25vl"):
        return jclip.encode_image_qwen2vl_impl(params, cfg, x, GRIDS[kind])
    return jclip.encode_image_impl(params, cfg, x)


def _run_port(kind, cfg, params, pixels):
    x = torch.from_numpy(pixels)
    with torch.no_grad():
        if kind == "pixtral":
            return tclip.encode_image_pixtral_impl(params, cfg, x,
                                                   GRIDS[kind])
        if kind in ("qwen2vl", "qwen25vl"):
            return tclip.encode_image_qwen2vl_impl(params, cfg, x,
                                                   GRIDS[kind])
        return tclip.encode_image_impl(params, cfg, x)


@pytest.mark.parametrize("kind", KINDS)
def test_tower_matches_jax(tmp_path, kind):
    path = write_tower(str(tmp_path / f"{kind}.gguf"), kind)
    jcfg, jparams = jclip.load_clip(path)
    tcfg, tparams = tclip.load_clip(path, device="cpu")
    assert dataclasses_equal(jcfg, tcfg)
    carried = params_from_numpy(_jax_tree(jparams), None)
    flat_t, flat_c = _flatten(tparams), _flatten(carried)
    assert flat_t.keys() == flat_c.keys()
    for k in flat_t:
        torch.testing.assert_close(flat_t[k], flat_c[k], rtol=0, atol=0)
    P = tcfg.patch_size
    gh, gw = GRIDS.get(kind, (tcfg.n_patches_side, tcfg.n_patches_side))
    pixels = np.random.default_rng(1).standard_normal(
        (gh * P, gw * P, 3)).astype(np.float32)
    want = np.asarray(_run_jax(kind, jcfg, jparams, pixels))
    _close(_run_port(kind, tcfg, tparams, pixels), want)
    _close(_run_port(kind, tcfg, carried, pixels), want)


def dataclasses_equal(a, b) -> bool:
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + "."))
        elif v is not None:
            out[prefix + k] = v
    return out


# -- preprocessors -------------------------------------------------------------


def _image(w: int, h: int, seed: int = 0) -> Image.Image:
    px = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    return Image.fromarray(px, "RGB")


@pytest.fixture(scope="module")
def cfg():
    return tclip.ClipConfig(image_size=28, patch_size=4, merge_size=2,
                            image_mean=(0.5, 0.4, 0.3),
                            image_std=(0.2, 0.3, 0.25))


@pytest.mark.parametrize("wh", [(40, 23), (9, 31), (28, 28)])
def test_preprocess_equals_jax(cfg, wh):
    img = _image(*wh)
    jcfg = jclip.ClipConfig(**__import__("dataclasses").asdict(cfg))
    np.testing.assert_array_equal(tclip.preprocess_image(img, cfg),
                                  jclip.preprocess_image(img, jcfg))
    np.testing.assert_array_equal(
        tclip.preprocess_image_native(img, cfg, (12, 20)),
        jclip.preprocess_image_native(img, jcfg, (12, 20)))


@pytest.mark.parametrize("wh", [(40, 23), (9, 31), (1000, 300), (3, 3),
                                (400, 400)])
def test_resize_rules_equal_jax(cfg, wh):
    jcfg = jclip.ClipConfig(**__import__("dataclasses").asdict(cfg))
    for cap in (0, 20):
        assert tclip.qwen2vl_smart_resize(*wh, cfg, cap) \
            == jclip.qwen2vl_smart_resize(*wh, jcfg, cap)
        assert tclip.pixtral_fit_resize(*wh, cfg, cap) \
            == jclip.pixtral_fit_resize(*wh, jcfg, cap)


def _same_images(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.size == y.size
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("wh", [(300, 200), (1000, 450), (120, 700)])
def test_minicpmv_slice_equals_jax(wh):
    img = _image(*wh, seed=2)
    ov, tiles, grid = tmm.minicpmv_slice(img)
    jov, jtiles, jgrid = jmm.minicpmv_slice(img)
    assert grid == jgrid
    _same_images([ov] + tiles, [jov] + jtiles)


@pytest.mark.parametrize("wh", [(300, 200), (900, 450), (200, 1100)])
def test_llama4_slice_equals_jax(wh):
    img = _image(*wh, seed=3)
    tiles, grid = tmm.llama4_slice(img, tile=112)
    jtiles, jgrid = jmm.llama4_slice(img, tile=112)
    assert grid == jgrid
    _same_images(tiles, jtiles)


def test_processor_encodes_as_jax(tmp_path):
    """MultimodalProcessor.encode over PNG bytes (decode, preprocess,
    tower) against JAX's, and the native grid it records for qwen2vl."""
    path = write_tower(str(tmp_path / "q.gguf"), "qwen2vl", IMG=32)
    jcfg, jparams = jclip.load_clip(path)
    tcfg, tparams = tclip.load_clip(path, device="cpu")
    jp = jmm.MultimodalProcessor(jcfg, jparams)
    tp = tmm.MultimodalProcessor(tcfg, tparams)
    buf = io.BytesIO()
    _image(50, 29, seed=5).save(buf, format="PNG")
    data = buf.getvalue()
    want, jh = jp.encode(data)
    got, th = tp.encode(data)
    assert th == jh
    _close(got, want)
    assert tp.image_grid(th) == jp.image_grid(jh)


def test_load_clip_on_cuda_unless_cpu(tmp_path, monkeypatch):
    """load_clip runs on the card by default, as load_model does: with no
    CUDA it raises unless the caller asks for the CPU."""
    path = write_tower(str(tmp_path / "m.gguf"), "mlp")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tclip.load_clip(path)
    _, params = tclip.load_clip(path, device="cpu")
    assert all(v.device.type == "cpu" for v in _flatten(params).values())
