"""The port's multimodal prompt pipeline (llama_box_tpu_torch/server/
multimodal.py) against the JAX package's on the same mmproj, tokenizer
and media: build_chunks (llava's mlp tower, minicpmv's v2 and v3 tiled
scaffolds, llama4's tiles, an audio clip beside an image), and
build_chunks_mrope (the three position streams a chunk and mrope_delta,
from the trained grid and from a qwen2vl tower's native grid) give the
same flat ids, chunk kinds, token ids, dummy ids and streams, and
embeddings within 1e-4 x max |JAX|; scaffold_prompt for every family and
both audio scaffolds; the dummy tokens and the LRU's evictions; and
fetch_image_bytes from a data URI, bare base64 and an http.server on
127.0.0.1 (the port fetches over urllib); and M-RoPE as the forward
applies it against JAX's apply_mrope, exactly."""

import base64
import dataclasses
import http.server
import io
import threading

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as conftest sets)
import numpy as np
import pytest
from PIL import Image

from llama_box_tpu.gguf import GGUFFile as JGGUFFile
from llama_box_tpu.models import audio as jaudio
from llama_box_tpu.models import clip as jclip
from llama_box_tpu.server import multimodal as jmm
from llama_box_tpu.tokenizer import Tokenizer as JTokenizer
from llama_box_tpu_torch.gguf import GGUFFile
from llama_box_tpu_torch.models import audio as taudio
from llama_box_tpu_torch.models import clip as tclip
from llama_box_tpu_torch.server import multimodal as tmm
from llama_box_tpu_torch.tokenizer import Tokenizer

from .fixtures.make_tiny_model import write_tiny_model
from .test_torch_audio import wav_bytes, write_audio_mmproj
from .test_torch_clip import write_tower

MARK = tmm.MTMD_MARKER


def png_bytes(size=(20, 20), seed=0) -> bytes:
    px = np.random.default_rng(seed).integers(0, 256, size[::-1] + (3,),
                                              np.uint8)
    buf = io.BytesIO()
    Image.fromarray(px, "RGB").save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mm_tok") / "tiny.gguf")
    write_tiny_model(path)
    with GGUFFile(path) as g:
        t = Tokenizer.from_gguf(g)
    with JGGUFFile(path) as g:
        jt = JTokenizer.from_gguf(g)
    return t, jt


def _pair(path: str, audio: str | None = None, **replace):
    """(port, JAX) MultimodalProcessors on one mmproj (and an audio
    mmproj), the vision config optionally replaced in both."""
    tcfg, tparams = tclip.load_clip(path, device="cpu")
    jcfg, jparams = jclip.load_clip(path)
    if replace:
        tcfg = dataclasses.replace(tcfg, **replace)
        jcfg = dataclasses.replace(jcfg, **replace)
    ta = ja = (None, None)
    if audio:
        ta = taudio.load_audio_tower(audio, device="cpu")
        ja = jaudio.load_audio_tower(audio)
    return (tmm.MultimodalProcessor(tcfg, tparams, audio_cfg=ta[0],
                                    audio_params=ta[1]),
            jmm.MultimodalProcessor(jcfg, jparams, audio_cfg=ja[0],
                                    audio_params=ja[1]))


def _same_chunks(got, want):
    assert [c[0] for c in got] == [c[0] for c in want]
    for g, w in zip(got, want):
        assert len(g) == len(w)
        if g[0] == "tokens":
            assert list(g[1]) == list(w[1])
        else:
            w1 = np.asarray(w[1])
            np.testing.assert_allclose(g[1], w1, rtol=0,
                                       atol=1e-4 * np.abs(w1).max())
            assert list(g[2]) == list(w[2])
        if len(g) > 2 + (g[0] == "embed"):
            np.testing.assert_array_equal(g[-1], w[-1])


@pytest.mark.parametrize("case", ["mlp", "minicpmv_v2", "minicpmv_v3",
                                  "llama4", "audio"])
def test_build_chunks_equals_jax(tmp_path, toks, case):
    tok, jtok = toks
    kind = {"minicpmv_v2": "resampler_v2", "minicpmv_v3": "resampler_v3"
            }.get(case, "mlp")
    path = write_tower(str(tmp_path / "v.gguf"), kind)
    audio = (write_audio_mmproj(str(tmp_path / "a.gguf"))
             if case == "audio" else None)
    replace = {"projector": "llama4"} if case == "llama4" else {}
    mp, jmp = _pair(path, audio, **replace)
    big = png_bytes((1000, 460), seed=1) if case != "mlp" else png_bytes()
    media = [("image", big), ("image", png_bytes(seed=2))]
    prompt = f"look {MARK} and {MARK} now"
    if case == "audio":
        media.append(("audio", wav_bytes(0.3)))
        prompt += f" hear {MARK}"
    flat, chunks = tmm.build_chunks(prompt, media, tok, mp)
    jflat, jchunks = jmm.build_chunks(prompt, media, jtok, jmp)
    assert flat == jflat
    _same_chunks(chunks, jchunks)
    assert sum(len(c[1]) for c in chunks) == len(flat)
    with pytest.raises(ValueError, match="media markers"):
        tmm.build_chunks("no markers", media, tok, mp)


@pytest.mark.parametrize("kind", ["mlp", "qwen2vl"])
def test_build_chunks_mrope_equals_jax(tmp_path, toks, kind):
    """The trained grid (a fixed-size tower, grids from the caller) and a
    qwen2vl tower's native grid (recorded at encode) give JAX's streams,
    next positions and mrope_delta."""
    tok, jtok = toks
    path = write_tower(str(tmp_path / "v.gguf"), kind, IMG=32)
    mp, jmp = _pair(path)
    media = [png_bytes((70, 30), seed=3), ("image", png_bytes(seed=4))]
    prompt = f"{MARK} hello {MARK} done"
    grids = [(2, 2), (2, 2)]
    flat, chunks, delta = tmm.build_chunks_mrope(prompt, media, tok, mp,
                                                 grids)
    jflat, jchunks, jdelta = jmm.build_chunks_mrope(prompt, media, jtok,
                                                    jmp, grids)
    assert flat == jflat and delta == jdelta
    _same_chunks(chunks, jchunks)
    if kind == "qwen2vl":
        assert delta < 0    # the grids compress the position space


@pytest.mark.parametrize("arch", sorted(jmm._SCAFFOLDS) + ["llama"])
@pytest.mark.parametrize("audio", [None, "qwen2a", "ultravox"])
def test_scaffold_prompt_equals_jax(arch, audio):
    prompt = f"a {MARK} b {MARK} c"
    media = [("image", b""), ("audio", b"")]
    for m in (media, None, media[:1]):
        assert tmm.scaffold_prompt(prompt, arch, m, audio) \
            == jmm.scaffold_prompt(prompt, arch, m, audio)


def test_dummy_tokens_and_lru_equal_jax(tmp_path):
    path = write_tower(str(tmp_path / "v.gguf"), "mlp")
    mp, jmp = _pair(path)
    mp.max_cache = jmp.max_cache = 2
    for h in (0, 1, 12345, (1 << 64) - 1):
        assert mp.dummy_tokens(h, 5) == jmp.dummy_tokens(h, 5)
        assert all(t < 0 for t in mp.dummy_tokens(h, 5))
    images = [png_bytes(seed=s) for s in range(3)] + [png_bytes(seed=0)]
    for data in images:
        emb, h = mp.encode(data)
        jemb, jh = jmp.encode(data)
        assert h == jh
        np.testing.assert_allclose(emb, jemb, rtol=0,
                                   atol=1e-4 * np.abs(jemb).max())
        assert list(mp._cache) == list(jmp._cache)
    hit, _ = mp.encode(images[-1])
    assert hit is mp.encode(images[-1])[0]        # a hit is the cached rows


class _Handler(http.server.BaseHTTPRequestHandler):
    body = b""

    def do_GET(self):
        self.send_response(200 if self.path == "/img.png" else 404)
        self.send_header("Content-Length", str(len(self.body)))
        self.end_headers()
        self.wfile.write(self.body)

    def log_message(self, *a):
        pass


def test_fetch_image_bytes_equals_jax():
    img = png_bytes()
    uri = "data:image/png;base64," + base64.b64encode(img).decode()
    bare = base64.b64encode(img).decode()
    for url in (uri, bare):
        assert tmm.fetch_image_bytes(url) == jmm.fetch_image_bytes(url) \
            == img
    _Handler.body = img
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        assert tmm.fetch_image_bytes(base + "/img.png") \
            == jmm.fetch_image_bytes(base + "/img.png") == img
        with pytest.raises(Exception):
            tmm.fetch_image_bytes(base + "/missing.png")
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("sections,n_streams,rot", [
    ((2, 3, 3, 0), 3, 16), ((2, 3, 3), 3, 16), ((2, 3, 3), 2, 16),
    ((1, 2, 2), 3, 12)], ids=["qwen2vl", "three", "fewer_streams",
                              "partial_rotary"])
def test_apply_mrope_equals_jax(sections, n_streams, rot):
    """M-RoPE as the forward applies it (ops/rope.mrope_at's per-section
    gather of the clamped streams, then apply_rope) against JAX
    `apply_mrope`, f32, exactly: stream s rotates its
    section's half-dims, a section past the streams takes the last one,
    dims past the sections stream 0, unrotated dims pass through."""
    import torch
    from llama_box_tpu.ops import rope as jrope
    from llama_box_tpu_torch.ops import rope as trope
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos3 = rng.integers(0, 40, (n_streams, 2, 5)).astype(np.int32)
    jc, js = jrope.compute_rope_cache(
        jrope.RopeParams(head_dim=16, n_rot=rot, mode="neox"), 64)
    tc, ts = trope.compute_rope_cache(
        trope.RopeParams(head_dim=16, n_rot=rot, mode="neox"), 64)
    want = np.asarray(jrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                        jc, js, sections))
    p3 = torch.from_numpy(pos3).long().clamp(0, tc.shape[0] - 1)
    c, s = trope.mrope_at(tc, ts, p3, sections)
    got = trope.apply_rope(torch.from_numpy(x), None, c, s, "neox").numpy()
    np.testing.assert_array_equal(got, want)
