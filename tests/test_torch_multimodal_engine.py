"""The port's multimodal serving path against the JAX package's: for a
llava-style image chat (the tiny llama and tiny mlp mmproj of
tests/test_vision.py), a Qwen2-VL image chat (M-RoPE streams in the
prefill, mrope_delta through decode; a qwen2vl tower at a native grid), a
gemma3 file with an image (the bidirectional span, split across two
ubatches), a minicpmv sliced image and an audio chat:
- the last-row logits of the prompt's chunks prefilled in turn (JAX
  `prefill` / `prefill_embed` against the port's prefill_batch_impl into
  one slot of a two-slot cache, the slot an operand as the engine passes
  it), f32 within the tolerance of tests/test_torch_families.py, and the
  same bits as a prefill into that slot's cache views;
- the engines' greedy tokens, equal to JAX's at decode chains of 1 and 4,
  and again when the same prompt is served from the prefix cache, on
  prompts whose greedy steps clear a top-2 log-prob margin of 1e-3
  (checked).
The chunks are built once, by the JAX pipeline, so both engines take the
same numbers (tests/test_torch_multimodal.py holds the pipelines equal).
And the HTTP route through the port CLI (--mmproj, --device cpu): an
image_url data URI and an input_audio WAV answered, /props and the
capability 400s."""

import base64
import json
import math
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.gguf import GGUFFile as JGGUFFile
from llama_box_tpu.models import audio as jaudio
from llama_box_tpu.models import clip as jclip
from llama_box_tpu.models import llama as jllama
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.sampling import SamplerParams as JSamplerParams
from llama_box_tpu.server import Engine as JEngine
from llama_box_tpu.server import EngineConfig as JEngineConfig
from llama_box_tpu.server import multimodal as jmm
from llama_box_tpu.server.task import CompletionsTask as JTask
from llama_box_tpu.tokenizer import Tokenizer as JTokenizer
from llama_box_tpu_torch import cli
from llama_box_tpu_torch.gguf import GGUFFile
from llama_box_tpu_torch.models import llama as tllama
from llama_box_tpu_torch.models.loader import load_model
from llama_box_tpu_torch.sampling import SamplerParams
from llama_box_tpu_torch.server.engine import Engine, EngineConfig
from llama_box_tpu_torch.server.task import CompletionsTask
from llama_box_tpu_torch.tokenizer import Tokenizer

from .fixtures.make_tiny_model import write_tiny_model
from .test_qwen2vl import write_tiny_qwen2vl
from .test_torch_audio import wav_bytes, write_audio_mmproj
from .test_torch_clip import write_tower
from .test_torch_families import write_attn
from .test_torch_multimodal import png_bytes

MARK = jmm.MTMD_MARKER
N_GEN, MARGIN, UB = 6, 1e-3, 8
CASES = ["llava", "qwen2vl", "gemma3", "minicpmv", "audio"]
# prompts whose greedy steps clear MARGIN (the random models' logits are
# flat, and other prompts meet near ties)
PROMPTS = {
    "llava": f"describe {MARK} now",
    "qwen2vl": f"see {MARK} and tell",
    "gemma3": f"what {MARK} is it",
    "minicpmv": f"the tiles {MARK} show",
    "audio": f"a tone {MARK} here",
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mm_engine")
    out = {}
    for case in CASES:
        lm, mm = str(d / f"{case}.gguf"), str(d / f"{case}-mmproj.gguf")
        if case == "qwen2vl":
            write_tiny_qwen2vl(lm)
            write_tower(mm, "qwen2vl", IMG=32)
        elif case == "gemma3":
            write_attn(lm, "gemma3")
            write_tower(mm, "llava", IMG=12, P=4)      # 9 image rows
        else:
            write_tiny_model(lm)
            if case == "minicpmv":
                write_tower(mm, "resampler_v3")
            elif case == "audio":
                write_audio_mmproj(mm)
            else:
                write_tower(mm, "mlp")
        out[case] = (lm, mm)
    return out


def _media(case):
    if case == "audio":
        return [("audio", wav_bytes(0.3, seed=1))]
    if case == "minicpmv":
        return [("image", png_bytes((1000, 460), seed=2))]
    if case == "gemma3":
        return [("image", png_bytes((40, 40), seed=3))]
    return [("image", png_bytes((70, 30), seed=4))]


@pytest.fixture(scope="module")
def chunked(files):
    """Per case: (flat ids, chunks, mrope_delta) built by the JAX
    pipeline on the case's mmproj."""
    out = {}
    for case, (lm, mm) in files.items():
        with JGGUFFile(lm) as g:
            tok = JTokenizer.from_gguf(g)
        if case == "audio":
            mp = jmm.MultimodalProcessor(
                jclip.ClipConfig(), {}, audio_cfg=None)
            mp.audio_cfg, mp.audio_params = jaudio.load_audio_tower(mm)
        else:
            mp = jmm.MultimodalProcessor(*jclip.load_clip(mm))
        prompt = jmm.scaffold_prompt(PROMPTS[case], "x", _media(case))
        if case == "qwen2vl":
            out[case] = jmm.build_chunks_mrope(prompt, _media(case), tok, mp,
                                               [(2, 2)])
        else:
            out[case] = (*jmm.build_chunks(prompt, _media(case), tok, mp), 0)
    return out


# -- the prefill's logits ------------------------------------------------------


def _spans(chunks):
    """(chunk, offset, n) ubatches of at most UB rows in prompt order."""
    for ch in chunks:
        for off in range(0, len(ch[1]), UB):
            yield ch, off, min(UB, len(ch[1]) - off)


def _jax_logits(path, chunks, mrope):
    cfg, p = jax_load(path, dtype=jnp.float32)
    C = 128
    kv = jllama.init_kv_cache(cfg, 1, C, jnp.float32)
    cos, sin = jllama.make_rope(cfg, C)
    pos = 0
    start = 0
    for ch, off, n in _spans(chunks):
        if off == 0:
            start = pos
        mp = None
        if mrope:
            buf = np.zeros((3, UB), np.int32)
            buf[:, :n] = ch[-1][:, off:off + n]
            mp = jnp.asarray(buf)
        if ch[0] == "tokens":
            buf = np.zeros(UB, np.int32)
            buf[:n] = ch[1][off:off + n]
            lg, kv = jllama.prefill(p, cfg, jnp.asarray(buf), kv,
                                    jnp.int32(0), jnp.int32(pos),
                                    jnp.int32(n), cos, sin, mp)
        else:
            buf = np.zeros((UB, ch[1].shape[1]), np.float32)
            buf[:n] = ch[1][off:off + n]
            bidir = ((jnp.int32(start), jnp.int32(pos + n))
                     if cfg.arch == "gemma3" else None)
            lg, kv = jllama.prefill_embed(p, cfg, jnp.asarray(buf), kv,
                                          jnp.int32(0), jnp.int32(pos),
                                          jnp.int32(n), cos, sin, mp,
                                          bidir_span=bidir)
        pos += n
    return np.asarray(lg, np.float32)


def _port_logits(path, chunks, mrope, views=False):
    """The last-row logits of the chunks prefilled into slot 1 of a
    two-slot cache: the slot an operand (the engine's way), or with
    `views` a cache of slot 1's views. Returns (logits, the cache)."""
    cfg, p = load_model(path, dtype=torch.float32, device="cpu")
    C = 128
    kv = tllama.init_kv_cache(cfg, 2, C, torch.float32, device="cpu")
    one, slot = ((tllama.KVCache(kv.k[:, 1:2], kv.v[:, 1:2]), None) if views
                 else (kv, torch.tensor([1])))
    cos, sin = tllama.make_rope(cfg, C, device="cpu")
    pos = start = 0
    for ch, off, n in _spans(chunks):
        if off == 0:
            start = pos
        kw = {}
        if mrope:
            buf = torch.zeros((3, 1, UB), dtype=torch.int64)
            buf[:, 0, :n] = torch.from_numpy(ch[-1][:, off:off + n])
            kw["mrope_pos"] = buf
        if ch[0] == "tokens":
            toks = torch.zeros((1, UB), dtype=torch.int64)
            toks[0, :n] = torch.tensor(ch[1][off:off + n])
        else:
            toks = None
            emb = torch.zeros((1, UB, ch[1].shape[1]))
            emb[0, :n] = torch.from_numpy(np.array(ch[1][off:off + n]))
            kw["embeds"] = emb
            if cfg.arch == "gemma3":
                kw["bidir"] = torch.tensor([[start, pos + n]])
        lg, _ = tllama.prefill_batch_impl(p, cfg, toks, [pos], [n], one, cos,
                                          sin, slots=slot, **kw)
        pos += n
    assert not kv.k[:, 0].any()     # slot 0 untouched
    return lg[0].numpy(), kv


@pytest.mark.parametrize("case", CASES)
def test_prefill_logits_match_jax(files, chunked, case):
    flat, chunks, _ = chunked[case]
    assert any(c[0] == "embed" for c in chunks)
    if case == "gemma3":    # the image spans two ubatches
        assert max(len(c[1]) for c in chunks if c[0] == "embed") > UB
    want = _jax_logits(files[case][0], chunks, case == "qwen2vl")
    got, _ = _port_logits(files[case][0], chunks, case == "qwen2vl")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max() + 1e-5)


@pytest.mark.parametrize("case", CASES)
def test_slot_operand_equals_slot_views(files, chunked, case):
    """The slot as an operand (the flash kernel meta's fifth column and
    the rows' writes) gives the bits of a prefill on that slot's views:
    the same logits and the same cache."""
    _, chunks, _ = chunked[case]
    got, kv = _port_logits(files[case][0], chunks, case == "qwen2vl")
    want, kv_v = _port_logits(files[case][0], chunks, case == "qwen2vl",
                              views=True)
    np.testing.assert_array_equal(got, want)
    assert torch.equal(kv.k, kv_v.k) and torch.equal(kv.v, kv_v.v)


def test_gemma3_span_changes_the_logits(files, chunked):
    """Without its span the image rows attend causally: other logits (so
    the span is what the check above holds equal)."""
    flat, chunks, _ = chunked["gemma3"]
    cfg, p = load_model(files["gemma3"][0], dtype=torch.float32,
                        device="cpu")
    emb = [c for c in chunks if c[0] == "embed"][0][1]
    n = len(emb)
    cos, sin = tllama.make_rope(cfg, 64, device="cpu")
    out = []
    for span in ([0, n], [0, 0]):
        kv = tllama.init_kv_cache(cfg, 1, 64, torch.float32, device="cpu")
        lg, _ = tllama.prefill_batch_impl(
            p, cfg, None, [0], [n], kv, cos, sin,
            embeds=torch.from_numpy(np.array(emb))[None],
            bidir=torch.tensor([span]))
        out.append(lg)
    assert not torch.allclose(out[0], out[1])


# -- the engines' greedy tokens -----------------------------------------------


def _collect(tasks, timeout=240):
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


def _ecfg(cls, chain=4):
    return cls(n_slots=2, n_ctx=2 * 256, n_ubatch=UB, kv_dtype="float32",
               decode_chain=chain)


def _jax_tokens(path, flat, chunks, delta):
    cfg, params = jax_load(path, dtype=jnp.float32)
    with JGGUFFile(path) as g:
        tok = JTokenizer.from_gguf(g)
    eng = JEngine(cfg, params, tok, _ecfg(JEngineConfig))
    eng.start()
    try:
        t = JTask(list(flat), JSamplerParams(temp=0.0), tokenizer=tok,
                  max_tokens=N_GEN, chunks=chunks)
        t.mrope_delta = delta
        eng.submit(t)
        return _collect([t])[0].generated
    finally:
        eng.stop()


def _port_runs(path, flat, chunks, delta, chain):
    """Two requests in turn (the second from the prefix cache)."""
    cfg, params = load_model(path, dtype=torch.float32, device="cpu")
    with GGUFFile(path) as g:
        tok = Tokenizer.from_gguf(g)
    eng = Engine(cfg, params, tok, _ecfg(EngineConfig, chain), device="cpu")
    eng.start()
    try:
        finals = []
        for _ in range(2):
            t = CompletionsTask(list(flat), SamplerParams(temp=0.0),
                                tokenizer=tok, max_tokens=N_GEN, n_probs=2,
                                chunks=chunks)
            t.mrope_delta = delta
            eng.submit(t)
            finals += _collect([t])
        return finals
    finally:
        eng.stop()


@pytest.mark.parametrize("case", CASES)
def test_engine_greedy_matches_jax(files, chunked, case):
    flat, chunks, delta = chunked[case]
    path = files[case][0]
    want = _jax_tokens(path, flat, chunks, delta)
    for chain in (1, 4):
        first, again = _port_runs(path, flat, chunks, delta, chain)
        for tp in first.probs:
            p0, p1 = tp.top_probs[:2]
            assert math.log(p0) - math.log(max(p1, 1e-30)) > MARGIN, \
                f"{case}: a near tie; pick another prompt"
        assert first.generated == want, (case, chain)
        assert again.generated == want
        assert again.n_cached >= len(flat) - 1     # the image's rows reused


# -- the HTTP route --------------------------------------------------------------


def _serve(argv):
    engine, srv = cli.build_server(argv + [
        "--device", "cpu", "--port", "0", "--no-jinja", "--weights-dtype",
        "f32", "-np", "2", "-c", "512", "-ub", "16", "-ctk", "f32",
        "-ctv", "f32"])
    threading.Thread(target=srv.serve_forever, daemon=True).start()

    def stop():
        srv.shutdown()
        srv.server_close()
        engine.stop()
    return f"http://127.0.0.1:{srv.server_address[1]}", stop


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _chat(url, part, max_tokens=3):
    return _call(url + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": [
            {"type": "text", "text": "what is this"}, part]}],
        "max_tokens": max_tokens, "temperature": 0})


IMAGE_PART = {"type": "image_url", "image_url": {
    "url": "data:image/png;base64,"
    + base64.b64encode(png_bytes(seed=6)).decode()}}
AUDIO_PART = {"type": "input_audio", "input_audio": {
    "data": base64.b64encode(wav_bytes(0.2)).decode(), "format": "wav"}}


def test_http_image_and_audio_chats(tmp_path):
    lm = str(tmp_path / "lm.gguf")
    write_tiny_model(lm)
    vis = write_tower(str(tmp_path / "v.gguf"), "mlp")
    aud = write_audio_mmproj(str(tmp_path / "a.gguf"))
    url, stop = _serve(["-m", lm, "--mmproj", vis])
    try:
        props = _call(url + "/props")[1]
        assert props["support_image"] and not props["support_audio"]
        meta = _call(url + "/v1/models")[1]["data"][0]["meta"]
        assert meta["support_vision"] and not meta["support_audio"]
        status, body = _chat(url, IMAGE_PART)
        assert status == 200, body
        assert 0 < body["usage"]["completion_tokens"] <= 3
        assert body["usage"]["prompt_tokens"] > 4      # the image's rows
        status, body = _chat(url, AUDIO_PART)
        assert status == 400 and "input_audio" in body["error"]["message"]
        status, body = _chat(url, {"type": "input_audio", "input_audio": {
            "data": "", "format": "flac"}})
        assert status == 400
    finally:
        stop()
    url, stop = _serve(["-m", lm, "--mmproj", aud])
    try:
        props = _call(url + "/props")[1]
        assert props["support_audio"] and not props["support_image"]
        status, body = _chat(url, AUDIO_PART)
        assert status == 200, body
        assert body["usage"]["completion_tokens"] > 0
        status, body = _call(url + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": [AUDIO_PART]}],
            "max_tokens": 2, "temperature": 0,
            "stream": False})
        assert status == 200
        status, body = _chat(url, {"type": "input_audio", "input_audio": {
            "data": "", "format": "ogg"}})
        assert status == 400 and "ogg" in body["error"]["message"]
        status, body = _chat(url, IMAGE_PART)
        assert status == 400
    finally:
        stop()


def test_http_without_mmproj_refuses_media(tmp_path):
    lm = str(tmp_path / "lm.gguf")
    write_tiny_model(lm)
    url, stop = _serve(["-m", lm])
    try:
        props = _call(url + "/props")[1]
        assert not props["support_image"] and not props["support_audio"]
        for part in (IMAGE_PART, AUDIO_PART):
            status, body = _chat(url, part)
            assert status == 400 and "not supported" in \
                body["error"]["message"]
    finally:
        stop()
