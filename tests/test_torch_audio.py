"""The port's audio frontend and towers (llama_box_tpu_torch/models/
audio.py) against the JAX package's: decode_wav (16-bit, 8-bit, stereo,
resampled) and log_mel_spectrogram exactly; the generic whisper tower
with the mm.a MLP and the qwen2-audio tower (pairs of frames pooled, one
linear) on the same mmproj and mel frames, f32, max abs error <= 1e-4 x
max |JAX|, on the port's own load_audio_tower and on the JAX tree carried
over by params_from_numpy; and mp3's capability error without libmpg123,
the same message as JAX's."""

import io
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.models import audio as jaudio
from llama_box_tpu_torch.gguf.writer import GGUFWriter
from llama_box_tpu_torch.models import audio as taudio
from llama_box_tpu_torch.models.loader import params_from_numpy
from llama_box_tpu_torch.utils import mp3 as tmp3

A_E, A_FF, A_LAYERS, A_HEADS, MELS, PROJ = 32, 64, 2, 4, 80, 64


def wav_bytes(seconds=0.5, freq=440.0, sr=16000, width=2, channels=1,
              seed=0) -> bytes:
    """A tone plus seeded noise as a WAV of `width` bytes a sample."""
    t = np.arange(int(seconds * sr)) / sr
    x = 0.5 * np.sin(2 * np.pi * freq * t) \
        + 0.05 * np.random.default_rng(seed).standard_normal(len(t))
    x = np.repeat(x[:, None], channels, axis=1)
    if width == 1:
        raw = np.clip(x * 127 + 128, 0, 255).astype(np.uint8)
    else:
        raw = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw.tobytes())
    return buf.getvalue()


def write_audio_mmproj(path: str, proj_type: str = "", seed: int = 0,
                       E: int = A_E, FF: int = A_FF, NL: int = A_LAYERS,
                       H: int = A_HEADS, MELS: int = MELS,
                       PROJ: int = PROJ) -> str:
    """A small random audio mmproj: a whisper encoder and, for "qwen2a",
    qwen2-audio's head (mm.a.fc1 after the pooled post-LN), else the
    generic mm.a.0 / mm.a.2 MLP."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    w = GGUFWriter(path, architecture="clip")
    w.add_kv("clip.has_audio_encoder", True)
    if proj_type:
        w.add_kv("clip.projector_type", proj_type)
    for key, val in (("num_mel_bins", MELS), ("embedding_length", E),
                     ("feed_forward_length", FF), ("block_count", NL),
                     ("attention.head_count", H), ("projection_dim", PROJ)):
        w.add_kv(f"clip.audio.{key}", val)
    w.add_tensor("a.conv1d.1.weight", rand(E, MELS, 3))
    w.add_tensor("a.conv1d.1.bias", rand(E))
    w.add_tensor("a.conv1d.2.weight", rand(E, E, 3))
    w.add_tensor("a.conv1d.2.bias", rand(E))
    w.add_tensor("a.position_embd.weight", rand(1500, E))
    w.add_tensor("a.post_ln.weight", 1.0 + rand(E))
    w.add_tensor("a.post_ln.bias", rand(E))
    for i in range(NL):
        p = f"a.blk.{i}."
        for nm in ("ln1", "ln2"):
            w.add_tensor(p + nm + ".weight", 1.0 + rand(E))
            w.add_tensor(p + nm + ".bias", rand(E))
        for nm in ("attn_q", "attn_v", "attn_out"):
            w.add_tensor(p + nm + ".weight", rand(E, E))
            w.add_tensor(p + nm + ".bias", rand(E))
        w.add_tensor(p + "attn_k.weight", rand(E, E))   # whisper: no k bias
        w.add_tensor(p + "ffn_up.weight", rand(FF, E))
        w.add_tensor(p + "ffn_up.bias", rand(FF))
        w.add_tensor(p + "ffn_down.weight", rand(E, FF))
        w.add_tensor(p + "ffn_down.bias", rand(E))
    if proj_type == "qwen2a":
        w.add_tensor("mm.a.fc1.weight", rand(PROJ, E))
        w.add_tensor("mm.a.fc1.bias", rand(PROJ))
    else:
        w.add_tensor("mm.a.0.weight", rand(PROJ, E))
        w.add_tensor("mm.a.0.bias", rand(PROJ))
        w.add_tensor("mm.a.2.weight", rand(PROJ, PROJ))
        w.add_tensor("mm.a.2.bias", rand(PROJ))
    w.write()
    return path


@pytest.mark.parametrize("kw", [
    {}, {"sr": 8000}, {"width": 1}, {"channels": 2, "sr": 22050},
    {"seconds": 0.0}], ids=["s16", "8khz", "u8", "stereo", "empty"])
def test_decode_wav_and_log_mel_equal_jax(kw):
    data = wav_bytes(**kw)
    x, jx = taudio.decode_wav(data), jaudio.decode_wav(data)
    np.testing.assert_array_equal(x, jx)
    for n_mels in (80, 128):
        np.testing.assert_array_equal(
            taudio.log_mel_spectrogram(x, n_mels),
            jaudio.log_mel_spectrogram(jx, n_mels))


@pytest.mark.parametrize("proj_type", ["", "qwen2a"],
                         ids=["generic", "qwen2a"])
def test_audio_tower_matches_jax(tmp_path, proj_type):
    path = write_audio_mmproj(str(tmp_path / "a.gguf"), proj_type)
    jcfg, jparams = jaudio.load_audio_tower(path)
    tcfg, tparams = taudio.load_audio_tower(path, device="cpu")
    assert tcfg == jcfg
    carried = params_from_numpy(jax.tree.map(np.asarray, jparams), None)
    mel = jaudio.log_mel_spectrogram(
        jaudio.decode_wav(wav_bytes(0.37, seed=3)), MELS)
    want = np.asarray(jaudio.encode_audio_impl(jcfg, jparams,
                                               jnp.asarray(mel)))
    for params in (tparams, carried):
        with torch.no_grad():
            got = taudio.encode_audio_impl(tcfg, params,
                                           torch.from_numpy(mel)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    # the host entry point: bytes in, f32 rows out
    data = wav_bytes(0.21, freq=880.0)
    np.testing.assert_allclose(
        taudio.encode_audio(tcfg, tparams, data),
        jaudio.encode_audio(jcfg, jparams, data), rtol=0,
        atol=1e-4 * np.abs(want).max())


def test_mp3_unavailable_is_clear(monkeypatch):
    """Without the codec, mp3 input fails with the JAX package's
    actionable message, and available() says so up front."""
    from llama_box_tpu.utils import mp3 as jmp3
    frame = b"\xff\xfb\x90\x00" + b"\x00" * 64
    assert tmp3.looks_like_mp3(frame) and not tmp3.looks_like_mp3(
        wav_bytes(0.01))
    msgs = []
    for m in (tmp3, jmp3):
        monkeypatch.setattr(m, "_lib", None)
        monkeypatch.setattr(m, "_lib_err", "forced by test")
        assert not m.available()
        with pytest.raises(ValueError, match="mpg123") as exc:
            m.decode_mp3(frame)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="mpg123"):
        taudio.decode_wav(frame)


def test_audio_tower_loads_on_cuda_unless_cpu(tmp_path, monkeypatch):
    """load_audio_tower runs on the card by default, as load_model does:
    with no CUDA it raises unless the caller asks for the CPU."""
    path = write_audio_mmproj(str(tmp_path / "a.gguf"), "qwen2a")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        taudio.load_audio_tower(path)
    _, params = taudio.load_audio_tower(path, device="cpu")
    assert all(v.device.type == "cpu" for v in _flat(params))


def _flat(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat(v)
    elif tree is not None:
        yield tree
