"""Whisper-style audio encoder of ultravox / qwen2-audio mmproj files
(counterpart of llama_box_tpu/models/audio.py).

WAV bytes -> log-mel spectrogram (whisper's frontend: 16 kHz, n_fft 400,
hop 160, in numpy) -> two convolutions (the second strided 2) -> learned
positions -> pre-LN transformer -> a projector into the language model's
embedding space: qwen2-audio's head (pairs of frames pooled, then one
linear) or the plain `mm.a.*` MLP. MP3 decodes through the platform's
mpg123 codec (utils/mp3.py).

Every op of the JAX encoder is XLA (a convolution, einsums, softmax), none
a Pallas kernel; the port writes them as plain torch ops in f32, on the
card as on the CPU (models/clip.py's rule).
"""

from __future__ import annotations

import io
import wave

import numpy as np
import torch
import torch.nn.functional as F

from ..gguf.reader import GGUFFile
from ..utils.logging import SRV_INF
from .clip import attend, layer_norm, stack_layers, tensor_loader

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160


def _resample(x: np.ndarray, sr: int) -> np.ndarray:
    t = np.linspace(0, len(x) - 1, int(len(x) * SAMPLE_RATE / sr))
    return np.interp(t, np.arange(len(x)), x).astype(np.float32)


def decode_wav(data: bytes) -> np.ndarray:
    """WAV or MP3 bytes -> mono f32 waveform at 16 kHz (linear resample;
    JAX `decode_wav`)."""
    from ..utils import mp3
    if mp3.looks_like_mp3(data):
        x, sr = mp3.decode_mp3(data)
        return _resample(x, sr) if sr != SAMPLE_RATE else x
    with wave.open(io.BytesIO(data)) as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
    if width == 1:
        x = (x - 128.0) / 128.0
    else:
        x = x / float(1 << (8 * width - 1))
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return _resample(x, sr) if sr != SAMPLE_RATE else x


def _mel_filterbank(n_mels: int) -> np.ndarray:
    """[n_mels, n_fft//2+1] whisper's mel filters: the Slaney mel scale
    (linear below 1 kHz, log above) with Slaney area normalization,
    triangles on the FFT bin frequencies."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        logstep = 27.0 / np.log(6.4)
        return np.where(f >= 1000.0,
                        15.0 + np.log(np.maximum(f, 1e-9) / 1000.0)
                        * logstep, 3.0 * f / 200.0)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        logstep = np.log(6.4) / 27.0
        return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)),
                        200.0 * m / 3.0)

    n_freqs = N_FFT // 2 + 1
    fft_freqs = np.linspace(0.0, SAMPLE_RATE / 2.0, n_freqs)
    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(SAMPLE_RATE / 2.0),
                       n_mels + 2)
    f_pts = mel_to_hz(mels)
    fdiff = np.diff(f_pts)
    slopes = f_pts[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / fdiff[:-1]
    up = slopes[:, 2:] / fdiff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels])
    return (fb * enorm[None, :]).T.astype(np.float32)


def log_mel_spectrogram(wav: np.ndarray, n_mels: int = 80) -> np.ndarray:
    """[T_frames, n_mels] log-mel features, whisper's frontend: periodic
    Hann window, centred frames (reflect padding n_fft/2), the trailing
    frame dropped, log10 clamped to max - 8, then (x + 4) / 4."""
    n = np.arange(N_FFT)
    window = (0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT))) \
        .astype(np.float32)
    pad = N_FFT // 2
    if len(wav) < 1:
        wav = np.zeros(HOP, np.float32)
    wav = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(wav) - N_FFT) // HOP
    frames = np.stack([wav[i * HOP:i * HOP + N_FFT]
                       for i in range(n_frames)])
    spec = np.abs(np.fft.rfft(frames * window, axis=1)) ** 2
    spec = spec[:-1]
    mel = spec @ _mel_filterbank(n_mels).T
    logmel = np.log10(np.maximum(mel, 1e-10))
    logmel = np.maximum(logmel, logmel.max() - 8.0)
    return ((logmel + 4.0) / 4.0).astype(np.float32)


_LAYER_TENSORS = {
    "ln1": ("ln1.weight", False), "ln1_b": ("ln1.bias", False),
    "wq": ("attn_q.weight", True), "bq": ("attn_q.bias", False),
    "wk": ("attn_k.weight", True), "bk": ("attn_k.bias", False),
    "wv": ("attn_v.weight", True), "bv": ("attn_v.bias", False),
    "wo": ("attn_out.weight", True), "bo": ("attn_out.bias", False),
    "ln2": ("ln2.weight", False), "ln2_b": ("ln2.bias", False),
    "w_up": ("ffn_up.weight", True), "b_up": ("ffn_up.bias", False),
    "w_down": ("ffn_down.weight", True), "b_down": ("ffn_down.bias", False),
}


def load_audio_tower(path: str, dtype=torch.float32, device="cuda"):
    """The audio branch of an mmproj GGUF ('a.' tensors; JAX
    `load_audio_tower`): (cfg dict, params) on `device` (CUDA unless the
    caller asks for the CPU; no CUDA is an error)."""
    from ..server.engine import resolve_device
    device = resolve_device(device)
    g = GGUFFile(path)
    md = g.metadata

    def kv(key, default=None):
        return md.get(f"clip.audio.{key}", md.get(f"clip.{key}", default))

    cfg = {
        "n_mels": int(kv("num_mel_bins", 80)),
        "n_embd": int(kv("embedding_length", 512)),
        "n_ff": int(kv("feed_forward_length", 2048)),
        "n_layers": int(kv("block_count", 6)),
        "n_heads": int(kv("attention.head_count", 8)),
        "eps": float(kv("attention.layer_norm_epsilon", 1e-5)),
        "proj_dim": int(kv("projection_dim", 2048)),
        # drives the audio prompt scaffold (qwen2a / ultravox)
        "proj_type": str(md.get("clip.projector_type", "")),
    }
    t = tensor_loader(g, dtype, device)
    params = {
        "conv1_w": t("a.conv1d.1.weight"),   # [E, n_mels, 3]
        "conv1_b": t("a.conv1d.1.bias"),
        "conv2_w": t("a.conv1d.2.weight"),   # [E, E, 3]
        "conv2_b": t("a.conv1d.2.bias"),
        "pos_embd": t("a.position_embd.weight"),
        "post_ln": t("a.post_ln.weight"),
        "post_ln_b": t("a.post_ln.bias"),
    }
    params["layers"] = stack_layers([
        {k: t(f"a.blk.{i}.{name}", tr)
         for k, (name, tr) in _LAYER_TENSORS.items()}
        for i in range(cfg["n_layers"])])
    for name in list(g.tensors):
        if name.startswith(("mm.a.", "mm.audio", "mm.fc")):
            params[name.replace(".", "_")] = t(
                name, transpose=name.endswith(".weight"))
    g.close()
    SRV_INF("load_audio", "audio tower: %d layers embd=%d mels=%d",
            cfg["n_layers"], cfg["n_embd"], cfg["n_mels"])
    return cfg, params


def _conv1d(x, w, b, stride: int):
    """x: [T, Cin]; w: [Cout, Cin, K] -> [T', Cout], padding 1 (JAX
    `_conv1d`: conv_general_dilated in f32)."""
    out = F.conv1d(x.float().T[None], w.float(), stride=stride,
                   padding=1)[0].T
    return out + b if b is not None else out


def encode_audio_impl(cfg: dict, params, mel) -> torch.Tensor:
    """mel: [T_frames, n_mels] (a tensor on the params' device) ->
    projected embeddings [N, proj_dim] (JAX `encode_audio_impl`)."""
    E, H, eps = cfg["n_embd"], cfg["n_heads"], cfg["eps"]
    D = E // H
    # jax.nn.gelu's default: the tanh form after the convolutions
    x = F.gelu(_conv1d(mel, params["conv1_w"], params["conv1_b"], 1),
               approximate="tanh")
    x = F.gelu(_conv1d(x, params["conv2_w"], params["conv2_b"], 2),
               approximate="tanh")
    if params.get("pos_embd") is not None:
        x = x + params["pos_embd"][:x.shape[0]]
    stacks = params["layers"]
    for i in range(cfg["n_layers"]):
        lp = {k: v[i] for k, v in stacks.items()}
        h = layer_norm(x, lp["ln1"], lp.get("ln1_b"), eps)
        q = (h @ lp["wq"] + lp.get("bq", 0.0)).reshape(-1, H, D)
        k = (h @ lp["wk"] + lp.get("bk", 0.0)).reshape(-1, H, D)
        v = (h @ lp["wv"] + lp.get("bv", 0.0)).reshape(-1, H, D)
        x = x + (attend(q, k, v) @ lp["wo"] + lp.get("bo", 0.0))
        h = layer_norm(x, lp["ln2"], lp.get("ln2_b"), eps)
        h = F.gelu(h @ lp["w_up"] + lp.get("b_up", 0.0))
        x = x + (h @ lp["w_down"] + lp.get("b_down", 0.0))

    if cfg.get("proj_type") == "qwen2a":
        # qwen2-audio head (HF Qwen2AudioEncoder): pairs of frames pooled
        # BEFORE the final layer norm, then one linear projector
        n2 = (x.shape[0] // 2) * 2
        x = x[:n2].reshape(-1, 2, E).mean(dim=1)
        if params.get("post_ln") is not None:
            x = layer_norm(x, params["post_ln"], params.get("post_ln_b"), eps)
        w = params.get("mm_fc1_weight", params.get("mm_a_fc1_weight"))
        if w is not None:
            x = x @ w + params.get("mm_fc1_bias",
                                   params.get("mm_a_fc1_bias", 0.0))
        return x
    if params.get("post_ln") is not None:
        x = layer_norm(x, params["post_ln"], params.get("post_ln_b"), eps)
    if "mm_a_0_weight" in params:
        x = x @ params["mm_a_0_weight"] + params.get("mm_a_0_bias", 0.0)
        if "mm_a_2_weight" in params:
            x = F.gelu(x)
            x = x @ params["mm_a_2_weight"] + params.get("mm_a_2_bias", 0.0)
    return x


def encode_audio(cfg: dict, params, wav_bytes: bytes) -> np.ndarray:
    """WAV/MP3 bytes -> projected embeddings [N, proj] f32 on the host,
    the tower run on the params' device."""
    mel = log_mel_spectrogram(decode_wav(wav_bytes), cfg["n_mels"])
    dev = params["conv1_w"].device
    with torch.no_grad():
        out = encode_audio_impl(cfg, params, torch.from_numpy(mel).to(dev))
    return out.float().cpu().numpy()
