"""CLIP/SigLIP, pixtral and Qwen2-VL vision towers with their multimodal
projectors, from an mmproj GGUF (counterpart of
llama_box_tpu/models/clip.py).

A ViT encoder turns preprocessed pixels into patch embeddings; the
projector maps them into the language model's embedding space, and the
engine prefills them as embedding chunks. Projectors: mlp (llava) and
mlp_norm (mm.0 / mm.2), the minicpmv resampler, internvl's and idefics3's
pixel shuffles, the qwen2vl merger (a 2x2 patch merge), pixtral's mm.1 /
mm.2.

In the JAX package every op of the towers is XLA (einsums, softmax, layer
norms), none a Pallas kernel. So the port writes them as plain torch ops
in f32, on the card as on the CPU, with the attention written out (no
library attention kernel), so that each op rounds where the JAX one does
(models/bert.py's precedent). `load_clip` loads f32 by default, as the
JAX CLI does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..gguf.reader import GGUFFile
from ..utils.logging import SRV_INF


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    image_size: int = 336
    patch_size: int = 14
    n_embd: int = 1024
    n_ff: int = 4096
    n_layers: int = 24
    n_heads: int = 16
    proj_dim: int = 4096
    eps: float = 1e-5
    projector: str = "mlp"
    use_silu: bool = False
    # llama.cpp clip semantics: clip.use_gelu=true -> (tanh) GELU;
    # otherwise the CLIP-default QUICK gelu (x * sigmoid(1.702x))
    use_gelu: bool = False
    use_gelu_quick: bool = True
    has_class_embd: bool = True
    image_mean: tuple = (0.48145466, 0.4578275, 0.40821073)
    image_std: tuple = (0.26862954, 0.26130258, 0.27577711)
    merge_size: int = 1          # qwen2vl merger: 2
    minicpmv_version: int = 0    # >0 => resampler projector + tiling
    wa_pattern: int = 0          # qwen2.5vl: every n-th block full-attn,
                                 # the rest attend within 8x8-patch windows
    vit_rms: bool = False        # qwen2.5vl / pixtral: RMSNorm tower
    rope_theta: float = 10000.0  # pixtral 2D rope base
    proj_scale: int = 2          # idefics3/smolvlm pixel-shuffle factor
    gelu_tanh: bool = False      # siglip gelu_pytorch_tanh towers

    @property
    def n_patches_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def n_patches(self) -> int:
        return self.n_patches_side ** 2


_LAYER_TENSORS = {
    "ln1": ("ln1.weight", False), "ln1_b": ("ln1.bias", False),
    "wq": ("attn_q.weight", True), "bq": ("attn_q.bias", False),
    "wk": ("attn_k.weight", True), "bk": ("attn_k.bias", False),
    "wv": ("attn_v.weight", True), "bv": ("attn_v.bias", False),
    "wo": ("attn_out.weight", True), "bo": ("attn_out.bias", False),
    "ln2": ("ln2.weight", False), "ln2_b": ("ln2.bias", False),
    "w_up": ("ffn_up.weight", True), "b_up": ("ffn_up.bias", False),
    "w_down": ("ffn_down.weight", True), "b_down": ("ffn_down.bias", False),
    "w_gate": ("ffn_gate.weight", True),    # qwen2.5vl SwiGLU
    "b_gate": ("ffn_gate.bias", False),
    "ls1": ("ls1.weight", False),           # internvl layer-scale
    "ls2": ("ls2.weight", False),
}

_RESAMPLER_TENSORS = {
    "query": ("resampler.query", False),
    "kv_w": ("resampler.kv.weight", True), "kv_b": ("resampler.kv.bias", False),
    "q_w": ("resampler.attn.q.weight", True),
    "q_b": ("resampler.attn.q.bias", False),
    "k_w": ("resampler.attn.k.weight", True),
    "k_b": ("resampler.attn.k.bias", False),
    "v_w": ("resampler.attn.v.weight", True),
    "v_b": ("resampler.attn.v.bias", False),
    "o_w": ("resampler.attn.out.weight", True),
    "o_b": ("resampler.attn.out.bias", False),
    "ln_q": ("resampler.ln_q.weight", False),
    "ln_q_b": ("resampler.ln_q.bias", False),
    "ln_kv": ("resampler.ln_kv.weight", False),
    "ln_kv_b": ("resampler.ln_kv.bias", False),
    "ln_post": ("resampler.ln_post.weight", False),
    "ln_post_b": ("resampler.ln_post.bias", False),
    "proj": ("resampler.proj.weight", True),
}


def tensor_loader(g: GGUFFile, dtype, device):
    """t(name, transpose) -> the GGUF tensor as f32-decoded torch on
    `device` in `dtype` ([in, out] when transposed and 2-D), or None when
    the file lacks it (the JAX loaders' `t`)."""
    def t(name, transpose=False):
        if name not in g.tensors:
            return None
        x = g.tensor_f32(name)
        if transpose and x.ndim == 2:
            x = x.T
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)
    return t


def stack_layers(layers: list[dict]) -> dict:
    """Per-layer dicts -> one dict of [L, ...] stacks, the keys the first
    layer has (the JAX loaders' stacking for lax.scan)."""
    return {k: torch.stack([lp[k] for lp in layers])
            for k in layers[0] if layers[0][k] is not None}


def load_clip(path: str, dtype=torch.float32, device="cuda"
              ) -> tuple[ClipConfig, dict]:
    """The vision tower and projector of an mmproj GGUF (JAX `load_clip`):
    the same config and parameter tree, as torch tensors on `device`
    (CUDA unless the caller asks for the CPU; no CUDA is an error)."""
    from ..server.engine import resolve_device
    device = resolve_device(device)
    g = GGUFFile(path)
    md = g.metadata

    def kv(key, default=None):
        return md.get(f"clip.vision.{key}", md.get(f"clip.{key}", default))

    proj = str(md.get("clip.projector_type", "mlp"))
    cfg = ClipConfig(
        image_size=int(kv("image_size", 336)),
        patch_size=int(kv("patch_size", 14)),
        n_embd=int(kv("embedding_length", 1024)),
        n_ff=int(kv("feed_forward_length", 4096)),
        n_layers=int(kv("block_count", 24)),
        n_heads=int(kv("attention.head_count", 16)),
        proj_dim=int(kv("projection_dim", 4096)),
        eps=float(kv("attention.layer_norm_epsilon", 1e-5)),
        projector=proj,
        use_silu=bool(md.get("clip.use_silu", False)),
        use_gelu=bool(md.get("clip.use_gelu", False)),
        use_gelu_quick=not bool(md.get("clip.use_gelu", False)),
        has_class_embd="v.class_embd" in g.tensors,
        image_mean=tuple(np.asarray(kv("image_mean",
                                       (0.48145466, 0.4578275, 0.40821073)))
                         .tolist()),
        image_std=tuple(np.asarray(kv("image_std",
                                      (0.26862954, 0.26130258, 0.27577711)))
                        .tolist()),
        merge_size=2 if "qwen2" in proj else 1,
        minicpmv_version=int(md.get("clip.minicpmv_version",
                                    2 if proj == "resampler" else 0)),
        wa_pattern=int(kv("n_wa_pattern", 0) or 0),
        vit_rms="2.5" in proj or "qwen25" in proj or proj == "pixtral",
        rope_theta=float(kv("rope_theta", 10000.0) or 10000.0),
        proj_scale=int(kv("projector.scale_factor", 2) or 2),
        gelu_tanh=bool(md.get("clip.use_gelu_tanh", proj == "idefics3")),
    )
    t = tensor_loader(g, dtype, device)
    params: dict = {
        "patch_embd": t("v.patch_embd.weight"),       # [E, 3, P, P]
        "patch_embd_1": t("v.patch_embd.weight.1"),   # qwen2vl temporal slice
        "patch_embd_b": t("v.patch_embd.bias"),
        "class_embd": t("v.class_embd"),
        "pos_embd": t("v.position_embd.weight"),      # [n_pos, E]
        "pre_ln": t("v.pre_ln.weight"),
        "pre_ln_b": t("v.pre_ln.bias"),
        "post_ln": t("v.post_ln.weight"),
        "post_ln_b": t("v.post_ln.bias"),
    }
    params["layers"] = stack_layers([
        {k: t(f"v.blk.{i}.{name}", tr)
         for k, (name, tr) in _LAYER_TENSORS.items()}
        for i in range(cfg.n_layers)])
    if cfg.wa_pattern > 0:
        # qwen2.5vl: every wa_pattern-th block is full attention
        params["layers"]["is_full"] = torch.tensor(
            [int((i + 1) % cfg.wa_pattern == 0) for i in range(cfg.n_layers)],
            dtype=torch.int32, device=device)
    for name in list(g.tensors):
        if name.startswith("mm."):
            params[name.replace(".", "_")] = t(
                name, transpose=name.endswith(".weight"))
    if any(n.startswith("resampler.") for n in g.tensors):
        # minicpmv perceiver resampler (llama.cpp clip.cpp resampler.*)
        params["resampler"] = {k: t(name, tr) for k, (name, tr)
                               in _RESAMPLER_TENSORS.items()}
    g.close()
    SRV_INF("load_clip", "clip: %d layers embd=%d patches=%d proj=%s",
            cfg.n_layers, cfg.n_embd, cfg.n_patches, cfg.projector)
    return cfg, params


# -- the ops, as the JAX towers write them -----------------------------------


def layer_norm(x, w, b, eps: float):
    """JAX `_ln`: mean, the mean squared deviation, rsqrt, weight, bias."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * w + (b if b is not None else 0.0)


def _rms(x, w, eps: float):
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * w).to(x.dtype)


def _gelu_quick(x):
    return x * torch.sigmoid(1.702 * x)


def _lin(x, w, b=None):
    y = x @ w
    return y + b if b is not None else y


def attend(q, k, v, keep=None):
    """softmax(q k^T / sqrt(D)) v over every row (JAX's einsum, softmax,
    einsum); q, k, v [N, H, D] -> [N, H * D]. keep [N, N] bool masks
    scores to -1e30, as the JAX qwen2.5vl window does."""
    D = q.shape[-1]
    s = torch.einsum("qhd,khd->hqk", q, k) * (D ** -0.5)
    if keep is not None:
        s = torch.where(keep[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(q.shape[0], -1)


def _layers(params) -> list[dict]:
    stacks = params["layers"]
    n = len(next(iter(stacks.values())))
    return [{k: v[i] for k, v in stacks.items()} for i in range(n)]


def _patchify(pixels, gh: int, gw: int, P: int):
    """[gh*P, gw*P, 3] -> [gh*gw, 3*P*P] in the conv weight's (c, y, x)
    order: the patch conv as one matmul, as JAX does it."""
    x = pixels.reshape(gh, P, gw, P, 3).permute(0, 2, 4, 1, 3)
    return x.reshape(gh * gw, 3 * P * P)


def _ffn_act(h, cfg: ClipConfig):
    if cfg.use_silu:
        return F.silu(h)
    if cfg.use_gelu_quick:
        return _gelu_quick(h)
    return F.gelu(h, approximate="tanh" if cfg.gelu_tanh else "none")


def _pixel_shuffle(x, S: int, E: int, sf: int):
    """HF's pixel-shuffle view/permute sequence (internvl at 2, idefics3
    at its scale factor): [S*S, E] -> [(S/sf)^2, E*sf*sf]."""
    v = x.reshape(S, S // sf, E * sf)
    v = v.permute(1, 0, 2).reshape(S // sf, S // sf, E * sf * sf)
    return v.permute(1, 0, 2).reshape((S // sf) ** 2, E * sf * sf)


def encode_image_impl(params, cfg: ClipConfig, pixels) -> torch.Tensor:
    """pixels: [H, W, 3] normalized f32 (a tensor on the params' device)
    -> projected embeddings [N, proj] (JAX `encode_image_impl`)."""
    P, S, E, H = cfg.patch_size, cfg.n_patches_side, cfg.n_embd, cfg.n_heads
    D = E // H
    x = _patchify(pixels, S, S, P) @ params["patch_embd"].reshape(E, -1).T
    if params.get("patch_embd_b") is not None:
        x = x + params["patch_embd_b"]
    if cfg.has_class_embd and params.get("class_embd") is not None:
        x = torch.cat([params["class_embd"][None, :], x], dim=0)
    n_pos = x.shape[0]
    if cfg.projector == "idefics3" and params.get("pos_embd") is not None:
        # HF Idefics3VisionEmbeddings buckets fractional coordinates
        # (torch.bucketize right=True == searchsorted side='left'), which
        # at full size yields ids like [0, 0, 1, 2] per axis, not arange
        bounds = np.arange(1, S) / S
        axis = np.searchsorted(bounds, np.arange(S) / S, side="left")
        ids = (axis[:, None] * S + axis[None, :]).reshape(-1)
        x = x + params["pos_embd"][torch.as_tensor(ids, device=x.device)]
    elif params.get("pos_embd") is not None:
        x = x + params["pos_embd"][:n_pos]
    if params.get("pre_ln") is not None:
        x = layer_norm(x, params["pre_ln"], params.get("pre_ln_b"), cfg.eps)

    for lp in _layers(params):
        h = layer_norm(x, lp["ln1"], lp.get("ln1_b"), cfg.eps)
        q = _lin(h, lp["wq"], lp.get("bq")).reshape(-1, H, D)
        k = _lin(h, lp["wk"], lp.get("bk")).reshape(-1, H, D)
        v = _lin(h, lp["wv"], lp.get("bv")).reshape(-1, H, D)
        ao = _lin(attend(q, k, v), lp["wo"], lp.get("bo"))
        if "ls1" in lp:
            ao = ao * lp["ls1"]
        x = x + ao
        h = layer_norm(x, lp["ln2"], lp.get("ln2_b"), cfg.eps)
        h = _lin(_ffn_act(_lin(h, lp["w_up"], lp.get("b_up")), cfg),
                 lp["w_down"], lp.get("b_down"))
        if "ls2" in lp:
            h = h * lp["ls2"]
        x = x + h

    if params.get("post_ln") is not None:
        x = layer_norm(x, params["post_ln"], params.get("post_ln_b"), cfg.eps)
    if cfg.has_class_embd:      # drop CLS for the projector (llava)
        x = x[1:]
    if cfg.merge_size > 1:      # qwen2vl merger: 2x2 merge before the MLP
        m = cfg.merge_size
        x = x.reshape(S // m, m, S // m, m, E).permute(0, 2, 1, 3, 4)
        x = x.reshape((S // m) * (S // m), m * m * E)
    if params.get("resampler") is not None:
        return _resampler_project(params["resampler"], cfg, x)
    if cfg.projector == "internvl":
        # pixel shuffle (0.5 downscale) + mlp1 (LN -> fc -> GELU -> fc;
        # mlp1.{0,1,3} -> mm.0/mm.1/mm.3)
        x = _pixel_shuffle(x, S, E, 2)
        x = layer_norm(x, params["mm_0_weight"], params.get("mm_0_bias"),
                       cfg.eps)
        x = F.gelu(_lin(x, params["mm_1_weight"], params.get("mm_1_bias")))
        return _lin(x, params["mm_3_weight"], params.get("mm_3_bias"))
    if cfg.projector == "idefics3":
        # smolvlm/idefics3 connector: pixel shuffle + one linear
        x = _pixel_shuffle(x, S, E, cfg.proj_scale)
        return _lin(x, params["mm_model_fc_weight"],
                    params.get("mm_model_fc_bias"))
    # projector: mm.0 (+gelu) mm.2 for mlp; single mm.0 otherwise
    if params.get("mm_0_weight") is not None:
        x = _lin(x, params["mm_0_weight"], params.get("mm_0_bias"))
        if params.get("mm_2_weight") is not None:
            x = _lin(F.gelu(x), params["mm_2_weight"],
                     params.get("mm_2_bias"))
    return x


def _apply_vit_rope(x, cos, sin):
    """x [N, H, D], cos/sin [N, D/2]: the half-split rotation of the
    Qwen2-VL towers (JAX `_apply_vit_rope`) and pixtral's."""
    half = x.shape[-1] // 2
    x0, x1 = x[..., :half], x[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)


def encode_image_pixtral_impl(params, cfg: ClipConfig, pixels,
                              grid_hw: tuple[int, int]) -> torch.Tensor:
    """Pixtral tower at the image's native (patch-quantized) size (JAX
    `encode_image_pixtral_impl`): patch conv, RMS norms, a 2D rope whose
    head dims take height then width frequency slices, gated SiLU FFN,
    llava-style two-layer GELU projector (mm.1 / mm.2)."""
    gh, gw = grid_hw
    P, E, H = cfg.patch_size, cfg.n_embd, cfg.n_heads
    D = E // H
    x = _patchify(pixels, gh, gw, P) @ params["patch_embd"].reshape(E, -1).T
    if params.get("patch_embd_b") is not None:
        x = x + params["patch_embd_b"]
    if params.get("pre_ln") is not None:
        x = _rms(x, params["pre_ln"], cfg.eps)
    half = D // 2
    freqs = 1.0 / (cfg.rope_theta
                   ** (np.arange(0, D, 2, dtype=np.float32) / D))
    fh = np.outer(np.arange(gh, dtype=np.float32), freqs[0::2])
    fw = np.outer(np.arange(gw, dtype=np.float32), freqs[1::2])
    ang = np.concatenate(
        [np.repeat(fh[:, None, :], gw, 1),
         np.repeat(fw[None, :, :], gh, 0)], axis=-1).reshape(gh * gw, half)
    cos = torch.as_tensor(np.cos(ang), dtype=x.dtype, device=x.device)
    sin = torch.as_tensor(np.sin(ang), dtype=x.dtype, device=x.device)
    for lp in _layers(params):
        h = _rms(x, lp["ln1"], cfg.eps)
        q = _apply_vit_rope((h @ lp["wq"]).reshape(-1, H, D), cos, sin)
        k = _apply_vit_rope((h @ lp["wk"]).reshape(-1, H, D), cos, sin)
        v = (h @ lp["wv"]).reshape(-1, H, D)
        x = x + attend(q, k, v) @ lp["wo"]
        h = _rms(x, lp["ln2"], cfg.eps)
        h = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
        x = x + h @ lp["w_down"]
    if params.get("mm_1_weight") is not None:
        x = _lin(x, params["mm_1_weight"], params.get("mm_1_bias"))
        if params.get("mm_2_weight") is not None:
            x = _lin(F.gelu(x), params["mm_2_weight"],
                     params.get("mm_2_bias"))
    return x


def pixtral_fit_resize(w: int, h: int, cfg: ClipConfig,
                       cap: int = 0) -> tuple[int, int]:
    """Pixtral native sizing: scale so the longest side fits image_size
    (and the optional server cap), then ceil to patch multiples."""
    P = cfg.patch_size
    limit = cfg.image_size if cap <= 0 else min(cfg.image_size, cap)
    scale = min(1.0, limit / max(w, h))
    W = max(P, math.ceil(w * scale / P) * P)
    H = max(P, math.ceil(h * scale / P) * P)
    return W, H


def _sincos_pos_2d(dim: int, side: int) -> np.ndarray:
    """2D sine-cosine position table [side*side, dim] (the minicpmv
    resampler adds it to keys; llama.cpp builds the same table)."""
    half = dim // 2
    omega = 1.0 / (10000.0 ** (np.arange(half // 2) / (half / 2.0)))
    pos = np.arange(side, dtype=np.float32)
    out = np.einsum("p,f->pf", pos, omega)
    emb_1d = np.concatenate([np.sin(out), np.cos(out)], -1)
    eh = np.repeat(emb_1d, side, axis=0)
    ew = np.tile(emb_1d, (side, 1))
    return np.concatenate([eh, ew], -1).astype(np.float32)


def _resampler_project(rp, cfg: ClipConfig, x) -> torch.Tensor:
    """Perceiver resampler (JAX `_resampler_project`): learned queries
    cross-attend the ViT patch grid, whose keys carry a 2D sincos
    position signal. x: [N, E_vit]."""
    q = rp["query"]
    D = q.shape[-1]
    heads = max(D // 128, 1)
    hd = D // heads
    kv = _lin(x, rp["kv_w"], rp.get("kv_b"))
    kv = layer_norm(kv, rp["ln_kv"], rp["ln_kv_b"], cfg.eps)
    side = int(np.sqrt(x.shape[0]))
    pos = torch.as_tensor(_sincos_pos_2d(D, side), device=x.device,
                          dtype=x.dtype)[: x.shape[0]]
    qn = layer_norm(q, rp["ln_q"], rp["ln_q_b"], cfg.eps)
    qh = (qn @ rp["q_w"] + rp["q_b"]).reshape(-1, heads, hd)
    kh = ((kv + pos) @ rp["k_w"] + rp["k_b"]).reshape(-1, heads, hd)
    vh = (kv @ rp["v_w"] + rp["v_b"]).reshape(-1, heads, hd)
    out = attend(qh, kh, vh) @ rp["o_w"] + rp["o_b"]
    out = layer_norm(out, rp["ln_post"], rp["ln_post_b"], cfg.eps)
    pw = rp["proj"]
    if pw.shape[0] != D:      # orientation differs between converters
        pw = pw.T
    return out @ pw


def _vit_2d_rope_angles(grid_h: int, grid_w: int, head_dim: int
                        ) -> np.ndarray:
    """Qwen2-VL vision rope: per-patch angles [n, head_dim/2], the first
    half of the rotary dims by the row index, the second by the column."""
    quarter = head_dim // 4
    inv_freq = 1.0 / (10000.0 ** (np.arange(quarter) / quarter))
    rows = np.repeat(np.arange(grid_h), grid_w)
    cols = np.tile(np.arange(grid_w), grid_h)
    return np.concatenate([np.outer(rows, inv_freq),
                           np.outer(cols, inv_freq)], axis=1)


def encode_image_qwen2vl_impl(params, cfg: ClipConfig, pixels,
                              grid_hw: tuple[int, int] | None = None
                              ) -> torch.Tensor:
    """Qwen2-VL ViT (JAX `encode_image_qwen2vl_impl`): the temporal patch
    conv (a still image repeats its frame, so the two temporal slices act
    as one summed weight), no learned positions, 2D rotary attention
    (qwen2.5vl: within 8x8-patch windows but on every wa_pattern-th
    block), the 2x2 merger MLP. pixels: [gh*P, gw*P, 3] -> [n_merged,
    proj]; grid_hw None is the trained square."""
    P = cfg.patch_size
    if grid_hw is None:
        grid_hw = (cfg.n_patches_side, cfg.n_patches_side)
    GH, GW = grid_hw
    E, H = cfg.n_embd, cfg.n_heads
    D = E // H
    w = params["patch_embd"].reshape(E, 3 * P * P)
    if params.get("patch_embd_1") is not None:
        w = w + params["patch_embd_1"].reshape(E, 3 * P * P)
    x = _patchify(pixels, GH, GW, P) @ w.T
    if params.get("patch_embd_b") is not None:
        x = x + params["patch_embd_b"]
    ang = _vit_2d_rope_angles(GH, GW, D)
    cos = torch.as_tensor(np.cos(ang), dtype=x.dtype, device=x.device)
    sin = torch.as_tensor(np.sin(ang), dtype=x.dtype, device=x.device)

    def norm(x, w, b):
        if cfg.vit_rms:
            var = x.float().square().mean(-1, keepdim=True)
            return (x * torch.rsqrt(var + cfg.eps)).to(x.dtype) * w
        return layer_norm(x, w, b, cfg.eps)

    window = None
    if cfg.wa_pattern > 0:
        # 8x8-patch windows (112 px at patch 14), patches kept in their
        # natural order (attention is permutation-invariant)
        idx = torch.arange(GH * GW, device=x.device)
        wid = (idx // GW // 8) * GW + (idx % GW) // 8
        window = wid[:, None] == wid[None, :]
    for lp in _layers(params):
        h = norm(x, lp["ln1"], lp.get("ln1_b"))
        q = _lin(h, lp["wq"], lp.get("bq")).reshape(-1, H, D)
        k = _lin(h, lp["wk"], lp.get("bk")).reshape(-1, H, D)
        v = _lin(h, lp["wv"], lp.get("bv")).reshape(-1, H, D)
        q, k = _apply_vit_rope(q, cos, sin), _apply_vit_rope(k, cos, sin)
        keep = None
        if window is not None and not int(lp["is_full"]):
            keep = window
        x = x + _lin(attend(q, k, v, keep), lp["wo"], lp.get("bo"))
        h = norm(x, lp["ln2"], lp.get("ln2_b"))
        if "w_gate" in lp:    # qwen2.5vl gated FFN
            h = F.silu(_lin(h, lp["w_gate"], lp.get("b_gate"))) \
                * _lin(h, lp["w_up"], lp.get("b_up"))
        else:
            h = _lin(h, lp["w_up"], lp.get("b_up"))
            h = (F.silu(h) if cfg.use_silu
                 else _gelu_quick(h) if cfg.use_gelu_quick else F.gelu(h))
        x = x + _lin(h, lp["w_down"], lp.get("b_down"))
    # merger: ln_q (the post_ln tensors), the 2x2 merge, a 2-layer MLP
    if params.get("post_ln") is not None:
        x = layer_norm(x, params["post_ln"], params.get("post_ln_b"), cfg.eps)
    m = max(cfg.merge_size, 1)
    x = x.reshape(GH // m, m, GW // m, m, E).permute(0, 2, 1, 3, 4)
    x = x.reshape((GH // m) * (GW // m), m * m * E)
    x = F.gelu(_lin(x, params["mm_0_weight"], params.get("mm_0_bias")))
    return _lin(x, params["mm_2_weight"], params.get("mm_2_bias"))


def qwen2vl_smart_resize(w: int, h: int, cfg: ClipConfig,
                         max_side: int = 0) -> tuple[int, int]:
    """The native grid-quantized pixel size (W, H) of an image:
    aspect-preserving, rounded to multiples of 2 merged tokens (2 x merge
    x patch px) a side, area clamped to [min, max] pixels (the published
    Qwen2-VL smart_resize, JAX `qwen2vl_smart_resize`)."""
    P = cfg.patch_size
    m = max(cfg.merge_size, 1)
    factor = 2 * P * m
    max_px = cfg.image_size * cfg.image_size * 4
    if max_side and max_side > 0:
        max_px = min(max_px, max_side * max_side)
    min_px = factor * factor

    def rnd(v):
        return max(factor, int(round(v / factor)) * factor)

    W, H = rnd(w), rnd(h)
    if W * H > max_px:
        s = (max_px / (w * h)) ** 0.5
        W = max(factor, int(w * s / factor) * factor)
        H = max(factor, int(h * s / factor) * factor)
    elif W * H < min_px:
        s = (min_px / (w * h)) ** 0.5
        W, H = rnd(w * s), rnd(h * s)
    return W, H


def _normalize(img, cfg: ClipConfig) -> np.ndarray:
    x = np.asarray(img, np.float32) / 255.0
    mean = np.asarray(cfg.image_mean, np.float32)
    std = np.asarray(cfg.image_std, np.float32)
    return (x - mean) / std


def preprocess_image_native(img, cfg: ClipConfig, size_wh: tuple[int, int]
                            ) -> np.ndarray:
    """PIL image -> normalized [H, W, 3] f32 at an explicit pixel size
    (Pillow's bicubic resize, as in JAX)."""
    from PIL import Image
    return _normalize(img.convert("RGB").resize(size_wh, Image.BICUBIC), cfg)


def preprocess_image(img, cfg: ClipConfig) -> np.ndarray:
    """PIL image -> normalized [H, W, 3] f32, bicubic-resized to the
    tower's input size."""
    return preprocess_image_native(img, cfg, (cfg.image_size, cfg.image_size))
