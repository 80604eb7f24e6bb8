"""Llama decoder in PyTorch (counterpart of the dense branches of
llama_box_tpu/models/llama.py: the llama graph and its dense variants,
LayerNorm and biases, q/k norms, post and sub norms, parallel residual,
ungated FFN, scales, learned positions, longrope; and its attention
variants, sliding windows with their per-layer pattern, gemma3's local
rope base, cohere2/exaone4's unroped global layers, attention softcap and
ALiBi; and its mixture-of-experts layers, every router, shared experts,
heterogeneous layer groups, gpt-oss's sinks, llama4's chunked window, q/k
L2 norm and temperature; and deepseek2's multi-head latent attention,
low-rank q and kv projections into a per-head K / V cache of unequal
widths; and Qwen2-VL's M-RoPE, whose rotary half-dims take their
sections' position streams (ops/rope.mrope_at: the tables gathered per
section, then the plain rotation), and the prefill of an embedding chunk
(a vision or audio tower's projected rows, bidirectional over gemma3's
image span); and jetmoe's mixture of attention (every expert's query
heads over one shared kv projection, the router's top k selecting at the
output mix); and per-request LoRA (each dense projection's low-rank delta
under its slot's scale row, _lora_delta) and control vectors (a [L, E]
residual add after each layer), with bf16/f32 weights or QTensors (w8a8
or grouped, ops/qmatmul). Every norm runs the row-norm kernel (ops/norm) on
the card, one order a row, and the routed experts the expert kernel
(ops/moe), one order a pair, so a verify pass's rows equal its one-row
decode steps bit for bit.

Attention variants, as JAX `_layer_is_local` and `_attn_deferred` give
them: layer li is local or global by a host list (layer_is_local); its
(window, chunk) kernel operand is row li of one [L, 2] buffer a device
(layer_windows), the window where the layer is local under a pattern
(everywhere without one), 0 elsewhere; rope tables are stacked [2, P,
half] where layers rotate differently (global/local bases, or identity
and rope for unroped global layers) and each layer takes branch
is_local of the tables gathered at the rows' positions; the softcap and
the ALiBi slopes (one [Hkv, G] buffer a device, alibi_slopes) go to every
attention call.

As in the JAX package, the KV cache stays read-only through a forward
(a prefill pass, or a whole K-step decode chain) and every layer's new
rows reach it in ONE scatter afterwards; the kernels see the JAX
semantics:
- prefill: the cache below pos0, plus the chunk's rows (rows operand);
- decode: the cache below the chain start cpos-(nv-1), plus the chain's
  rows 0..nv-1 with the current token's row last;
- verify (T rows a slot, a speculative pass): row j is a decode query at
  cpos = pos0 + j whose chain rows are the verify rows 0..j.
Every operand of a forward is computed on the device from fixed-shape
buffers (a prefill's tokens [S, T], pos_base [S], n_valid [S]; a chain's
token0, pos0 and active [S]), so a forward replays as one CUDA graph. The
scatter keeps a fixed shape too: all S x T (prefill, verify) or S x K
(decode) rows are written, row t of slot b to position (start + t) mod C,
and a row that is padding, inactive or past the capacity writes back the
value it overwrites (gathered first). A slot's positions are distinct when
T <= C, so no index repeats, the result is deterministic and an idle
slot's prefix-cache rows keep their bits. (JAX dropped writes at the
position >= C sentinel; an out-of-range index on CUDA is a device fault,
so the port never forms one.)

bf16 rounding points follow the JAX model: attention computes in `adt`
(f32 for an f32 cache, else bf16); rows are stored in the cache dtype
(int8 codes with bf16 scales for a q8_0 cache); the prefill attention
output stays f32 into the output projection while the decode output is
cast to `adt`; matmuls return x's dtype; the FFN activation runs in f32.

w8a8 weights: at decode widths (R = B*T <= 64 rows, bf16 activations)
the fused q/k/v projection, the layer tail and the output projection take
the fused kernels of ops/fused_decode, under the JAX package's own gates
(_fuse_qkv_ok, _fuse_tail_ok; both shut while LoRA scale rows are
present, whose deltas ride the unfused projections); the gates count
rows, so short prefill chunks and the prefill's last-token logits take
them too. The JAX package
makes them opt-in on the TPU; here they are on unless
LLAMA_BOX_TPU_NO_FUSED is set. Both paths give the same rounding.

Grouped weights (the LLAMA_BOX_TPU_PACKED4 / _Q4_INT8 / _Q4_F32SCALES
residencies): every projection goes through ops/qmatmul.mm, which runs
the Q4 or Q8 group-dequant kernel on the card. The fused gates stay
w8a8-only, as the JAX package's `_w8`, so decode rows take the unfused
path.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple

import torch

from ..ops import _kernels
from ..ops.attention import softmax_attend
from ..ops.flash_decode import flash_decode
from ..ops.flash_prefill import HEAD_PAIRS, flash_prefill_batched
from ..ops.fused_decode import (_MAX_ROWS, _pick_tile, fused_layer_tail,
                                fused_norm_qmm)
from ..ops.moe import ACTS as MOE_ACTS
from ..ops.moe import MAX_EXPERTS, MAX_PICKS, moe_ffn
from ..ops.norm import ln_per_head, norm_any, rms_norm
from ..ops.qmatmul import _SPLIT_MAX_ROWS, QTensor, dense_matmul, mm
from ..ops.rope import RopeParams, apply_rope, compute_rope_cache, mrope_at
from .config import ModelConfig


class KVCache(NamedTuple):
    """K [L, B, C, Hkv, D], V [L, B, C, Hkv, Dv]; an int8 cache carries
    per-(token, head) bf16 scales [L, B, C, Hkv] (the reference's
    -ctk/-ctv q8_0 mode)."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def kv_heads(cfg: ModelConfig) -> int:
    """The cache's heads: every query head under MLA, which decompresses
    its latent into per-head K and V (JAX `init_kv_cache`), else Hkv."""
    return cfg.n_heads if cfg.kv_lora_rank else cfg.n_kv_heads


def v_width(cfg: ModelConfig) -> int:
    """V's head width: value_length under MLA (128 where K has 192), else
    the head width."""
    return cfg.v_head_dim or cfg.head_dim


def init_kv_cache(cfg: ModelConfig, n_slots: int, capacity: int,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    lead = (cfg.n_layers, n_slots, capacity, kv_heads(cfg))
    kshape, vshape = lead + (cfg.head_dim,), lead + (v_width(cfg),)
    dev = torch.device(device)
    if dtype == torch.int8:
        return KVCache(
            k=torch.zeros(kshape, dtype=torch.int8, device=dev),
            v=torch.zeros(vshape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(lead, dtype=torch.bfloat16, device=dev),
            v_scale=torch.zeros(lead, dtype=torch.bfloat16, device=dev))
    return KVCache(k=torch.zeros(kshape, dtype=dtype, device=dev),
                   v=torch.zeros(vshape, dtype=dtype, device=dev))


def _kv_quantize(x: torch.Tensor):
    """[..., D] f32 -> (int8 codes, [...] bf16 scales): symmetric per row,
    round half to even (torch.round, like jnp.round)."""
    amax = x.abs().amax(dim=-1)
    scale = amax.clamp_min(1e-6) / 127.0
    q = torch.round(x / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def attn_dtype(kv: KVCache) -> torch.dtype:
    """The attention compute dtype `adt`: f32 for an f32 cache, else bf16."""
    return torch.float32 if kv.k.dtype == torch.float32 else torch.bfloat16


# -- what this slice of the port covers --------------------------------------

_LAYER_KEYS = {
    "attn_norm", "attn_norm_b", "attn_norm_2", "attn_norm_2_b", "ffn_norm",
    "ffn_norm_b", "wq", "wk", "wv", "wqkv", "wo", "w_gate", "w_up",
    "w_gateup", "w_down", "bq", "bk", "bv", "bo", "b_gate", "b_up", "b_down",
    "q_norm", "k_norm", "q_norm_b", "k_norm_b", "attn_post_norm",
    "attn_post_norm_b", "ffn_post_norm", "ffn_post_norm_b", "attn_sub_norm",
    "ffn_sub_norm", "xielu",
    # mixture of experts, gpt-oss's sinks
    "w_gate_inp", "b_gate_inp", "w_gate_exps", "w_up_exps", "w_down_exps",
    "b_gate_exps", "b_up_exps", "b_down_exps", "w_gate_shexp", "w_up_shexp",
    "w_down_shexp", "w_gate_inp_shexp", "exp_probs_b", "ffn_norm_exps",
    "sinks",
    # multi-head latent attention (deepseek2 / deepseek3 / kimi, minicpm3)
    "wq_a", "q_a_norm", "wq_b", "wkv_a", "kv_a_norm", "wkv_b",
    # jetmoe's mixture of attention
    "wq_exps", "wo_exps", "attn_gate_inp"} | {
    # per-request LoRA stacks (models/lora.stack_dynamic; lora_Bt_ is the
    # engine's layout of lora_B_, loader.fuse_projections)
    f"lora_{p}_{k}" for p in ("A", "B", "Bt")
    for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
# the recurrent families' layer tensors (models/mamba.py, models/rwkv.py):
# the mamba / mamba2 / DeltaNet mixers, lfm2's short conv, qwen3-next's
# attention output gate, rwkv6/7's time and channel mix
_REC_KEYS = {
    "ssm_in", "ssm_x", "ssm_dt", "ssm_out", "ssm_conv_w", "ssm_conv_b",
    "ssm_dt_b", "ssm_a", "ssm_d", "ssm_norm", "ssm_dt_norm", "ssm_b_norm",
    "ssm_c_norm", "ssm_ba", "wq_gate", "shortconv_in", "shortconv_out",
    "shortconv_conv", "shortconv_conv_b",
    "tm_k", "tm_v", "tm_r", "tm_g", "tm_o", "cm_k", "cm_r", "cm_v", "tm_w1",
    "tm_w2", "tm_lerp_x", "tm_lerp_w", "tm_lerp_k", "tm_lerp_v", "tm_lerp_r",
    "tm_lerp_g", "tm_lerp_fused", "tm_first", "tm_decay", "tm_decay_w1",
    "tm_decay_w2", "tm_ln", "tm_ln_b", "cm_lerp_k", "cm_lerp_r", "tm_w0",
    "tm_a0", "tm_a1", "tm_a2", "tm_v0", "tm_v1", "tm_v2", "tm_g1", "tm_g2",
    "tm_lerp_a", "tm_kk", "tm_ka", "tm_rk"}
_ROOT_KEYS = {"tok_embd", "pos_embd", "tok_embd_norm", "tok_embd_norm_b",
              "output_norm", "output_norm_b", "output", "output_b", "layers",
              "layer_groups", "cvec", "lora_scales"}
_EXPERT_STACKS = ("w_gate_exps", "w_up_exps", "w_down_exps")
# the keys that may hold a QTensor (the JAX loader's quantizable 2D
# projections; token_embd and the norms stay dense)
_Q_KEYS = {"wq", "wk", "wv", "wqkv", "wo", "w_gate", "w_up", "w_gateup",
           "w_down", "output",
           # the recurrent projections (the JAX loader's _LAYER_WEIGHTS)
           "ssm_in", "ssm_x", "ssm_dt", "ssm_out", "shortconv_in",
           "shortconv_out", "ssm_ba", "wq_gate", "tm_k", "tm_v", "tm_r",
           "tm_g", "tm_o", "cm_k", "cm_r", "cm_v"}


# what the attention kernels instantiate (csrc/flash_prefill.cu,
# csrc/flash_decode.cu): (K, V) head width pairs, and the GQA group of
# flash decode (flash prefill takes up to 128)
_KERNEL_HEAD_PAIRS, _KERNEL_MAX_GROUP = HEAD_PAIRS, 16


def layer_groups(params: dict) -> list[dict]:
    """The stacked layer groups in layer order: `layer_groups` where the
    tree has them (heterogeneous layers), else the one `layers` stack."""
    return params.get("layer_groups") or [params.get("layers", {})]


def moe_act(cfg: ModelConfig) -> str:
    """The expert activation of JAX `_moe_mix`: silu under llama4's
    weight-before-FFN routing, else the configured one (JAX `_act` takes
    any other name as silu; the CPU path does too, the card refuses it)."""
    return "silu" if cfg.moe_weight_before_ffn else cfg.act_fn


def check_supported(cfg: ModelConfig, params: dict, device=None) -> None:
    """Raise NotImplementedError for a model outside the dense llama graph,
    its dense, attention, mixture-of-experts and latent-attention variants
    and the recurrent families (models/mamba.py, models/rwkv.py: a
    recurrent config whose layers carry a recurrent mixer; the recurrent
    tensors nowhere else), or, on a CUDA `device`, for shapes the kernels
    do not take: a (K, V) head width pair (where a layer attends), expert
    stacks that are not bf16, an expert activation or width
    csrc/moe_ffn.cu lacks, a state width csrc/ssm_scan.cu or csrc/wkv.cu
    lacks. The engine refuses such a model at load, not at its first
    request, and nothing falls back to a plain version."""
    groups = layer_groups(params)
    mla = {"wkv_a" in gp for gp in groups}
    rec = bool(getattr(cfg, "recurrent", False))
    rec_groups = [gp for gp in groups
                  if {"ssm_in", "shortconv_in", "tm_k"} & set(gp)]
    unsupported = {
        # a recurrent config runs models/mamba.py, which needs a mixer
        "recurrent": rec and not rec_groups,
        # M-RoPE gathers 2-D tables per section
        "mrope_sections": bool(cfg.mrope_sections) and (
            cfg.nope_layer_step > 0 or cfg.rope_freq_base_swa > 0),
        "act_fn": cfg.act_fn not in ("silu", "gelu", "relu2", "xielu",
                                     "swiglu_oai"),
        # MLA in every layer (its tensors) exactly when the config has its
        # rank; a V width other than K's only there
        "kv_lora_rank": mla != {cfg.kv_lora_rank > 0},
        "v_head_dim": v_width(cfg) != cfg.head_dim and mla != {True},
    }
    extra_keys = set().union(*groups) - _LAYER_KEYS - (_REC_KEYS if rec
                                                       else set())
    bad = [k for k, v in unsupported.items() if v]
    if not rec and extra_keys & _REC_KEYS:
        raise NotImplementedError(
            f"{cfg.arch}: the recurrent mixer's tensors "
            f"{sorted(extra_keys & _REC_KEYS)} in a config that is not "
            "recurrent")
    if bad or extra_keys or set(params) - _ROOT_KEYS:
        raise NotImplementedError(
            f"{cfg.arch}: not on the ported llama graph "
            f"(config: {bad}, tensors: "
            f"{sorted(extra_keys | (set(params) - _ROOT_KEYS))})")
    leaves = [(k, v) for gp in groups for k, v in gp.items()] \
        + [(k, v) for k, v in params.items()
           if k not in ("layers", "layer_groups")]
    for key, w in leaves:
        if isinstance(w, QTensor) and key not in _Q_KEYS:
            raise NotImplementedError(f"{cfg.arch}: {key} as a QTensor")
    if device is not None and torch.device(device).type == "cuda":
        for gp in groups:
            if "w_gate_exps" not in gp:
                continue
            dts = {str(gp[k].dtype) for k in _EXPERT_STACKS}
            X, E, F = gp["w_gate_exps"].shape[-3:]
            K = max(cfg.expert_used_count, 1)
            if dts != {"torch.bfloat16"}:
                raise NotImplementedError(
                    f"{cfg.arch}: the CUDA expert kernel (csrc/moe_ffn.cu) "
                    f"takes bf16 expert stacks, not {sorted(dts)}; "
                    "--device cpu runs it")
            if moe_act(cfg) not in MOE_ACTS:
                raise NotImplementedError(
                    f"{cfg.arch}: the CUDA expert kernel takes the "
                    f"activations {MOE_ACTS}, not {moe_act(cfg)!r}; "
                    "--device cpu runs it")
            if E % 8 or F % 8 or K > min(X, MAX_PICKS) or X > MAX_EXPERTS:
                raise NotImplementedError(
                    f"{cfg.arch}: the CUDA expert kernel takes widths that "
                    f"are multiples of 8, up to {MAX_PICKS} picks and "
                    f"{MAX_EXPERTS} experts (this model: E {E}, FF {F}, "
                    f"{K} of {X}); --device cpu runs it")
        if rec:
            _check_rec_kernels(cfg, rec_groups)
        attends = any("wq" in gp or "wqkv" in gp or "wkv_a" in gp
                      or "wq_exps" in gp for gp in groups)
        dv = v_width(cfg)
        group = cfg.n_heads / max(1, kv_heads(cfg))
        if attends and ((cfg.head_dim, dv) not in _KERNEL_HEAD_PAIRS
                        or group > _KERNEL_MAX_GROUP):
            raise NotImplementedError(
                f"{cfg.arch}: the CUDA attention kernels take the (K, V) "
                f"head widths {_KERNEL_HEAD_PAIRS} and up to "
                f"{_KERNEL_MAX_GROUP} query heads per KV head (this model: "
                f"K {cfg.head_dim}, V {dv}, {cfg.n_heads} / "
                f"{kv_heads(cfg)} heads); --device cpu runs it")


def _check_rec_kernels(cfg: ModelConfig, rec_groups: list[dict]) -> None:
    """The recurrent mixers' state widths the CUDA kernels take: at most
    ssm_scan.MAX_STATE states a channel (csrc/ssm_scan.cu); rwkv's head
    size and the DeltaNet's key and value widths, equal, among
    wkv.WIDTHS (csrc/wkv.cu)."""
    from ..ops.ssm_scan import MAX_STATE
    from ..ops.wkv import WIDTHS
    for gp in rec_groups:
        if "tm_k" in gp:
            N = (cfg.wkv_head_size,) * 2
        elif "ssm_ba" in gp:
            N = (cfg.ssm_d_state, gp["ssm_norm"].shape[-1])
        else:
            if "ssm_in" in gp and cfg.ssm_d_state > MAX_STATE:
                raise NotImplementedError(
                    f"{cfg.arch}: the CUDA selective scan (csrc/ssm_scan.cu)"
                    f" takes up to {MAX_STATE} states a channel, not "
                    f"{cfg.ssm_d_state}; --device cpu runs it")
            continue
        if N[0] != N[1] or N[0] not in WIDTHS:
            raise NotImplementedError(
                f"{cfg.arch}: the CUDA WKV kernel (csrc/wkv.cu) takes equal "
                f"key and value widths among {WIDTHS}, not {N}; --device "
                "cpu runs it")


# -- rope --------------------------------------------------------------------


def _rope_params(cfg: ModelConfig, max_pos: int = 0) -> RopeParams:
    """The JAX `_rope_params`: longrope (phi3) when the GGUF ships the
    factor tensors, whose long set applies when the runtime context
    max_pos exceeds the original window, with the magnitude factor
    sqrt(1 + ln(scale) / ln(orig)) where the file gives none."""
    attn_factor = cfg.yarn_attn_factor
    factors = ()
    scaling_type = cfg.rope_scaling_type
    if cfg.extra.get("rope_factors_short") \
            or cfg.extra.get("rope_factors_long"):
        scaling_type = "longrope"
    if scaling_type == "longrope":
        orig = cfg.rope_orig_ctx or cfg.n_ctx_train
        factors = tuple(cfg.extra.get(
            "rope_factors_long" if max_pos > orig else "rope_factors_short",
            ()))
        scale = cfg.n_ctx_train / max(orig, 1)
        if attn_factor == 1.0 and scale > 1.0:
            attn_factor = math.sqrt(1.0 + math.log(scale) / math.log(orig))
    return RopeParams(
        head_dim=cfg.head_dim, n_rot=cfg.rope_dim,
        freq_base=cfg.rope_freq_base, freq_scale=cfg.rope_freq_scale,
        scaling_type=scaling_type,
        yarn_orig_ctx=cfg.rope_orig_ctx or cfg.n_ctx_train,
        yarn_ext_factor=cfg.yarn_ext_factor,
        yarn_attn_factor=attn_factor,
        yarn_beta_fast=cfg.yarn_beta_fast, yarn_beta_slow=cfg.yarn_beta_slow,
        mode=cfg.rope_mode, freq_factors=factors)


def make_rope(cfg: ModelConfig, max_pos: int, device="cuda"):
    """(cos, sin) tables [max_pos, rot/2] f32 on `device`, or stacked [2,
    max_pos, rot/2] where layers rotate differently (JAX `make_rope`):
    identity at index 0 and rope at 1 for the unroped global layers of
    nope_layer_step (cohere2, exaone4); gemma3's global base at 0 and its
    local base rope_freq_base_swa at 1. Layer li takes index
    layer_is_local(cfg)[li]."""
    rp = _rope_params(cfg, max_pos)
    cos, sin = compute_rope_cache(rp, max_pos, device)
    if cfg.nope_layer_step > 0:
        return (torch.stack([torch.ones_like(cos), cos]),
                torch.stack([torch.zeros_like(sin), sin]))
    if cfg.swa_pattern > 0 and cfg.rope_freq_base_swa > 0:
        cos_l, sin_l = compute_rope_cache(dataclasses.replace(
            rp, freq_base=cfg.rope_freq_base_swa), max_pos, device)
        return torch.stack([cos, cos_l]), torch.stack([sin, sin_l])
    return cos, sin


def layer_is_local(cfg: ModelConfig) -> list[int]:
    """Per layer, 1 where it is local (JAX `_layer_is_local`): under
    nope_layer_step every step-th layer is global (full context, unroped);
    under a sliding window every swa_pattern-th layer is global, or every
    layer is local without a pattern; else none is."""
    L = cfg.n_layers
    if cfg.nope_layer_step > 0:
        return [int((i + 1) % cfg.nope_layer_step != 0) for i in range(L)]
    if cfg.swa_window <= 0:
        return [0] * L
    if cfg.swa_pattern <= 0:
        return [1] * L
    return [int((i + 1) % cfg.swa_pattern != 0) for i in range(L)]


def make_delta_rope(cfg: ModelConfig, max_pos: int, device="cuda"):
    """Pure-rotation tables for shift_kv: make_rope's frequencies without
    the YaRN mscale amplitude (the stored keys carry it once already).
    Stacked [2, P, half] where layers rotate differently, as make_rope
    (identity at index 0 for unroped layers; gemma3's local base at index
    1): shift_kv then picks one per layer by layer_is_local, as the JAX
    engine passes it as `layer_select`."""
    def pure(rp):
        cos, sin = compute_rope_cache(
            dataclasses.replace(rp, yarn_attn_factor=1.0), max_pos, device)
        if rp.scaling_type == "yarn" and rp.freq_scale != 1.0:
            # the residual of attn_factor 1: 1 + 0.1 ln(1 / freq_scale)
            mscale = 1.0 + 0.1 * math.log(1.0 / rp.freq_scale)
            cos, sin = cos / mscale, sin / mscale
        return cos, sin

    rp = _rope_params(cfg, max_pos)
    cos, sin = pure(rp)
    if cfg.nope_layer_step > 0:
        return (torch.stack([torch.ones_like(cos), cos]),
                torch.stack([torch.zeros_like(sin), sin]))
    if cfg.swa_pattern > 0 and cfg.rope_freq_base_swa > 0:
        cos_l, sin_l = pure(dataclasses.replace(
            rp, freq_base=cfg.rope_freq_base_swa))
        return torch.stack([cos, cos_l]), torch.stack([sin, sin_l])
    return cos, sin


# -- in-place KV-cache edits -------------------------------------------------
#
# Both take the slot and row counts as host ints and write into the cache's
# own tensors, which the engine's CUDA graphs captured by address; they are
# plain torch ops enqueued on the caller's current stream, with no read-back.


def shift_kv(kv: KVCache, slot: int, n_keep: int, n_discard: int,
             delta_cos, delta_sin, rope_mode: str,
             layer_select=None) -> KVCache:
    """Context shift of one slot, in place (JAX `shift_kv_impl`): row i
    takes row i + n_discard (clipped to C - 1) for i >= n_keep, and its
    key is rotated by -n_discard positions (RoPE is additive in position
    at fixed frequency); values (and their scales) only move. Stacked [2,
    P, half] tables rotate layer l by branch layer_select[l] (a host list,
    layer_is_local). An int8 cache re-quantizes every key row of the slot
    from the rotated f32 values, the kept prefix too, as JAX does."""
    C = kv.capacity
    idx = torch.arange(C, device=kv.k.device)
    src = torch.where(idx < n_keep, idx, (idx + n_discard).clamp_max(C - 1))
    moved = (idx >= n_keep)[None, :, None, None]
    # gathered first: source and destination rows overlap within the slot
    k_g = kv.k[:, slot].index_select(1, src)              # [L, C, Hkv, D]
    v_g = kv.v[:, slot].index_select(1, src)
    if kv.quantized:
        ks_g = kv.k_scale[:, slot].index_select(1, src)   # [L, C, Hkv]
        vs_g = kv.v_scale[:, slot].index_select(1, src)
        k_f = k_g.float() * ks_g.float()[..., None]
    else:
        k_f = k_g.float()
    # the rotation by n_discard for every row: cos(d), -sin(d), [1, half],
    # or [L, 1, half] from stacked tables by each layer's branch
    c = delta_cos[..., n_discard:n_discard + 1, :]
    s = delta_sin[..., n_discard:n_discard + 1, :]
    if delta_cos.dim() == 3 and layer_select is not None:
        sel = torch.tensor(layer_select, device=c.device)
        c, s = c.index_select(0, sel), s.index_select(0, sel)
    k_rot = apply_rope(k_f, None, c, -s, rope_mode)
    if kv.quantized:
        k_rot_f = torch.where(moved, k_rot, k_f)
        amax = k_rot_f.abs().amax(dim=-1)
        ks_new = (amax.clamp_min(1e-6) / 127.0).to(torch.bfloat16)
        k_new = torch.round(k_rot_f / ks_new.float()[..., None]).clamp(
            -127, 127).to(torch.int8)
        kv.k_scale[:, slot].copy_(ks_new)
        kv.v_scale[:, slot].copy_(vs_g)
    else:
        k_new = torch.where(moved, k_rot.to(k_g.dtype), k_g)
    kv.k[:, slot].copy_(k_new)
    kv.v[:, slot].copy_(v_g)
    return kv


def copy_kv_prefix(kv: KVCache, src: int, dst: int, n: int) -> KVCache:
    """Rows [0, n) of slot `src` into slot `dst`, every leaf, in place (JAX
    `copy_kv_prefix_impl`): a new request that shares a busy sibling's
    prefix takes its rows instead of recomputing them. dst's rows from n
    on keep their bits. The slots differ, so the views do not overlap."""
    for x in kv:
        if x is not None:
            x[:, dst, :n].copy_(x[:, src, :n])
    return kv


# -- layers ------------------------------------------------------------------


def _weak(s: float, dtype) -> float:
    """The Python scalar s rounded to `dtype`, as JAX takes a weak-typed
    scalar in an array's dtype."""
    return float(torch.tensor(s, dtype=dtype))


def _scaled(t: torch.Tensor, s: float) -> torch.Tensor:
    """t * s as JAX computes it (skipped at 1, where it changes no bit)."""
    return t if s == 1.0 else t * _weak(s, t.dtype)


def _norm_any(x, w, b, cfg: ModelConfig):
    """RMS or LayerNorm (biased) per cfg.norm_style (JAX `_norm_any`),
    through the row-norm kernel on the card."""
    return norm_any(x, w, b, cfg.norm_style, cfg.rms_eps)


def _pre_norm(x, lp, key, cfg: ModelConfig):
    """Input norm; an absent tensor is the identity (olmo2's post-norm-only
    blocks)."""
    if key not in lp:
        return x
    return _norm_any(x, lp[key], lp.get(key + "_b"), cfg)


def _act(gate: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.act_fn == "gelu":
        return torch.nn.functional.gelu(gate, approximate="tanh")
    if cfg.act_fn == "relu2":
        return torch.square(torch.relu(gate))
    return torch.nn.functional.silu(gate)


def _xielu(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """apertus xIELU (JAX `_xielu`): p = raw [alpha_p, alpha_n, beta, eps],
    softplus applied here."""
    sp = torch.nn.functional.softplus
    ap = sp(p[0])
    beta = p[2]
    an = beta + sp(p[1])
    return torch.where(x > 0, ap * x * x + beta * x,
                       (torch.expm1(torch.minimum(x, p[3])) - x) * an
                       + beta * x)


def _top_k(x: torch.Tensor, k: int):
    """jax.lax.top_k over the last dim: the k largest values and their
    indices, ties to the lower index (a stable descending sort; bf16
    router logits tie often enough to flip an expert otherwise)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _moe_ffn(h, lp, cfg: ModelConfig) -> torch.Tensor:
    """The mixture-of-experts FFN (JAX `_moe_ffn`), h [..., E] -> [..., E]
    f32: the router product in h's dtype, its bias (gpt-oss) and tanh cap
    (grok), then in f32 phimoe's sparsemixer (gating func 3), or the
    sigmoid (2) or softmax scores with deepseek3's bias-corrected,
    group-limited selection (exp_probs_b) or a plain top-k, the weights
    renormalized under expert_weights_norm; the experts in _moe_mix."""
    X, K = cfg.expert_count, max(cfg.expert_used_count, 1)
    router = mm(h, lp["w_gate_inp"])
    if "b_gate_inp" in lp:
        router = router + lp["b_gate_inp"]
    if cfg.router_softcap > 0.0:
        c = cfg.router_softcap
        router = _scaled(torch.tanh(router / _weak(c, router.dtype)), c)
    s = router.float()
    if cfg.expert_gating_func == 3:
        # phimoe's sparsemixer at inference (HF sparsemixer, training
        # False): two rounds, each the argmax of the scores left, weighted
        # by the softmax of the original scores masked to those within
        # 2 x jitter_eps (relative) of the round's max; not renormalized
        eps = cfg.router_jitter_eps

        def pick(masked):
            thr = masked.max(-1, keepdim=True).values
            idx = masked.argmax(-1)
            factor = torch.maximum(s.abs(), thr)
            gates = torch.where((thr - s) / factor > 2.0 * eps,
                                -torch.inf, masked)
            w = torch.softmax(gates, dim=-1).gather(-1, idx[..., None])
            return idx, w[..., 0]

        i1, w1 = pick(s)
        first = torch.nn.functional.one_hot(i1, X).bool()
        i2, w2 = pick(torch.where(first, -torch.inf, s))
        return _moe_mix(h, lp, cfg, torch.stack([i1, i2], -1),
                        torch.stack([w1, w2], -1))
    if cfg.expert_gating_func == 2:
        probs = torch.sigmoid(s)
    else:
        probs = torch.softmax(s, dim=-1)
    if "exp_probs_b" in lp:
        # deepseek3 noaux_tc: select on bias-corrected scores, group-
        # limited (the sum of each group's top 2 picks the groups; the
        # others are zeroed, as HF does), weight by the uncorrected ones
        choice = probs + lp["exp_probs_b"].float()
        ng, ug = cfg.expert_group_count, cfg.expert_group_used_count
        if ng > 1 and ug < ng:
            gsc = choice.reshape(*choice.shape[:-1], ng, X // ng)
            g2 = _top_k(gsc, min(2, X // ng))[0].sum(-1)
            gmask = torch.zeros_like(g2).scatter(-1, _top_k(g2, ug)[1], 1.0)
            choice = (gsc * gmask[..., None]).reshape(probs.shape)
        topi = _top_k(choice, K)[1]
        topv = probs.gather(-1, topi)
    else:
        topv, topi = _top_k(probs, K)
    if cfg.expert_weights_norm:
        topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)
    return _moe_mix(h, lp, cfg, topi, topv)


def _f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return dense_matmul(x, w.float())


def _lora_delta(h, lp, key: str, scales):
    """The per-slot scaled low-rank delta of projection `key` (JAX
    `_lora_delta`; dynamic LoRA), h [B, T, in] -> [B, T, out] in h's dtype,
    or None without stacks or scales. scales [S, n_ad]: row b scales
    batch row b (one row broadcasts; other counts raise TypeError, where
    JAX's broadcast fails). In f32, through dense_matmul (a row's bits do
    not depend on the call's rows): t = h A^T over every adapter at once,
    scaled per row and adapter, then ONE product against the adapters'
    B^T stacked along the inner dim ([n_ad * r, out]: lora_Bt_<key>, or
    made from lora_B_<key>), so the sum over adapters rides that product's
    inner dim where JAX sums the per-adapter products after it (f32
    rounding apart, tests/test_torch_lora.py)."""
    A = lp.get(f"lora_A_{key}")
    if A is None or scales is None:
        return None
    n_ad, r, E = A.shape
    S, B = scales.shape[0], h.shape[0]
    if S != B and S != 1:
        raise TypeError(f"lora_scales rows {S} do not broadcast against "
                        f"{B} batch rows")
    Bt = lp.get(f"lora_Bt_{key}")
    if Bt is None:
        Bt = lp[f"lora_B_{key}"].transpose(1, 2).reshape(n_ad * r, -1)
    lead = h.shape[:-1]
    t = dense_matmul(h.float(), A.reshape(n_ad * r, E).T)
    s = scales.float().view(S, *(1,) * (len(lead) - 1), n_ad, 1)
    t = (t.view(*lead, n_ad, r) * s).view(*lead, n_ad * r)
    return dense_matmul(t, Bt).to(h.dtype)


def _plus_lora(y, h, lp, key: str, lora):
    """y + _lora_delta(h, ...), or y where there is none."""
    d = _lora_delta(h, lp, key, lora)
    return y if d is None else y + d


def _expert_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, in] against every expert's w [X, in, out] -> [X, M, out] in
    x's dtype (one batched product; on the card a call of at most
    _SPLIT_MAX_ROWS rows runs at that many, as dense_matmul does)."""
    M = x.shape[0]
    pad = x.is_cuda and M < _SPLIT_MAX_ROWS
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, _SPLIT_MAX_ROWS - M))
    y = torch.matmul(x[None], w.to(x.dtype))
    return y[:, :M] if pad else y


def _moa_route(h, lp, cfg: ModelConfig) -> torch.Tensor:
    """jetmoe's mixture-of-attention router (JAX `_attn_layer`): the
    router product in h's dtype, softmax in f32, the top k renormalized
    and scattered into a dense [B, T, X] mask (0 for unselected
    experts)."""
    pr = torch.softmax(dense_matmul(h, lp["attn_gate_inp"]).float(), dim=-1)
    topv, topi = _top_k(pr, max(cfg.expert_used_count, 1))
    topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)
    return torch.zeros_like(pr).scatter_add(-1, topi, topv)


def _moa_qkv(h, lp, cfg: ModelConfig):
    """jetmoe's queries (JAX `_attn_layer`'s MoA branch): every expert's
    query heads, H = X * Hkv laid out [Hkv, X] (expert x's head for kv
    head m is head m * X + x, GQA group slot x), over the one shared k
    and v projection. Returns q [B, T, H, D], k, v [B, T, Hkv, D]."""
    B, T, E = h.shape
    Hkv, D = cfg.n_kv_heads, cfg.head_dim
    Xe = lp["wq_exps"].shape[0]
    q = _expert_mm(h.reshape(B * T, E), lp["wq_exps"])      # [X, BT, Hkv D]
    q = q.view(Xe, B, T, Hkv, D).permute(1, 2, 3, 0, 4).reshape(
        B, T, Hkv * Xe, D)
    return (q, mm(h, lp["wk"]).reshape(B, T, Hkv, D),
            mm(h, lp["wv"]).reshape(B, T, Hkv, -1))


def _moe_mix(h, lp, cfg: ModelConfig, topi, topv) -> torch.Tensor:
    """The routed experts and the shared expert (JAX `_moe_mix`): the
    picks through ops/moe (csrc/moe_ffn.cu on the card), with gpt-oss's
    per-expert biases and llama4's weight-before-FFN routing, times
    expert_weights_scale; then in f32 the always-on shared expert with its
    sigmoid gate (qwen2moe) and jetmoe's bias after the sum."""
    lead, E = h.shape[:-1], h.shape[-1]
    K = topi.shape[-1]
    wb = cfg.moe_weight_before_ffn
    y = moe_ffn(
        h.reshape(-1, E), topi.reshape(-1, K), topv.reshape(-1, K),
        lp["w_gate_exps"], lp["w_up_exps"], lp["w_down_exps"],
        act=moe_act(cfg), b_gate=None if wb else lp.get("b_gate_exps"),
        b_up=None if wb else lp.get("b_up_exps"),
        b_down=None if wb else lp.get("b_down_exps"), weight_before=wb,
        scale=cfg.expert_weights_scale).view(*lead, E)
    if "w_gate_shexp" in lp:
        hf = h.float()
        sg = torch.nn.functional.silu(_f32_mm(hf, lp["w_gate_shexp"]))
        sy = _f32_mm(sg * _f32_mm(hf, lp["w_up_shexp"]),
                     lp["w_down_shexp"])
        if "w_gate_inp_shexp" in lp:
            sy = sy * torch.sigmoid(_f32_mm(hf, lp["w_gate_inp_shexp"]))
        y = y + sy
    if "b_down" in lp:
        y = y + lp["b_down"].float()
    return y


def _ffn_block(h, lp, cfg: ModelConfig, dtype, lora=None):
    """JAX `_ffn_block`: the experts where the layer has a router, else an
    ungated up -> act -> down (falcon, gptneox, phi2, starcoder2, gpt2) or
    the gated one, each with its optional biases and, under per-request
    LoRA (lora: the [S, n_ad] scale rows), each dense projection's delta;
    bitnet's sub norm before the down projection. The routed experts take
    no delta, as in JAX."""
    if "w_gate_inp" in lp:
        return _moe_ffn(h, lp, cfg).to(dtype)
    if not cfg.ffn_gated:
        up = _plus_lora(mm(h, lp["w_up"]), h, lp, "w_up", lora)
        if "b_up" in lp:
            up = up + lp["b_up"]
        if cfg.act_fn == "xielu" and "xielu" in lp:
            act = _xielu(up.float(), lp["xielu"]).to(dtype)
        else:
            act = _act(up.float(), cfg).to(dtype)
        out = _plus_lora(mm(act, lp["w_down"]), act, lp, "w_down", lora)
        if "b_down" in lp:
            out = out + lp["b_down"]
        return out.to(dtype)
    if "w_gateup" in lp:
        gu = mm(h, lp["w_gateup"])
        ff = gu.shape[-1] // 2
        gate, up = gu[..., :ff], gu[..., ff:]
    else:
        gate, up = mm(h, lp["w_gate"]), mm(h, lp["w_up"])
    gate = _plus_lora(gate, h, lp, "w_gate", lora)
    up = _plus_lora(up, h, lp, "w_up", lora)
    if "b_gate" in lp:          # jais biased SwiGLU
        gate = gate + lp["b_gate"]
    if "b_up" in lp:
        up = up + lp["b_up"]
    act = (_act(gate.float(), cfg) * up.float()).to(dtype)
    if "ffn_sub_norm" in lp:    # bitnet: a norm before the down projection
        act = _norm_any(act, lp["ffn_sub_norm"], None, cfg)
    out = _plus_lora(mm(act, lp["w_down"]), act, lp, "w_down", lora)
    if "b_down" in lp:
        out = out + lp["b_down"]
    return out.to(dtype)


# -- fused w8a8 decode kernels: the JAX package's gates ------------------------


def _fused_on() -> bool:
    """On by default in the port (the JAX package makes the fused kernels
    opt-in because of a cost of the TPU's compiler that the card does not
    have); LLAMA_BOX_TPU_NO_FUSED turns them off, as in JAX."""
    return not os.environ.get("LLAMA_BOX_TPU_NO_FUSED")


def _w8(w) -> bool:
    return isinstance(w, QTensor) and w.w8a8


def _n_rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1]


def _fuse_qkv_ok(cfg: ModelConfig, lp, x, lora=None) -> bool:
    """JAX `_fuse_qkv_ok`; like the tail's, false under per-request LoRA
    (scale rows present), whose deltas ride the unfused projections."""
    return (_fused_on() and _n_rows(x) <= _MAX_ROWS
            and x.dtype == torch.bfloat16
            and cfg.norm_style == "rms" and lora is None
            and "attn_norm" in lp and "attn_norm_b" not in lp
            and "bq" not in lp and _w8(lp.get("wqkv"))
            and _pick_tile(lp["wqkv"].out_dim) != 0)


def _fuse_tail_ok(cfg: ModelConfig, lp, x, lora=None) -> bool:
    return (_fused_on() and _n_rows(x) <= _MAX_ROWS
            and x.dtype == torch.bfloat16
            and cfg.norm_style == "rms" and lora is None
            and not cfg.parallel_residual and cfg.ffn_gated
            and cfg.act_fn in ("silu", "gelu", "relu2")
            and _w8(lp.get("wo")) and _w8(lp.get("w_gateup"))
            and _w8(lp.get("w_down"))
            and "ffn_norm" in lp and "ffn_norm_b" not in lp
            and "bo" not in lp and "b_down" not in lp
            and "b_gate" not in lp and "b_up" not in lp
            and "attn_post_norm" not in lp and "ffn_post_norm" not in lp
            and "w_gate_inp" not in lp and "wq_gate" not in lp
            and "attn_sub_norm" not in lp and "ffn_sub_norm" not in lp
            and _pick_tile(x.shape[-1], (256, 128)) != 0
            and _pick_tile(lp["w_down"].in_dim, (512, 256, 128)) != 0)


def _layer_tail(x, lp, cfg: ModelConfig, attn, lora=None, route=None,
                extra_residual=None):
    """The output projection and the FFN block with their residuals (JAX
    `_layer_tail` without an extra residual): bitnet's attention sub norm,
    jetmoe's expert output mix (route: the [B, T, X] routing mask; each
    expert's heads through its own output matrix, as one product over
    (expert, head) pairs), else the output projection and its LoRA delta,
    the output bias, the post norms (gemma, olmo2, grok), granite's
    residual scale, the parallel residual (falcon, gptneox, phi2,
    command-r) whose FFN input is attn_norm_2, ffn_norm or the shared
    attention-input norm, and arctic's parallel dense and expert
    branches. Of the recurrent hybrids: qwen3-next's output gate (wq_gate:
    the attention output times sigmoid of the gate's projection of the
    layer's normed input), falcon-h1's parallel mixer (extra_residual: its
    output joins the attention residual, x + attn + mixer, then the FFN
    block) and nemotron_h's attention-only blocks (no FFN tensors: the
    block ends after the attention residual)."""
    if extra_residual is None and _fuse_tail_ok(cfg, lp, x, lora):
        # decode widths: the whole tail through ops/fused_decode
        B, T, E = x.shape
        out = fused_layer_tail(
            attn.to(torch.bfloat16).reshape(B * T, -1), x.reshape(B * T, E),
            lp["wo"].qs, lp["wo"].scales, lp["ffn_norm"],
            lp["w_gateup"].qs, lp["w_gateup"].scales, lp["w_down"].qs,
            lp["w_down"].scales, eps=cfg.rms_eps, rs=cfg.residual_scale,
            act_fn=cfg.act_fn)
        return out.reshape(B, T, E).to(x.dtype)
    ao = attn.to(x.dtype)
    if "attn_sub_norm" in lp:   # bitnet: a norm before the output proj
        ao = _norm_any(ao, lp["attn_sub_norm"], None, cfg)
    if "wq_gate" in lp:
        hg = _pre_norm(x, lp, "attn_norm", cfg)
        ao = ao * torch.sigmoid(mm(hg, lp["wq_gate"])).to(x.dtype)
    if route is not None:
        B, T, HD = ao.shape
        Xe = lp["wo_exps"].shape[0]
        Dv = HD // (Xe * cfg.n_kv_heads)
        a4 = ao.view(B, T, cfg.n_kv_heads, Xe, Dv).transpose(2, 3) \
            * route[:, :, :, None, None].to(ao.dtype)
        attn_out = dense_matmul(a4.reshape(B, T, HD),
                                lp["wo_exps"].reshape(HD, -1)).to(x.dtype)
    else:
        attn_out = _plus_lora(mm(ao, lp["wo"]), ao, lp, "wo",
                              lora).to(x.dtype)
    if "bo" in lp:
        attn_out = attn_out + lp["bo"].to(x.dtype)
    if "attn_post_norm" in lp:
        attn_out = _norm_any(attn_out, lp["attn_post_norm"],
                             lp.get("attn_post_norm_b"), cfg)
    rs = cfg.residual_scale
    if extra_residual is not None:
        # the JAX package divides by rs so that x + attn_out * rs below
        # adds the mixer unscaled (falcon-h1's rs is 1)
        e = extra_residual.to(x.dtype)
        attn_out = attn_out + (e if rs == 1.0 else e / _weak(rs, e.dtype))
    if cfg.parallel_residual:
        if "attn_norm_2" in lp:
            h = _norm_any(x, lp["attn_norm_2"], lp.get("attn_norm_2_b"), cfg)
        elif "ffn_norm" in lp:
            h = _pre_norm(x, lp, "ffn_norm", cfg)
        else:
            h = _pre_norm(x, lp, "attn_norm", cfg)
        ffn_out = _ffn_block(h, lp, cfg, x.dtype, lora)
        if "ffn_post_norm" in lp:
            ffn_out = _norm_any(ffn_out, lp["ffn_post_norm"],
                                lp.get("ffn_post_norm_b"), cfg)
        return x + _scaled(attn_out + ffn_out, rs)
    x = x + _scaled(attn_out, rs)
    if "ffn_norm_exps" in lp:
        # arctic: the dense FFN and the experts in parallel off the
        # attention residual, each behind its own norm; b_down belongs to
        # the dense branch
        h = _pre_norm(x, lp, "ffn_norm", cfg)
        dense = _ffn_block(h, {k: v for k, v in lp.items()
                               if k != "w_gate_inp"}, cfg, x.dtype, lora)
        hm = _norm_any(x, lp["ffn_norm_exps"], None, cfg)
        moe = _moe_ffn(hm, {k: v for k, v in lp.items() if k != "b_down"},
                       cfg).to(x.dtype)
        return x + _scaled(dense + moe, rs)
    if not any(k in lp for k in ("w_up", "w_gate", "w_gate_inp",
                                 "w_gateup")):
        return x    # an attention-only block (nemotron_h)
    h = _pre_norm(x, lp, "ffn_norm", cfg)
    ffn_out = _ffn_block(h, lp, cfg, x.dtype, lora)
    if "ffn_post_norm" in lp:
        ffn_out = _norm_any(ffn_out, lp["ffn_post_norm"],
                            lp.get("ffn_post_norm_b"), cfg)
    return x + _scaled(ffn_out, rs)


class ChainRows(NamedTuple):
    """Rows of the current K-step decode chain as the attention reads them
    (K [L, B, K, Hkv, D], V [L, B, K, Hkv, Dv] in adt): row j is step j's
    K/V, in the cache dtype's values (dequantized for an int8 cache),
    except that the step being computed sees its own row at full
    precision."""
    k: torch.Tensor
    v: torch.Tensor


def init_chain_rows(cfg: ModelConfig, kv: KVCache, n_steps: int) -> ChainRows:
    L, B = kv.k.shape[0], kv.k.shape[1]
    lead = (L, B, n_steps, kv_heads(cfg))
    dt = attn_dtype(kv)
    return ChainRows(
        torch.zeros(lead + (cfg.head_dim,), dtype=dt, device=kv.k.device),
        torch.zeros(lead + (v_width(cfg),), dtype=dt, device=kv.k.device))


class RowWrites(NamedTuple):
    """Where a forward's new rows go: row (i, t) of slot b[i, t] lands at
    cache position p[i, t] if valid[i, t]; else the cache keeps its value
    there. [N, M] int64/bool device tensors whose (b, p) pairs are
    distinct."""
    b: torch.Tensor
    p: torch.Tensor
    valid: torch.Tensor


def _cache_rows(kv: KVCache, k, v):
    """A layer's new rows as the cache stores them: (k, v) in its dtype, or
    int8 codes with their bf16 scales (k, v, k_scale, v_scale), K and V
    each quantized over its own width."""
    if kv.quantized:
        kq, ksr = _kv_quantize(k.float())
        vq, vsr = _kv_quantize(v.float())
        return kq, vq, ksr, vsr
    return k.to(kv.k.dtype), v.to(kv.v.dtype)


def write_rows(kv: KVCache, fields: list, writes: RowWrites) -> None:
    """The one scatter of a forward: fields[f] holds field f of every
    layer's _cache_rows, [L, *writes.b.shape, Hkv(, D)]; each goes in one
    gather, select and put."""
    caches = (kv.k, kv.v, kv.k_scale, kv.v_scale) if kv.quantized \
        else (kv.k, kv.v)
    for cache, new in zip(caches, fields):
        old = cache[:, writes.b, writes.p]
        keep = writes.valid.view(1, *writes.valid.shape,
                                 *(1,) * (new.dim() - 3))
        cache[:, writes.b, writes.p] = torch.where(keep, new, old)


def _qk_norms(q, k, lp, cfg: ModelConfig):
    """The q/k norms before the rotation (JAX `_attn_layer`): chameleon's
    biased per-head LayerNorm, a per-head RMSNorm over rows of D (qwen3),
    or a whole-row RMSNorm over H * D (olmo2). q [B, T, H, D]."""
    if "q_norm_b" in lp:
        return (ln_per_head(q, lp["q_norm"], lp["q_norm_b"]),
                ln_per_head(k, lp["k_norm"], lp["k_norm_b"]))
    if lp["q_norm"].shape[-1] == q.shape[-1]:
        return (rms_norm(q, lp["q_norm"], cfg.rms_eps),
                rms_norm(k, lp["k_norm"], cfg.rms_eps))
    B, T = q.shape[:2]
    return (rms_norm(q.reshape(B, T, -1), lp["q_norm"],
                     cfg.rms_eps).reshape(q.shape),
            rms_norm(k.reshape(B, T, -1), lp["k_norm"],
                     cfg.rms_eps).reshape(k.shape))


def _mla_qkv(h, lp, cfg: ModelConfig):
    """Multi-head latent attention's projections (JAX `_mla_qkv`), h [B,
    T, E] -> per-head q, k [B, T, H, rope + nope] with the rope dims FIRST
    in each head (so the plain rotation and shift apply) and v [B, T, H,
    Dv]. q is wq_a -> q_a_norm -> wq_b, or plain wq without a q rank (GGUF
    stores a head as (nope, rope): reordered here); kv is wkv_a -> [c_kv |
    k_pe], then kv_a_norm(c_kv) @ wkv_b -> per head [k_nope | v]; k_pe is
    one shared rope stream, broadcast to every head."""
    B, T, _ = h.shape
    H, rope = cfg.n_heads, cfg.rope_dim
    nope = cfg.head_dim - rope
    if "wq_a" in lp:
        q = mm(rms_norm(mm(h, lp["wq_a"]), lp["q_a_norm"], cfg.rms_eps),
               lp["wq_b"])
    else:
        q = mm(h, lp["wq"])
    q = q.reshape(B, T, H, nope + rope)
    q = torch.cat([q[..., nope:], q[..., :nope]], dim=-1)
    c = mm(h, lp["wkv_a"])                          # [B, T, kv_lora + rope]
    c_kv = rms_norm(c[..., :cfg.kv_lora_rank], lp["kv_a_norm"], cfg.rms_eps)
    k_pe = c[..., cfg.kv_lora_rank:]
    kv = mm(c_kv, lp["wkv_b"]).reshape(B, T, H, nope + v_width(cfg))
    k = torch.cat([k_pe[:, :, None, :].expand(B, T, H, rope),
                   kv[..., :nope]], dim=-1)
    return q, k, kv[..., nope:]


def _attn_layer(x, lp, li: int, kv: KVCache, cfg: ModelConfig, cos, sin,
                rows: list, win, alibi=None, flash_meta=None, chain=None,
                step=0, decode_meta=None, verify_meta=None,
                dense_mask=None, positions=None, is_local: int = 0,
                lora=None, extra_residual=None):
    """x [B, T, E] -> x after attention and the layer tail (whose
    extra_residual, falcon-h1's parallel mixer output, _layer_tail adds). cos/sin are the
    tables gathered at the rows' positions ([B, T, rot/2]). The input norm
    (absent: olmo2), the q/k/v projections with their per-request LoRA
    deltas (lora: the [S, n_ad] scale rows, or None), the q/k/v biases,
    olmo's clamp and the q/k norms (before the rotation, or after it for
    hunyuan) as in JAX `_attn_layer`; after the rotation llama4's
    weightless q/k L2 norm and, on its global (unroped) layers, its query
    temperature from the rows' `positions` [B, T]. MLA layers (wkv_a)
    take _mla_qkv's per-head q, k, v, H heads of K and V; jetmoe's
    mixture-of-attention layers (wq_exps) _moa_qkv's every expert's query
    heads and the router's mask for the output mix; neither takes a q/k/v
    delta, as in JAX."""
    B, T, E = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    route = None
    if "wkv_a" in lp:
        q, k, v = _mla_qkv(_pre_norm(x, lp, "attn_norm", cfg), lp, cfg)
    elif "wq_exps" in lp:
        h = _pre_norm(x, lp, "attn_norm", cfg)
        route = _moa_route(h, lp, cfg)
        q, k, v = _moa_qkv(h, lp, cfg)
    elif "wqkv" in lp:
        if _fuse_qkv_ok(cfg, lp, x, lora):
            # decode widths: norm + act-quantize fused into the matmul
            qkv = fused_norm_qmm(x.reshape(B * T, E), lp["attn_norm"],
                                 lp["wqkv"].qs, lp["wqkv"].scales,
                                 eps=cfg.rms_eps)
            qkv = qkv.reshape(B, T, -1).to(x.dtype)
            h = None    # no delta: the gate is off under LoRA
        else:
            h = _pre_norm(x, lp, "attn_norm", cfg)
            qkv = mm(h, lp["wqkv"])
        nq, nk = H * D, Hkv * D
        q, k, v = qkv[..., :nq], qkv[..., nq:nq + nk], qkv[..., nq + nk:]
    else:
        h = _pre_norm(x, lp, "attn_norm", cfg)
        q, k, v = mm(h, lp["wq"]), mm(h, lp["wk"]), mm(h, lp["wv"])
    if "wkv_a" not in lp and "wq_exps" not in lp:
        if h is not None:
            q = _plus_lora(q, h, lp, "wq", lora)
            k = _plus_lora(k, h, lp, "wk", lora)
            v = _plus_lora(v, h, lp, "wv", lora)
        if "bq" in lp:          # qwen2-style attention biases
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        if cfg.attn_clamp > 0.0:    # olmo clip_qkv
            c = cfg.attn_clamp
            q, k, v = (t.clamp(-c, c) for t in (q, k, v))
        q = q.reshape(B, T, H, D)
        k = k.reshape(B, T, Hkv, D)
        v = v.reshape(B, T, Hkv, D)
        if "q_norm" in lp and not cfg.qk_norm_post_rope:
            q, k = _qk_norms(q, k, lp, cfg)
    q = apply_rope(q, None, cos, sin, cfg.rope_mode)
    k = apply_rope(k, None, cos, sin, cfg.rope_mode)
    if cfg.qk_norm_post_rope and "q_norm" in lp:
        # hunyuan: per-head q/k RMSNorm after the rotation; the cache keeps
        # the normed keys
        q = rms_norm(q, lp["q_norm"], cfg.rms_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_eps)
    if cfg.qk_l2_norm:
        q = q * torch.rsqrt(q.float().square().sum(-1, keepdim=True)
                            + 1e-6).to(q.dtype)
        k = k * torch.rsqrt(k.float().square().sum(-1, keepdim=True)
                            + 1e-6).to(k.dtype)
    if cfg.attn_temp_scale > 0.0 and not is_local:
        # q *= 1 + scale x log1p(floor((pos + 1) / floor_scale)); a rope
        # layer's factor is 1 in JAX, which changes no bit
        pf = torch.floor((positions.float() + 1.0) / cfg.attn_temp_floor)
        f = 1.0 + cfg.attn_temp_scale * torch.log1p(pf)
        q = q * f[:, :, None, None].to(q.dtype)
    return _attn_deferred(x, lp, li, kv, cfg, q, k, v, rows, win, alibi,
                          flash_meta=flash_meta, chain=chain, step=step,
                          decode_meta=decode_meta, verify_meta=verify_meta,
                          dense_mask=dense_mask, lora=lora, route=route,
                          extra_residual=extra_residual)


def _attn_verify(q, k, v, kc, vc, ks, vs, stored, meta, win, adt, scale,
                 softcap=0.0, alibi=None, sinks=None):
    """The T query rows of a verify forward, each through the flash decode
    kernel with the verify rows as its chain operand: query j has meta
    (pos0 + j, j + 1), so it attends the cache below pos0 and rows 0..j,
    the rows before it as the cache holds them (dequantized for an int8
    cache) and its own at full precision, as step j of a decode chain
    does. q [B, T, H, D] -> [B, T, H*Dv] in adt."""
    B, T, H, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    kf, vf = k.to(adt).contiguous(), v.to(adt).contiguous()
    if ks is not None:
        kq, vq, ksr, vsr = stored
        kd = (kq.float() * ksr.float()[..., None]).to(adt)
        vd = (vq.float() * vsr.float()[..., None]).to(adt)
    outs = []
    for j in range(T):
        kr, vr = kf, vf
        if ks is not None and j > 0:
            kr = torch.cat([kd[:, :j], kf[:, j:]], dim=1)
            vr = torch.cat([vd[:, :j], vf[:, j:]], dim=1)
        qd = q[:, j].to(adt).reshape(B, Hkv, H // Hkv, D).contiguous()
        o = flash_decode(qd, kc, vc, kr, vr, meta[j], win, k_scale=ks,
                         v_scale=vs, sinks=sinks, scale=scale,
                         softcap=softcap, alibi=alibi)
        outs.append(o.to(adt).reshape(B, H * Dv))
    return torch.stack(outs, dim=1)


def _attn_deferred(x, lp, li: int, kv: KVCache, cfg: ModelConfig, q, k, v,
                   rows: list, win, alibi=None, flash_meta=None, chain=None,
                   step=0, decode_meta=None, verify_meta=None,
                   dense_mask=None, lora=None, route=None,
                   extra_residual=None):
    """Attention against the cache as it stood before this forward plus
    the new rows (through the flash kernels), then the layer tail (with
    `lora` and `route` as _layer_tail takes them). The
    layer's rows, as the cache stores them, are appended to `rows` for the
    forward's one scatter (write_rows). dense_mask [B, T, T]: the rows
    (at positions 0..T-1) attend only each other under that mask, written
    out in torch (softmax_attend; the non-causal embeddings forward). win
    is the layer's (window, chunk) row, alibi the [Hkv, G] slopes or
    None; the softcap is cfg's, gpt-oss's sink logits the layer's."""
    B, T = q.shape[:2]
    H, Hkv, D, Dv = q.shape[2], k.shape[2], q.shape[-1], v.shape[-1]
    G = H // Hkv
    adt = attn_dtype(kv)
    kc, vc = kv.k[li], kv.v[li]
    ks = kv.k_scale[li] if kv.quantized else None
    vs = kv.v_scale[li] if kv.quantized else None
    stored = _cache_rows(kv, k, v)
    rows.append(stored)
    scale = cfg.attn_scale or None
    cap = cfg.attn_softcap
    snk = lp["sinks"].float().reshape(Hkv, G) if "sinks" in lp else None

    if dense_mask is not None:
        qg = q.to(adt).reshape(B, T, Hkv, G, D).permute(0, 2, 3, 1, 4)
        t = torch.arange(T, device=q.device)
        dist = (t[None, :] - t[:, None]).expand(B, T, T)
        o = softmax_attend(qg, k.to(adt), v.to(adt), dense_mask,
                           D ** -0.5 if scale is None else scale, cap,
                           sinks=snk, alibi=alibi, dist=dist)
        attn = o.permute(0, 3, 1, 2, 4).reshape(B, T, H * Dv)
    elif flash_meta is not None:
        qg = q.to(adt).reshape(B, T, Hkv, G, D).permute(0, 2, 3, 1, 4)
        o = flash_prefill_batched(qg.contiguous(), kc, vc, k.to(adt),
                                  v.to(adt), flash_meta, win,
                                  k_scale=ks, v_scale=vs, sinks=snk,
                                  scale=scale, softcap=cap, alibi=alibi)
        attn = o.permute(0, 3, 1, 2, 4).reshape(B, T, H * Dv)
    elif verify_meta is not None:
        attn = _attn_verify(q, k, v, kc, vc, ks, vs, stored, verify_meta,
                            win, adt, scale, cap, alibi, snk)
    else:
        # chained decode: the current row rides chain index `step`
        kr, vr = chain.k[li], chain.v[li]
        kr[:, step] = k[:, 0].to(adt)
        vr[:, step] = v[:, 0].to(adt)
        qd = q.to(adt).reshape(B, Hkv, G, D).contiguous()
        o = flash_decode(qd, kc, vc, kr, vr, decode_meta, win,
                         k_scale=ks, v_scale=vs, sinks=snk, scale=scale,
                         softcap=cap, alibi=alibi)
        attn = o.to(adt).reshape(B, 1, H * Dv)
        if kv.quantized:
            # later steps read this row as the cache holds it
            kq, vq, ksr, vsr = stored
            kr[:, step] = (kq[:, 0].float() * ksr[:, 0].float()[..., None]
                           ).to(adt)
            vr[:, step] = (vq[:, 0].float() * vsr[:, 0].float()[..., None]
                           ).to(adt)
    return _layer_tail(x, lp, cfg, attn, lora, route, extra_residual)


def layer_params(params) -> list[dict]:
    """Each layer's parameters, in layer order, over the layer groups."""
    out = []
    for gp in layer_groups(params):
        cols = {k: v.unbind(0) for k, v in gp.items()}
        n = len(next(iter(cols.values()))) if cols else 0
        out.extend({k: v[j] for k, v in cols.items()} for j in range(n))
    return out


def _run_stack(params, cfg: ModelConfig, x, kv: KVCache, cos, sin,
               rows: list, positions, flash_meta=None, chain=None, step=0,
               decode_meta=None, verify_meta=None, dense_mask=None,
               windows=None):
    """The layer loop (the JAX package's lax.scan, one a layer group);
    appends each layer's rows to `rows`. cos/sin are gathered at the rows'
    `positions` [B, T], [B, T, half] or stacked [2, B, T, half] (layer li
    takes branch is_local); layer li attends under row li of `windows`
    ([L, 2], layer_windows by default) or the one [2] row given. The
    per-request LoRA scale rows (params["lora_scales"], [S, n_ad]) reach
    every projection's delta; a control vector (params["cvec"], [L, E])
    adds its row li, cast to the activations' dtype, to the residual
    stream after layer li (the reference's llama_apply_adapter_cvec)."""
    win = layer_windows(cfg, x.device) if windows is None else windows
    alibi = alibi_slopes(cfg, x.device)
    loc = layer_is_local(cfg)
    lora, cvec = params.get("lora_scales"), params.get("cvec")
    stacked = cos.dim() == 4
    for li, lp in enumerate(layer_params(params)):
        c, s = (cos[loc[li]], sin[loc[li]]) if stacked else (cos, sin)
        x = _attn_layer(x, lp, li, kv, cfg, c, s, rows,
                        win[li] if win.dim() == 2 else win, alibi,
                        flash_meta=flash_meta, chain=chain, step=step,
                        decode_meta=decode_meta, verify_meta=verify_meta,
                        dense_mask=dense_mask, positions=positions,
                        is_local=loc[li], lora=lora)
        if cvec is not None:
            x = x + cvec[li].to(x.dtype)
    return x


def _output_logits(params, cfg: ModelConfig, x):
    """The output norm and projection (JAX `_output_logits`): the fused
    w8a8 kernel at decode widths when the norm is an unbiased RMSNorm and
    the projection has no bias, else the norm (biased LayerNorm for the LN
    families), the projection or tied embeddings and phi2's output bias;
    then command-r / granite's logit scale and the final softcap."""
    out_w = params.get("output")
    R = _n_rows(x)
    if (_fused_on() and _w8(out_w) and R <= _MAX_ROWS
            and x.dtype == torch.bfloat16 and cfg.norm_style == "rms"
            and "output_norm_b" not in params
            and params.get("output_b") is None
            and _pick_tile(out_w.out_dim) != 0):
        logits = fused_norm_qmm(x.reshape(R, x.shape[-1]),
                                params["output_norm"], out_w.qs,
                                out_w.scales, eps=cfg.rms_eps)
        logits = logits.reshape(*x.shape[:-1], out_w.out_dim)
    else:
        x = _norm_any(x, params["output_norm"], params.get("output_norm_b"),
                      cfg)
        if out_w is None:   # tied word embeddings
            logits = dense_matmul(x, params["tok_embd"].T)
        else:
            logits = mm(x, out_w)
        if params.get("output_b") is not None:
            logits = logits + params["output_b"]
    logits = _scaled(logits, cfg.logit_scale)
    if cfg.logit_softcap > 0.0:
        c = cfg.logit_softcap
        logits = _scaled(torch.tanh(logits / _weak(c, logits.dtype)), c)
    return logits.float()


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor):
    """Token rows, times embd_scale (granite, minicpm), then bloom's
    embedding LayerNorm (JAX `_embed_tokens`)."""
    emb = params["tok_embd"]
    x = _scaled(emb[tokens.long().clamp(0, emb.shape[0] - 1)],
                cfg.embd_scale)
    if "tok_embd_norm" in params:
        x = _norm_any(x, params["tok_embd_norm"],
                      params.get("tok_embd_norm_b"), cfg)
    return x


def _add_pos_embd(params, x, positions: torch.Tensor):
    """Learned absolute positions (gpt2; JAX `_add_pos_embd`): a sentinel
    position clips to the table's last row, whose row is never kept."""
    pe = params.get("pos_embd")
    if pe is None:
        return x
    return x + pe[positions.clamp(0, pe.shape[0] - 1)].to(x.dtype)


def _rope_at(cos, sin, positions: torch.Tensor):
    """Tables gathered at positions (sentinels clamp to the end): [P, half]
    tables give [*positions.shape, half], stacked [2, P, half] ones [2,
    *positions.shape, half]."""
    p = positions.clamp(0, cos.shape[-2] - 1)
    return cos[..., p, :], sin[..., p, :]


# per-device constant operands of the attention kernels, made at their
# first, eager, use (never inside a CUDA graph capture) and kept: the
# graphs point into them
_CONSTANTS: dict[tuple, torch.Tensor] = {}


def _constant(device, key: tuple, make, what: str) -> torch.Tensor:
    dev = torch.device(device)
    t = _CONSTANTS.get((dev, key))
    if t is None:
        _kernels.no_capture(dev, what)
        t = _CONSTANTS[(dev, key)] = make().to(dev)
    return t


def _no_window(device) -> torch.Tensor:
    """An all-zero (swa_window, chunked_window) operand, one buffer per
    device: the embeddings forward's, whose JAX counterpart attends under
    its own mask, with no window."""
    return _constant(device, ("no_window",),
                     lambda: torch.zeros(2, dtype=torch.int32),
                     "the window operand")


def layer_windows(cfg: ModelConfig, device) -> torch.Tensor:
    """[L, 2] int32: row li is layer li's (swa_window, chunked_window)
    kernel operand, as JAX `_attn_deferred` forms it: the window where the
    layer is local under a pattern, everywhere without one, else 0; the
    chunk (llama4) where the layer is local, else 0. One buffer a device
    and set of rows."""
    rows = tuple((cfg.swa_window if loc or cfg.swa_pattern <= 0 else 0,
                  cfg.chunked_window if loc else 0)
                 for loc in layer_is_local(cfg))
    return _constant(device, ("windows", rows),
                     lambda: torch.tensor(rows, dtype=torch.int32).view(-1, 2),
                     "the window operand")


def alibi_values(H: int, max_bias: float) -> list[float]:
    """The ALiBi slopes of H heads (JAX `_alibi_slopes`: ggml soft_max_ext
    with f_max_alibi_bias; 2^(-8i/H) for a power-of-two head count)."""
    n = 2 ** int(math.floor(math.log2(H)))
    m0 = 2.0 ** (-max_bias / n)
    m1 = 2.0 ** (-max_bias / 2.0 / n)
    return [m0 ** (i + 1) if i < n else m1 ** (2 * (i - n) + 1)
            for i in range(H)]


def alibi_slopes(cfg: ModelConfig, device) -> torch.Tensor | None:
    """[Hkv, G] f32 ALiBi slopes, one buffer a device, or None without
    ALiBi."""
    if cfg.alibi_max_bias <= 0.0:
        return None
    vals = tuple(alibi_values(cfg.n_heads, cfg.alibi_max_bias))
    G = cfg.n_heads // max(1, cfg.n_kv_heads)
    return _constant(device, ("alibi", vals, G),
                     lambda: torch.tensor(vals, dtype=torch.float32)
                     .view(-1, G), "the ALiBi slopes")


class DecodeOperands(NamedTuple):
    """Device operands of a K-step chain, all computed from pos0 and
    active [S]: step j's positions [K, S] (>= C marks an inactive slot),
    flash decode meta [K, S, 2] (cpos, nv = j + 1), the rope tables
    gathered at the positions ([K, S, 1, rot/2], stacked tables [K, 2, S,
    1, rot/2]) and the chain's row writes ([K, S])."""
    positions: torch.Tensor
    meta: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    writes: RowWrites


def decode_operands(pos0: torch.Tensor, active: torch.Tensor, capacity: int,
                    n_steps: int, rope_cos, rope_sin,
                    rope_delta=None) -> DecodeOperands:
    """The operands of n_steps chained steps from each slot's first
    position pos0 [S] (int64) and its active mask [S] (bool), as the JAX
    scan body computes them: positions where(active, pos0 + j, C), meta
    (cpos, j + 1) with cpos 0 for an inactive slot. Step j of slot b
    writes position (pos0[b] + j) mod C, kept only if active and inside
    the cache. rope_delta [S] (M-RoPE's mrope_delta, or None): the rows
    rotate at position + delta, every stream alike, as JAX passes
    mrope_pos = positions + delta to its decode programs."""
    C = capacity
    j = torch.arange(n_steps, device=pos0.device)
    pos = pos0[None, :] + j[:, None]                           # [K, S]
    live = active[None, :] & (pos < C)
    positions = torch.where(active[None, :], pos, C)
    cpos = torch.where(positions >= C, 0, positions)
    meta = torch.stack([cpos, (j + 1)[:, None].expand_as(cpos)],
                       dim=-1).to(torch.int32)
    rpos = positions if rope_delta is None else positions + rope_delta
    cos, sin = _rope_at(rope_cos, rope_sin, rpos[..., None])
    if rope_cos.dim() == 3:     # stacked: step j's [2, S, 1, rot/2]
        cos, sin = cos.movedim(0, 1), sin.movedim(0, 1)
    b = torch.arange(pos0.shape[0], device=pos0.device)
    writes = RowWrites(b[None, :].expand_as(pos), pos % C, live)
    return DecodeOperands(positions, meta, cos, sin, writes)


def decode_step_impl(params, cfg: ModelConfig, tokens, ops: DecodeOperands,
                     kv: KVCache, chain: ChainRows, step: int, rows: list):
    """Step `step` of a decode chain through the flash decode kernel; the
    step's rows are appended to `rows` (one entry per layer), for the
    chain's write_rows. Returns logits [B, 1, V] f32."""
    x = _add_pos_embd(params, _embed_tokens(params, cfg, tokens),
                      ops.positions[step][:, None])
    x = _run_stack(params, cfg, x, kv, ops.cos[step], ops.sin[step], rows,
                   ops.positions[step][:, None], chain=chain, step=step,
                   decode_meta=ops.meta[step])
    return _output_logits(params, cfg, x)


def write_chain_rows(kv: KVCache, steps: list, writes: RowWrites) -> None:
    """Write a chain's rows: steps[j][l] is layer l's _cache_rows at step
    j ([S, 1, ...] each field); one stack a field gives [L, K, S, ...]."""
    K, L = len(steps), len(steps[0])
    fields = []
    for f in range(len(steps[0][0])):
        st = torch.stack([steps[j][li][f][:, 0] for li in range(L)
                          for j in range(K)])
        fields.append(st.view(L, K, *st.shape[1:]))
    write_rows(kv, fields, writes)


class VerifyOperands(NamedTuple):
    """Device operands of a T-row verify forward, all computed from pos0,
    n_draft and active [S]: the rows' positions [S, T] (C for a sentinel
    row), flash decode meta [T, S, 2] (query j: cpos = pos0 + j, nv = j +
    1; cpos 0 for a sentinel row), the rope tables gathered at the
    positions ([S, T, rot/2], stacked [2, S, T, rot/2]) and the row writes
    ([S, T])."""
    positions: torch.Tensor
    meta: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    writes: RowWrites


def verify_operands(pos0: torch.Tensor, n_draft: torch.Tensor,
                    active: torch.Tensor, capacity: int, T: int, rope_cos,
                    rope_sin, rope_delta=None) -> VerifyOperands:
    """The operands of T verify rows from each slot's first position pos0
    [S] (int64), its draft count n_draft [S] and its active mask [S]: row
    j of slot b lies at pos0[b] + j and is kept iff the slot is active, j
    <= n_draft[b] and the position is inside the cache; every other row is
    a sentinel (position C), attended by nothing and never written (JAX
    `_decode_verify_rows`'s positions and seq_lens); rope_delta [S] as in
    decode_operands."""
    C = capacity
    S = pos0.shape[0]
    j = torch.arange(T, device=pos0.device)
    pos = pos0[:, None] + j[None, :]                            # [S, T]
    kept = active[:, None] & (j[None, :] <= n_draft[:, None])
    positions = torch.where(kept, pos, C)
    cpos = torch.where(positions >= C, 0, positions)
    meta = torch.stack([cpos.T, (j + 1)[:, None].expand(T, S)],
                       dim=-1).to(torch.int32)
    rpos = positions if rope_delta is None else \
        positions + rope_delta[:, None]
    cos, sin = _rope_at(rope_cos, rope_sin, rpos)
    b = torch.arange(S, device=pos0.device)[:, None].expand(S, T)
    writes = RowWrites(b, pos % C, kept & (pos < C))
    return VerifyOperands(positions, meta, cos, sin, writes)


def verify_forward(params, cfg: ModelConfig, tokens, ops: VerifyOperands,
                   kv: KVCache):
    """The verify forward (JAX `forward_rows_impl` + `apply_rows_impl`):
    tokens [S, T] (column 0 the accepted token, then the drafts) through
    the stack at once, every query row's attention through the flash
    decode kernel (_attn_verify), the kept rows written into the cache in
    place by one scatter. At T = 1 it is a one-step decode chain, bit for
    bit. Returns logits [S, T, V] f32."""
    x = _add_pos_embd(params, _embed_tokens(params, cfg, tokens),
                      ops.positions)
    rows: list = []
    x = _run_stack(params, cfg, x, kv, ops.cos, ops.sin, rows,
                   ops.positions, verify_meta=ops.meta)
    fields = [torch.stack([r[f] for r in rows]) for f in range(len(rows[0]))]
    write_rows(kv, fields, ops.writes)
    return _output_logits(params, cfg, x)


def forward_impl(params, cfg: ModelConfig, tokens, positions, kv: KVCache,
                 rope_cos, rope_sin):
    """One batched decode forward of T rows a slot (a verify forward).

    tokens:    [B, T] int
    positions: [B, T] int (host or device): row j of slot b at
               positions[b, 0] + j, or >= C (a sentinel: its row is neither
               attended nor kept); a slot's sentinels follow its live rows,
               and a slot whose first row is one is inactive
    The live rows are written into the cache in place. Returns
    (logits [B, T, V] f32, kv)."""
    dev = kv.k.device
    C = kv.capacity
    positions = torch.as_tensor(positions).to(dev, torch.int64)
    pos0 = positions[:, 0]
    n_draft = (positions < C).sum(dim=1) - 1
    ops = verify_operands(pos0, n_draft, pos0 < C, C, positions.shape[1],
                          rope_cos, rope_sin)
    return verify_forward(params, cfg, torch.as_tensor(tokens).to(dev), ops,
                          kv), kv


def prefill_batch_impl(params, cfg: ModelConfig, tokens, pos_base, n_valid,
                       kv: KVCache, rope_cos, rope_sin, logits: bool = True,
                       embeds=None, mrope_pos=None, bidir=None, slots=None):
    """Batched prefill: one chunk per slot through the flash prefill kernel.

    tokens:   [S, T] int — row s is slot s's next chunk (padded), T <= C
    pos_base: [S] int — absolute position of each row's start
    n_valid:  [S] int — valid tokens per row (0 = slot not prefilling)
    embeds:   [S, T, E] — a chunk of projected media rows in place of
              `tokens` (JAX `prefill_embed_impl`: cast to tok_embd's dtype,
              no embedding scale or norm); tokens is then None
    mrope_pos: [3, S, T] int — M-RoPE's (t, y, x) position streams of the
              rows (JAX `mrope_pos`); None rotates at the rows' positions
    bidir:    [S, 2] int — an (start, end) span of absolute positions that
              every valid row attends regardless of causality (gemma3's
              image; the kernel meta's bidir_st / bidir_en), else none
    slots:    [S] int — the cache slot each row reads and writes (the
              kernel meta's fifth column), else row s is slot s: one
              program, its slot an operand, prefills any slot alone; the
              rows take those slots' LoRA scale rows (JAX `_prefill_core`
              slices its slot's)
    Host arrays or tensors; on the cache's device every operand below is
    computed there, so the pass replays as one CUDA graph. The rows are
    written into the cache in place (write_rows). Returns
    (last-token logits [S, V] f32, or None when `logits` is false, kv)."""
    dev = kv.k.device
    pos_base = torch.as_tensor(pos_base).to(dev, torch.int64)
    n_valid = torch.as_tensor(n_valid).to(dev, torch.int64)
    if embeds is None:
        tokens = torch.as_tensor(tokens).to(dev)
        S, T = tokens.shape
    else:
        S, T = embeds.shape[:2]
    C = kv.capacity
    if T > C:
        raise ValueError(f"a prefill chunk of {T} rows does not fit a cache "
                         f"of {C} positions")
    t = torch.arange(T, device=dev)[None, :]
    pos = pos_base[:, None] + t                                 # [S, T]
    inside = t < n_valid[:, None]
    positions = torch.where(inside, pos, C)
    if bidir is None:
        st = en = torch.zeros_like(pos_base)
    else:
        st, en = torch.as_tensor(bidir).to(dev, torch.int64).unbind(1)
    cols = [pos_base, n_valid, st, en]
    if slots is not None:
        slots = torch.as_tensor(slots).to(dev, torch.int64)
        cols.append(slots)
        if params.get("lora_scales") is not None:
            params = dict(params, lora_scales=params["lora_scales"]
                          .index_select(0, slots))
    meta = torch.stack(cols, dim=1).to(torch.int32)
    if mrope_pos is not None:
        p3 = torch.as_tensor(mrope_pos).to(dev, torch.int64)
        cos, sin = mrope_at(rope_cos, rope_sin,
                            p3.clamp(0, rope_cos.shape[-2] - 1),
                            cfg.mrope_sections)
    else:
        cos, sin = _rope_at(rope_cos, rope_sin, positions)
    if embeds is None:
        x = _embed_tokens(params, cfg, tokens)
    else:
        x = embeds.to(dev, params["tok_embd"].dtype)
    x = _add_pos_embd(params, x, positions)
    rows: list = []
    x = _run_stack(params, cfg, x, kv, cos, sin, rows, positions,
                   flash_meta=meta)
    b = (torch.arange(S, device=dev) if slots is None else slots)
    b = b[:, None].expand(S, T)
    fields = [torch.stack([r[f] for r in rows]) for f in range(len(rows[0]))]
    write_rows(kv, fields, RowWrites(b, pos % C, inside & (pos < C)))
    if not logits:
        return None, kv
    last = (n_valid - 1).clamp_min(0)
    x_last = x[torch.arange(S, device=dev), last]
    return _output_logits(params, cfg, x_last), kv


def forward_embeddings(params, cfg: ModelConfig, tokens, seq_lens, rope_cos,
                       rope_sin, pooling: str = "mean") -> torch.Tensor:
    """The embedding forward (JAX `forward_embeddings`): tokens [B, T] and
    seq_lens [B] (host arrays or tensors; no KV cache kept) through the
    stack, output_norm as an RMSNorm whatever cfg.norm_style (the JAX
    function's own), then f32, pooled over each row's valid positions:
    "mean", "cls" or "last" give [B, E]; any other pooling returns every
    row, [B, T, E] (the JAX function's fall-through, which its engine's
    llama rerank reads).

    The JAX mask (valid query and key, and causal unless the file says
    `attention.causal` false) is what a prefill from position 0 attends,
    so a causal model runs the batched prefill's layer loop through the
    flash prefill kernel, on a scratch cache of B slots x T positions
    (pos_base 0, n_valid = seq_lens: the kernel reads none of it, and the
    rows are not written back) in the activations' dtype, as the JAX
    forward attends zeros of x's dtype; its projections take the weights'
    own kernels (ops/qmatmul.mm and the fused w8a8 gates). A non-causal
    model attends under the dense [B, T, T] mask through
    ops/attention.softmax_attend, as JAX's `_run_stack` does without
    flash_meta. Rows are at positions 0..T-1, padding included. As in the
    JAX function, no layer attends under a sliding window (its mask is the
    causal one alone); the per-layer rope branches, the softcap and ALiBi
    apply."""
    emb = params["tok_embd"]
    dev = emb.device
    tokens = torch.as_tensor(tokens).to(dev)
    seq_lens = torch.as_tensor(seq_lens).to(dev, torch.int64)
    B, T = tokens.shape
    t = torch.arange(T, device=dev)
    # the JAX function's own embedding: the token rows and the learned
    # positions, without _embed_tokens' scale and norm (mirrored as it is)
    x = _add_pos_embd(params, emb[tokens.long().clamp(0, emb.shape[0] - 1)],
                      t[None, :].expand(B, T))
    valid = t[None, :] < seq_lens[:, None]                     # [B, T]
    pos = t[None, :].expand(B, T)
    cos, sin = _rope_at(rope_cos, rope_sin, pos)
    adt = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    # one zero layer serves every layer: nothing below position 0 is read
    zk, zv = (torch.zeros((1, B, T, kv_heads(cfg), w), dtype=adt,
                          device=dev).expand(cfg.n_layers, -1, -1, -1, -1)
              for w in (cfg.head_dim, v_width(cfg)))
    scratch = KVCache(zk, zv)
    rows: list = []
    if cfg.causal:
        zeros = torch.zeros_like(seq_lens)
        meta = torch.stack([zeros, seq_lens, zeros, zeros], dim=1).to(
            torch.int32)
        x = _run_stack(params, cfg, x, scratch, cos, sin, rows, pos,
                       flash_meta=meta, windows=_no_window(dev))
    else:
        mask = valid[:, :, None] & valid[:, None, :]
        x = _run_stack(params, cfg, x, scratch, cos, sin, rows, pos,
                       dense_mask=mask)
    x = rms_norm(x, params["output_norm"], cfg.rms_eps).float()
    if pooling == "mean":
        w = valid.float()
        return (x * w[:, :, None]).sum(1) / w.sum(1)[:, None].clamp_min(1.0)
    if pooling == "cls":
        return x[:, 0]
    if pooling == "last":
        idx = (seq_lens - 1).clamp_min(0)
        return x[torch.arange(B, device=dev), idx]
    return x
