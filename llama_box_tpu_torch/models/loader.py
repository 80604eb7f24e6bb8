"""GGUF -> torch parameter loading, llama path (counterpart of
llama_box_tpu/models/loader.py: load_model, deinterleave_rope,
fuse_projections).

GGUF 2D tensors arrive as numpy (out_features, in_features); the model
multiplies x @ W, so weights are transposed once here to (in, out). Layer
weights stack along a leading L axis. The param tree has the JAX
package's key names and layouts (`tok_embd`, `output_norm`, `output`,
`layers.wq` ... or the fused `layers.wqkv` / `layers.w_gateup`), so
`params_from_numpy` carries a JAX param tree across unchanged.

Two weight formats:
- dense (default): dequantize to bf16/f32 on the device.
- quantized=True: every block-quant 2D projection (and the output
  projection) is repacked (gguf/repack.py) and held as a QTensor in the
  residency ops/qmatmul.pack_repacked picks from the JAX package's
  switches: w8a8 by default (per-column int8 codes, f32 scales), or the
  grouped layout under LLAMA_BOX_TPU_PACKED4 / _Q4_INT8 / _Q4_F32SCALES
  (group codes, nibble-packed for 4-bit formats, per-group scales and
  mins). Tensors are packed one at a time: w8a8 on the device, the
  grouped layout on the host, moved to the device once per layer stack.
  token_embd, the norms and formats without a repacker stay dense, as in
  JAX.
Mixture-of-experts layers (the router, the expert stacks [X, E, FF] /
[X, FF, E], shared experts, gpt-oss's sinks and biases) load dense, as in
JAX. Multi-head latent attention's projections and norms (wq_a,
q_a_norm, wq_b, wkv_a, kv_a_norm, wkv_b: deepseek2, minicpm3) load dense
too: they are the JAX loader's optional keys, which never quantize (a
file without a q rank keeps its plain wq, which does). Consecutive layers
with the same tensor set stack as one group;
where the layers form several (leading dense layers, interleaved dense
and MoE layers), the tree holds `layer_groups`, a list of stacked groups,
in place of `layers`, as the JAX loader's does.
A layer key whose layers pack to different layouts (a llama.cpp Q4_K_M
gives Q6_K to some layers' attn_v and ffn_down) cannot be stacked: the
JAX loader's np.stack fails on it under the grouped residency, and this
loader refuses it by name. jetmoe's mixture of attention (q and output
experts, their router) loads dense, as the JAX loader's optional keys;
openelm's per-layer head counts and FFN widths are zero-padded to the
largest, as the JAX loader pads them (_pad_openelm; a quantized load
stays dense, with JAX's warning). The recurrent families' tensors load
as the JAX loader reads them (the mixers' projections quantizable, their
smalls dense; rwkv6's 3D time_mix_w2 swapped to [5, edim, E], rwkv7's 2D
one transposed), their layer groups by tensor set too (jamba's and the
other hybrids' attention, mixer and MoE layers, rwkv7's layer 0 without
its v LoRA). A GGUF that carries a tensor no ported path knows is refused,
never half-loaded.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..gguf.reader import GGUFFile
from ..gguf.repack import REPACKERS, repack
from ..ops.qmatmul import QTensor, pack_repacked
from ..utils.logging import SRV_INF, SRV_WRN
from .config import ModelConfig

# the quantizable per-layer projections (JAX `_LAYER_WEIGHTS`, the dense
# llama graph's part of it)
_LAYER_WEIGHTS = {
    "wq": ("blk.{i}.attn_q.weight", True),
    "wk": ("blk.{i}.attn_k.weight", True),
    "wv": ("blk.{i}.attn_v.weight", True),
    "wo": ("blk.{i}.attn_output.weight", True),
    "w_gate": ("blk.{i}.ffn_gate.weight", True),
    "w_up": ("blk.{i}.ffn_up.weight", True),
    "w_down": ("blk.{i}.ffn_down.weight", True),
    # the recurrent mixers' projections (models/mamba.py, models/rwkv.py):
    # mamba / mamba2 / DeltaNet (whose fused q|k|v|z rides ssm_in, with
    # its beta|alpha gates and the attention output gate), lfm2's short
    # conv, rwkv6/7's time and channel mix
    "ssm_in": ("blk.{i}.ssm_in.weight", True),
    "shortconv_in": ("blk.{i}.shortconv.in_proj.weight", True),
    "shortconv_out": ("blk.{i}.shortconv.out_proj.weight", True),
    "ssm_ba": ("blk.{i}.ssm_beta_alpha.weight", True),
    "wq_gate": ("blk.{i}.attn_gate.weight", True),
    "ssm_x": ("blk.{i}.ssm_x.weight", True),
    "ssm_dt": ("blk.{i}.ssm_dt.weight", True),
    "ssm_out": ("blk.{i}.ssm_out.weight", True),
    "tm_k": ("blk.{i}.time_mix_key.weight", True),
    "tm_v": ("blk.{i}.time_mix_value.weight", True),
    "tm_r": ("blk.{i}.time_mix_receptance.weight", True),
    "tm_g": ("blk.{i}.time_mix_gate.weight", True),
    "tm_o": ("blk.{i}.time_mix_output.weight", True),
    "cm_k": ("blk.{i}.channel_mix_key.weight", True),
    "cm_r": ("blk.{i}.channel_mix_receptance.weight", True),
    "cm_v": ("blk.{i}.channel_mix_value.weight", True),
}
# optional per-layer tensors, always dense (JAX `_LAYER_OPTIONAL`, the part
# the dense variants read): norms (absent attn_norm: olmo2's post-norm-only
# blocks) and their biases, falcon-40b's second input norm, the projection
# biases, q/k norms (per head, whole row, or chameleon's biased per-head
# LayerNorm), gemma/olmo2 post norms and bitnet's sub norms
_LAYER_OPTIONAL = {
    "attn_norm": ("blk.{i}.attn_norm.weight", False),
    "attn_norm_b": ("blk.{i}.attn_norm.bias", False),
    "attn_norm_2": ("blk.{i}.attn_norm_2.weight", False),
    "attn_norm_2_b": ("blk.{i}.attn_norm_2.bias", False),
    "ffn_norm": ("blk.{i}.ffn_norm.weight", False),
    "ffn_norm_b": ("blk.{i}.ffn_norm.bias", False),
    "attn_post_norm_b": ("blk.{i}.post_attention_norm.bias", False),
    "ffn_post_norm_b": ("blk.{i}.post_ffw_norm.bias", False),
    "bo": ("blk.{i}.attn_output.bias", False),
    "b_gate": ("blk.{i}.ffn_gate.bias", False),
    "b_up": ("blk.{i}.ffn_up.bias", False),
    "b_down": ("blk.{i}.ffn_down.bias", False),
    "bq": ("blk.{i}.attn_q.bias", False),
    "bk": ("blk.{i}.attn_k.bias", False),
    "bv": ("blk.{i}.attn_v.bias", False),
    "q_norm": ("blk.{i}.attn_q_norm.weight", False),
    "k_norm": ("blk.{i}.attn_k_norm.weight", False),
    "attn_sub_norm": ("blk.{i}.attn_sub_norm.weight", False),
    "ffn_sub_norm": ("blk.{i}.ffn_sub_norm.weight", False),
    "q_norm_b": ("blk.{i}.attn_q_norm.bias", False),
    "k_norm_b": ("blk.{i}.attn_k_norm.bias", False),
    "attn_post_norm": ("blk.{i}.post_attention_norm.weight", False),
    "ffn_post_norm": ("blk.{i}.post_ffw_norm.weight", False),
    # dbrx's pre-MoE norm, or grok's post-attention sandwich norm (renamed
    # after load, as in JAX), and grok's post-MoE norm
    "attn_out_norm": ("blk.{i}.attn_output_norm.weight", False),
    "attn_out_norm_b": ("blk.{i}.attn_output_norm.bias", False),
    "layer_out_norm": ("blk.{i}.layer_output_norm.weight", False),
    # mixture of experts: the router [E, X], the expert stacks (stored (X,
    # FF, E) / (X, E, FF) -> [X, E, FF] / [X, FF, E] by the "3d" swap), the
    # shared expert and its sigmoid gate, gpt-oss's attention sinks and
    # router / expert biases, deepseek3's selection bias, arctic's MoE
    # pre-norm. Always dense, as in JAX (its optional keys never quantize)
    "w_gate_inp": ("blk.{i}.ffn_gate_inp.weight", True),
    "w_gate_exps": ("blk.{i}.ffn_gate_exps.weight", "3d"),
    "w_up_exps": ("blk.{i}.ffn_up_exps.weight", "3d"),
    "w_down_exps": ("blk.{i}.ffn_down_exps.weight", "3d"),
    "sinks": ("blk.{i}.attn_sinks.weight", False),
    "exp_probs_b": ("blk.{i}.exp_probs_b.bias", False),
    "ffn_norm_exps": ("blk.{i}.ffn_norm_exps.weight", False),
    "b_gate_inp": ("blk.{i}.ffn_gate_inp.bias", False),
    "b_gate_exps": ("blk.{i}.ffn_gate_exps.bias", False),
    "b_up_exps": ("blk.{i}.ffn_up_exps.bias", False),
    "b_down_exps": ("blk.{i}.ffn_down_exps.bias", False),
    "w_gate_shexp": ("blk.{i}.ffn_gate_shexp.weight", True),
    "w_up_shexp": ("blk.{i}.ffn_up_shexp.weight", True),
    "w_down_shexp": ("blk.{i}.ffn_down_shexp.weight", True),
    "w_gate_inp_shexp": ("blk.{i}.ffn_gate_inp_shexp.weight", True),
    # multi-head latent attention: the low-rank q (absent without a q
    # rank: plain wq) and kv projections and their norms
    "wq_a": ("blk.{i}.attn_q_a.weight", True),
    "q_a_norm": ("blk.{i}.attn_q_a_norm.weight", False),
    "wq_b": ("blk.{i}.attn_q_b.weight", True),
    "wkv_a": ("blk.{i}.attn_kv_a_mqa.weight", True),
    "kv_a_norm": ("blk.{i}.attn_kv_a_norm.weight", False),
    "wkv_b": ("blk.{i}.attn_kv_b.weight", True),
    # jetmoe's mixture of attention: the q and output projections as
    # experts ([X, E, Hkv * D] / [X, Hkv * D, E]) over the shared wk / wv,
    # and their router [E, X]
    "wq_exps": ("blk.{i}.attn_q_exps.weight", "3d"),
    "wo_exps": ("blk.{i}.attn_output_exps.weight", "3d"),
    "attn_gate_inp": ("blk.{i}.attn_gate_inp.weight", True),
    # the recurrent mixers' smalls, always dense: the mamba conv kernel,
    # its bias, dt's bias, A, D and mamba2's gated norm; jamba's learned
    # dt/B/C norms; lfm2's conv
    "ssm_conv_w": ("blk.{i}.ssm_conv1d.weight", False),
    "ssm_conv_b": ("blk.{i}.ssm_conv1d.bias", False),
    "ssm_dt_b": ("blk.{i}.ssm_dt.bias", False),
    "ssm_a": ("blk.{i}.ssm_a.weight", False),
    "ssm_d": ("blk.{i}.ssm_d.weight", False),
    "ssm_norm": ("blk.{i}.ssm_norm.weight", False),
    "shortconv_conv": ("blk.{i}.shortconv.conv.weight", False),
    "shortconv_conv_b": ("blk.{i}.shortconv.conv.bias", False),
    "ssm_dt_norm": ("blk.{i}.ssm_dt_norm.weight", False),
    "ssm_b_norm": ("blk.{i}.ssm_b_norm.weight", False),
    "ssm_c_norm": ("blk.{i}.ssm_c_norm.weight", False),
    # rwkv6's time-mix smalls: the data-dependent lerp LoRA (w1 [E, 5
    # edim]; w2 stored (5, E, edim) -> [5, edim, E] by the "3d" swap,
    # rwkv7's 2D one transposed), the decay LoRA, the bonus, the per-head
    # group norm; the channel-mix lerps
    "tm_w1": ("blk.{i}.time_mix_w1.weight", True),
    "tm_w2": ("blk.{i}.time_mix_w2.weight", "3d"),
    "tm_lerp_x": ("blk.{i}.time_mix_lerp_x.weight", False),
    "tm_lerp_w": ("blk.{i}.time_mix_lerp_w.weight", False),
    "tm_lerp_k": ("blk.{i}.time_mix_lerp_k.weight", False),
    "tm_lerp_v": ("blk.{i}.time_mix_lerp_v.weight", False),
    "tm_lerp_r": ("blk.{i}.time_mix_lerp_r.weight", False),
    "tm_lerp_g": ("blk.{i}.time_mix_lerp_g.weight", False),
    "tm_lerp_fused": ("blk.{i}.time_mix_lerp_fused.weight", False),
    "tm_first": ("blk.{i}.time_mix_first.weight", False),
    "tm_decay": ("blk.{i}.time_mix_decay.weight", False),
    "tm_decay_w1": ("blk.{i}.time_mix_decay_w1.weight", True),
    "tm_decay_w2": ("blk.{i}.time_mix_decay_w2.weight", True),
    "tm_ln": ("blk.{i}.time_mix_ln.weight", False),
    "tm_ln_b": ("blk.{i}.time_mix_ln.bias", False),
    "cm_lerp_k": ("blk.{i}.channel_mix_lerp_k.weight", False),
    "cm_lerp_r": ("blk.{i}.channel_mix_lerp_r.weight", False),
    # rwkv7's w0 / a0..a2 / v0..v2 / g1, g2 LoRAs and k_k / k_a / r_k gates
    # (layer 0 carries no v LoRA: its own layer group, as in JAX)
    "tm_w0": ("blk.{i}.time_mix_w0.weight", False),
    "tm_a0": ("blk.{i}.time_mix_a0.weight", False),
    "tm_a1": ("blk.{i}.time_mix_a1.weight", True),
    "tm_a2": ("blk.{i}.time_mix_a2.weight", True),
    "tm_v0": ("blk.{i}.time_mix_v0.weight", False),
    "tm_v1": ("blk.{i}.time_mix_v1.weight", True),
    "tm_v2": ("blk.{i}.time_mix_v2.weight", True),
    "tm_g1": ("blk.{i}.time_mix_g1.weight", True),
    "tm_g2": ("blk.{i}.time_mix_g2.weight", True),
    "tm_lerp_a": ("blk.{i}.time_mix_lerp_a.weight", False),
    "tm_kk": ("blk.{i}.time_mix_k_k.weight", False),
    "tm_ka": ("blk.{i}.time_mix_k_a.weight", False),
    "tm_rk": ("blk.{i}.time_mix_r_k.weight", False),
}
# fused tensors split at load (phi3/gptneox attn_qkv, phi3 gate|up ffn_up)
_LAYER_FUSED = ("blk.{i}.attn_qkv.weight", "blk.{i}.attn_qkv.bias")
_ROOT = ("token_embd.weight", "output_norm.weight", "output.weight",
         "position_embd.weight", "token_embd_norm.weight",
         "token_embd_norm.bias", "output_norm.bias", "output.bias",
         "rope_factors_long.weight", "rope_factors_short.weight")


def _torch_dtype_of(arr: np.ndarray) -> torch.Tensor:
    """numpy -> torch (copied: arrays handed over from JAX are read-only);
    numpy arrays of dtype bfloat16 (as JAX hands them over) are
    reinterpreted through their 16-bit pattern."""
    arr = np.array(arr, order="C", copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def dequant_q8_0(raw: np.ndarray, shape, device) -> torch.Tensor:
    """A Q8_0 payload (blocks of an f16 scale and 32 int8 codes) as f32
    on `device`, dequantized there by torch: the bytes cross to the card
    at about a quarter of the f32 size, and on the host torch's threads
    share the work. Each value is its code times its scale in f32, one
    rounding, the same bits as gguf/quants.dequantize_q8_0."""
    b = torch.from_numpy(np.array(raw, copy=True)).to(device).view(-1, 34)
    d = b[:, :2].contiguous().view(torch.float16).float()
    q = b[:, 2:].contiguous().view(torch.int8).float()
    n = int(np.prod(shape))
    return (q * d).reshape(-1)[:n].reshape(tuple(shape))


def _quantizable(info, shape) -> bool:
    if info.ggml_type not in REPACKERS or len(shape) != 2:
        return False
    out_dim, in_dim = shape
    return in_dim % 64 == 0 and out_dim % 64 == 0


def _layout(q: QTensor) -> tuple:
    return (q.w8a8, q.packed4, q.group, q.in_dim, q.mins is None,
            tuple(q.qs.shape), tuple(q.scales.shape), q.scales.dtype)


def _stack_qtensors(qts: list[QTensor], key: str,
                    formats: list[str]) -> QTensor:
    """Stack per-layer QTensors along a new leading axis. Raises
    ValueError, naming `key` and the GGUF `formats` found, when the layers
    differ in layout; nothing is padded or converted."""
    layouts = sorted({_layout(q) for q in qts}, key=str)
    if len(layouts) > 1:
        desc = "; ".join(f"packed4={p}, group={g}, mins={not nm}, qs{qs}"
                         for _, p, g, _, nm, qs, _, _ in layouts)
        raise ValueError(
            f"{key}: its layers pack to {len(layouts)} different quantized "
            f"layouts ({desc}) from GGUF formats {sorted(set(formats))}; "
            "a layer stack needs one layout per key (the JAX package's "
            "loader cannot stack them either)")
    return QTensor(
        qs=torch.stack([q.qs for q in qts]),
        scales=torch.stack([q.scales for q in qts]),
        mins=(torch.stack([q.mins for q in qts])
              if qts[0].mins is not None else None),
        in_dim=qts[0].in_dim, group=qts[0].group, packed4=qts[0].packed4,
        w8a8=qts[0].w8a8)


def parse_kv_overrides(specs: list[str]) -> dict:
    """--override-kv KEY=TYPE:VALUE (the reference's semantics: types
    int/float/bool/str); a copy of the JAX loader's."""
    out = {}
    for spec in specs or []:
        key, _, rest = spec.partition("=")
        typ, _, val = rest.partition(":")
        if not key or not typ or val == "":
            raise ValueError(f"bad --override-kv {spec!r} "
                             "(KEY=TYPE:VALUE)")
        if typ == "int":
            out[key] = int(val)
        elif typ == "float":
            out[key] = float(val)
        elif typ == "bool":
            out[key] = val.lower() in ("1", "true", "yes")
        elif typ == "str":
            out[key] = val
        else:
            raise ValueError(f"bad --override-kv type {typ!r}")
    return out


def load_model(path: str, dtype=torch.bfloat16, device="cuda",
               quantized: bool = False,
               metadata_overrides: dict | None = None
               ) -> tuple[ModelConfig, dict]:
    """Load a llama-graph GGUF into a stacked-layer param tree of `dtype`
    tensors on `device`; with `quantized`, the block-quant projections as
    QTensors (w8a8 or grouped: see the module docstring). The dense
    variants' tensors are read as the JAX loader reads them: the optional
    per-layer norms and biases (_LAYER_OPTIONAL), learned positions, the
    embedding norm, the output norm's and projection's biases, longrope
    factors (into cfg.extra), a fused attn_qkv (and its bias) or phi3's
    fused gate|up ffn_up split into their parts (dense, as in JAX), olmo's
    non-parametric norms as unit weights, apertus's xIELU parameters and
    the mixture-of-experts tensors (dense; dbrx's and grok's output norms
    renamed as in JAX), jetmoe's mixture-of-attention tensors (dense)
    and openelm's per-layer geometry (padded). Layers that differ in
    their tensors stack in `layer_groups`; any tensor outside these is
    refused."""
    dev = torch.device(device)
    with GGUFFile(path) as g:
        for k, v in (metadata_overrides or {}).items():
            SRV_INF("load_model", "override %s = %r", k, v)
            g.metadata[k] = v
        cfg = ModelConfig.from_gguf(g)
        SRV_INF("load_model", "arch=%s layers=%d embd=%d heads=%d/%d ff=%d "
                "vocab=%d dtype=%s quantized=%s device=%s", cfg.arch,
                cfg.n_layers, cfg.n_embd, cfg.n_heads, cfg.n_kv_heads,
                cfg.n_ff, cfg.vocab_size, dtype, quantized, dev)
        known = set(_ROOT) | {pat.format(i=i)
                              for pat, _ in (*_LAYER_WEIGHTS.values(),
                                             *_LAYER_OPTIONAL.values())
                              for i in range(cfg.n_layers)} \
            | {pat.format(i=i) for pat in _LAYER_FUSED
               for i in range(cfg.n_layers)}
        extra = sorted(set(g.tensors) - known)
        hc_arr = cfg.extra.get("head_count_arr")
        hckv_arr = cfg.extra.get("head_count_kv_arr")
        varheads = cfg.arch == "openelm" and (
            "head_count_arr" in cfg.extra or "n_ff_arr" in cfg.extra)
        if varheads and quantized:
            # per-layer geometry is padded to the largest after the load
            SRV_WRN("load_model", "openelm: variable per-layer geometry — "
                    "loading dense (padding precedes packing)")
            quantized = False
        if extra:
            raise NotImplementedError(
                f"{cfg.arch}: tensors outside the llama graph and the "
                f"recurrent families are not ported yet: {extra[:8]}")

        def fetch(name: str, transpose) -> torch.Tensor:
            info = g.tensors[name]
            if info.ggml_type == GGMLType.Q8_0:
                x = dequant_q8_0(g.tensor_raw(name), info.shape, dev)
            else:
                x = torch.from_numpy(np.ascontiguousarray(
                    g.tensor_f32(name)))
            if transpose == "3d" and x.dim() == 3:
                x = x.transpose(1, 2)        # (X, FF, E) -> (X, E, FF)
            elif transpose and x.dim() == 2:
                x = x.T
            return x.to(dev, dtype).contiguous()

        def fetch_maybe_q(name: str, transpose: bool):
            """A QTensor (w8a8 on the device, grouped on the host) or a
            dense device tensor."""
            info = g.tensors[name]
            if quantized and transpose and _quantizable(info, info.shape):
                rt = repack(info.ggml_type, g.tensor_raw(name),
                            info.n_elements)
                out_dim, in_dim = info.shape
                return pack_repacked(rt, (in_dim, out_dim), dev)
            return fetch(name, transpose)

        def stack(key: str, ws: list):
            if any(isinstance(w, QTensor) for w in ws):
                if not all(isinstance(w, QTensor) for w in ws):
                    raise ValueError(f"{key}: some layers are quantized "
                                     "QTensors and some dense")
                pattern = _LAYER_WEIGHTS[key][0]
                return _stack_qtensors(
                    ws, key, [g.tensors[pattern.format(i=i)].ggml_type.name
                              for i in range(len(ws))]).to(dev)
            return torch.stack(ws)

        # phi3 LongRoPE per-dim frequency factors (make_rope picks long or
        # short by the slot context against the original window)
        extra_cfg = dict(cfg.extra)
        for tname, key in (("rope_factors_long.weight", "rope_factors_long"),
                           ("rope_factors_short.weight",
                            "rope_factors_short")):
            if tname in g.tensors:
                extra_cfg[key] = tuple(
                    float(x) for x in g.tensor_f32(tname).reshape(-1))
        cfg = dataclasses.replace(cfg, extra=extra_cfg)

        params: dict = {"tok_embd": fetch("token_embd.weight", False)}
        for key, name in (("pos_embd", "position_embd.weight"),
                          ("tok_embd_norm", "token_embd_norm.weight"),
                          ("tok_embd_norm_b", "token_embd_norm.bias")):
            if name in g.tensors:
                params[key] = fetch(name, False)
        if "output_norm.weight" in g.tensors:
            params["output_norm"] = fetch("output_norm.weight", False)
        else:
            # olmo (v1): non-parametric LayerNorm; unit weights are exact
            params["output_norm"] = torch.ones(cfg.n_embd, dtype=dtype,
                                               device=dev)
        if "output_norm.bias" in g.tensors:
            params["output_norm_b"] = fetch("output_norm.bias", False)
        if "output.weight" in g.tensors:
            out_w = fetch_maybe_q("output.weight", True)
            params["output"] = (out_w.to(dev) if isinstance(out_w, QTensor)
                                else out_w)
        else:
            SRV_INF("load_model", "output.weight absent -> tied embeddings")
        if "output.bias" in g.tensors:        # phi2
            params["output_b"] = fetch("output.bias", False)

        def split_qkv(i: int) -> dict:
            """A fused attn_qkv (and its bias) -> wq/wk/wv (bq/bk/bv),
            dense, as the JAX loader splits it."""
            name = f"blk.{i}.attn_qkv.weight"
            if name not in g.tensors:
                return {}
            w = fetch(name, True)                     # [in, q + k + v]
            # openelm: the layer's own head counts
            qd = (hc_arr[i] if hc_arr else cfg.n_heads) * cfg.head_dim
            kvd = (hckv_arr[i] if hckv_arr else cfg.n_kv_heads) \
                * cfg.head_dim
            out = {"wq": w[:, :qd], "wk": w[:, qd:qd + kvd],
                   "wv": w[:, qd + kvd:qd + 2 * kvd]}
            bname = f"blk.{i}.attn_qkv.bias"
            if bname in g.tensors:
                b = fetch(bname, False)
                out.update(bq=b[:qd], bk=b[qd:qd + kvd],
                           bv=b[qd + kvd:qd + 2 * kvd])
            return out

        def split_gate_up(i: int) -> dict:
            """phi3's fused ffn_up ([E, 2 FF], gate columns first) ->
            w_gate/w_up, dense, as the JAX loader splits it."""
            name = f"blk.{i}.ffn_up.weight"
            if (name not in g.tensors or not cfg.ffn_gated or cfg.n_ff <= 0
                    or f"blk.{i}.ffn_gate.weight" in g.tensors
                    or g.tensors[name].shape[0] != 2 * cfg.n_ff):
                return {}
            w = fetch(name, True)
            return {"w_gate": w[:, :cfg.n_ff], "w_up": w[:, cfg.n_ff:]}

        per_layer: list[dict] = []
        for i in range(cfg.n_layers):
            # the split gate|up first (its ffn_up name is the fused
            # tensor's), then the GGUF's own tensors, then a split attn_qkv
            lp = split_gate_up(i)
            for key, (pattern, transpose) in _LAYER_WEIGHTS.items():
                name = pattern.format(i=i)
                if key not in lp and name in g.tensors:
                    lp[key] = fetch_maybe_q(name, transpose)
            for key, (pattern, transpose) in _LAYER_OPTIONAL.items():
                name = pattern.format(i=i)
                if name in g.tensors:
                    lp[key] = fetch(name, transpose)
            for key, w in split_qkv(i).items():
                lp.setdefault(key, w)
            per_layer.append(lp)
        # dbrx: attn_output_norm is the pre-FFN norm; grok: it is the
        # post-attention sandwich norm (ffn_norm exists there) and
        # layer_output_norm the post-MoE one (the JAX loader's renames)
        for lp in per_layer:
            if "attn_out_norm" in lp:
                key = "attn_post_norm" if "ffn_norm" in lp else "ffn_norm"
                lp[key] = lp.pop("attn_out_norm")
                if "attn_out_norm_b" in lp:
                    lp[key + "_b"] = lp.pop("attn_out_norm_b")
            if "layer_out_norm" in lp:
                lp["ffn_post_norm"] = lp.pop("layer_out_norm")
        if cfg.arch == "olmo":
            # olmo (v1): unit weights for the non-parametric LayerNorms
            ones = torch.ones(cfg.n_embd, dtype=dtype, device=dev)
            for lp in per_layer:
                lp.setdefault("attn_norm", ones)
                lp.setdefault("ffn_norm", ones)
        if varheads:
            per_layer, cfg = _pad_openelm(per_layer, cfg, hc_arr, hckv_arr)
        # apertus xIELU per-layer parameters ride metadata arrays (raw
        # learned values; the forward applies softplus)
        xap = g.metadata.get(f"{cfg.arch}.xielu.alpha_p")
        if xap is not None:
            xan = g.metadata.get(f"{cfg.arch}.xielu.alpha_n")
            xb = g.metadata.get(f"{cfg.arch}.xielu.beta",
                                [0.5] * cfg.n_layers)
            xe = g.metadata.get(f"{cfg.arch}.xielu.eps",
                                [-1e-6] * cfg.n_layers)
            for i, lp in enumerate(per_layer):
                lp["xielu"] = torch.tensor(
                    [xap[i], xan[i], xb[i], xe[i]], dtype=torch.float32
                ).to(dev, dtype)
        # consecutive layers with the same tensor set stack as one group;
        # more than one group is the JAX loader's layer_groups (leading
        # dense layers, llama4's interleaved dense and MoE layers)
        groups: list[list[dict]] = []
        for lp in per_layer:
            if groups and set(groups[-1][0]) == set(lp):
                groups[-1].append(lp)
            else:
                groups.append([lp])
        stacked = [{key: stack(key, [lp[key] for lp in gr]) for key in gr[0]}
                   for gr in groups]
        if len(stacked) <= 1:
            params["layers"] = stacked[0] if stacked else {}
        else:
            SRV_INF("load_model", "heterogeneous layers: %s",
                    [len(gr) for gr in groups])
            params["layer_groups"] = stacked
    return cfg, params


def _pad_openelm(per_layer: list[dict], cfg: ModelConfig, hc_arr,
                 hckv_arr) -> tuple[list[dict], ModelConfig]:
    """openelm's per-layer head counts and FFN widths, zero-padded to the
    largest geometry (the JAX loader's padding), so every layer stacks and
    runs the same programs: padded q heads contribute nothing (their wo
    rows are zero), padded KV heads see k = v = 0, padded FFN columns give
    act(0) * 0 = 0. Q heads are grouped by kv head at stride G_max, so a
    head's kv head stays h // G_max, as HF's repeat_interleave maps it.
    Returns the padded layers and the config at the padded widths."""
    D, L = cfg.head_dim, cfg.n_layers
    hc = list(hc_arr or [cfg.n_heads] * L)
    hk = list(hckv_arr or [cfg.n_kv_heads] * L)
    ffs = list(cfg.extra.get("n_ff_arr") or [cfg.n_ff] * L)
    gmax = max(hc[i] // hk[i] for i in range(L))
    hkv_max = max(hk)
    h_pad = hkv_max * gmax
    ff_max = max(ffs)

    def pad(w, rows, cols):
        out = w.new_zeros((rows, cols))
        out[:w.shape[0], :w.shape[1]] = w
        return out

    for i, lp in enumerate(per_layer):
        g_i = hc[i] // hk[i]
        wq = lp["wq"].new_zeros((cfg.n_embd, h_pad * D))
        wo = lp["wo"].new_zeros((h_pad * D, cfg.n_embd))
        for k in range(hk[i]):
            src = slice(k * g_i * D, (k + 1) * g_i * D)
            dst = slice(k * gmax * D, (k * gmax + g_i) * D)
            wq[:, dst] = lp["wq"][:, src]
            wo[dst, :] = lp["wo"][src, :]
        lp["wq"], lp["wo"] = wq, wo
        lp["wk"] = pad(lp["wk"], cfg.n_embd, hkv_max * D)
        lp["wv"] = pad(lp["wv"], cfg.n_embd, hkv_max * D)
        if "w_gate" in lp:
            lp["w_gate"] = pad(lp["w_gate"], cfg.n_embd, ff_max)
        lp["w_up"] = pad(lp["w_up"], cfg.n_embd, ff_max)
        lp["w_down"] = pad(lp["w_down"], ff_max, cfg.n_embd)
    SRV_INF("load_model", "openelm: padded to %d/%d heads, ff=%d", h_pad,
            hkv_max, ff_max)
    return per_layer, dataclasses.replace(cfg, n_heads=h_pad,
                                          n_kv_heads=hkv_max, n_ff=ff_max)


def params_from_numpy(params_np: dict, cfg: ModelConfig,
                      device="cpu") -> dict:
    """Carry a JAX param tree (after `jax.tree.map(np.asarray, params)`)
    into torch on `device`: same keys, same [in, out] layouts, same
    dtypes. The JAX package's QTensor nodes (numpy leaves) become the
    port's QTensors. The `smalls_all` bundle (a TPU layout of values the
    tree already holds) is dropped. The mmproj towers' trees (JAX
    `load_clip`, `load_audio_tower`) carry over the same way, their
    absent tensors (None) as None, and so do the recurrent families'
    trees: their layer groups (a list of stacked groups: rwkv7's layer 0
    without its v LoRA, the hybrids' mixer, attention and FFN-only
    groups) and every leaf as the JAX loader laid it out (rwkv6's tm_w2
    [5, edim, E] after the "3d" swap)."""
    del cfg  # the tree carries its own shapes; kept for the JAX signature

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items() if k != "smalls_all"}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if all(hasattr(x, a) for a in ("qs", "scales", "mins", "in_dim",
                                       "group", "packed4", "w8a8")):
            return QTensor(conv(x.qs), conv(x.scales),
                           None if x.mins is None else conv(x.mins),
                           int(x.in_dim), int(x.group), bool(x.packed4),
                           bool(x.w8a8))
        return _torch_dtype_of(np.asarray(x)).to(device)
    return conv(params_np)


def _out_dim(w) -> int:
    return w.out_dim if isinstance(w, QTensor) else w.shape[-1]


def deinterleave_rope(params: dict, cfg: ModelConfig):
    """Permute wq/wk output columns from ggml's adjacent-pair ('norm')
    rotation order to half-split ('neox') order; attention is invariant
    and the runtime rotation takes the neox path. Returns (params, cfg')
    with cfg'.rope_mode == 'neox', or the inputs unchanged when the
    transform does not apply. The q/k biases and norms follow the columns
    (a per-head norm's weight by the in-head permutation), as in JAX."""
    lay = params.get("layers")
    if (cfg.rope_mode != "norm" or cfg.mrope_sections or cfg.kv_lora_rank
            or not isinstance(lay, dict)
            or "wq" not in lay or "wk" not in lay):
        return params, cfg
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rot = cfg.rope_dim or D
    if rot % 2 or _out_dim(lay["wq"]) != H * D \
            or _out_dim(lay["wk"]) != Hkv * D:
        return params, cfg
    base = np.concatenate([np.arange(0, rot, 2), np.arange(1, rot, 2),
                           np.arange(rot, D)])

    def perm_cols(w, n_heads):
        idx = torch.from_numpy(np.concatenate(
            [h * D + base for h in range(n_heads)]))

        def take(a):
            return torch.index_select(a, -1, idx.to(a.device))
        if isinstance(w, QTensor):   # permute the codes and the scales
            return w._map(take)
        return take(w)

    lay = dict(lay)
    lay["wq"] = perm_cols(lay["wq"], H)
    lay["wk"] = perm_cols(lay["wk"], Hkv)
    for key, n in (("bq", H), ("bk", Hkv)):
        if key in lay:
            lay[key] = perm_cols(lay[key], n)
    for key in ("q_norm", "k_norm", "q_norm_b", "k_norm_b"):
        if key in lay:
            w = lay[key]
            if w.shape[-1] == D:      # per-head norm, shared across heads
                lay[key] = torch.index_select(
                    w, -1, torch.from_numpy(base).to(w.device))
            else:                     # whole-row [H * D]
                lay[key] = perm_cols(w, H if key[0] == "q" else Hkv)
    out = dict(params)
    out["layers"] = lay
    return out, dataclasses.replace(cfg, rope_mode="neox")


def _cat_weights(ws):
    """Concatenate projection weights along the output dim: dense tensors
    or QTensors with identical layout params. Returns None when the set is
    heterogeneous (no fusion)."""
    if all(isinstance(w, torch.Tensor) for w in ws):
        if len({w.dtype for w in ws}) != 1 \
                or len({w.shape[:-1] for w in ws}) != 1:
            return None
        return torch.cat(ws, dim=-1)
    if not all(isinstance(w, QTensor) for w in ws):
        return None
    w0 = ws[0]
    if any(w.w8a8 != w0.w8a8 or w.packed4 != w0.packed4
           or w.group != w0.group or w.in_dim != w0.in_dim
           or (w.mins is None) != (w0.mins is None) for w in ws):
        return None
    return QTensor(
        qs=torch.cat([w.qs for w in ws], dim=-1),
        scales=torch.cat([w.scales for w in ws], dim=-1),
        mins=(torch.cat([w.mins for w in ws], dim=-1)
              if w0.mins is not None else None),
        in_dim=w0.in_dim, group=w0.group, packed4=w0.packed4,
        w8a8=w0.w8a8)


def fuse_projections(params: dict, cfg: ModelConfig) -> dict:
    """Fuse per-layer q/k/v and gate/up projections into single matmuls
    (`wqkv` [L, E, (H+2*Hkv)*D], `w_gateup` [L, E, 2*FF]). Each output
    column is an independent contraction (and w8a8 activation scales are
    per row of x, shared by construction), so the split outputs equal the
    separate matmuls'. Layer groups stay unfused, as in JAX, and so do
    MLA's projections (no wk / wv; JAX's gate names wkv_a). The
    per-request LoRA stacks ride along, each `lora_B_<key>` [L, n_ad, out,
    r] as `lora_Bt_<key>` [L, n_ad * r, out], the layout of the delta's
    second product (models/llama._lora_delta), made here once."""
    del cfg
    layers = params.get("layers")
    if not isinstance(layers, dict):
        return params
    layers = dict(layers)
    for key in [k for k in layers if k.startswith("lora_B_")]:
        Bm = layers.pop(key)
        L, n_ad, out, r = Bm.shape
        layers["lora_Bt_" + key[len("lora_B_"):]] = \
            Bm.transpose(2, 3).reshape(L, n_ad * r, out).contiguous()
    for fused, keys in (("wqkv", ("wq", "wk", "wv")),
                        ("w_gateup", ("w_gate", "w_up"))):
        # an MoE layer's dense gate and up (arctic's branch) stay apart,
        # as in JAX
        if fused == "w_gateup" and "w_gate_inp" in layers \
                or fused == "wqkv" and "wkv_a" in layers:
            continue
        if all(k in layers for k in keys):
            f = _cat_weights([layers[k] for k in keys])
            if f is not None:
                layers[fused] = f
                for k in keys:
                    del layers[k]
    out = dict(params)
    out["layers"] = layers
    return out
